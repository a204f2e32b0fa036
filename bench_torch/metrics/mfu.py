"""The whole step's or frame's share of the card's bf16 peak: the MLP
operations of the traced window's work (forward and backward of each
step's kept samples and the occupancy updates' forward in training; the
forward of the points shaded in serving) over the window's wall time at
989 TFLOP/s."""

from bench_torch import roofline


def read(r):
    if r["window_s"] <= 0 or r["work"]["mlp_flops"] <= 0:
        return None
    return 100.0 * r["work"]["mlp_flops"] / (r["window_s"] * roofline.BF16_FLOP_S)
