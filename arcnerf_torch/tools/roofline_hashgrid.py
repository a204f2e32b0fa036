"""Hash-grid gather roofline on the card: the counterpart of
``tools/roofline_hashgrid.py``.

It asks how far the NGP recipe's hash-grid gather (B = 2^18 points, L = 16
levels, F = 2 features, T = 2^19 entries a level) runs from the card's
memory limit, and what a fused encode + MLP megakernel could save. Rows:

  seq_read     ``torch.sum`` over a 256 MB f32 tensor: sequential read GB/s
  gather_f32   kernel B (``hash_encode``) reading the f32 table as f32
  gather_bf16  kernel B rounding each read to bf16 (the recipe's setting)
  encode_mlp   kernel B, then kernel A on the geometry chain 32 -> 64 -> 16
  matmul_peak  a chain of tanh(c @ a), 4096^2 bf16 (``torch.matmul``)
  vmem_gather  kernel G gathering 2^15 rows from a (2^14, 128) bf16 table
               (4 MiB, L2-resident): the Pallas probe's shape, 8 MiB a call
  l2_gather    kernel G gathering 2^21 rows from a (2^14, 128) f32 table
               (8 MiB, L2-resident), beside
  loop_gather  kernel G gathering 2^21 rows from a (2^19, 128) f32 table
               (256 MiB, HBM-resident): the same 1 GiB of rows, so the two
               differ only in where the table lives

The JAX probe's encoder hashes every level with the instant-ngp hash; the
production encoder, and kernel B, index the coarse levels densely and hash
the others with the recipe's quad hash. Both read 8 corners x F features a
point and level, so the gathered bytes are the same; this tool times the
production gather on purpose, since that is the gather the roofline
question is about. Kernel B keeps the table in f32 and rounds after the
load, so both gather rows move 4-byte elements: gathered GB/s counts those,
and the bf16 row also states the rate at the JAX probe's 2 bytes an element.

Run: ``python -m arcnerf_torch.tools.roofline_hashgrid [--device cuda:0]``.
"""

import math
import sys

import numpy as np
import torch

from . import device_label, generator, parse_device, print_table, time_ms
from ..models.base_modules.encoding import hash_encode
from ..ops.fused_mlp import fused_mlp
from ..ops.gather_scatter import row_gather

B = 1 << 18  # compacted point budget (log_max_allowance 18)
L, F, T_LOG = 16, 2, 19
SEQ_SHAPE = (64, 1024, 1024)  # 256 MB of f32
MM_N, MM_ITERS = 4096, 32
VMEM_T, VMEM_N = 1 << 14, 1 << 15  # the Pallas probe's VMEM-resident table and its gather
LOOP_T, LOOP_N = 1 << 19, 1 << 21  # loop_gather of scripts/probe_pallas_gather2.py; l2_gather: VMEM_T rows
GEO_WIDTHS = (64, 16)  # geometry chain after the L * F embedding
REPS = 20
VARIANT = "quad"


def resolutions():
    """The probe's level resolutions: ceil(16 * (2048 / 16)^(i / (L - 1)) - 1)."""
    return [int(math.ceil(16 * (2048 / 16) ** (i / (L - 1)) - 1)) for i in range(L)]


def seq_read_probe(dev):
    big = torch.ones(SEQ_SHAPE, dtype=torch.float32, device=dev)
    ms = time_ms(lambda: torch.sum(big), dev, REPS)
    return {"ms": ms, "gbs": big.numel() * 4 / ms / 1e6}


def _encoder_inputs(dev):
    table = torch.full((L, 1 << T_LOG, F), 0.01, dtype=torch.float32, device=dev)
    xyz = torch.as_tensor(np.random.default_rng(0).uniform(-0.95, 0.95, (B, 3)).astype(np.float32), device=dev)
    res = resolutions()
    res_dev = torch.as_tensor(res, dtype=torch.int32, device=dev)
    return lambda read_bf16: hash_encode(xyz, table, res, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0), VARIANT, read_bf16,
                                         res_dev=res_dev)


def gather_probe(dev, read_bf16, seq_gbs):
    encode = _encoder_inputs(dev)
    ms = time_ms(lambda: encode(read_bf16), dev, REPS)
    elems = B * L * 8 * F
    row = {"ms": ms, "gbs": elems * 4 / ms / 1e6}
    row["share_of_seq_read"] = row["gbs"] / seq_gbs
    if read_bf16:
        row["gbs_at_2_bytes"] = elems * 2 / ms / 1e6
    return row


def encode_mlp_probe(dev):
    encode = _encoder_inputs(dev)
    dims = (L * F,) + GEO_WIDTHS
    ws = [torch.full((dims[i], dims[i + 1]), 0.01, dtype=torch.float32, device=dev) for i in range(len(dims) - 1)]
    return {"ms": time_ms(lambda: fused_mlp(encode(True), ws), dev, REPS)}


def matmul_peak_probe(dev):
    a = torch.ones((MM_N, MM_N), dtype=torch.bfloat16, device=dev)
    c0 = torch.ones((MM_N, MM_N), dtype=torch.bfloat16, device=dev)

    def chain():
        c = c0
        for _ in range(MM_ITERS):
            c = torch.tanh(c @ a)
        return c

    ms = time_ms(chain, dev, max(1, REPS // 4))
    return {"ms": ms, "gflops": 2.0 * MM_N ** 3 * MM_ITERS / ms / 1e6}


def row_gather_probe(dev, n_table, n_rows, dtype):
    gen = generator(dev)
    table = torch.randn((n_table, 128), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, n_table, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    ms = time_ms(lambda: row_gather(table, idx), dev, REPS)
    return {"ms": ms, "gbs": n_rows * 128 * table.element_size() / ms / 1e6}


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    print("device:", device_label(dev))
    out = {"seq_read": seq_read_probe(dev)}
    seq = out["seq_read"]["gbs"]
    out["gather_f32"] = gather_probe(dev, False, seq)
    out["gather_bf16"] = gather_probe(dev, True, seq)
    out["encode_mlp"] = encode_mlp_probe(dev)
    out["matmul_peak"] = matmul_peak_probe(dev)
    out["vmem_gather"] = row_gather_probe(dev, VMEM_T, VMEM_N, torch.bfloat16)
    out["l2_gather"] = row_gather_probe(dev, VMEM_T, LOOP_N, torch.float32)
    out["loop_gather"] = row_gather_probe(dev, LOOP_T, LOOP_N, torch.float32)
    # a fused encode + MLP kernel would not write and re-read the (B, L*F) f32 embedding
    out["megakernel_savable_mb"] = B * L * F * 4 * 2 / 1e6

    g32, g16 = out["gather_f32"], out["gather_bf16"]
    print_table(("probe", "result"), [
        ("seq_read ({} MB f32 sum)".format(int(np.prod(SEQ_SHAPE)) * 4 // 10**6), "{:.1f} GB/s".format(seq)),
        ("hashgrid encode fwd f32 (kernel B)", "{:.4f} ms, gathered {:.1f} GB/s ({:.1%} of seq_read)".format(
            g32["ms"], g32["gbs"], g32["share_of_seq_read"])),
        ("hashgrid encode fwd bf16 (kernel B)", "{:.4f} ms, gathered {:.1f} GB/s ({:.1%} of seq_read; "
                                                "{:.1f} GB/s at 2 B/element)".format(
            g16["ms"], g16["gbs"], g16["share_of_seq_read"], g16["gbs_at_2_bytes"])),
        ("encode + geo MLP fwd bf16 (kernels B, A)", "{:.4f} ms".format(out["encode_mlp"]["ms"])),
        ("bf16 matmul chain {}^2 x {}".format(MM_N, MM_ITERS), "{:.0f} GFLOP/s".format(out["matmul_peak"]["gflops"])),
        ("row gather ({}, 128) bf16, {} rows (kernel G, L2-resident)".format(VMEM_T, VMEM_N),
         "{:.4f} ms, {:.1f} GB/s".format(out["vmem_gather"]["ms"], out["vmem_gather"]["gbs"])),
        ("row gather ({}, 128) f32, {} rows (kernel G, L2-resident)".format(VMEM_T, LOOP_N),
         "{:.4f} ms, {:.1f} GB/s".format(out["l2_gather"]["ms"], out["l2_gather"]["gbs"])),
        ("row gather ({}, 128) f32, {} rows (kernel G, HBM-resident)".format(LOOP_T, LOOP_N),
         "{:.4f} ms, {:.1f} GB/s".format(out["loop_gather"]["ms"], out["loop_gather"]["gbs"])),
    ])
    print("workload: B={} pts, L={}, F={}, T=2^{}, {} hash; mean of {} calls after a warm-up".format(
        B, L, F, T_LOG, VARIANT, REPS))
    print("megakernel savable intermediate traffic/iter: {:.0f} MB".format(out["megakernel_savable_mb"]))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
