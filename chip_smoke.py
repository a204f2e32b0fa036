"""Smoke run of the arcnerf_torch serving and training paths, and of the
gather/scatter tools, on one NVIDIA GPU.

Usage: python3 chip_smoke.py [--profile]   (from the root of the repository)

1. Requires CUDA; prints the card (nvidia-smi name and power limit), torch
   and CUDA versions.
2. Builds the CUDA kernels A-J and their pybind11 binding from
   arcnerf_torch/csrc into one extension module (nvcc, the binding and the
   link timed apart).
3. Holds each kernel against its plain PyTorch version on the card at the
   shapes of the main paths, and times both (CUDA events, mean of 20
   calls; G-J and their library calls also replayed from a CUDA graph),
   beside the kernel's bound (bytes over 3.35 TB/s or operations over the
   peak rate, whichever is larger) and, for E and G-J, one PyTorch call of
   the same function (index_add_ of E's precomputed updates, index_select,
   gather, index_add_, torch.zeros + scatter_add_). Kernel E runs on
   uniform points here and on the training stream after step 6, each also
   through its C entry point alone and on levels 0-1 and 2-15 apart; kernel
   B also runs on that stream's points with the trained table, C and F on
   step 6's compositing stream, and C on the serving chunk of step 5. B's,
   C's, F's, I's and J's rows quote the parent kernels' times from PERF.md
   (PARENT_MS). Kernel I runs at the probes' five shapes, each also
   replayed from a CUDA graph beside index_add_ in one, and at kernel E's
   scale in place (compare_scatter_w1); kernel J at the probe's quad and
   pair geometries. The fused sampler (S, ``sample_compact``) at a training
   step's shapes (16384 rays x 512 slots, jitter, 2^18 budget), the
   16384-ray serving chunk at cap 16 and the 1024-ray last chunk of an
   800x800 frame, on the scene's occupancy, held bit for bit against its
   plain version and timed through CUDA events and from a CUDA graph (its
   count and scan alone too).
   Kernels A (both builds, inference and save_pre) and D are also run
   twice for bit-identical results and timed beside a
   bf16 chain of cuBLAS calls (A through its C entry point in a CUDA graph,
   so that its launch time does not hide it; each build beside its own
   bound; the share of flipped bf16 values checked), and the HMMA
   instructions of their compiled code are counted (cuobjdump).
   Launch path: the host microseconds a call of every wrapper A-J at a
   small shape (2000 back-to-back calls, then one synchronize), beside the
   same launch through the kernel's C entry point by ctypes and the PyTorch
   calls of G, H and I (index_select, gather, index_add_).
4. Tools: the hash-grid roofline and the gather/scatter probes
   (``arcnerf_torch.tools``: roofline_hashgrid, probe_gather, probe_scatter,
   probe_cons_forms) print their tables; checks that kernels A, B and G-J
   launched in that run.
5. Serving: ``arcnerf_torch.evaluate`` on an 800x800 Synthetic view of the
   NGP recipe (configs/expr/synthetic_ngp.yaml, full width, random weights
   from a seeded torch.Generator saved as a port checkpoint, occupancy of
   the scene's spheres at n_grid 128, per-ray cap 16). Checks the image,
   that kernels A-C and the sampler launched in that run, and a 4096-ray
   crop against the plain path on the CPU; then times 3 renders, the first of which also
   captures the compacted stream kernel C receives for the 16384-ray chunk
   that crosses the spheres (rays 311296-327679), on which C is held
   against its plain version and timed from a CUDA graph.
6. Training: ``arcnerf_torch.train`` runs the full-width recipe for 400
   steps (24 Synthetic views at 128x128, dynamic batch up to 32768 rays,
   occupancy updates every 16 steps with warmup below 256). Checks that the
   loss is finite and falls, that the bitfield changed, that kernels A-F
   and the sampler all launched, that one batch's loss and gradients match
   the plain path on the CPU, and that the held-out view renders at >= 20 dB PSNR through
   the serving path; prints the ray bucket, valid samples per ray and peak
   memory. The tiers phase then renders an 800x800 held-out view of the
   trained model through the trainer's render tiers, with the eval
   background, under bench.py's serving keys: exact at cap 16
   (``render``), ``render_compact`` (fast, cap 16, hit_frac 0.42),
   ``render_fast`` (cap 4), ``render_interactive`` (cap 4, 64 steps, scale
   3), ``render_windowed_s1`` and ``_s2`` (windows of 8 samples, eps 1e-3,
   the counted ladder of 512 / 8 passes): for each a warm-up and 3 timed
   frames (median, host clock around torch.cuda.synchronize()), PSNR
   against the exact frame, stats, peak memory and the launches of A-C and
   the sampler a frame (each in every tier: the windowed tier's windows
   sample through S's window mode and march through C's tail mode; the
   exact tier's from one replayed frame by kernel name: each as often as an
   eager frame's counters and at least once a replayed chunk). Gates:
   finite (800, 800, ...) images; fast at hit_frac 1.0 against exact (rgb
   max abs <= 5e-2); windows at eps 0 against the uncapped render of the
   4096-ray crop (<= 1e-3); windowed s1 >= 40 dB against the uncapped
   frame (both uncapped renders in clip-free chunks of 512 rays); no alive
   ray clipped. Then one torch.profiler pass over a windowed s1 frame, and
   ``python -m arcnerf_torch.inference`` from the run's checkpoint (a circle
   of 4 cameras at 200x200; its log must show every frame finite). Then
   the training run times 100 more steps (CUDA events: ms/step, rays/s), and
   captures the streams kernels E and F receive in one more step (E's
   valid and padding rows are printed). With --profile, also profiles 4
   more steps (torch.profiler) and prints the device-time split (by kernel
   name and for each of A-F) and idle share. Then kernel B on that step's
   points with the trained table, and kernels C and F on that step's
   compositing stream (its segment-length distribution printed), each held
   against its plain version and timed from a CUDA graph beside its bound.
   The NeuS-NGP phase: kernels K (the hash grid's input gradient) and L
   (its backward) at 2^18 ray-ordered points against their plain
   versions; kernel S's sections mode at 2048 rays x 1024 ladder slots
   with a 2^18 budget (the scene's grid, half the voxels occupied so the
   budget cuts the stream) and 64 diagonal rays of a full grid (every
   slot valid, the sections clipped at 1024), bit for bit with its plain
   version; kernels C and F in their alpha mode on each stream it wrote;
   kernels M and N (the fused geometry chain and its backward, with the
   reduce) at a step's 2^18 rows, M also at an occupancy update's 2^20
   points, against their plain versions and autograd's create-graph
   chain (the library yardstick), each beside its f32 FMA bound;
   kernel P (the SDF nets' softplus, ``ops.softplus``): its forward at the
   VolSDF sampler's GeoNet call (1024 x 128 points, 256 wide) bit for bit
   the card's three ops, its backward at a step's training points (1024 x
   98) bit for bit autograd's and its double backward within 1e-6 of
   autograd's, each beside its bound (bytes), its plain version and the
   three ops' or autograd's time; then 48 eager steps of
   configs/expr/synthetic_neus_ngp.yaml (each kernel's launches a step,
   the loss finite), and 4 eager steps of the VolSDF lego recipe
   (configs/expr/NeRF/lego/nerf_lego_volsdf.yaml at its 1024 rays and
   widths, procedural views): kernel P's launches a step, the loss finite.
   The graph phase, last (its draws do not always repeat on the card, so
   a failure there is printed after the kernel table and still exits
   non-zero): (a) the same 400 steps again with
   ``--progress.scan_steps 16`` (strides of replays of the step captured
   as a CUDA graph, one a ray bucket): the loss is finite and falls, the
   bitfield changes, the held-out PSNR is >= 20 dB and within 0.5 dB of
   the eager run's; prints each bucket's capture time and the peak
   memory, and the launch counters, which count each bucket's warm-up
   step and capture, not the replays. (b) Two eager copies of that
   trainer (its checkpoint, its generator state) run 16 steps beside one
   stride of 16 replays: every step's picks and valid-sample count equal,
   every loss within 1e-2 relative (the two eager copies show the spread
   of kernel E's atomics). (c) Median ms/step and rays/s of eager steps
   and of graph replays at the same bucket. (d) torch.profiler over one
   stride of replays, cold (printed: the profiler misses the replays it
   starts during) and after a warm-up stride: device busy and idle,
   Adam's time, and in the latter each of A-F launched a replay as often
   as an eager step launches it.
7. Prints the kernel table as JSON (A-F's and the sampler's launches from
   the training run,
   G-J's from the tools; G-J's times at the probes' largest shape, J's
   also at quad's; A's entry also holds its save_pre build, B's and E's
   their numbers on the training stream, C's and F's on the captured
   compositing stream (F's with its segment lengths), C's also on the
   serving chunk, S's, C's and F's also on the NeuS sections; every entry its wrapper's host_us and ctypes_us), the
   card line, and as the last line
   {"ok": true, "device": {...}}.

Any failure raises and exits non-zero. Outputs go to chiprun_out/chip_smoke/;
the training run's checkpoints go to experiments/ and are deleted.
"""

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "chiprun_out", "chip_smoke")
WORK_DIR = os.path.join(ROOT, "experiments", "chip_smoke")  # checkpoints: git-ignored, not copied back
SEED = 0

# (rows, tolerance) per kernel comparison, and the slice tolerances
A_ROWS, A_TOL = 1 << 18, 2e-2  # bf16 flips from another summation order
A_FLIP_BOUND = 1e-3  # the share of flipped bf16 values (tests/test_torch_mlp_fwd_numerics.py)
B_POINTS, B_TOL = 1 << 18, 1e-5  # f32 sums in another order
C_RAYS, C_STREAM, C_TOL = 16384, 1 << 18, 1e-4  # sequential vs cumprod/sum order, relative
# D, E, F: sums over many rows/samples in another order (atomics, cumprod),
# so the tolerance is relative to the largest value of each output
D_TOL, E_TOL, F_TOL = 1e-4, 1e-4, 1e-4
# G, H and J copy values or place one term per lane: bit-identical to plain.
# I: f32 atomics add in another order, relative to the largest value
I_TOL = 1e-5
RGB_MAX, RGB_MEAN, DEPTH_MAX = 2e-2, 1e-3, 5e-2
# the earlier kernels' ms as PERF.md records them (NVIDIA H100 80GB HBM3,
# 700.00 W): B on the training stream, C on march_stream, on the captured
# training stream and on the serving chunk, all from a CUDA graph; F on
# march_stream through CUDA events; I at 2^25 -> 2^23, W=1, the mean of 20
# calls; J (the parent: a warp a row) at the probe's quad and pair
# geometries from a CUDA graph, re-timed before its redesign
PARENT_MS = {"B": 0.1364, "C": 0.0089, "C captured": 0.0361, "C serving": 0.0087, "F": 0.0340, "I": 0.7151,
             "J quad": 0.2042, "J pair": 0.2507}
TRAIN_STEPS, STEADY_STEPS, PSNR_FLOOR = 400, 100, 20.0
# the graph phase: bench.py's stride; the held-out PSNR of the strided run
# within 0.5 dB of the eager run's; graph replays against eager steps from
# one state, each step's loss within 1e-2 relative - kernel E adds the
# table gradient with float atomics in an order that changes from run to
# run, so two runs part in the last bits after the first step (an eager run
# against a second eager run shows the spread); the draws, and so the picks
# and the valid-sample counts, stay exactly equal
GRAPH_STRIDE, GRAPH_PSNR_GAP, GRAPH_LOSS_TOL, GRAPH_TIMED_STRIDES = 16, 0.5, 1e-2, 6
# one training step on the card vs the plain path on the CPU (same batch,
# no draws): bf16 flips in the MLPs and f32 sums in another order (atomics)
STEP_RAYS, STEP_LOSS_TOL, STEP_GRAD_TOL = 1024, 1e-3, 1e-2


def card_line():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def time_ms(fn, reps=20):
    """Mean ms per call over ``reps`` back-to-back calls, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the H100 SXM data sheet: HBM rate, dense bf16 tensor-core and f32 FMA peaks
HBM_BYTES_S, BF16_FLOP_S, F32_FLOP_S = 3.35e12, 989e12, 67e12


def bound(nbytes, flops, peak):
    """The least time of a function on the card: (ms, "bytes" or
    "operations"), the larger of its bytes (each input read once, each output
    written once) over the HBM rate and its operations over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def add_bound(entry, bounds):
    """Sum the bounds of the cases timed in ``entry["ms"]`` into the entry
    (bound_ms, bound_by of the largest, share = bound / kernel); returns the
    printed suffix."""
    entry["bound_ms"] = sum(b[0] for b in bounds)
    entry["bound_by"] = max(bounds)[1]
    entry["share"] = entry["bound_ms"] / entry["ms"]
    entry.setdefault("library_ms", None)
    return "bound {:.4f} ms by {}, share {:.1%}".format(entry["bound_ms"], entry["bound_by"], entry["share"])


def n_unique(idx):
    return int(torch.unique(idx).numel())


def max_err(out, ref):
    return float((out - ref).abs().max())


def check_close(name, out, ref, atol, rtol):
    bad = (out - ref).abs() > atol + rtol * ref.abs()
    if not torch.isfinite(out).all() or bool(bad.any()):
        raise AssertionError("{}: {} of {} values outside atol={} rtol={} (max abs err {})".format(
            name, int(bad.sum()), bad.numel(), atol, rtol, max_err(out, ref)))


def check_scaled(name, out, ref, tol):
    """|out - ref| <= tol * max|ref| everywhere; returns max abs err."""
    scale = float(ref.abs().max())
    err = max_err(out, ref)
    if not torch.isfinite(out).all() or err > tol * scale:
        raise AssertionError("{}: max abs err {} > {} * max|ref| {}".format(name, err, tol, scale))
    return err


def _chain(dims, gen, dev):
    return [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
            for i in range(len(dims) - 1)]


def graph_ms(fn, reps=20):
    """Mean device ms per call over ``reps`` calls replayed from one CUDA
    graph, after a warm-up: no host launch time between the calls, which
    a kernel shorter than its launch would otherwise show. ``fn`` must look
    up the current stream when called (the capture runs on its own)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the warm-up on a side stream, as capture wants
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def a_entry_point(lib, x, dims, packed, out, pre=None):
    """Kernel A through its C entry point alone, on the chain's packed
    weights and preallocated outputs: the inference build, or with ``pre``
    the save_pre build."""
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.ops.fused_mlp import _pads

    din_pad, dout_pad = _pads(dims[0], dims[-1])

    def call():
        cuda_lib.check(lib.arcnerf_fused_mlp_fwd(
            x.data_ptr(), x.shape[0], dims[0], din_pad, packed.data_ptr(), 64, len(dims) - 2, dims[-1], dout_pad,
            out.data_ptr(), None if pre is None else pre.data_ptr(), cuda_lib.stream_handle(x.device)), "fused_mlp")

    return call


def cublas_chain_fwd(x, wb):
    """The same forward as a chain of bf16 torch.matmul calls (cuBLAS, f32
    accumulation, bf16 out) and ReLUs; the bf16 products before each ReLU
    are the pre-activations, so it serves as the yardstick of both builds.
    The port never calls it."""
    h = x.to(torch.bfloat16)
    for i, w in enumerate(wb):
        h = h @ w
        if i < len(wb) - 1:
            h = torch.relu(h)
    return h.float()


def compare_fused_mlp(dev, gen):
    """Kernel A's two builds at A_ROWS rows of both recipe chains: each
    against the plain version (A_TOL, and the share of flipped bf16 values
    under A_FLIP_BOUND), the save_pre output equal to the inference output,
    two calls bit-identical; timed through the C entry point (CUDA graph),
    through the wrapper, plain, and the bf16 cuBLAS chain, each build
    beside its own bound."""
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.ops.fused_mlp import _pads, fused_mlp, fused_mlp_fwd, fused_mlp_reference, pack_weights

    rows, bounds, bounds_pre, worst = [], [], [], 0.0
    totals = dict.fromkeys(("ms", "plain_ms", "wrapper_ms", "save_pre_ms", "save_pre_plain_ms",
                            "save_pre_wrapper_ms", "chain_ms"), 0.0)
    flips = {"out": 0.0, "pre": 0.0}
    lib = cuda_lib.lib()
    for label, dims in (("geo", [32, 64, 16]), ("radiance", [18, 64, 64, 3])):
        x = torch.randn((A_ROWS, dims[0]), generator=gen, device=dev)
        ws = _chain(dims, gen, dev)
        n_hidden = len(dims) - 2
        kn = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        # x and out f32 and the f32 weights, with save_pre also the bf16
        # pre-activations out; 2 flops a weight and row, bf16
        io = A_ROWS * (dims[0] + dims[-1]) * 4 + kn * 4
        bounds.append(bound(io, 2 * A_ROWS * kn, BF16_FLOP_S))
        bounds_pre.append(bound(io + A_ROWS * n_hidden * 64 * 2, 2 * A_ROWS * kn, BF16_FLOP_S))
        out, ref = fused_mlp(x, ws), fused_mlp_reference(x, ws)
        check_close("fused_mlp " + label, out, ref, A_TOL, A_TOL)
        out_s, pre = fused_mlp_fwd(x, ws, save_pre=True)
        _, pre_ref = fused_mlp_reference(x, ws, save_pre=True)
        check_close("fused_mlp save_pre " + label, pre.float(), pre_ref.float(), A_TOL, A_TOL)
        if not torch.equal(out_s, out):
            raise AssertionError("fused_mlp {}: the save_pre build's output differs from the inference build's"
                                 .format(label))
        out_s2, pre2 = fused_mlp_fwd(x, ws, save_pre=True)
        if not (torch.equal(fused_mlp(x, ws), out) and torch.equal(out_s2, out_s) and torch.equal(pre2, pre)):
            raise AssertionError("fused_mlp {}: two calls on the same inputs differ".format(label))
        flip = {"out": float((out != ref).float().mean()), "pre": float((pre != pre_ref).float().mean())}
        if max(flip.values()) > A_FLIP_BOUND:
            raise AssertionError("fused_mlp {}: flipped bf16 shares {} above {}".format(label, flip, A_FLIP_BOUND))
        err = max(max_err(out, ref), max_err(pre.float(), pre_ref.float()))
        del out_s, out_s2, pre2, pre_ref
        packed = pack_weights(ws, *_pads(dims[0], dims[-1]), dev)
        wb = [w.to(torch.bfloat16) for w in ws]
        case = {
            "ms": graph_ms(a_entry_point(lib, x, dims, packed, torch.empty_like(ref))),
            "save_pre_ms": graph_ms(a_entry_point(lib, x, dims, packed, torch.empty_like(ref), torch.empty_like(pre))),
            "wrapper_ms": time_ms(lambda: fused_mlp(x, ws)),
            "save_pre_wrapper_ms": time_ms(lambda: fused_mlp_fwd(x, ws, save_pre=True)),
            "plain_ms": time_ms(lambda: fused_mlp_reference(x, ws)),
            "save_pre_plain_ms": time_ms(lambda: fused_mlp_reference(x, ws, save_pre=True)),
            "chain_ms": graph_ms(lambda: cublas_chain_fwd(x, wb)),
        }
        rows.append("A fused_mlp {} {}: max abs err {:.3e} (tol {}), flipped bf16 values out {:.2e} pre {:.2e} "
                    "(bound {}), save_pre output = inference output, two calls bit-identical; C entry point "
                    "(CUDA graph): inference {:.4f} ms (bound {:.4f} ms by {}), save_pre {:.4f} ms (bound {:.4f} ms "
                    "by {}); through the wrapper {:.4f} / {:.4f} ms; plain {:.4f} / {:.4f} ms; bf16 chain of cuBLAS "
                    "calls (not one call, CUDA graph) {:.4f} ms".format(
                        label, "-".join(map(str, dims)), err, A_TOL, flip["out"], flip["pre"], A_FLIP_BOUND,
                        case["ms"], *bounds[-1], case["save_pre_ms"], *bounds_pre[-1], case["wrapper_ms"],
                        case["save_pre_wrapper_ms"], case["plain_ms"], case["save_pre_plain_ms"], case["chain_ms"]))
        for k in totals:
            totals[k] += case[k]
        worst = max(worst, err)
        for k in flips:
            flips[k] = max(flips[k], flip[k])
        del x, out, ref, pre, packed
    entry = dict(totals, max_abs_err=worst, flip_share=flips)
    suffix = add_bound(entry, bounds)
    entry.update(save_pre_bound_ms=sum(b[0] for b in bounds_pre), save_pre_bound_by=max(bounds_pre)[1])
    entry["save_pre_share"] = entry["save_pre_bound_ms"] / entry["save_pre_ms"]
    rows.append("A geo + radiance: inference {:.4f} ms, {}; save_pre {:.4f} ms, bound {:.4f} ms by {}, share {:.1%}; "
                "bf16 cuBLAS chain {:.4f} ms".format(entry["ms"], suffix, entry["save_pre_ms"],
                                                     entry["save_pre_bound_ms"], entry["save_pre_bound_by"],
                                                     entry["save_pre_share"], entry["chain_ms"]))
    return rows, entry


def compare_hash_encode(dev, gen):
    from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode, hash_encode_reference

    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    table = (torch.rand((16, 1 << 19, 2), generator=gen, device=dev) * 2 - 1).contiguous()
    xyz = torch.rand((B_POINTS, 3), generator=gen, device=dev) * 2 - 1
    rows, entry = [], None
    # xyz in, (N, 32) f32 out, the f32 table entries the corners can reach
    # (at most (res + 1)^3, T or 8 N a level); 2 flops a corner and feature
    touched = sum(min(1 << 19, (r + 1) ** 3, 8 * B_POINTS) for r in enc.resolutions)
    b_bound = bound(B_POINTS * (12 + 32 * 4) + touched * 2 * 4, B_POINTS * 16 * 8 * 2 * 2, F32_FLOP_S)
    for variant in ("quad", "ngp"):
        args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, variant, True)
        out, ref = hash_encode(*args), hash_encode_reference(*args)
        check_close("hash_encode " + variant, out, ref, B_TOL, 0.0)
        ms, plain = time_ms(lambda: hash_encode(*args)), time_ms(lambda: hash_encode_reference(*args))
        rows.append("B hash_encode {} (2^18 pts, L=16, T=2^19, F=2): max abs err {:.3e} (tol {}), kernel {:.4f} ms, "
                    "plain {:.4f} ms".format(variant, max_err(out, ref), B_TOL, ms, plain))
        if variant == enc.variant:
            # also as the step calls it, the resolutions on the card, in a CUDA graph
            res_dev = torch.as_tensor(enc.resolutions, dtype=torch.int32, device=dev)
            entry = {"max_abs_err": max_err(out, ref), "ms": ms, "plain_ms": plain,
                     "graph_ms": graph_ms(lambda: hash_encode(*args, res_dev=res_dev))}
            rows[-1] += ", CUDA graph {:.4f} ms, {}".format(entry["graph_ms"], add_bound(entry, [b_bound]))
    return rows, entry


def compare_segment_march(dev, gen):
    """Kernel C on march_stream (rays of at most 32 samples) at the training
    width (32 lanes a ray), and from a CUDA graph also at the serving width
    (``march_group(16)``, 8 lanes a ray), each held against the plain
    version."""
    from arcnerf_torch.render.ray_helper import TRAIN_GROUP, march_group, segment_march, segment_march_reference

    sigma, rgb, z, off, cnt = march_stream(dev, gen, C_RAYS, C_STREAM)
    bkg = torch.ones((C_RAYS, 3), device=dev)
    ref = segment_march_reference(sigma, rgb, z, off, cnt, bkg=bkg)
    err = 0.0
    for group in (TRAIN_GROUP, march_group(16)):
        out = segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg, group=group)
        for k in ("rgb", "depth", "mask", "trans_end"):
            check_close("segment_march {} at {} lanes".format(k, group), out[k], ref[k], C_TOL, C_TOL)
            err = max(err, max_err(out[k], ref[k]))
    ms = time_ms(lambda: segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg))
    plain = time_ms(lambda: segment_march_reference(sigma, rgb, z, off, cnt, bkg=bkg))
    entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "group": TRAIN_GROUP,
             "graph_ms": graph_ms(lambda: segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg)),
             "serving_group_graph_ms": graph_ms(lambda: segment_march(sigma, rgb, z, off, cnt, bkg_color=bkg,
                                                                      group=march_group(16)))}
    suffix = add_bound(entry, [c_bound(cnt, C_RAYS)])
    row = "C segment_march (16384 rays of 0-32 samples, 2^18 stream, {} lanes a ray): max abs err {:.3e} (tol {} " \
          "rel), kernel {:.4f} ms (CUDA graph {:.4f} ms, at {} lanes a ray {:.4f} ms; parent {} ms from a CUDA " \
          "graph, PERF.md), plain {:.4f} ms, {}".format(TRAIN_GROUP, err, C_TOL, ms, entry["graph_ms"],
                                                 march_group(16), entry["serving_group_graph_ms"], PARENT_MS["C"],
                                                 plain, suffix)
    return [row], entry


def c_bound(cnt, n_rays, tail=False):
    """Kernel C's bound: the valid samples' sigma, rgb, z and per ray off,
    cnt (int64), bkg (and in the tail mode the tail, f32) in, rgb, depth,
    mask, trans_end out; ~10 f32 flops a sample."""
    n_valid = int(cnt.sum())
    return bound(n_valid * 20 + n_rays * (16 + 12 + 24 + (4 if tail else 0)), n_valid * 10, F32_FLOP_S)


def f_bound(cnt, n_rays, k_total):
    """Kernel F's bound: the valid samples' sigma, rgb, z and the per-ray
    gradients, bkg, off, cnt in; d_sigma and d_rgb over the whole stream
    out; ~20 flops a sample."""
    n_valid = int(cnt.sum())
    return bound(n_valid * 20 + n_rays * 48 + k_total * 16, n_valid * 20, F32_FLOP_S)


def cublas_chain_bwd(x, g, wb, pre):
    """The same backward as a chain of bf16 torch.matmul calls (cuBLAS) and
    elementwise masks, g in bf16 throughout: a yardstick the port never
    calls (it misses D_TOL, since dW takes g in bf16)."""
    n = len(wb)
    posts = [x.to(torch.bfloat16)] + [torch.relu(pre[i]) for i in range(n - 1)]
    gb, dws = g.to(torch.bfloat16), [None] * n
    for i in reversed(range(n)):
        if i < n - 1:
            gb = gb * (pre[i] > 0)
        dws[i] = posts[i].T @ gb
        gb = gb @ wb[i].T
    return gb, dws


def compare_fused_mlp_bwd(dev, gen):
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.ops.fused_mlp import (D_MAX_PARTS, _pads, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd,
                                             pack_weights)

    rows, bounds = [], []
    total_ms = total_plain = total_chain = worst = 0.0
    for label, dims in (("geo", [32, 64, 16]), ("radiance", [18, 64, 64, 3])):
        x = torch.randn((A_ROWS, dims[0]), generator=gen, device=dev)
        ws = _chain(dims, gen, dev)
        _, pre = fused_mlp_fwd(x, ws, save_pre=True)
        g = torch.randn((A_ROWS, dims[-1]), generator=gen, device=dev)
        dx, dws = fused_mlp_bwd(x, g, ws, pre)
        dx_ref, dws_ref = fused_mlp_bwd_reference(x, g, ws, pre)
        err = check_scaled("fused_mlp_bwd dX " + label, dx, dx_ref, D_TOL)
        for i, (a, b) in enumerate(zip(dws, dws_ref)):
            err = max(err, check_scaled("fused_mlp_bwd dW{} {}".format(i, label), a, b, D_TOL))
        dx2, dws2 = fused_mlp_bwd(x, g, ws, pre)
        if not (torch.equal(dx, dx2) and all(torch.equal(a, b) for a, b in zip(dws, dws2))):
            raise AssertionError("fused_mlp_bwd {}: two calls on the same inputs differ".format(label))
        del dx, dws, dx_ref, dws_ref, dx2, dws2
        kn = sum(dims[i] * dims[i + 1] for i in range(len(dims) - 1))
        # x, g, the bf16 pre-activations and the f32 weights in, dX and dW
        # out; 2 flops a weight and row for dW and again for dX, bf16
        nbytes = A_ROWS * (2 * dims[0] * 4 + dims[-1] * 4 + (len(dims) - 2) * 64 * 2) + 2 * kn * 4
        bounds.append(bound(nbytes, 4 * A_ROWS * kn, BF16_FLOP_S))
        wb = [w.to(torch.bfloat16) for w in ws]
        # the kernel alone: its C entry point on kernel A's packed weights and
        # preallocated outputs, so that the wrapper's host time cannot set it
        din_pad, dout_pad = _pads(dims[0], dims[-1])
        packed = pack_weights(ws, din_pad, dout_pad, dev)
        dx_out = torch.empty_like(x)
        parts = torch.empty((D_MAX_PARTS, packed.numel()), device=dev)
        lib, stream = cuda_lib.lib(), cuda_lib.stream_handle(dev)

        def kernel():
            cuda_lib.check(lib.arcnerf_fused_mlp_bwd(
                x.data_ptr(), g.data_ptr(), A_ROWS, dims[0], din_pad, packed.data_ptr(), 64, len(ws) - 1, dims[-1],
                dout_pad, pre.data_ptr(), dx_out.data_ptr(), parts.data_ptr(), stream), "fused_mlp_bwd")

        ms = time_ms(kernel)
        wrapper = time_ms(lambda: fused_mlp_bwd(x, g, ws, pre, packed=packed))
        plain = time_ms(lambda: fused_mlp_bwd_reference(x, g, ws, pre))
        chain = time_ms(lambda: cublas_chain_bwd(x, g, wb, pre))
        rows.append("D fused_mlp_bwd {} {}: max abs err {:.3e} (tol {} x max|ref|, two calls bit-identical), "
                    "kernel {:.4f} ms (through the wrapper {:.4f} ms), plain {:.4f} ms, bound {:.4f} ms by {} "
                    "({:.1f} MB, {:.2f} GFLOP), bf16 chain of cuBLAS calls (not one call) {:.4f} ms".format(
                        label, "-".join(map(str, dims)), err, D_TOL, ms, wrapper, plain, *bounds[-1], nbytes / 1e6,
                        4 * A_ROWS * kn / 1e9, chain))
        total_ms, total_plain, total_chain = total_ms + ms, total_plain + plain, total_chain + chain
        worst = max(worst, err)
    entry = {"max_abs_err": worst, "ms": total_ms, "plain_ms": total_plain}
    rows.append("D geo + radiance: kernel {:.4f} ms, {}, bf16 cuBLAS chain {:.4f} ms".format(
        total_ms, add_bound(entry, bounds), total_chain))
    return rows, entry


def count_hmma(lib_path, kernels):
    """HMMA instructions in the compiled code of each kernel function named
    in ``kernels`` (cuobjdump -sass of the library, all instantiations), or
    None where cuobjdump is missing."""
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                     "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    counts, current = dict.fromkeys(kernels, 0), None
    for line in sass.splitlines():
        if "Function :" in line:
            current = next((k for k in kernels if k in line), None)
        elif current and "HMMA" in line:
            counts[current] += 1
    return counts


def index_add_updates(xyz, g, shape, res, aabb_min, aabb_len, variant):
    """Kernel E's updates of a stream, precomputed for one ``index_add_``:
    (8 N L,) int64 rows of the (L T, F) table and their (8 N L, F) w * g."""
    from arcnerf_torch.models.base_modules.encoding import _corners_and_weights

    n_levels, table_size, n_feat = shape
    entries, weights = _corners_and_weights(xyz, res, aabb_min, aabb_len, table_size, variant)
    level_off = torch.arange(n_levels, device=xyz.device) * table_size
    gl = g.reshape(xyz.shape[0], n_levels, n_feat)
    idx = torch.cat([(e + level_off).reshape(-1) for e in entries])
    vals = torch.cat([(gl * w[..., None]).reshape(-1, n_feat) for w in weights])
    return idx, vals


def e_entry_point(lib, xyz, g, shape, res, aabb_min, aabb_len, variant):
    """Kernel E through its C entry point in ``lib`` alone: a call that adds
    the stream into one zeroed table of its own, every call again (the same
    atomics; no memset and none of the wrapper's host work). The call holds
    the tensors its pointers name in ``call.tensors`` (xyz, g, res, table)."""
    from arcnerf_torch.models.base_modules.encoding import _VARIANTS
    from arcnerf_torch.ops import cuda_lib

    n_levels, table_size, n_feat = shape
    dev = xyz.device
    res_dev, grad = torch.as_tensor(res, dtype=torch.int32, device=dev), torch.zeros(shape, device=dev)
    args = (xyz.data_ptr(), xyz.shape[0], g.data_ptr(), n_levels, table_size.bit_length() - 1, n_feat,
            res_dev.data_ptr(), cuda_lib.float3(aabb_min), cuda_lib.float3(aabb_len), _VARIANTS[variant],
            grad.data_ptr(), cuda_lib.stream_handle(dev))

    def call():
        cuda_lib.check(lib.arcnerf_hash_encode_bwd(*args), "hash_encode_bwd")

    call.tensors = (xyz, g, res_dev, grad)
    return call


def e_level_split(lib, xyz, g, shape, res, aabb_min, aabb_len, variant):
    """Kernel E's entry point alone on levels 0-1 and on levels 2-(L-1) of
    the stream, one launch each: ms of each."""
    n_pts, (n_levels, table_size, n_feat) = xyz.shape[0], shape
    gl = g.reshape(n_pts, n_levels, n_feat)
    return [time_ms(e_entry_point(lib, xyz, gl[:, lo:hi].reshape(n_pts, -1).contiguous(),
                                  (hi - lo, table_size, n_feat), res[lo:hi], aabb_min, aabb_len, variant))
            for lo, hi in ((0, 2), (2, n_levels))]


def hold_hash_encode_bwd(label, xyz, g, shape, res, aabb_min, aabb_len, variants, main_variant):
    """Kernel E on one stream per variant against its plain version, timed
    through the wrapper (which zeroes the table) and through its C entry
    point alone; for ``main_variant`` also the bound, one ``index_add_`` of
    the stream's precomputed updates into a zeroed table, and levels 0-1
    and 2-(L-1) each alone. Returns rows and the entry."""
    from arcnerf_torch.models.base_modules.encoding import hash_encode_bwd, hash_encode_bwd_reference
    from arcnerf_torch.ops import cuda_lib

    n_pts, (n_levels, table_size, n_feat) = xyz.shape[0], shape
    rows, entry, worst = [], None, 0.0
    for variant in variants:
        args = (xyz, g, shape, res, aabb_min, aabb_len, variant)
        ref = hash_encode_bwd_reference(*args)
        err = check_scaled("hash_encode_bwd {} {}".format(label, variant), hash_encode_bwd(*args), ref, E_TOL)
        worst = max(worst, err)
        ms, alone = time_ms(lambda: hash_encode_bwd(*args)), time_ms(e_entry_point(cuda_lib.lib(), *args))
        plain = time_ms(lambda: hash_encode_bwd_reference(*args))
        rows.append("E hash_encode_bwd {} {} ({} pts, L={}, T=2^{}, F={}): max abs err {:.3e} (tol {} x max|ref|), "
                    "kernel {:.4f} ms (its entry point alone {:.4f} ms), plain {:.4f} ms".format(
                        label, variant, n_pts, n_levels, table_size.bit_length() - 1, n_feat, err, E_TOL, ms,
                        alone, plain))
        if variant != main_variant:
            continue
        idx, vals = index_add_updates(*args)

        def library():
            return torch.zeros((n_levels * table_size, n_feat), device=xyz.device).index_add_(0, idx, vals)

        check_scaled("index_add_ of E's updates " + label, library().reshape(shape), ref, E_TOL)
        entry = {"ms": ms, "plain_ms": plain, "library_ms": time_ms(library), "entry_point_ms": alone}
        del idx, vals
        # xyz and g in, the whole f32 table gradient out; 2 flops a corner and feature
        rows[-1] += ", " + add_bound(entry, [bound(n_pts * (12 + n_levels * n_feat * 4) + n_levels * table_size *
                                                   n_feat * 4, n_pts * n_levels * 8 * n_feat * 2, F32_FLOP_S)])
        rows[-1] += ", library (one index_add_ of the {} precomputed updates) {:.4f} ms".format(
            8 * n_pts * n_levels, entry["library_ms"])
        entry["levels_0_1_ms"], entry["levels_2_up_ms"] = e_level_split(cuda_lib.lib(), *args)
        rows.append("E {} {}: entry point alone on levels 0-1 {:.4f} ms, on levels 2-{} {:.4f} ms".format(
            label, variant, entry["levels_0_1_ms"], n_levels - 1, entry["levels_2_up_ms"]))
    entry["max_abs_err"] = worst
    return rows, entry


def compare_hash_encode_bwd(dev, gen):
    """Kernel E on uniform points in the volume (the stream of the earlier
    slices, kept for continuity); the training stream follows the training
    run (``compare_hash_encode_bwd_stream``)."""
    from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder

    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    xyz = torch.rand((B_POINTS, 3), generator=gen, device=dev) * 2 - 1
    g = torch.randn((B_POINTS, 32), generator=gen, device=dev)
    return hold_hash_encode_bwd("uniform", xyz, g, (16, 1 << 19, 2), enc.resolutions, enc.aabb_min, enc.aabb_len,
                                ("quad", "ngp"), enc.variant)


def capture_training_streams(trainer):
    """One more training step with ``encoding.hash_encode_bwd`` and
    ``ray_helper.segment_march_bwd`` wrapped: the stream kernel E received
    in it (xyz, g, table shape, res, volume, variant; kernel B encoded the
    same xyz), the step's valid sample count, the trained table as the step
    left it with its read precision, and under "march" the compositing
    stream kernels C and F received (sigma, rgb, z, off, cnt, the incoming
    g_rgb, g_depth, g_mask, and the flags and background)."""
    from arcnerf_torch.models.base_modules import encoding
    from arcnerf_torch.render import ray_helper

    enc = next(m for m in trainer.model.modules() if isinstance(m, encoding.HashGridEmbedder))

    inner, seen = encoding.hash_encode_bwd, []
    inner_f, seen_f = ray_helper.segment_march_bwd, []

    def wrapper(xyz, g, table_shape, res, aabb_min, aabb_len, variant, res_dev=None):
        seen.append(dict(xyz=xyz.clone(), g=g.clone(), shape=tuple(table_shape), res=list(res), aabb_min=aabb_min,
                         aabb_len=aabb_len, variant=variant))
        return inner(xyz, g, table_shape, res, aabb_min, aabb_len, variant, res_dev)

    def wrapper_f(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z=False, bkg=None, white_bkg=False,
                  **mode):  # mode: the alpha mode's flag, where the tree has one
        seen_f.append(dict(sigma=sigma.clone(), rgb=radiance.clone(), z=z.clone(), off=off.clone(), cnt=cnt.clone(),
                           g_rgb=g_rgb.clone(), g_depth=g_depth.clone(), g_mask=g_mask.clone(), add_inf_z=add_inf_z,
                           bkg=None if bkg is None else bkg.clone(), white_bkg=white_bkg))
        return inner_f(sigma, radiance, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z, bkg, white_bkg, **mode)

    # each wrapper counts its launch on the module's function: the wrapped
    # one, for this step
    wrapper.launches, wrapper_f.launches = inner.launches, inner_f.launches
    encoding.hash_encode_bwd, ray_helper.segment_march_bwd = wrapper, wrapper_f
    try:
        stats = trainer.train_step(trainer.step)
    finally:
        encoding.hash_encode_bwd, inner.launches = inner, wrapper.launches
        ray_helper.segment_march_bwd, inner_f.launches = inner_f, wrapper_f.launches
    if len(seen) != 1 or len(seen_f) != 1:
        raise AssertionError("a training step called kernel E {} and kernel F {} times, not once each".format(
            len(seen), len(seen_f)))
    stream = seen[0]
    stream.update(n_valid=int(stats["n_valid_pts"]), table=enc.embeddings.detach().clone(), read_bf16=enc.read_bf16,
                  march=seen_f[0])
    return stream


def compare_hash_encode_stream(stream):
    """Kernel B on the points one training step encodes (the xyz of kernel
    E's stream) with the trained table, against its plain version; timed
    as the step calls it (the levels' resolutions already on the card) in a
    CUDA graph and through CUDA events, beside the bound of the table
    entries those points reach."""
    from arcnerf_torch.models.base_modules.encoding import _corners_and_weights, hash_encode, hash_encode_reference

    xyz, table, variant = stream["xyz"], stream["table"], stream["variant"]
    n_levels, table_size, n_feat = table.shape
    args = (xyz, table, stream["res"], stream["aabb_min"], stream["aabb_len"], variant, stream["read_bf16"])
    res_dev = torch.as_tensor(np.asarray(stream["res"]), dtype=torch.int32, device=xyz.device)
    out, ref = hash_encode(*args, res_dev=res_dev), hash_encode_reference(*args)
    check_close("hash_encode training " + variant, out, ref, B_TOL, 0.0)
    entry = {"max_abs_err": max_err(out, ref), "ms": graph_ms(lambda: hash_encode(*args, res_dev=res_dev)),
             "events_ms": time_ms(lambda: hash_encode(*args, res_dev=res_dev)),
             "plain_ms": time_ms(lambda: hash_encode_reference(*args))}
    del out, ref
    entries, _ = _corners_and_weights(xyz, stream["res"], stream["aabb_min"], stream["aabb_len"], table_size, variant)
    level_off = torch.arange(n_levels, device=xyz.device) * table_size
    touched = n_unique(torch.cat([(e + level_off).reshape(-1) for e in entries]))
    n_pts = xyz.shape[0]
    # xyz in, (N, L F) f32 out, the f32 entries the corners reach; 2 flops a corner and feature
    suffix = add_bound(entry, [bound(n_pts * (12 + n_levels * n_feat * 4) + touched * n_feat * 4,
                                     n_pts * n_levels * 8 * n_feat * 2, F32_FLOP_S)])
    entry["touched_entries"] = touched
    row = "B hash_encode training stream ({} pts, {} variant, trained table, {} entries reached): max abs err {:.3e} " \
          "(tol {}), kernel {:.4f} ms (CUDA graph; CUDA events {:.4f} ms; parent {} ms, PERF.md), plain {:.4f} ms, " \
          "{}".format(n_pts, variant, touched, entry["max_abs_err"], B_TOL, entry["ms"], entry["events_ms"],
                      PARENT_MS["B"], entry["plain_ms"], suffix)
    return [row], entry


def compare_hash_encode_bwd_stream(stream):
    """Kernel E on the stream it received in one training step: its rows,
    how many are valid and how many are padding (g = 0), then the
    comparison and times of ``hold_hash_encode_bwd``."""
    xyz, g = stream["xyz"], stream["g"]
    n_pts = xyz.shape[0]
    in_stream = min(stream["n_valid"], n_pts)
    pad_zero = int((g[in_stream:] == 0).all(dim=1).sum())
    zero_rows = int((g == 0).all(dim=1).sum())
    head = "E training stream ({} variant): {} rows, {} valid samples in the step, {} in the stream, {} padding " \
           "rows ({} of them g = 0), {} rows with g = 0 in all".format(
               stream["variant"], n_pts, stream["n_valid"], in_stream, n_pts - in_stream, pad_zero, zero_rows)
    if pad_zero != n_pts - in_stream:
        raise AssertionError("E training stream: a padding row carries a gradient")
    rows, entry = hold_hash_encode_bwd("training", xyz, g, stream["shape"], stream["res"], stream["aabb_min"],
                                       stream["aabb_len"], (stream["variant"],), stream["variant"])
    entry.update(n_pts=n_pts, n_valid=stream["n_valid"], padding_rows=n_pts - in_stream)
    return [head] + rows, entry


def march_stream(dev, gen, n_rays, k):
    """A compacted stream as the main path makes it: segments of 0-32
    samples, the last ones clipped by the budget, z ascending inside each
    segment on a fixed-step ladder with gaps of 0 (crushed deltas), 1 or 2
    steps."""
    tot = torch.randint(0, 33, (n_rays,), generator=gen, device=dev)
    off = torch.cumsum(tot, 0) - tot
    cnt = torch.minimum((k - off).clamp_min(0), tot)
    sigma = torch.randn((k,), generator=gen, device=dev) * 20
    rgb = torch.rand((k, 3), generator=gen, device=dev)
    steps = torch.cumsum(torch.randint(0, 3, (k,), generator=gen, device=dev), 0)
    ray_id = torch.repeat_interleave(torch.arange(n_rays, device=dev), cnt)
    z = 2.0 + torch.rand((k,), generator=gen, device=dev)
    z[: ray_id.shape[0]] = 2.0 + 0.0068 * (steps[: ray_id.shape[0]] - steps[off[ray_id]]).float()
    return sigma, rgb, z, off, cnt


def compare_segment_march_bwd(dev, gen):
    from arcnerf_torch.render.ray_helper import segment_march_bwd, segment_march_bwd_reference

    sigma, rgb, z, off, cnt = march_stream(dev, gen, C_RAYS, C_STREAM)
    bkg = torch.rand((C_RAYS, 3), generator=gen, device=dev)
    g_rgb = torch.randn((C_RAYS, 3), generator=gen, device=dev)
    g_depth, g_mask = (torch.randn((C_RAYS,), generator=gen, device=dev) for _ in range(2))
    args = (sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, False, bkg)
    (d_sigma, d_rgb), (r_sigma, r_rgb) = segment_march_bwd(*args), segment_march_bwd_reference(*args)
    err = max(check_scaled("segment_march_bwd d_sigma", d_sigma, r_sigma, F_TOL),
              check_scaled("segment_march_bwd d_rgb", d_rgb, r_rgb, F_TOL))
    ms, plain = time_ms(lambda: segment_march_bwd(*args)), time_ms(lambda: segment_march_bwd_reference(*args), 3)
    entry = {"max_abs_err": err, "ms": ms, "plain_ms": plain, "graph_ms": graph_ms(lambda: segment_march_bwd(*args))}
    suffix = add_bound(entry, [f_bound(cnt, C_RAYS, C_STREAM)])
    row = "F segment_march_bwd (16384 rays, 2^18 stream): max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} ms " \
          "(CUDA graph {:.4f} ms; parent {} ms, PERF.md), plain {:.4f} ms, {}; segments: {}".format(
              err, F_TOL, ms, entry["graph_ms"], PARENT_MS["F"], plain, suffix,
              length_text(segment_lengths(off, cnt, C_STREAM)))
    return [row], entry


def segment_lengths(off, cnt, k_total):
    """The samples of each ray's segment inside the stream (clipped by the
    budget, as kernels C and F read them)."""
    return (off + cnt).clamp_max(k_total) - off.clamp_max(k_total)


def length_summary(n):
    """The distribution of segment lengths ``n`` (int64, one a ray)."""
    nf = n.double()
    q = torch.quantile(nf, torch.tensor([0.5, 0.9, 0.99], dtype=torch.float64, device=n.device)).tolist()
    total = max(int(n.sum()), 1)
    return {"rays": n.numel(), "empty": int((n == 0).sum()), "samples": int(n.sum()), "mean": float(nf.mean()),
            "p50": q[0], "p90": q[1], "p99": q[2], "max": int(n.max()), "above_4": int((n > 4).sum()),
            "above_8": int((n > 8).sum()), "above_16": int((n > 16).sum()),
            "above_32": int((n > 32).sum()), "above_128": int((n > 128).sum()),
            "samples_above_32": int(n[n > 32].sum()) / total}


def length_text(n):
    d = length_summary(n)
    return ("{rays} rays ({empty} empty), {samples} samples, mean {mean:.2f}, p50 {p50:.0f}, p90 {p90:.0f}, "
            "p99 {p99:.0f}, max {max}; {above_4} rays above 4, {above_8} above 8, {above_16} above 16, {above_32} "
            "above 32 (holding {samples_above_32:.1%} "
            "of the samples), {above_128} above 128".format(**d))


def compare_march_stream(march):
    """Kernels C and F on the compositing stream one training step hands
    them, against their plain versions (C_TOL, F_TOL), each timed from a
    CUDA graph and through CUDA events, beside its bound; and the stream's
    segment-length distribution."""
    from arcnerf_torch.render.ray_helper import (segment_march_bwd, segment_march_bwd_reference, segment_march_fwd,
                                                 segment_march_reference)

    sigma, rgb, z, off, cnt = (march[k] for k in ("sigma", "rgb", "z", "off", "cnt"))
    flags = (march["add_inf_z"], march["bkg"], march["white_bkg"])
    n_rays, k_total = off.shape[0], z.shape[0]
    lengths = segment_lengths(off, cnt, k_total)
    rows = ["compositing stream of a training step: {} rows, add_inf_z {}, bkg {}, white_bkg {}; segments: {}".format(
        k_total, flags[0], "per ray" if flags[1] is not None else None, flags[2], length_text(lengths))]
    out, ref = segment_march_fwd(sigma, rgb, z, off, cnt, *flags), segment_march_reference(sigma, rgb, z, off, cnt,
                                                                                           *flags)
    err = 0.0
    for k in ("rgb", "depth", "mask", "trans_end"):
        check_close("segment_march captured " + k, out[k], ref[k], C_TOL, C_TOL)
        err = max(err, max_err(out[k], ref[k]))
    c = {"max_abs_err": err, "ms": graph_ms(lambda: segment_march_fwd(sigma, rgb, z, off, cnt, *flags)),
         "events_ms": time_ms(lambda: segment_march_fwd(sigma, rgb, z, off, cnt, *flags)),
         "plain_ms": time_ms(lambda: segment_march_reference(sigma, rgb, z, off, cnt, *flags), 3)}
    suffix = add_bound(c, [c_bound(lengths, n_rays)])
    rows.append("C segment_march captured stream ({} rays): max abs err {:.3e} (tol {} rel), kernel {:.4f} ms (CUDA "
                "graph; CUDA events {:.4f} ms; parent {} ms, PERF.md), plain {:.4f} ms, {}".format(
                    n_rays, err, C_TOL, c["ms"], c["events_ms"], PARENT_MS["C captured"], c["plain_ms"], suffix))
    args = (sigma, rgb, z, off, cnt, march["g_rgb"], march["g_depth"], march["g_mask"], *flags)
    (d_sigma, d_rgb), (r_sigma, r_rgb) = segment_march_bwd(*args), segment_march_bwd_reference(*args)
    err = max(check_scaled("segment_march_bwd captured d_sigma", d_sigma, r_sigma, F_TOL),
              check_scaled("segment_march_bwd captured d_rgb", d_rgb, r_rgb, F_TOL))
    f = {"max_abs_err": err, "ms": graph_ms(lambda: segment_march_bwd(*args)),
         "events_ms": time_ms(lambda: segment_march_bwd(*args)),
         "plain_ms": time_ms(lambda: segment_march_bwd_reference(*args), 3)}
    suffix = add_bound(f, [f_bound(lengths, n_rays, k_total)])
    rows.append("F segment_march_bwd captured stream ({} rays): max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} "
                "ms (CUDA graph; CUDA events {:.4f} ms), plain {:.4f} ms, {}".format(
                    n_rays, err, F_TOL, f["ms"], f["events_ms"], f["plain_ms"], suffix))
    return rows, {"C": c, "F": f, "lengths": length_summary(lengths)}


# the fused sampler at the main paths' shapes: (label, rays, jitter, cap,
# budget, window offset) on the scene's occupancy with a tenth of the rays
# missing, 512 ladder slots a ray; the window mode on a chunk of the
# windowed tier at cap 8, its ninth window (offset 8 x cap)
S_SLOTS = 512
S_CASES = (("training step", 16384, True, None, 1 << 18, None), ("serving chunk", 16384, False, 16, 1 << 18, None),
           ("last serving chunk", 1024, False, 16, 16384, None),
           ("serving window", 16384, False, 8, 1 << 17, 64))
S_KEYS = ("z", "pts", "dirs", "off", "cnt", "n_valid", "ray_has")


def s_bound(n_rays, jitter, budget):
    """The sampler's least bytes: each ray's origin and direction read once
    (24 bytes), its off, cnt and flag written (17), the jitter read once,
    the stream written (28 bytes a row)."""
    return bound(41 * n_rays + (4 * n_rays * S_SLOTS if jitter else 0) + 28 * budget, 0, F32_FLOP_S)


def compare_sample_compact(dev, gen):
    """The fused sampler on S_CASES against its plain version, bit for bit;
    timed through CUDA events (the mean of 20 calls), from a CUDA graph,
    its count and scan alone from a CUDA graph, and the plain version."""
    from arcnerf_torch.models.base_modules import sample_compact as sampler
    from arcnerf_torch.tools.sample_streams import ladder_bitfield, ladder_rand, ladder_rays, ladder_volume

    vol = ladder_volume()
    bitfield = ladder_bitfield("scene", vol, SEED, device=dev)
    rows, entry = [], {"cases": {}}
    for label, n_rays, jitter, cap, budget, offset in S_CASES:
        o, d = ladder_rays(vol, n_rays, SEED, 0.1, device=dev)
        rand = ladder_rand(n_rays, S_SLOTS, SEED + 1, device=dev) if jitter else None
        args = (vol, bitfield, o, d, S_SLOTS, budget, cap, rand)
        window = {} if offset is None else {"offset": offset}

        def run():
            return sampler.sample_compact(*args, **window)

        def plain():
            return sampler.sample_compact(*args, count=sampler.sample_count_reference, **window)

        got, want = run(), plain()
        for k in S_KEYS + (("n_win", "tail") if window else ()):
            if not torch.equal(got[k], want[k]):
                raise AssertionError("sampler {}: {} is not bit-identical to the plain version".format(label, k))
        c = {"max_abs_err": 0.0, "ms": graph_ms(run), "events_ms": time_ms(run),
             "count_ms": graph_ms(lambda: sampler.sample_count(*args, **window)), "plain_ms": time_ms(plain, 3),
             "n_valid": int(got["n_valid"]), "kept": int(got["cnt"].sum())}
        del got, want
        suffix = add_bound(c, [s_bound(n_rays, jitter, budget)])
        rows.append("S sample_compact {} ({} rays x {} slots, jitter {}, cap {}, budget {}, window offset {}; {} valid, "
                    "{} kept): bit-identical, kernel {:.4f} ms (CUDA graph; count + scan {:.4f} ms; CUDA events "
                    "{:.4f} ms), plain {:.4f} ms, {}".format(label, n_rays, S_SLOTS, jitter, cap, budget, offset,
                                                             c["n_valid"], c["kept"], c["ms"], c["count_ms"],
                                                             c["events_ms"], c["plain_ms"], suffix))
        entry["cases"][label] = c
    entry.update(entry["cases"]["training step"])
    return rows, entry


def compare_serving_chunk(march):
    """Kernel C on the compacted stream of one 16384-ray chunk of the
    800x800 serving frame (``capture_chunk``), against its plain version
    (C_TOL), timed from a CUDA graph and through CUDA events beside its
    bound, with the chunk's segment-length distribution."""
    from arcnerf_torch.render.ray_helper import segment_march_fwd, segment_march_reference

    sigma, rgb, z, off, cnt = (march[k] for k in ("sigma", "rgb", "z", "off", "cnt"))
    flags, kwargs = (march["add_inf_z"], march["bkg"], march["white_bkg"]), march["kwargs"]
    n_rays, k_total = off.shape[0], z.shape[0]
    lengths = segment_lengths(off, cnt, k_total)
    out, ref = segment_march_fwd(sigma, rgb, z, off, cnt, *flags, **kwargs), segment_march_reference(
        sigma, rgb, z, off, cnt, *flags)
    err = 0.0
    for k in ("rgb", "depth", "mask", "trans_end"):
        check_close("segment_march serving " + k, out[k], ref[k], C_TOL, C_TOL)
        err = max(err, max_err(out[k], ref[k]))
    c = {"max_abs_err": err, "ms": graph_ms(lambda: segment_march_fwd(sigma, rgb, z, off, cnt, *flags, **kwargs)),
         "events_ms": time_ms(lambda: segment_march_fwd(sigma, rgb, z, off, cnt, *flags, **kwargs)),
         "plain_ms": time_ms(lambda: segment_march_reference(sigma, rgb, z, off, cnt, *flags), 3),
         "lengths": length_summary(lengths)}
    suffix = add_bound(c, [c_bound(lengths, n_rays)])
    rows = ["C segment_march serving chunk {} ({} rays, {} rows, add_inf_z {}, bkg {}, white_bkg {}, {}): max abs err "
            "{:.3e} (tol {} rel), kernel {:.4f} ms (CUDA graph; CUDA events {:.4f} ms; parent {} ms, PERF.md), plain "
            "{:.4f} ms, {}; segments: {}".format(SERVE_CHUNK, n_rays, k_total, flags[0],
                                                 "per ray" if flags[1] is not None else None, flags[2],
                                                 kwargs or "no keywords", err, C_TOL, c["ms"], c["events_ms"],
                                                 PARENT_MS["C serving"], c["plain_ms"], suffix, length_text(lengths))]
    return rows, c


def compare_serving_window(dev, march):
    """Kernel C's tail mode on the stream S writes for S_CASES' serving
    window (a chunk of the windowed tier: 16384 rays, cap 8, its ninth
    window, each ray's tail), at the capped group width, against its plain
    version (C_TOL); sigma and rgb drawn from the valid rows of the serving
    chunk (``capture_chunk``), so that they have its scale. Timed from a
    CUDA graph and through CUDA events beside its bound."""
    from arcnerf_torch.models.base_modules import sample_compact as sampler
    from arcnerf_torch.render.ray_helper import march_group, segment_march_fwd, segment_march_reference
    from arcnerf_torch.tools.sample_streams import ladder_bitfield, ladder_rays, ladder_volume

    label, n_rays, _, cap, budget, offset = S_CASES[-1]
    vol = ladder_volume()
    o, d = ladder_rays(vol, n_rays, SEED, 0.1, device=dev)
    stream = sampler.sample_compact(vol, ladder_bitfield("scene", vol, SEED, device=dev), o, d, S_SLOTS, budget, cap,
                                    offset=offset)
    z, off, cnt, tail = (stream[k] for k in ("z", "off", "cnt", "tail"))
    n_src = int(march["cnt"].sum())
    pick = torch.randint(0, n_src, z.shape, generator=torch.Generator(device=dev).manual_seed(SEED), device=dev)
    sigma, rgb = march["sigma"][pick].contiguous(), march["rgb"][pick].contiguous()
    flags, group = (march["add_inf_z"], None, False), march_group(cap)
    n_tail = int((torch.isfinite(tail) & (cnt > 0)).sum())
    if n_tail == 0:
        raise AssertionError("segment_march serving window: no ray marches to a tail")

    def run():
        return segment_march_fwd(sigma, rgb, z, off, cnt, *flags, group=group, tail=tail)

    def plain():
        return segment_march_reference(sigma, rgb, z, off, cnt, *flags, tail=tail)

    out, ref = run(), plain()
    err = 0.0
    for k in ("rgb", "depth", "mask", "trans_end"):
        check_close("segment_march serving window " + k, out[k], ref[k], C_TOL, C_TOL)
        err = max(err, max_err(out[k], ref[k]))
    lengths = segment_lengths(off, cnt, z.shape[0])
    c = {"max_abs_err": err, "ms": graph_ms(run), "events_ms": time_ms(run), "plain_ms": time_ms(plain, 3),
         "lengths": length_summary(lengths), "rays_with_tail": n_tail}
    suffix = add_bound(c, [c_bound(lengths, n_rays, tail=True)])
    rows = ["C segment_march {} ({} rays, {} rows, cap {}, window offset {}, {} lanes a ray, add_inf_z {}, {} rays "
            "with a tail): max abs err {:.3e} (tol {} rel), kernel {:.4f} ms (CUDA graph; CUDA events {:.4f} ms), "
            "plain {:.4f} ms, {}; segments: {}".format(label, n_rays, z.shape[0], cap, offset, group, flags[0], n_tail,
                                                       err, C_TOL, c["ms"], c["events_ms"], c["plain_ms"], suffix,
                                                       length_text(lengths))]
    return rows, c


def hold(key, label, run, plain, tol, cost, library=None, graph=False):
    """One kernel case against its plain version: bit-identical when ``tol``
    is 0, else within ``tol`` x max|plain|; timed both ways, and ``library``
    (one PyTorch call of the same function) where given; with ``graph`` the
    kernel and the library call are also replayed from a CUDA graph
    (``graph_ms``, ``library_graph_ms``: device time without the host's
    launch work). ``cost`` is (bytes, flops, peak) for the bound. Returns
    the printed row and the case's numbers."""
    out, ref = run(), plain()
    if tol == 0:
        if not torch.equal(out, ref):
            raise AssertionError("{} {}: not bit-identical to plain (max abs err {})".format(
                key, label, max_err(out.float(), ref.float())))
        err = 0.0
    else:
        err = check_scaled("{} {}".format(key, label), out, ref, tol)
    del out, ref
    entry = {"max_abs_err": err, "ms": time_ms(run), "plain_ms": time_ms(plain),
             "library_ms": time_ms(library) if library is not None else None}
    suffix = add_bound(entry, [bound(*cost)])
    row = "{} {}: max abs err {:.3e} ({}), kernel {:.4f} ms, plain {:.4f} ms, {}".format(
        key, label, err, "bit-identical" if tol == 0 else "tol {} x max|ref|".format(tol), entry["ms"],
        entry["plain_ms"], suffix)
    if library is not None:
        row += ", library {:.4f} ms (kernel / library {:.2f})".format(entry["library_ms"],
                                                                      entry["ms"] / entry["library_ms"])
    if graph:
        entry["graph_ms"] = graph_ms(run)
        row += "; from a CUDA graph: kernel {:.4f} ms".format(entry["graph_ms"])
        if library is not None:
            entry["library_graph_ms"] = graph_ms(library)
            row += ", library {:.4f} ms (kernel / library {:.2f})".format(
                entry["library_graph_ms"], entry["graph_ms"] / entry["library_graph_ms"])
    return row, entry


def hold_all(key, cases, tol, graph=False):
    """``hold`` over (label, run, plain, cost, library) cases; the entry
    carries the worst error and the last (largest) case's numbers."""
    rows, worst, entry = [], 0.0, None
    for case in cases:
        row, entry = hold(key, *case[:3], tol, *case[3:], graph=graph)
        rows.append(row)
        worst = max(worst, entry["max_abs_err"])
    entry["max_abs_err"] = worst
    return rows, entry


def _index(gen, dev, high, shape):
    return torch.randint(0, high, shape, generator=gen, device=dev, dtype=torch.int32)


def compare_row_gather(dev, gen):
    from arcnerf_torch.ops.gather_scatter import row_gather, row_gather_reference

    cases = []
    for label, n_table, n_rows, dtype in (("vmem_gather (2^14, 128) bf16, 2^15 rows", 1 << 14, 1 << 15, torch.bfloat16),
                                          ("case_a/taa0 (2048, 128) f32, 1024 rows", 2048, 1024, torch.float32),
                                          ("case_onehot (2048, 128) bf16, 1024 rows", 2048, 1024, torch.bfloat16),
                                          ("case_e (1024, 128) f32, 1024 rows", 1024, 1024, torch.float32),
                                          ("loop_gather (2^19, 128) f32, 2^21 rows", 1 << 19, 1 << 21, torch.float32)):
        table = torch.randn((n_table, 128), generator=gen, device=dev).to(dtype)
        idx = _index(gen, dev, n_table, (n_rows,))
        row_bytes = 128 * table.element_size()
        # the indices and the distinct rows they name in, the rows out
        cost = (n_rows * 4 + (n_unique(idx) + n_rows) * row_bytes, 0, F32_FLOP_S)
        cases.append((label, lambda t=table, i=idx: row_gather(t, i), lambda t=table, i=idx: row_gather_reference(t, i),
                      cost, lambda t=table, i=idx: torch.index_select(t, 0, i)))
    return hold_all("G row_gather", cases, 0, graph=True)


def compare_lane_gather(dev, gen):
    from arcnerf_torch.ops.gather_scatter import lane_gather, lane_gather_reference

    cases = []
    for label, m, width, idx_rows, n in (("case_take_1d (1, 2048), 1024 idx", 1, 2048, 1, 1024),
                                         ("case_taa1/b/d (8, 2048), shared 1024 idx", 8, 2048, 1, 1024),
                                         ("case_lane_gather (8, 2048), per-row idx", 8, 2048, 8, 2048),
                                         ("lane_gather (8, 2^19), per-row idx", 8, 1 << 19, 8, 1 << 19)):
        src = torch.randn((m, width), generator=gen, device=dev)
        idx = _index(gen, dev, width, (idx_rows, n))
        # the indices and the distinct lanes they name in, (m, n) f32 out
        touched = n_unique(idx) * m if idx_rows == 1 else sum(n_unique(r) for r in idx)
        cost = (idx.numel() * 4 + (touched + m * n) * 4, 0, F32_FLOP_S)
        idx64 = idx.long().expand(m, -1).contiguous()
        cases.append((label, lambda s=src, i=idx: lane_gather(s, i), lambda s=src, i=idx: lane_gather_reference(s, i),
                      cost, lambda s=src, i=idx64: torch.gather(s, 1, i)))
    return hold_all("H lane_gather", cases, 0, graph=True)


def compare_scatter_add_rows(dev, gen):
    from arcnerf_torch.ops.gather_scatter import scatter_add_rows, scatter_add_rows_reference

    cases = []
    for label, n_table, width, n in (("case_scatter_ref 1024 rows -> (2048, 128)", 2048, 128, 1024),
                                     ("probe_scatter d 2^21 rows -> (8192, 128)", 8192, 128, 1 << 21),
                                     ("cons_forms tail 2^20 rows -> (16384, 128)", 16384, 128, 1 << 20),
                                     ("probe_scatter f 2^18 -> 64^3 entries, W=1", 64 ** 3, 1, 1 << 18),
                                     ("kernel E's scale 2^25 -> 2^23 entries, W=1", 1 << 23, 1, 1 << 25)):
        idx = _index(gen, dev, n_table, (n,))
        g = torch.randn((n, width), generator=gen, device=dev)

        def zeros(rows=n_table, w=width):
            return torch.zeros((rows, w), device=dev)

        # the indices and rows in, the zeroed table out; 1 f32 add a value
        cost = (n * 4 + n * width * 4 + n_table * width * 4, n * width, F32_FLOP_S)
        cases.append((label, lambda i=idx, g=g, z=zeros: scatter_add_rows(z(), i, g),
                      lambda i=idx, g=g, z=zeros: scatter_add_rows_reference(z(), i, g), cost,
                      lambda i=idx, g=g, z=zeros: z().index_add_(0, i, g)))
    rows, entry = hold_all("I scatter_add_rows", cases, I_TOL, graph=True)
    rows[-1] += "; parent {} ms, PERF.md".format(PARENT_MS["I"])
    return rows, entry


def compare_scatter_w1(dev, gen):
    """Kernel I at kernel E's scale, 2^25 updates into 2^23 entries, W=1,
    added in place into one table, against its plain version and timed from
    a CUDA graph beside index_add_ (``arcnerf_torch.tools.ab_step`` runs it
    on a parent tree too). Returns the row."""
    from arcnerf_torch.ops.gather_scatter import scatter_add_rows, scatter_add_rows_reference

    n_table, n = 1 << 23, 1 << 25
    idx = _index(gen, dev, n_table, (n,))
    g = torch.randn((n, 1), generator=gen, device=dev)
    out = scatter_add_rows(torch.zeros((n_table, 1), device=dev), idx, g)
    err = check_scaled("I scatter_add_rows W=1", out, scatter_add_rows_reference(torch.zeros_like(out), idx, g), I_TOL)
    ms, library = graph_ms(lambda: scatter_add_rows(out, idx, g)), graph_ms(lambda: out.index_add_(0, idx, g))
    events, library_events = time_ms(lambda: scatter_add_rows(out, idx, g)), time_ms(lambda: out.index_add_(0, idx, g))
    return "I scatter_add_rows W=1 2^25 -> 2^23 in place: max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} ms " \
           "(CUDA graph; CUDA events {:.4f} ms; parent {} ms, PERF.md), index_add_ {:.4f} ms (CUDA graph; CUDA " \
           "events {:.4f} ms)".format(err, I_TOL, ms, events, PARENT_MS["I"], library, library_events)


def compare_update_rows(dev, gen):
    """Kernel J at the probe's two geometries, bit-identical to its plain
    version, timed both ways beside its ``scatter_add_`` yardstick (its index
    made outside the timed call) and the parent's time. The entry carries
    pair's numbers (the larger) and quad's under "quad"."""
    from arcnerf_torch.ops.gather_scatter import LANES, build_update_rows, build_update_rows_reference
    from arcnerf_torch.tools.probe_cons_forms import build_scatter_add, scatter_add_index

    rows, entries = [], {}
    for key, label, k, offs in (("quad", "quad K=2^19, offs (0, 2, 62, 64), F=2", 1 << 19, (0, 2, 62, 64)),
                                ("pair", "pair K=2^20, offs (0, 2), F=2", 1 << 20, (0, 2))):
        lane0 = _index(gen, dev, 60, (k,))
        vals = torch.rand((k, len(offs) * 2), generator=gen, device=dev)
        idx = scatter_add_index(lane0, offs, 2)
        if not torch.equal(build_scatter_add(idx, vals), build_update_rows_reference(lane0, vals, offs, 2)):
            raise AssertionError("J {}: the scatter_add_ yardstick differs from the plain version".format(key))
        # lane0 and the values in, (K, 128) f32 rows out
        cost = (k * 4 + vals.numel() * 4 + k * LANES * 4, vals.numel(), F32_FLOP_S)
        row, entries[key] = hold("J build_update_rows", label, lambda: build_update_rows(lane0, vals, offs, 2),
                                 lambda: build_update_rows_reference(lane0, vals, offs, 2), 0, cost,
                                 library=lambda: build_scatter_add(idx, vals), graph=True)
        rows.append(row + "; parent {} ms (CUDA graph), PERF.md".format(PARENT_MS["J " + key]))
        del lane0, vals, idx
    entry = dict(entries["pair"], quad=entries["quad"])
    entry["max_abs_err"] = max(e["max_abs_err"] for e in entries.values())
    return rows, entry


LAUNCH_CALLS = 2000  # back-to-back calls a host-time reading


def host_us(fn, n=LAUNCH_CALLS):
    """Host microseconds a call: ``time.perf_counter`` over ``n``
    back-to-back calls (after a warm-up), read before the one synchronize
    that ends the run; at the launch path's small shapes the card keeps up,
    so this is the host's work a call."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def launch_path(dev, gen):
    """Host microseconds a call of every kernel's wrapper (A-J) at a small
    shape, beside the same launch through its C entry point by ctypes
    (argument conversion, a stream lookup and a status check a call, the
    outputs made once: the launch mechanism of the ctypes wrappers, without
    their Python checks and allocations) and the PyTorch calls of G, H and
    I. Uses only names the earlier trees of the port also have, so
    ``arcnerf_torch.tools.ab_step`` runs it on a parent tree too. Returns
    {key: {"host_us", "ctypes_us"[, "library_host_us"]}} and the rows."""
    import ctypes

    from arcnerf_torch.models.base_modules.encoding import hash_encode, hash_encode_bwd
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.ops.fused_mlp import fused_mlp_bwd, fused_mlp_fwd, pack_weights
    from arcnerf_torch.ops.gather_scatter import build_update_rows, lane_gather, row_gather, scatter_add_rows
    from arcnerf_torch.render.ray_helper import segment_march_bwd, segment_march_fwd

    lib, f32 = cuda_lib.lib(), dict(device=dev)

    def entry(name, *args):  # one launch through ctypes, the stream looked up a call
        fn = getattr(lib, "arcnerf_" + name)
        return lambda: cuda_lib.check(fn(*[a() if callable(a) else a for a in args], cuda_lib.stream_handle(dev)),
                                      name)

    def ptr(t):
        return t.data_ptr

    def since(name, n_args, *args):  # arguments a launcher gained later: none for a tree from before
        return args if len(cuda_lib._SIGNATURES[name]) >= n_args else ()

    rows = 64
    x = torch.randn((rows, 32), generator=gen, **f32)
    ws = _chain([32, 64, 16], gen, dev)
    packed = pack_weights(ws, 32, 16, dev)
    _, pre = fused_mlp_fwd(x, ws, save_pre=True, packed=packed)
    g16 = torch.randn((rows, 16), generator=gen, **f32)
    out16, dx, parts = torch.empty((rows, 16), **f32), torch.empty_like(x), torch.empty((1, packed.numel()), **f32)
    xyz = torch.rand((rows, 3), generator=gen, **f32) * 2 - 1
    shape, res, lo, span = (2, 1 << 10, 2), [3, 7], np.full(3, -1.0, np.float32), np.full(3, 2.0, np.float32)
    table = torch.rand(shape, generator=gen, **f32)
    res_dev = torch.as_tensor(res, dtype=torch.int32, device=dev)
    g4, enc_out, grad = torch.randn((rows, 4), generator=gen, **f32), torch.empty((rows, 4), **f32), torch.empty(shape,
                                                                                                                 **f32)
    sigma, rgb, z, off, cnt = march_stream(dev, gen, rows, 1024)
    bkg, g_rgb = torch.rand((rows, 3), generator=gen, **f32), torch.randn((rows, 3), generator=gen, **f32)
    g_depth, g_mask = torch.randn((rows,), generator=gen, **f32), torch.randn((rows,), generator=gen, **f32)
    march_out = [torch.empty((rows, 3), **f32)] + [torch.empty((rows,), **f32) for _ in range(3)]
    d_sigma, d_rgb = torch.empty_like(sigma), torch.empty_like(rgb)
    gtab, gidx = torch.randn((1024, 128), generator=gen, **f32), _index(gen, dev, 1024, (1024,))
    gout = torch.empty((1024, 128), **f32)
    src, hidx = torch.randn((1, 2048), generator=gen, **f32), _index(gen, dev, 2048, (1, 1024))
    hidx64, hout = hidx.long(), torch.empty((1, 1024), **f32)
    itab, iidx = torch.zeros((2048, 128), **f32), _index(gen, dev, 2048, (1024,))
    ig = torch.randn((1024, 128), generator=gen, **f32)
    lane0, vals, jout = _index(gen, dev, 60, (1024,)), torch.rand((1024, 4), generator=gen, **f32), torch.empty(
        (1024, 128), **f32)
    k = z.shape[0]
    cases = {
        "A": (lambda: fused_mlp_fwd(x, ws, packed=packed),
              entry("fused_mlp_fwd", ptr(x), rows, 32, 32, ptr(packed), 64, 1, 16, 16, ptr(out16), None), None),
        "B": (lambda: hash_encode(xyz, table, res, lo, span, "ngp", True, res_dev),
              entry("hash_encode_fwd", ptr(xyz), rows, ptr(table), 2, 10, 2, ptr(res_dev),
                    lambda: cuda_lib.float3(lo), lambda: cuda_lib.float3(span), 0, 1, ptr(enc_out)), None),
        "C": (lambda: segment_march_fwd(sigma, rgb, z, off, cnt, bkg=bkg),
              entry("segment_march_fwd", ptr(sigma), ptr(rgb), ptr(z), ptr(off), ptr(cnt), rows, k, 0, ptr(bkg), 0,
                    *since("arcnerf_segment_march_fwd", 16, 32), *since("arcnerf_segment_march_fwd", 17, None),
                    *[ptr(t) for t in march_out]), None),
        "D": (lambda: fused_mlp_bwd(x, g16, ws, pre, packed=packed),
              entry("fused_mlp_bwd", ptr(x), ptr(g16), rows, 32, 32, ptr(packed), 64, 1, 16, 16, ptr(pre), ptr(dx),
                    ptr(parts)), None),
        "E": (lambda: hash_encode_bwd(xyz, g4, shape, res, lo, span, "ngp", res_dev),
              entry("hash_encode_bwd", ptr(xyz), rows, ptr(g4), 2, 10, 2, ptr(res_dev), lambda: cuda_lib.float3(lo),
                    lambda: cuda_lib.float3(span), 0, ptr(grad)), None),
        "F": (lambda: segment_march_bwd(sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, False, bkg),
              entry("segment_march_bwd", ptr(sigma), ptr(rgb), ptr(z), ptr(off), ptr(cnt), rows, k, 0, ptr(bkg), 0,
                    ptr(g_rgb), ptr(g_depth), ptr(g_mask), ptr(d_sigma), ptr(d_rgb)), None),
        "G": (lambda: row_gather(gtab, gidx), entry("row_gather", ptr(gtab), 1024, 512, ptr(gidx), 1024, ptr(gout)),
              ("index_select", lambda: torch.index_select(gtab, 0, gidx))),
        "H": (lambda: lane_gather(src, hidx), entry("lane_gather", ptr(src), 1, 2048, ptr(hidx), 0, 1024, ptr(hout)),
              ("gather", lambda: torch.gather(src, 1, hidx64))),
        "I": (lambda: scatter_add_rows(itab, iidx, ig),
              entry("scatter_add_rows", ptr(itab), 2048, 128, ptr(iidx), ptr(ig), 1024,
                    *since("arcnerf_scatter_add_rows", 9, None, 0)),
              ("index_add_", lambda: itab.index_add_(0, iidx, ig))),
        "J": (lambda: build_update_rows(lane0, vals, (0, 2), 2),
              entry("build_update_rows", ptr(lane0), ptr(vals), 1024, lambda: (ctypes.c_int * 2)(0, 2), 2, 2,
                    ptr(jout)), None),
    }
    result, out_rows = {}, []
    for key, (wrapper, through_ctypes, library) in cases.items():
        result[key] = {"host_us": host_us(wrapper), "ctypes_us": host_us(through_ctypes)}
        row = "launch path {}: wrapper {:.2f} us a call, its C entry point through ctypes {:.2f} us".format(
            key, result[key]["host_us"], result[key]["ctypes_us"])
        if library is not None:
            result[key]["library_host_us"] = host_us(library[1])
            row += ", {} {:.2f} us".format(library[0], result[key]["library_host_us"])
        out_rows.append(row)
    return result, out_rows


def run_tools():
    """The gather/scatter tools on the card, each through its ``main``;
    returns the launch counts of that run."""
    from arcnerf_torch.tools import probe_cons_forms, probe_gather, probe_scatter, roofline_hashgrid

    t0 = time.perf_counter()
    reset_launches()
    for tool in (roofline_hashgrid, probe_gather, probe_scatter, probe_cons_forms):
        print("--- python -m {} --device cuda:0".format(tool.__name__))
        tool.main(["--device", "cuda:0"])
    torch.cuda.synchronize()
    launches = read_launches("ABGHIJ")
    print("tools: {:.1f} s, launches: {}".format(time.perf_counter() - t0, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the tools never launched: {}".format(launches))
    torch.cuda.empty_cache()
    return launches


def make_checkpoint(path, argv):
    """Seeded random weights + the spheres' occupancy -> a port checkpoint."""
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.models import build_model
    from arcnerf_torch.utils.cfgs import parse_configs
    from arcnerf_torch.utils.model_io import save_model

    cfgs = parse_configs(argv)
    model = build_model(cfgs, generator=torch.Generator().manual_seed(SEED))
    bound_state = model.init_bound_state()
    vol = model.fg_model.get_obj_bound().get_obj_bound()
    bound_state["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(vol.get_n_grid(), float(vol.xyz_len[0])))
    save_model(path, model.state_dict(), bound_state, meta={}, step=0)


def kernel_counters():
    from arcnerf_torch.models.base_modules.encoding import hash_encode, hash_encode_bwd
    from arcnerf_torch.models.base_modules.sample_compact import sample_count
    from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_bwd
    from arcnerf_torch.ops.gather_scatter import build_update_rows, lane_gather, row_gather, scatter_add_rows
    from arcnerf_torch.render.ray_helper import segment_march, segment_march_bwd

    counters = {"A": fused_mlp, "B": hash_encode, "C": segment_march, "D": fused_mlp_bwd, "E": hash_encode_bwd,
                "F": segment_march_bwd, "G": row_gather, "H": lane_gather, "I": scatter_add_rows,
                "J": build_update_rows, "S": sample_count}
    from arcnerf_torch.models.base_modules import encoding

    if hasattr(encoding, "hash_encode_dx"):  # kernels K and L (a tree from before them has none)
        counters.update(K=encoding.hash_encode_dx, L=encoding.hash_dx_bwd)
    try:  # kernels M and N (a tree from before them has none)
        from arcnerf_torch.ops import geo_chain
    except ImportError:
        return counters
    counters.update(M=geo_chain.geo_chain_fwd, N=geo_chain.geo_chain_bwd)
    return counters


def reset_launches():
    for fn in kernel_counters().values():
        fn.launches = 0


def read_launches(keys):
    counters = kernel_counters()
    return {k: counters[k].launches for k in keys}


def serve(dev):
    """The serving path on an 800x800 view; returns its launch counts."""
    from arcnerf_torch import evaluate
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.render.engine import RenderEngine
    from arcnerf_torch.utils.cfgs import parse_configs

    ckpt = os.path.join(WORK_DIR, "ngp_random.pt")
    argv = ["--configs", os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--model_pt", ckpt,
            "--device", "cuda:0", "--dir.eval_dir", os.path.join(OUT_DIR, "eval"), "--progress.max_samples_eval", "1",
            "--dataset.eval.type", "Synthetic", "--dataset.eval.n_imgs", "1", "--dataset.eval.wh", "[800,800]",
            "--dataset.eval.cam_radius", "2.5", "--dataset.eval.white_bkg", "True",
            "--dataset.eval.center_pixel", "True", "--model.obj_bound.eval_max_pts_per_ray", "16"]
    make_checkpoint(ckpt, argv)  # 64 MB, outside chiprun_out: removed at the end

    summary, results = evaluate.main(argv)
    torch.cuda.synchronize()
    print("eval summary:", summary)
    rgb = results[0]["rgb"]
    if rgb.shape != (800, 800, 3) or not np.isfinite(rgb).all():
        raise AssertionError("render: expected a finite (800, 800, 3) image, got {}".format(rgb.shape))

    # the same model on the CPU (plain versions) over a crop of the view
    cfgs = parse_configs(argv)
    model, bound_state = evaluate.load_for_eval(cfgs, dev)
    sample = get_dataset(cfgs.dataset, "data", "eval")[0]
    bkg = evaluate.eval_bkg_color(cfgs)
    crop = slice(400 * 800, 400 * 800 + 4096)  # the middle rows cross the spheres
    feed = {k: torch.as_tensor(sample[k][crop])[None] for k in ("rays_o", "rays_d")}
    feed["bkg_color"] = torch.tensor(bkg, dtype=torch.float32).expand(1, 4096, 3)
    model_cpu, bound_cpu = evaluate.load_for_eval(cfgs, torch.device("cpu"))
    with torch.inference_mode():
        cpu = model_cpu(feed, inference_only=True, bound_state=bound_cpu)
    gpu_rgb = torch.as_tensor(rgb.reshape(-1, 3)[crop])
    gpu_depth = torch.as_tensor(results[0]["depth"].reshape(-1)[crop])
    d_rgb = (gpu_rgb - cpu["rgb"][0]).abs()
    d_depth = float((gpu_depth - cpu["depth"][0]).abs().max())
    print("crop vs CPU plain path: rgb max {:.3e} mean {:.3e}, depth max {:.3e}".format(
        float(d_rgb.max()), float(d_rgb.mean()), d_depth))
    if float(d_rgb.max()) > RGB_MAX or float(d_rgb.mean()) > RGB_MEAN or d_depth > DEPTH_MAX:
        raise AssertionError("the card's render disagrees with the plain path on the crop")

    engine = RenderEngine(model, cfgs, bound_state, dev)
    reset_launches()
    serving = capture_chunk(engine, sample, bkg)  # an eager frame: the wrapped march sees every chunk
    eager_launches = read_launches("ABCS")
    engine.render_image(sample, bkg_color=bkg)  # the timed renders' warm-up: the frame graph's capture
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.render_image(sample, bkg_color=bkg)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated() / 2**20
    per_ray = int(engine.last_n_valid_pts) / (800 * 800)
    print("render 800x800: median {:.2f} ms (runs {}), peak {:.0f} MiB, valid samples/ray {:.3f}, chunk {}".format(
        statistics.median(times) * 1e3, ", ".join("{:.2f}".format(t * 1e3) for t in times), peak, per_ray,
        engine._chunk_for_mesh()))
    launches = replayed_launches(lambda: engine.render_image(sample, bkg_color=bkg), eager_launches, "serving path")
    os.remove(ckpt)
    return launches, serving


# kernels S, B, A and C of the exact tier's chunk, by the name a profile gives them
FRAME_KERNELS = {"S": "sample_count_kernel", "B": "hash_encode_fwd_kernel", "A": "fused_mlp_fwd_kernel",
                 "C": "segment_march_fwd_kernel"}


def replayed_launches(render, eager, label):
    """torch.profiler over one exact frame replayed from its frame graph
    (``render``, the graph captured already): S, B, A and C's launches by
    kernel name. Gates: the frame replayed its chunks (``render.replays``),
    captured nothing and rendered nothing eagerly, and each kernel launched
    as often as in an eager frame of the same view (``eager``: its launch
    counters) and at least once a chunk."""
    from torch.profiler import ProfilerActivity, profile

    from arcnerf_torch.utils import profiler

    profiler.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render()
            torch.cuda.synchronize()
    finally:
        profiler.disable()
    counters = profiler.collect()["counters"]
    chunks = int(counters.get("render.replays", 0))
    calls = device_split(prof, 1, "profile of one replayed {} frame".format(label), unit="frame")
    if calls is None:
        raise AssertionError("{}: no device events recorded in the replayed frame".format(label))
    launches = {k: sum(n for name, n in calls.items() if part in name) for k, part in FRAME_KERNELS.items()}
    print("{}: one replayed frame of {} chunks, launches by kernel name {}; an eager frame's counters {}".format(
        label, chunks, launches, eager))
    if chunks <= 0 or counters.get("render.captures") or counters.get("render.eager"):
        raise AssertionError("{}: the frame did not replay its graph: {}".format(label, counters))
    for k, n in launches.items():
        if n != eager[k] or n < chunks:
            raise AssertionError("{}: kernel {} launched {} times in a replayed frame of {} chunks, an eager frame "
                                 "{} times".format(label, k, n, chunks, eager[k]))
    return launches


SERVE_CHUNK = 19  # the chunk of 16384 rays holding row 400 (rays 311296-327679), which crosses the spheres


def capture_chunk(engine, sample, bkg, chunk=SERVE_CHUNK):
    """One eager render (``engine.eager()``) of ``sample`` with
    ``ray_helper.segment_march_fwd`` wrapped: the compacted stream kernel C received for ray chunk ``chunk``
    of the frame (sigma, rgb, z, off, cnt, the flags, the background and
    any keyword arguments, such as the group width)."""
    import inspect

    from arcnerf_torch.render import ray_helper

    inner, seen = ray_helper.segment_march_fwd, []
    names = ("sigma", "radiance", "z", "off", "cnt", "add_inf_z", "bkg", "white_bkg")

    def wrapper(*args, **kwargs):
        if len(seen) == chunk:
            bound = inspect.signature(inner).bind(*args, **kwargs)
            bound.apply_defaults()
            call = dict(bound.arguments)
            got = {"rgb" if k == "radiance" else k: call.pop(k) for k in names}
            seen.append(dict({k: v.clone() if torch.is_tensor(v) else v for k, v in got.items()}, kwargs=call))
        else:
            seen.append(None)
        return inner(*args, **kwargs)

    ray_helper.segment_march_fwd = wrapper
    try:
        with engine.eager():
            engine.render_image(sample, bkg_color=bkg)
    finally:
        ray_helper.segment_march_fwd = inner
    if len(seen) <= chunk:
        raise AssertionError("the frame rendered in {} chunks, not more than {}".format(len(seen), chunk))
    return seen[chunk]


def train_argv(expr):
    """The recipe's training command line, TRAIN_STEPS steps into ``expr``."""
    return ["--configs", os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--device", "cuda:0",
            "--dir.expr_dir", expr, "--progress.epoch", str(TRAIN_STEPS), "--progress.epoch_loss", "50",
            "--progress.epoch_val", "-1", "--progress.epoch_save_checkpoint", "-1"]


def train(profile=False):
    """The training path: the full-width recipe for TRAIN_STEPS steps
    through ``arcnerf_torch.train``; returns its launch counts, the stream
    kernel E received in one more step and the held-out PSNR."""
    from arcnerf_torch import train as train_entry

    expr = os.path.join(WORK_DIR, "train")
    argv = train_argv(expr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("ABCDEFS")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("training path launches:", launches, "per step:", {k: v / TRAIN_STEPS for k, v in launches.items()})
    if min(launches.values()) <= 0:
        raise AssertionError("a kernel of the training path never launched: {}".format(launches))
    if launches["E"] != TRAIN_STEPS:
        raise AssertionError("kernel E launched {} times in {} steps, not once a step".format(launches["E"],
                                                                                               TRAIN_STEPS))

    losses = torch.stack(trainer.loss_history).float().cpu()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print("loss: first 20 steps {:.5f}, last 20 steps {:.5f}, all finite {}".format(
        first, last, bool(torch.isfinite(losses).all())))
    if not torch.isfinite(losses).all() or not last < first:
        raise AssertionError("training: the loss is not finite or did not fall")
    occ = float(trainer.bound_state["fg"]["bitfield"].float().mean())
    print("occupancy: {:.4f} of the voxels after {} steps".format(occ, TRAIN_STEPS))
    if occ >= 1.0:
        raise AssertionError("training: the occupancy bitfield never changed")

    print("train {} steps: wall {:.1f} s, bucket {} rays, valid samples/ray {:.3f}, peak {:.2f} GiB".format(
        TRAIN_STEPS, wall, trainer.pipeline.n_rays, trainer.pipeline.last_valid_per_ray, peak))
    check_step_against_cpu(trainer)
    val = trainer.valid_epoch(TRAIN_STEPS)
    print("held-out view after {} steps: PSNR {:.3f} dB, SSIM {:.4f} (floor {} dB)".format(
        TRAIN_STEPS, val["psnr"], val["ssim"], PSNR_FLOOR))
    if not val["psnr"] >= PSNR_FLOOR:
        raise AssertionError("training: held-out PSNR {} below {}".format(val["psnr"], PSNR_FLOOR))
    tiers(trainer)
    run_inference(os.path.join(trainer.ckpt_dir, "final.pt"))
    steady_steps(trainer)
    stream = capture_training_streams(trainer)
    if profile:
        profile_steps(trainer)
    shutil.rmtree(expr)
    return launches, stream, val["psnr"]


# the tiers phase: bench.py's serving keys on an 800x800 held-out view of
# the trained model. (key, cap, ladder, tier, keyword arguments)
TIER_RUNS = 3
TIERS = (("render", 16, None, "exact", {}),
         ("render_compact", 16, None, "fast", {"hit_frac": 0.42}),
         ("render_fast", 4, None, "fast", {"hit_frac": 0.42}),
         ("render_interactive", 4, 64, "interactive", {"hit_frac": 0.42, "scale": 3}),
         ("render_windowed_s1", 8, None, "windowed", {"n_pass": 512 // 8, "eps": 1e-3, "scale": 1}),
         ("render_windowed_s2", 8, None, "windowed", {"n_pass": 512 // 8, "eps": 1e-3, "scale": 2}))
# fast with nothing clipped against exact (tests/test_render_cap.py's bound);
# windows at eps 0 against the uncapped render of the crop; windowed s1 at
# eps 1e-3 against the uncapped frame; both uncapped renders in chunks of
# 512 rays x 512 samples, the 2^18 point budget, so that no chunk clips
FAST_EXACT_TOL, WINDOW_EXACT_TOL, WINDOW_PSNR_FLOOR, UNCAPPED_CHUNK = 5e-2, 1e-3, 40.0, 512


def psnr_db(a, b):
    return float(-10.0 * torch.log10(((a.float() - b.float()) ** 2).mean().clamp_min(1e-12)))


def check_frame(key, imgs):
    for k, v in imgs.items():
        if tuple(v.shape[:2]) != (800, 800) or not bool(torch.isfinite(v).all()):
            raise AssertionError("{}: {} is not a finite (800, 800, ...) image: {}".format(key, k, tuple(v.shape)))


def tiers(trainer):
    """The serving tiers on an 800x800 held-out Synthetic view of the
    trained model through the trainer's delegates (eval background): for
    each tier of TIERS a warm-up and TIER_RUNS timed frames (median, host
    clock around torch.cuda.synchronize()), PSNR against the exact cap-16
    frame, stats, peak memory and the launches of A-C and S a frame (the
    exact tier's from one replayed frame, ``replayed_launches``); then the
    gates, and one torch.profiler pass over a windowed s1 frame. Returns
    the numbers it printed."""
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.utils.cfgs import dict_to_obj

    sample = get_dataset(dict_to_obj({"val": {"type": "Synthetic", "n_imgs": 1, "wh": [800, 800], "cam_radius": 2.5,
                                              "white_bkg": True, "center_pixel": True}}), "data", "val")[0]
    bkg = trainer.eval_bkg_color("val")
    renders = {"exact": lambda **kw: (trainer.render_image(sample, bkg_color=bkg), {}),
               "fast": lambda **kw: trainer.render_image_fast(sample, bkg_color=bkg, **kw),
               "interactive": lambda **kw: trainer.render_image_interactive(sample, bkg_color=bkg, **kw),
               "windowed": lambda **kw: trainer.render_image_windowed(sample, bkg_color=bkg, **kw)}
    numbers, exact = {}, None
    for key, cap, n_sample, tier, kwargs in TIERS:
        trainer.set_render_cap(cap, n_sample=n_sample, window=tier == "windowed")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        imgs, stats = renders[tier](**kwargs)  # warm-up
        times = []
        for _ in range(TIER_RUNS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            imgs, stats = renders[tier](**kwargs)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        peak = torch.cuda.max_memory_allocated() / 2**20
        if tier == "exact":  # a replay calls no Python: its kernels by name against an eager frame's counters
            reset_launches()
            with trainer.engine.eager():
                renders[tier](**kwargs)
            launches = replayed_launches(lambda: renders[tier](**kwargs), read_launches("ABCS"), key)
        else:
            launches = {k: v / (TIER_RUNS + 1) for k, v in read_launches("ABCS").items()}
        check_frame(key, imgs)
        if exact is None:
            exact = imgs["rgb"]
        if min(launches[k] for k in "ABCS") <= 0:  # the windowed tier's windows on S and C too
            raise AssertionError("{}: a kernel of the tier never launched: {}".format(key, launches))
        if tier == "windowed" and stats["clipped_alive"] != 0:
            raise AssertionError("{}: {} alive rays clipped".format(key, stats["clipped_alive"]))
        numbers[key] = {"ms": statistics.median(times) * 1e3, "runs_ms": [t * 1e3 for t in times],
                        "psnr_vs_exact": psnr_db(imgs["rgb"], exact), "peak_mib": peak, "launches": launches,
                        "stats": stats}
        print("tier {}: median {:.2f} ms (runs {}), PSNR vs exact cap-16 {:.3f} dB, peak {:.0f} MiB, launches a "
              "frame {}, stats {}".format(key, numbers[key]["ms"], ", ".join("{:.2f}".format(t * 1e3) for t in times),
                                          numbers[key]["psnr_vs_exact"], peak, launches, stats))

    # fast with room for every hit ray renders the exact frame
    trainer.set_render_cap(16)
    fast, stats = trainer.render_image_fast(sample, bkg_color=bkg, hit_frac=1.0)
    err = float((fast["rgb"] - exact).abs().max())
    print("gate: fast (cap 16, hit_frac 1.0, {} clipped) vs exact: rgb max abs {:.3e} (tol {})".format(
        stats["clipped_rays"], err, FAST_EXACT_TOL))
    if stats["clipped_rays"] or err > FAST_EXACT_TOL:
        raise AssertionError("fast with nothing clipped disagrees with the exact frame: {}".format(err))
    # windows at eps 0 compose the uncapped render: the 4096-ray crop of serve()
    crop = slice(400 * 800, 400 * 800 + 4096)
    sub = {"rays_o": sample["rays_o"][crop], "rays_d": sample["rays_d"][crop], "H": 1, "W": 4096}
    trainer.set_render_cap(None)
    uncapped_crop = trainer.render_image(sub, bkg_color=bkg)  # the trainer's clip-free chunk: 512 rays
    trainer.set_render_cap(8, window=True)
    win, stats = trainer.render_image_windowed(sub, bkg_color=bkg, n_pass=512 // 8, eps=0.0)
    err = float((win["rgb"] - uncapped_crop["rgb"]).abs().max())
    print("gate: windowed (eps 0, {} passes, {} alive at the end) vs uncapped on the crop: rgb max abs {:.3e} "
          "(tol {})".format(1 + len(stats["pass_budget_rays"]), stats["alive_at_end"], err, WINDOW_EXACT_TOL))
    if stats["clipped_alive"] or stats["alive_at_end"] or err > WINDOW_EXACT_TOL:
        raise AssertionError("windows at eps 0 disagree with the uncapped render: {} {}".format(err, stats))
    # windowed s1 against the uncapped frame
    trainer.set_render_cap(None)
    if trainer._val_chunk_rays() != UNCAPPED_CHUNK:
        raise AssertionError("the uncapped render's chunk is {} rays".format(trainer._val_chunk_rays()))
    t0 = time.perf_counter()
    uncapped = trainer.render_image(sample, bkg_color=bkg)
    torch.cuda.synchronize()
    uncapped_s = time.perf_counter() - t0
    check_frame("uncapped", uncapped)
    trainer.set_render_cap(8, window=True)
    kwargs = TIERS[4][4]
    win, stats = trainer.render_image_windowed(sample, bkg_color=bkg, **kwargs)
    p_win, p_exact = psnr_db(win["rgb"], uncapped["rgb"]), psnr_db(exact, uncapped["rgb"])
    print("gate: windowed s1 vs the uncapped frame ({:.1f} ms in {}-ray chunks): {:.3f} dB (floor {}); exact "
          "cap-16 vs uncapped {:.3f} dB".format(uncapped_s * 1e3, UNCAPPED_CHUNK, p_win, WINDOW_PSNR_FLOOR, p_exact))
    if p_win < WINDOW_PSNR_FLOOR:
        raise AssertionError("windowed s1: {} dB against the uncapped frame".format(p_win))
    numbers["render_windowed_s1"]["psnr_vs_uncapped"] = p_win
    numbers["render"]["psnr_vs_uncapped"] = p_exact

    # where a windowed frame's time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.render_image_windowed(sample, bkg_color=bkg, **kwargs)
        torch.cuda.synchronize()
    device_split(prof, 1, "profile of one windowed s1 frame", unit="frame")
    trainer.set_render_cap(None)
    torch.cuda.empty_cache()
    return numbers


INFER_CAMS, INFER_WH = 4, 200


def run_inference(ckpt):
    """``python -m arcnerf_torch.inference`` on the card from the trained
    checkpoint: a circle of INFER_CAMS cameras at INFER_WH x INFER_WH; checks
    that every frame is finite and written."""
    out = os.path.join(OUT_DIR, "inference")
    shutil.rmtree(out, ignore_errors=True)
    argv = [sys.executable, "-m", "arcnerf_torch.inference", "--configs",
            os.path.join(ROOT, "configs/expr/synthetic_ngp.yaml"), "--model_pt", ckpt, "--device", "cuda:0",
            "--dir.eval_dir", out, "--dataset.val.wh", "[{0},{0}]".format(INFER_WH), "--inference.render.type",
            "circle", "--inference.render.n_cam", str(INFER_CAMS), "--inference.render.radius", "2.5",
            "--inference.render.bkg_color", "[1.0,1.0,1.0]"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise AssertionError("python -m arcnerf_torch.inference failed:\n" + proc.stderr[-4000:])
    with open(os.path.join(out, "infer.log")) as f:
        log = f.read()
    video = os.path.join(out, "render_circle")
    frames = sorted(os.listdir(video)) if os.path.isdir(video) else []
    if not os.path.exists(video + ".mp4") and len(frames) != INFER_CAMS:
        raise AssertionError("inference wrote neither render_circle.mp4 nor {} frames: {}".format(INFER_CAMS, frames))
    finite = "circle: {0} frames of {1}x{1}, all finite True".format(INFER_CAMS, INFER_WH)
    if finite not in log:
        raise AssertionError("inference frames: expected '{}' in the log:\n{}".format(finite, log))
    print("inference: {:.1f} s, {}; {}".format(time.perf_counter() - t0, finite,
                                              log.strip().splitlines()[-1].split("| ")[-1]))


def steady_steps(trainer, n=STEADY_STEPS):
    """n more steps of the trained run, each bracketed by CUDA events (no
    host sync between steps): median and mean ms per step, rays/s at the
    bucket. The occupancy update keeps its cadence, so the mean carries it
    and the median does not."""
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(n + 1)]
    epoch0 = trainer.step
    marks[0].record()
    for i in range(n):
        trainer.train_step(epoch0 + i)
        marks[i + 1].record()
    torch.cuda.synchronize()
    step_ms = [marks[i].elapsed_time(marks[i + 1]) for i in range(n)]
    med = statistics.median(step_ms)
    n_rays = trainer.pipeline.n_rays
    print("steady steps {}-{}: median {:.3f} ms/step (mean {:.3f}), bucket {} rays, {:.0f} rays/s".format(
        epoch0, epoch0 + n - 1, med, statistics.mean(step_ms), n_rays, n_rays / med * 1e3))
    return med


def check_step_against_cpu(trainer):
    """Loss and gradients of one batch on the card (kernels A-F) against a
    CPU copy of the trained model (plain versions): relative loss error
    <= STEP_LOSS_TOL, relative norm error of each parameter's gradient <=
    STEP_GRAD_TOL. No jitter or noise (no generator), no optimizer step."""
    import copy

    feed = trainer.pipeline.sample(trainer.generator)
    feed = {k: v[:, :STEP_RAYS] for k, v in feed.items()}
    results = []
    for model, dev in ((trainer.model, trainer.device), (copy.deepcopy(trainer.model).cpu(), torch.device("cpu"))):
        bound = {name: {k: v.to(dev) for k, v in sub.items()} for name, sub in trainer.bound_state.items()}
        batch = {k: v.to(dev) for k, v in feed.items()}
        model.zero_grad(set_to_none=True)
        out = model(batch, inference_only=False, bound_state=bound)
        loss = trainer.loss_factory(batch, out)["sum"]
        loss.backward()
        results.append((float(loss.detach()), {n: p.grad.detach().cpu() for n, p in model.named_parameters()},
                        int(out["n_valid_pts"])))
    trainer.model.zero_grad(set_to_none=True)
    (loss_k, grads_k, n_valid), (loss_p, grads_p, _) = results
    rel = {n: float((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)) for n, g in grads_p.items()}
    loss_rel = abs(loss_k - loss_p) / abs(loss_p)
    print("one step, {} rays, {} valid samples, card vs CPU plain: loss {:.6f} vs {:.6f} (rel {:.2e}, tol {}), "
          "grad rel norm err max {:.2e} (tol {})".format(STEP_RAYS, n_valid, loss_k, loss_p, loss_rel, STEP_LOSS_TOL,
                                                          max(rel.values()), STEP_GRAD_TOL))
    if loss_rel > STEP_LOSS_TOL or max(rel.values()) > STEP_GRAD_TOL:
        raise AssertionError("training step: the card disagrees with the plain path: {}".format(rel))


# kernels A-F as the profiler names them (D with its dW sum)
PROFILE_KERNELS = {"A": ("fused_mlp_fwd_kernel",), "B": ("hash_encode_fwd_kernel",),
                   "C": ("segment_march_fwd_kernel",), "D": ("fused_mlp_bwd_kernel", "reduce_parts_kernel"),
                   "E": ("hash_encode_bwd_kernel",), "F": ("segment_march_bwd_kernel",)}


def profile_steps(trainer, n=4):
    """torch.profiler over n more steps: device time by kernel name and for
    each of kernels A-F, busy and idle."""
    from torch.profiler import ProfilerActivity, profile

    epoch0 = trainer.step + 1  # off the occupancy cadence
    trainer.train_step(epoch0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for e in range(epoch0 + 1, epoch0 + 1 + n):
            trainer.train_step(e)
        torch.cuda.synchronize()
    device_split(prof, n, "profile of {} steps".format(n))


def device_split(prof, n, label, unit="step"):
    """Print a profile's device busy time and idle share, its kernels by
    name and each of A-F per ``unit``, over n of them; returns the calls by
    kernel name, or None when the profile holds no device event."""
    spans = sorted((ev.time_range.start, ev.time_range.end, ev.name) for ev in prof.events()
                   if ev.device_type == torch.autograd.DeviceType.CUDA and not getattr(ev, "is_user_annotation", False))
    if not spans:
        print(label + ": no device events recorded")
        return None
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    by_name, calls = {}, {}
    for s, e, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e - s)
        calls[name] = calls.get(name, 0) + 1
        if s > cur_e:
            busy, cur_s, cur_e = busy + (cur_e - cur_s), s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    total = sum(by_name.values())
    print("{}: device busy {:.2f} ms of a {:.2f} ms span ({:.1f} % idle), {} kernels".format(
        label, busy / 1e3, span / 1e3, 100.0 * (1 - busy / span), len(spans)))
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:25]:
        print("  {:8.3f} ms/{} {:5.1f} %  {}".format(us / 1e3 / n, unit, 100.0 * us / total, name[:110]))
    split = []
    for key, parts in PROFILE_KERNELS.items():
        names = [name for name in by_name if any(p in name for p in parts)]
        split.append("{} {:.3f} ms ({:.2f} launches)".format(key, sum(by_name[m] for m in names) / 1e3 / n,
                                                             sum(calls[m] for m in names) / n))
    adam = [name for name in by_name if "adam" in name.lower()]
    split.append("Adam {:.3f} ms ({:.2f} launches)".format(sum(by_name[m] for m in adam) / 1e3 / n,
                                                          sum(calls[m] for m in adam) / n))
    print(label + " per {} by kernel: ".format(unit) + ", ".join(split))
    return calls


def train_graph(eager_psnr):
    """The graph phase: (a) the recipe's TRAIN_STEPS steps again through
    ``arcnerf_torch.train`` with ``--progress.scan_steps GRAPH_STRIDE``,
    the same seed and otherwise the same command line, each stride
    replays of the step captured for its batch bucket; (b) graph replays
    against eager steps from one state; (c) eager and graph ms/step at the
    same bucket; (d) torch.profiler over one stride of replays. Returns
    the numbers it printed."""
    from arcnerf_torch import train as train_entry

    expr = os.path.join(WORK_DIR, "train_graph")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_entry.main(train_argv(expr) + ["--progress.scan_steps", str(GRAPH_STRIDE)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    # the counters count Python calls: each bucket's eager warm-up step and
    # its capture, never a replay (the profile below reads the replays)
    launches = read_launches("ABCDEF")
    peak = torch.cuda.max_memory_allocated() / 2**30
    print("graph training run (strides of {}): launch counters (warm-up steps and captures) {}".format(
        GRAPH_STRIDE, launches))
    if min(launches.values()) <= 0:
        raise AssertionError("graph run: a kernel of the training step was never captured: {}".format(launches))
    losses = torch.stack(trainer.loss_history).float().cpu()
    first, last = float(losses[:20].mean()), float(losses[-20:].mean())
    print("graph run loss: first 20 steps {:.5f}, last 20 steps {:.5f}, {} steps, all finite {}".format(
        first, last, losses.numel(), bool(torch.isfinite(losses).all())))
    if losses.numel() != TRAIN_STEPS or not torch.isfinite(losses).all() or not last < first:
        raise AssertionError("graph run: the loss is not finite, not one a step, or did not fall")
    occ = float(trainer.bound_state["fg"]["bitfield"].float().mean())
    if occ >= 1.0:
        raise AssertionError("graph run: the occupancy bitfield never changed")
    for (n_rays, _), graph in sorted(trainer.step_graphs.items(), key=lambda kv: kv[0][0]):
        print("graph run: bucket {} rays captured in {:.3f} s".format(n_rays, graph.capture_seconds))
    print("graph run {} steps: wall {:.1f} s, bucket {} rays, valid samples/ray {:.3f}, occupancy {:.4f}, "
          "peak {:.2f} GiB".format(TRAIN_STEPS, wall, trainer.pipeline.n_rays, trainer.pipeline.last_valid_per_ray,
                                   occ, peak))
    val = trainer.valid_epoch(TRAIN_STEPS)
    print("graph run held-out view: PSNR {:.3f} dB (eager run {:.3f} dB, floor {} dB, gap at most {} dB)".format(
        val["psnr"], eager_psnr, PSNR_FLOOR, GRAPH_PSNR_GAP))
    if not val["psnr"] >= PSNR_FLOOR or abs(val["psnr"] - eager_psnr) > GRAPH_PSNR_GAP:
        raise AssertionError("graph run: held-out PSNR {} against {} (eager)".format(val["psnr"], eager_psnr))

    eager = graph_against_eager(trainer, expr)
    numbers = graph_speed(trainer, eager)
    numbers.update(psnr=val["psnr"], eager_psnr=eager_psnr, peak_gib=peak,
                   capture_s={k[0]: g.capture_seconds for k, g in trainer.step_graphs.items()})
    shutil.rmtree(expr)
    return numbers


def graph_against_eager(graph_trainer, expr):
    """(b) Two eager copies of the graph run's trainer (its checkpoint
    loaded, its generator state copied) and the trainer itself from the
    same state: GRAPH_STRIDE eager steps on each copy, one stride of
    replays on the trainer. Every step's picks and valid-sample count
    equal exactly; every step's loss within GRAPH_LOSS_TOL. Returns the
    first eager copy."""
    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.utils.cfgs import parse_configs

    epoch0 = graph_trainer.step
    graph_trainer.save(["graph_vs_eager"], epoch0)
    ckpt = os.path.join(graph_trainer.ckpt_dir, "graph_vs_eager.pt")
    runs = []
    for name in ("eager_a", "eager_b"):
        eager = ArcNerfTrainer(parse_configs(train_argv(os.path.join(expr, name)) + ["--resume", ckpt]))
        eager.pipeline.n_rays = graph_trainer.pipeline.n_rays
        eager.generator.set_state(graph_trainer.generator.get_state())
        picks, counts = [], []
        for e in range(epoch0, epoch0 + GRAPH_STRIDE):
            counts.append(int(eager.train_steps(e, 1)["n_valid_pts"]))
            picks.append(eager.pipeline.last_picks.clone())
        runs.append((eager, picks, counts, torch.stack(eager.loss_history).float().cpu()))
    graph_trainer.loss_history = []
    graph_trainer.train_steps(epoch0, GRAPH_STRIDE)
    step = graph_trainer.step_graphs[(min(graph_trainer.pipeline.n_rays, graph_trainer.pipeline.n_total_rays), None)]
    g_picks, g_counts = step.picks[:GRAPH_STRIDE], [int(c) for c in step.ring["n_valid_pts"][:GRAPH_STRIDE]]
    g_losses = torch.stack(graph_trainer.loss_history).float().cpu()
    eager, picks, counts, losses = runs[0]
    rel = ((g_losses - losses).abs() / losses.abs()).max()
    spread = ((runs[1][3] - losses).abs() / losses.abs()).max()
    same_picks = all(torch.equal(a, b) for a, b in zip(picks, g_picks))
    print("graph vs eager from step {} at {} rays, {} steps: picks equal {}, valid samples equal {} (first step "
          "{} vs {}), loss rel diff max {:.3e} (tol {}), eager vs eager {:.3e}".format(
              epoch0, graph_trainer.pipeline.n_rays, GRAPH_STRIDE, same_picks, g_counts == counts, g_counts[0],
              counts[0], float(rel), GRAPH_LOSS_TOL, float(spread)))
    if not same_picks or g_counts != counts or runs[1][2] != counts:
        raise AssertionError("graph vs eager: the draws differ")
    if float(rel) > GRAPH_LOSS_TOL:
        raise AssertionError("graph vs eager: a step's loss differs by {} relative".format(float(rel)))
    os.remove(ckpt)
    return eager


def graph_speed(graph_trainer, eager):
    """(c) median ms/step of eager steps and of graph replays at the same
    bucket (strides off the occupancy cadence, CUDA events around each);
    (d) torch.profiler over one stride of replays, cold and after a
    warm-up stride: in the latter kernels A-F must each launch as often a
    replay as the counters show for an eager step."""
    from torch.profiler import ProfilerActivity, profile, schedule

    n_rays = graph_trainer.pipeline.n_rays
    eager_ms = steady_steps(eager)
    epoch = graph_trainer.step + 1  # strides start off the occupancy cadence
    marks = [torch.cuda.Event(enable_timing=True) for _ in range(GRAPH_TIMED_STRIDES + 1)]
    marks[0].record()
    for i in range(GRAPH_TIMED_STRIDES):
        graph_trainer.train_steps(epoch + i * GRAPH_STRIDE, GRAPH_STRIDE)
        marks[i + 1].record()
    torch.cuda.synchronize()
    per_step = [marks[i].elapsed_time(marks[i + 1]) / GRAPH_STRIDE for i in range(GRAPH_TIMED_STRIDES)]
    graph_ms = statistics.median(per_step)
    print("graph replays, {} strides of {} at {} rays: median {:.3f} ms/step (strides {}), {:.0f} rays/s; eager "
          "median {:.3f} ms/step, {:.0f} rays/s".format(
              GRAPH_TIMED_STRIDES, GRAPH_STRIDE, n_rays, graph_ms, ", ".join("{:.3f}".format(t) for t in per_step),
              n_rays / graph_ms * 1e3, eager_ms, n_rays / eager_ms * 1e3))

    reset_launches()
    eager.train_step(eager.step + 1 if (eager.step + 1) % GRAPH_STRIDE else eager.step + 2)
    torch.cuda.synchronize()
    expected = read_launches("ABCDEF")
    # the profiler misses the kernels of replays launched while it starts
    # up (seen: the first one or two of a stride): a stride profiled cold
    # is printed, and the launches are checked on a stride after a warm-up
    # stride under the profiler's schedule
    for warm in (0, 1):
        epoch = graph_trainer.step + 1
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=warm, active=1, repeat=1)) as prof:
            for i in range(warm + 1):
                graph_trainer.train_steps(epoch + i * GRAPH_STRIDE, GRAPH_STRIDE)
                torch.cuda.synchronize()
                prof.step()
        calls = device_split(prof, GRAPH_STRIDE, "graph profile of one stride ({} replays{})".format(
            GRAPH_STRIDE, ", after a warm-up stride" if warm else ", cold"))
        if calls is None:
            raise AssertionError("graph profile: no device events recorded")
        seen = {key: sum(n for name, n in calls.items() if parts[0] in name) for key, parts in PROFILE_KERNELS.items()}
        print("graph profile{}: launches seen {}, an eager step's times {}: {}".format(
            " after a warm-up stride" if warm else " cold", seen, GRAPH_STRIDE,
            {key: expected[key] * GRAPH_STRIDE for key in seen}))
    for key in PROFILE_KERNELS:
        if seen[key] != expected[key] * GRAPH_STRIDE:
            raise AssertionError("graph profile: kernel {} launched {} times in {} replays, an eager step launches "
                                 "it {} times".format(key, seen[key], GRAPH_STRIDE, expected[key]))
    print("graph profile: kernels A-F launched as an eager step launches them ({} a step)".format(expected))
    # Adam reads the parameter, its gradient and both moments and writes
    # back all but the gradient: 28 bytes a parameter; 11 operations each
    n_params = sum(p.numel() for p in graph_trainer.model.parameters())
    adam_bound, adam_by = bound(28 * n_params, 11 * n_params, F32_FLOP_S)
    print("Adam over {} parameters: bound {:.4f} ms by {}".format(n_params, adam_bound, adam_by))
    return {"eager_ms": eager_ms, "graph_ms": graph_ms, "n_rays": n_rays, "adam_bound_ms": adam_bound}


# ------------------------------------------------ NeuS-NGP: K, L, C/F alpha

NEUS_STEPS = 48  # eager steps of the NeuS recipe (occupancy updates at 16, 32 during the warm-up)


def hash_dx_points(dev, gen, n=B_POINTS):
    """A ray-ordered stream of ``n`` points inside the volume, as the
    training step hands the hash grid (consecutive sections of a ray
    2 sqrt(3) / 1024 apart)."""
    from arcnerf_torch.tools.hash_streams import ray_stream

    return torch.as_tensor(ray_stream(n, 11, step=2 * 3 ** 0.5 / 1024), device=dev)


def compare_hash_dx(dev, gen):
    """Kernel K (the encoding's input gradient) and kernel L (its backward)
    at the main path's shapes (2^18 points, L=16, T=2^19, F=2, quad, bf16
    reads) against their plain versions."""
    from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, hash_dx_bwd, hash_dx_bwd_reference,
                                                           hash_encode_dx, hash_encode_dx_reference)

    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    table = (torch.rand((16, 1 << 19, 2), generator=gen, device=dev) * 2 - 1).contiguous()
    xyz = hash_dx_points(dev, gen)
    g = torch.randn((B_POINTS, 32), generator=gen, device=dev)
    g_dx = torch.randn((B_POINTS, 3), generator=gen, device=dev)
    args = (enc.resolutions, enc.aabb_min, enc.aabb_len, enc.variant, True)
    res_dev = torch.as_tensor(enc.resolutions, dtype=torch.int32, device=dev)
    touched = sum(min(1 << 19, (r + 1) ** 3, 8 * B_POINTS) for r in enc.resolutions)
    rows, stats = [], {}
    dx, ref = hash_encode_dx(xyz, table, g, *args), hash_encode_dx_reference(xyz, table, g, *args)
    err = check_scaled("hash_encode_dx", dx, ref, 1e-4)
    k_bound = bound(B_POINTS * (12 + 32 * 4 + 12) + touched * 2 * 4, B_POINTS * 16 * 8 * (2 * 2 + 6), F32_FLOP_S)
    entry = {"max_abs_err": err, "ms": time_ms(lambda: hash_encode_dx(xyz, table, g, *args)),
             "plain_ms": time_ms(lambda: hash_encode_dx_reference(xyz, table, g, *args), 3),
             "graph_ms": graph_ms(lambda: hash_encode_dx(xyz, table, g, *args, res_dev=res_dev))}
    suffix = add_bound(entry, [k_bound])
    rows.append("K hash_encode_dx (2^18 ray-ordered pts, L=16, T=2^19, F=2, quad): max abs err {:.3e} (tol 1e-4 x "
                "max|ref|), kernel {:.4f} ms (CUDA graph {:.4f} ms), plain {:.4f} ms, {}".format(
                    err, entry["ms"], entry["graph_ms"], entry["plain_ms"], suffix))
    stats["K"] = entry
    (d_t, d_g), (r_t, r_g) = hash_dx_bwd(xyz, table, g, g_dx, *args), hash_dx_bwd_reference(xyz, table, g, g_dx, *args)
    err = max(check_scaled("hash_dx_bwd d_table", d_t, r_t, 1e-5), check_scaled("hash_dx_bwd d_g", d_g, r_g, 1e-5))
    l_bound = bound(B_POINTS * (12 + 2 * 32 * 4 + 12) + touched * 2 * 4 + 16 * (1 << 19) * 2 * 4,
                    B_POINTS * 16 * 8 * (6 + 4 * 2), F32_FLOP_S)
    entry = {"max_abs_err": err, "ms": time_ms(lambda: hash_dx_bwd(xyz, table, g, g_dx, *args)),
             "plain_ms": time_ms(lambda: hash_dx_bwd_reference(xyz, table, g, g_dx, *args), 3),
             "graph_ms": graph_ms(lambda: hash_dx_bwd(xyz, table, g, g_dx, *args, res_dev=res_dev))}
    suffix = add_bound(entry, [l_bound])
    rows.append("L hash_dx_bwd (same shapes; the table gradient zeroed and scattered, d_g gathered): max abs err "
                "{:.3e} (tol 1e-5 x max|ref|), kernel {:.4f} ms (CUDA graph {:.4f} ms), plain {:.4f} ms, {}".format(
                    err, entry["ms"], entry["graph_ms"], entry["plain_ms"], suffix))
    stats["L"] = entry
    return rows, stats


# the NeuS cell's sampler: its rays a step, ladder slots and budget; the
# cases: the benchmark scene's grid (~44 sections a ray), half the voxels
# occupied (the budget cuts the stream, segments of ~500), and rays along
# the diagonals of a full grid (every slot valid: sections clip at 1024)
NEUS_SLOTS, NEUS_BUDGET = 1024, 1 << 18
NEUS_S_CASES = (("scene", 2048, "scene"), ("half", 2048, "half"), ("diagonal", 64, "full"))
NEUS_ALPHA_MAX = 0.05  # alphas under 0.05 keep a ray's transmittance alive across its groups


def compare_sections(dev, gen):
    """Kernel S's sections mode on NEUS_S_CASES against its plain version,
    bit for bit (the lengths included), timed from a CUDA graph; then
    kernels C and F in their alpha mode on each stream it wrote (alpha
    uniform under NEUS_ALPHA_MAX, so the carry crosses every group of a
    long segment) against their plain versions."""
    from arcnerf_torch.models.base_modules import sample_compact as sampler
    from arcnerf_torch.render.ray_helper import (segment_march_bwd, segment_march_bwd_reference,
                                                 segment_march_fwd, segment_march_reference)
    from arcnerf_torch.tools.sample_streams import (diagonal_rays, ladder_bitfield, ladder_rand, ladder_rays,
                                                    ladder_volume)

    vol = ladder_volume()
    rows, stats = [], {"S": {}, "C": {}, "F": {}}
    for label, n_rays, kind in NEUS_S_CASES:
        bitfield = ladder_bitfield(kind, vol, SEED, device=dev)
        o, d = (diagonal_rays if kind == "full" else ladder_rays)(vol, n_rays, SEED, device=dev)
        rand = ladder_rand(n_rays, NEUS_SLOTS, SEED + 1, device=dev)
        args = (vol, bitfield, o, d, NEUS_SLOTS, NEUS_BUDGET, None, rand)

        def run():
            return sampler.sample_compact(*args, sections=True)

        def plain():
            return sampler.sample_compact(*args, count=sampler.sample_count_reference, sections=True)

        got, want = run(), plain()
        for k in S_KEYS + ("len",):
            if not torch.equal(got[k], want[k]):
                raise AssertionError("sampler sections {}: {} is not bit-identical to the plain version".format(
                    label, k))
        cnt = got["cnt"]
        if kind == "full" and int(cnt.max()) != NEUS_SLOTS:
            raise AssertionError("sampler sections diagonal: no ray reached the clip at {}".format(NEUS_SLOTS))
        c = {"max_abs_err": 0.0, "ms": graph_ms(run), "plain_ms": time_ms(plain, 3), "n_valid": int(got["n_valid"]),
             "kept": int(cnt.sum()), "max_cnt": int(cnt.max())}
        suffix = add_bound(c, [bound(41 * n_rays + 4 * n_rays * NEUS_SLOTS + 32 * NEUS_BUDGET, 0, F32_FLOP_S)])
        rows.append("S sections {} ({} rays x {} slots, jitter, budget {}; {} sections, {} kept, a ray at most {}): "
                    "bit-identical, kernel {:.4f} ms (CUDA graph), plain {:.4f} ms, {}".format(
                        label, n_rays, NEUS_SLOTS, NEUS_BUDGET, c["n_valid"], c["kept"], c["max_cnt"], c["ms"],
                        c["plain_ms"], suffix))
        stats["S"][label] = c

        z, off = got["z"], got["off"]
        alpha = torch.rand(z.shape, generator=gen, device=dev) * NEUS_ALPHA_MAX
        rgb = torch.rand((z.shape[0], 3), generator=gen, device=dev)
        bkg = torch.rand((n_rays, 3), generator=gen, device=dev)
        grads = [torch.randn((n_rays, 3), generator=gen, device=dev)] + [
            torch.randn((n_rays,), generator=gen, device=dev) for _ in range(2)]
        fwd = (alpha, rgb, z, off, cnt, False, bkg, False)
        out, ref = segment_march_fwd(*fwd, alpha=True), segment_march_reference(*fwd, alpha=True)
        err_c = max(max_err(out[k], ref[k]) for k in ("rgb", "depth", "mask", "trans_end"))
        if err_c > C_TOL:
            raise AssertionError("segment_march alpha mode {}: max abs err {} over {}".format(label, err_c, C_TOL))
        bwd = (alpha, rgb, z, off, cnt, *grads, False, bkg, False)
        (d_a, d_rgb), (r_a, r_rgb) = segment_march_bwd(*bwd, alpha=True), segment_march_bwd_reference(*bwd, alpha=True)
        err_f = max(check_scaled("segment_march_bwd alpha {} d_alpha".format(label), d_a, r_a, F_TOL),
                    check_scaled("segment_march_bwd alpha {} d_rgb".format(label), d_rgb, r_rgb, F_TOL))
        cc = {"max_abs_err": err_c, "ms": graph_ms(lambda: segment_march_fwd(*fwd, alpha=True)),
              "plain_ms": time_ms(lambda: segment_march_reference(*fwd, alpha=True), 3)}
        ff = {"max_abs_err": err_f, "ms": graph_ms(lambda: segment_march_bwd(*bwd, alpha=True)),
              "plain_ms": time_ms(lambda: segment_march_bwd_reference(*bwd, alpha=True), 3)}
        k_total = z.shape[0]
        rows.append("C alpha mode on the {} sections ({} rays, {} rows): max abs err {:.3e} (tol {}), kernel {:.4f} ms "
                    "(CUDA graph), plain {:.4f} ms, {}".format(label, n_rays, k_total, err_c, C_TOL, cc["ms"],
                                                              cc["plain_ms"], add_bound(cc, [c_bound(cnt, n_rays)])))
        rows.append("F alpha mode on the {} sections: max abs err {:.3e} (tol {} x max|ref|), kernel {:.4f} ms (CUDA "
                    "graph), plain {:.4f} ms, {}".format(label, err_f, F_TOL, ff["ms"], ff["plain_ms"],
                                                         add_bound(ff, [f_bound(cnt, n_rays, k_total)])))
        stats["C"][label], stats["F"][label] = cc, ff
        del got, want, out, ref
    return rows, stats


GEO_ROWS, GEO_OCC_PTS = 1 << 18, 1 << 20  # a NeuS step's kept sections; an occupancy update's points
# f32 FMAs a row: M (z, out, g) and N's essential work (u, d_out W2^T, d_enc,
# dW1's two products, dW2), without its recompute of z
M_FMAS, N_FMAS = 32 * 64 + 64 * 17 + 64 * 32, 32 * 64 + 64 * 17 + 64 * 32 + 2 * 32 * 64 + 64 * 17


def compare_geo_chain(dev, gen):
    """Kernels M and N (with the reduce) at the NeuS step's shapes (2^18
    rows, the recipe's GeoNet 32 -> 64 -> 17, softplus beta 100) and M at an
    occupancy update's 2^20 points, against their plain versions, beside
    their bound (f32 FMAs) and autograd's create-graph chain of the same
    function (the library yardstick: what the step ran before them)."""
    from arcnerf_torch.ops import geo_chain

    rows, stats = [], {}

    def inputs(n):
        enc = torch.randn((n, 32), generator=gen, device=dev) * 0.3
        w1, w2 = torch.randn((32, 64), generator=gen, device=dev) * 0.3, torch.randn((64, 17), generator=gen,
                                                                                       device=dev) * 0.2
        return enc, w1, w2, torch.randn((n, 17), generator=gen, device=dev), torch.randn((n, 32), generator=gen,
                                                                                         device=dev)

    def autograd_fwd(enc, w1, w2):
        x = enc.detach().requires_grad_(True)
        a, b = w1.detach().requires_grad_(True), w2.detach().requires_grad_(True)
        h = torch.nn.functional.softplus(100.0 * (x @ a)) / 100.0 @ b
        (g,) = torch.autograd.grad(h[:, :1], x, torch.ones_like(h[:, :1]), create_graph=True)
        return (x, a, b), h, g

    for n, label in ((GEO_ROWS, "step"), (GEO_OCC_PTS, "occupancy update")):
        enc, w1, w2, d_out, d_g = inputs(n)
        count = torch.tensor(n, device=dev)
        out, g = geo_chain.geo_chain_fwd(enc, w1, w2, 100.0, count)
        r_out, r_g = geo_chain.geo_chain_fwd_reference(enc, w1, w2, 100.0)
        err = max(check_scaled("geo_chain out", out, r_out, 1e-5), check_scaled("geo_chain g", g, r_g, 1e-5))
        entry = {"max_abs_err": err, "ms": time_ms(lambda: geo_chain.geo_chain_fwd(enc, w1, w2, 100.0, count)),
                 "plain_ms": time_ms(lambda: geo_chain.geo_chain_fwd_reference(enc, w1, w2, 100.0), 3),
                 "graph_ms": graph_ms(lambda: geo_chain.geo_chain_fwd(enc, w1, w2, 100.0, count)),
                 "library_ms": time_ms(lambda: autograd_fwd(enc, w1, w2), 5)}
        suffix = add_bound(entry, [bound(n * (32 + 17 + 32) * 4, n * M_FMAS * 2, F32_FLOP_S)])
        rows.append("M geo_chain_fwd ({}: {} rows, 32 -> 64 -> 17 f32): max abs err {:.3e} (tol 1e-5 x max|ref|), "
                    "kernel {:.4f} ms (CUDA graph {:.4f} ms), plain {:.4f} ms, autograd create-graph chain {:.4f} "
                    "ms, {}".format(label, n, err, entry["ms"], entry["graph_ms"], entry["plain_ms"],
                                    entry["library_ms"], suffix))
        if label == "step":
            stats["M"] = entry
        else:
            stats["M"]["occupancy_update"] = entry
            break
        grads = geo_chain.geo_chain_bwd(enc, w1, w2, d_out, d_g, 100.0, count)
        want = geo_chain.geo_chain_bwd_reference(enc, w1, w2, d_out, d_g, 100.0)
        err = max(check_scaled("geo_chain d_enc", grads[0], want[0], 1e-5),
                  check_scaled("geo_chain dW1", grads[1], want[1], 1e-4),
                  check_scaled("geo_chain dW2", grads[2], want[2], 1e-4))
        leaves, h, ag = autograd_fwd(enc, w1, w2)
        entry = {"max_abs_err": err,
                 "ms": time_ms(lambda: geo_chain.geo_chain_bwd(enc, w1, w2, d_out, d_g, 100.0, count)),
                 "plain_ms": time_ms(lambda: geo_chain.geo_chain_bwd_reference(enc, w1, w2, d_out, d_g, 100.0), 3),
                 "graph_ms": graph_ms(lambda: geo_chain.geo_chain_bwd(enc, w1, w2, d_out, d_g, 100.0, count)),
                 "library_ms": time_ms(lambda: torch.autograd.grad([h, ag], leaves, [d_out, d_g], retain_graph=True),
                                       5)}
        suffix = add_bound(entry, [bound(n * (32 + 17 + 32 + 32) * 4, n * N_FMAS * 2, F32_FLOP_S)])
        rows.append("N geo_chain_bwd + reduce ({}: {} rows; d_enc, dW1, dW2): max abs err {:.3e} (tol 1e-5 / 1e-4 x "
                    "max|ref|), kernel {:.4f} ms (CUDA graph {:.4f} ms), plain {:.4f} ms, autograd double backward "
                    "{:.4f} ms, {}".format(label, n, err, entry["ms"], entry["graph_ms"], entry["plain_ms"],
                                           entry["library_ms"], suffix))
        stats["N"] = entry
        del leaves, h, ag, grads, want
    return rows, stats


# kernel P's shapes: the VolSDF sampler's GeoNet call (1024 rays x 128
# points, 256 wide) and a step's training points (1024 rays x 98, 256 wide)
P_SAMPLER, P_STEP = (1024 * 128, 256), (1024 * 98, 256)


def compare_softplus(dev, gen):
    """Kernel P (forward at the sampler's call, backward and double backward
    at a step's training points) against the card's three ops and
    autograd's derivatives of them (the library yardstick: what the step
    ran before it), beside its bound (bytes) and its plain version."""
    from arcnerf_torch.ops import softplus as sp

    beta = 100.0
    F = torch.nn.functional
    rows, stats = [], {}

    def inputs(shape):
        x = (torch.rand(shape, generator=gen, device=dev) * 140.0 - 100.0) / beta
        return x, torch.randn(shape, generator=gen, device=dev), torch.randn(shape, generator=gen, device=dev)

    x, _, _ = inputs(P_SAMPLER)
    out = sp.softplus_fwd(x, beta)
    if not (torch.equal(out, F.softplus(beta * x) / beta) and torch.equal(out, sp.softplus_fwd_reference(x, beta))):
        raise AssertionError("softplus_fwd: not the three ops' values bit for bit")
    n = x.numel()
    entry = {"max_abs_err": 0.0, "ms": time_ms(lambda: sp.softplus_fwd(x, beta)),
             "plain_ms": time_ms(lambda: sp.softplus_fwd_reference(x, beta), 5),
             "graph_ms": graph_ms(lambda: sp.softplus_fwd(x, beta)),
             "library_ms": time_ms(lambda: F.softplus(beta * x) / beta)}
    suffix = add_bound(entry, [bound(n * 8, 0, F32_FLOP_S)])
    rows.append("P softplus_fwd (the sampler's call: {} values): bit for bit the three ops, kernel {:.4f} ms (CUDA "
                "graph {:.4f} ms), plain {:.4f} ms, three ops {:.4f} ms, {}".format(
                    n, entry["ms"], entry["graph_ms"], entry["plain_ms"], entry["library_ms"], suffix))
    stats["P"] = entry
    del x, out

    x, d_out, gg = inputs(P_STEP)
    n = x.numel()
    xr, dr = x.clone().requires_grad_(True), d_out.clone().requires_grad_(True)
    out = F.softplus(beta * xr) / beta
    (d_x,) = torch.autograd.grad(out, xr, dr, create_graph=True)
    g_x, g_dout = torch.autograd.grad(d_x, (xr, dr), gg, retain_graph=True)
    got = sp.softplus_bwd(x, d_out, beta)
    if not torch.equal(got, d_x):
        raise AssertionError("softplus_bwd: not autograd's gradient bit for bit")
    entry = {"max_abs_err": 0.0, "ms": time_ms(lambda: sp.softplus_bwd(x, d_out, beta)),
             "plain_ms": time_ms(lambda: sp.softplus_bwd_reference(x, d_out, beta), 5),
             "graph_ms": graph_ms(lambda: sp.softplus_bwd(x, d_out, beta)),
             "library_ms": time_ms(lambda: torch.autograd.grad(out, xr, dr, retain_graph=True), 5)}
    suffix = add_bound(entry, [bound(n * 12, 0, F32_FLOP_S)])
    rows.append("P softplus_bwd (a step's training points: {} values): bit for bit autograd's, kernel {:.4f} ms "
                "(CUDA graph {:.4f} ms), plain {:.4f} ms, autograd's three backwards {:.4f} ms, {}".format(
                    n, entry["ms"], entry["graph_ms"], entry["plain_ms"], entry["library_ms"], suffix))
    stats["P"]["backward"] = entry
    gx, gd = sp.softplus_bwd2(x, d_out, gg, beta)
    err = max(check_scaled("softplus_bwd2 g_x", gx, g_x, 1e-6), check_scaled("softplus_bwd2 g_dout", gd, g_dout, 1e-6))
    entry = {"max_abs_err": err, "ms": time_ms(lambda: sp.softplus_bwd2(x, d_out, gg, beta)),
             "plain_ms": time_ms(lambda: sp.softplus_bwd2_reference(x, d_out, gg, beta), 5),
             "graph_ms": graph_ms(lambda: sp.softplus_bwd2(x, d_out, gg, beta)),
             "library_ms": time_ms(lambda: torch.autograd.grad(d_x, (xr, dr), gg, retain_graph=True), 5),
             "equal": bool(torch.equal(gx, g_x) and torch.equal(gd, g_dout))}
    suffix = add_bound(entry, [bound(n * 20, 0, F32_FLOP_S)])
    rows.append("P softplus_bwd2 (the same values): max abs err {:.3e} (tol 1e-6 x max|ref|; bit for bit: {}), "
                "kernel {:.4f} ms (CUDA graph {:.4f} ms), plain {:.4f} ms, autograd's double backward {:.4f} ms, "
                "{}".format(err, entry["equal"], entry["ms"], entry["graph_ms"], entry["plain_ms"],
                            entry["library_ms"], suffix))
    stats["P"]["double_backward"] = entry
    stats["P"]["max_abs_err"] = err
    return rows, stats


def neus_train():
    """The NeuS-NGP recipe (configs/expr/synthetic_neus_ngp.yaml) for
    NEUS_STEPS eager steps through ``arcnerf_torch.train``, then a render
    of a held-out view: each kernel's launches a step (the warm-up's
    occupancy updates at steps 16 and 32 add B and K launches over every
    voxel centre), the loss finite."""
    from arcnerf_torch import train as train_entry

    expr = os.path.join(WORK_DIR, "neus")
    argv = ["--configs", os.path.join(ROOT, "configs/expr/synthetic_neus_ngp.yaml"), "--device", "cuda:0",
            "--dir.expr_dir", expr, "--progress.epoch", str(NEUS_STEPS), "--progress.epoch_loss", "16",
            "--progress.epoch_val", str(NEUS_STEPS), "--progress.epoch_save_checkpoint", "-1"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    trainer = train_entry.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("ABCDEFKLMNS")
    losses = torch.stack(trainer.loss_history).float().cpu()
    print("NeuS-NGP {} eager steps: wall {:.1f} s, peak {:.2f} GiB, bucket {} rays; launches {}, per step {}; loss "
          "first {:.4f} last {:.4f}, all finite {}".format(
              NEUS_STEPS, wall, torch.cuda.max_memory_allocated() / 2**30, trainer.pipeline.n_rays, launches,
              {k: round(v / NEUS_STEPS, 3) for k, v in launches.items()}, float(losses[0]), float(losses[-1]),
              bool(torch.isfinite(losses).all())))
    if not torch.isfinite(losses).all():
        raise AssertionError("NeuS training: a loss is not finite")
    for key in "BCEFKLMNS":
        if launches[key] < NEUS_STEPS:
            raise AssertionError("NeuS training: kernel {} launched {} times in {} steps".format(
                key, launches[key], NEUS_STEPS))
    shutil.rmtree(expr)
    return launches


VOLSDF_STEPS = 4  # eager steps of the VolSDF lego recipe


def volsdf_train():
    """The VolSDF lego recipe (configs/expr/NeRF/lego/nerf_lego_volsdf.yaml,
    1024 rays, the 8 x 256 GeoNet; its dataset swapped for procedural views
    over white) for VOLSDF_STEPS eager steps after one warm-up step: kernel
    P's launches a step (its forward for each of the sampler's rounds and
    the step's points, a hidden layer each; its backward for the normal and
    the loss; its double backward for the eikonal loss), the loss finite."""
    from arcnerf_torch.ops import softplus as sp
    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.utils.cfgs import dict_to_obj, load_configs, update_configs_by_dotlist

    expr = os.path.join(WORK_DIR, "volsdf")
    cfgs = load_configs(os.path.join(ROOT, "configs/expr/NeRF/lego/nerf_lego_volsdf.yaml"))
    cfgs.dataset = dict_to_obj({"train": {"type": "Synthetic", "n_imgs": 4, "wh": [128, 128], "cam_radius": 2.5,
                                          "white_bkg": True, "center_pixel": True,
                                          "scheduler": {"ray_sample": {"mode": "random", "cross_view": True}}}})
    trainer = ArcNerfTrainer(update_configs_by_dotlist(cfgs, ["--device", "cuda:0", "--dir.expr_dir", expr]))
    trainer.train_steps(0, 1)
    fns = {"softplus_fwd": sp.softplus_fwd, "softplus_bwd": sp.softplus_bwd, "softplus_bwd2": sp.softplus_bwd2}
    for fn in fns.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for epoch in range(1, VOLSDF_STEPS + 1):
        trainer.train_steps(epoch, 1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    per_step = {name: fn.launches / VOLSDF_STEPS for name, fn in fns.items()}
    losses = torch.stack(trainer.loss_history).float().cpu()
    print("VolSDF lego {} eager steps ({} rays, GeoNet {} x {}, n_iter {}): wall {:.1f} s; kernel P launches per step "
          "{}; loss first {:.4f} last {:.4f}, all finite {}".format(
              VOLSDF_STEPS, trainer.pipeline.n_rays, trainer.model.fg_model.geo_net.D, cfgs.model.geometry.W,
              trainer.model.fg_model.n_iter, wall, per_step, float(losses[0]), float(losses[-1]),
              bool(torch.isfinite(losses).all())))
    if not torch.isfinite(losses).all():
        raise AssertionError("VolSDF training: a loss is not finite")
    if min(per_step.values()) <= 0:
        raise AssertionError("VolSDF training: kernel P launched {} times a step".format(per_step))
    del trainer
    shutil.rmtree(expr)
    return sum(fn.launches for fn in fns.values()), per_step


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    from arcnerf_torch.ops import cuda_lib

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    dev = torch.device("cuda:0")
    print("card:", card)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device", torch.cuda.get_device_name(0))

    # ------------------------------------------------------------ build
    t0 = time.perf_counter()
    seconds = cuda_lib.build(verbose=True)
    cuda_lib.ops()
    cuda_lib.lib()
    print("build: nvcc {nvcc:.1f} s (the last kernel object), binding {binding:.1f} s (bindings.cpp, compiled beside "
          "them), link {link:.1f} s; build+load {0:.1f} s".format(time.perf_counter() - t0, **seconds))
    mma_kernels = {"A": "fused_mlp_fwd_kernel", "D": "fused_mlp_bwd_kernel"}
    hmma = count_hmma(cuda_lib.library_path(), mma_kernels.values())
    if hmma is None:
        print("A, D sass: cuobjdump not found, HMMA instructions not counted")
    else:
        for key, name in mma_kernels.items():
            print("{} sass: {} HMMA instructions in {} (cuobjdump -sass)".format(key, hmma[name], name))
            if hmma[name] <= 0:
                raise AssertionError("kernel {}: no tensor-core (HMMA) instruction in its compiled code".format(key))

    # -------------------------------------------- kernels vs plain versions
    gen = torch.Generator(device=dev).manual_seed(SEED)
    stats = {}
    t0 = time.perf_counter()
    for key, fn in (("A", compare_fused_mlp), ("B", compare_hash_encode), ("C", compare_segment_march),
                    ("D", compare_fused_mlp_bwd), ("E", compare_hash_encode_bwd), ("F", compare_segment_march_bwd),
                    ("G", compare_row_gather), ("H", compare_lane_gather), ("I", compare_scatter_add_rows),
                    ("J", compare_update_rows), ("S", compare_sample_compact)):
        rows, stats[key] = fn(dev, gen)
        for row in rows:
            print(row)
    print(compare_scatter_w1(dev, gen))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print("kernel comparisons A-J, S: {:.1f} s".format(time.perf_counter() - t0))

    # ------------------------------------------------------ the launch path
    host, rows = launch_path(dev, gen)
    for row in rows:
        print(row)
    for key, numbers in host.items():
        stats[key].update(numbers)

    # ------------------------------------------------------- the main paths
    tool_launches = run_tools()
    os.makedirs(OUT_DIR, exist_ok=True)
    os.makedirs(WORK_DIR, exist_ok=True)
    _, serving = serve(dev)
    rows, stats["C"]["serving_chunk"] = compare_serving_chunk(serving)
    for row in rows:
        print(row)
    rows, stats["C"]["serving_window"] = compare_serving_window(dev, serving)
    for row in rows:
        print(row)
    stats["C"]["max_abs_err"] = max(stats["C"]["max_abs_err"], stats["C"]["serving_chunk"]["max_abs_err"],
                                    stats["C"]["serving_window"]["max_abs_err"])
    del serving
    train_launches, e_stream, eager_psnr = train(profile="--profile" in sys.argv[1:])
    launches = dict(train_launches, **{k: tool_launches[k] for k in "GHIJ"})
    rows, stats["E"]["training_stream"] = compare_hash_encode_bwd_stream(e_stream)
    for row in rows:
        print(row)
    stats["E"]["max_abs_err"] = max(stats["E"]["max_abs_err"], stats["E"]["training_stream"]["max_abs_err"])
    rows, stats["B"]["training_stream"] = compare_hash_encode_stream(e_stream)
    for row in rows:
        print(row)
    stats["B"]["max_abs_err"] = max(stats["B"]["max_abs_err"], stats["B"]["training_stream"]["max_abs_err"])
    rows, captured = compare_march_stream(e_stream["march"])
    for row in rows:
        print(row)
    for key in "CF":
        stats[key]["captured_stream"] = captured[key]
        stats[key]["max_abs_err"] = max(stats[key]["max_abs_err"], captured[key]["max_abs_err"])
    stats["F"]["captured_stream"]["lengths"] = captured["lengths"]
    del e_stream
    torch.cuda.empty_cache()

    # ------------------------------------------------------------ NeuS-NGP
    rows, neus_stats = compare_hash_dx(dev, gen)
    section_rows, section_stats = compare_sections(dev, gen)
    geo_rows, geo_stats = compare_geo_chain(dev, gen)
    softplus_rows, softplus_stats = compare_softplus(dev, gen)
    for row in rows + section_rows + geo_rows + softplus_rows:
        print(row)
    stats.update(neus_stats)
    stats.update(geo_stats)
    stats.update(softplus_stats)
    stats["S"]["sections"] = section_stats["S"]
    stats["C"]["alpha_mode"], stats["F"]["alpha_mode"] = section_stats["C"], section_stats["F"]
    neus_launches = neus_train()
    launches.update({k: neus_launches[k] for k in "KLMN"})
    torch.cuda.empty_cache()
    launches["P"], stats["P"]["launches_per_step"] = volsdf_train()
    torch.cuda.empty_cache()

    # the graph phase last: its draws do not always repeat on the card
    # (ROADMAP Queue 3), so a failure there is reported after the kernels'
    # line and still fails the run
    graph_failure = None
    try:
        graph = train_graph(eager_psnr)
        print("graph phase: {}".format(json.dumps(graph, sort_keys=True)))
    except AssertionError as err:
        graph_failure = err
        print("graph phase FAILED: {}".format(err))

    meta = {
        "A": ("fused_mlp_fwd", "arcnerf_torch/csrc/fused_mlp.cu", "arcnerf_tpu/ops/fused_mlp.py:125"),
        "B": ("hash_encode_fwd", "arcnerf_torch/csrc/hash_encode.cu",
              "arcnerf_tpu/models/base_modules/encoding.py:544"),
        "C": ("segment_march_fwd", "arcnerf_torch/csrc/segment_march.cu", "arcnerf_tpu/render/ray_helper.py:328"),
        "D": ("fused_mlp_bwd", "arcnerf_torch/csrc/fused_mlp_bwd.cu", "arcnerf_tpu/ops/fused_mlp.py:172"),
        "E": ("hash_encode_bwd", "arcnerf_torch/csrc/hash_encode_bwd.cu",
              "arcnerf_tpu/models/base_modules/encoding.py:69"),
        "F": ("segment_march_bwd", "arcnerf_torch/csrc/segment_march_bwd.cu", "arcnerf_tpu/render/ray_helper.py:328"),
        "G": ("row_gather", "arcnerf_torch/csrc/row_gather.cu",
              "tools/roofline_hashgrid.py:149; scripts/probe_pallas_gather.py:55,87,102,124; "
              "scripts/probe_pallas_gather2.py:42,72,104,123,171"),
        "H": ("lane_gather", "arcnerf_torch/csrc/lane_gather.cu",
              "scripts/probe_scatter.py:115,155; scripts/probe_pallas_gather.py:40,71; "
              "scripts/probe_pallas_gather2.py:57,88"),
        "I": ("scatter_add_rows", "arcnerf_torch/csrc/scatter_add_rows.cu", "scripts/probe_pallas_gather.py:142"),
        "J": ("build_update_rows", "arcnerf_torch/csrc/update_rows.cu", "scripts/probe_cons_forms.py:95"),
        "S": ("sample_compact", "arcnerf_torch/csrc/sample_compact.cu",
              "none (XLA: models/base_modules/obj_bound.py:60, geometry/volume.py:288,307, "
              "render/ray_helper.py:162, models/fg_model.py:227)"),
        "K": ("hash_encode_dx", "arcnerf_torch/csrc/hash_dx.cu",
              "none (jax.grad through the unfused element path, models/base_modules/encoding.py)"),
        "L": ("hash_dx_bwd", "arcnerf_torch/csrc/hash_dx.cu",
              "none (jax.grad of jax.grad through the unfused element path)"),
        "M": ("geo_chain_fwd", "arcnerf_torch/csrc/geo_chain.cu",
              "none (jax.grad of GeoNet's sdf, arcnerf_tpu/models/sdf_model.py geo_with_grad)"),
        "N": ("geo_chain_bwd", "arcnerf_torch/csrc/geo_chain.cu", "none (jax.grad of that jax.grad)"),
        "P": ("softplus", "arcnerf_torch/csrc/softplus.cu",
              "none (XLA fuses the activation and its derivatives, arcnerf_tpu/models/base_modules/activation.py)"),
    }
    kernels = [dict(name=meta[k][0], route="cuda", source=meta[k][1], replaces=meta[k][2], launches=launches[k],
                    **stats[k]) for k in "ABCDEFGHIJSKLMNP"]
    print(json.dumps({"kernels": kernels}))
    print(card)
    if graph_failure is not None:
        raise SystemExit("chip_smoke: graph phase failed: {}".format(graph_failure))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
