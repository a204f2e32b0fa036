"""Design variants of kernel B (hash-grid encode) on the card, beside the
port's kernel: the measurements the design in
``arcnerf_torch/csrc/hash_encode.cu`` was chosen by, among them whether
the kernel should read a bf16 copy of the table. A one-off study, not part
of the package: nothing in ``arcnerf_torch`` or ``chip_smoke.py`` runs it.

Each variant (``hash_encode_designs.cu``, built with nvcc into
``arcnerf_torch/csrc/build/`` on first use and called through ctypes) and
the port's kernel (through its wrapper, the resolutions already on the
card, as a training step calls it) run on the recipe's grid (16 levels x
2^19 entries x F = 2, quad hash, bf16 reads), each replayed from a CUDA
graph (device time, no host launch work between calls), and must equal the
plain version bit for bit. The bf16 copy variant's row also carries the
cast a step would add (``copy_`` of the f32 table into a preallocated bf16
one, from a CUDA graph), since the table changes every step. Streams:

  uniform   2^18 points uniform in the volume
  ray       2^18 ray-ordered points (``arcnerf_torch.tools.hash_streams``:
            the training stream's order and step)
  captured  with ``--captured``: the points one training step encodes, with
            the trained table (``chip_smoke.train``: 400 steps first)

Run, from the root of the repository: ``python -m
design_studies.hash_encode_designs [--captured]`` (the card only).
"""

import argparse
import ctypes
import functools
import hashlib
import os
import subprocess
import sys
from pathlib import Path

import torch

from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode, hash_encode_reference
from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.tools import device_label, generator, print_table
from arcnerf_torch.tools.hash_streams import ray_stream

ROOT = Path(__file__).resolve().parents[1]
SOURCE = Path(__file__).resolve().with_name("hash_encode_designs.cu")
VARIANTS = ("thread a (point, level) (earlier kernel)", "bf16 copy", "direct stores", "a float2 a corner",
            "two levels a warp", "two points a lane", "pair loads", "pair loads, 32 registers")
REPS = 20
_VARIANT_IDS = {"ngp": 0, "pair": 1, "quad": 2}


def load():
    """The variants' library, built first if needed."""
    text = b"".join(p.read_bytes() for p in (SOURCE, cuda_lib.CSRC / "hash_encode.cu", cuda_lib.CSRC / "hash_grid.cuh"))
    out = cuda_lib.BUILD_DIR / "hash_encode_designs_{}.so".format(hashlib.sha256(text).hexdigest()[:12])
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-shared", str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
    lib = ctypes.CDLL(str(out))
    P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.design_hash_encode.argtypes = [I, P, LL, P, I, I, P, F, F, F, F, F, F, I, I, P, P]
    return lib


def graph_ms(fn, reps=REPS):
    """Mean device ms a call over ``reps`` calls replayed from one CUDA graph
    (``fn`` looks up the current stream when called)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
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


@functools.lru_cache(maxsize=None)
def captured_stream():
    """The streams one training step hands kernels B, E and F, with the
    trained table, from a 400-step training run (``chip_smoke.train``; once
    a process, so that both studies read the same step)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
    os.makedirs(chip_smoke.WORK_DIR, exist_ok=True)
    stream = chip_smoke.train()[1]
    return stream


def run_stream(lib, label, xyz, table, res, aabb_min, aabb_len, variant):
    """The port's kernel and each variant on one stream: ms, checked bit for bit."""
    dev = xyz.device
    res_dev = torch.as_tensor(res, dtype=torch.int32, device=dev)
    args = (xyz, table, res, aabb_min, aabb_len, variant, True)
    ref = hash_encode_reference(*args)
    cells = {"kernel": graph_ms(lambda: hash_encode(*args, res_dev=res_dev))}
    if not torch.equal(hash_encode(*args, res_dev=res_dev), ref):
        raise AssertionError("the port's kernel differs from the plain version on " + label)
    table16 = table.to(torch.bfloat16)
    cells["cast"] = graph_ms(lambda: table16.copy_(table))
    out = torch.empty_like(ref)
    n_levels, t_size, _ = table.shape
    mn, ln = [float(v) for v in aabb_min], [float(v) for v in aabb_len]
    texts = ["{:.4f}".format(cells["kernel"])]
    for v, name in enumerate(VARIANTS):
        src = table16 if v == 1 else table

        def call(v=v, src=src):
            lib.design_hash_encode(v, xyz.data_ptr(), xyz.shape[0], src.data_ptr(), n_levels,
                                   t_size.bit_length() - 1, res_dev.data_ptr(), *mn, *ln, _VARIANT_IDS[variant], 1,
                                   out.data_ptr(), torch.cuda.current_stream().cuda_stream)

        out.zero_()
        call()
        torch.cuda.synchronize()
        cells[name] = graph_ms(call)
        if not torch.equal(out, ref):
            raise AssertionError("variant {} differs from the plain version on {}".format(name, label))
        texts.append("{:.4f}".format(cells[name]) + (" + cast {:.4f}".format(cells["cast"]) if v == 1 else ""))
    return cells, [label] + texts


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--captured", action="store_true", help="also the stream of a training step (trains first)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("hash_encode_designs times CUDA kernels: it runs on the card only")
    dev = torch.device("cuda:0")
    print("device:", device_label(dev))
    lib, gen = load(), generator(dev)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False,
                           dtype="bfloat16")
    table = (torch.rand((16, 1 << 19, 2), generator=gen, device=dev) * 2 - 1).contiguous()
    grid = (enc.resolutions, enc.aabb_min, enc.aabb_len, enc.variant)
    streams = [("uniform 2^18", torch.rand((1 << 18, 3), generator=gen, device=dev) * 2 - 1, table, *grid),
               ("ray 2^18", torch.from_numpy(ray_stream(1 << 18, 0)).to(dev), table, *grid)]
    if args.captured:
        s = captured_stream()
        streams.append(("captured {} pts".format(s["xyz"].shape[0]), s["xyz"], s["table"], s["res"], s["aabb_min"],
                        s["aabb_len"], s["variant"]))
    results, rows = {}, []
    for label, *stream in streams:
        results[label], row = run_stream(lib, label, *stream)
        rows.append(row)
    print("device ms a call, each replayed from a CUDA graph (16 levels, T = 2^19, F = 2, quad, bf16 reads)")
    print_table(["stream", "kernel"] + list(VARIANTS), rows)
    return results


if __name__ == "__main__":
    main()
