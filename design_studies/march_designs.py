"""Design variants of kernels F (compositing backward) and C (compositing
forward) on the card, beside the port's kernels: the measurements the
designs in ``arcnerf_torch/csrc/segment_march_bwd.cu`` and
``segment_march.cu`` were chosen by, among them whether several short rays
should share a warp. A one-off study, not part of the package: nothing in
``arcnerf_torch`` or ``chip_smoke.py`` runs it.

Each variant (``march_designs.cu``, which includes the package's kernel
source, built with nvcc into ``arcnerf_torch/csrc/build/`` on first use and
called through ctypes) runs on each stream replayed from a CUDA graph
(device time, no host launch work between calls), beside the port's kernel
through its C entry point in the same library (32 lanes a ray) and through
its wrapper (which also zeroes the outputs), and must agree with the plain
version within 1e-4 of its largest value. Kernel C runs through its entry
point at the widths it ships (32 and 8 lanes a ray), beside its template at
16 and 4 lanes and its earlier design, one thread a ray (both in
``march_fwd_designs.cu``, which includes the package's source), and its
wrapper at the width the main path gives that stream; each must agree with
the plain version within C_TOL (``chip_smoke``). Streams:

  synthetic  ``chip_smoke.march_stream``: 16384 rays of 0-32 samples over 2^18 rows
  long tail  16384 rays of 0-512 samples (``arcnerf_torch.tools.march_streams``)
  cap 16     (C only) 16384 rays, 43 % empty and the rest 16 samples, as the
             serving chunk that crosses the spheres
  captured   with ``--captured``: the stream one training step hands kernels
             C and F (``chip_smoke.train``: 400 steps first)
  serving    with ``--serving`` (C only): the stream of that 16384-ray chunk
             of the 800x800 serving frame (``chip_smoke.serve``)

Run, from the root of the repository: ``python -m design_studies.march_designs
[--captured] [--serving]`` (the card only).
"""

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.render.ray_helper import (march_group, segment_march_bwd, segment_march_bwd_reference,
                                             segment_march_fwd, segment_march_reference)
from arcnerf_torch.tools import device_label, generator, print_table
from arcnerf_torch.tools.march_streams import long_tail_lengths, ray_gradients, segment_stream
from design_studies.hash_encode_designs import captured_stream, graph_ms

SOURCE = Path(__file__).resolve().with_name("march_designs.cu")
FWD_SOURCE = Path(__file__).resolve().with_name("march_fwd_designs.cu")
VARIANTS = ("thread a ray (earlier kernel)", "16 lanes a ray", "8 lanes a ray", "32 lanes a ray (the kernel)")
TOL = 1e-4  # chip_smoke.F_TOL
C_VARIANTS = ("thread a ray (earlier kernel)", "32 lanes", "16 lanes", "8 lanes", "4 lanes")
C_WIDTHS = (0, 32, 16, 8, 4)  # 0: a thread a ray
C_SHIPPED = (32, 8)  # the widths the package's entry point takes
C_TOL = 1e-4  # chip_smoke.C_TOL, relative and absolute


def load_fwd():
    """Kernel C's variants, built first if needed."""
    text = b"".join(p.read_bytes() for p in (FWD_SOURCE, cuda_lib.CSRC / "segment_march.cu",
                                             cuda_lib.CSRC / "seg_scan.cuh"))
    digest = hashlib.sha256(text).hexdigest()[:12]
    out = cuda_lib.BUILD_DIR / "march_fwd_designs_{}.so".format(digest)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-shared", str(FWD_SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_segment_march_fwd.argtypes = [P, P, P, P, P, I, LL, I, P, I, I, P, P, P, P, P]
    return lib


def run_fwd_stream(lib, label, stream, group):
    """Kernel C through its wrapper at ``group`` lanes a ray, its entry point
    at each width and its earlier design on one stream (sigma, rgb, z, off,
    cnt, add_inf_z, bkg, white_bkg): ms, checked against the plain version."""
    sigma, rgb, z, off, cnt, add_inf_z, bkg, white_bkg = stream
    ref = segment_march_reference(*stream)
    cells = {"wrapper": graph_ms(lambda: segment_march_fwd(*stream, group=group))}
    n_rays = off.shape[0]
    outs = (torch.empty((n_rays, 3), device=z.device),) + tuple(torch.empty(n_rays, device=z.device) for _ in range(3))
    head = [t.data_ptr() for t in (sigma, rgb, z, off, cnt)] + [n_rays, z.shape[0], add_inf_z,
                                                                 None if bkg is None else bkg.data_ptr(), white_bkg]
    tail = [t.data_ptr() for t in outs]
    entry = cuda_lib.lib().arcnerf_segment_march_fwd
    texts = ["{:.4f}".format(cells["wrapper"])]
    for v, name in enumerate(C_VARIANTS):
        def call(v=v):
            stream_, width = torch.cuda.current_stream().cuda_stream, C_WIDTHS[v]
            if width in C_SHIPPED:  # the package's launcher takes a window tail after the width (none here)
                return entry(*head, width, None, *tail, stream_)
            return lib.design_segment_march_fwd(*head, width, *tail, stream_)

        for t in outs:
            t.fill_(float("nan"))
        cuda_lib.check(call(), "segment_march_fwd " + name)
        torch.cuda.synchronize()
        for out, key in zip(outs, ("rgb", "depth", "mask", "trans_end")):
            bad = (out - ref[key]).abs() > C_TOL + C_TOL * ref[key].abs()
            if bool(bad.any()) or not bool(torch.isfinite(out).all()):
                raise AssertionError("C variant {} is off the plain version on {} ({})".format(name, label, key))
        cells[name] = graph_ms(call)
        texts.append("{:.4f}".format(cells[name]))
    return cells, [label, str(group)] + texts


def load():
    """The variants' library, built first if needed."""
    text = b"".join(p.read_bytes() for p in (SOURCE, cuda_lib.CSRC / "segment_march_bwd.cu",
                                             cuda_lib.CSRC / "seg_scan.cuh"))
    out = cuda_lib.BUILD_DIR / "march_designs_{}.so".format(hashlib.sha256(text).hexdigest()[:12])
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-shared", str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_segment_march_bwd.argtypes = [I, P, P, P, P, P, I, LL, I, P, I, P, P, P, P, P, P]
    lib.arcnerf_segment_march_bwd.argtypes = [P, P, P, P, P, I, LL, I, P, I, P, P, P, P, P, P]
    return lib


def _scaled_err(out, ref):
    return float((out - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)


def run_stream(lib, label, args):
    """The port's kernel and each variant on one stream (the wrapper's
    arguments): ms, checked against the plain version."""
    sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z, bkg, white_bkg = args
    ref = segment_march_bwd_reference(*args)
    cells = {"wrapper": graph_ms(lambda: segment_march_bwd(*args))}
    outs = (torch.empty_like(sigma), torch.empty_like(rgb))
    ptrs = [t.data_ptr() for t in (sigma, rgb, z, off, cnt)]
    tail = [add_inf_z, None if bkg is None else bkg.data_ptr(), white_bkg,
            *[t.data_ptr() for t in (g_rgb, g_depth, g_mask, *outs)]]
    texts = ["{:.4f}".format(cells["wrapper"])]
    for v, name in enumerate(VARIANTS):
        def call(v=v):
            stream = torch.cuda.current_stream().cuda_stream
            if v == 3:
                return lib.arcnerf_segment_march_bwd(*ptrs, off.shape[0], z.shape[0], *tail, stream)
            return lib.design_segment_march_bwd(v, *ptrs, off.shape[0], z.shape[0], *tail, stream)

        for t in outs:
            t.zero_()
        cuda_lib.check(call(), "design_segment_march_bwd")
        torch.cuda.synchronize()
        err = max(_scaled_err(o, r) for o, r in zip(outs, ref))
        if err > TOL:
            raise AssertionError("variant {} is {} x max|ref| off the plain version on {}".format(name, err, label))
        cells[name] = graph_ms(call)
        texts.append("{:.4f}".format(cells[name]))
    return cells, [label] + texts


def main(argv=None):
    import chip_smoke

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--captured", action="store_true", help="also the stream of a training step (trains first)")
    parser.add_argument("--serving", action="store_true", help="also a chunk of the serving frame (C only)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("march_designs times CUDA kernels: it runs on the card only")
    dev = torch.device("cuda:0")
    print("device:", device_label(dev))
    lib, gen = load(), generator(dev)

    def ray_args(n_rays, seed):
        g_rgb, g_depth, g_mask, bkg = (torch.from_numpy(a).to(dev) for a in ray_gradients(n_rays, seed))
        return g_rgb, g_depth, g_mask, False, bkg, False

    synthetic = chip_smoke.march_stream(dev, gen, 16384, 1 << 18)
    lengths = long_tail_lengths(16384, 1)
    long_tail = [torch.from_numpy(a).to(dev) for a in segment_stream(lengths, int(lengths.sum()), 2)]
    streams = [("synthetic", (*synthetic, *ray_args(16384, 3))), ("long tail", (*long_tail, *ray_args(16384, 4)))]
    if args.captured:
        m = captured_stream()["march"]
        streams.append(("captured", tuple(m[k] for k in ("sigma", "rgb", "z", "off", "cnt", "g_rgb", "g_depth",
                                                          "g_mask", "add_inf_z", "bkg", "white_bkg"))))
    results, rows = {}, []
    for label, stream in streams:
        results[label], row = run_stream(lib, label, stream)
        off, cnt, k = stream[3], stream[4], stream[2].shape[0]
        rows.append(row)
        print("{}: {}".format(label, chip_smoke.length_text(chip_smoke.segment_lengths(off, cnt, k))))
    print("F: device ms a call, each replayed from a CUDA graph; 'wrapper' is the port's kernel through its wrapper "
          "(outputs zeroed), the last column through its C entry point")
    print_table(["stream", "wrapper"] + list(VARIANTS), rows)

    fwd, c_rows = load_fwd(), []
    lengths16 = torch.where(torch.rand(16384, generator=torch.Generator().manual_seed(5)) < 0.43, 0, 16).numpy()
    cap16 = [torch.from_numpy(a).to(dev) for a in segment_stream(lengths16, 1 << 18, 6)]
    c_streams = [(label, s[:5] + s[8:], march_group(None)) for label, s in streams]
    c_streams.insert(2, ("cap 16", (*cap16, False, torch.ones((16384, 3), device=dev), False), march_group(16)))
    if args.serving:
        import os

        os.makedirs(chip_smoke.OUT_DIR, exist_ok=True)
        os.makedirs(chip_smoke.WORK_DIR, exist_ok=True)
        m = chip_smoke.serve(dev)[1]
        c_streams.append(("serving", tuple(m[k] for k in ("sigma", "rgb", "z", "off", "cnt", "add_inf_z", "bkg",
                                                          "white_bkg")), m["kwargs"].get("group", 32)))
    for label, stream, group in c_streams:
        results["C " + label], row = run_fwd_stream(fwd, label, stream, group)
        c_rows.append(row)
        print("C {}: {}".format(label, chip_smoke.length_text(chip_smoke.segment_lengths(stream[3], stream[4],
                                                                                         stream[2].shape[0]))))
    print("C: device ms a call, each replayed from a CUDA graph; 'wrapper' is the port's kernel through its wrapper "
          "at the main path's width for the stream, the rest through the entry points")
    print_table(["stream", "width", "wrapper"] + list(C_VARIANTS), c_rows)
    return results


if __name__ == "__main__":
    main()
