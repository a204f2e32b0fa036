"""Design variants of kernel F (compositing backward) on the card, beside
the port's kernel: the measurements the design in
``arcnerf_torch/csrc/segment_march_bwd.cu`` was chosen by, among them
whether several short rays should share a warp. A one-off study, not part
of the package: nothing in ``arcnerf_torch`` or ``chip_smoke.py`` runs it.

Each variant (``march_designs.cu``, which includes the package's kernel
source, built with nvcc into ``arcnerf_torch/csrc/build/`` on first use and
called through ctypes) runs on each stream replayed from a CUDA graph
(device time, no host launch work between calls), beside the port's kernel
through its C entry point in the same library (32 lanes a ray) and through
its wrapper (which also zeroes the outputs), and must agree with the plain
version within 1e-4 of its largest value. Streams:

  synthetic  ``chip_smoke.march_stream``: 16384 rays of 0-32 samples over 2^18 rows
  long tail  16384 rays of 0-512 samples (``arcnerf_torch.tools.march_streams``)
  captured   with ``--captured``: the stream one training step hands kernel F
             (``chip_smoke.train``: 400 steps first)

Run, from the root of the repository: ``python -m design_studies.march_designs
[--captured]`` (the card only).
"""

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.render.ray_helper import segment_march_bwd, segment_march_bwd_reference
from arcnerf_torch.tools import device_label, generator, print_table
from arcnerf_torch.tools.march_streams import long_tail_lengths, ray_gradients, segment_stream
from design_studies.hash_encode_designs import captured_stream, graph_ms

SOURCE = Path(__file__).resolve().with_name("march_designs.cu")
VARIANTS = ("thread a ray (earlier kernel)", "16 lanes a ray", "8 lanes a ray", "32 lanes a ray (the kernel)")
TOL = 1e-4  # chip_smoke.F_TOL


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
    print("device ms a call, each replayed from a CUDA graph; 'wrapper' is the port's kernel through its wrapper "
          "(outputs zeroed), the last column through its C entry point")
    print_table(["stream", "wrapper"] + list(VARIANTS), rows)
    return results


if __name__ == "__main__":
    main()
