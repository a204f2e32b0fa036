"""Floors and design variants of kernel J (lane-packed update rows) on the
card, beside the port's kernel and its ``scatter_add_`` yardstick: the
measurements the design in ``arcnerf_torch/csrc/update_rows.cu`` was chosen
by, and what held the first kernel (a warp a row) at 42 % of its bound. A
one-off study, not part of the package: nothing in ``arcnerf_torch`` or
``chip_smoke.py`` runs it.

Each variant (``update_rows_designs.cu``, built with nvcc into
``arcnerf_torch/csrc/build/`` on first use and called through ctypes; the
list is at the top of that file), the port's kernel (through its wrapper)
and the yardstick (``torch.zeros`` + ``scatter_add_``, its index made
outside the timed call) run at the probe's two geometries (quad K = 2^19,
offsets (0, 2, 62, 64); pair K = 2^20, offsets (0, 2); F = 2, lane0 in
[0, 60)) and at quad's terms on pair's K, each replayed from a CUDA graph.
Every variant but the floors must equal the plain version bit for bit,
there and on small edge cases (K of 1, 31, 33, 777 and 5000; 1, 3, 4, 6
and 8 terms; overlapping offsets; lane0 in [-10, 130)). The bound is the
bytes: lane0 and the values read once, K x 512 bytes written, over
3.35 TB/s.

Run, from the root of the repository: ``python -m design_studies.update_rows_designs``
(the card only).
"""

import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

import chip_smoke
from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops.gather_scatter import LANES, build_update_rows, build_update_rows_reference
from arcnerf_torch.tools import device_label, generator, parse_device, print_table
from arcnerf_torch.tools.probe_cons_forms import build_scatter_add, scatter_add_index
from design_studies.gather_designs import graph_ms

SOURCE = Path(__file__).resolve().with_name("update_rows_designs.cu")
PACKAGE_SOURCE = cuda_lib.CSRC / "update_rows.cu"  # included by SOURCE (variant "package kernel")
VARIANTS = ("store floor", "store floor, stcs", "bulk-copy floor", "parent", "terms unrolled", "+ stcs",
            "warp tile", "warp tile + stcs", "+ persistent", "shared scatter", "shared + bulk, 2 tiles",
            "shared + bulk, 3 tiles", "read + store floor", "blocked", "blocked, prefetched",
            "shared, blocked, prefetched", "L2 pass + warp tile + stcs", "L2 pass + read + store floor",
            "read floor", "L2 pass alone", "tile store floor", "strided store floor", "strided warp tile",
            "strided shared", "runs of 4, floor", "runs of 4, ahead, floor", "runs of 16, ahead, floor",
            "runs of 4, ahead", "runs of 16, ahead", "phased floor", "phased, shared scatter",
            "phased, registers, 16 warps", "phased, registers, 32 warps", "package kernel, entry point",
            "phased, 16-byte head", "phased, rows unrounded")
FLOORS = {0, 1, 2, 12, 17, 18, 19, 20, 21, 24, 25, 26, 29}  # the floors write zeros and are not compared
GEOMETRIES = (("quad K=2^19", 1 << 19, (0, 2, 62, 64)), ("pair K=2^20", 1 << 20, (0, 2)),
              ("quad terms, K=2^20", 1 << 20, (0, 2, 62, 64)))
F = 2
# (K, offsets, n_feat): the edge cases every compared variant must pass
EDGES = ((1, (0,), 1), (31, (0, 2, 62, 64), 2), (33, (0, 1), 2), (777, (0, 5, 9), 1), (5000, (0, 1, 2), 2),
         (4099, (0, 2), 2), (100, (0, 60, 120), 1))


def load():
    """The variants' library, built first if needed."""
    digest = hashlib.sha256(SOURCE.read_bytes() + PACKAGE_SOURCE.read_bytes()).hexdigest()[:12]
    out = cuda_lib.BUILD_DIR / "update_rows_designs_{}.so".format(digest)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-Xptxas", "-v", "-shared", str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
        print_registers(proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_update_rows.argtypes = [I, P, P, LL, ctypes.POINTER(ctypes.c_int), I, I, P, P]
    return lib


def print_registers(report):
    """Registers and spills of each kernel at 8 and 4 terms (and the
    untemplated ones), from ptxas's report."""
    name = None
    for line in report.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "Used" in line and name is not None:
            if "ILi8E" in name or "ILi4E" in name or "ILi" not in name:
                try:
                    shown = subprocess.run(["c++filt", name], capture_output=True, text=True).stdout.strip()
                except OSError:
                    shown = name
                shown = shown.replace("void (anonymous namespace)::", "").split("(")[0]
                print("ptxas:", shown, "|", line.split(":", 1)[1].strip())
            name = None
        elif "spill" in line and "0 bytes spill" not in line and name is not None:
            print("ptxas spill:", name, line.strip())


def caller(lib, v, lane0, vals, offs, n_feat, out):
    """One launch of variant ``v`` on the current stream, checked."""
    c_offs = (ctypes.c_int * len(offs))(*offs)

    def call():
        cuda_lib.check(lib.design_update_rows(v, lane0.data_ptr(), vals.data_ptr(), lane0.shape[0], c_offs, len(offs),
                                              n_feat, out.data_ptr(), torch.cuda.current_stream().cuda_stream),
                       "design_update_rows")

    return call


def check_edges(lib, gen):
    """Every compared variant against the plain version on the edge cases."""
    dev = gen.device
    for k, offs, n_feat in EDGES:
        lane0 = torch.randint(-10, 130, (k,), generator=gen, device=dev, dtype=torch.int32)
        vals = torch.rand((k, len(offs) * n_feat), generator=gen, device=dev)
        ref = build_update_rows_reference(lane0, vals, offs, n_feat)
        out = torch.empty((k, LANES), device=dev)
        for v in sorted(set(range(len(VARIANTS))) - FLOORS):
            out.fill_(float("nan"))
            caller(lib, v, lane0, vals, offs, n_feat, out)()
            if not torch.equal(out, ref):
                raise AssertionError("variant {} differs from the plain version at K={}, offsets {}, n_feat {}".format(
                    VARIANTS[v], k, offs, n_feat))


def run_geometry(lib, gen, label, k, offs):
    """The port's kernel, the yardstick and each variant at one geometry:
    {name: ms a call, "bound": ms}."""
    dev = gen.device
    lane0 = torch.randint(0, 60, (k,), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.rand((k, len(offs) * F), generator=gen, device=dev)
    ref = build_update_rows_reference(lane0, vals, offs, F)
    idx = scatter_add_index(lane0, offs, F)
    if not torch.equal(build_update_rows(lane0, vals, offs, F), ref):
        raise AssertionError("the port's kernel differs from the plain version at " + label)
    if not torch.equal(build_scatter_add(idx, vals), ref):
        raise AssertionError("the yardstick differs from the plain version at " + label)
    cells = {"bound": chip_smoke.bound(lane0.numel() * 4 + vals.numel() * 4 + k * LANES * 4, 0, 1.0)[0],
             "kernel": graph_ms(lambda: build_update_rows(lane0, vals, offs, F)),
             "scatter_add_": graph_ms(lambda: build_scatter_add(idx, vals))}
    out = torch.empty((k, LANES), device=dev)
    for v, name in enumerate(VARIANTS):
        call = caller(lib, v, lane0, vals, offs, F, out)
        out.fill_(float("nan"))
        call()
        if v not in FLOORS and not torch.equal(out, ref):
            raise AssertionError("variant {} differs from the plain version at {}".format(name, label))
        cells[name] = graph_ms(call)
    return cells


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type != "cuda":
        raise RuntimeError("update_rows_designs times CUDA kernels: it runs on the card only")
    print("device:", device_label(dev), "|", chip_smoke.card_line())
    lib, gen, results = load(), generator(dev), {}
    check_edges(lib, gen)
    print("edge cases: every compared variant equals the plain version")
    for label, k, offs in GEOMETRIES:
        results[label] = run_geometry(lib, gen, label, k, offs)
        torch.cuda.empty_cache()
    print("device ms a call (share of the bound), each replayed from a CUDA graph; 'kernel' is the port's kernel "
          "through its wrapper, 'scatter_add_' torch.zeros + scatter_add_ (its index made outside)")
    rows = [["bound"] + ["{:.4f}".format(results[g]["bound"]) for g, _, _ in GEOMETRIES]]
    for name in ["kernel", "scatter_add_", *VARIANTS]:
        rows.append([name] + ["{:.4f} ({:.0%})".format(results[g][name], results[g]["bound"] / results[g][name])
                              for g, _, _ in GEOMETRIES])
    print_table(["case"] + [g for g, _, _ in GEOMETRIES], rows)
    return results


if __name__ == "__main__":
    main()
