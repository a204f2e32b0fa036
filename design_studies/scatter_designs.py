"""Floors and design variants of kernel I's W = 1 route (row scatter-add of
single floats) on the card, beside the port's kernel and ``index_add_``:
the measurements the route in ``arcnerf_torch/csrc/scatter_add_rows.cu``
was chosen by, and whether atomics or a destination partition win at
kernel E's scale (2^25 updates into 2^23 entries). A one-off study, not
part of the package: nothing in ``arcnerf_torch`` or ``chip_smoke.py``
runs it.

Each variant (``scatter_designs.cu``, which includes the package's kernel
source, built with nvcc into ``arcnerf_torch/csrc/build/`` on first use and
called through ctypes), the port's kernel (through its wrapper) and
``index_add_`` run on uniform random indices at each shape, each replayed
from a CUDA graph (device time, no host launch work between calls), adding
into a table that is not zeroed between calls. The kernel's variants must
agree with the plain version within 1e-5 of its largest value
(``chip_smoke.I_TOL``); the floors are not compared.

Run, from the root of the repository: ``python -m design_studies.scatter_designs``
(the card only).
"""

import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops.gather_scatter import scatter_add_rows, scatter_add_rows_reference
from arcnerf_torch.tools import device_label, generator, parse_device, print_table
from design_studies.gather_designs import graph_ms

SOURCE = Path(__file__).resolve().with_name("scatter_designs.cu")
VARIANTS = ("RED floor, random", "RED floor, sorted", "copy 8 n bytes", "RED kernel", "partition", "passes 1-2",
            "passes 2-3", "pass 4", "RED, evict-first loads", "partition 13/1024/16", "partition 14/1024/8",
            "partition 15/1024/16", "partition 14/512/16", "partition 14/512/32", "8-byte pairs",
            "8-byte, evict-first", "8-byte, sums on 512 threads")
COMPARED = {3, 4, 8, 9, 10, 11, 12, 13, 14, 15, 16}  # the variants held against the plain version
# the partition's variants need at most 2048 buckets of 2^13 entries
PARTITION = {4, 5, 6, 7, 9, 10, 11, 12, 13, 14, 15, 16}
# (label, n_table, n): kernel E's scale first, then smaller shapes around the route's threshold
SHAPES = (("2^25 -> 2^23", 1 << 23, 1 << 25), ("2^24 -> 2^23", 1 << 23, 1 << 24), ("2^25 -> 2^22", 1 << 22, 1 << 25),
          ("2^24 -> 2^22", 1 << 22, 1 << 24), ("2^23 -> 2^21", 1 << 21, 1 << 23),
          ("2^22 -> 2^20", 1 << 20, 1 << 22), ("2^21 -> 2^19", 1 << 19, 1 << 21), ("2^20 -> 2^18", 1 << 18, 1 << 20),
          ("2^18 -> 64^3", 64 ** 3, 1 << 18))
TOL = 1e-5  # chip_smoke.I_TOL


def load():
    """The variants' library, built first if needed."""
    text = b"".join(p.read_bytes() for p in (SOURCE, cuda_lib.CSRC / "scatter_add_rows.cu"))
    out = cuda_lib.BUILD_DIR / "scatter_designs_{}.so".format(hashlib.sha256(text).hexdigest()[:12])
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-shared", str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_scatter.argtypes = [I, P, LL, P, P, LL, P, P]
    lib.design_dirty_shared.argtypes = [ctypes.c_float, P]
    return lib


def run_shape(lib, gen, label, n_table, n):
    """The port's kernel, index_add_ and each variant at one shape: ms a
    call, the compared variants checked against the plain version."""
    dev = gen.device
    idx = torch.randint(0, n_table, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((n, 1), generator=gen, device=dev)
    ref = scatter_add_rows_reference(torch.zeros((n_table, 1), device=dev), idx, g)
    scale = float(ref.abs().max())
    out = torch.zeros((n_table, 1), device=dev)
    if float((scatter_add_rows(out, idx, g) - ref).abs().max()) > TOL * scale:
        raise AssertionError("the port's kernel is off the plain version at " + label)
    cells = {"kernel": graph_ms(lambda: scatter_add_rows(out, idx, g)),
             "index_add_": graph_ms(lambda: out.index_add_(0, idx, g))}
    scratch = torch.empty((2 * n, 2), device=dev)
    stream = torch.cuda.current_stream

    for v, name in enumerate(VARIANTS):
        if v in PARTITION and (n_table + 8191) // 8192 > 2048:
            cells[name] = None
            continue

        def call(v=v):
            return lib.design_scatter(v, out.data_ptr(), n_table, idx.data_ptr(), g.data_ptr(), n, scratch.data_ptr(),
                                      stream().cuda_stream)

        if v in COMPARED:
            out.zero_()
            cuda_lib.check(call(), "design_scatter")
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            if err > TOL * scale:
                raise AssertionError("variant {} is {} off the plain version at {} (tol {})".format(
                    name, err, label, TOL * scale))
        cells[name] = graph_ms(call)
    return cells, [label] + ["-" if cells[k] is None else "{:.4f}".format(cells[k])
                             for k in ["kernel", "index_add_", *VARIANTS]]


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type != "cuda":
        raise RuntimeError("scatter_designs times CUDA kernels: it runs on the card only")
    print("device:", device_label(dev))
    lib, gen, results, rows = load(), generator(dev), {}, []
    for label, n_table, n in SHAPES:
        results[label], row = run_shape(lib, gen, label, n_table, n)
        rows.append(row)
        torch.cuda.empty_cache()
    print("device ms a call, each replayed from a CUDA graph (uniform random indices, W = 1, the table not zeroed "
          "between calls); 'kernel' is the port's kernel through its wrapper")
    print_table(["n -> table", "kernel", "index_add_", *VARIANTS], rows)
    return results


if __name__ == "__main__":
    main()
