"""Design variants of kernels G (row gather) and H (lane gather) on the card,
beside the port's kernels and the PyTorch calls of the same function: the
measurements the designs in ``arcnerf_torch/csrc/row_gather.cu`` and
``arcnerf_torch/csrc/lane_gather.cu`` were chosen by, and the floor of H's
random reads. A one-off study, not part of the package: nothing in
``arcnerf_torch`` or ``chip_smoke.py`` runs it.

Each variant (``gather_designs.cu``, built with nvcc into
``arcnerf_torch/csrc/build/`` on first use and called through ctypes) and
the port's kernel (through its wrapper) run at the probes' shapes, each replayed from a CUDA graph
(device time, no host launch work between calls), and must equal the plain
version bit for bit (H's floor probe reads hashed addresses and is not
compared). Rows:

  G  loop_gather (2^19, 128) f32, 2^21 rows (HBM-resident table);
     the same rows from a (2^14, 128) f32 table (L2-resident); the
     (2^14, 128) bf16 and (2048, 128) f32 probe shapes
  H  (8, 2^19) per-row and shared indices; (8, 2048) per-row and shared;
     (1, 2048), 1024 indices

Run, from the root of the repository: ``python -m design_studies.gather_designs``
(the card only).
"""

import ctypes
import hashlib
import subprocess
from pathlib import Path

import torch

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops.gather_scatter import lane_gather, lane_gather_reference, row_gather, row_gather_reference
from arcnerf_torch.tools import device_label, generator, parse_device, print_table

SOURCE = Path(__file__).resolve().with_name("gather_designs.cu")
G_VARIANTS = ("plain stores", "grid-stride", "warp a row (earlier kernel)")
H_VARIANTS = ("four a thread", "eight a thread", "divide (earlier kernel)", "floor: random reads, no index")
G_SHAPES = (("loop_gather (2^19, 128) f32, 2^21 rows", 1 << 19, 1 << 21, torch.float32),
            ("(2^14, 128) f32, 2^21 rows, L2-resident", 1 << 14, 1 << 21, torch.float32),
            ("(2^14, 128) bf16, 2^15 rows", 1 << 14, 1 << 15, torch.bfloat16),
            ("(2048, 128) f32, 1024 rows", 2048, 1024, torch.float32))
H_SHAPES = (("(8, 2^19), per-row idx", 8, 1 << 19, 8, 1 << 19), ("(8, 2^19), shared idx", 8, 1 << 19, 1, 1 << 19),
            ("(8, 2048), per-row idx", 8, 2048, 8, 2048), ("(8, 2048), shared 1024 idx", 8, 2048, 1, 1024),
            ("(1, 2048), 1024 idx", 1, 2048, 1, 1024))
REPS = 20


def load():
    """The variants' library, built first if needed."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:12]
    out = cuda_lib.BUILD_DIR / "gather_designs_{}.so".format(digest)
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        cmd = [cuda_lib._nvcc()] + cuda_lib.NVCC_FLAGS + ["-shared", str(SOURCE), "-o", str(out)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed ({}):\n{}{}".format(" ".join(cmd), proc.stdout, proc.stderr))
    lib = ctypes.CDLL(str(out))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.design_row_gather.argtypes = [I, P, I, P, LL, P, P]
    lib.design_lane_gather.argtypes = [I, P, LL, LL, P, LL, LL, P, P]
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


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _variant(out, ref, fn, compare=True):
    out.zero_()
    fn()
    torch.cuda.synchronize()
    ms = graph_ms(fn)
    ok = not compare or torch.equal(out, ref)
    return "{:.4f}".format(ms) if ok else "{:.4f} WRONG".format(ms), ms, ok


def main(argv=None):
    dev = parse_device(argv, __doc__.splitlines()[0])
    if dev.type != "cuda":
        raise RuntimeError("gather_designs times CUDA kernels: it runs on the card only")
    print("device:", device_label(dev))
    lib, gen, results, table = load(), generator(dev), {}, []
    for label, n_table, n_rows, dtype in G_SHAPES:
        src = torch.randn((n_table, 128), generator=gen, device=dev).to(dtype)
        idx = torch.randint(0, n_table, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
        ref, out = row_gather_reference(src, idx), torch.empty((n_rows, 128), device=dev, dtype=dtype)
        row_bytes = 128 * src.element_size()
        cells = {"kernel": graph_ms(lambda: row_gather(src, idx)),
                 "index_select": graph_ms(lambda: torch.index_select(src, 0, idx))}
        texts = ["{:.4f}".format(cells["kernel"]), "{:.4f}".format(cells["index_select"])]
        for v, name in enumerate(G_VARIANTS):
            text, cells[name], ok = _variant(out, ref, lambda v=v: lib.design_row_gather(
                v, src.data_ptr(), row_bytes, idx.data_ptr(), n_rows, out.data_ptr(), _stream()))
            texts.append(text)
            if not ok:
                raise AssertionError("G variant {} differs from the plain version at {}".format(name, label))
        results["G " + label] = cells
        table.append(["G " + label] + texts)
        del src, idx, ref, out
    for label, m, width, idx_rows, n in H_SHAPES:
        src = torch.randn((m, width), generator=gen, device=dev)
        idx = torch.randint(0, width, (idx_rows, n), generator=gen, device=dev, dtype=torch.int32)
        idx64 = idx.long().expand(m, -1).contiguous()
        ref, out = lane_gather_reference(src, idx), torch.empty((m, n), device=dev)
        stride = 0 if idx_rows == 1 else n
        cells = {"kernel": graph_ms(lambda: lane_gather(src, idx)),
                 "gather": graph_ms(lambda: torch.gather(src, 1, idx64))}
        texts = ["{:.4f}".format(cells["kernel"]), "{:.4f}".format(cells["gather"])]
        for v, name in enumerate(H_VARIANTS):
            text, cells[name], ok = _variant(out, ref, lambda v=v: lib.design_lane_gather(
                v, src.data_ptr(), m, width, idx.data_ptr(), stride, n, out.data_ptr(), _stream()), compare=v != 3)
            texts.append(text)
            if not ok:
                raise AssertionError("H variant {} differs from the plain version at {}".format(name, label))
        results["H " + label] = cells
        table.append(["H " + label] + texts)
    print("device ms a call, each replayed from a CUDA graph; G variants: " + ", ".join(G_VARIANTS) +
          "; H variants: " + ", ".join(H_VARIANTS))
    print_table(["case", "kernel", "library", "variant 0", "variant 1", "variant 2", "variant 3"],
                [row + [""] * (7 - len(row)) for row in table])
    return results


if __name__ == "__main__":
    main()
