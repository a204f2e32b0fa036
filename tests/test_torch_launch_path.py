"""The launch path of arcnerf_torch's kernels, on the CPU (no nvcc needed).

(a) Numpy models of the index maths of kernels H (``csrc/lane_gather.cu``)
and G (``csrc/row_gather.cu``), written from the same expressions as the
sources, with the sources' constants and G's lane-group dispatch read from
the files: which thread writes which output from which index. Each output
must be written exactly once, and the result must equal the plain versions
(``lane_gather_reference``, ``row_gather_reference``) and JAX on the CPU
(``jnp.take_along_axis``, ``jnp.take``) bit for bit: both kernels copy.

(b) Source scans: every ``extern "C"`` launcher of ``csrc/*.cu`` is
declared in ``launchers.h`` and called by ``bindings.cpp``; every function
the binding defines is called by a wrapper; no wrapper goes through ctypes
(``cuda_lib.lib()``); the binding includes only light headers.

(c) The build as commands (``cuda_lib.build_commands``, a pure function),
the module name's hash, and a failed build raising instead of falling back.
"""

import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from arcnerf_torch.ops import cuda_lib
from arcnerf_torch.ops.gather_scatter import lane_gather_reference, row_gather_reference

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "arcnerf_torch" / "csrc"
PACKAGE = ROOT / "arcnerf_torch"


def _constant(source, name):
    match = re.search(r"constexpr (?:int|int64_t) {} = (\d+);".format(name), (CSRC / source).read_text())
    assert match, "{} not found in {}".format(name, source)
    return int(match.group(1))


# ------------------------------------------------------------------ kernel H

H_THREADS = _constant("lane_gather.cu", "kThreads")
H_MAX_GRID_Y = _constant("lane_gather.cu", "kMaxGridY")


def model_lane_gather(src, idx_flat, idx_offset, idx_stride, n, max_grid_y=H_MAX_GRID_Y):
    """Kernel H on numpy arrays: src (m, w) f32, the index storage
    ``idx_flat`` whose rows start at ``idx_offset`` (elements) with row
    stride ``idx_stride`` (n, or 0 for a shared row). One thread an output:
    the column from the block and thread along x, the row from blockIdx.y,
    rows past the grid looping. Returns the output, the count of writes of
    each element and the count of reads of each element of ``idx_flat``."""
    m = src.shape[0]
    assert idx_stride in (0, n)
    blocks_x = -(-n // H_THREADS)
    grid_y = min(m, max_grid_y)
    out = np.full((m, n), np.nan, np.float32)
    writes = np.zeros((m, n), np.int64)
    idx_reads = np.zeros(idx_flat.shape[0], np.int64)
    # every thread of the grid's x dimension at once
    j = (np.arange(blocks_x)[:, None] * H_THREADS + np.arange(H_THREADS)[None, :]).reshape(-1)
    j = j[j < n]  # threads past the row return
    for by in range(grid_y):
        for r in range(by, m, grid_y):
            pos = idx_offset + r * idx_stride + j
            np.add.at(idx_reads, pos, 1)
            out[r, j] = src[r, idx_flat[pos]]
            np.add.at(writes[r], j, 1)
    return out, writes, idx_reads


def _lane_inputs(m, width, idx_rows, n, seed, idx_offset=0):
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((m, width)).astype(np.float32)
    flat = rng.integers(0, width, idx_offset + idx_rows * n).astype(np.int32)
    return src, flat, flat[idx_offset:].reshape(idx_rows, n)


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024])
def test_lane_gather_model_matches_plain_and_jax(m, n, shared):
    src, flat, idx = _lane_inputs(m, 50, 1 if shared else m, n, seed=m * 7919 + n)
    out, writes, _ = model_lane_gather(src, flat, 0, 0 if shared else n, n)
    assert (writes == 1).all()
    ref = lane_gather_reference(torch.from_numpy(src), torch.from_numpy(idx)).numpy()
    jax_ref = np.asarray(jnp.take_along_axis(jnp.asarray(src), jnp.asarray(np.broadcast_to(idx, (m, n))), axis=1))
    assert np.array_equal(out, ref) and np.array_equal(out, jax_ref)


@pytest.mark.parametrize("shared", [True, False])
def test_lane_gather_model_takes_an_index_view_at_a_4_byte_offset(shared):
    # an index view one int32 into its storage reads the same indices as an
    # aligned copy: the kernel has no 16-byte path to fall off
    m, n = 8, 1024
    src, flat, idx = _lane_inputs(m, 2048, 1 if shared else m, n, seed=5, idx_offset=1)
    out, writes, _ = model_lane_gather(src, flat, 1, 0 if shared else n, n)
    aligned, _, _ = model_lane_gather(src, flat[1:].copy(), 0, 0 if shared else n, n)
    assert (writes == 1).all() and np.array_equal(out, aligned)
    assert np.array_equal(out, lane_gather_reference(torch.from_numpy(src), torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize("max_grid_y", [1, 3])
@pytest.mark.parametrize("shared", [True, False])
def test_lane_gather_model_rows_past_the_grid_loop(max_grid_y, shared):
    # more rows than the grid's y dimension (capped at kMaxGridY): the
    # blocks loop over the rest
    m, n = 37, 9
    src, flat, idx = _lane_inputs(m, 20, 1 if shared else m, n, seed=11)
    out, writes, _ = model_lane_gather(src, flat, 0, 0 if shared else n, n, max_grid_y=max_grid_y)
    assert (writes == 1).all()
    assert np.array_equal(out, lane_gather_reference(torch.from_numpy(src), torch.from_numpy(idx)).numpy())


@pytest.mark.parametrize("shared", [True, False])
def test_lane_gather_model_index_reads(shared):
    # per-row indices are read once each; a shared index row once for each
    # of the m rows (coalesced reads that hit L2: the random source reads
    # set the time, and a thread for each output keeps the most in flight)
    m, n = 8, 2048
    src, flat, _ = _lane_inputs(m, 2048, 1 if shared else m, n, seed=3)
    _, writes, idx_reads = model_lane_gather(src, flat, 0, 0 if shared else n, n)
    assert (writes == 1).all() and (idx_reads == (m if shared else 1)).all()


# ------------------------------------------------------------------ kernel G

G_THREADS = _constant("row_gather.cu", "kThreads")
G_ROWS = _constant("row_gather.cu", "kRows")


def g_lanes(chunks):
    """The lanes a row gets: the launcher's dispatch, read from the source."""
    text = (CSRC / "row_gather.cu").read_text()
    for limit, lanes in re.findall(r"if \(chunks <= (\d+)\) return launch<(\d+)>", text):
        if chunks <= int(limit):
            return int(lanes)
    return int(re.search(r"\n    return launch<(\d+)>", text).group(1))


def model_row_gather(table_bytes, idx):
    """Kernel G on numpy arrays: table (T, row_bytes) uint8, idx (N,) ->
    the output bytes and the count of writes of each 16-byte chunk. One
    pass: a group of ``g_lanes`` lanes for each kRows consecutive rows."""
    n_rows, row_bytes = idx.shape[0], table_bytes.shape[1]
    chunks = row_bytes // 16
    lanes = g_lanes(chunks)
    groups = G_THREADS // lanes
    rows_per_block = groups * G_ROWS
    grid = -(-n_rows // rows_per_block)
    table = table_bytes.reshape(table_bytes.shape[0], chunks, 16)
    out = np.zeros((n_rows, chunks, 16), np.uint8)
    writes = np.zeros((n_rows, chunks), np.int64)
    for block in range(grid):
        for t in range(G_THREADS):
            lane = t % lanes
            row0 = (block * groups + t // lanes) * G_ROWS
            if row0 >= n_rows:
                continue
            src = [int(idx[row0 + i]) if row0 + i < n_rows else 0 for i in range(G_ROWS)]
            for c in range(lane, chunks, lanes):
                v = [table[src[i], c] for i in range(G_ROWS)]
                for i in range(G_ROWS):
                    if row0 + i < n_rows:
                        out[row0 + i, c] = v[i]
                        writes[row0 + i, c] += 1
    return out.reshape(n_rows, row_bytes), writes


def test_row_gather_lane_groups_fill_the_warp_for_256_and_512_byte_rows():
    # a 256-byte bf16 row takes a half-warp, a 512-byte f32 row a warp: no idle lane
    assert g_lanes(256 // 16) == 16 and g_lanes(512 // 16) == 32
    assert [g_lanes(c) for c in (1, 2, 3, 5, 64)] == [1, 2, 4, 8, 32]
    assert 32 % g_lanes(16) == 0 and G_THREADS % 32 == 0


@pytest.mark.parametrize("n_rows", [1, 3, 37, 999])
@pytest.mark.parametrize("width,dtype", [(128, torch.bfloat16), (128, torch.float32), (4, torch.float32),
                                         (24, torch.bfloat16), (256, torch.float32)])
def test_row_gather_model_matches_plain_and_jax(n_rows, width, dtype):
    gen = torch.Generator().manual_seed(n_rows * 31 + width)
    table = torch.randn((300, width), generator=gen).to(dtype)
    idx = torch.randint(0, 300, (n_rows,), generator=gen, dtype=torch.int32)
    as_bytes = table.view(torch.uint8).numpy()
    ref = row_gather_reference(table, idx)
    out, writes = model_row_gather(as_bytes, idx.numpy())
    assert (writes == 1).all()
    assert np.array_equal(out, ref.view(torch.uint8).numpy())
    jax_ref = np.asarray(jnp.take(jnp.asarray(table.float().numpy()), jnp.asarray(idx.numpy()), axis=0))
    assert np.array_equal(ref.float().numpy(), jax_ref)


# ------------------------------------------------------------ source scans

def _launchers():
    names = set()
    for src in CSRC.glob("*.cu"):
        names |= set(re.findall(r'extern "C" int (arcnerf_\w+)\(', src.read_text()))
    return names


def test_every_launcher_is_declared_and_bound():
    names = _launchers()
    assert len(names) == 19
    header, binding = (CSRC / "launchers.h").read_text(), (CSRC / "bindings.cpp").read_text()
    for name in names:
        assert re.search(r"\bint {}\(".format(name), header), name
        assert re.search(r"\b{}\(".format(name), binding), name
    assert set(cuda_lib._SIGNATURES) == names


def test_every_bound_function_is_called_by_a_wrapper():
    defined = re.findall(r'm\.def\("(\w+)"', (CSRC / "bindings.cpp").read_text())
    assert len(defined) == 21  # a function a launcher, and the two graph-capture queries
    wrappers = "".join(p.read_text() for p in PACKAGE.rglob("*.py"))
    for name in defined:
        assert "cuda_lib.ops().{}(".format(name) in wrappers, name


def test_no_wrapper_launches_through_ctypes():
    for path in PACKAGE.rglob("*.py"):
        if path.name == "cuda_lib.py":
            continue
        text = path.read_text()
        assert "cuda_lib.lib(" not in text and "stream_handle(" not in text, path


def test_gather_designs_tool_runs_on_the_card_only():
    from design_studies import gather_designs

    with pytest.raises(RuntimeError, match="card only"):
        gather_designs.main(["--device", "cpu"])
    names = set(re.findall(r'extern "C" int (design_\w+)\(', gather_designs.SOURCE.read_text()))
    assert names == {"design_row_gather", "design_lane_gather"}


def test_binding_includes_only_light_headers():
    text = (CSRC / "bindings.cpp").read_text()
    includes = re.findall(r"#include [<\"]([^>\"]+)[>\"]", text)
    assert "torch/extension.h" not in includes and "ATen/ATen.h" not in includes
    assert {"ATen/core/Tensor.h", "ATen/ops/empty.h", "c10/cuda/CUDAGuard.h", "c10/cuda/CUDAStream.h",
            "torch/csrc/utils/pybind.h"} <= set(includes)


# ------------------------------------------------------------------ build

def test_build_commands_compile_the_binding_against_torch(tmp_path):
    from torch.utils.cpp_extension import include_paths, library_paths

    out = tmp_path / "arcnerf_kernels_x.so"
    kernels, binding, link = cuda_lib.build_commands("nvcc", tmp_path, out)
    assert sorted(Path(cmd[cmd.index("-c") + 1]).name for cmd in kernels) == sorted(
        p.name for p in CSRC.glob("*.cu"))
    assert all("arch=compute_90a,code=sm_90a" in cmd for cmd in kernels)
    assert str(CSRC / "bindings.cpp") in binding and binding[0] == "nvcc"
    for path in include_paths():
        assert "-I" + path in binding
    assert "-D_GLIBCXX_USE_CXX11_ABI={}".format(int(torch._C._GLIBCXX_USE_CXX11_ABI)) in binding
    assert "-DARCNERF_MODULE=arcnerf_kernels_x" in binding and "-std=c++20" in binding
    assert not any("ninja" in part for part in kernels[0] + binding + link)
    assert link[link.index("-o") + 1] == str(out)
    assert set(cmd[-1] for cmd in kernels) | {binding[-1]} <= set(link)
    for name in ("c10", "c10_cuda", "torch", "torch_cpu", "torch_python"):
        assert "-l" + name in link
    for path in library_paths():
        assert "-L" + path in link and path in link[link.index("-Xlinker") + 1]


def _csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(CSRC, copy, ignore=shutil.ignore_patterns("build"))
    monkeypatch.setattr(cuda_lib, "CSRC", copy)
    monkeypatch.setattr(cuda_lib, "BINDING", copy / "bindings.cpp")
    monkeypatch.setattr(cuda_lib, "BUILD_DIR", copy / "build")
    return copy


def test_module_name_follows_every_source(tmp_path, monkeypatch):
    copy = _csrc_copy(tmp_path, monkeypatch)
    first = cuda_lib.library_path()
    assert first.parent == copy / "build" and first.name.startswith(cuda_lib.module_name())
    for name in ("bindings.cpp", "launchers.h", "lane_gather.cu", "common.cuh"):
        path = copy / name
        path.write_text(path.read_text() + "\n// edited\n")
        now = cuda_lib.library_path()
        assert now != first
        first = now


def test_a_failed_build_raises_and_loads_nothing(tmp_path, monkeypatch):
    _csrc_copy(tmp_path, monkeypatch)
    monkeypatch.setattr(cuda_lib, "_ops", None)
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    fail = [sys.executable, "-c", "import sys; print('no such compiler'); sys.exit(3)"]
    monkeypatch.setattr(cuda_lib, "build_commands", lambda nvcc, work, out, verbose=False: ([fail], fail, fail))
    with pytest.raises(RuntimeError, match="no such compiler"):
        cuda_lib.ops()
    assert cuda_lib._ops is None and not cuda_lib.library_path().exists()
