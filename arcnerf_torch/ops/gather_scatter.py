"""Row gather, lane gather, row scatter-add and the lane-packed update-row
build: kernels G, H, I and J, their plain PyTorch versions and launch
counters.

Counterparts of the Pallas probe kernels of the TPU repo, which asked which
gather and scatter forms Mosaic lowers and how fast they run:
``row_gather`` (kernel G, ``csrc/row_gather.cu``) the row gathers of
``tools/roofline_hashgrid.py``, ``scripts/probe_pallas_gather.py`` and
``scripts/probe_pallas_gather2.py``; ``lane_gather`` (kernel H,
``csrc/lane_gather.cu``) their lane gathers and those of
``scripts/probe_scatter.py``; ``scatter_add_rows`` (kernel I,
``csrc/scatter_add_rows.cu``) ``case_scatter_ref``; ``build_update_rows``
(kernel J, ``csrc/update_rows.cu``) ``build_P`` of
``scripts/probe_cons_forms.py``. The tools in ``arcnerf_torch.tools`` time
them.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises. Indices are int32 and must be in range: the kernels do not check
them, and the wrappers do not read them back (that would synchronise).
"""

import ctypes

import torch

from . import cuda_lib

LANES = 128  # width of an update row (build_update_rows)


def row_gather_reference(table, idx):
    """Plain version: table (T, W) -> table[idx] (N, W)."""
    return table.index_select(0, idx)


def lane_gather_reference(src, idx):
    """Plain version: src (M, W), idx (M or 1, N) -> (M, N), out[m, j] =
    src[m, idx[m or 0, j]] (``take_along_axis`` on the last axis)."""
    return torch.gather(src, 1, idx.long().expand(src.shape[0], -1))


def scatter_add_rows_reference(out, idx, g):
    """Plain version: out[idx[n]] += g[n] for every n, repeats summed
    (``np.add.at``), in place; returns ``out``."""
    return out.index_add_(0, idx, g)


def build_update_rows_reference(lane0, vals, offs, n_feat):
    """Plain version: lane0 (K,) int, vals (K, len(offs) * n_feat) f32 ->
    (K, 128) f32 rows, out[k, l] = sum over (i, f) of [l == lane0[k] +
    offs[i] + f] * vals[k, i * n_feat + f], summed in (i, f) order from 0
    (the XLA form ``build_A`` of ``scripts/probe_cons_forms.py``)."""
    lanes = torch.arange(LANES, dtype=lane0.dtype, device=lane0.device)[None, :]
    out = torch.zeros((lane0.shape[0], LANES), dtype=torch.float32, device=lane0.device)
    for i, off in enumerate(offs):
        for f in range(n_feat):
            hit = lanes == (lane0 + (off + f))[:, None]
            out = out + torch.where(hit, vals[:, i * n_feat + f][:, None], 0.0)
    return out


def _require_aligned(name, *tensors):
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("{}: the kernel needs 16-byte aligned tensors".format(name))


def _require_index(name, idx, dims):
    cuda_lib.require_cuda(name, idx, dtype=torch.int32)
    if idx.dim() != dims:
        raise ValueError("{}: expected a {}-D index, got shape {}".format(name, dims, tuple(idx.shape)))


def row_gather(table, idx):
    """table (T, W) f32 or bf16, idx (N,) int32 in [0, T) -> (N, W) of the
    table's type. On CUDA, kernel G: a row must be a multiple of 16 bytes."""
    if table.device.type == "cpu":
        return row_gather_reference(table, idx)
    if table.dtype not in (torch.float32, torch.bfloat16) or table.dim() != 2:
        raise ValueError("row_gather: expected a 2-D f32 or bf16 table, got {} {}".format(
            table.dtype, tuple(table.shape)))
    cuda_lib.require_cuda("row_gather", table, dtype=table.dtype)
    _require_index("row_gather", idx, 1)
    row_bytes = table.shape[1] * table.element_size()
    if row_bytes % 16:
        raise ValueError("row_gather: kernel G moves 16-byte chunks; a row is {} bytes".format(row_bytes))
    out = torch.empty((idx.shape[0], table.shape[1]), dtype=table.dtype, device=table.device)
    _require_aligned("row_gather", table, out)
    if idx.shape[0] > 0 and table.shape[0] > 0:
        status = cuda_lib.lib().arcnerf_row_gather(table.data_ptr(), table.shape[0], row_bytes, idx.data_ptr(),
                                                   idx.shape[0], out.data_ptr(), cuda_lib.stream_handle(table.device))
        cuda_lib.check(status, "row_gather")
        row_gather.launches += 1
    return out


def lane_gather(src, idx):
    """src (M, W) f32, idx (M or 1, N) int32 in [0, W) -> (M, N) f32,
    out[m, j] = src[m, idx[m or 0, j]]; a single index row serves every row.
    On CUDA, kernel H."""
    if src.device.type == "cpu":
        return lane_gather_reference(src, idx)
    cuda_lib.require_cuda("lane_gather", src)
    _require_index("lane_gather", idx, 2)
    if src.dim() != 2 or idx.shape[0] not in (1, src.shape[0]):
        raise ValueError("lane_gather: src {} and idx {} do not match".format(tuple(src.shape), tuple(idx.shape)))
    m, n = src.shape[0], idx.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=src.device)
    if m > 0 and n > 0 and src.shape[1] > 0:
        stride = 0 if idx.shape[0] == 1 else n  # one index row serves every row
        status = cuda_lib.lib().arcnerf_lane_gather(src.data_ptr(), m, src.shape[1], idx.data_ptr(), stride, n,
                                                    out.data_ptr(), cuda_lib.stream_handle(src.device))
        cuda_lib.check(status, "lane_gather")
        lane_gather.launches += 1
    return out


def scatter_add_rows(out, idx, g):
    """out (T, W) f32, idx (N,) int32 in [0, T), g (N, W) f32: adds every
    g[n] into out[idx[n]], repeats summed, IN PLACE (no copy of the table);
    returns ``out``. On CUDA, kernel I (f32 atomics, so the order of each
    sum changes from run to run): W is 1 or a multiple of 4."""
    if out.device.type == "cpu":
        return scatter_add_rows_reference(out, idx, g)
    cuda_lib.require_cuda("scatter_add_rows", out, g)
    _require_index("scatter_add_rows", idx, 1)
    if out.dim() != 2 or g.shape != (idx.shape[0], out.shape[1]):
        raise ValueError("scatter_add_rows: out {}, idx {} and g {} do not match".format(
            tuple(out.shape), tuple(idx.shape), tuple(g.shape)))
    w = out.shape[1]
    if w != 1 and w % 4:
        raise ValueError("scatter_add_rows: kernel I takes rows of 1 or a multiple of 4 floats, not {}".format(w))
    if w > 1:
        _require_aligned("scatter_add_rows", out, g)
    if idx.shape[0] > 0 and out.shape[0] > 0:
        status = cuda_lib.lib().arcnerf_scatter_add_rows(out.data_ptr(), out.shape[0], w, idx.data_ptr(),
                                                         g.data_ptr(), idx.shape[0], cuda_lib.stream_handle(out.device))
        cuda_lib.check(status, "scatter_add_rows")
        scatter_add_rows.launches += 1
    return out


def build_update_rows(lane0, vals, offs, n_feat):
    """lane0 (K,) int32, vals (K, len(offs) * n_feat) f32 -> (K, 128) f32
    update rows (see ``build_update_rows_reference``). On CUDA, kernel J:
    at most 4 offsets and 8 terms."""
    if lane0.device.type == "cpu":
        return build_update_rows_reference(lane0, vals, offs, n_feat)
    _require_index("build_update_rows", lane0, 1)
    cuda_lib.require_cuda("build_update_rows", vals)
    n_off = len(offs)
    if not 1 <= n_off <= 4 or n_off * n_feat > 8 or vals.shape != (lane0.shape[0], n_off * n_feat):
        raise ValueError("build_update_rows: kernel J takes 1-4 offsets and at most 8 terms; got {} offsets, "
                         "n_feat {}, vals {}".format(n_off, n_feat, tuple(vals.shape)))
    out = torch.empty((lane0.shape[0], LANES), dtype=torch.float32, device=lane0.device)
    if lane0.shape[0] > 0:
        status = cuda_lib.lib().arcnerf_build_update_rows(
            lane0.data_ptr(), vals.data_ptr(), lane0.shape[0], (ctypes.c_int * n_off)(*[int(o) for o in offs]),
            n_off, n_feat, out.data_ptr(), cuda_lib.stream_handle(lane0.device))
        cuda_lib.check(status, "build_update_rows")
        build_update_rows.launches += 1
    return out


row_gather.launches = 0
lane_gather.launches = 0
scatter_add_rows.launches = 0
build_update_rows.launches = 0
