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

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
through the compiled binding (``cuda_lib.ops()``, which checks the tensors)
or raises. Indices are int32 and must be in range: the kernels do not check
them, and the wrappers do not read them back (that would synchronise).
"""

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


def row_gather(table, idx):
    """table (T, W) f32 or bf16, idx (N,) int32 in [0, T) -> (N, W) of the
    table's type. On CUDA, kernel G: a row must be a multiple of 16 bytes."""
    if table.is_cpu:
        return row_gather_reference(table, idx)
    out = cuda_lib.ops().row_gather(table, idx)
    if out.shape[0] > 0 and table.shape[0] > 0:
        row_gather.launches += 1
    return out


def lane_gather(src, idx):
    """src (M, W) f32, idx (M or 1, N) int32 in [0, W) -> (M, N) f32,
    out[m, j] = src[m, idx[m or 0, j]]; a single index row serves every row.
    On CUDA, kernel H."""
    if src.is_cpu:
        return lane_gather_reference(src, idx)
    out = cuda_lib.ops().lane_gather(src, idx)
    if out.numel() > 0 and src.shape[1] > 0:
        lane_gather.launches += 1
    return out


def scatter_add_rows(out, idx, g):
    """out (T, W) f32, idx (N,) int32 in [0, T), g (N, W) f32: adds every
    g[n] into out[idx[n]], repeats summed, IN PLACE (no copy of the table);
    returns ``out``. On CUDA, kernel I (f32 atomics, so the order of each
    sum changes from run to run): W is 1 or a multiple of 4."""
    if out.is_cpu:
        return scatter_add_rows_reference(out, idx, g)
    cuda_lib.ops().scatter_add_rows(out, idx, g)
    if idx.shape[0] > 0 and out.shape[0] > 0:
        scatter_add_rows.launches += 1
    return out


def build_update_rows(lane0, vals, offs, n_feat):
    """lane0 (K,) int32, vals (K, len(offs) * n_feat) f32 -> (K, 128) f32
    update rows (see ``build_update_rows_reference``). On CUDA, kernel J:
    at most 4 offsets and 8 terms."""
    if lane0.is_cpu:
        return build_update_rows_reference(lane0, vals, offs, n_feat)
    out = cuda_lib.ops().build_update_rows(lane0, vals, offs, n_feat)
    if out.shape[0] > 0:
        build_update_rows.launches += 1
    return out


row_gather.launches = 0
lane_gather.launches = 0
scatter_add_rows.launches = 0
build_update_rows.launches = 0
