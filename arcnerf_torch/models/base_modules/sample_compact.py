"""The sampler and its compaction in one: rays in, the compacted sample
stream out (``csrc/sample_compact.cu`` on the card).

It takes the place of ``VolumeBound``'s near/far and sampler on the fix-step
occupancy ladder (the box intersection, the ladder, its duplicate tail, the
training jitter, the occupancy test, the inference cap),
``compact_sel_aux`` and the point, direction and z gathers of
``FgModel.fused_render_by_mask_pts``, without the (rays, n_pts) grid they
build. Counterparts in the JAX package:
``_occ_mask_soa`` (``models/base_modules/obj_bound.py``),
``get_zvals_from_near_far_fix_step`` (``render/ray_helper.py``) and
``_compact_sel_aux`` (``models/fg_model.py``).

Two phases, so that the model's spans keep their meaning: ``sample_count``
(the kernel's count and scan; the plain version: the ladder, its masks and
the compaction's indices) and ``sample_write`` (the kernel's write; the
plain version: the gathers). A CPU tensor takes the plain version
(``sample_count_reference``), which composes the program's own functions;
a CUDA tensor launches the kernel or raises. Both give the same stream bit
for bit: the kernel rounds as PyTorch's CUDA operators do. The jitter is fed as drawn uniforms
(``rand``, (rays, n_pts)), the one draw the plain path makes.
"""

import numpy as np
import torch

from ...ops import cuda_lib
from ...render.ray_helper import get_zvals_from_near_far_fix_step
from .obj_bound import _cap_pts_per_ray, _occ_mask_soa


def compact_sel_aux(mask_pts, budget):
    """Flat indices of the first ``budget`` valid samples in ray-major
    order, plus the segment geometry of that stream: ``off`` (B,)
    unclipped exclusive start rank per ray and ``cnt`` (B,) in-stream
    count (clipped to the budget). Returns (sel, sel_valid, off, cnt).
    Same ``sel`` as the JAX row-gather form on the valid prefix; padding
    rows carry index 0 (consumers bound reads by off/cnt or sel_valid)."""
    n_rays, n_pts = mask_pts.shape
    total = n_rays * n_pts
    row = torch.cumsum(mask_pts.to(torch.int64), dim=1)  # (B, N) inclusive
    tot = row[:, -1]
    off = torch.cumsum(tot, dim=0) - tot
    # each valid slot lands at its global rank; the rest at a dump row
    rank = (row + off[:, None] - 1).reshape(-1)
    rank = torch.where(mask_pts.reshape(-1) & (rank < budget), rank, budget)
    sel = torch.zeros(budget + 1, dtype=torch.int64, device=mask_pts.device)
    sel = sel.scatter_(0, rank, torch.arange(total, device=mask_pts.device))[:budget]
    sel_valid = torch.arange(budget, device=mask_pts.device) < tot.sum()
    cnt = torch.minimum((budget - off).clamp_min(0), tot)
    return sel, sel_valid, off, cnt


def gather_stream(sel, zvals, rays_o, rays_d):
    """The stream's z (K,), points and directions (K, 3) at the flat grid
    indices ``sel`` of the (B, n_pts) ``zvals``."""
    ray_id = sel // zvals.shape[1]
    z = zvals.reshape(-1)[sel]
    dirs = rays_d[ray_id]
    return z, rays_o[ray_id] + z[:, None] * dirs, dirs


_GRIDS = {}  # the kernel's constants of a volume's geometry, made once


def _grid(volume):
    """(box, inv_voxel): the volume's lower corner then its upper corner, and
    the reciprocal voxel sizes, as f32 values; the reciprocal is rounded as
    PyTorch rounds the one it multiplies by when a CUDA tensor is divided
    by a Python number (``Volume.get_flat_voxel_idx_from_coords``)."""
    key = (volume.origin.tobytes(), volume.xyz_len.tobytes(), volume.get_n_grid())
    if key not in _GRIDS:
        box = [float(v) for v in volume.get_range_np().T.reshape(-1)]
        inv = [float(np.float32(1.0) / np.float32(v)) for v in volume.get_voxel_size()]
        _GRIDS[key] = box, inv
    return _GRIDS[key]


def sample_count_reference(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None):
    """Plain version of ``sample_count`` (on any device): near/far from the
    volume's box, the fix-step ladder with its jitter, the occupancy and
    cap masks on the (B, n_pts) grid, and the compaction's indices, which
    ``sample_write`` gathers."""
    near, far, _, hit = volume.ray_volume_intersection(rays_o, rays_d)
    zvals, mask = get_zvals_from_near_far_fix_step(near, far, volume.get_diag_len() / n_pts, n_pts, rand=rand)
    mask = _cap_pts_per_ray(mask & _occ_mask_soa(volume, bitfield, rays_o, rays_d, zvals), True, cap)
    sel, _, off, cnt = compact_sel_aux(mask, int(budget))
    return {"rays_o": rays_o, "rays_d": rays_d, "budget": int(budget), "off": off, "cnt": cnt,
            "n_valid": mask.sum(), "ray_has": hit[:, 0] & mask.any(dim=1), "sel": sel, "zvals": zvals}


def sample_count(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None):
    """The count phase over rays_o, rays_d (B, 3) on the ``volume``'s
    fix-step ladder of ``n_pts`` slots between the ray's near and far in
    its box, culled by the ``bitfield``: the first ``cap`` valid samples a
    ray when ``cap`` is set, ``rand`` (B, n_pts) jitter draws or None, into
    a stream of ``budget`` rows. Returns the plan: off, cnt (B,) int64 (as
    ``compact_sel_aux``), n_valid () int64 (every valid sample, before the
    budget), ray_has (B,) bool (the ray hits the box and keeps a sample:
    the rays that render), and what ``sample_write`` reads."""
    if rays_o.is_cpu:
        return sample_count_reference(volume, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    box, inv = _grid(volume)
    args = {"rays_o": rays_o.contiguous(), "rays_d": rays_d.contiguous(), "bitfield": bitfield.contiguous(),
            "rand": rand, "n_pts": int(n_pts), "fix_t": volume.get_diag_len() / n_pts, "box": box, "inv_voxel": inv}
    off, cnt, n_valid, ray_has, near_far, clamp, first_z = cuda_lib.ops().sample_count(**args, cap=int(cap or 0),
                                                                                       budget=int(budget))
    sample_count.launches += 1
    return {"budget": int(budget), "off": off, "cnt": cnt, "n_valid": n_valid, "ray_has": ray_has, "args": args,
            "near_far": near_far, "clamp": clamp, "first_z": first_z}


def sample_write(plan):
    """The write phase: the plan of ``sample_count`` -> {z (budget,), pts,
    dirs (budget, 3), off, cnt}: the valid samples in ray-major ladder
    order, then rows that repeat ray 0's first sample."""
    if "sel" in plan:
        z, pts, dirs = gather_stream(plan["sel"], plan["zvals"], plan["rays_o"], plan["rays_d"])
    else:
        z, pts, dirs = cuda_lib.ops().sample_write(**plan["args"], near_far=plan["near_far"], clamp=plan["clamp"],
                                                   first_z=plan["first_z"], off=plan["off"], cnt=plan["cnt"],
                                                   n_valid=plan["n_valid"], budget=plan["budget"])
        sample_write.launches += 1
    return {"z": z, "pts": pts, "dirs": dirs, "off": plan["off"], "cnt": plan["cnt"]}


def sample_compact(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None, count=sample_count):
    """Both phases: the stream of ``sample_write`` plus n_valid and
    ray_has. ``count=sample_count_reference`` takes the plain version on
    any device."""
    plan = count(volume, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    return dict(sample_write(plan), n_valid=plan["n_valid"], ray_has=plan["ray_has"])


sample_count.launches = 0
sample_write.launches = 0
