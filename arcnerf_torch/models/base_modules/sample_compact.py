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
``_compact_sel_aux`` (``models/fg_model.py``). The ladder is the bound's
(``obj_bound.occupied_ladder``, the kernel's step ``obj_bound.ladder_step``).

Two phases, so that the model's spans keep their meaning: ``sample_count``
(the kernel's count and scan; the plain version: the ladder, its masks and
the compaction's indices) and ``sample_write`` (the kernel's write; the
plain version: the gathers). A CPU tensor takes the plain version
(``sample_count_reference``), which composes the program's own functions;
a CUDA tensor launches the kernel or raises. Both give the same stream bit
for bit: the kernel rounds as PyTorch's CUDA operators do. The jitter is fed as drawn uniforms
(``rand``, (rays, n_pts)), the one draw the plain path makes.

With ``offset`` (the window mode of the windowed tier's passes, at
inference under a cap) the stream holds each ray's valid samples of rank in
(offset, offset + cap], ``_cap_pts_per_ray`` with its offset, and each ray
with a sample in the stream its ``tail``: the z of its next valid sample
after the last one in the stream (past the window, or a window sample the
budget dropped), +inf where there is none. Kernel C's tail mode marches the
last sample up to it, as the dense march on the pre-cap mask does
(``scattered_deltas``), so consecutive windows telescope.

With ``sections`` the stream holds an SDF's sections in place of the
samples (JAX ``Neus.handle_mid_pts`` on left-compacted rows, the model's
``sdf_sections`` here): a ray with c valid samples z_0 < ... < z_(c-1)
gets min(c + 1, n_pts) sections, section j < c - 1 from z_j to z_(j+1),
section c - 1 from z_(c-1) to z_(c-1) + 2 sd with sd = (z_(c-1) - z_0) /
n_pts / 2, and section c of zero length there; a ray with no sample gets
none. Each row holds the section's mid point (``z``, ``pts``) and its
length (``len``), and the point budget applies to sections.
"""

import numpy as np
import torch

from ...ops import cuda_lib
from .obj_bound import _cap_pts_per_ray, ladder_step, occupied_ladder


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


def sdf_sections(zvals, mask, n_sample):
    """An SDF's sections on the (B, N) grid of samples ``zvals`` whose valid
    ones ``mask`` marks in ladder order: JAX ``Neus.handle_mid_pts`` on the
    left-compacted rows (``handle_valid_mask_zvals``: the valid z first,
    the tail repeating the last). Returns the sections' mid z, lengths and
    mask, each (B, N): section j < c - 1 spans two valid samples, section
    c - 1 reaches z_(c-1) + 2 sd (sd = (z_(c-1) - z_0) / n_sample / 2),
    section c has length 0 there; a ray with no sample has none (the JAX
    mask keeps its first, whose ray renders the background). sd divides by
    n_sample as a multiply by its f32 reciprocal: within an ulp of the JAX
    division, and the same on the CPU and the card."""
    n_rays, n_pts = zvals.shape
    c = mask.sum(1, keepdim=True)
    order = torch.argsort((~mask).to(torch.int8), dim=1, stable=True)
    zc = zvals.gather(1, order)
    pos = torch.arange(n_pts, device=zvals.device)[None]
    zc = torch.where(pos < c, zc, zc.gather(1, (c - 1).clamp_min(0)))
    # a multiply by the f32 reciprocal, as PyTorch divides a CUDA tensor by a Python number (the kernel repeats it)
    sample_dist = (zc[:, -1] - zc[:, 0]) * (1.0 / n_sample) * 0.5
    final = zc[:, -1] + sample_dist * 2.0
    ext = torch.cat([zc, zc[:, -1:]], 1)
    ext = torch.where(torch.cat([pos < c, torch.zeros_like(c, dtype=torch.bool)], 1), ext, final[:, None])
    mid = 0.5 * (ext[:, 1:] + ext[:, :-1])
    return mid, ext[:, 1:] - ext[:, :-1], (pos <= c) & (c > 0)


def window_tail(zvals, mask_pre, offset, cnt):
    """(B,): the z of each ray's valid sample (``mask_pre``, before the cap)
    of rank ``offset + cnt + 1``, the next after the last of its window in
    the stream, where cnt > 0 and it exists; else +inf."""
    rank = torch.cumsum(mask_pre.to(torch.int64), dim=1)
    at = mask_pre & (rank == (offset + cnt + 1)[:, None]) & (cnt > 0)[:, None]
    return torch.where(at, zvals, torch.inf).amin(dim=1)


def sample_count_reference(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None, sections=False,
                           offset=None):
    """Plain version of ``sample_count`` (on any device): near/far from the
    volume's box, the fix-step ladder with its jitter, the occupancy and
    cap masks on the (B, n_pts) grid (with ``sections``, then the SDF's
    sections on it; with ``offset``, the window's mask and its tails), and
    the compaction's indices, which ``sample_write`` gathers."""
    near, far, _, hit = volume.ray_volume_intersection(rays_o, rays_d)
    zvals, pre = occupied_ladder(volume, bitfield, rays_o, rays_d, near, far, n_pts, rand=rand)
    mask = _cap_pts_per_ray(pre, True, cap, offset=offset)
    plan = {"rays_o": rays_o, "rays_d": rays_d, "budget": int(budget), "ray_has": hit[:, 0] & mask.any(dim=1),
            "zvals": zvals}
    if sections:
        plan["first_z"] = zvals[0, 0]
        zvals, plan["len_grid"], mask = sdf_sections(zvals, mask, n_pts)
        plan["zvals"] = zvals
    sel, _, off, cnt = compact_sel_aux(mask, int(budget))
    if offset is not None:
        plan["n_win"] = mask.sum(dim=1, dtype=torch.int32)
        plan["tail"] = window_tail(zvals, pre, int(offset), cnt)
    return dict(plan, off=off, cnt=cnt, n_valid=mask.sum(), sel=sel)


def sample_count(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None, sections=False, offset=None):
    """The count phase over rays_o, rays_d (B, 3) on the ``volume``'s
    fix-step ladder of ``n_pts`` slots between the ray's near and far in
    its box, culled by the ``bitfield``: the first ``cap`` valid samples a
    ray when ``cap`` is set, ``rand`` (B, n_pts) jitter draws or None, into
    a stream of ``budget`` rows. Returns the plan: off, cnt (B,) int64 (as
    ``compact_sel_aux``), n_valid () int64 (every valid sample, before the
    budget), ray_has (B,) bool (the ray hits the box and keeps a sample:
    the rays that render), and what ``sample_write`` reads. With
    ``sections`` the stream holds an SDF's sections, and off, cnt and
    n_valid count sections. With ``offset`` (an int; it takes a cap, and
    samples) they count the window's samples, of rank in (offset, offset +
    cap], and the plan also holds n_win (B,) int32, each ray's."""
    if offset is not None and not (cap and not sections):
        raise ValueError("sample_count: a window (offset {}) takes a cap, and samples".format(offset))
    if rays_o.is_cpu:
        return sample_count_reference(volume, bitfield, rays_o, rays_d, n_pts, budget, cap, rand, sections, offset)
    box, inv = _grid(volume)
    args = {"rays_o": rays_o.contiguous(), "rays_d": rays_d.contiguous(), "bitfield": bitfield.contiguous(),
            "rand": rand, "n_pts": int(n_pts), "fix_t": ladder_step(volume, n_pts), "box": box, "inv_voxel": inv}
    count_args = dict(sections=True) if sections else {}
    if offset is not None:
        count_args["offset"] = int(offset)
    off, cnt, n_valid, ray_has, near_far, clamp, first_z, tot = cuda_lib.ops().sample_count(
        **args, cap=int(cap or 0), budget=int(budget), **count_args)
    sample_count.launches += 1
    plan = {"budget": int(budget), "off": off, "cnt": cnt, "n_valid": n_valid, "ray_has": ray_has, "args": args,
            "near_far": near_far, "clamp": clamp, "first_z": first_z, "sections": bool(sections), "cap": int(cap or 0)}
    if offset is not None:
        plan.update(n_win=tot, offset=int(offset))
    return plan


def sample_write(plan):
    """The write phase: the plan of ``sample_count`` -> {z (budget,), pts,
    dirs (budget, 3), off, cnt}: the valid samples in ray-major ladder
    order, then rows that repeat ray 0's first sample. A plan of sections
    also gives ``len`` (budget,), each section's length, 0 in the rows
    past them; a window's plan ``tail`` (B,), each ray's tail z."""
    out = {"off": plan["off"], "cnt": plan["cnt"]}
    if "sel" in plan:
        out["z"], out["pts"], out["dirs"] = gather_stream(plan["sel"], plan["zvals"], plan["rays_o"], plan["rays_d"])
        if "len_grid" in plan:
            out["len"] = plan["len_grid"].reshape(-1)[plan["sel"]]
            _pad_sections(out, plan)
        if "tail" in plan:
            out["tail"] = plan["tail"]
    else:
        write_args = dict(sections=True, cap=plan["cap"]) if plan["sections"] else {}
        if "offset" in plan:
            write_args.update(cap=plan["cap"], offset=plan["offset"])
        z, pts, dirs, length, tail = cuda_lib.ops().sample_write(**plan["args"], near_far=plan["near_far"],
                                                                 clamp=plan["clamp"], first_z=plan["first_z"],
                                                                 off=plan["off"], cnt=plan["cnt"],
                                                                 n_valid=plan["n_valid"], budget=plan["budget"],
                                                                 **write_args)
        sample_write.launches += 1
        out.update(z=z, pts=pts, dirs=dirs)
        if length is not None:
            out["len"] = length
        if tail is not None:
            out["tail"] = tail
    return out


def _pad_sections(out, plan):
    """The rows past the sections as the kernel writes them: ray 0's first
    ladder sample, length 0."""
    pad = torch.arange(plan["budget"], device=out["z"].device) >= plan["n_valid"].clamp_max(plan["budget"])
    z0 = plan["first_z"].expand(out["z"].shape)
    out["z"] = torch.where(pad, z0, out["z"])
    out["pts"] = torch.where(pad[:, None], plan["rays_o"][0] + z0[:, None] * plan["rays_d"][0], out["pts"])
    out["dirs"] = torch.where(pad[:, None], plan["rays_d"][0], out["dirs"])
    out["len"] = torch.where(pad, 0.0, out["len"])


def sample_compact(volume, bitfield, rays_o, rays_d, n_pts, budget, cap=None, rand=None, count=sample_count,
                   sections=False, offset=None):
    """Both phases: the stream of ``sample_write`` plus n_valid and
    ray_has (and with ``offset`` the window's n_win).
    ``count=sample_count_reference`` takes the plain version on any
    device."""
    plan = count(volume, bitfield, rays_o, rays_d, n_pts, budget, cap, rand, sections, offset)
    out = dict(sample_write(plan), n_valid=plan["n_valid"], ray_has=plan["ray_has"])
    if offset is not None:
        out["n_win"] = plan["n_win"]
    return out


sample_count.launches = 0
sample_write.launches = 0
