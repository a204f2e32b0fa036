"""arcnerf_torch sampling, compaction and compositing vs the JAX package on
the same numpy inputs (CPU): ray generation, the volume near/far, the
fixed-step ladder with its occupancy mask, stream compaction and
segment_march. Each comparison states its tolerance and why."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.geometry.volume import Volume as JaxVolume
from arcnerf_tpu.models.base_modules.obj_bound import _cap_pts_per_ray as jax_cap
from arcnerf_tpu.models.base_modules.obj_bound import _occ_mask_soa as jax_occ_mask
from arcnerf_tpu.models.fg_model import FgModel as JaxFgModel
from arcnerf_tpu.render.ray_helper import get_rays as jax_get_rays
from arcnerf_tpu.render.ray_helper import get_zvals_from_near_far_fix_step as jax_fix_step
from arcnerf_tpu.render.ray_helper import segment_march as jax_segment_march
from arcnerf_torch.geometry.volume import Volume
from arcnerf_torch.models.base_modules.obj_bound import _cap_pts_per_ray, _occ_mask_soa
from arcnerf_torch.models.fg_model import FgModel
from arcnerf_torch.render.ray_helper import get_rays, get_zvals_from_near_far_fix_step, segment_march

torch.set_num_threads(1)

N_GRID, N_SAMPLE, N_RAYS = 16, 64, 256


def _rays(seed=0, n=N_RAYS):
    """Rays from a sphere of radius 2.5 aimed near the volume center."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = 2.5 * o / np.linalg.norm(o, axis=-1, keepdims=True)
    d = rng.uniform(-0.6, 0.6, size=(n, 3)) - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _bitfield(seed=1):
    return np.random.default_rng(seed).random((N_GRID,) * 3) < 0.3


@pytest.mark.parametrize("center_pixel,wh_order", [(True, False), (False, True)])
def test_get_rays_matches_jax(center_pixel, wh_order):
    # 1e-6: the same f32 pixel -> camera -> world chain, term by term
    intr = np.array([[38.4, 0.0, 16.0], [0.0, 38.4, 12.0], [0.0, 0.0, 1.0]], np.float32)
    c2w = np.array([[0.8, 0.36, -0.48, 1.2], [0.0, 0.8, 0.6, 1.5], [0.6, -0.48, 0.64, -1.6], [0, 0, 0, 1]], np.float32)
    want = jax_get_rays(32, 24, jnp.asarray(intr), jnp.asarray(c2w), wh_order=wh_order, center_pixel=center_pixel)
    got = get_rays(32, 24, torch.from_numpy(intr), torch.from_numpy(c2w), wh_order=wh_order,
                   center_pixel=center_pixel)
    for w, g in zip((want[0], want[1], want[3]), (got[0], got[1], got[3])):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


def test_ray_volume_intersection_matches_jax():
    # 1e-6: the same f32 slab test
    o, d = _rays()
    want = JaxVolume(n_grid=N_GRID, side=2.0).ray_volume_intersection(jnp.asarray(o), jnp.asarray(d))
    got = Volume(n_grid=N_GRID, side=2.0).ray_volume_intersection(torch.from_numpy(o), torch.from_numpy(d))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cap", [None, 8])
def test_fix_step_ladder_and_occupancy_mask_match_jax(cap):
    # zvals 1e-6 (same f32 ladder); masks exact (same voxel indices)
    o, d = _rays()
    jvol, vol = JaxVolume(n_grid=N_GRID, side=2.0), Volume(n_grid=N_GRID, side=2.0)
    near, far, _, _ = jvol.ray_volume_intersection(jnp.asarray(o), jnp.asarray(d))
    fix_t = jvol.get_diag_len() / N_SAMPLE
    bitfield = _bitfield()

    jz, jm = jax_fix_step(near, far, fix_t, N_SAMPLE)
    jm = jax_cap(jm & jax_occ_mask(jvol, jnp.asarray(bitfield), jnp.asarray(o), jnp.asarray(d), jz), True, cap)

    tz, tm = get_zvals_from_near_far_fix_step(torch.tensor(np.asarray(near)), torch.tensor(np.asarray(far)),
                                              fix_t, N_SAMPLE)
    tm = _cap_pts_per_ray(tm & _occ_mask_soa(vol, torch.from_numpy(bitfield), torch.from_numpy(o),
                                             torch.from_numpy(d), tz), True, cap)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert 0 < tm.sum() < tm.numel()


@pytest.mark.parametrize("budget", [1 << 12, 1 << 13])
def test_compact_sel_aux_matches_jax_rowgather(budget):
    # exact: sel on the valid prefix, off and cnt (integer bookkeeping);
    # 2^12 clips the stream (~4.9k valid samples), 2^13 does not
    mask = np.random.default_rng(2).random((N_RAYS, N_SAMPLE)) < 0.3
    mask[::7] = False  # rays with no sample
    sel_j, valid_j, off_j, cnt_j = JaxFgModel._compact_sel_aux(jnp.asarray(mask), budget)
    sel_t, valid_t, off_t, cnt_t = FgModel._compact_sel_aux(torch.from_numpy(mask), budget)
    n_valid = int(np.asarray(valid_j).sum())
    assert n_valid == int(valid_t.sum()) == min(budget, int(mask.sum()))
    np.testing.assert_array_equal(sel_t.numpy()[:n_valid], np.asarray(sel_j)[:n_valid])
    np.testing.assert_array_equal(off_t.numpy(), np.asarray(off_j))
    np.testing.assert_array_equal(cnt_t.numpy(), np.asarray(cnt_j))


def _stream(budget, seed=3):
    """A compacted stream as the model builds it: ladder zvals masked by
    occupancy, compacted to ``budget`` rows (padding rows carry whatever
    ray the compaction leaves there)."""
    o, d = _rays(seed)
    vol = JaxVolume(n_grid=N_GRID, side=2.0)
    near, far, _, _ = vol.ray_volume_intersection(jnp.asarray(o), jnp.asarray(d))
    z, m = jax_fix_step(near, far, vol.get_diag_len() / N_SAMPLE, N_SAMPLE)
    m = m & jax_occ_mask(vol, jnp.asarray(_bitfield(seed)), jnp.asarray(o), jnp.asarray(d), z)
    sel, _, off, cnt = JaxFgModel._compact_sel_aux(m, budget)
    rng = np.random.default_rng(seed)
    sigma = (rng.normal(size=budget) * 30).astype(np.float32)
    rgb = rng.random((budget, 3)).astype(np.float32)
    z_sel = np.asarray(z).reshape(-1)[np.asarray(sel)]
    ray_id = np.asarray(sel) // N_SAMPLE
    # gaps below the 1e-5 crush and just above it, inside rays (still ascending)
    for k in range(0, budget - 2, 7):
        if ray_id[k] == ray_id[k + 1] == ray_id[k + 2]:
            z_sel[k + 1] = z_sel[k] + 5e-6
            z_sel[k + 2] = z_sel[k + 1] + 5e-4
    return sigma, rgb, z_sel, ray_id, np.asarray(off), np.asarray(cnt)


@pytest.mark.parametrize("budget,add_inf_z,bkg", [
    (1 << 11, False, None), (1 << 11, True, "white"), (1 << 12, False, "color"), (1 << 12, True, "color")])
def test_segment_march_matches_jax(budget, add_inf_z, bkg):
    sigma, rgb, z, ray_id, off, cnt = _stream(budget)
    assert budget > 1 << 11 or cnt.sum() == budget  # the 2^11 stream is budget-clipped
    color = np.random.default_rng(9).random((N_RAYS, 3)).astype(np.float32) if bkg == "color" else None
    march = jax.jit(jax_segment_march, static_argnames=("n_rays", "add_inf_z", "white_bkg"))
    want = march(jnp.asarray(sigma), jnp.asarray(rgb), jnp.asarray(z), jnp.asarray(ray_id), jnp.asarray(off),
                 jnp.asarray(cnt), n_rays=N_RAYS, add_inf_z=add_inf_z, white_bkg=bkg == "white",
                 bkg_color=None if color is None else jnp.asarray(color))

    def port(dtype):
        return segment_march(torch.tensor(sigma, dtype=dtype), torch.tensor(rgb, dtype=dtype),
                             torch.tensor(z, dtype=dtype), torch.tensor(off).long(), torch.tensor(cnt).long(),
                             add_inf_z=add_inf_z, white_bkg=bkg == "white",
                             bkg_color=None if color is None else torch.from_numpy(color).to(dtype))

    got, exact = port(torch.float32), port(torch.float64)
    for k in ("rgb", "depth", "mask", "trans_end"):
        # the port multiplies and sums sequentially per ray: within 1e-6 of
        # the same sums in float64
        np.testing.assert_allclose(got[k].numpy(), exact[k].numpy(), atol=1e-6, rtol=0, err_msg=k)
        # JAX takes each ray's sum as a difference of one stream-wide f32
        # cumsum, so its error grows with the stream's running total:
        # atol 1e-5 plus two f32 ulps of that total (trans_end is per-ray)
        total = 0.0 if k == "trans_end" else float(np.abs(exact[k].numpy()).sum())
        atol = 1e-5 + 2 * np.finfo(np.float32).eps * total
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=atol, rtol=0, err_msg=k)
