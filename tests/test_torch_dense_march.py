"""The port's dense compositing on the (rays, samples) grid vs the JAX
package (CPU): ``scattered_deltas``, ``alpha_to_weights`` and
``ray_marching`` on the same seeded inputs, then the model's dense path
(``get_sigma_radiance_by_mask_pts`` in both branches, ``_forward`` without
a point budget, the ``get_progress`` outputs) at the small size of
``test_torch_slice.py`` on bridged params and the spheres' bitfield."""

import contextlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.render import ray_helper as jax_ray_helper
from arcnerf_torch.models import build_model
from arcnerf_torch.render import ray_helper
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import state_from_jax
from tests.test_torch_slice import (CFG, DEPTH_MAX, RGB_MAX, RGB_MEAN, SMALL, assert_slice_close,
                                    jax_model_and_params, sphere_bound_state, view_rays)

torch.set_num_threads(1)
MARCH_TOL = 1e-5  # f32 sums in the same order; the JAX cumsum of logs as the port's


def march_inputs(seed=0, n_rays=64, n_pts=48):
    """Ascending ladder zvals with a duplicated far tail, a scattered mask,
    sigma with zeros and large values, radiance in [0, 1]."""
    rng = np.random.default_rng(seed)
    near = rng.uniform(0.5, 1.5, (n_rays, 1))
    z = near + np.cumsum(rng.uniform(0.0, 0.05, (n_rays, n_pts)), 1)
    z[:, -4:] = z[:, -5:-4]  # the clamp at far duplicates the tail
    mask = rng.uniform(size=(n_rays, n_pts)) < 0.4
    mask[:, -4:] = False
    mask[:3] = False  # rays with no valid sample
    sigma = rng.exponential(8.0, (n_rays, n_pts)) * (rng.uniform(size=(n_rays, n_pts)) < 0.8)
    radiance = rng.uniform(size=(n_rays, n_pts, 3))
    return [a.astype(np.float32) if a.dtype != bool else a for a in (z, mask, sigma, radiance)]


def close(got, want, tol=MARCH_TOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("inf_tail", [False, True])
def test_scattered_deltas_matches_jax(inf_tail):
    z, mask, _, _ = march_inputs()
    close(ray_helper.scattered_deltas(torch.from_numpy(z), torch.from_numpy(mask), inf_tail),
          jax_ray_helper.scattered_deltas(jnp.asarray(z), jnp.asarray(mask), inf_tail))


@pytest.mark.parametrize("add_inf_z", [False, True])
@pytest.mark.parametrize("offset", [0, 4, 12])
@pytest.mark.parametrize("budget", [None, 98])
def test_segment_march_tail_equals_the_dense_window_march(add_inf_z, offset, budget):
    # a window of the windowed tier, two ways: the dense march of the grid
    # (sigma 0 outside the window's samples in the stream, deltas on the
    # pre-cap mask) and the compacted stream with each ray's tail (kernel
    # C's tail mode); a 98-row budget clips a ray mid-window, whose last
    # sample in the stream then marches to its first dropped one
    from arcnerf_torch.models.base_modules.obj_bound import _cap_pts_per_ray
    from arcnerf_torch.models.base_modules.sample_compact import compact_sel_aux, window_tail

    z, pre, sigma, radiance = (torch.from_numpy(a) for a in march_inputs(seed=5))
    n_rays, n_pts = z.shape
    mask = _cap_pts_per_ray(pre, True, 4, offset=offset)
    sel, sel_valid, off, cnt = compact_sel_aux(mask, budget or n_rays * n_pts)
    assert (budget is not None) == bool(((cnt > 0) & (cnt < mask.sum(1))).any())
    kept = torch.zeros(n_rays * n_pts, dtype=torch.bool)
    kept[sel[sel_valid]] = True
    kept = kept.reshape(n_rays, n_pts)
    want = ray_helper.ray_marching(torch.where(kept, sigma, 0.0), radiance, z, add_inf_z, mask_pts=pre)
    tail = window_tail(z, pre, offset, cnt)
    assert bool(torch.isfinite(tail).any()) and bool(torch.isinf(tail).any())
    got = ray_helper.segment_march_reference(sigma.reshape(-1)[sel], radiance.reshape(-1, 3)[sel], z.reshape(-1)[sel],
                                             off, cnt, add_inf_z, tail=tail)
    for k in ("rgb", "depth", "mask"):
        close(got[k], want[k])
    # without the tail a window's last sample would take the tail rule
    plain = ray_helper.segment_march_reference(sigma.reshape(-1)[sel], radiance.reshape(-1, 3)[sel],
                                               z.reshape(-1)[sel], off, cnt, add_inf_z)
    assert float((plain["mask"] - want["mask"]).abs().max()) > 1e-3


def test_alpha_to_weights_matches_jax():
    alpha = np.random.default_rng(1).uniform(size=(64, 48)).astype(np.float32)
    alpha[:, 5] = 1.0  # a saturated sample: the log's clamp
    for got, want in zip(ray_helper.alpha_to_weights(torch.from_numpy(alpha)),
                         jax_ray_helper.alpha_to_weights(jnp.asarray(alpha))):
        close(got, want)


@pytest.mark.parametrize("masked,add_inf_z,bkg,white", [
    (True, False, None, False),
    (True, True, None, False),
    (True, False, (0.2, 0.5, 0.9), False),
    (True, True, None, True),
    (False, False, None, False),
    (False, True, (1.0, 1.0, 1.0), False),
    (False, False, None, True),
])
def test_ray_marching_matches_jax(masked, add_inf_z, bkg, white):
    z, mask, sigma, radiance = march_inputs(seed=2)
    bkg_np = None if bkg is None else np.asarray(bkg, np.float32)
    got = ray_helper.ray_marching(torch.from_numpy(sigma), torch.from_numpy(radiance), torch.from_numpy(z), add_inf_z,
                                  white_bkg=white, bkg_color=None if bkg is None else torch.from_numpy(bkg_np),
                                  mask_pts=torch.from_numpy(mask) if masked else None)
    want = jax_ray_helper.ray_marching(jnp.asarray(sigma), jnp.asarray(radiance), jnp.asarray(z), add_inf_z,
                                       white_bkg=white, bkg_color=None if bkg is None else jnp.asarray(bkg_np),
                                       mask_pts=jnp.asarray(mask) if masked else None)
    assert sorted(got) == sorted(want)
    for k in got:
        # depth sums z up to ~3 and weights, so its tolerance is relative
        close(got[k], want[k], MARCH_TOL * (4 if k == "depth" else 1))
    assert float(got["mask"].max()) > 0.9  # some rays saturate


@pytest.fixture(scope="module")
def models():
    """The JAX model and params at the small size, and the port's model on
    the same weights; rays of a 16x16 view; the spheres' bitfield."""
    cfgs_j, model_j, params = jax_model_and_params(SMALL)
    cfgs = update_configs_by_dotlist(load_configs(CFG), list(SMALL))
    model = build_model(cfgs)
    bound_np = sphere_bound_state()
    state, bound = state_from_jax(jax.tree_util.tree_map(np.asarray, params), bound_np)
    model.load_state_dict(state)
    return model_j, params, jax.tree_util.tree_map(jnp.asarray, bound_np), model, bound, view_rays()


def grid_inputs(model, bound, ro, rd):
    """zvals and the occupancy mask the sampler gives at inference."""
    fg = model.fg_model
    ro_t, rd_t = torch.from_numpy(ro), torch.from_numpy(rd)
    near, far, _ = fg.get_near_far_from_rays({"rays_o": ro_t, "rays_d": rd_t}, bound["fg"])
    zvals, mask = fg.obj_bound.get_zvals_from_near_far(bound["fg"], near, far, fg.get_ray_cfgs("n_sample"), True,
                                                       rays_o=ro_t, rays_d=rd_t, keep_order=True)
    return zvals, mask


@contextlib.contextmanager
def obj_bound_cfgs(models, **values):
    """Set obj_bound cfg values on both models inside the block (the port's
    bound re-reads them)."""
    model_j, model = models[0], models[3]
    nodes = [model.fg_model.cfgs.model.obj_bound, model_j.cfgs.model.obj_bound]
    saved = [{k: getattr(node, k, None) for k in values} for node in nodes]
    for node in nodes:
        for k, v in values.items():
            setattr(node, k, v)
    model.fg_model.obj_bound.refresh_optim_cfgs()
    try:
        yield
    finally:
        for node, old in zip(nodes, saved):
            for k, v in old.items():
                setattr(node, k, v)
        model.fg_model.obj_bound.refresh_optim_cfgs()


@pytest.mark.parametrize("budget_log", [12, 16])  # compacted (a budget below B*N) and every sample
def test_sigma_radiance_by_mask_pts_matches_jax(models, budget_log):
    model_j, params, bound_j, model, bound, (ro, rd) = models
    zvals, mask = grid_inputs(model, bound, ro, rd)
    fg = model.fg_model

    def run(m, ro, rd, z, msk):
        f = m.fg_model
        return f.get_sigma_radiance_by_mask_pts(*f.get_coarse_net(), ro, rd, z, msk, True)

    with obj_bound_cfgs(models, log_max_allowance=budget_log), torch.inference_mode():
        sigma, radiance = fg.get_sigma_radiance_by_mask_pts(*fg.get_net(), torch.from_numpy(ro), torch.from_numpy(rd),
                                                            zvals, mask, True)
        sigma_j, radiance_j = jax.jit(lambda p, *a: model_j.apply({"params": p}, *a, method=run))(
            params, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(zvals.numpy()), jnp.asarray(mask.numpy()))
    sigma_j, radiance_j = np.asarray(sigma_j), np.asarray(radiance_j)
    compacted = budget_log == 12
    assert compacted == (1 << budget_log < mask.numel())
    if compacted:  # slots outside the budgeted valid samples hold 0 in both
        assert float(sigma[~mask].abs().max()) == 0.0 and np.abs(sigma_j[~mask.numpy()]).max() == 0.0
    # TruncExp amplifies bf16 flips of the density: relative on sigma
    np.testing.assert_allclose(sigma.numpy(), sigma_j, rtol=5e-2, atol=1e-3)
    d_rad = np.abs(radiance.numpy() - radiance_j)
    assert d_rad.max() <= RGB_MAX and d_rad.mean() <= RGB_MEAN, (d_rad.max(), d_rad.mean())


def forward_both(models, get_progress, **cfg_values):
    model_j, params, bound_j, model, bound, (ro, rd) = models
    feed = {"rays_o": ro[None], "rays_d": rd[None]}
    with obj_bound_cfgs(models, **cfg_values):
        out_j = jax.jit(lambda p, f: model_j.apply({"params": p}, f, inference_only=True, get_progress=get_progress,
                                                  bound_state=bound_j))(
            params, {k: jnp.asarray(v) for k, v in feed.items()})
        with torch.inference_mode():
            out = model({k: torch.from_numpy(v) for k, v in feed.items()}, inference_only=True,
                        get_progress=get_progress, bound_state=bound)
    return out, out_j


def test_dense_forward_without_a_budget_matches_jax(models):
    # log_max_allowance -1: no point budget, so no compaction: the dense path
    out, out_j = forward_both(models, False, log_max_allowance=-1)
    got = {k: out[k][0].numpy() for k in ("rgb", "depth", "mask")}
    want = {k: np.asarray(out_j[k][0]) for k in ("rgb", "depth", "mask")}
    assert 0.05 < want["mask"].mean() < 0.95
    assert_slice_close(got, want)
    assert int(out["n_valid_pts"]) == int(out_j["n_valid_pts"])


def test_get_progress_matches_jax(models):
    out, out_j = forward_both(models, True)
    keys = sorted(k for k in out_j if k.startswith("progress_"))
    assert keys == sorted(k for k in out if k.startswith("progress_"))
    assert keys == ["progress_{}".format(k) for k in sorted(("alpha", "radiance", "sigma", "trans_shift",
                                                               "weights", "zvals"))]
    assert_slice_close({k: out[k][0].numpy() for k in ("rgb", "depth", "mask")},
                       {k: np.asarray(out_j[k][0]) for k in ("rgb", "depth", "mask")})
    for k in keys:
        got, want = out[k][0].numpy(), np.asarray(out_j[k][0])
        assert got.shape == want.shape == (256, 64) + ((3,) if k == "progress_radiance" else ())
        if k == "progress_sigma":
            np.testing.assert_allclose(got, want, rtol=5e-2, atol=1e-3)
        elif k == "progress_zvals":
            np.testing.assert_allclose(got, want, atol=1e-5)
        else:
            d = np.abs(got - want)
            assert d.max() <= RGB_MAX and d.mean() <= RGB_MEAN, (k, d.max(), d.mean())
    assert np.abs(out["depth"][0].numpy() - np.asarray(out_j["depth"][0])).max() <= DEPTH_MAX


@pytest.mark.parametrize("with_dir", [True, False])  # a view direction (normalised), and none (zero)
def test_forward_pts_dir_matches_jax(models, with_dir):
    model_j, params, _, model, _, _ = models
    rng = np.random.default_rng(3)
    pts = rng.uniform(-0.9, 0.9, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32) * 3.0 if with_dir else None
    with torch.inference_mode():
        sigma, rgb = model.fg_model.forward_pts_dir(torch.from_numpy(pts),
                                                    None if dirs is None else torch.from_numpy(dirs))
    sigma_j, rgb_j = jax.jit(lambda p, x, d: model_j.apply({"params": p}, x, d, method="forward_pts_dir"))(
        params, jnp.asarray(pts), None if dirs is None else jnp.asarray(dirs))
    np.testing.assert_allclose(sigma.numpy(), np.asarray(sigma_j), rtol=5e-2, atol=1e-3)
    d_rgb = np.abs(rgb.numpy() - np.asarray(rgb_j))
    assert d_rgb.max() <= RGB_MAX and d_rgb.mean() <= RGB_MEAN, (d_rgb.max(), d_rgb.mean())
