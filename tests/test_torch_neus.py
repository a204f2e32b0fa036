"""NeuS-NGP on the port against the JAX package (CPU): the hash grid's
input gradient and its double backward (against autograd of the encoding's
plain version, in f64), GeoNet and its normal, NeuS's alpha and occupancy
estimate and the whole model's render (at 4 levels, the autograd chain,
and at the recipe's 16, the fused chain, with its loss gradients against
``jax.grad``), the sections of the fused sampler's stream against
``Neus.handle_mid_pts`` on left-compacted rows, compositing in the alpha
mode against a dense ``alpha_to_weights`` march, the eikonal and mask
losses, AdamW against ``optax.adamw``, and the normal entry point on
``configs/expr/synthetic_neus_ngp.yaml``."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from arcnerf_torch.models.base_modules import encoding
from arcnerf_torch.models.base_modules.sample_compact import (compact_sel_aux, sample_compact,
                                                              sample_count_reference, sdf_sections)
from arcnerf_torch.render.ray_helper import alpha_to_weights, segment_march, segment_march_reference
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import state_from_jax

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/expr/synthetic_neus_ngp.yaml")
# the recipe's 16 levels (the GeoNet's 32 inputs: the fused chain, kernels
# M and N on the card) over T = 2^12, n_grid 16, 32 samples a ray, a budget
# of 2^14; SMALL: 4 levels (8 inputs: the autograd chain)
RECIPE = ["--model.geometry.encoder.hashmap_size", "12", "--model.obj_bound.volume.n_grid", "16",
          "--model.rays.n_sample", "32", "--model.obj_bound.log_max_allowance", "14"]
SMALL = RECIPE + ["--model.geometry.encoder.n_levels", "4"]
RES, LO, LEN = [3, 7, 15, 31], np.full(3, -1.0, np.float32), np.full(3, 2.0, np.float32)


# ------------------------------------------------ the hash grid's derivatives

def _grid(dtype, seed=0, n=40):
    gen = torch.Generator().manual_seed(seed)
    table = (torch.rand((4, 1 << 8, 2), generator=gen, dtype=dtype) * 2 - 1)
    xyz = torch.rand((n, 3), generator=gen, dtype=dtype) * 1.8 - 0.9
    g = torch.randn((n, 8), generator=gen, dtype=dtype)
    return xyz, table, g


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_input_gradient_is_autograd_of_the_encoding(variant):
    # f64, the table read as it is: the plain input gradient and its
    # backward against autograd of hash_encode_reference (1e-12), and the
    # input gradient's backward against finite differences (gradcheck)
    xyz, table, g = _grid(torch.float64)
    x = xyz.clone().requires_grad_(True)
    t = table.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    enc = encoding.hash_encode_reference(x, t, RES, LO, LEN, variant, read_bf16=False)
    (dx_auto,) = torch.autograd.grad((enc * gg).sum(), x, create_graph=True)
    dx = encoding.hash_encode_dx_reference(xyz, table, g, RES, LO, LEN, variant, read_bf16=False)
    torch.testing.assert_close(dx, dx_auto.detach(), rtol=0, atol=1e-12)
    v = torch.randn((xyz.shape[0], 3), generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    d_t_auto, d_g_auto = torch.autograd.grad((dx_auto * v).sum(), [t, gg])
    d_t, d_g = encoding.hash_dx_bwd_reference(xyz, table, g, v, RES, LO, LEN, variant, read_bf16=False)
    torch.testing.assert_close(d_t, d_t_auto, rtol=0, atol=1e-12)
    torch.testing.assert_close(d_g, d_g_auto, rtol=0, atol=1e-12)
    assert torch.autograd.gradcheck(
        lambda tt, g2: encoding._HashDxFunction.apply(xyz, tt, g2, RES, LO, LEN, variant, False, None),
        (t, gg))


def test_the_encoding_gives_the_input_gradient_and_its_backward_through_autograd():
    # hash_encode with points that require a gradient: autograd.grad with
    # create_graph gives the plain input gradient, and a loss on it reaches
    # the table and the encoding's gradient as the double backward does
    xyz, table, g = _grid(torch.float64, 2)
    t = table.clone().requires_grad_(True)
    gg = g.clone().requires_grad_(True)
    x = xyz.clone().requires_grad_(True)
    enc = encoding.hash_encode(x, t, RES, LO, LEN, "quad", False)
    (dx,) = torch.autograd.grad((enc * gg).sum(), x, create_graph=True)
    x2 = xyz.clone().requires_grad_(True)
    enc2 = encoding.hash_encode_reference(x2, t, RES, LO, LEN, "quad", read_bf16=False)
    (dx2,) = torch.autograd.grad((enc2 * gg).sum(), x2, create_graph=True)
    torch.testing.assert_close(dx, dx2, rtol=0, atol=1e-12)
    v = torch.randn(dx.shape, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    for a, b in zip(torch.autograd.grad((dx * v).sum(), [t, gg]), torch.autograd.grad((dx2 * v).sum(), [t, gg])):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_input_grad_block_ends_the_points_gradient():
    # inside encoding.input_grad the backward gives d/dxyz once (the
    # normal); the loss's backward after the block launches no input
    # gradient and leaves the points without one
    xyz, table, g = _grid(torch.float32, 4)
    t = table.clone().requires_grad_(True)
    calls = []
    inner = encoding.hash_encode_dx

    def counting(*args, **kwargs):
        calls.append(1)
        return inner(*args, **kwargs)

    encoding.hash_encode_dx = counting
    try:
        x = xyz.clone().requires_grad_(True)
        with encoding.input_grad():
            s = (encoding.hash_encode(x, t, RES, LO, LEN, "quad") * g).sum()
            (n,) = torch.autograd.grad(s, x, create_graph=True)
        (s + (n * n).sum()).backward()
    finally:
        encoding.hash_encode_dx = inner
    assert len(calls) == 1 and x.grad is None and t.grad is not None


# ---------------------------------------------------------- the JAX model

def jax_model_and_params(seed=0, shape=SMALL):
    from arcnerf_tpu.models import build_model as jax_build_model
    from arcnerf_tpu.utils.cfgs import load_configs as jax_load_configs
    from arcnerf_tpu.utils.cfgs import update_configs_by_dotlist as jax_update

    model = jax_build_model(jax_update(jax_load_configs(CFG), list(shape)))
    tiny = {"rays_o": jnp.zeros((1, 2, 3)), "rays_d": jnp.ones((1, 2, 3)) / np.sqrt(3.0)}
    variables = model.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, tiny,
                           inference_only=True, bound_state=model.init_bound_state())
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        names = [getattr(p, "key", str(p)) for p in path]
        shape = np.shape(leaf)
        if names[-1] == "embeddings":
            return rng.uniform(-0.5, 0.5, size=shape).astype(np.float32)
        if names[-1] == "inv_s":
            return np.asarray(leaf, np.float32)
        if names[-1].endswith("/kernel/scale"):
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return (rng.normal(size=shape) / np.sqrt(shape[0])).astype(np.float32)

    return model, jax.tree_util.tree_map_with_path(fill, variables["params"])


def port_model(params, shape=SMALL):
    from arcnerf_torch.models import build_model

    model = build_model(update_configs_by_dotlist(load_configs(CFG), shape + ["--device", "cpu"]))
    state, _ = state_from_jax(jax.tree_util.tree_map(np.asarray, params), {})
    assert set(state) == set(dict(model.named_parameters()))
    model.load_state_dict(state)
    return model


def sphere_bound(n_grid=16):
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield

    return {"fg": {"bitfield": sphere_scene_bitfield(n_grid, 2.0), "opafield": np.zeros((n_grid,) * 3, np.float32)}}


def view_rays(wh=16):
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.utils.cfgs import dict_to_obj

    ds = get_dataset(dict_to_obj({"eval": {"type": "Synthetic", "n_imgs": 1, "wh": [wh, wh], "cam_radius": 2.5,
                                           "white_bkg": True, "center_pixel": True}}), "data", "eval")
    return ds[0]["rays_o"], ds[0]["rays_d"]


@pytest.fixture(scope="module")
def recipe_models():
    """The JAX Neus and the port on its weights at the recipe's 16 levels,
    where the port takes the fused geometry chain."""
    from arcnerf_torch.models.sdf_model import fuses_geo_chain

    model_j, params = jax_model_and_params(1, RECIPE)
    model = port_model(params, RECIPE)
    assert fuses_geo_chain(model.fg_model.geo_net)
    return model_j, params, model


def check_geonet(model_j, params, model):
    """sdf and feature within f32 rounding of the JAX GeoNet's, the normal
    (jax.grad / the port's input gradient through the hash grid) within
    1e-6 of its largest value."""
    from arcnerf_tpu.models.sdf_model import geo_with_grad as jax_geo_with_grad
    from arcnerf_torch.models.sdf_model import geo_with_grad

    pts = np.random.default_rng(2).uniform(-0.95, 0.95, size=(500, 3)).astype(np.float32)
    out_j = model_j.apply({"params": params}, jnp.asarray(pts),
                          method=lambda m, p: jax_geo_with_grad(m.fg_model.geo_net, p))
    sdf, feat, normal = geo_with_grad(model.fg_model.geo_net, torch.from_numpy(pts))
    np.testing.assert_allclose(sdf.numpy(), np.asarray(out_j[0]), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(feat.numpy(), np.asarray(out_j[1]), rtol=1e-5, atol=1e-5)
    want = np.asarray(out_j[2])  # |normal| up to ~300 on these weights: 1e-6 of the largest
    np.testing.assert_allclose(normal.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_geonet_sdf_feature_and_normal_match_jax():
    # the recipe's GeoNet (weight norm, softplus 100, no bias) at 4 levels
    # (the autograd chain) on the JAX weights
    model_j, params = jax_model_and_params(1)
    check_geonet(model_j, params, port_model(params))


def test_fused_geonet_sdf_feature_and_normal_match_jax(recipe_models):
    # the same at the recipe's 16 levels: the fused chain (plain M)
    check_geonet(*recipe_models)


def test_geonet_init_is_the_geometric_init_under_weight_norm():
    # as the JAX init draws it: the first layer's normal rows on the first
    # three inputs only, the last layer around sqrt(pi / W), scales 1
    from arcnerf_torch.models.base_modules import build_geo_model

    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL)
    net = build_geo_model(cfgs.model.geometry, torch.Generator().manual_seed(0))
    assert torch.equal(net.fc_0[3:], torch.zeros_like(net.fc_0[3:])) and net.fc_0[:3].abs().sum() > 0
    w = net.fc_1.detach()
    assert abs(float(w.mean()) - np.sqrt(np.pi) / 8) < 1e-4 and float(w.std()) < 2e-4
    assert torch.equal(net.wn_0, torch.ones(64)) and torch.equal(net.wn_1, torch.ones(17))
    assert not hasattr(net, "fc_0_bias")


def test_sdf_to_alpha_and_the_occupancy_estimate_match_jax():
    from arcnerf_tpu.models.neus_model import sdf_to_alpha as jax_sdf_to_alpha
    from arcnerf_torch.models.neus_model import sdf_to_alpha

    rng = np.random.default_rng(3)
    sdf, slope = rng.normal(size=(64, 8)).astype(np.float32) * 0.1, rng.normal(size=(64, 8)).astype(np.float32)
    z = np.sort(rng.uniform(2, 3, size=(64, 9)).astype(np.float32), axis=1)
    want = np.asarray(jax_sdf_to_alpha(jnp.asarray(sdf), jnp.asarray(z), jnp.asarray(slope), 20.0))
    got = sdf_to_alpha(torch.from_numpy(sdf), torch.from_numpy(z[:, 1:] - z[:, :-1]), torch.from_numpy(slope), 20.0)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)

    model_j, params = jax_model_and_params(4)
    check_occupancy_estimate(model_j, params, port_model(params), rng)


def check_occupancy_estimate(model_j, params, model, rng):
    """The occupancy update's opacity at random points against the JAX
    model's ``get_est_opacity``."""
    pts = rng.uniform(-0.95, 0.95, size=(400, 3)).astype(np.float32)
    dt = float(np.sqrt(3.0) * 2.0 / 32)
    want = np.asarray(model_j.apply({"params": params}, dt, jnp.asarray(pts), method="get_est_opacity"))
    got = model.get_est_opacity(dt, torch.from_numpy(pts))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4, atol=1e-6)


def test_fused_occupancy_estimate_matches_jax(recipe_models):
    check_occupancy_estimate(*recipe_models, np.random.default_rng(3))


def check_render(model_j, params, model, unpadded=False):
    """The whole model at inference on the sphere scene's grid: the
    stream's sections, the normals, the radiance (bf16 kernel A's plain
    version), alpha, compositing and the invalid-ray fill against the JAX
    Neus on its (rays, n_sample) grid. 2e-3: the JAX grid also marches its
    padding sections (alpha ~1e-5 / cdf each, ROADMAP Queue 3) and the
    radiance net rounds to bf16. n_valid_pts counts sections: one more
    than the samples for every ray that has a sample. ``unpadded``: only
    the rays whose padding sections carry under 1e-4 of the JAX grid's
    weight (a padding section sits at its ray's last mid point; the count
    takes in the last real section's weight too, so it may leave out more
    rays, never fewer), at least 7 in 8."""
    bound_np = sphere_bound()
    ro, rd = view_rays()
    feed = {"rays_o": ro[None], "rays_d": rd[None]}
    out_j = model_j.apply({"params": params}, {k: jnp.asarray(v) for k, v in feed.items()}, inference_only=True,
                          get_progress=unpadded, bound_state=jax.tree_util.tree_map(jnp.asarray, bound_np))
    _, bound = state_from_jax({}, bound_np)
    with torch.inference_mode():
        out = model({k: torch.from_numpy(v) for k, v in feed.items()}, inference_only=True, bound_state=bound)
    rays = np.ones(ro.shape[0], dtype=bool)
    if unpadded:
        mid, weights = np.asarray(out_j["progress_zvals"][0]), np.asarray(out_j["progress_weights"][0])
        rays = (weights * (mid == mid[:, -1:])).sum(1) < 1e-4
        assert rays.mean() >= 7 / 8 and (np.asarray(out_j["mask"][0])[rays] > 0.5).sum() > 20
    for k in ("rgb", "depth", "mask", "normal"):
        np.testing.assert_allclose(out[k][0].numpy()[rays], np.asarray(out_j[k][0])[rays], rtol=0, atol=2e-3,
                                   err_msg=k)
    assert 0.1 < float(out["mask"].mean()) < 0.9
    n_rays_hit = int(np.asarray(out_j["mask"][0] > 0).sum())
    assert int(out["n_valid_pts"]) > int(out_j["n_valid_pts"]) and n_rays_hit > 0


def test_render_matches_jax_neus():
    model_j, params = jax_model_and_params(0)
    check_render(model_j, params, port_model(params))


def test_fused_render_matches_jax_neus(recipe_models):
    # at the recipe's 16 levels the field is rougher: rays end inside the
    # surface, where the JAX grid's padding sections take up to 5e-2 of a
    # ray's weight, on the fused and the autograd chain alike: those rays
    # are left out
    check_render(*recipe_models, unpadded=True)


def test_fused_neus_loss_gradients_match_jax(recipe_models):
    # the NeuS loss's terms on given sections at the recipe's 16 levels, the
    # chain fused (plain M, then N in the backward): alpha (NeuS eq. 13
    # from the sdf, the normal's slope and s = exp(speed inv_s)), weights
    # on the feature and the normal (what the radiance net reads) and the
    # eikonal loss. Each leaf's gradient (table, both layers and their
    # scales, inv_s) against jax.grad of the same loss on the JAX Neus,
    # within 1e-5 of its largest value
    from arcnerf_tpu.models.neus_model import sdf_to_alpha as jax_sdf_to_alpha
    from arcnerf_tpu.models.sdf_model import geo_with_grad as jax_geo_with_grad
    from arcnerf_torch.models.neus_model import sdf_to_alpha
    from arcnerf_torch.models.sdf_model import geo_with_grad

    model_j, params, model = recipe_models
    rng = np.random.default_rng(13)
    n = 400
    pts = rng.uniform(-0.95, 0.95, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)
    dist = rng.uniform(0.005, 0.02, size=n).astype(np.float32)
    c_alpha, c_feat, c_normal = (rng.normal(size=s).astype(np.float32) for s in (n, (n, 16), (n, 3)))

    def jax_loss(p):
        def terms(m):
            sdf, feat, normal = jax_geo_with_grad(m.fg_model.geo_net, jnp.asarray(pts))
            slope = -jax.nn.relu(-jnp.sum(dirs * normal, axis=-1))
            zvals = jnp.stack([jnp.zeros(n), jnp.asarray(dist)], axis=1)
            alpha = jax_sdf_to_alpha(sdf, zvals, slope[:, None], m.fg_model.forward_scale())[:, 0]
            eikonal = jnp.mean((jnp.linalg.norm(normal, axis=-1) - 1.0) ** 2)
            return (alpha * c_alpha).sum() + (feat * c_feat).sum() + (normal * c_normal).sum() + 0.1 * eikonal

        return model_j.apply({"params": p}, method=terms)

    want, _ = state_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(params)), {})
    fg = model.fg_model
    model.zero_grad()
    sdf, feat, normal = geo_with_grad(fg.geo_net, torch.from_numpy(pts), create_graph=True)
    slope = -torch.relu(-(torch.from_numpy(dirs) * normal).sum(-1))
    alpha = sdf_to_alpha(sdf[:, 0], torch.from_numpy(dist), slope, fg.forward_scale())
    eikonal = ((normal.norm(dim=-1) - 1.0) ** 2).mean()
    loss = ((alpha * torch.from_numpy(c_alpha)).sum() + (feat * torch.from_numpy(c_feat)).sum()
            + (normal * torch.from_numpy(c_normal)).sum() + 0.1 * eikonal)
    loss.backward()
    got = {name: p.grad for name, p in model.named_parameters() if p.grad is not None}
    assert set(got) == {"fg_model.inv_s"} | {"fg_model.geo_net." + k for k in
                                             ("fc_0", "wn_0", "fc_1", "wn_1", "encoder.embeddings")}
    for name, grad in got.items():
        w = want[name]
        assert float(w.abs().max()) > 0, name
        torch.testing.assert_close(grad, w, rtol=0, atol=1e-5 * float(w.abs().max()), msg=name)


# -------------------------------------------------------------- the sections

def _ladder(seed, n_rays=300, n_pts=48, budget=1 << 20, cap=None):
    from arcnerf_torch.tools.sample_streams import ladder_bitfield, ladder_rand, ladder_rays, ladder_volume

    vol = ladder_volume()
    rays_o, rays_d = ladder_rays(vol, n_rays, seed, 0.2)
    rand = ladder_rand(n_rays, n_pts, seed + 1)
    return vol, ladder_bitfield("half", vol, seed), rays_o, rays_d, n_pts, budget, cap, rand


def ladder_mask(args):
    """The (rays, n_pts) ladder z of the sampler's inputs ``args`` and the
    mask of its valid samples (box, occupancy, cap), in ladder order."""
    from arcnerf_torch.models.base_modules.obj_bound import _cap_pts_per_ray, _occ_mask_soa
    from arcnerf_torch.render.ray_helper import get_zvals_from_near_far_fix_step

    vol, bitfield, rays_o, rays_d, n_pts, _, cap, rand = args
    near, far, _, _ = vol.ray_volume_intersection(rays_o, rays_d)
    zvals, mask = get_zvals_from_near_far_fix_step(near, far, vol.get_diag_len() / n_pts, n_pts, rand=rand)
    return zvals, _cap_pts_per_ray(mask & _occ_mask_soa(vol, bitfield, rays_o, rays_d, zvals), True, cap)


def test_sections_are_handle_mid_pts_on_left_compacted_rows():
    # sdf_sections on the ladder's scattered mask against JAX's
    # handle_valid_mask_zvals then Neus.handle_mid_pts: the same mid points
    # and lengths (an ulp: sd divides as a multiply by the reciprocal) and
    # mask, but for rays without a sample, where the JAX mask keeps one
    # section (its ray renders the background either way)
    from arcnerf_tpu.models.neus_model import Neus
    from arcnerf_tpu.render.ray_helper import handle_valid_mask_zvals

    args = _ladder(5)
    zvals, mask = ladder_mask(args)
    mid, length, smask = sdf_sections(zvals, mask, args[4])
    zc, mc = handle_valid_mask_zvals(jnp.asarray(zvals.numpy()), jnp.asarray(mask.numpy()))
    neus = Neus.__new__(Neus)
    object.__setattr__(neus, "get_ray_cfgs", lambda key: args[4])
    mid_j, ext_j, mask_j = Neus.handle_mid_pts(neus, zc, mc)
    has = mask.any(1).numpy()
    np.testing.assert_array_equal(smask.numpy()[has], np.asarray(mask_j)[has])
    assert not smask.numpy()[~has].any() and np.asarray(mask_j)[~has][:, 0].all()
    m = smask.numpy()
    np.testing.assert_allclose(mid.numpy()[m], np.asarray(mid_j)[m], rtol=0, atol=2e-6)
    np.testing.assert_allclose(length.numpy()[m], np.asarray(ext_j[:, 1:] - ext_j[:, :-1])[m], rtol=0, atol=2e-6)
    assert has.sum() > 20 and (~has).sum() > 5


@pytest.mark.parametrize("budget", [1 << 20, 1500])
def test_stream_holds_the_sections_in_ray_major_order_under_the_budget(budget):
    # the fused sampler's sections mode: the first `budget` sections in
    # ray-major order (the JAX compact_point_eval's selection of
    # mask_mid_pts), their mid points, lengths and the per-ray off/cnt;
    # the rows past them repeat ray 0's first ladder sample at length 0.
    # A budget that cuts a ray ends its sections there (ROADMAP Queue 3:
    # the JAX grid evaluates the cut sections at sdf 0)
    from arcnerf_tpu.models.fg_model import FgModel as JaxFgModel

    args = _ladder(7, budget=budget)
    plan = sample_count_reference(*args, sections=True)
    stream = sample_compact(*args, count=sample_count_reference, sections=True)
    zvals, mask = ladder_mask(args)
    mid, length, smask = sdf_sections(zvals, mask, args[4])
    k = min(budget, mid.numel())
    sel, _, off, cnt = compact_sel_aux(smask, k)
    sel_j, _ = JaxFgModel._compact_sel(jnp.asarray(smask.numpy()), k)
    n = int(stream["cnt"].sum())
    np.testing.assert_array_equal(sel[:n].numpy(), np.asarray(sel_j)[:n])
    assert torch.equal(stream["z"][:n], mid.reshape(-1)[sel[:n]])
    assert torch.equal(stream["len"][:n], length.reshape(-1)[sel[:n]])
    assert torch.equal(stream["off"], off) and torch.equal(stream["cnt"], cnt)
    assert (stream["len"][n:] == 0).all() and (stream["z"][n:] == plan["first_z"]).all()
    if budget < 1 << 20:
        assert int(plan["n_valid"]) > budget and n == budget


def test_alpha_mode_composites_as_a_dense_alpha_to_weights_march():
    # segment_march_reference's alpha mode against alpha_to_weights on the
    # (rays, max cnt) grid, and its backward against autograd of that grid
    # march (1e-6: cumprod against exp(cumsum(log)))
    rng = np.random.default_rng(9)
    n_rays, cnt_np = 50, rng.integers(0, 12, size=50)
    k = int(cnt_np.sum()) + 7
    off = torch.as_tensor(np.cumsum(cnt_np) - cnt_np)
    cnt = torch.as_tensor(cnt_np)
    alpha = torch.as_tensor(rng.uniform(0, 1, size=k).astype(np.float32)).requires_grad_(True)
    rgb = torch.as_tensor(rng.uniform(0, 1, size=(k, 3)).astype(np.float32)).requires_grad_(True)
    z = torch.as_tensor(np.sort(rng.uniform(2, 4, size=k)).astype(np.float32))
    bkg = torch.as_tensor(rng.uniform(0, 1, size=(n_rays, 3)).astype(np.float32))
    out = segment_march(alpha, rgb, z, off, cnt, bkg_color=bkg, alpha=True)
    m = int(cnt_np.max())
    pos = torch.arange(m)[None]
    inseg = pos < cnt[:, None]
    idx = torch.where(inseg, off[:, None] + pos, 0)
    a = torch.where(inseg, alpha[idx], 0.0)
    trans, w = alpha_to_weights(a)
    rgb_d = (w[..., None] * torch.where(inseg[..., None], rgb[idx], 0.0)).sum(1)
    t_end = torch.where(cnt > 0, (trans * (1 - a + 1e-10))[torch.arange(n_rays), (cnt - 1).clamp_min(0)], 1.0)
    dense = {"rgb": rgb_d + t_end[:, None] * bkg, "depth": (w * torch.where(inseg, z[idx], 0.0)).sum(1),
             "mask": w.sum(1)}
    for key in dense:
        torch.testing.assert_close(out[key], dense[key], rtol=1e-6, atol=1e-6)
    g = [torch.as_tensor(rng.normal(size=s).astype(np.float32)) for s in ((n_rays, 3), (n_rays,), (n_rays,))]
    got = torch.autograd.grad(sum((out[k] * gk).sum() for k, gk in zip(("rgb", "depth", "mask"), g)), [alpha, rgb])
    want = torch.autograd.grad(sum((dense[k] * gk).sum() for k, gk in zip(("rgb", "depth", "mask"), g)),
                               [alpha, rgb])
    for a_, b_ in zip(got, want):
        torch.testing.assert_close(a_, b_, rtol=1e-5, atol=1e-6)
    plain = segment_march_reference(alpha.detach(), rgb.detach(), z, off, cnt, bkg=bkg, alpha=True)
    assert torch.equal(plain["rgb"], out["rgb"].detach())


# ------------------------------------------------------ losses and optimizer

def test_eikonal_and_mask_losses_match_jax():
    from arcnerf_tpu.losses import EikonalLoss as JaxEikonal
    from arcnerf_tpu.losses import MaskLoss as JaxMaskLoss
    from arcnerf_torch.losses import EikonalLoss, MaskLoss
    from arcnerf_torch.utils.cfgs import dict_to_obj

    rng = np.random.default_rng(11)
    normal = rng.normal(size=(2, 30, 3)).astype(np.float32)
    mask_pred = rng.uniform(0, 1, size=(2, 30)).astype(np.float32)
    mask_gt = (rng.uniform(size=(2, 30)) > 0.5).astype(np.float32)
    want = float(JaxEikonal(dict_to_obj({"key": "normal_pts"}))({}, {"normal_pts": jnp.asarray(normal)}))
    got = float(EikonalLoss(dict_to_obj({"key": "normal_pts"}))({"img": torch.zeros(1)},
                                                                 {"normal_pts": torch.from_numpy(normal)}))
    assert abs(got - want) <= 1e-6 * abs(want)
    cfg = dict_to_obj({"loss_type": "BCE"})
    want = float(JaxMaskLoss(cfg)({"mask": jnp.asarray(mask_gt)}, {"mask": jnp.asarray(mask_pred)}))
    got = float(MaskLoss(cfg)({"mask": torch.from_numpy(mask_gt)}, {"mask": torch.from_numpy(mask_pred)}))
    assert abs(got - want) <= 1e-6 * abs(want)
    # a stream's normal_pts with its kept rows: only those count
    valid = torch.arange(30) < 17
    flat = torch.from_numpy(normal[0])
    got = float(EikonalLoss()({"img": torch.zeros(1)}, {"normal_pts": flat, "normal_pts_valid": valid}))
    assert abs(got - float(((flat[:17].norm(dim=-1) - 1) ** 2).mean())) < 1e-6


def test_weight_decay_is_adamw_as_optax_decays():
    # three steps of the port's optimizer under optim.weight_decay against
    # optax.adamw (decoupled: p - lr (update + wd p)); 1e-5 relative: torch
    # scales p by (1 - lr wd) before the update, optax adds wd p to it
    from arcnerf_torch.trainer.optimizer import build_optimizer
    from arcnerf_torch.utils.cfgs import dict_to_obj

    cfg = dict_to_obj({"lr": 1e-2, "eps": 1e-15, "weight_decay": 0.05, "optim_type": "adam"})
    rng = np.random.default_rng(12)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3)]
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = build_optimizer(cfg, [param])
    assert isinstance(opt, torch.optim.AdamW)
    tx = optax.adamw(1e-2, eps=1e-15, weight_decay=0.05)
    pj = jnp.asarray(p0)
    state = tx.init(pj)
    for g in grads:
        param.grad = torch.from_numpy(g.copy())
        opt.step()
        upd, state = tx.update(jnp.asarray(g), state, pj)
        pj = optax.apply_updates(pj, upd)
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(pj), rtol=1e-5, atol=1e-7)


# ------------------------------------------------------------ the entry point

TINY = ["--device", "cpu", "--progress.epoch", "20", "--progress.epoch_loss", "10", "--progress.epoch_val", "20",
        "--progress.epoch_save_checkpoint", "-1", "--dataset.train.n_imgs", "3", "--dataset.train.wh", "[16,16]",
        "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]", "--n_rays", "256",
        "--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
        "--model.obj_bound.volume.n_grid", "16", "--model.rays.n_sample", "48",
        "--model.obj_bound.log_max_allowance", "13", "--model.obj_bound.epoch_optim_warmup", "8",
        "--model.obj_bound.epoch_optim", "8"]


def test_train_entry_trains_neus_ngp_and_renders_it(tmp_path):
    # python -m arcnerf_torch.train on the NeuS-NGP recipe at a tiny size:
    # finite losses (the recipe's early steps spike: Adam's first steps
    # move every touched table entry by ~lr, and the eikonal loss answers),
    # the occupancy updates through NeuS's estimate, a validation render
    # with normals, the final checkpoint
    from arcnerf_torch import train

    trainer = train.main(["--configs", CFG, "--dir.expr_dir", str(tmp_path / "neus")] + TINY)
    losses = torch.stack(trainer.loss_history)
    assert losses.shape == (20,) and torch.isfinite(losses).all()
    assert not torch.equal(trainer.bound_state["fg"]["opafield"], torch.zeros_like(trainer.bound_state["fg"]["opafield"]))
    assert trainer.ema is not None and isinstance(trainer.optimizer, torch.optim.AdamW)
    assert os.path.exists(tmp_path / "neus" / "checkpoints" / "final.pt")
    out = trainer.render_image(trainer.data["val"][0])
    assert set(out) >= {"rgb", "depth", "mask", "normal"} and all(torch.isfinite(v).all() for v in out.values())


def test_strided_neus_steps_are_the_eager_steps(tmp_path):
    # the static-buffer step (a CUDA graph on the card) on the CPU, stride
    # 4, against one eager step a call: the same losses and leaves bit for
    # bit, the annealed slope read from the device count of updates
    from arcnerf_torch.trainer import ArcNerfTrainer

    def make(name, scan):
        return ArcNerfTrainer(update_configs_by_dotlist(load_configs(CFG), TINY + [
            "--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps", str(scan),
            "--model.params.anneal_end", "4"]))

    eager, strided = make("e", 1), make("s", 4)
    for e in range(8):
        eager.train_steps(e, 1)
    for e in range(0, 8, 4):
        strided.train_steps(e, 4)
    assert torch.equal(torch.stack(eager.loss_history), torch.stack(strided.loss_history))
    params = dict(strided.model.named_parameters())
    for name, p in eager.model.named_parameters():
        assert torch.equal(p, params[name]), name
