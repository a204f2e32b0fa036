"""arcnerf_torch's training pieces vs the JAX package on the same numpy
inputs (CPU): the plain versions of kernels D (fused-MLP backward), E
(hash-table scatter) and F (segment_march backward) against jax.grad, the
sample jitter and the occupancy update fed the JAX draws, the Huber image
loss, the MultiStepLR schedule and an Adam step. Each comparison states its
tolerance and why."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.geometry.volume import Volume as JaxVolume
from arcnerf_tpu.losses import ImgLoss as JaxImgLoss
from arcnerf_tpu.models.base_modules.encoding import HashGridEmbedder as JaxHashGrid
from arcnerf_tpu.models.base_modules.obj_bound import VolumeBound as JaxVolumeBound
from arcnerf_tpu.ops.fused_mlp import _run_forward as jax_run_forward
from arcnerf_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from arcnerf_tpu.render.ray_helper import get_zvals_from_near_far as jax_zvals
from arcnerf_tpu.render.ray_helper import get_zvals_from_near_far_fix_step as jax_fix_step
from arcnerf_tpu.render.ray_helper import segment_march as jax_segment_march
from arcnerf_tpu.trainer.ema import ema_debiased as jax_ema_debiased
from arcnerf_tpu.trainer.ema import ema_init as jax_ema_init
from arcnerf_tpu.trainer.ema import ema_update as jax_ema_update
from arcnerf_tpu.trainer.optimizer import build_lr_schedule as jax_lr_schedule
from arcnerf_tpu.utils.cfgs import dict_to_obj as jax_dict_to_obj
from arcnerf_torch.losses import ImgLoss
from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder
from arcnerf_torch.models.base_modules.obj_bound import VolumeBound
from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from arcnerf_torch.render.ray_helper import get_zvals_from_near_far, get_zvals_from_near_far_fix_step, segment_march
from arcnerf_torch.trainer.ema import ema_debiased, ema_init, ema_update
from arcnerf_torch.trainer.optimizer import build_lr_schedule, build_optimizer
from arcnerf_torch.utils.cfgs import dict_to_obj
from test_torch_ops import _HASH_KW, _VARIANT_FLAGS, _net
from test_torch_render import N_GRID, N_RAYS, N_SAMPLE, _rays, _stream

torch.set_num_threads(1)


def _rel_err(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - np.asarray(b, np.float64)) /
                 max(np.linalg.norm(np.asarray(b, np.float64)), 1e-30))


@pytest.mark.parametrize("dims,b", [([32, 64, 16], 300), ([18, 64, 64, 3], 257)])
def test_fused_mlp_backward_matches_pallas(dims, b):
    # the plain version of kernel D against jax.vjp of the Pallas kernel in
    # interpret mode, on both chains of the recipe. The forward's bf16
    # pre-activations may differ by one bf16 ulp where the two f32 sums of
    # a layer round differently, and a flipped ReLU input or layer input
    # moves a gradient by that much: relative norm error 1e-2 per tensor.
    rng = np.random.default_rng(11)
    ws = _net(dims, 12)
    x = rng.normal(size=(b, dims[0])).astype(np.float32)
    g = rng.normal(size=(b, dims[-1])).astype(np.float32)
    out_j, vjp = jax.vjp(lambda x_, w_: jax_fused_mlp(x_, w_, jax.nn.relu, 128, True), jnp.asarray(x),
                         [jnp.asarray(w) for w in ws])
    dx_j, dws_j = vjp(jnp.asarray(g))

    xt = torch.from_numpy(x).requires_grad_()
    wt = [torch.from_numpy(w).requires_grad_() for w in ws]
    out = fused_mlp(xt, wt)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j), rtol=2e-2, atol=2e-2)
    assert _rel_err(xt.grad.numpy(), dx_j) < 1e-2
    for w, dw_j in zip(wt, dws_j):
        assert w.grad.shape == w.shape and _rel_err(w.grad.numpy(), dw_j) < 1e-2

    # save_pre rides along: the bf16 pre-activations of every hidden layer
    # (one bf16 ulp where the f32 sums round differently: rtol = atol = 2e-2)
    _, pres_j = jax_run_forward(jnp.asarray(x), [jnp.asarray(w) for w in ws], jax.nn.relu, 128, True, save_pre=True)
    _, pre = fused_mlp_reference(torch.from_numpy(x), [torch.from_numpy(w) for w in ws], save_pre=True)
    assert pre.shape == (len(ws) - 1, b, 64) and pre.dtype == torch.bfloat16
    for i, p_j in enumerate(pres_j):
        np.testing.assert_allclose(pre[i].float().numpy(), np.asarray(p_j[:b, :64].astype(jnp.float32)),
                                   rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_table_gradient_matches_jax(variant):
    # the plain version of kernel E against jax.grad of HashGridEmbedder's
    # CPU path: the same entries and weights, the adds into each entry in
    # another order (atol 1e-5 on entries of up to ~5)
    rng = np.random.default_rng(13)
    table = rng.uniform(-1, 1, size=(4, 1 << 12, 2)).astype(np.float32)
    xyz = rng.uniform(-1.02, 1.02, size=(600, 3)).astype(np.float32)
    g = rng.normal(size=(600, 8)).astype(np.float32)
    jax_enc = JaxHashGrid(**_HASH_KW, **_VARIANT_FLAGS[variant])
    want = jax.grad(lambda t: jnp.sum(jax_enc.apply({"params": {"embeddings": t}}, jnp.asarray(xyz)) * g))(
        jnp.asarray(table))

    enc = HashGridEmbedder(**_HASH_KW, **_VARIANT_FLAGS[variant])
    with torch.no_grad():
        enc.embeddings.copy_(torch.from_numpy(table))
    (enc(torch.from_numpy(xyz)) * torch.from_numpy(g)).sum().backward()
    got = enc.embeddings.grad.numpy()
    assert np.count_nonzero(got) > 1000  # dense and hashed levels both receive gradient
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("budget,add_inf_z,bkg", [
    (1 << 12, False, "color"), (1 << 12, False, "white"), (1 << 12, True, None), (1 << 11, False, "color")])
def test_segment_march_gradient_matches_jax(budget, add_inf_z, bkg):
    # the plain version of kernel F against jax.grad of the JAX
    # segment_march for d_sigma and d_rgb: with a background colour, with
    # white_bkg, with add_inf_z, and on a budget-clipped stream (2^11).
    sigma, rgb, z, ray_id, off, cnt = _stream(budget)
    assert budget > 1 << 11 or cnt.sum() == budget
    rng = np.random.default_rng(17)
    color = rng.random((N_RAYS, 3)).astype(np.float32) if bkg == "color" else None
    g_rgb = rng.normal(size=(N_RAYS, 3)).astype(np.float32)
    g_depth, g_mask = rng.normal(size=N_RAYS).astype(np.float32), rng.normal(size=N_RAYS).astype(np.float32)

    def jax_loss(s, c):
        out = jax_segment_march(s, c, jnp.asarray(z), jnp.asarray(ray_id), jnp.asarray(off), jnp.asarray(cnt),
                                N_RAYS, add_inf_z=add_inf_z, white_bkg=bkg == "white",
                                bkg_color=None if color is None else jnp.asarray(color))
        return jnp.sum(out["rgb"] * g_rgb) + jnp.sum(out["depth"] * g_depth) + jnp.sum(out["mask"] * g_mask)

    want = jax.jit(jax.grad(jax_loss, argnums=(0, 1)))(jnp.asarray(sigma), jnp.asarray(rgb))

    def port(dtype):
        s = torch.tensor(sigma, dtype=dtype, requires_grad=True)
        c = torch.tensor(rgb, dtype=dtype, requires_grad=True)
        out = segment_march(s, c, torch.tensor(z, dtype=dtype), torch.tensor(off).long(), torch.tensor(cnt).long(),
                            add_inf_z=add_inf_z, white_bkg=bkg == "white",
                            bkg_color=None if color is None else torch.from_numpy(color).to(dtype))
        loss = sum((out[k] * torch.from_numpy(gk).to(dtype)).sum()
                   for k, gk in (("rgb", g_rgb), ("depth", g_depth), ("mask", g_mask)))
        loss.backward()
        return s.grad.numpy(), c.grad.numpy()

    got, exact = port(torch.float32), port(torch.float64)
    for name, a, b, w in zip(("d_sigma", "d_rgb"), got, exact, want):
        # the port's recurrence in f32 is within 1e-5 of the largest value
        # of the same recurrence in float64
        scale = np.abs(b).max()
        np.testing.assert_allclose(a, b, atol=1e-5 * scale, rtol=0, err_msg=name)
        # JAX differentiates per-ray sums taken as differences of one
        # stream-wide f32 cumsum: its error grows with the stream's total,
        # so 1e-4 of the largest value
        np.testing.assert_allclose(a, np.asarray(w), atol=1e-4 * scale, rtol=0, err_msg=name)
        if add_inf_z:
            continue
        assert np.count_nonzero(a) > 100


def test_jitter_fed_the_jax_draw_matches_jax():
    # the same uniform draw (ray_helper.py:207) through both jitters: the
    # same f32 interval arithmetic, 1e-6
    o, d = _rays()
    vol = JaxVolume(n_grid=N_GRID, side=2.0)
    near, far, _, _ = vol.ray_volume_intersection(jnp.asarray(o), jnp.asarray(d))
    key = jax.random.PRNGKey(21)
    u = np.array(jax.random.uniform(key, (N_RAYS, N_SAMPLE), dtype=jnp.float32))
    fix_t = vol.get_diag_len() / N_SAMPLE
    jz, jm = jax_fix_step(near, far, fix_t, N_SAMPLE, key=key)
    tz, tm = get_zvals_from_near_far_fix_step(torch.tensor(np.asarray(near)), torch.tensor(np.asarray(far)), fix_t,
                                              N_SAMPLE, rand=torch.from_numpy(u))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    plain_z, _ = get_zvals_from_near_far_fix_step(torch.tensor(np.asarray(near)), torch.tensor(np.asarray(far)),
                                                  fix_t, N_SAMPLE)
    assert (tz != plain_z).float().mean() > 0.5  # the jitter moved the samples

    jz2 = jax_zvals(near, far, N_SAMPLE, perturb=True, key=key)
    tz2 = get_zvals_from_near_far(torch.tensor(np.asarray(near)), torch.tensor(np.asarray(far)), N_SAMPLE,
                                  rand=torch.from_numpy(u))
    np.testing.assert_allclose(tz2.numpy(), np.asarray(jz2), atol=1e-6, rtol=0)


def _bound_cfgs():
    return {"volume": {"n_grid": N_GRID, "side": 2.0}, "epoch_optim": 16, "epoch_optim_warmup": 256,
            "ray_sample_acc": True, "ray_sample_fix_step": True, "opa_thres": 0.01}


def _opacity(lib):
    # a smooth analytic density: the update is what is compared, not a net
    return lambda dt, pts: lib.exp(-4.0 * ((pts - 0.2) ** 2).sum(-1)) * 50.0 * dt


@pytest.mark.parametrize("warmup", [True, False])
def test_volume_bound_optimize_fed_the_jax_draws_matches_jax(warmup):
    # VolumeBound.optimize with the voxel picks and jitter JAX draws from
    # jax.random.split(key, 3) (obj_bound.py:302): opafield within 1e-6
    # (the same f32 voxel centres and EMA), bitfield exact
    rng = np.random.default_rng(23)
    state_np = {"bitfield": rng.random((N_GRID,) * 3) < 0.4,
                "opafield": rng.uniform(-0.05, 0.5, size=(N_GRID,) * 3).astype(np.float32)}
    cur_epoch = 0 if warmup else 10**9
    key = jax.random.PRNGKey(5)
    jbound = JaxVolumeBound(jax_dict_to_obj(_bound_cfgs()))
    want = jbound.optimize({k: jnp.asarray(v) for k, v in state_np.items()}, cur_epoch, N_SAMPLE, _opacity(jnp),
                           key)

    # the same draws, as obj_bound.py:302-315 makes them
    n_voxel = N_GRID**3
    k_sel, k_occ, k_noise = jax.random.split(key, 3)
    if warmup:
        flat_idx = np.arange(n_voxel)
    else:
        uni = jax.random.choice(k_sel, n_voxel, shape=(n_voxel // 4,), replace=False)
        occ_p = jnp.asarray(state_np["bitfield"].reshape(-1), jnp.float32)
        occ_p = occ_p / jnp.maximum(jnp.sum(occ_p), 1.0)
        occ = jax.random.choice(k_occ, n_voxel, shape=(n_voxel // 4,), replace=True, p=occ_p)
        flat_idx = np.concatenate([np.asarray(uni), np.asarray(occ)])
    noise_u = np.asarray(jax.random.uniform(k_noise, (flat_idx.shape[0], 3)))

    bound = VolumeBound(dict_to_obj(_bound_cfgs()))
    got = bound.optimize({k: torch.from_numpy(v) for k, v in state_np.items()}, cur_epoch, N_SAMPLE, _opacity(torch),
                         flat_idx=torch.from_numpy(flat_idx), noise_u=torch.from_numpy(noise_u))
    np.testing.assert_allclose(got["opafield"].numpy(), np.asarray(want["opafield"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_array_equal(got["bitfield"].numpy(), np.asarray(want["bitfield"]))
    assert not np.array_equal(got["bitfield"].numpy(), state_np["bitfield"])


def test_volume_bound_optimize_draws_from_the_generator():
    # without fed draws: n_voxel/2 picks after warmup, and a fixed seed
    # gives a fixed result
    bound = VolumeBound(dict_to_obj(_bound_cfgs()))
    state = bound.init_state()
    runs = [bound.optimize(state, 10**9, N_SAMPLE, _opacity(torch), generator=torch.Generator().manual_seed(3))
            for _ in range(2)]
    assert torch.equal(runs[0]["opafield"], runs[1]["opafield"])
    touched = int((runs[0]["opafield"] > 0).sum())
    assert 0 < touched <= N_GRID**3 // 2


def test_huber_image_loss_matches_jax():
    # the same elementwise Huber and mean in f32 (1e-6), errors on both
    # sides of delta, on the _coarse key the training forward outputs
    rng = np.random.default_rng(29)
    gt = rng.uniform(-1, 1, size=(1, 500, 3)).astype(np.float32)
    pred = (gt + rng.normal(size=gt.shape) * 1.5).astype(np.float32)
    cfg = {"loss_type": "Huber", "weight": 1.0}
    want = JaxImgLoss(jax_dict_to_obj(cfg))({"img": jnp.asarray(gt)}, {"rgb_coarse": jnp.asarray(pred)})
    got = ImgLoss(dict_to_obj(cfg))({"img": torch.from_numpy(gt)}, {"rgb_coarse": torch.from_numpy(pred)})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_multistep_lr_matches_optax_at_the_boundaries():
    # update t (0 for the first) gets lr * 0.33^(number of boundaries <= t),
    # as optax.piecewise_constant_schedule; 1e-6 relative (optax computes in f32)
    cfg = {"lr": 1e-2, "lr_scheduler": {"type": "MultiStepLR", "lr_gamma": 0.33, "lr_steps": [20000, 30000]}}
    want, got = jax_lr_schedule(jax_dict_to_obj(cfg)), build_lr_schedule(dict_to_obj(cfg))
    for t in (0, 1, 19999, 20000, 20001, 29999, 30000, 30001, 50000):
        np.testing.assert_allclose(got(t), float(want(t)), rtol=1e-6, err_msg=str(t))
    assert got(19999) == 1e-2 and abs(got(20000) - 3.3e-3) < 1e-12


def test_adam_steps_match_optax():
    # three Adam updates (eps 1e-15, lr from the schedule) on the same
    # gradients, one entry with a zero gradient: the same moments and bias
    # correction in another order of f32 operations, so params of size ~1
    # agree to 1e-6 (a few f32 ulps) after updates of size ~1e-2
    rng = np.random.default_rng(31)
    p0 = {"a": rng.normal(size=(40, 8)).astype(np.float32), "b": rng.normal(size=(17,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 1e-3 for k, v in p0.items()} for _ in range(3)]
    for g in grads:
        g["a"][0] = 0.0
    cfg = {"lr": 1e-2, "eps": 1e-15, "optim_type": "adam"}
    tx = optax.adam(1e-2, eps=1e-15)
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    opt_state = tx.init(params)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, params)
        params = optax.apply_updates(params, upd)

    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt, schedule = build_optimizer(dict_to_obj(cfg), list(tp.values()))
    for t, g in enumerate(grads):
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        for group in opt.param_groups:
            group["lr"] = schedule(t)
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(params[k]), rtol=0, atol=1e-6)
        assert np.abs(tp[k].detach().numpy() - p0[k]).max() > 1e-2


def test_ema_matches_jax():
    # three updates then the debiased read, decay 0.9: the same f32
    # arithmetic in another order (1e-6 relative)
    rng = np.random.default_rng(37)
    steps = [{"a": rng.normal(size=(5, 4)).astype(np.float32)} for _ in range(3)]
    shadow_j = jax_ema_init({"a": jnp.asarray(steps[0]["a"])})
    shadow = ema_init([("a", torch.from_numpy(steps[0]["a"]))])
    for t, p in enumerate(steps, start=1):
        shadow_j = jax_ema_update(shadow_j, {"a": jnp.asarray(p["a"])}, t, 0.9)
        ema_update(shadow, [("a", torch.from_numpy(p["a"]))], 0.9)
    np.testing.assert_allclose(ema_debiased(shadow, 3, 0.9)["a"].numpy(),
                               np.asarray(jax_ema_debiased(shadow_j, 3, 0.9)["a"]), rtol=1e-6, atol=1e-7)


def test_unported_optimizer_options_raise():
    with pytest.raises(NotImplementedError, match="clip_gradients"):
        build_optimizer(dict_to_obj({"clip_gradients": 1.0}), [torch.nn.Parameter(torch.zeros(2))])
    with pytest.raises(NotImplementedError, match="sgd"):
        build_optimizer(dict_to_obj({"optim_type": "sgd"}), [torch.nn.Parameter(torch.zeros(2))])
