"""VolSDF on the port (CPU) against the JAX package at
``configs/expr/synthetic_volsdf.yaml``'s widths and against the benchmark's
plain reference (``bench_torch/reference/volsdf.py``, plain PyTorch that
shares no code with the program), on seeded random weights: the
FreqEmbedder, RadianceNet, SphereBound's near and far, the Laplace density,
Theorem 1's d*, the error bound, the bisection's beta and Algorithm 1's
samples (through ``sample_pdf``), the render, the loss gradients against
``jax.grad``, a training step's loss, samples and every leaf's gradient
against the reference, the strided (graph-form) steps against the eager
ones, the normal entry point on ``synthetic_volsdf.yaml``, and the spans and
counters it adds.

The JAX ``RadianceNet`` drops its encoders (ROADMAP Queue 3), the port's
encodes its view as the config says: where the whole model is compared with
JAX, the port's view encoder is the identity (``--model.radiance.encoder.
view.n_freqs 0``), the function the JAX net computes."""

import math
import os
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arcnerf_torch.utils.cfgs import load_configs, obj_to_dict, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import state_from_jax
from bench_torch import port_volsdf, run, traffic
from bench_torch.drivers import train_volsdf
from bench_torch.reference import volsdf as ref

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/expr/synthetic_volsdf.yaml")
# the yaml's widths (GeoNet 4 x 128 with its skip, radiance 2 x 128, n_iter 3,
# beta_iter 6) at fewer samples a ray; JAX: the view unencoded, as the JAX
# RadianceNet computes it
SMALL = ["--model.rays.n_eval", "16", "--model.rays.n_sample", "16", "--model.rays.n_importance", "8"]
JAX_FORM = SMALL + ["--model.radiance.encoder.view.n_freqs", "0"]


def _perturb(path, leaf, rng):
    """The JAX init (geometric for the GeoNet) moved by seeded noise, so
    that no leaf holds its init's special values."""
    name = getattr(path[-1], "key", str(path[-1]))
    a = np.asarray(leaf, np.float32)
    if name == "ln_beta":
        return a
    if name.endswith("/kernel/scale"):
        return (a * rng.uniform(0.8, 1.2, size=a.shape)).astype(np.float32)
    if name == "bias":
        return (a + 0.01 * rng.normal(size=a.shape)).astype(np.float32)
    return (a + 0.1 / np.sqrt(a.shape[0]) * rng.normal(size=a.shape)).astype(np.float32)


@pytest.fixture(scope="module")
def models():
    """The JAX VolSDF and the port on its weights."""
    from arcnerf_tpu.models import build_model as jax_build_model
    from arcnerf_tpu.utils.cfgs import load_configs as jax_load_configs
    from arcnerf_tpu.utils.cfgs import update_configs_by_dotlist as jax_update
    from arcnerf_torch.models import build_model

    model_j = jax_build_model(jax_update(jax_load_configs(CFG), list(JAX_FORM)))
    tiny = {"rays_o": jnp.zeros((1, 2, 3)), "rays_d": jnp.ones((1, 2, 3)) / np.sqrt(3.0)}
    variables = model_j.init({"params": jax.random.PRNGKey(0), "sampling": jax.random.PRNGKey(1)}, tiny,
                             inference_only=True, bound_state=model_j.init_bound_state())
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map_with_path(lambda p, x: _perturb(p, x, rng), variables["params"])
    model = build_model(update_configs_by_dotlist(load_configs(CFG), JAX_FORM + ["--device", "cpu"]))
    state, _ = state_from_jax(params, {})
    assert set(state) == set(dict(model.named_parameters()))
    model.load_state_dict(state)
    return model_j, params, model


def _rays(n=96, seed=0):
    """Rays from cameras 2.5 from the origin toward points near it."""
    gen = torch.Generator().manual_seed(seed)
    o = torch.randn((n, 3), generator=gen)
    o = o / o.norm(dim=-1, keepdim=True) * 2.5
    d = torch.randn((n, 3), generator=gen) * 0.3 - o
    return o, d / d.norm(dim=-1, keepdim=True)


def _np(*ts):
    return [jnp.asarray(t.detach().numpy()) for t in ts]


def _ref_spec_and_leaves(model):
    """The reference's sizes from the port model's config, and its leaves
    from the port's parameters."""
    spec = ref.Spec(obj_to_dict(model.fg_model.cfgs.model))
    params = dict(model.named_parameters())
    return spec, {k: params[name].detach().clone() for k, name in port_volsdf.names(spec).items()}


# ------------------------------------------------------------- the pieces

def test_freq_embedder_matches_jax_and_the_reference():
    from arcnerf_tpu.models.base_modules.encoding import FreqEmbedder as JaxFreq
    from arcnerf_torch.models.base_modules import build_encoder

    x = torch.rand((50, 3), generator=torch.Generator().manual_seed(1)) * 4 - 2
    for cfg in ({"type": "FreqEmbedder", "input_dim": 3, "n_freqs": 6}, {"n_freqs": 4, "log_sampling": False},
                {"n_freqs": 3, "include_input": False}, None):
        enc = build_encoder(cfg)
        kwargs = {k: v for k, v in (cfg or {"n_freqs": 0}).items() if k != "type"}
        want = np.asarray(JaxFreq(**kwargs).apply({}, jnp.asarray(x.numpy())))
        got = enc(x)
        assert enc.out_dim == want.shape[1]
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-6)
    torch.testing.assert_close(build_encoder({"n_freqs": 6})(x), ref.encode(x, 6), rtol=0, atol=0)


def test_radiance_net_matches_jax_and_the_reference(models):
    # the port's RadianceNet against the JAX one (identity encoders, the JAX
    # form) and, with the view on 4 frequencies, against the reference
    from arcnerf_torch.models import build_model

    model_j, params, model = models
    gen = torch.Generator().manual_seed(2)
    n = 40
    x, v, nrm = (torch.randn((n, 3), generator=gen) for _ in range(3))
    feat = torch.randn((n, 128), generator=gen)
    want = model_j.apply({"params": params}, *_np(x, v, nrm, feat),
                         method=lambda m, *a: m.fg_model.radiance_net(*a))
    got = model.fg_model.radiance_net(x, v, nrm, feat)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=0, atol=2e-6)

    encoded = build_model(update_configs_by_dotlist(load_configs(CFG), SMALL + ["--device", "cpu"]))
    assert encoded.fg_model.radiance_net.fc_0.shape[0] == 3 + 27 + 3 + 128
    spec, leaves = _ref_spec_and_leaves(encoded)
    want = ref.radiance(spec, leaves, x, v, nrm, feat)
    torch.testing.assert_close(encoded.fg_model.radiance_net(x, v, nrm, feat), want, rtol=0, atol=2e-6)


def test_sphere_bound_near_far_match_jax_and_the_reference(models):
    from arcnerf_tpu.models.base_modules.obj_bound import build_obj_bound as jax_build_obj_bound
    from arcnerf_tpu.utils.cfgs import dict_to_obj as jax_dict_to_obj
    from arcnerf_torch.models.base_modules.obj_bound import SphereBound

    _, _, model = models
    bound = model.fg_model.get_obj_bound()
    assert isinstance(bound, SphereBound) and bound.radius == 1.5
    o, d = _rays()
    o[:5] = torch.tensor([0.0, 3.0, 0.0])  # five rays that miss
    d[:5] = torch.tensor([1.0, 0.0, 0.0])
    near, far, hit = bound.get_near_far_from_rays({}, {"rays_o": o, "rays_d": d})
    jb, _ = jax_build_obj_bound(jax_dict_to_obj({"obj_bound": {"sphere": {"radius": 1.5}}}))
    nj, fj, hj = jb.get_near_far_from_rays({}, dict(zip(("rays_o", "rays_d"), _np(o, d))))
    np.testing.assert_allclose(near.numpy(), np.asarray(nj), rtol=0, atol=1e-6)
    np.testing.assert_allclose(far.numpy(), np.asarray(fj), rtol=0, atol=1e-6)
    assert np.array_equal(hit.numpy(), np.asarray(hj)) and not hit[:5].any() and hit[5:].all()
    spec = types.SimpleNamespace(radius=1.5)
    rn, rf = ref.sphere_chord(spec, o[5:], d[5:])
    torch.testing.assert_close(near[5:], rn, rtol=0, atol=2e-6)
    torch.testing.assert_close(far[5:], rf, rtol=0, atol=2e-6)


def _sdf_grid(seed, n_rays=64, n_pts=40):
    gen = torch.Generator().manual_seed(seed)
    z = torch.sort(torch.rand((n_rays, n_pts), generator=gen) * 4 + 0.5, -1).values
    sdf = torch.cumsum(torch.randn((n_rays, n_pts), generator=gen) * 0.05, -1) + 0.3 - 0.2 * (z - 2.5).abs()
    return z, sdf


def test_density_d_star_and_error_bound_match_jax_and_the_reference():
    from arcnerf_tpu.models import volsdf_model as jv
    from arcnerf_torch.models import volsdf_model as pv

    z, sdf = _sdf_grid(3)
    zj, sj = _np(z, sdf)
    beta = torch.full((64, 1), 0.05)
    spec = types.SimpleNamespace(beta_min=1e-4)
    sigma = pv.sdf_to_sigma(sdf, beta, 1e-4)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jv.sdf_to_sigma(sj, 0.05, 1e-4)), rtol=1e-5, atol=1e-7)
    torch.testing.assert_close(sigma, ref.density(spec, sdf, beta), rtol=1e-5, atol=1e-7)
    dists = z[:, 1:] - z[:, :-1]
    ds = pv.get_d_star(dists, sdf)
    assert 0 < int((ds > 0).sum()) < ds.numel()
    np.testing.assert_allclose(ds.numpy(), np.asarray(jv.VolSDF.get_d_star(zj, sj)), rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(ds, ref.d_star(z, sdf), rtol=1e-6, atol=1e-7)
    stand_in = types.SimpleNamespace(beta_min=1e-4)
    stand_in.get_integral_bound = lambda *a: jv.VolSDF.get_integral_bound(stand_in, *a)
    for b in (0.01, 0.05, 0.3):
        got = pv.get_error_bound(torch.full((64, 1), b), sdf, dists, ds, 1e-4)
        want = jv.VolSDF.get_error_bound(stand_in, b, sj, zj, jnp.asarray(ds.numpy()))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=1e-7)
        torch.testing.assert_close(got, ref.largest_bound(spec, z, sdf, ds, torch.full((64, 1), b)), rtol=2e-5,
                                   atol=1e-7)


def test_sample_pdf_matches_jax_and_the_reference():
    from arcnerf_tpu.render.ray_helper import sample_pdf as jax_sample_pdf
    from arcnerf_torch.render.ray_helper import sample_pdf

    z, _ = _sdf_grid(4)
    w = torch.rand((64, 39), generator=torch.Generator().manual_seed(5)) + 0.05  # no bin under eps: no flip at u = 1
    got = sample_pdf(z, w, 32, det=True)
    # 1e-5: a few ulps of the cdf's sums and of the evenly spaced u, over bins ~0.1 wide
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_sample_pdf(*_np(z, w), 32, det=True)), rtol=0, atol=1e-5)
    torch.testing.assert_close(got, ref.inverse_cdf(z, w, 32), rtol=0, atol=1e-5)
    gen = torch.Generator().manual_seed(6)
    drawn = sample_pdf(z, w, 32, generator=gen)
    u = torch.rand((64, 32), generator=torch.Generator().manual_seed(6))
    torch.testing.assert_close(drawn, ref.inverse_cdf(z, w, 32, u=u), rtol=0, atol=1e-5)
    assert (drawn[:, 1:] >= drawn[:, :-1]).all() and (drawn >= z[:, :1]).all() and (drawn <= z[:, -1:]).all()


def test_sampler_matches_jax(models):
    # Algorithm 1 at inference (every u evenly spaced): the samples and the
    # surface sample against the JAX upsample_zvals, which re-evaluates every
    # point each round where the port carries each point's sdf
    model_j, params, model = models
    o, d = _rays(80, 8)
    near, far, _ = model.fg_model.get_obj_bound().get_near_far_from_rays({}, {"rays_o": o, "rays_d": d})
    z0 = near + (far - near) * torch.linspace(0, 1, 16)
    with torch.no_grad():
        z, surface = model.fg_model.upsample_zvals(o, d, z0, inference_only=True)
    f = jax.jit(lambda p, *a: model_j.apply({"params": p}, *a, True,
                                           method=lambda m, *b: m.fg_model.upsample_zvals(*b)))
    zj, surf_j, _ = f(params, *_np(o, d, z0))
    assert z.shape == (80, 24)
    np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=0, atol=2e-5)
    np.testing.assert_allclose(surface.numpy(), np.asarray(surf_j), rtol=0, atol=2e-5)


def test_render_matches_jax_volsdf(models):
    model_j, params, model = models
    o, d = _rays(64, 9)
    feed = {"rays_o": o[None], "rays_d": d[None]}
    out_j = jax.jit(lambda p, f: model_j.apply({"params": p}, f, inference_only=True, bound_state={}))(
        params, {k: jnp.asarray(v.numpy()) for k, v in feed.items()})
    with torch.inference_mode():
        out = model(feed, inference_only=True, bound_state={})
    for k in ("rgb", "depth", "mask", "normal"):
        np.testing.assert_allclose(out[k][0].numpy(), np.asarray(out_j[k][0]), rtol=0, atol=2e-5, err_msg=k)
    assert 0.05 < float(out["mask"].mean()) <= 1.0 + 1e-5


def test_loss_gradients_match_jax(models):
    # the step's terms on given points: the GeoNet's sdf, feature and normal
    # (the autograd chain with create_graph), the radiance net on them, the
    # density with the learned beta and the eikonal loss; each leaf's
    # gradient against jax.grad of the same loss, within 1e-5 of its largest
    from arcnerf_tpu.models import volsdf_model as jv
    from arcnerf_tpu.models.sdf_model import geo_with_grad as jax_geo_with_grad
    from arcnerf_torch.models import volsdf_model as pv
    from arcnerf_torch.models.sdf_model import geo_with_grad

    model_j, params, model = models
    rng = np.random.default_rng(13)
    n = 300
    pts = rng.uniform(-1.2, 1.2, size=(n, 3)).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    c_rgb, c_sigma = rng.normal(size=(n, 3)).astype(np.float32), rng.normal(size=n).astype(np.float32)

    def jax_loss(p):
        def terms(m):
            fg = m.fg_model
            sdf, feat, normal = jax_geo_with_grad(fg.geo_net, jnp.asarray(pts))
            rgb = fg.radiance_net(jnp.asarray(pts), jnp.asarray(dirs), normal, feat)
            sigma = jv.sdf_to_sigma(sdf[:, 0], fg.forward_beta(), fg.beta_min)
            eikonal = jnp.mean((jnp.linalg.norm(normal, axis=-1) - 1.0) ** 2)
            return (rgb * c_rgb).sum() + (sigma * c_sigma).sum() * 1e-3 + 0.1 * eikonal

        return model_j.apply({"params": p}, method=terms)

    want, _ = state_from_jax(jax.tree_util.tree_map(np.asarray, jax.grad(jax_loss)(params)), {})
    fg = model.fg_model
    model.zero_grad()
    sdf, feat, normal = geo_with_grad(fg.geo_net, torch.from_numpy(pts), create_graph=True)
    rgb = fg.radiance_net(torch.from_numpy(pts), torch.from_numpy(dirs), normal, feat)
    sigma = pv.sdf_to_sigma(sdf[:, 0], fg.forward_beta(), fg.beta_min)
    eikonal = ((normal.norm(dim=-1) - 1.0) ** 2).mean()
    loss = (rgb * torch.from_numpy(c_rgb)).sum() + (sigma * torch.from_numpy(c_sigma)).sum() * 1e-3 + 0.1 * eikonal
    loss.backward()
    got = {name: p.grad for name, p in model.named_parameters()}
    assert set(got) == set(want)
    for name, grad in got.items():
        w = want[name]
        assert float(w.abs().max()) > 0, name
        torch.testing.assert_close(grad, w, rtol=0, atol=1e-5 * float(w.abs().max()), msg=name)


# ------------------------------------------------ training and the reference

@pytest.fixture(scope="module")
def rehearsal():
    """The benchmark cell's rehearsal sizes: its tree, views and seeded
    weights, and a trainer holding them."""
    _, _, config, workload = run.load_cell("train_volsdf", rehearse=True)
    tree = dict(config["run"])
    tree["progress"] = dict(tree["progress"], scan_steps=1, epoch=10**9)
    spec = ref.Spec(tree["model"])
    views, _ = traffic.training_views(workload["traffic"]["views"], 4000000021, "cpu")
    leaves = train_volsdf.weights(spec, 4000000021, "cpu")
    gen = torch.Generator().manual_seed(3)
    for k, v in leaves.items():  # off the init's special values
        leaves[k] = v + 0.05 * torch.randn(v.shape, generator=gen) * max(float(v.std()) if v.numel() > 1 else 0.1, 0.05)
    t = port_volsdf.trainer(tree, "cpu", 17, tempfile.mkdtemp(), views, leaves, spec)
    return {"spec": spec, "views": views, "leaves": leaves, "trainer": t, "tree": tree}


def test_training_step_matches_the_reference(rehearsal):
    # one eager step of the program's trainer (its draws from its generator)
    # against the reference's step on the same draws: the samples bit for bit
    # (the reference computes the sampler in the program's order and batches:
    # its decisions flip on rounding), the loss within 1e-5, each leaf's
    # gradient within 1e-4 of its norm (sums in other orders), Adam's change
    # of each leaf's norm within 1e-4
    t, spec = rehearsal["trainer"], rehearsal["spec"]
    seed, n_rays = 23, 64
    t.generator.manual_seed(seed)
    named = port_volsdf.leaves_of(t.model, spec)
    t.pipeline.n_rays = n_rays
    seen = []
    stop = port_volsdf.watch_samples(t, seen.append)
    try:
        stats = t.train_steps(0, 1)
    finally:
        stop()
    grads = {k: t.optimizer.state[p]["exp_avg"] / 0.1 for k, p in named.items()}
    pool = {k: torch.cat([torch.from_numpy(v[k]) for v in rehearsal["views"]]) for k in ("img", "rays_o", "rays_d")}
    optim = rehearsal["tree"]["optim"]
    losses, first, after, zs = ref.train_steps(spec, rehearsal["leaves"], pool, torch.Generator().manual_seed(seed),
                                               n_rays, 1, optim["lr"], optim["eps"])
    assert seen[0].shape == zs[0].shape == (n_rays, spec.n_sample + spec.n_importance)
    assert torch.equal(seen[0], zs[0])
    assert math.isclose(float(stats["loss"]), losses[0], rel_tol=1e-5)
    assert set(first) == set(port_volsdf.names(spec))
    for k, g in first.items():
        assert float(g.norm()) > 0, k
        assert float((grads[k] - g).norm()) <= 1e-4 * float(g.norm()), k
    for k, p in named.items():
        got, want = p.detach() - rehearsal["leaves"][k], after[k] - rehearsal["leaves"][k]
        assert abs(float(got.norm()) - float(want.norm())) <= 1e-4 * float(want.norm()), k


def _trainer(tmp_path, name, scan, extra=()):
    from arcnerf_torch.trainer import ArcNerfTrainer

    return ArcNerfTrainer(update_configs_by_dotlist(load_configs(CFG), TINY + list(extra) + [
        "--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps", str(scan)]))


TINY = SMALL + ["--device", "cpu", "--progress.epoch", "12", "--progress.epoch_loss", "6", "--progress.epoch_val", "12",
                "--progress.epoch_save_checkpoint", "-1", "--dataset.train.n_imgs", "3", "--dataset.train.wh",
                "[16,16]", "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]", "--n_rays", "64",
                "--model.geometry.W", "64", "--model.geometry.W_feat", "64", "--model.radiance.W", "32",
                "--model.radiance.W_feat_in", "64", "--model.obj_bound.sphere.radius", "2.0"]


def test_strided_volsdf_steps_are_the_eager_steps(tmp_path):
    # the static-buffer step (a CUDA graph on the card) on the CPU, stride
    # 4, against one eager step a call: the same losses and leaves bit for
    # bit, beta learned in both
    eager, strided = _trainer(tmp_path, "e", 1), _trainer(tmp_path, "s", 4)
    beta0 = float(eager.model.fg_model.forward_beta().detach())
    for e in range(8):
        eager.train_steps(e, 1)
    for e in range(0, 8, 4):
        strided.train_steps(e, 4)
    assert torch.equal(torch.stack(eager.loss_history), torch.stack(strided.loss_history))
    params = dict(strided.model.named_parameters())
    for name, p in eager.model.named_parameters():
        assert torch.equal(p, params[name]), name
    assert float(eager.model.fg_model.forward_beta().detach()) != beta0


def test_train_entry_trains_synthetic_volsdf_and_renders_it(tmp_path):
    # python -m arcnerf_torch.train on synthetic_volsdf.yaml at a tiny size:
    # finite losses, a validation render with normals, the final checkpoint
    from arcnerf_torch import train

    trainer = train.main(["--configs", CFG, "--dir.expr_dir", str(tmp_path / "volsdf")] + TINY)
    losses = torch.stack(trainer.loss_history)
    assert losses.shape == (12,) and torch.isfinite(losses).all()
    assert os.path.exists(tmp_path / "volsdf" / "checkpoints" / "final.pt")
    out = trainer.render_image(trainer.data["val"][0])
    assert set(out) >= {"rgb", "depth", "mask", "normal"} and all(torch.isfinite(v).all() for v in out.values())


def test_spans_and_counters_fire(tmp_path):
    # tracing on: model.error_bound (iters) inside model.sample and
    # model.sdf_density in each eager step; volsdf.eval_pts and
    # sdf.normal_pts counted outside the step, n_eval n_iter and n_sample +
    # n_importance + 2 a ray and step; an inference call counts its own
    from arcnerf_torch.utils import profiler

    t = _trainer(tmp_path, "t", 4)
    n_rays, fg = 64, t.model.fg_model
    profiler.enable()
    try:
        t.train_steps(0, 1)
        t.train_steps(1, 4)
        with torch.inference_mode():
            t.model({"rays_o": torch.zeros((1, 32, 3)) + torch.tensor([0.0, 0.0, 2.5]),
                     "rays_d": torch.zeros((1, 32, 3)) + torch.tensor([0.0, 0.0, -1.0])}, inference_only=True,
                    bound_state=t.bound_state)
        record = profiler.collect()
    finally:
        profiler.disable()
    steps = 5  # one eager step, then a stride of 4 (static-buffer steps on the CPU)
    c = record["counters"]
    assert c["volsdf.eval_pts"] == (steps * n_rays + 32) * fg.n_eval * fg.n_iter
    assert c["sdf.normal_pts"] == steps * n_rays * (fg.n_samples() + 2) + 32 * fg.n_samples()
    spans = record["spans"]
    bounds = [s for s in spans if s["name"] == "model.error_bound"]
    assert len(bounds) == steps + 1 and all(s["attrs"] == {"iters": fg.n_iter} for s in bounds)
    assert all(spans[s["parent"]]["name"] == "model.sample" for s in bounds)
    assert sum(s["name"] == "model.sdf_density" for s in spans) == steps + 1


def test_the_lego_recipe_trains_on_the_port(tmp_path):
    # configs/expr/NeRF/lego/nerf_lego_volsdf.yaml through the trainer's
    # strided steps, its dataset swapped for procedural views over white (the
    # recipe's blend_bkg_color augmentation is not ported) and its sizes cut
    # for the CPU: finite losses, the recipe's sampler and losses
    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.utils.cfgs import dict_to_obj

    cfgs = load_configs(os.path.join(ROOT, "configs/expr/NeRF/lego/nerf_lego_volsdf.yaml"))
    assert (cfgs.model.type, cfgs.model.geometry.W, cfgs.model.geometry.D, cfgs.model.radiance.W) == ("VolSDF", 256,
                                                                                                       8, 256)
    cfgs.dataset = dict_to_obj({"train": {"type": "Synthetic", "n_imgs": 2, "wh": [16, 16], "cam_radius": 2.5,
                                          "white_bkg": True, "center_pixel": True,
                                          "scheduler": {"ray_sample": {"mode": "random", "cross_view": True}}}})
    cfgs = update_configs_by_dotlist(cfgs, ["--device", "cpu", "--dir.expr_dir", str(tmp_path), "--n_rays", "32",
                                            "--progress.scan_steps", "4", "--model.geometry.W", "64",
                                            "--model.geometry.W_feat", "64", "--model.radiance.W", "32",
                                            "--model.radiance.W_feat_in", "64", "--model.rays.n_eval", "16",
                                            "--model.rays.n_sample", "8", "--model.rays.n_importance", "4"])
    t = ArcNerfTrainer(cfgs)
    assert set(t.loss_factory.losses) == {"ImgLoss", "EikonalLoss"} and t.model.fg_model.n_iter == 5
    t.train_steps(0, 4)
    assert torch.isfinite(torch.stack(t.loss_history)).all() and len(t.loss_history) == 4
