"""NeuS-NGP's geometry chain as one explicit first-order computation
(``arcnerf_torch/ops/geo_chain.py``; kernels M and N on the card) on the
CPU: the plain versions against autograd's create-graph double backward of
the recipe's GeoNet, across the softplus threshold; the rows past a kept
count; ``geo_with_grad``'s dispatch on the net's shape and its counters;
and the fused path against the autograd path on a Neus model (sdf,
feature, normal, and every leaf's gradient of the NeuS loss)."""

import os

import pytest
import torch

from arcnerf_torch.models import sdf_model
from arcnerf_torch.ops import geo_chain
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(ROOT, "configs/expr/synthetic_neus_ngp.yaml")
# the recipe's widths (16 levels x 2 features: the chain's 32 inputs) over a small table and grid
SMALL = ["--model.geometry.encoder.hashmap_size", "12", "--model.obj_bound.volume.n_grid", "16",
         "--model.rays.n_sample", "32", "--model.obj_bound.log_max_allowance", "14", "--device", "cpu"]
BETA = 100.0


def recipe_cfgs(extra=()):
    return update_configs_by_dotlist(load_configs(CFG), SMALL + list(extra))


def geo_net(extra=(), seed=0):
    from arcnerf_torch.models.base_modules import build_geo_model

    return build_geo_model(recipe_cfgs(extra).model.geometry, torch.Generator().manual_seed(seed))


def chain_inputs(regime, dtype, n=200, seed=0):
    """The recipe's GeoNet in ``dtype`` (weight norm, scales drawn in [0.5,
    1.5]) and rows whose 100 z fall in ``regime``: below -20, near 0, above
    20 (the threshold branch), or spread over all three."""
    gen = torch.Generator().manual_seed(seed)
    net = geo_net(seed=seed).to(dtype)
    with torch.no_grad():
        net.fc_0.copy_(torch.randn(net.fc_0.shape, generator=gen, dtype=dtype))
        net.fc_1.copy_(torch.randn(net.fc_1.shape, generator=gen, dtype=dtype))
        for p in (net.wn_0, net.wn_1):
            p.copy_(torch.rand(p.shape, generator=gen, dtype=dtype) + 0.5)
        if regime != "mixed":  # every z of a row the row's sign: positive W1 columns, rows of one sign
            net.fc_0.abs_()
    enc = torch.rand((n, 32), generator=gen, dtype=dtype) * 0.4 + 0.1
    if regime == "below":
        enc = -enc
    elif regime == "near":
        enc = enc * 1e-4
    elif regime == "mixed":
        enc = torch.randn((n, 32), generator=gen, dtype=dtype) * 0.3
    return net, enc


REGIMES = ["below", "near", "above", "mixed"]


@pytest.mark.parametrize("regime", REGIMES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plain_chain_is_autograds_double_backward(regime, dtype):
    # out, g, then d_enc, dW1, dW2 for random (d_out, d_g), against autograd
    # with create_graph through the GeoNet's own softplus: f64 within 1e-10
    # of the largest value (the algebra), f32 within 1e-5 (rounding in
    # another order)
    net, enc = chain_inputs(regime, dtype)
    y = 100.0 * (enc @ net.layer_weight(0)).detach()
    share = {"below": (y < -20).double().mean(), "near": (y.abs() < 1).double().mean(),
             "above": (y > 20).double().mean(), "mixed": ((y < -20).any() & (y > 20).any() & (y.abs() < 20).any())}
    assert float(share[regime]) > 0.9, regime
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    gen = torch.Generator().manual_seed(7)
    d_out = torch.randn((enc.shape[0], 17), generator=gen, dtype=dtype)
    d_g = torch.randn((enc.shape[0], 32), generator=gen, dtype=dtype)
    w1, w2 = net.layer_weight(0).detach().requires_grad_(True), net.layer_weight(1).detach().requires_grad_(True)
    x = enc.clone().requires_grad_(True)
    h = net.act(x @ w1) @ w2
    (g,) = torch.autograd.grad(h[:, :1], x, torch.ones_like(h[:, :1]), create_graph=True)
    want = [h, g] + list(torch.autograd.grad([h, g], [x, w1, w2], [d_out, d_g]))
    got = list(geo_chain.geo_chain_fwd_reference(enc, w1.detach(), w2.detach(), BETA))
    got += list(geo_chain.geo_chain_bwd_reference(enc, w1.detach(), w2.detach(), d_out, d_g, BETA))
    for name, a, b in zip(["out", "g", "d_enc", "dW1", "dW2"], got, want):
        torch.testing.assert_close(a, b.detach(), rtol=0, atol=tol * float(b.detach().abs().max()) + 1e-30, msg=name)


@pytest.mark.parametrize("n_rows", [0, 1, 37, 200])
def test_rows_past_the_kept_count_are_zero_and_add_nothing(n_rows):
    # the kept rows are the chain of those rows alone, the rest read 0, and
    # the weights' gradients are those of the kept rows (1e-6 of the
    # largest value: a product of fewer rows may take another BLAS path)
    net, enc = chain_inputs("mixed", torch.float32, seed=3)
    w1, w2 = net.layer_weight(0).detach(), net.layer_weight(1).detach()
    gen = torch.Generator().manual_seed(4)
    d_out, d_g = torch.randn((200, 17), generator=gen), torch.randn((200, 32), generator=gen)
    count = torch.tensor(n_rows)
    out, g = geo_chain.geo_chain_fwd(enc, w1, w2, BETA, count)
    d_enc, dw1, dw2 = geo_chain.geo_chain_bwd(enc, w1, w2, d_out, d_g, BETA, count)
    k_out, k_g = geo_chain.geo_chain_fwd(enc[:n_rows], w1, w2, BETA)
    k_enc, k_w1, k_w2 = geo_chain.geo_chain_bwd(enc[:n_rows], w1, w2, d_out[:n_rows], d_g[:n_rows], BETA)
    for a, b in ((out[:n_rows], k_out), (g[:n_rows], k_g), (d_enc[:n_rows], k_enc), (dw1, k_w1), (dw2, k_w2)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * (float(b.abs().max()) if b.numel() else 0))
    for a in (out, g, d_enc):
        assert not a[n_rows:].any()
    if n_rows == 0:
        assert not dw1.any() and not dw2.any()


def test_the_function_backward_is_the_plain_backward():
    # GeoChain's backward hands autograd the plain backward's gradients
    net, enc = chain_inputs("mixed", torch.float32, seed=5)
    w1, w2 = net.layer_weight(0).detach().requires_grad_(True), net.layer_weight(1).detach().requires_grad_(True)
    x = enc.clone().requires_grad_(True)
    out, g = geo_chain.geo_chain(x, w1, w2, BETA)
    gen = torch.Generator().manual_seed(6)
    d_out, d_g = torch.randn(out.shape, generator=gen), torch.randn(g.shape, generator=gen)
    ((out * d_out).sum() + (g * d_g).sum()).backward()
    want = geo_chain.geo_chain_bwd_reference(enc, w1.detach(), w2.detach(), d_out, d_g, BETA)
    for a, b in zip((x.grad, w1.grad, w2.grad), want):
        assert torch.equal(a, b)


# ------------------------------------------------------------ the dispatch

@pytest.mark.parametrize("extra,fused", [
    ((), True),
    (("--model.geometry.encoder.n_levels", "4"), False),  # 8 features
    (("--model.geometry.encoder.include_input", "True"), False),
    (("--model.geometry.use_bias", "True"), False),
    (("--model.geometry.act_cfg.type", "relu"), False),
    (("--model.geometry.W", "128"), False),
    (("--model.geometry.D", "2"), False),
    (("--model.geometry.W_feat", "15"), False),
])
def test_the_chain_fuses_only_for_the_kernels_shape(extra, fused):
    assert sdf_model.fuses_geo_chain(geo_net(extra)) is fused


def test_another_geonet_keeps_the_autograd_path_and_counts_nothing_fused(monkeypatch):
    # the recipe's model with a GeoNet of another shape (W 256, D 8, skips
    # [4], bias): the occupancy estimate takes the autograd path, counts
    # sdf.normal_pts and not sdf.geo_fused
    from arcnerf_torch.models import build_model

    cfgs = recipe_cfgs(["--model.geometry.W", "256", "--model.geometry.D", "8", "--model.geometry.skips", "[4]",
                        "--model.geometry.use_bias", "True"])
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0)).fg_model
    assert not sdf_model.fuses_geo_chain(model.geo_net)
    calls = []
    monkeypatch.setattr(geo_chain, "geo_chain", lambda *a, **k: calls.append(1))
    pts = torch.rand((50, 3), generator=torch.Generator().manual_seed(1)) * 1.6 - 0.8
    profiler.enable()
    try:
        alpha = model.get_est_opacity(0.05, pts)
        counters = profiler.collect()["counters"]
    finally:
        profiler.disable()
    assert not calls and alpha.shape == (50,) and torch.isfinite(alpha).all()
    assert counters["sdf.normal_pts"] == 50 and "sdf.geo_fused" not in counters


# ------------------------------------------------------- the model's paths

def neus_model(seed=0):
    from arcnerf_torch.models import build_model

    model = build_model(recipe_cfgs(), generator=torch.Generator().manual_seed(seed))
    fg = model.fg_model
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():  # a field that varies: table features of +-0.5, scales off 1
        enc = fg.geo_net.encoder
        enc.embeddings.copy_(torch.rand(enc.embeddings.shape, generator=gen) - 0.5)
        for p in (fg.geo_net.wn_0, fg.geo_net.wn_1):
            p.copy_(torch.rand(p.shape, generator=gen) + 0.5)
    return model


@pytest.mark.parametrize("create_graph", [False, True])
def test_fused_sdf_feature_and_normal_match_the_autograd_path(create_graph):
    # at random points, and with a kept count: the kept rows as the
    # autograd path gives them (f32 rounding in another order: 1e-5 of the
    # largest value), the rest 0
    fg = neus_model().fg_model
    assert sdf_model.fuses_geo_chain(fg.geo_net)
    pts = torch.rand((300, 3), generator=torch.Generator().manual_seed(2)) * 1.8 - 0.9
    want = sdf_model._autograd_with_grad(fg.geo_net, pts, create_graph)
    got = sdf_model.geo_with_grad(fg.geo_net, pts, create_graph)
    kept = sdf_model.geo_with_grad(fg.geo_net, pts, create_graph, n_rows=torch.tensor(120))
    for name, a, b, c in zip(("sdf", "feature", "normal"), got, want, kept):
        assert a.requires_grad is create_graph
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.detach().abs().max()), msg=name)
        assert torch.equal(c[:120], a[:120]) and not c[120:].any()


def _loss_grads(model, fused, monkeypatch):
    """Each leaf's gradient of the NeuS loss (image, mask and eikonal) on a
    training forward over the sphere scene's grid."""
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.losses import build_loss

    if not fused:
        monkeypatch.setattr(sdf_model, "fuses_geo_chain", lambda net: False)
    gen = torch.Generator().manual_seed(8)
    rays_o = torch.tensor([0.0, 0.0, 2.5]).expand(64, 3) + torch.randn((64, 3), generator=gen) * 0.05
    rays_d = torch.nn.functional.normalize(torch.randn((64, 3), generator=gen) * 0.15 +
                                           torch.tensor([0.0, 0.0, -1.0]), dim=-1)
    bound = {"fg": {"bitfield": torch.from_numpy(sphere_scene_bitfield(16, 2.0)),
                    "opafield": torch.zeros((16, 16, 16))}}
    inputs = {"rays_o": rays_o[None], "rays_d": rays_d[None], "img": torch.rand((1, 64, 3), generator=gen),
              "mask": (torch.rand((1, 64), generator=gen) > 0.5).float()}
    calls, apply = [], geo_chain.GeoChain.apply
    monkeypatch.setattr(geo_chain.GeoChain, "apply", lambda *a: calls.append(1) or apply(*a))
    model.zero_grad()
    out = model(inputs, inference_only=False, bound_state=bound, generator=torch.Generator().manual_seed(9))
    loss = build_loss(recipe_cfgs())(inputs, out)
    loss["sum"].backward()
    monkeypatch.undo()
    assert len(calls) == int(fused) and int(out["n_valid_pts"]) > 0 and float(loss["EikonalLoss"].detach()) > 0
    return float(loss["sum"].detach()), {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None}


def test_fused_neus_loss_gradients_match_the_autograd_path(monkeypatch):
    # one training forward and the NeuS loss's backward, the chain fused
    # (plain M and N) against autograd's double backward: the loss, and
    # every leaf (table, both layers and their scales, the radiance net,
    # inv_s) within 1e-5 of its largest value (f32 sums in another order,
    # carried through the table's two backward passes: ~1e-6 here)
    model = neus_model(4)
    loss_f, fused = _loss_grads(model, True, monkeypatch)
    loss_a, auto = _loss_grads(model, False, monkeypatch)
    assert set(fused) == set(auto) and len(auto) == len(list(model.parameters()))
    assert abs(loss_f - loss_a) <= 1e-6 * abs(loss_a)
    for name, want in auto.items():
        torch.testing.assert_close(fused[name], want, rtol=0, atol=1e-5 * float(want.abs().max()), msg=name)


def test_training_steps_count_every_kept_section_as_fused(tmp_path):
    # tracing on: sdf.geo_fused counts each step's kept sections and each
    # occupancy update's points, as sdf.normal_pts does
    from arcnerf_torch.trainer import ArcNerfTrainer

    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL[:-2] + [
        "--device", "cpu", "--dir.expr_dir", str(tmp_path), "--progress.epoch", "4", "--n_rays", "128",
        "--dataset.train.n_imgs", "2", "--dataset.train.wh", "[16,16]", "--dataset.val.n_imgs", "1",
        "--dataset.val.wh", "[16,16]", "--model.obj_bound.epoch_optim_warmup", "2",
        "--model.obj_bound.epoch_optim", "2"])
    trainer = ArcNerfTrainer(cfgs)
    profiler.enable()
    try:
        for epoch in range(4):
            trainer.train_steps(epoch, 1)
        counters = profiler.collect()["counters"]
    finally:
        profiler.disable()
    assert counters["sdf.geo_fused"] == counters["sdf.normal_pts"] > 0
