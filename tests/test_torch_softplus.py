"""The SDF nets' softplus as one pass a derivative order
(``arcnerf_torch/ops/softplus.py``; kernel P on the card) on the CPU: the
plain versions of the forward, backward and double backward against
autograd of the three-op form ``F.softplus(beta * x) / beta`` (element gaps
in f32), ``gradcheck`` and ``gradgradcheck`` of the Functions in f64, at
beta 100 and 1 on values whose beta x crosses the threshold 20 and reaches
-100; ``activation.softplus`` (its ``beta``, the three ops off the card);
``fuses_geo_chain`` on NeuS-NGP's GeoNet; a VolSDF GeoNet on the CPU equal
to the three-op form; the step's work counters."""

import os

import pytest
import torch
import torch.nn.functional as F

from arcnerf_torch.models import sdf_model
from arcnerf_torch.models.base_modules import activation, build_geo_model
from arcnerf_torch.ops import softplus as sp
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOLSDF = os.path.join(ROOT, "configs/expr/synthetic_volsdf.yaml")
NEUS_NGP = os.path.join(ROOT, "configs/expr/synthetic_neus_ngp.yaml")


def three_op(x, beta):
    return F.softplus(beta * x) / beta


def spread(beta, n, dtype, seed=0, margin=0.0):
    """n values whose beta x runs from -100 to 40 (across the threshold
    20), the ones within ``margin`` of the threshold left out."""
    gen = torch.Generator().manual_seed(seed)
    y = torch.rand(n, generator=gen, dtype=torch.float64) * 140.0 - 100.0
    if margin:
        y = torch.where((y - sp.THRESHOLD).abs() < margin, y - 2 * margin, y)
    return (y / beta).to(dtype)


def autograd_chain(x, d_out, gg, beta):
    """Autograd of the three-op form: (out, d_x, g_x, g_dout)."""
    x = x.detach().requires_grad_(True)
    d_out = d_out.detach().requires_grad_(True)
    out = three_op(x, beta)
    (d_x,) = torch.autograd.grad(out, x, d_out, create_graph=True)
    g_x, g_dout = torch.autograd.grad(d_x, (x, d_out), gg)
    return out.detach(), d_x.detach(), g_x, g_dout


@pytest.mark.parametrize("beta", [100.0, 1.0])
def test_plain_versions_match_autograd_of_the_three_ops(beta):
    # f32: the plain versions multiply by fl(1 / beta) where the CPU's
    # three ops divide, and exp / log1p round their own way, so values sit
    # within a few f32 ulps (2e-6 of each value, 1e-30 absolute near 0)
    n = 4096
    x = spread(beta, n, torch.float32)
    gen = torch.Generator().manual_seed(1)
    d_out = torch.randn(n, generator=gen)
    gg = torch.randn(n, generator=gen)
    out, d_x, g_x, g_dout = autograd_chain(x, d_out, gg, beta)
    got = (sp.softplus_fwd_reference(x, beta), sp.softplus_bwd_reference(x, d_out, beta))
    got += sp.softplus_bwd2_reference(x, d_out, gg, beta)
    for name, a, b in zip(("out", "d_x", "g_x", "g_dout"), got, (out, d_x, g_x, g_dout)):
        torch.testing.assert_close(a, b, rtol=2e-6, atol=1e-30, msg=name)
    over = x * beta > sp.THRESHOLD
    assert over.any() and (x * beta < -90).any()
    assert torch.equal(got[0][over], x[over] * beta * sp._inv(beta, x)) and not got[2][over].any()


@pytest.mark.parametrize("beta", [100.0, 1.0])
def test_the_functions_pass_gradcheck_and_gradgradcheck_in_f64(beta):
    # on the CPU the Functions run the plain versions; the threshold's jump
    # (2e-9 in softplus) is kept 0.05 of beta x away from the finite
    # differences
    x = spread(beta, 64, torch.float64, seed=2, margin=0.05).requires_grad_(True)
    assert (x * beta > sp.THRESHOLD).any() and (x * beta < -90).any()
    fn = lambda t: sp.Softplus.apply(t, beta)  # noqa: E731
    assert torch.autograd.gradcheck(fn, (x,))
    assert torch.autograd.gradgradcheck(fn, (x,))
    d_out = torch.randn(64, dtype=torch.float64, generator=torch.Generator().manual_seed(3), requires_grad=True)
    bwd = lambda t, d: sp.SoftplusBackward.apply(t, d, beta)  # noqa: E731
    assert torch.autograd.gradcheck(bwd, (x, d_out))


def test_the_function_is_the_three_ops_in_f64():
    # the derivatives through ``Softplus`` in f64 against autograd's:
    # first and second order within 1e-12 of each value
    beta = 100.0
    x = spread(beta, 512, torch.float64, seed=4)
    gen = torch.Generator().manual_seed(5)
    d_out, gg = torch.randn(512, generator=gen, dtype=torch.float64), torch.randn(512, generator=gen,
                                                                                  dtype=torch.float64)
    want = autograd_chain(x, d_out, gg, beta)
    xr, dr = x.clone().requires_grad_(True), d_out.clone().requires_grad_(True)
    out = sp.Softplus.apply(xr, beta)
    (d_x,) = torch.autograd.grad(out, xr, dr, create_graph=True)
    got = (out.detach(), d_x.detach()) + torch.autograd.grad(d_x, (xr, dr), gg)
    for name, a, b in zip(("out", "d_x", "g_x", "g_dout"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-300, msg=name)


def test_activation_softplus_carries_beta_and_keeps_the_three_ops_off_the_card():
    act = activation.softplus(100.0)
    assert act.beta == 100.0
    assert activation.get_activation({"type": "softplus", "beta": 100}).beta == 100.0
    launches = (sp.softplus_fwd.launches, sp.softplus_bwd.launches, sp.softplus_bwd2.launches)
    for dtype in (torch.float32, torch.float64):
        x = spread(100.0, 1000, dtype, seed=6)
        assert torch.equal(act(x), three_op(x, 100.0))
    assert (sp.softplus_fwd.launches, sp.softplus_bwd.launches, sp.softplus_bwd2.launches) == launches


def _cfgs(path, extra=()):
    return update_configs_by_dotlist(load_configs(path), list(extra))


def test_fuses_geo_chain_still_takes_neus_ngps_geonet():
    small = ["--model.geometry.encoder.hashmap_size", "12", "--model.obj_bound.volume.n_grid", "16"]
    net = build_geo_model(_cfgs(NEUS_NGP, small).model.geometry, torch.Generator().manual_seed(0))
    assert net.act.beta == 100.0 and sdf_model.fuses_geo_chain(net)


def test_a_volsdf_geonet_on_the_cpu_is_the_three_op_form():
    # sdf, feature and normal (with its create-graph backward) equal the
    # net with the three ops as its activation, bit for bit; no launch
    net = build_geo_model(_cfgs(VOLSDF).model.geometry, torch.Generator().manual_seed(0))
    pts = torch.rand((300, 3), generator=torch.Generator().manual_seed(1)) * 2.0 - 1.0
    launches = (sp.softplus_fwd.launches, sp.softplus_bwd.launches, sp.softplus_bwd2.launches)
    got = sdf_model.geo_with_grad(net, pts, create_graph=True)
    beta = net.act.beta
    net.act = lambda x: three_op(x, beta)
    want = sdf_model.geo_with_grad(net, pts, create_graph=True)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (sp.softplus_fwd.launches, sp.softplus_bwd.launches, sp.softplus_bwd2.launches) == launches


def test_the_fused_counter_reads_zero_off_the_card():
    # the step's work counts the sampler's sdf evaluations and the points
    # whose normals a step takes, and nothing else: kernel P's share shows
    # in the captured step's layer map, so no counter of its own remains
    from arcnerf_torch.models import build_model

    model = build_model(_cfgs(VOLSDF), generator=torch.Generator().manual_seed(0))
    fg = model.fg_model
    profiler.enable()
    try:
        fg.count_step_work(64, 2)
        counters = profiler.collect()["counters"]
    finally:
        profiler.disable()
    assert counters == {"volsdf.eval_pts": 64 * 2 * fg.n_eval * fg.n_iter,
                        "sdf.normal_pts": 64 * 2 * (fg.n_samples() + 2)}
