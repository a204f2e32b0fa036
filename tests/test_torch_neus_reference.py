"""The port's NeuS-NGP against the benchmark's plain reference
(``bench_torch/reference/neus.py``, plain PyTorch that shares no code with
the program), on the CPU at the benchmark rehearsal's tiny sizes, seeded
weights: the render (rgb, depth, opacity), the normals, one training
step's loss and every leaf's gradient (``inv_s`` included), and the
AdamW step with its EMA. The reference runs at the precision the
configuration states (bf16 table reads and radiance operands), as the
program on the CPU does through the kernels' plain versions."""

import math
import tempfile

import pytest
import torch

from bench_torch import port_neus, run, scene, traffic
from bench_torch.drivers import train_neus
from bench_torch.reference import neus

torch.set_num_threads(2)
SEED = 4000000011


@pytest.fixture(scope="module")
def setup():
    _, _, config, workload = run.load_cell("train_neus_ngp", rehearse=True)
    tree = dict(config["run"])
    p = train_neus.rehearsal_traffic(workload["traffic"])
    model = tree["model"]
    spec = neus.Spec(model)
    views, held = traffic.training_views(p["views"], SEED, "cpu")
    # seeded weights with a surface to render: every leaf N(0, 1 / fan-in),
    # the table uniform in +-0.5, the weight-norm scales in [0.5, 1.5]
    gen = torch.Generator().manual_seed(SEED)
    leaves = {}
    for k, shape in train_neus.leaf_shapes(model).items():
        if k == "table":
            leaves[k] = torch.rand(shape, generator=gen) - 0.5
        elif k.endswith(".wn"):
            leaves[k] = torch.rand(shape, generator=gen) + 0.5
        elif k == "inv_s":
            leaves[k] = torch.full(shape, 0.3)
        else:
            leaves[k] = torch.randn(shape, generator=gen) / math.sqrt(shape[0])
    bits = scene.bitfield(spec.n_grid, spec.side)
    tree["progress"] = dict(tree["progress"], scan_steps=1, epoch=10**9)
    trainer = port_neus.trainer(tree, "cpu", 17, tempfile.mkdtemp(), views, leaves)
    trainer.bound_state["fg"]["bitfield"].copy_(bits)
    return {"spec": spec, "views": views, "held": held, "leaves": leaves, "bits": bits, "trainer": trainer,
            "tree": tree}


def test_render_and_normals_match_the_reference(setup):
    # the held-out view at inference: opacity within 2e-5 (f32 sums in
    # other orders); colour within 2e-3, 1e-4 on average: the radiance MLP
    # rounds its operands to bf16 in both, and a normal an ulp apart in f32
    # can round to the neighbouring bf16 value
    t, spec = setup["trainer"], setup["spec"]
    held = setup["held"]
    bkg = torch.ones(3)
    with torch.no_grad():
        out = t.model({"rays_o": held["rays_o"][None], "rays_d": held["rays_d"][None]}, inference_only=True,
                      bound_state=t.bound_state)
    rgb, depth, opacity, _ = neus.render_rays(spec, setup["leaves"], setup["bits"], held["rays_o"], held["rays_d"],
                                              bkg.expand(held["rays_o"].shape[0], 3), budget=spec.budget,
                                              prec=neus.STATED, create_graph=False)
    assert 0.05 < float(opacity.detach().mean()) < 0.95
    torch.testing.assert_close(out["mask"][0], opacity, rtol=0, atol=2e-5)
    # the program composites white as 1 - opacity (white_bkg), the reference with the last T
    torch.testing.assert_close(out["rgb"][0], rgb, rtol=0, atol=2e-3)
    assert float((out["rgb"][0] - rgb).detach().abs().mean()) < 1e-4
    has = opacity > 0
    torch.testing.assert_close(out["depth"][0][has], depth[has], rtol=1e-5, atol=1e-5)
    from arcnerf_torch.models.sdf_model import geo_with_grad

    pts = torch.rand((300, 3), generator=torch.Generator().manual_seed(1)) * 1.8 - 0.9
    sdf, _, normal = geo_with_grad(t.model.fg_model.geo_net, pts)
    sdf_r, _, normal_r = neus.sdf_normal(spec, setup["leaves"], pts, create_graph=False, prec=neus.STATED)
    torch.testing.assert_close(sdf[:, 0], sdf_r.detach(), rtol=0, atol=1e-6)
    torch.testing.assert_close(normal, normal_r, rtol=0, atol=1e-5 * float(normal_r.abs().max()))


def test_step_loss_gradients_adamw_and_ema_match_the_reference(setup):
    # one eager step of the program's trainer (its draws from its
    # generator) against the reference's step on the same draws: the loss
    # within 1e-5; each leaf's gradient within 1e-3 of its norm (sums in
    # other orders, the table's scattered; the radiance MLP's within 1e-2:
    # its backward, kernel D's plain version, takes bf16 operands where the
    # reference passes the gradient straight through); AdamW's change of
    # each leaf and the EMA's move: the norms within 1e-4, and at most 1 %
    # of the entries moved the other way (Adam's first step is lr sign(g),
    # so a gradient entry at rounding level may flip)
    t, spec = setup["trainer"], setup["spec"]
    seed = 23
    t.generator.manual_seed(seed)
    named = port_neus.leaves_of(t.model)
    t.pipeline.n_rays = 256
    stats = t.train_steps(0, 1)
    grads = {k: t.optimizer.state[p]["exp_avg"] / 0.1 for k, p in named.items()}
    pool = {k: torch.cat([torch.from_numpy(v[k]) for v in setup["views"]]) for k in ("img", "mask", "rays_o",
                                                                                      "rays_d")}
    optim = setup["tree"]["optim"]
    losses, first, after, shadow = neus.train_steps(spec, setup["leaves"], pool, setup["bits"],
                                                    torch.Generator().manual_seed(seed), 256, 1, optim["lr"],
                                                    optim["eps"], optim["weight_decay"], optim["ema_decay"],
                                                    neus.STATED)
    assert math.isclose(float(stats["loss"]), losses[0], rel_tol=1e-5)
    assert set(first) == set(port_neus.NAMES)
    for k, g in first.items():
        assert float(g.norm()) > 0, k
        tol = 1e-2 if k.startswith("rad.") else 1e-3
        assert float((grads[k] - g).norm()) <= tol * float(g.norm()), k
    ema = port_neus.ema_of(t)
    for k, p in named.items():
        for got, want in ((p.detach() - setup["leaves"][k], after[k] - setup["leaves"][k]),
                          (ema[k] - 0.05 * setup["leaves"][k], shadow[k] - 0.05 * setup["leaves"][k])):
            assert abs(float(got.norm()) - float(want.norm())) <= 1e-4 * float(want.norm()) + 1e-9, k
            assert float((torch.sign(got) != torch.sign(want)).float().mean()) <= 0.01, k


def test_occupancy_update_matches_the_reference(setup):
    # the post-warm-up occupancy update from one draw seed: the program
    # estimates at the reference's points bit for bit (NeuS's normal jumps
    # at the hash cells' faces, so an ulp would move an estimate), and the
    # opacities outside the given grid within 1e-7 (alpha ~1e-2 here from
    # cdf differences near 0.5, whose f32 ulps are 6e-8)
    t, spec = setup["trainer"], setup["spec"]
    fg = t.bound_state["fg"]
    saved = {k: v.clone() for k, v in fg.items()}
    bits = setup["bits"]
    opa0 = bits.to(torch.float32) * train_neus.SCENE_OPACITY
    seed = 29
    try:
        fg["bitfield"].copy_(bits)
        fg["opafield"].copy_(opa0)
        t.generator.manual_seed(seed)
        seen = []
        stop = port_neus.watch_occupancy(t, seen.append)
        try:
            every, warm = t.epoch_optim, t.epoch_optim_warmup or 0
            t.run_optimize(-(-max(warm, 1) // every) * every)
        finally:
            stop()
        got_opa, got_bits = fg["opafield"].clone(), fg["bitfield"].clone()
    finally:
        for k, v in saved.items():
            fg[k].copy_(v)
    idx, pts = neus.occupancy_points(spec, bits, torch.Generator().manual_seed(seed))
    assert torch.equal(torch.cat(seen), pts)
    # the weights as the program holds them (another test may have stepped them)
    leaves = {k: p.detach().clone() for k, p in port_neus.leaves_of(t.model).items()}
    opa, want_bits = neus.occupancy_update(spec, leaves, opa0, bits, torch.Generator().manual_seed(seed),
                                           prec=neus.STATED)
    outside = ~bits
    assert bool((opa[outside] != 0).any())
    torch.testing.assert_close(got_opa[outside], opa[outside], rtol=1e-3, atol=1e-7)
    assert torch.equal(got_bits, want_bits)
