"""The port's render tiers vs the JAX package's RenderEngine (CPU), at the
small size of ``test_torch_slice.py`` on bridged params and the spheres'
bitfield: the hit and count prepasses, the fast, interactive and windowed
tiers with their stats, the upsample and the refine selection; then the
engine's own invariants (a new cap re-reads the bound, the eval_n_sample
ladder, windows at eps 0 compose the uncapped render, window cfgs leave
plain renders alone) and the trainer's delegates."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.parallel.mesh import get_mesh
from arcnerf_tpu.render.engine import RenderEngine as JaxRenderEngine
from arcnerf_tpu.render.engine import _bilinear_upsample as jax_bilinear_upsample
from arcnerf_torch.models import build_model
from arcnerf_torch.render.engine import RenderEngine, _bilinear_upsample
from arcnerf_torch.utils import profiler
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from arcnerf_torch.utils.model_io import state_from_jax
from tests.test_torch_slice import (CFG, DEPTH_MAX, RGB_MAX, RGB_MEAN, SMALL, jax_model_and_params,
                                    sphere_bound_state, view_rays)

torch.set_num_threads(1)
WH, CHUNK, CAP = 24, 64, 8  # 576 rays; 64 rays x 64 samples fill the 2^12 budget, so no chunk clips
WHITE = (1.0, 1.0, 1.0)
WINDOW_TOL = 1e-4  # windows at eps 0 against the uncapped render: f32 sums in another order


@pytest.fixture(scope="module")
def engines():
    """(JAX engine, port engine, sample) on the same weights and bitfield."""
    cfgs_j, model_j, params = jax_model_and_params(SMALL)
    bound_np = sphere_bound_state()
    bound_j = jax.tree_util.tree_map(jnp.asarray, bound_np)
    engine_j = JaxRenderEngine(model_j, get_mesh(1), cfgs_j, lambda: (params, bound_j))
    cfgs = update_configs_by_dotlist(load_configs(CFG), list(SMALL))
    model = build_model(cfgs)
    state, bound = state_from_jax(jax.tree_util.tree_map(np.asarray, params), bound_np)
    model.load_state_dict(state)
    ro, rd = view_rays(WH)
    return engine_j, RenderEngine(model, cfgs, bound, "cpu"), {"rays_o": ro, "rays_d": rd, "H": WH, "W": WH}


def set_cap(engines, cap, n_sample=None, window=False):
    engines[0].set_render_cap(cap, n_sample=n_sample, window=window)
    engines[1].set_render_cap(cap, n_sample=n_sample, window=window)


def numpy_imgs(imgs):
    return {k: v.numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in imgs.items()}


def assert_tier_close(got, want):
    got, want = numpy_imgs(got), numpy_imgs(want)
    assert sorted(got) == sorted(want) == ["depth", "mask", "rgb"]
    for k in got:
        assert got[k].shape == want[k].shape, (k, got[k].shape, want[k].shape)
    d_rgb, d_mask = np.abs(got["rgb"] - want["rgb"]), np.abs(got["mask"] - want["mask"])
    assert d_rgb.max() <= RGB_MAX and d_rgb.mean() <= RGB_MEAN, (d_rgb.max(), d_rgb.mean())
    assert d_mask.max() <= RGB_MAX and d_mask.mean() <= RGB_MEAN, (d_mask.max(), d_mask.mean())
    assert np.abs(got["depth"] - want["depth"]).max() <= DEPTH_MAX


def psnr(a, b):
    return -10.0 * np.log10(max(float(np.mean((np.asarray(a) - np.asarray(b)) ** 2)), 1e-12))


# ------------------------------------------------------------ the prepasses
@pytest.mark.parametrize("n_sample", [None, 32])
def test_prepasses_equal_jax(engines, n_sample):
    engine_j, engine, sample = engines
    set_cap(engines, CAP, n_sample=n_sample)
    ro, rd = torch.from_numpy(sample["rays_o"]), torch.from_numpy(sample["rays_d"])
    bound_j = engine_j.bound_state()
    for n_probe in (0, 16):
        hit = engine._hit_prepass(engine.bound_state, ro, rd, n_probe)
        hit_j = np.asarray(engine_j._hit_prepass(bound_j, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()), n_probe))
        assert 0 < int(hit.sum()) < hit.numel()
        np.testing.assert_array_equal(hit.numpy(), hit_j)
    counts = engine._count_prepass(engine.bound_state, ro, rd)
    counts_j = engine_j._count_prepass(bound_j, jnp.asarray(ro.numpy()), jnp.asarray(rd.numpy()))
    assert int(counts.max()) > CAP  # some rays need more than one window
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j))
    set_cap(engines, None)


def test_prepasses_over_ray_chunks_equal_one_pass(engines, monkeypatch):
    import arcnerf_torch.render.engine as engine_mod

    engine, sample = engines[1], engines[2]
    ro, rd = torch.from_numpy(sample["rays_o"]), torch.from_numpy(sample["rays_d"])
    whole = engine._hit_prepass(engine.bound_state, ro, rd), engine._count_prepass(engine.bound_state, ro, rd)
    monkeypatch.setattr(engine_mod, "PREPASS_RAYS", 100)  # 576 rays in 6 chunks, the last one short
    chunked = engine._hit_prepass(engine.bound_state, ro, rd), engine._count_prepass(engine.bound_state, ro, rd)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


# ------------------------------------------------------- fast, interactive
@pytest.mark.parametrize("hit_frac", [0.6, 0.1])  # room for every hit ray; a budget that clips
def test_render_image_fast_matches_jax(engines, hit_frac):
    engine_j, engine, sample = engines
    set_cap(engines, CAP)
    fast, stats = engine.render_image_fast(sample, chunk_rays=CHUNK, hit_frac=hit_frac, bkg_color=WHITE)
    fast_j, stats_j = engine_j.render_image_fast(sample, chunk_rays=CHUNK, hit_frac=hit_frac, bkg_color=WHITE)
    assert stats == stats_j
    assert (stats["clipped_rays"] > 0) == (hit_frac < 0.2)
    assert_tier_close(fast, fast_j)
    if not stats["clipped_rays"]:  # every hit ray renders as the exact render renders it
        exact = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)
        torch.testing.assert_close(fast["rgb"], exact["rgb"], atol=1e-6, rtol=0)
    set_cap(engines, None)


def test_render_image_interactive_matches_jax(engines):
    engine_j, engine, sample = engines
    set_cap(engines, CAP)
    inter, stats = engine.render_image_interactive(sample, scale=2, chunk_rays=CHUNK, hit_frac=0.6)
    inter_j, stats_j = engine_j.render_image_interactive(sample, scale=2, chunk_rays=CHUNK, hit_frac=0.6)
    assert stats == stats_j and stats["shaded_rays"] == (WH // 2) ** 2
    assert_tier_close(inter, inter_j)
    one, stats1 = engine.render_image_interactive(sample, scale=1, chunk_rays=CHUNK, hit_frac=0.6)
    fast, stats_f = engine.render_image_fast(sample, chunk_rays=CHUNK, hit_frac=0.6)
    assert stats1 == stats_f
    for k in fast:
        torch.testing.assert_close(one[k], fast[k], atol=0, rtol=0)
    set_cap(engines, None)


@pytest.mark.parametrize("h,scale,channels", [(16, 2, (3,)), (17, 3, ()), (16, 4, (2,))])
def test_bilinear_upsample_matches_jax(h, scale, channels):
    off = scale // 2
    hs = len(range(off, h, scale))
    img = np.random.default_rng(h).uniform(size=(hs, hs) + channels).astype(np.float32)
    got = _bilinear_upsample(torch.from_numpy(img), h, h, off, scale)
    want = jax_bilinear_upsample(img, h, h, off, scale)
    assert got.dtype == torch.float32 and got.shape == want.shape == (h, h) + channels
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)


def test_refine_pixel_select_matches_jax():
    rgb = np.random.default_rng(5).uniform(size=(20, 20, 3)).astype(np.float32)
    got = RenderEngine._refine_pixel_select(torch.from_numpy(rgb), 20, 20, 1, 2, 0.2)
    want = JaxRenderEngine._refine_pixel_select(rgb, 20, 20, 1, 2, 0.2)
    assert got.numel() == want.size == 80
    assert sorted(got.tolist()) == sorted(want.tolist())
    # a flat frame ties every score: the port takes the lowest indices off the subgrid
    flat = RenderEngine._refine_pixel_select(torch.full((20, 20, 3), 0.5), 20, 20, 1, 2, 0.2)
    onsub = np.zeros((20, 20), bool)
    onsub[1::2, 1::2] = True
    assert flat.tolist() == np.flatnonzero(~onsub)[:80].tolist()


# -------------------------------------------------------------- windowed
def windowed_both(engines, **kwargs):
    engine_j, engine, sample = engines
    got = engine.render_image_windowed(sample, chunk_rays=CHUNK, bkg_color=WHITE, **kwargs)
    want = engine_j.render_image_windowed(sample, chunk_rays=CHUNK, bkg_color=WHITE, **kwargs)
    return got, want


STAT_KEYS = ("hit_frac", "budget_rays", "hit_clipped", "pass_budget_rays", "alive_per_pass", "n_pass", "cap",
             "alive_at_end", "clipped_alive")


def test_render_image_windowed_matches_jax(engines):
    set_cap(engines, CAP, window=True)
    # counted ladder
    (win, stats), (win_j, stats_j) = windowed_both(engines, n_pass=8, eps=1e-3)
    assert {k: stats[k] for k in STAT_KEYS} == {k: stats_j[k] for k in STAT_KEYS}
    assert len(stats["pass_budget_rays"]) >= 2 and stats["clipped_alive"] == 0
    assert_tier_close(win, win_j)
    # calibrated ladder on the counted frame's alive rays, tight enough to clip
    calib = dict(n_pass=8, eps=1e-3, pass_budget_rays=tuple(max(1, a // 2) for a in stats["alive_per_pass"]),
                 budget_rays=stats["budget_rays"])
    (win, stats), (win_j, stats_j) = windowed_both(engines, **calib)
    assert {k: stats[k] for k in STAT_KEYS} == {k: stats_j[k] for k in STAT_KEYS}
    assert_tier_close(win, win_j)
    # geometric ladder (no count prepass), whose small budgets clip hit and alive rays
    (win, stats), (win_j, stats_j) = windowed_both(engines, n_pass=4, eps=1e-3, adaptive_budget=False,
                                                   alive_frac=0.25, hit_frac=0.1)
    assert {k: stats[k] for k in STAT_KEYS} == {k: stats_j[k] for k in STAT_KEYS}
    assert stats["hit_clipped"] > 0
    assert_tier_close(win, win_j)
    set_cap(engines, None)


def test_render_image_windowed_scale_and_refine_match_jax(engines):
    set_cap(engines, CAP, window=True)
    (win, stats), (win_j, stats_j) = windowed_both(engines, n_pass=8, eps=1e-3, scale=2, refine_frac=0.2)
    assert {k: stats[k] for k in STAT_KEYS + ("scale", "shaded_rays", "refined_rays")} == \
        {k: stats_j[k] for k in STAT_KEYS + ("scale", "shaded_rays", "refined_rays")}
    assert stats["refined_rays"] == int(0.2 * WH * WH)
    # the refined pixels are those of the largest gradient in each upsampled
    # frame, which part within the tolerance: hold the frames where both
    # refined a pixel, or neither did
    engine = engines[1]
    plain, _ = engine.render_image_windowed(engines[2], chunk_rays=CHUNK, bkg_color=WHITE, n_pass=8, eps=1e-3,
                                            scale=2)
    ours = (win["rgb"] != plain["rgb"]).any(-1).numpy()
    win_j, plain_j = numpy_imgs(win_j), engines[0].render_image_windowed(
        engines[2], chunk_rays=CHUNK, bkg_color=WHITE, n_pass=8, eps=1e-3, scale=2)[0]
    theirs = (win_j["rgb"] != np.asarray(plain_j["rgb"])).any(-1)
    assert (ours == theirs).mean() >= 0.9
    agree = ours == theirs
    got = {k: v.numpy()[agree] for k, v in win.items()}
    want = {k: v[agree] for k, v in win_j.items()}
    assert_tier_close(got, want)
    set_cap(engines, None)


# --------------------------------------------------- the engine's invariants
def test_set_render_cap_refreshes_the_bound(engines):
    """The bound reads its cfgs when built: set_render_cap must refresh it,
    or a new cap would serve the old one."""
    engine = engines[1]
    sample = engines[2]
    engine.set_render_cap(None)
    full = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)["rgb"]
    engine.set_render_cap(1)
    assert engine.model.fg_model.obj_bound.get_optim_cfgs("eval_max_pts_per_ray") == 1
    capped = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)["rgb"]
    assert not torch.allclose(capped, full), "cap 1 rendered as the uncapped render: the bound kept its old cap"
    engine.set_render_cap(64)  # every sample of the 64-step ladder
    torch.testing.assert_close(engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)["rgb"], full,
                               atol=1e-5, rtol=0)
    engine.set_render_cap(None)


def test_eval_n_sample_ladder_matches_jax(engines):
    engine_j, engine, sample = engines
    set_cap(engines, CAP)
    full = engine.render_image(sample, chunk_rays=CHUNK)
    set_cap(engines, CAP, n_sample=32)  # half the training ladder
    coarse = engine.render_image(sample, chunk_rays=CHUNK)
    coarse_j = engine_j.render_image(sample, chunk_rays=CHUNK)
    assert_tier_close(coarse, coarse_j)
    assert 15.0 < psnr(coarse["rgb"], full["rgb"]) < 100.0  # close, and not the 64-step render
    set_cap(engines, None)


def test_windows_at_eps_0_compose_the_uncapped_render(engines):
    engine, sample = engines[1], engines[2]
    engine.set_render_cap(None)
    full = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)
    engine.set_render_cap(CAP, window=True)
    # chunks of 8 rays: 8 x 64 samples fit the capped budget's 1024, so no
    # chunk compacts and the window must zero the samples outside it. Every
    # window samples through the fused sampler (sample.window a chunk) and
    # marches to its tail
    for kwargs in ({"chunk_rays": CHUNK}, {"chunk_rays": CHUNK, "adaptive_budget": False, "alive_frac": 1.0,
                                           "hit_frac": 1.0}, {"chunk_rays": 8}):
        profiler.enable()
        try:
            win, stats = engine.render_image_windowed(sample, n_pass=8, bkg_color=WHITE, eps=0.0, **kwargs)
            record = profiler.collect()
        finally:
            profiler.disable()
        chunks = sum(s["name"] == "render.chunk" for s in record["spans"])
        assert chunks > 0 and record["counters"].get("sample.window") == chunks
        assert stats["clipped_alive"] == 0 and stats["hit_clipped"] == 0 and stats["alive_at_end"] == 0
        for k in ("rgb", "depth", "mask"):
            torch.testing.assert_close(win[k], full[k], atol=WINDOW_TOL, rtol=0)
    engine.set_render_cap(None)


def test_window_cfgs_leave_plain_renders_alone(engines):
    engine, sample = engines[1], engines[2]
    engine.set_render_cap(CAP, window=True)
    plain_win = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)
    engine.set_render_cap(CAP)
    plain = engine.render_image(sample, chunk_rays=CHUNK, bkg_color=WHITE)
    for k in plain:
        torch.testing.assert_close(plain_win[k], plain[k], atol=0, rtol=0)
    engine.set_render_cap(None)


def test_unported_fast_path_and_bkg_owning_fallback(engines):
    engine, sample = engines[1], engines[2]
    with pytest.raises(NotImplementedError, match=r"fused=False.*ROADMAP Queue 1, item 7"):
        engine.render_image_fast(sample, fused=False)
    rays = engine.model.fg_model.cfgs.model.rays
    rays.white_bkg = True
    try:
        imgs, stats = engine.render_image_windowed(sample, chunk_rays=CHUNK)
        exact = engine.render_image(sample, chunk_rays=CHUNK)
    finally:
        rays.white_bkg = False
    assert stats == {"fallback": "bkg-owning model"}
    torch.testing.assert_close(imgs["rgb"], exact["rgb"], atol=0, rtol=0)


def test_trainer_delegates_render_with_eval_params(tmp_path):
    from arcnerf_torch.trainer import ArcNerfTrainer

    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL + [
        "--device", "cpu", "--dir.expr_dir", str(tmp_path / "x"), "--dataset.train.n_imgs", "1",
        "--dataset.train.wh", "[8,8]", "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]",
        "--optim.ema_decay", "0.9"])
    trainer = ArcNerfTrainer(cfgs)
    trainer.train_step(0)  # the EMA shadow now differs from the live weights
    sample = trainer.data["val"][0]
    live = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    trainer.set_render_cap(CAP, window=True)
    win, stats = trainer.render_image_windowed(sample, n_pass=8, eps=0.0, chunk_rays=CHUNK)
    trainer.set_render_cap(CAP)
    fast, _ = trainer.render_image_fast(sample, chunk_rays=CHUNK, hit_frac=1.0)
    inter, _ = trainer.render_image_interactive(sample, chunk_rays=CHUNK, hit_frac=1.0, scale=1)
    capped = trainer.render_image(sample)
    trainer.set_render_cap(None)
    exact = trainer.render_image(sample)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, live[k]), k  # the live weights came back
    torch.testing.assert_close(win["rgb"], exact["rgb"], atol=WINDOW_TOL, rtol=0)
    torch.testing.assert_close(fast["rgb"], inter["rgb"], atol=0, rtol=0)
    torch.testing.assert_close(fast["rgb"], capped["rgb"], atol=1e-6, rtol=0)
    with torch.no_grad():  # the live weights render another image
        live_img = trainer.engine.render_image(sample)["rgb"]
    assert not torch.allclose(live_img, exact["rgb"])
