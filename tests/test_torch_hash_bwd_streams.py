"""The plain version of kernel E (``hash_encode_bwd_reference``) on the point
streams its card tests hold the kernel against
(``arcnerf_torch.tools.hash_streams``: ray-ordered, one level-0 cell,
compacted with padding rows): against a float64 ``np.add.at`` of the same
corners and weights, and against ``jax.grad`` of the JAX HashGridEmbedder.
Also the streams' own shapes and ordering, and the two pieces of
``chip_smoke.py`` that feed kernel E's measurements: the capture of the
stream a training step hands it, and the precomputed updates of its
``index_add_`` yardstick. CPU, small sizes, seeded numpy; each comparison
states its tolerance."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from arcnerf_tpu.models.base_modules.encoding import HashGridEmbedder as JaxHashGrid
from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, _corners_and_weights, hash_encode_bwd,
                                                       hash_encode_bwd_reference)
from arcnerf_torch.tools.hash_streams import STEP, one_cell_stream, pad_stream, ray_stream
from arcnerf_torch.trainer import ArcNerfTrainer
from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist
from test_torch_ops import _VARIANT_FLAGS
from test_torch_train_slice import CFG, SMALL_RUN

torch.set_num_threads(1)

N_PTS, N_LEVELS = 1500, 4
STREAMS = ("ray", "one_cell", "padded")


def _kw(n_feat):
    # 4 levels over T = 2^12 (level 0 dense, 1-3 hashed), as in test_torch_ops
    return dict(n_levels=N_LEVELS, n_feat_per_entry=n_feat, hashmap_size=12, base_res=16, max_res=2048, side=2.0,
                include_input=False, dtype="bfloat16")


def _stream(kind, n_feat, seed=0):
    """(xyz (N, 3), g (N, L F)) f32 numpy of one stream kind."""
    g = np.random.default_rng(seed + 100).normal(size=(N_PTS, N_LEVELS * n_feat)).astype(np.float32)
    if kind == "one_cell":
        return one_cell_stream(N_PTS, seed), g
    xyz = ray_stream(N_PTS, seed)
    return pad_stream(xyz, g, N_PTS * 2 // 3) if kind == "padded" else (xyz, g)


def _reference(xyz, g, n_feat, variant):
    enc = HashGridEmbedder(**_kw(n_feat))
    args = (torch.from_numpy(xyz), torch.from_numpy(g), tuple(enc.embeddings.shape), enc.resolutions,
            enc.aabb_min, enc.aabb_len, variant)
    return hash_encode_bwd_reference(*args).numpy(), args


def _add_at_f64(args):
    """The same corners and f32 weights as the reference, each w * g and
    every sum in float64 with np.add.at."""
    xyz, g, (n_levels, table_size, n_feat), res, aabb_min, aabb_len, variant = args
    entries, weights = _corners_and_weights(xyz, res, aabb_min, aabb_len, table_size, variant)
    gl = g.numpy().reshape(-1, n_levels, n_feat).astype(np.float64)
    level_off = np.arange(n_levels) * table_size
    out = np.zeros((n_levels * table_size, n_feat))
    for e, w in zip(entries, weights):
        np.add.at(out, (e.numpy() + level_off).reshape(-1),
                  (gl * w.numpy().astype(np.float64)[..., None]).reshape(-1, n_feat))
    return out.reshape(n_levels, table_size, n_feat)


@pytest.mark.parametrize("n_pts", [1, 31, 4096])
def test_ray_stream_shapes_and_ordering(n_pts):
    xyz = ray_stream(n_pts, 3)
    assert xyz.shape == (n_pts, 3) and xyz.dtype == np.float32
    assert np.all(np.abs(xyz) < 1.0)
    assert np.array_equal(xyz, ray_stream(n_pts, 3))
    if n_pts > 1:
        # rays of 1-32 samples: consecutive rows a step apart inside a ray
        # (f32 rounding of the points: 1e-6), most pairs lie inside one
        gaps = np.linalg.norm(np.diff(xyz.astype(np.float64), axis=0), axis=-1)
        assert np.mean(np.abs(gaps - STEP) < 1e-6) >= (0.8 if n_pts > 1000 else 0.5)


def test_one_cell_stream_lies_in_one_level0_cell():
    enc = HashGridEmbedder(**_kw(2))
    xyz = torch.from_numpy(one_cell_stream(N_PTS, 4))
    entries, _ = _corners_and_weights(xyz, enc.resolutions, enc.aabb_min, enc.aabb_len, enc.table_size, "quad")
    for e in entries:
        assert torch.all(e[:, 0] == e[0, 0])  # level 0: the same 8 entries for every point
    assert len(torch.unique(entries[0][:, N_LEVELS - 1])) > 100  # the finest level spreads them


def test_pad_stream_repeats_row_zero_with_zero_g():
    xyz, g = _stream("ray", 2)
    pxyz, pg = pad_stream(xyz, g, 1000)
    assert np.array_equal(pxyz[:1000], xyz[:1000]) and np.array_equal(pg[:1000], g[:1000])
    assert np.all(pxyz[1000:] == xyz[0]) and np.all(pg[1000:] == 0.0)
    assert np.array_equal(xyz, ray_stream(N_PTS, 0))  # the input is left as it was


@pytest.mark.parametrize("kind", STREAMS)
@pytest.mark.parametrize("variant,n_feat", [("quad", 2), ("pair", 2), ("ngp", 2), ("ngp", 1), ("pair", 4),
                                            ("ngp", 8)])
def test_reference_matches_float64_add_at(kind, variant, n_feat):
    # the reference's f32 products and index_add_ sums against float64:
    # 1e-5 of the largest entry, ten times tighter than the kernel's E_TOL
    xyz, g = _stream(kind, n_feat)
    got, args = _reference(xyz, g, n_feat, variant)
    want = _add_at_f64(args)
    assert got.shape == want.shape and np.count_nonzero(got[0]) > 0
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))


@pytest.mark.parametrize("variant,n_feat", [("quad", 2), ("pair", 1), ("ngp", 1), ("pair", 4), ("ngp", 4)])
def test_reference_matches_jax_grad_on_the_ray_stream(variant, n_feat):
    # jax.grad of HashGridEmbedder's CPU path: the same entries and weights,
    # the adds into each entry in another order. On this stream level 0
    # gathers ~100 adds an entry: 1e-5 of the largest entry.
    xyz, g = _stream("ray", n_feat, seed=5)
    table = np.random.default_rng(6).uniform(-1, 1, size=(N_LEVELS, 1 << 12, n_feat)).astype(np.float32)
    jax_enc = JaxHashGrid(**_kw(n_feat), **_VARIANT_FLAGS[variant])
    want = np.asarray(jax.grad(lambda t: jnp.sum(jax_enc.apply({"params": {"embeddings": t}}, jnp.asarray(xyz)) * g))(
        jnp.asarray(table)))
    enc = HashGridEmbedder(**_kw(n_feat), **_VARIANT_FLAGS[variant])
    assert enc.variant == variant
    with torch.no_grad():
        enc.embeddings.copy_(torch.from_numpy(table))
    (enc(torch.from_numpy(xyz)) * torch.from_numpy(g)).sum().backward()
    got = enc.embeddings.grad.numpy()
    assert np.count_nonzero(got) > 1000
    np.testing.assert_allclose(got, want, atol=1e-5 * np.max(np.abs(want)), rtol=0)


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_padding_rows_leave_the_reference_unchanged(variant):
    # padding rows add w * 0 into a table that starts at +0, so the kernel
    # may skip them: the reference on the padded stream equals it on the
    # valid rows alone, bit for bit
    xyz, g = _stream("padded", 2)
    n_valid = N_PTS * 2 // 3
    padded, _ = _reference(xyz, g, 2, variant)
    valid, _ = _reference(np.ascontiguousarray(xyz[:n_valid]), np.ascontiguousarray(g[:n_valid]), 2, variant)
    assert np.array_equal(padded, valid)


def _trainer(tmp_path):
    cfgs = update_configs_by_dotlist(load_configs(CFG), SMALL_RUN + ["--dir.expr_dir", str(tmp_path / "expr")])
    trainer = ArcNerfTrainer(cfgs)
    for t in range(2):
        trainer.train_step(t)
    return trainer


def test_chip_smoke_captures_the_stream_of_one_training_step(tmp_path, monkeypatch):
    # the capture wraps encoding.hash_encode_bwd and ray_helper.segment_march_bwd
    # for one step and restores them; what it holds is kernel E's and kernel
    # F's input, so the references on it are the step's table gradient and
    # compositing gradient
    from arcnerf_torch.models.base_modules import encoding
    from arcnerf_torch.render import ray_helper

    trainer = _trainer(tmp_path)
    plain = encoding.hash_encode_bwd
    plain_f = ray_helper.segment_march_bwd

    def counting(*args):
        # counts as the card's wrapper does: on the module's hash_encode_bwd
        encoding.hash_encode_bwd.launches += 1
        return plain(*args)

    counting.launches = 5
    monkeypatch.setattr(encoding, "hash_encode_bwd", counting)
    step = trainer.step
    stream = chip_smoke.capture_training_streams(trainer)
    assert encoding.hash_encode_bwd is counting and trainer.step == step + 1 and counting.launches == 6
    assert ray_helper.segment_march_bwd is plain_f
    n_pts = stream["xyz"].shape[0]
    assert stream["shape"] == (N_LEVELS, 1 << 12, 2) and stream["variant"] == "quad"
    assert n_pts == 1 << 12 and stream["g"].shape == (n_pts, N_LEVELS * 2)
    assert 0 < stream["n_valid"]
    in_stream = min(stream["n_valid"], n_pts)
    # padding rows: sample 0 of ray 0 with g = 0
    assert torch.all(stream["g"][in_stream:] == 0) and torch.all(stream["xyz"][in_stream:] == stream["xyz"][0])
    assert stream["res"] == HashGridEmbedder(**_kw(2)).resolutions
    grad = hash_encode_bwd(stream["xyz"], stream["g"], stream["shape"], stream["res"], stream["aabb_min"],
                           stream["aabb_len"], stream["variant"])
    assert torch.isfinite(grad).all() and grad.abs().sum() > 0
    march = stream["march"]
    n_rays, k_total = march["off"].shape[0], march["z"].shape[0]
    assert march["sigma"].shape == (k_total,) and march["rgb"].shape == (k_total, 3) and k_total == n_pts
    assert march["cnt"].shape == (n_rays,) and march["g_rgb"].shape == (n_rays, 3)
    assert march["g_depth"].shape == march["g_mask"].shape == (n_rays,)
    assert march["bkg"] is not None and march["bkg"].shape == (n_rays, 3)  # the recipe's random background
    lengths = chip_smoke.segment_lengths(march["off"], march["cnt"], k_total)
    assert int(lengths.sum()) == min(stream["n_valid"], k_total)
    summary = chip_smoke.length_summary(lengths)
    assert summary["rays"] == n_rays and summary["samples"] == int(lengths.sum()) and summary["max"] <= 1 << 12
    d_sigma, d_rgb = plain_f(*(march[k] for k in ("sigma", "rgb", "z", "off", "cnt", "g_rgb", "g_depth", "g_mask",
                                                  "add_inf_z", "bkg", "white_bkg")))
    assert torch.isfinite(d_sigma).all() and torch.isfinite(d_rgb).all() and d_rgb.abs().sum() > 0


@pytest.mark.parametrize("kind", STREAMS)
def test_chip_smoke_index_add_updates_give_the_reference(kind):
    # one index_add_ of the precomputed (entry, w * g) updates: the same
    # function as the plain version, its terms in the same order
    xyz, g = _stream(kind, 2)
    ref, args = _reference(xyz, g, 2, "quad")
    idx, vals = chip_smoke.index_add_updates(*args)
    assert idx.shape == (8 * N_PTS * N_LEVELS,) and vals.shape == (8 * N_PTS * N_LEVELS, 2)
    got = torch.zeros((N_LEVELS * (1 << 12), 2)).index_add_(0, idx, vals).reshape(ref.shape).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-6 * np.max(np.abs(ref))
