"""arcnerf_torch's CUDA kernels (A-J) vs their plain PyTorch versions on the
card, the autograd Functions' dispatch to them, and the gather/scatter
wrappers' launch counters.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips where CUDA is
unavailable. The card's machine has no JAX, so run this file without the
suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""

import numpy as np
import pytest
import torch

import arcnerf_torch.models.base_modules.encoding as encoding
import arcnerf_torch.ops.fused_mlp as fused_mlp_mod
import arcnerf_torch.ops.gather_scatter as gs
import arcnerf_torch.render.ray_helper as ray_helper
from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, hash_encode, hash_encode_bwd,
                                                       hash_encode_bwd_reference, hash_encode_reference)
from arcnerf_torch.ops.fused_mlp import (fused_mlp, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd,
                                         fused_mlp_reference)
from arcnerf_torch.render.ray_helper import (segment_march, segment_march_bwd, segment_march_bwd_reference,
                                             segment_march_reference)
from arcnerf_torch.tools.hash_streams import one_cell_stream, pad_stream, ray_stream

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


@pytest.mark.parametrize("dims", [[32, 64, 16], [18, 64, 64, 3], [40, 64, 64, 64, 16]])
def test_fused_mlp_kernel_matches_plain(dev, dims):
    # rtol = atol = 2e-2: bf16 flips from another f32 summation order
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((1000, dims[0]), generator=gen, device=dev)
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
          for i in range(len(dims) - 1)]
    launches = fused_mlp.launches
    torch.testing.assert_close(fused_mlp(x, ws), fused_mlp_reference(x, ws), rtol=2e-2, atol=2e-2)
    assert fused_mlp.launches == launches + 1


def test_fused_mlp_kernel_takes_host_weights(dev):
    # the kernel reads the packed buffer, which is built on the input's device
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((256, 32), generator=gen).to(dev)
    ws = [torch.randn((32, 64), generator=gen) / 32**0.5, torch.randn((64, 16), generator=gen) / 8.0]
    torch.testing.assert_close(fused_mlp(x, ws).cpu(), fused_mlp_reference(x.cpu(), ws), rtol=2e-2, atol=2e-2)


def _scaled_close(out, ref, tol):
    # |out - ref| <= tol * max|ref|: sums over many rows in another order
    assert torch.isfinite(out).all()
    assert float((out - ref).abs().max()) <= tol * float(ref.abs().max())


@pytest.mark.parametrize("dims", [[32, 64, 16], [18, 64, 64, 3], [40, 64, 64, 64, 16]])
def test_fused_mlp_save_pre_and_backward_kernel_match_plain(dev, dims):
    # save_pre: bf16 flips (rtol = atol = 2e-2) like the output; kernel D
    # against the plain backward on the same saved pre-activations: 1e-4 of
    # the largest value (the dW sums over 3000 rows run in another order)
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn((3000, dims[0]), generator=gen, device=dev)
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
          for i in range(len(dims) - 1)]
    out, pre = fused_mlp_fwd(x, ws, save_pre=True)
    out_ref, pre_ref = fused_mlp_reference(x, ws, save_pre=True)
    assert pre.shape == (len(ws) - 1, 3000, 64) and pre.dtype == torch.bfloat16
    assert torch.equal(out, fused_mlp_fwd(x, ws))
    torch.testing.assert_close(pre.float(), pre_ref.float(), rtol=2e-2, atol=2e-2)
    g = torch.randn((3000, dims[-1]), generator=gen, device=dev)
    dx, dws = fused_mlp_bwd(x, g, ws, pre)
    dx_ref, dws_ref = fused_mlp_bwd_reference(x, g, ws, pre)
    _scaled_close(dx, dx_ref, 1e-4)
    for a, b in zip(dws, dws_ref):
        assert a.shape == b.shape
        _scaled_close(a, b, 1e-4)


def _bwd_inputs(dev, dims, n_rows, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((n_rows, dims[0]), generator=gen, device=dev)
    ws = [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
          for i in range(len(dims) - 1)]
    g = torch.randn((n_rows, dims[-1]), generator=gen, device=dev)
    _, pre = fused_mlp_fwd(x, ws, save_pre=True)
    return x, ws, g, pre


@pytest.mark.parametrize("dims", [[18, 64, 64, 3], [32, 64, 16], [40, 64, 64, 64, 16], [64, 64, 1]])
@pytest.mark.parametrize("n_rows", [1, 15, 64, 3000, (1 << 18) + 7])
def test_fused_mlp_bwd_kernel_matches_plain_at_ragged_rows(dev, dims, n_rows):
    # kernel D against the plain backward on kernel A's saved
    # pre-activations: 1e-4 of the largest value (dW sums its rows on tensor
    # cores in another order, with g split into two bf16 halves)
    x, ws, g, pre = _bwd_inputs(dev, dims, n_rows, 12)
    launches = fused_mlp_bwd.launches
    dx, dws = fused_mlp_bwd(x, g, ws, pre)
    assert fused_mlp_bwd.launches == launches + 1
    dx_ref, dws_ref = fused_mlp_bwd_reference(x, g, ws, pre)
    assert dx.shape == dx_ref.shape
    _scaled_close(dx, dx_ref, 1e-4)
    for a, b in zip(dws, dws_ref):
        assert a.shape == b.shape
        _scaled_close(a, b, 1e-4)


@pytest.mark.parametrize("dims", [[18, 64, 64, 3], [32, 64, 16]])
def test_fused_mlp_bwd_kernel_is_deterministic(dev, dims):
    # 2^18 + 7 rows spread over many CTAs, so dW takes the two-pass sum of
    # the per-CTA partials: two calls agree bit for bit
    x, ws, g, pre = _bwd_inputs(dev, dims, (1 << 18) + 7, 13)
    dx, dws = fused_mlp_bwd(x, g, ws, pre)
    dx2, dws2 = fused_mlp_bwd(x, g, ws, pre)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(dws, dws2))


def test_autograd_hands_kernel_d_the_forward_packed_weights(dev, monkeypatch):
    # the forward packs the weights once for kernel A; the backward hands
    # that buffer to kernel D and never packs again
    x, ws, g, pre = _bwd_inputs(dev, [18, 64, 64, 3], 5000, 14)
    packs = []
    pack = fused_mlp_mod.pack_weights

    def counting(*args, **kwargs):
        packs.append(1)
        return pack(*args, **kwargs)

    def refuse(*args, **kwargs):
        raise AssertionError("the backward packed the weights again")

    monkeypatch.setattr(fused_mlp_mod, "pack_weights", counting)
    xp = x.clone().requires_grad_(True)
    wp = [w.clone().requires_grad_(True) for w in ws]
    out = fused_mlp(xp, wp)
    assert len(packs) == 1
    monkeypatch.setattr(fused_mlp_mod, "pack_weights", refuse)
    launches = fused_mlp_bwd.launches
    out.backward(g)
    assert fused_mlp_bwd.launches == launches + 1
    dx_ref, dws_ref = fused_mlp_bwd_reference(x, g, ws, pre)
    _scaled_close(xp.grad, dx_ref, 1e-4)
    for w, b in zip(wp, dws_ref):
        _scaled_close(w.grad, b, 1e-4)


def test_fused_mlp_bwd_kernel_refuses_chains_it_does_not_take(dev):
    x, ws, g, pre = _bwd_inputs(dev, [32, 64, 64, 64, 64, 16], 100, 15)
    with pytest.raises(ValueError, match="hidden layers"):
        fused_mlp_bwd(x, g, ws, pre)


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_encode_bwd_kernel_matches_plain(dev, variant):
    # 1e-4 of the largest entry: f32 atomics add in another order
    gen = torch.Generator(device=dev).manual_seed(5)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False)
    xyz = torch.rand((8192, 3), generator=gen, device=dev) * 2.1 - 1.05
    g = torch.randn((8192, 32), generator=gen, device=dev)
    args = (xyz, g, (16, 1 << 19, 2), enc.resolutions, enc.aabb_min, enc.aabb_len, variant)
    _scaled_close(hash_encode_bwd(*args), hash_encode_bwd_reference(*args), 1e-4)


E_STREAMS = ("ray", "one_cell", "padded", "single", "ragged")


def _e_stream(kind, n_feat, dev, n_pts=8192):
    """(xyz, g) on ``dev`` for kernel E: ray-ordered fixed-step samples, all
    points in one level-0 cell, a compacted stream whose last quarter is
    padding (row 0 repeated, g = 0), one point, or 1000 ray-ordered points
    (not a multiple of 32)."""
    n_pts = {"single": 1, "ragged": 1000}.get(kind, n_pts)
    g = np.random.default_rng(20).normal(size=(n_pts, 16 * n_feat)).astype(np.float32)
    xyz = one_cell_stream(n_pts, 21) if kind == "one_cell" else ray_stream(n_pts, 21)
    if kind == "padded":
        xyz, g = pad_stream(xyz, g, n_pts * 3 // 4)
    return torch.from_numpy(xyz).to(dev), torch.from_numpy(g).to(dev)


def _e_args(xyz, g, n_feat, variant, log2_table=14):
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=n_feat, hashmap_size=log2_table, side=2.0,
                           include_input=False)
    return xyz, g, (16, 1 << log2_table, n_feat), enc.resolutions, enc.aabb_min, enc.aabb_len, variant


@pytest.mark.parametrize("kind", E_STREAMS)
@pytest.mark.parametrize("n_feat", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_encode_bwd_kernel_on_streams(dev, kind, n_feat, variant):
    # 1e-4 of the largest entry: the adds into an entry in another order
    # (warp sums, then atomics); T = 2^14 keeps levels 0-1 dense
    args = _e_args(*_e_stream(kind, n_feat, dev), n_feat, variant)
    launches = hash_encode_bwd.launches
    out = hash_encode_bwd(*args)
    assert hash_encode_bwd.launches == launches + 1
    _scaled_close(out, hash_encode_bwd_reference(*args), 1e-4)


@pytest.mark.parametrize("kind", ["ray", "one_cell", "padded"])
def test_hash_encode_bwd_kernel_two_calls_agree(dev, kind):
    # the atomics land in another order on every call: 1e-4 of the largest entry
    args = _e_args(*_e_stream(kind, 2, dev), 2, "quad")
    _scaled_close(hash_encode_bwd(*args), hash_encode_bwd(*args), 1e-4)


def test_hash_encode_bwd_kernel_at_the_recipe_scale(dev):
    # 2^18 + 5 ray-ordered points (a ragged last warp) into T = 2^19
    args = _e_args(*_e_stream("ray", 2, dev, (1 << 18) + 5), 2, "quad", 19)
    _scaled_close(hash_encode_bwd(*args), hash_encode_bwd_reference(*args), 1e-4)


@pytest.mark.parametrize("add_inf_z,white_bkg,bkg", [(False, False, True), (True, False, False),
                                                     (False, True, False)])
def test_segment_march_bwd_kernel_matches_plain(dev, add_inf_z, white_bkg, bkg):
    # 1e-4 of the largest value: expf and the products in another order
    gen = torch.Generator(device=dev).manual_seed(6)
    n_rays, k = 2048, 1 << 14
    tot = torch.randint(0, 17, (n_rays,), generator=gen, device=dev)
    off = torch.cumsum(tot, 0) - tot
    cnt = torch.minimum((k - off).clamp_min(0), tot)
    z = 2.0 + 0.01 * torch.arange(k, device=dev, dtype=torch.float32)
    sigma = torch.randn((k,), generator=gen, device=dev) * 20
    rgb = torch.rand((k, 3), generator=gen, device=dev)
    g_rgb = torch.randn((n_rays, 3), generator=gen, device=dev)
    g_depth, g_mask = torch.randn((n_rays,), generator=gen, device=dev), torch.randn((n_rays,), generator=gen,
                                                                                     device=dev)
    b = torch.rand((n_rays, 3), generator=gen, device=dev) if bkg else None
    args = (sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, add_inf_z, b, white_bkg)
    (ds, dr), (rs, rr) = segment_march_bwd(*args), segment_march_bwd_reference(*args)
    _scaled_close(ds, rs, 1e-4)
    _scaled_close(dr, rr, 1e-4)


def test_autograd_launches_the_kernels_never_the_plain_versions(dev, monkeypatch):
    # forward and backward through each Function on CUDA tensors with every
    # plain version replaced by one that raises
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for mod, names in ((fused_mlp_mod, ("fused_mlp_reference", "fused_mlp_bwd_reference")),
                       (encoding, ("hash_encode_reference", "hash_encode_bwd_reference")),
                       (ray_helper, ("segment_march_reference", "segment_march_bwd_reference"))):
        for name in names:
            monkeypatch.setattr(mod, name, refuse)
    before = [f.launches for f in (fused_mlp, fused_mlp_bwd, hash_encode, hash_encode_bwd, segment_march,
                                   segment_march_bwd)]
    gen = torch.Generator(device=dev).manual_seed(7)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=14, side=2.0, include_input=False).to(dev)
    w1 = torch.nn.Parameter(torch.randn((32, 64), generator=gen, device=dev) / 8)
    w2 = torch.nn.Parameter(torch.randn((64, 4), generator=gen, device=dev) / 8)
    xyz = torch.rand((512, 3), generator=gen, device=dev) * 2 - 1
    h = fused_mlp(enc(xyz), [w1, w2])
    off = torch.arange(0, 512, 8, device=dev)
    cnt = torch.full((64,), 8, dtype=torch.int64, device=dev)
    z = 2.0 + 0.01 * torch.arange(512, device=dev, dtype=torch.float32)
    out = segment_march(h[:, 0].relu(), h[:, 1:].sigmoid(), z, off, cnt, bkg_color=torch.ones(3, device=dev))
    (out["rgb"].sum() + out["depth"].sum() + out["mask"].sum()).backward()
    torch.cuda.synchronize()
    after = [f.launches for f in (fused_mlp, fused_mlp_bwd, hash_encode, hash_encode_bwd, segment_march,
                                  segment_march_bwd)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1, 1, 1]
    for p in (w1, w2, enc.embeddings):
        assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().sum() > 0


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
@pytest.mark.parametrize("read_bf16", [True, False])
def test_hash_encode_kernel_matches_plain(dev, variant, read_bf16):
    # atol 1e-5: the same entries and weights, summed in another order
    gen = torch.Generator(device=dev).manual_seed(1)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False)
    table = torch.rand((16, 1 << 19, 2), generator=gen, device=dev) * 2 - 1
    xyz = torch.rand((4096, 3), generator=gen, device=dev) * 2.1 - 1.05
    args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, variant, read_bf16)
    torch.testing.assert_close(hash_encode(*args), hash_encode_reference(*args), rtol=0, atol=1e-5)


@pytest.mark.parametrize("add_inf_z,white_bkg", [(False, False), (True, False), (False, True)])
def test_segment_march_kernel_matches_plain(dev, add_inf_z, white_bkg):
    # 1e-4 relative: sequential vs cumprod/sum order
    gen = torch.Generator(device=dev).manual_seed(2)
    n_rays, k = 2048, 1 << 14
    tot = torch.randint(0, 17, (n_rays,), generator=gen, device=dev)
    off = torch.cumsum(tot, 0) - tot
    cnt = torch.minimum((k - off).clamp_min(0), tot)
    steps = torch.cumsum(torch.randint(0, 3, (k,), generator=gen, device=dev), 0)
    ray_id = torch.repeat_interleave(torch.arange(n_rays, device=dev), cnt)
    z = 2.0 + torch.rand((k,), generator=gen, device=dev)
    z[: ray_id.shape[0]] = 2.0 + 0.01 * (steps[: ray_id.shape[0]] - steps[off[ray_id]]).float()
    sigma = torch.randn((k,), generator=gen, device=dev) * 20
    rgb = torch.rand((k, 3), generator=gen, device=dev)
    out = segment_march(sigma, rgb, z, off, cnt, add_inf_z=add_inf_z, white_bkg=white_bkg)
    ref = segment_march_reference(sigma, rgb, z, off, cnt, add_inf_z=add_inf_z, white_bkg=white_bkg)
    for key in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(out[key], ref[key], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_table,n_rows,width,dtype", [
    (100, 37, 4, torch.float32), (2048, 1024, 128, torch.float32), (2048, 1024, 128, torch.bfloat16),
    (300, 999, 8, torch.bfloat16), (1 << 14, 1 << 15, 128, torch.bfloat16), (1 << 16, 1 << 17, 128, torch.float32)])
def test_row_gather_kernel_matches_plain(dev, n_table, n_rows, width, dtype):
    # bit-identical: a copy
    gen = torch.Generator(device=dev).manual_seed(8)
    table = torch.randn((n_table, width), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, n_table, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    launches = gs.row_gather.launches
    out = gs.row_gather(table, idx)
    assert gs.row_gather.launches == launches + 1
    assert out.dtype == dtype and torch.equal(out, gs.row_gather_reference(table, idx))


def test_row_gather_kernel_refuses_rows_it_cannot_move(dev):
    with pytest.raises(ValueError, match="16-byte"):
        gs.row_gather(torch.zeros((8, 3), device=dev), torch.zeros((2,), dtype=torch.int32, device=dev))
    with pytest.raises(ValueError, match="int32"):
        gs.row_gather(torch.zeros((8, 4), device=dev), torch.zeros((2,), dtype=torch.int64, device=dev))


@pytest.mark.parametrize("m,width,idx_rows,n", [(1, 2048, 1, 1024), (8, 2048, 1, 1024), (8, 2048, 8, 2048),
                                                (3, 50, 3, 7), (8, 1 << 19, 8, 1 << 19)])
def test_lane_gather_kernel_matches_plain(dev, m, width, idx_rows, n):
    # bit-identical: a copy
    gen = torch.Generator(device=dev).manual_seed(9)
    src = torch.randn((m, width), generator=gen, device=dev)
    idx = torch.randint(0, width, (idx_rows, n), generator=gen, device=dev, dtype=torch.int32)
    launches = gs.lane_gather.launches
    out = gs.lane_gather(src, idx)
    assert gs.lane_gather.launches == launches + 1
    assert torch.equal(out, gs.lane_gather_reference(src, idx))


@pytest.mark.parametrize("n_table,width,n", [(2048, 128, 1024), (100, 4, 1000), (1000, 1, 5000), (64 ** 3, 1, 1 << 18),
                                             (8192, 128, 1 << 21), (1 << 23, 1, 1 << 25)])
def test_scatter_add_rows_kernel_matches_plain(dev, n_table, width, n):
    # 1e-5 of the largest sum: f32 atomics add in another order; in place
    gen = torch.Generator(device=dev).manual_seed(10)
    idx = torch.randint(0, n_table, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((n, width), generator=gen, device=dev)
    out = torch.ones((n_table, width), device=dev)
    launches = gs.scatter_add_rows.launches
    assert gs.scatter_add_rows(out, idx, g) is out
    assert gs.scatter_add_rows.launches == launches + 1
    _scaled_close(out, gs.scatter_add_rows_reference(torch.ones((n_table, width), device=dev), idx, g), 1e-5)


def test_scatter_add_rows_kernel_refuses_widths_it_does_not_take(dev):
    with pytest.raises(ValueError, match="multiple of 4"):
        gs.scatter_add_rows(torch.zeros((8, 6), device=dev), torch.zeros((2,), dtype=torch.int32, device=dev),
                            torch.zeros((2, 6), device=dev))


@pytest.mark.parametrize("k,offs,n_feat", [(1000, (0, 2), 2), (4096, (0, 2, 62, 64), 2), (777, (0,), 1),
                                           (300, (0, 5, 9), 2), (500, (0, 1), 2), (1 << 20, (0, 2), 2),
                                           (1 << 19, (0, 2, 62, 64), 2)])
def test_build_update_rows_kernel_matches_plain(dev, k, offs, n_feat):
    # bit-identical: each lane sums its terms from 0 in the plain version's
    # order, so even the overlapping terms of offsets (0, 1) agree exactly
    gen = torch.Generator(device=dev).manual_seed(11)
    lane0 = torch.randint(0, 80, (k,), generator=gen, device=dev, dtype=torch.int32)
    vals = torch.rand((k, len(offs) * n_feat), generator=gen, device=dev)
    launches = gs.build_update_rows.launches
    out = gs.build_update_rows(lane0, vals, offs, n_feat)
    assert gs.build_update_rows.launches == launches + 1
    assert torch.equal(out, gs.build_update_rows_reference(lane0, vals, offs, n_feat))


def test_gather_scatter_wrappers_launch_the_kernels_never_the_plain_versions(dev, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on CUDA tensors")

    for name in ("row_gather_reference", "lane_gather_reference", "scatter_add_rows_reference",
                 "build_update_rows_reference"):
        monkeypatch.setattr(gs, name, refuse)
    before = [f.launches for f in (gs.row_gather, gs.lane_gather, gs.scatter_add_rows, gs.build_update_rows)]
    idx = torch.tensor([2, 0, 2], dtype=torch.int32, device=dev)
    gs.row_gather(torch.randn((4, 8), device=dev), idx)
    gs.lane_gather(torch.randn((2, 4), device=dev), idx[None])
    gs.scatter_add_rows(torch.zeros((4, 4), device=dev), idx, torch.ones((3, 4), device=dev))
    gs.build_update_rows(idx, torch.ones((3, 2), device=dev), (0,), 2)
    torch.cuda.synchronize()
    after = [f.launches for f in (gs.row_gather, gs.lane_gather, gs.scatter_add_rows, gs.build_update_rows)]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1, 1]
