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
from arcnerf_torch.tools.march_streams import long_tail_lengths, ray_gradients, segment_stream
from arcnerf_torch.tools.scatter_streams import partition_constants

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


def _chain(dims, gen, dev):
    return [torch.randn((dims[i], dims[i + 1]), generator=gen, device=dev) / dims[i] ** 0.5
            for i in range(len(dims) - 1)]


@pytest.mark.parametrize("dims", [[18, 64, 64, 3], [32, 64, 16], [64, 64, 1], [40, 64, 64, 64, 16]])
@pytest.mark.parametrize("n_rows", [1, 15, 16, 17, 1000, 3000, (1 << 18) + 7])
def test_fused_mlp_kernel_both_builds_at_ragged_rows(dev, dims, n_rows):
    # out and pre within rtol = atol = 2e-2 of the plain version: bf16 flips
    # from the MMA's summation order (tests/test_torch_mlp_fwd_numerics.py).
    # The save_pre build's output is the inference build's, and two calls
    # of either agree bit for bit
    gen = torch.Generator(device=dev).manual_seed(n_rows)
    x = torch.randn((n_rows, dims[0]), generator=gen, device=dev)
    ws = _chain(dims, gen, dev)
    launches = fused_mlp.launches
    out = fused_mlp_fwd(x, ws)
    out_s, pre = fused_mlp_fwd(x, ws, save_pre=True)
    assert fused_mlp.launches == launches + 2
    ref, pre_ref = fused_mlp_reference(x, ws, save_pre=True)
    assert out.shape == ref.shape and pre.shape == pre_ref.shape and pre.dtype == torch.bfloat16
    torch.testing.assert_close(out, ref, rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(pre.float(), pre_ref.float(), rtol=2e-2, atol=2e-2)
    assert torch.equal(out_s, out)
    out2, pre2 = fused_mlp_fwd(x, ws, save_pre=True)
    assert torch.equal(out2, out) and torch.equal(pre2, pre) and torch.equal(fused_mlp_fwd(x, ws), out)


@pytest.mark.parametrize("offset", [1, 18])
def test_fused_mlp_kernel_reads_x_at_a_4_or_8_byte_offset(dev, offset):
    # x a view `offset` floats into its storage: 4- or 8-byte aligned, not
    # 16, so the kernel copies x 4 bytes at a time; rtol = atol = 2e-2 as above
    gen = torch.Generator(device=dev).manual_seed(offset)
    flat = torch.randn((offset + 1000 * 18,), generator=gen, device=dev)
    x = flat[offset:].view(1000, 18)
    assert x.data_ptr() % 16 != 0
    ws = _chain([18, 64, 64, 3], gen, dev)
    torch.testing.assert_close(fused_mlp(x, ws), fused_mlp_reference(x, ws), rtol=2e-2, atol=2e-2)
    assert torch.equal(fused_mlp(x, ws), fused_mlp(x.clone(), ws))


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


F_STREAMS = ("long_tail", "ragged", "clipped", "short")
F_FLAGS = [(False, False, True), (True, False, False), (False, True, False), (True, False, True), (False, False, False)]


def _f_args(kind, add_inf_z, white_bkg, bkg, dev):
    """Kernel F's arguments on a stream of segments of 0-512 samples (every
    chunk boundary of a 32-lane group among them): 4096 rays; 1001 rays (not
    a whole block of rays); a budget that clips one ray and leaves the rest
    empty; or 0-32 samples a ray."""
    n_rays = 1001 if kind == "ragged" else 4096
    lengths = long_tail_lengths(n_rays, 30, max_len=32 if kind == "short" else 512)
    k_total = int(lengths.sum()) * 2 // 3 if kind == "clipped" else int(lengths.sum()) + 100
    sigma, rgb, z, off, cnt = segment_stream(lengths, k_total, 31)
    g_rgb, g_depth, g_mask, b = ray_gradients(n_rays, 32)
    t = [torch.from_numpy(a).to(dev) for a in (sigma, rgb, z, off, cnt, g_rgb, g_depth, g_mask, b)]
    return (*t[:8], add_inf_z, t[8] if bkg else None, white_bkg)


@pytest.mark.parametrize("kind", F_STREAMS)
@pytest.mark.parametrize("add_inf_z,white_bkg,bkg", F_FLAGS)
def test_segment_march_bwd_kernel_on_long_tail_streams(dev, kind, add_inf_z, white_bkg, bkg):
    # 1e-4 of the largest value: expf, and the warp scans' tree order in
    # place of the plain version's sequential order
    args = _f_args(kind, add_inf_z, white_bkg, bkg, dev)
    launches = segment_march_bwd.launches
    (ds, dr), (rs, rr) = segment_march_bwd(*args), segment_march_bwd_reference(*args)
    assert segment_march_bwd.launches == launches + 1
    _scaled_close(ds, rs, 1e-4)
    _scaled_close(dr, rr, 1e-4)
    k_in = int(args[4].sum())
    assert torch.all(ds[k_in:] == 0) and torch.all(dr[k_in:] == 0)  # padding rows untouched


def test_segment_march_bwd_kernel_is_deterministic(dev):
    # no atomics: two calls agree bit for bit
    args = _f_args("long_tail", False, False, True, dev)
    (a, b), (c, d) = segment_march_bwd(*args), segment_march_bwd(*args)
    assert torch.equal(a, c) and torch.equal(b, d)


B_STREAMS = ("ray", "one_cell", "padded", "ragged")


@pytest.mark.parametrize("kind", B_STREAMS)
@pytest.mark.parametrize("n_feat", [1, 2, 4, 8])
@pytest.mark.parametrize("read_bf16", [True, False])
@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_encode_kernel_on_streams(dev, kind, n_feat, read_bf16, variant):
    # bit-identical: the same entries and weights as the plain version,
    # summed in its corner order with unfused f32 multiplies and adds
    xyz, _ = _e_stream(kind, n_feat, dev)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=n_feat, hashmap_size=14, side=2.0, include_input=False)
    gen = torch.Generator(device=dev).manual_seed(n_feat)
    table = torch.rand((16, 1 << 14, n_feat), generator=gen, device=dev) * 2 - 1
    args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, variant, read_bf16)
    launches = hash_encode.launches
    out = hash_encode(*args)
    assert hash_encode.launches == launches + 1
    assert torch.equal(out, hash_encode_reference(*args))


@pytest.mark.parametrize("n_levels", [2, 3, 16, 17, 33])
@pytest.mark.parametrize("n_feat", [1, 2, 8])
def test_hash_encode_kernel_takes_any_number_of_levels(dev, n_levels, n_feat):
    # a block takes 16 levels at once; fewer levels leave warps idle, more
    # go in chunks: every (point, level, feature) written once, bit-identical
    xyz = torch.from_numpy(ray_stream(1000, 22)).to(dev)
    enc = HashGridEmbedder(n_levels=n_levels, n_feat_per_entry=n_feat, hashmap_size=12, side=2.0, base_res=4,
                           max_res=max(8, 64 * n_levels), include_input=False)
    gen = torch.Generator(device=dev).manual_seed(n_levels)
    table = torch.rand((n_levels, 1 << 12, n_feat), generator=gen, device=dev) * 2 - 1
    args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, "pair", True)
    out = hash_encode(*args)
    assert out.shape == (1000, n_levels * n_feat)
    assert torch.equal(out, hash_encode_reference(*args))


def test_hash_encode_kernel_at_the_recipe_scale(dev):
    # 2^18 + 5 ray-ordered points (a ragged last block) at T = 2^19, as
    # kernel E's scale test
    xyz = torch.from_numpy(ray_stream((1 << 18) + 5, 23)).to(dev)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False)
    table = torch.rand((16, 1 << 19, 2), generator=torch.Generator(device=dev).manual_seed(4), device=dev) - 0.5
    args = (xyz, table, enc.resolutions, enc.aabb_min, enc.aabb_len, "quad", True)
    assert torch.equal(hash_encode(*args), hash_encode_reference(*args))


def test_hash_encode_kernel_follows_the_table_in_place(dev):
    # the kernel reads the table every call: after an in-place update (as
    # the optimizer makes one a step) it gives the new table's encoding
    xyz = torch.from_numpy(ray_stream(4096, 24)).to(dev)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=14, side=2.0, include_input=False,
                           dtype="bfloat16").to(dev)
    before = enc(xyz).clone()
    with torch.no_grad():
        enc.embeddings.add_(torch.randn_like(enc.embeddings))
    after = enc(xyz)
    args = (xyz, enc.embeddings.detach(), enc.resolutions, enc.aabb_min, enc.aabb_len, enc.variant, True)
    assert torch.equal(after, hash_encode_reference(*args)) and not torch.equal(after, before)


def test_hash_encode_binding_refuses_a_misaligned_table(dev):
    # a float2 load a corner for F = 2 needs an 8-byte aligned table
    from arcnerf_torch.ops import cuda_lib

    xyz, res = torch.zeros((16, 3), device=dev), torch.tensor([2, 3], dtype=torch.int32, device=dev)
    table = torch.zeros(2 * 16 * 2 + 1, device=dev)[1:].view(2, 16, 2)
    with pytest.raises(ValueError, match="aligned to 8 bytes"):
        cuda_lib.ops().hash_encode_fwd(xyz, table, res, 4, (0, 0, 0), (1, 1, 1), 0, True)


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


@pytest.mark.parametrize("shared", [True, False])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("n", [1, 3, 4, 5, 1023, 1024])
def test_lane_gather_kernel_odd_shapes(dev, m, n, shared):
    # bit-identical at widths that are and are not a multiple of 4
    gen = torch.Generator(device=dev).manual_seed(m * 1031 + n)
    src = torch.randn((m, 50), generator=gen, device=dev)
    idx = torch.randint(0, 50, (1 if shared else m, n), generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(gs.lane_gather(src, idx), gs.lane_gather_reference(src, idx))


@pytest.mark.parametrize("shared", [True, False])
def test_lane_gather_kernel_takes_index_views_at_a_4_byte_offset(dev, shared):
    gen = torch.Generator(device=dev).manual_seed(12)
    m, n = 8, 1024
    rows = 1 if shared else m
    src = torch.randn((m, 2048), generator=gen, device=dev)
    storage = torch.randint(0, 2048, (1 + rows * n,), generator=gen, device=dev, dtype=torch.int32)
    idx = storage[1:].view(rows, n)
    assert idx.data_ptr() % 16 == 4
    assert torch.equal(gs.lane_gather(src, idx), gs.lane_gather_reference(src, idx))


@pytest.mark.parametrize("n_rows", [1, 3, 37, 999, 4097])
@pytest.mark.parametrize("width,dtype", [(128, torch.bfloat16), (128, torch.float32), (4, torch.float32),
                                         (24, torch.bfloat16), (256, torch.float32)])
def test_row_gather_kernel_odd_shapes(dev, n_rows, width, dtype):
    # bit-identical: 256- and 512-byte rows (a half-warp and a warp a row),
    # 16-, 48- and 1024-byte rows, row counts that leave a group part-full
    gen = torch.Generator(device=dev).manual_seed(n_rows * 7 + width)
    table = torch.randn((300, width), generator=gen, device=dev).to(dtype)
    idx = torch.randint(0, 300, (n_rows,), generator=gen, device=dev, dtype=torch.int32)
    assert torch.equal(gs.row_gather(table, idx), gs.row_gather_reference(table, idx))


def test_gather_kernels_replay_from_a_cuda_graph(dev):
    # G and H captured once, replayed on new inputs written in place
    gen = torch.Generator(device=dev).manual_seed(13)
    table = torch.randn((2048, 128), generator=gen, device=dev).to(torch.bfloat16)
    idx = torch.randint(0, 2048, (1024,), generator=gen, device=dev, dtype=torch.int32)
    src = torch.randn((8, 2048), generator=gen, device=dev)
    lanes = torch.randint(0, 2048, (1, 1024), generator=gen, device=dev, dtype=torch.int32)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gs.row_gather(table, idx), gs.lane_gather(src, lanes)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = gs.row_gather.launches, gs.lane_gather.launches
    with torch.cuda.graph(graph):
        rows, picked = gs.row_gather(table, idx), gs.lane_gather(src, lanes)
    assert (gs.row_gather.launches, gs.lane_gather.launches) == (launches[0] + 1, launches[1] + 1)
    for _ in range(2):
        idx.copy_(torch.randint(0, 2048, (1024,), generator=gen, device=dev, dtype=torch.int32))
        src.copy_(torch.randn((8, 2048), generator=gen, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(rows, gs.row_gather_reference(table, idx))
        assert torch.equal(picked, gs.lane_gather_reference(src, lanes))


def _binding_refusals(dev):
    from arcnerf_torch.ops import cuda_lib

    ops = cuda_lib.ops()
    f32, i32, i64 = dict(device=dev), dict(device=dev, dtype=torch.int32), dict(device=dev, dtype=torch.int64)
    zeros = torch.zeros
    x, packed = zeros((64, 32), **f32), zeros((32 * 64 + 64 * 16,), device=dev, dtype=torch.bfloat16)
    xyz, res = zeros((16, 3), **f32), zeros((2,), **i32)
    march = (zeros(8, **f32), zeros((8, 3), **f32), zeros(8, **f32), zeros(2, **i64), zeros(2, **i64))
    return {
        "row_gather int64 index": (lambda: gs.row_gather(zeros((8, 4), **f32), zeros(2, **i64)), "int32"),
        "row_gather 12-byte rows": (lambda: gs.row_gather(zeros((8, 3), **f32), zeros(2, **i32)), "16-byte"),
        "row_gather f64 table": (lambda: gs.row_gather(zeros((8, 4), device=dev, dtype=torch.float64),
                                                       zeros(2, **i32)), "f32 or bf16"),
        "row_gather host index": (lambda: gs.row_gather(zeros((8, 4), **f32), torch.zeros(2, dtype=torch.int32)),
                                  "CUDA"),
        "row_gather unaligned table": (lambda: gs.row_gather(zeros(8 * 4 + 1, **f32)[1:].view(8, 4),
                                                             zeros(2, **i32)), "16-byte"),
        "lane_gather row mismatch": (lambda: gs.lane_gather(zeros((8, 4), **f32), zeros((3, 2), **i32)),
                                     "do not match"),
        "lane_gather 1-D index": (lambda: gs.lane_gather(zeros((8, 4), **f32), zeros(2, **i32)), "2-D index"),
        "lane_gather strided src": (lambda: gs.lane_gather(zeros((8, 8), **f32)[:, ::2], zeros((1, 2), **i32)),
                                    "contiguous"),
        "scatter_add_rows width 6": (lambda: gs.scatter_add_rows(zeros((8, 6), **f32), zeros(2, **i32),
                                                                 zeros((2, 6), **f32)), "multiple of 4"),
        "scatter_add_rows unaligned": (lambda: gs.scatter_add_rows(zeros(8 * 4 + 1, **f32)[1:].view(8, 4),
                                                                   zeros(2, **i32), zeros((2, 4), **f32)), "16-byte"),
        "build_update_rows five offsets": (lambda: gs.build_update_rows(zeros(4, **i32), zeros((4, 10), **f32),
                                                                        (0, 1, 2, 3, 4), 2), "1-4 offsets"),
        "fused_mlp_fwd packed size": (lambda: ops.fused_mlp_fwd(x, packed[:5], 32, 1, 16, 16, False),
                                      "packed weights"),
        "fused_mlp_bwd pre type": (lambda: ops.fused_mlp_bwd(x, zeros((64, 16), **f32), packed,
                                                             zeros((1, 64, 64), **f32), 32, 1, 16, 16), "bfloat16"),
        "hash_encode int64 levels": (lambda: ops.hash_encode_fwd(xyz, zeros((2, 16, 2), **f32), res.long(), 4,
                                                                 (0, 0, 0), (1, 1, 1), 0, True), "int32"),
        "hash_encode unknown variant": (lambda: ops.hash_encode_fwd(xyz, zeros((2, 16, 2), **f32), res, 4,
                                                                    (0, 0, 0), (1, 1, 1), 7, True),
                                        "does not take these arguments"),
        "hash_encode_bwd g size": (lambda: ops.hash_encode_bwd(xyz, zeros((16, 3), **f32), res, 2, 4, 2, (0, 0, 0),
                                                               (1, 1, 1), 0), "values in g"),
        "segment_march int32 offsets": (lambda: ops.segment_march_fwd(*march[:3], march[3].int(), march[4], False,
                                                                      None, False), "int64"),
        "segment_march_bwd g_rgb size": (lambda: ops.segment_march_bwd(*march, zeros((3, 3), **f32),
                                                                       zeros(2, **f32), zeros(2, **f32), False, None,
                                                                       False), "g_rgb"),
    }


_REFUSALS = ["row_gather int64 index", "row_gather 12-byte rows", "row_gather f64 table", "row_gather host index",
             "row_gather unaligned table", "lane_gather row mismatch", "lane_gather 1-D index",
             "lane_gather strided src", "scatter_add_rows width 6", "scatter_add_rows unaligned",
             "build_update_rows five offsets", "fused_mlp_fwd packed size", "fused_mlp_bwd pre type",
             "hash_encode int64 levels", "hash_encode unknown variant", "hash_encode_bwd g size",
             "segment_march int32 offsets", "segment_march_bwd g_rgb size"]


@pytest.mark.parametrize("case", _REFUSALS)
def test_binding_refuses_what_the_kernels_do_not_take(dev, case):
    # ValueError with the words of the Python checks the binding replaced;
    # no launch is counted
    cases = _binding_refusals(dev)
    assert sorted(cases) == sorted(_REFUSALS)
    call, words = cases[case]
    launches = [f.launches for f in (gs.row_gather, gs.lane_gather, gs.scatter_add_rows, gs.build_update_rows)]
    with pytest.raises(ValueError, match=words):
        call()
    assert launches == [f.launches for f in (gs.row_gather, gs.lane_gather, gs.scatter_add_rows,
                                             gs.build_update_rows)]


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


# ------------------------------------------- kernel C at each group width

C_GROUPS = (32, 8)
C_STREAMS = ("synthetic", "long_tail", "cap16", "clipped")
C_FLAGS = [(a, white, bkg) for a in (False, True) for white, bkg in ((False, False), (True, False), (False, True))]


def _c_args(kind, add_inf_z, white_bkg, bkg, dev):
    """Kernel C's arguments on 4096 rays: 0-32 samples a ray; 0-512 (every
    chunk boundary among them); the serving cap's 0-16, 40 % empty; or the
    0-512 stream under a budget that clips one ray and empties the rest."""
    n_rays = 4096
    if kind == "cap16":
        rng = np.random.default_rng(35)
        lengths = np.where(rng.random(n_rays) < 0.4, 0, rng.integers(0, 17, size=n_rays))
    else:
        lengths = long_tail_lengths(n_rays, 33, max_len=32 if kind == "synthetic" else 512)
    k_total = int(lengths.sum()) * 2 // 3 if kind == "clipped" else int(lengths.sum()) + 100
    t = [torch.from_numpy(a).to(dev) for a in segment_stream(lengths, k_total, 34)]
    b = torch.from_numpy(ray_gradients(n_rays, 36)[3]).to(dev)
    return (*t, add_inf_z, b if bkg else None, white_bkg)


@pytest.mark.parametrize("kind", C_STREAMS)
@pytest.mark.parametrize("add_inf_z,white_bkg,bkg", C_FLAGS)
@pytest.mark.parametrize("group", C_GROUPS)
def test_segment_march_kernel_at_each_group_width(dev, kind, add_inf_z, white_bkg, bkg, group):
    # rtol = atol = 1e-4 (chip_smoke.C_TOL): expf and the group's tree order
    # in place of the plain version's sequential order; no atomics, so two
    # calls agree bit for bit
    args = _c_args(kind, add_inf_z, white_bkg, bkg, dev)
    launches = segment_march.launches
    out, again = ray_helper.segment_march_fwd(*args, group=group), ray_helper.segment_march_fwd(*args, group=group)
    assert segment_march.launches == launches + 2
    ref = segment_march_reference(*args)
    for key in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(out[key], ref[key], rtol=1e-4, atol=1e-4, msg=key)
        assert torch.equal(out[key], again[key]), key


def test_segment_march_passes_its_group_to_the_kernel(dev):
    # the entry the serving path takes: segment_march(..., group=march_group(16))
    sigma, rgb, z, off, cnt, *_ = _c_args("cap16", False, False, False, dev)
    group = ray_helper.march_group(16)
    out = segment_march(sigma, rgb, z, off, cnt, white_bkg=True, group=group)
    ref = segment_march_reference(sigma, rgb, z, off, cnt, white_bkg=True)
    for key in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(out[key], ref[key], rtol=1e-4, atol=1e-4)
    for other in (5, 16, 4):
        with pytest.raises(ValueError, match="groups of 32 or 8"):
            ray_helper.segment_march_fwd(sigma, rgb, z, off, cnt, group=other)


# --------------------------------------------- kernel I's W = 1 routes

# the route's constants, read from the kernel's source
I_ROUTE = partition_constants()
# (updates, table entries): the RED kernel's sizes, then the partition's
# (tables whose last bucket is partial)
I_SIZES = [(1 << 20, (1 << 18) + 1000), (1 << 22, (1 << 20) + 1000), (1 << 24, (1 << 23) + 1000),
           (1 << 25, (1 << 23) + 1000)]


@pytest.mark.parametrize("kind", ["uniform", "one_bucket", "one_index", "bucket_boundary", "empty_buckets"])
@pytest.mark.parametrize("n,n_table", I_SIZES)
def test_scatter_add_rows_w1_on_index_sets(dev, kind, n, n_table):
    # against the sums in float64: 1e-5 of the largest (chip_smoke.I_TOL)
    # plus the growth of f32 rounding over the m updates of one entry in
    # any order, 4 eps sqrt(m sum g^2) (2^25 updates into one entry round
    # by ~3 in a sum of ~6000)
    from arcnerf_torch.tools.scatter_streams import index_set, values

    idx = torch.from_numpy(index_set(kind, n, n_table, 37, I_ROUTE["kLogBucket"])).to(dev)
    g = torch.from_numpy(values(n, 38)).to(dev)
    out = torch.ones((n_table, 1), device=dev)
    launches = gs.scatter_add_rows.launches
    assert gs.scatter_add_rows(out, idx, g) is out
    assert gs.scatter_add_rows.launches == launches + 1
    ref = torch.ones((n_table, 1), device=dev, dtype=torch.float64).index_add_(0, idx, g.double())
    m = torch.zeros(n_table, device=dev, dtype=torch.float64).index_add_(0, idx, torch.ones_like(g[:, 0]).double())
    s2 = torch.zeros(n_table, device=dev, dtype=torch.float64).index_add_(0, idx, g[:, 0].double() ** 2)
    tol = 1e-5 * float(ref.abs().max()) + 4 * float(torch.finfo(torch.float32).eps) * float((m * s2).sqrt().max())
    assert torch.isfinite(out).all() and float((out.double() - ref).abs().max()) <= tol
    untouched = m == 0
    assert torch.all(out[untouched] == 1)


def _scratch_bytes(n_table, w, n):
    import ctypes

    from arcnerf_torch.ops import cuda_lib

    fn = cuda_lib.lib().arcnerf_scatter_add_rows_scratch_bytes
    fn.argtypes, fn.restype = [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong], ctypes.c_longlong
    return fn(n_table, w, n)


def _route_cases():
    lo, t = I_ROUTE["kPartitionMinUpdates"], I_ROUTE["kPartitionMinTable"]
    b = I_ROUTE["kMaxBuckets"] << I_ROUTE["kLogBucket"]
    # (n_table, n, the partition expected)
    return [(t, lo - 1, False), (t, lo, True), (t - 1, lo, False), (b, lo, True), (b + 1, lo, False)]


@pytest.mark.parametrize("n_table,n,partition", _route_cases())
def test_scatter_add_rows_routes_around_the_threshold(dev, n_table, n, partition):
    assert (_scratch_bytes(n_table, 1, n) > 0) == partition
    gen = torch.Generator(device=dev).manual_seed(39)
    idx = torch.randint(0, n_table, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((n, 1), generator=gen, device=dev)
    out = gs.scatter_add_rows(torch.zeros((n_table, 1), device=dev), idx, g)
    _scaled_close(out, gs.scatter_add_rows_reference(torch.zeros((n_table, 1), device=dev), idx, g), 1e-5)


def test_scatter_add_rows_partition_needs_its_scratch(dev):
    # the binding allocates the scratch at the source's size; the C entry
    # point refuses none or too little, and takes exactly that much
    from arcnerf_torch.ops import cuda_lib

    n, n_table = I_ROUTE["kPartitionMinUpdates"], I_ROUTE["kPartitionMinTable"]
    assert _scratch_bytes(n_table, 4, n) == 0 and _scratch_bytes(n_table, 1, n - 1) == 0
    idx, g = torch.zeros(n, dtype=torch.int32, device=dev), torch.ones((n, 1), device=dev)
    out = torch.zeros((n_table, 1), device=dev)
    need = _scratch_bytes(n_table, 1, n)
    entry = cuda_lib.lib().arcnerf_scatter_add_rows
    stream = cuda_lib.stream_handle(dev)
    for scratch in (None, torch.empty(need - 1, dtype=torch.uint8, device=dev)):
        ptr, size = (None, 0) if scratch is None else (scratch.data_ptr(), scratch.numel())
        assert entry(out.data_ptr(), n_table, 1, idx.data_ptr(), g.data_ptr(), n, ptr, size, stream) == \
            cuda_lib.BAD_ARGUMENT
    scratch = torch.empty(need, dtype=torch.uint8, device=dev)
    cuda_lib.check(entry(out.data_ptr(), n_table, 1, idx.data_ptr(), g.data_ptr(), n, scratch.data_ptr(), need,
                         stream), "scatter_add_rows")
    gs.scatter_add_rows(out, idx, g)
    torch.cuda.synchronize()
    assert float(out[0, 0]) == 2 * n and float(out.sum()) == 2 * n


@pytest.mark.parametrize("kind", ["uniform", "bucket_boundary"])
def test_scatter_add_rows_partition_repeats_over_dirty_shared_memory(dev, kind):
    # the largest table the route takes (2048 buckets: two a thread in each
    # block's scan), every call after a kernel that fills the shared memory
    # of every SM with 1.0f: a slot read before it was written would add
    # 1.0 or lose an update; 12 calls, each within the bound of the test above
    from arcnerf_torch.ops import cuda_lib
    from arcnerf_torch.tools.scatter_streams import index_set, values
    from design_studies import scatter_designs

    n_table, n = I_ROUTE["kMaxBuckets"] << I_ROUTE["kLogBucket"], 1 << 25
    assert _scratch_bytes(n_table, 1, n) > 0
    dirty = scatter_designs.load().design_dirty_shared
    idx = torch.from_numpy(index_set(kind, n, n_table, 41, I_ROUTE["kLogBucket"])).to(dev)
    g = torch.from_numpy(values(n, 42)).to(dev)
    ref = torch.zeros((n_table, 1), device=dev, dtype=torch.float64).index_add_(0, idx, g.double())
    m = torch.zeros(n_table, device=dev, dtype=torch.float64).index_add_(0, idx, torch.ones_like(g[:, 0]).double())
    s2 = torch.zeros(n_table, device=dev, dtype=torch.float64).index_add_(0, idx, g[:, 0].double() ** 2)
    tol = 1e-5 * float(ref.abs().max()) + 4 * float(torch.finfo(torch.float32).eps) * float((m * s2).sqrt().max())
    out = torch.empty((n_table, 1), device=dev)
    for _ in range(12):
        out.zero_()
        assert dirty(1.0, cuda_lib.stream_handle(dev)) == 0
        gs.scatter_add_rows(out, idx, g)
        torch.cuda.synchronize()
        assert float((out.double() - ref).abs().max()) <= tol


@pytest.mark.parametrize("n_table,n", [(1 << 23, 1 << 24), (64 ** 3, 1 << 18)])
def test_scatter_add_rows_replays_from_a_cuda_graph(dev, n_table, n):
    # both W = 1 routes captured once (the partition's scratch from the
    # graph's pool), replayed on new indices and values written in place
    gen = torch.Generator(device=dev).manual_seed(40)
    idx = torch.randint(0, n_table, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn((n, 1), generator=gen, device=dev)
    out = torch.zeros((n_table, 1), device=dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gs.scatter_add_rows(out, idx, g)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gs.scatter_add_rows(out, idx, g)
    for _ in range(2):
        idx.copy_(torch.randint(0, n_table, (n,), generator=gen, device=dev, dtype=torch.int32))
        g.copy_(torch.randn((n, 1), generator=gen, device=dev))
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _scaled_close(out, gs.scatter_add_rows_reference(torch.zeros((n_table, 1), device=dev), idx, g), 1e-5)
