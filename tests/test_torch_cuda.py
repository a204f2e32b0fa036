"""arcnerf_torch's CUDA kernels (A-L, the fused sampler) vs their plain
PyTorch versions on the card, the autograd Functions' dispatch to them, and
the gather/scatter wrappers' launch counters.

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
import arcnerf_torch.models.base_modules.sample_compact as sampler
import arcnerf_torch.render.ray_helper as ray_helper
from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, hash_encode, hash_encode_bwd,
                                                       hash_encode_bwd_reference, hash_encode_reference)
from arcnerf_torch.ops.fused_mlp import (fused_mlp, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd,
                                         fused_mlp_reference)
from arcnerf_torch.render.ray_helper import (segment_march, segment_march_bwd, segment_march_bwd_reference,
                                             segment_march_reference)
from arcnerf_torch.tools.hash_streams import one_cell_stream, pad_stream, ray_stream
from arcnerf_torch.tools.march_streams import long_tail_lengths, ray_gradients, segment_stream
from arcnerf_torch.tools.sample_streams import diagonal_rays, ladder_bitfield, ladder_rand, ladder_rays, ladder_volume
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


# ------------------------------- kernel J: a block an SM, reads then writes

# term count -> (offsets, n_feat), n_off in 1..4
J_TERMS = {1: ((0,), 1), 2: ((0, 2), 1), 3: ((0, 5, 9), 1), 4: ((0, 2), 2), 5: ((0,), 5), 6: ((0, 2, 62), 2),
           7: ((0,), 7), 8: ((0, 2, 62, 64), 2)}
J_ROWS = (1, 31, 32, 33, 777, 1 << 19, 1 << 20)


def _j_inputs(dev, k, n_terms, seed, low=0, high=60):
    gen = torch.Generator(device=dev).manual_seed(seed)
    lane0 = torch.randint(low, high, (k,), generator=gen, device=dev, dtype=torch.int32)
    return lane0, torch.rand((k, n_terms), generator=gen, device=dev)


def _j_equal(lane0, vals, offs, n_feat):
    launches = gs.build_update_rows.launches
    out = gs.build_update_rows(lane0, vals, offs, n_feat)
    assert gs.build_update_rows.launches == launches + 1
    assert torch.equal(out, gs.build_update_rows_reference(lane0, vals, offs, n_feat))


@pytest.mark.parametrize("k", J_ROWS)
@pytest.mark.parametrize("n_terms", sorted(J_TERMS))
def test_build_update_rows_every_term_count_and_row_count(dev, n_terms, k):
    # bit-identical: a lane sums its terms from 0 in the plain version's
    # order; 2^20 rows of 7 or 8 terms take two launches (rounds)
    offs, n_feat = J_TERMS[n_terms]
    _j_equal(*_j_inputs(dev, k, n_terms, 50 + n_terms), offs, n_feat)


@pytest.mark.parametrize("k", [33, 4099])
@pytest.mark.parametrize("n_terms", [1, 4, 8])
def test_build_update_rows_drops_terms_outside_the_row(dev, n_terms, k):
    # lane0 negative, or pushing its terms past lane 127: those terms drop
    offs, n_feat = J_TERMS[n_terms]
    lane0, vals = _j_inputs(dev, k, n_terms, 60, low=-70, high=200)
    assert bool((lane0 < 0).any()) and bool((lane0 > 127 - 64).any())
    _j_equal(lane0, vals, offs, n_feat)


@pytest.mark.parametrize("k", [33, 777, 1 << 19])
def test_build_update_rows_sums_overlapping_offsets_in_order(dev, k):
    # offsets (0, 1) with F = 2: terms 1 and 2 of a row land on one lane
    lane0, vals = _j_inputs(dev, k, 4, 61, low=-3, high=130)
    _j_equal(lane0, vals, (0, 1), 2)


@pytest.mark.parametrize("k", [777, (1 << 19) + 3])
@pytest.mark.parametrize("n_terms", [3, 6])
def test_build_update_rows_takes_inputs_off_16_byte_bounds(dev, n_terms, k):
    # rows of 12 or 24 bytes, and both inputs viewed one element into their
    # buffers, so no block's range starts on a 16-byte bound by itself
    offs, n_feat = J_TERMS[n_terms]
    lane0, vals = _j_inputs(dev, k + 1, n_terms, 62)
    lane0 = lane0[1:]
    vals = vals.reshape(-1)[1:1 + k * n_terms].view(k, n_terms)
    assert vals.data_ptr() % 16 != 0 and lane0.data_ptr() % 16 != 0
    _j_equal(lane0, vals, offs, n_feat)


@pytest.mark.parametrize("k,n_terms", [(1 << 20, 8), (1 << 19, 4)])
def test_build_update_rows_replays_from_a_cuda_graph(dev, k, n_terms):
    # captured once (quad's terms at 2^20 rows: two launches in the graph),
    # replayed 20 times on new inputs written in place into poisoned rows
    offs, n_feat = J_TERMS[n_terms]
    lane0, vals = _j_inputs(dev, k, n_terms, 63)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        gs.build_update_rows(lane0, vals, offs, n_feat)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rows = gs.build_update_rows(lane0, vals, offs, n_feat)
    new_lane0, new_vals = _j_inputs(dev, k, n_terms, 64, low=-5, high=130)
    lane0.copy_(new_lane0)
    vals.copy_(new_vals)
    rows.fill_(float("nan"))
    for _ in range(20):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(rows, gs.build_update_rows_reference(lane0, vals, offs, n_feat))


# ------------------------------------------------- strided steps as graphs

# the NGP recipe at a small size (64-wide nets, as kernels A and D take)
GRAPH_ARGV = ["--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
              "--model.obj_bound.volume.n_grid", "16", "--model.rays.n_sample", "64",
              "--model.obj_bound.log_max_allowance", "12", "--dataset.train.n_imgs", "2", "--dataset.train.wh",
              "[16,16]", "--dataset.val.n_imgs", "1", "--dataset.val.wh", "[16,16]", "--n_rays", "256",
              "--device", "cuda:0"]
# graph replays against eager steps from one state: kernel E adds the table
# gradient with float atomics in an order that changes from run to run, so
# the two runs part in the last bits after step 1 (the graph's draws, and
# so the picks and the valid-sample counts, stay exactly equal); the loss of
# each step within 1e-2 relative, each parameter within 5e-2 relative norm
GRAPH_LOSS_TOL, GRAPH_PARAM_TOL = 1e-2, 5e-2


def _graph_trainer(tmp_path, name, scan_steps):
    import os

    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfgs = update_configs_by_dotlist(load_configs(os.path.join(root, "configs/expr/synthetic_ngp.yaml")),
                                     GRAPH_ARGV + ["--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps",
                                                   str(scan_steps)])
    return ArcNerfTrainer(cfgs)


def test_graph_strides_follow_the_eager_steps(dev, tmp_path):
    eager, graph = _graph_trainer(tmp_path, "eager", 1), _graph_trainer(tmp_path, "graph", 4)
    picks, counts = [], []
    for e in range(12):
        counts.append(int(eager.train_steps(e, 1)["n_valid_pts"]))
        picks.append(eager.pipeline.last_picks.clone())
    captures = encoding.hash_encode_bwd.launches
    graph_picks, graph_counts = [], []
    for e in range(0, 12, 4):
        graph.train_steps(e, 4)
        step = graph.step_graphs[(256, None)]
        graph_picks += list(step.picks.clone())
        graph_counts += [int(c) for c in step.ring["n_valid_pts"]]
    torch.cuda.synchronize()
    # the counters count Python calls: the bucket's warm-up step and its capture
    assert encoding.hash_encode_bwd.launches == captures + 2
    assert step.graph is not None and step.capture_seconds > 0
    assert graph_counts == counts and all(torch.equal(a, b) for a, b in zip(picks, graph_picks))
    losses_e, losses_g = torch.stack(eager.loss_history).cpu(), torch.stack(graph.loss_history).cpu()
    torch.testing.assert_close(losses_g, losses_e, rtol=GRAPH_LOSS_TOL, atol=0)
    assert torch.equal(eager.generator.get_state(), graph.generator.get_state())
    params_g = dict(graph.model.named_parameters())
    for name, p in eager.model.named_parameters():
        rel = float((params_g[name] - p).detach().norm() / p.detach().norm())
        assert rel < GRAPH_PARAM_TOL, (name, rel)


def test_graph_capture_failure_raises(dev, tmp_path):
    # a host read inside the step cannot be captured: the capture raises and
    # nothing runs the step eagerly in its place
    trainer = _graph_trainer(tmp_path, "fails", 4)
    update = trainer.update

    def update_with_host_read(feed):
        stats = update(feed)
        float(stats["loss"])
        return stats

    trainer.update = update_with_host_read
    with pytest.raises(RuntimeError):
        trainer.train_steps(0, 4)
    torch.cuda.synchronize()
    step = trainer.step_graphs[(256, None)]
    assert step.graph is None and trainer.step == 0
    assert int(step.slot) == 1  # the bucket's eager warm-up step ran; no other


# the render tiers on the card: the NGP recipe at a small size with seeded
# weights and the spheres' occupancy, a 32x32 view
TIER_ARGV = ["--model.geometry.encoder.hashmap_size", "14", "--model.obj_bound.volume.n_grid", "32",
             "--model.rays.n_sample", "64", "--model.obj_bound.log_max_allowance", "14"]
TIER_CHUNK = 256  # 256 rays x 64 samples fill the 2^14 budget: no chunk clips
FAST_TOL, WINDOW_TOL = 5e-2, 1e-3  # fast against exact (the JAX test's bound); windows against uncapped


def _tier_engine(device):
    import os

    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.models import build_model
    from arcnerf_torch.render.engine import RenderEngine
    from arcnerf_torch.utils.cfgs import dict_to_obj, load_configs, update_configs_by_dotlist

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfgs = update_configs_by_dotlist(load_configs(os.path.join(root, "configs/expr/synthetic_ngp.yaml")), TIER_ARGV)
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0)).to(device).eval()
    bound = model.init_bound_state(device)
    bound["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(32, 2.0)).to(device)
    sample = get_dataset(dict_to_obj({"val": {"type": "Synthetic", "n_imgs": 1, "wh": [32, 32], "cam_radius": 2.5,
                                              "white_bkg": True, "center_pixel": True}}), "data", "val")[0]
    return RenderEngine(model, cfgs, bound, device), sample


def test_render_tiers_fast_matches_exact_on_the_card(dev):
    engine, sample = _tier_engine(dev)
    engine.set_render_cap(8)
    exact = engine.render_image(sample, chunk_rays=TIER_CHUNK, bkg_color=(1.0, 1.0, 1.0))
    counts = (fused_mlp.launches, hash_encode.launches, segment_march.launches)
    fast, stats = engine.render_image_fast(sample, chunk_rays=TIER_CHUNK, hit_frac=1.0, bkg_color=(1.0, 1.0, 1.0))
    assert fast["rgb"].is_cuda and stats["clipped_rays"] == 0 and 0.0 < stats["hit_frac"] < 1.0
    assert fused_mlp.launches > counts[0] and hash_encode.launches > counts[1] and segment_march.launches > counts[2]
    assert float((fast["rgb"] - exact["rgb"]).abs().max()) <= FAST_TOL
    # the card's kernels against the plain versions on the CPU, same tier
    cpu_engine, _ = _tier_engine("cpu")
    cpu_engine.set_render_cap(8)
    cpu, cpu_stats = cpu_engine.render_image_fast(sample, chunk_rays=TIER_CHUNK, hit_frac=1.0,
                                                  bkg_color=(1.0, 1.0, 1.0))
    assert cpu_stats == stats
    d_rgb = (fast["rgb"].cpu() - cpu["rgb"]).abs()
    assert float(d_rgb.max()) <= 2e-2 and float(d_rgb.mean()) <= 1e-3


def test_render_tiers_windowed_matches_uncapped_on_the_card(dev):
    engine, sample = _tier_engine(dev)
    engine.set_render_cap(None)
    full = engine.render_image(sample, chunk_rays=TIER_CHUNK, bkg_color=(1.0, 1.0, 1.0))
    engine.set_render_cap(8, window=True)
    counts = (fused_mlp.launches, hash_encode.launches)
    win, stats = engine.render_image_windowed(sample, n_pass=8, chunk_rays=TIER_CHUNK, bkg_color=(1.0, 1.0, 1.0),
                                              eps=0.0)
    assert win["rgb"].is_cuda and stats["clipped_alive"] == 0 and stats["alive_at_end"] == 0
    assert len(stats["pass_budget_rays"]) >= 1
    assert fused_mlp.launches > counts[0] and hash_encode.launches > counts[1]
    for k in ("rgb", "depth", "mask"):
        assert float((win[k] - full[k]).abs().max()) <= WINDOW_TOL * (4 if k == "depth" else 1), k


# ------------------------------------------------------- the fused sampler

# (rays, bitfield, ladder slots, jitter, cap, budget, miss share) at the main
# path's shapes: a training step (2^18 budget: the scene's samples overflow
# it, and far more those of a half-occupied grid), a 16384-ray serving chunk
# at cap 16 and the 1024-ray last chunk of an 800x800 frame; rays that all
# miss, an empty bitfield, a full one whose budget covers every sample; a
# ragged ladder (not a multiple of 32)
SAMPLER_CASES = {
    "train_step": (16384, "scene", 512, True, None, 1 << 18, 0.1),
    "train_step_half": (16384, "half", 512, True, None, 1 << 18, 0.1),
    "serve_chunk": (16384, "scene", 512, False, 16, 1 << 18, 0.1),
    "serve_last_chunk": (1024, "scene", 512, False, 16, 16384, 0.1),
    "all_miss": (4096, "scene", 512, True, None, 1 << 16, 1.0),
    "empty_bitfield": (4096, "empty", 512, True, None, 1 << 16, 0.1),
    "full_covered": (1024, "full", 512, True, None, 1024 * 512, 0.0),
    "full_covered_capped": (1024, "full", 512, False, 16, 1024 * 512, 0.0),
    "ragged_ladder": (3000, "half", 100, True, None, 1 << 16, 0.2),
    # the NeuS cell's sampler: 2048 rays on its 1024-slot ladder, 2^18 budget
    "neus_step": (2048, "scene", 1024, True, None, 1 << 18, 0.1),
    "neus_step_half": (2048, "half", 1024, True, None, 1 << 18, 0.1),
}
SAMPLER_KEYS = ("z", "pts", "dirs", "off", "cnt", "n_valid", "ray_has")


def _sampler_inputs(name, dev, seed=0):
    n_rays, kind, n_pts, jitter, cap, budget, miss = SAMPLER_CASES[name]
    vol = ladder_volume()
    rays_o, rays_d = ladder_rays(vol, n_rays, seed, miss, device=dev)
    rand = ladder_rand(n_rays, n_pts, seed + 1, device=dev) if jitter else None
    return vol, ladder_bitfield(kind, vol, seed, device=dev), rays_o, rays_d, n_pts, budget, cap, rand


def _sampler_equal(got, want):
    for k in SAMPLER_KEYS:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", sorted(SAMPLER_CASES))
def test_sample_compact_kernel_matches_plain(dev, name):
    # bit for bit: the kernel rounds as PyTorch's CUDA operators do
    args = _sampler_inputs(name, dev)
    launches = (sampler.sample_count.launches, sampler.sample_write.launches)
    got = sampler.sample_compact(*args)
    assert (sampler.sample_count.launches, sampler.sample_write.launches) == (launches[0] + 1, launches[1] + 1)
    want = sampler.sample_compact(*args, count=sampler.sample_count_reference)
    _sampler_equal(got, want)
    n_valid, budget = int(got["n_valid"]), args[5]
    if name.startswith("train_step"):
        assert n_valid > budget  # the budget drops samples
    if name in ("all_miss", "empty_bitfield"):
        assert n_valid == 0 and not bool(got["ray_has"].any())
    if name.startswith("full_covered"):
        assert int(got["cnt"].sum()) == n_valid > 0


def test_sample_compact_kernel_replays_from_a_cuda_graph(dev):
    # captured once (the counters rise at the capture, not at a replay), then
    # replayed on new rays and draws copied into the captured inputs
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand = _sampler_inputs("train_step", dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        sampler.sample_compact(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    torch.cuda.current_stream().wait_stream(side)
    launches = sampler.sample_count.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = sampler.sample_compact(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand)
    assert sampler.sample_count.launches == launches + 1
    _, _, new_o, new_d, _, _, _, new_rand = _sampler_inputs("train_step", dev, seed=9)
    for buf, new in ((rays_o, new_o), (rays_d, new_d), (rand, new_rand)):
        buf.copy_(new)
    bitfield.copy_(ladder_bitfield("half", vol, 9, device=dev))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert sampler.sample_count.launches == launches + 1
    _sampler_equal(out, sampler.sample_compact(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand,
                                               count=sampler.sample_count_reference))


def test_sample_compact_binding_refuses_what_the_kernel_does_not_take(dev):
    vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand = _sampler_inputs("serve_last_chunk", dev)
    with pytest.raises(ValueError):  # a draw for every slot, or none
        sampler.sample_count(vol, bitfield, rays_o, rays_d, n_pts, budget, cap, rand=rays_o[:, 0].contiguous())
    with pytest.raises(ValueError):  # a bool bitfield
        sampler.sample_count(vol, bitfield.float(), rays_o, rays_d, n_pts, budget, cap)
    with pytest.raises(ValueError):  # a budget of at least one row
        sampler.sample_count(vol, bitfield, rays_o, rays_d, n_pts, 0, cap)


def test_graph_strides_launch_the_fused_sampler(dev, tmp_path):
    # the NGP recipe's step samples through the kernel: its bucket's warm-up
    # step and capture launch it, the replays add no Python call
    trainer = _graph_trainer(tmp_path, "sampler", 4)
    assert trainer.model.fg_model.fuses_sampling(trainer.bound_state["fg"])
    launches = (sampler.sample_count.launches, sampler.sample_write.launches)
    trainer.train_steps(0, 4)
    trainer.train_steps(4, 4)
    torch.cuda.synchronize()
    assert (sampler.sample_count.launches, sampler.sample_write.launches) == (launches[0] + 2, launches[1] + 2)
    step = trainer.step_graphs[(256, None)]
    assert step.graph is not None and all(int(c) > 0 for c in step.ring["n_valid_pts"])


# ------------------------------------------------ NeuS-NGP: K, L, the modes

HASH_DX_RES = [15, 22, 33, 48, 71, 104, 153, 224, 329, 482, 706, 1034, 1515, 2219, 3250, 4761]


def _hash_dx_inputs(dev, n_pts, n_feat, seed, log2_t=19):
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = (torch.rand((16, 1 << log2_t, n_feat), generator=gen, device=dev) * 2 - 1) * 0.5
    xyz = torch.as_tensor(ray_stream(n_pts, seed), device=dev)
    g = torch.randn((n_pts, 16 * n_feat), generator=gen, device=dev)
    return xyz, table, g


@pytest.mark.parametrize("variant", ["quad", "ngp"])
@pytest.mark.parametrize("n_pts,n_feat", [(1, 2), (33, 2), (5000, 2), (1 << 18, 2), (777, 4), (300, 1)])
def test_hash_dx_kernel_matches_plain(dev, variant, n_pts, n_feat):
    # kernel K against hash_encode_dx_reference: the same terms, summed over
    # the levels in another order (1e-4 of the largest value)
    if variant == "quad" and n_feat != 2:
        variant = "pair"
    xyz, table, g = _hash_dx_inputs(dev, n_pts, n_feat, n_pts)
    args = (HASH_DX_RES, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0), variant)
    launches = encoding.hash_encode_dx.launches
    got = encoding.hash_encode_dx(xyz, table, g, *args)
    assert encoding.hash_encode_dx.launches == launches + 1
    want = encoding.hash_encode_dx_reference(xyz, table, g, *args)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4 * float(want.abs().max()))


@pytest.mark.parametrize("variant", ["quad", "ngp"])
@pytest.mark.parametrize("n_pts,n_feat", [(1, 2), (33, 2), (5000, 2), (1 << 18, 2), (777, 4)])
def test_hash_dx_bwd_kernel_matches_plain(dev, variant, n_pts, n_feat):
    # kernel L against hash_dx_bwd_reference: d_g exactly the plain terms in
    # corner order (1e-5 of the largest); the table's float atomics land in
    # another order (1e-5 of the largest entry)
    if variant == "quad" and n_feat != 2:
        variant = "pair"
    xyz, table, g = _hash_dx_inputs(dev, n_pts, n_feat, n_pts + 1)
    g_dx = torch.randn((n_pts, 3), generator=torch.Generator(device=dev).manual_seed(5), device=dev)
    args = (HASH_DX_RES, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0), variant)
    launches = encoding.hash_dx_bwd.launches
    d_table, d_g = encoding.hash_dx_bwd(xyz, table, g, g_dx, *args)
    assert encoding.hash_dx_bwd.launches == launches + 1
    w_table, w_g = encoding.hash_dx_bwd_reference(xyz, table, g, g_dx, *args)
    torch.testing.assert_close(d_g, w_g, rtol=0, atol=1e-5 * float(w_g.abs().max()))
    torch.testing.assert_close(d_table, w_table, rtol=0, atol=1e-5 * float(w_table.abs().max()))


def test_hash_grid_normal_and_its_backward_launch_k_and_l(dev):
    # an SDF's normal through the encoding on the card: autograd.grad with
    # create_graph reaches kernel K, the eikonal-style loss's backward
    # kernel L for the normal's terms and kernel E for the encoding's; the
    # gradients match the CPU's plain versions (1e-4 relative: atomics and
    # level order)
    xyz, table, _ = _hash_dx_inputs(dev, 4096, 2, 11, log2_t=14)
    w = torch.randn((32, 1), generator=torch.Generator(device=dev).manual_seed(2), device=dev)
    grads = {}
    for device in (dev, torch.device("cpu")):
        t = table.to(device).clone().requires_grad_(True)
        ww = w.to(device).clone().requires_grad_(True)
        x = xyz.to(device).clone().requires_grad_(True)
        counts = (encoding.hash_encode_dx.launches, encoding.hash_dx_bwd.launches, encoding.hash_encode_bwd.launches)
        with encoding.input_grad():
            enc = encoding.hash_encode(x, t, HASH_DX_RES, (-1.0, -1.0, -1.0), (2.0, 2.0, 2.0), "quad")
            sdf = torch.tanh(enc @ ww)
            (normal,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=True)
        loss = ((normal.norm(dim=-1) - 1) ** 2).mean() + sdf.mean()
        loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert (encoding.hash_encode_dx.launches, encoding.hash_dx_bwd.launches,
                    encoding.hash_encode_bwd.launches) == (counts[0] + 1, counts[1] + 1, counts[2] + 1)
        assert x.grad is None
        grads[device.type] = (t.grad.cpu(), ww.grad.cpu(), normal.detach().cpu())
    for a, b in zip(grads["cuda"], grads["cpu"]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max()))


@pytest.mark.parametrize("group", [32, 8])
def test_segment_march_alpha_mode_matches_plain(dev, group):
    # kernels C and F in the alpha mode against the plain versions: the
    # tree order of the scans (2e-5, as the sigma mode's tests allow)
    lengths = long_tail_lengths(2000, 3, max_len=64)
    sigma, rgb, z, off, cnt = segment_stream(lengths, int(lengths.sum()) - 100, 3)
    alpha = torch.as_tensor(np.random.default_rng(4).random(sigma.shape[0]).astype(np.float32))
    g_rgb, g_depth, g_mask, bkg = ray_gradients(len(lengths), 5)
    cpu = [alpha, torch.as_tensor(rgb), torch.as_tensor(z), torch.as_tensor(off), torch.as_tensor(cnt)]
    card = [t.to(dev) for t in cpu]
    bkg_c = torch.as_tensor(bkg)
    launches = (segment_march.launches, segment_march_bwd.launches)
    out = ray_helper.segment_march_fwd(*card, False, bkg_c.to(dev), False, group, alpha=True)
    want = segment_march_reference(*cpu, False, bkg_c, False, alpha=True)
    for k in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(out[k].cpu(), want[k], rtol=2e-5, atol=2e-5)
    grads = [torch.as_tensor(g) for g in (g_rgb, g_depth, g_mask)]
    d_a, d_rgb = segment_march_bwd(*card, *[g.to(dev) for g in grads], False, bkg_c.to(dev), False, alpha=True)
    w_a, w_rgb = segment_march_bwd_reference(*cpu, *grads, False, bkg_c, False, alpha=True)
    assert (segment_march.launches, segment_march_bwd.launches) == (launches[0] + 1, launches[1] + 1)
    torch.testing.assert_close(d_a.cpu(), w_a, rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(d_rgb.cpu(), w_rgb, rtol=2e-5, atol=2e-5)


SECTION_CASES = ("train_step", "train_step_half", "serve_chunk", "all_miss", "full_covered", "ragged_ladder",
                 "neus_step", "neus_step_half")


@pytest.mark.parametrize("name", SECTION_CASES)
def test_sample_compact_sections_kernel_matches_plain(dev, name):
    # the sections mode, bit for bit with its plain version (sdf_sections
    # then the gathers), the lengths included
    args = _sampler_inputs(name, dev)
    got = sampler.sample_compact(*args, sections=True)
    want = sampler.sample_compact(*args, count=sampler.sample_count_reference, sections=True)
    _sampler_equal(got, want)
    assert torch.equal(got["len"], want["len"])
    if int(want["n_valid"]) > 0:
        assert int(want["cnt"].sum()) > 0
    if name == "neus_step_half":
        assert int(want["n_valid"]) > args[5]  # the budget drops sections


def test_sample_compact_sections_clip_at_the_ladder(dev):
    # rays along the diagonals of a full grid keep all 1024 slots valid, so
    # their c + 1 sections clip at n_pts = 1024: bit for bit with the plain
    # version, every ray at the clip
    vol = ladder_volume()
    rays_o, rays_d = diagonal_rays(vol, 64, 3, device=dev)
    args = (vol, ladder_bitfield("full", vol, 0, device=dev), rays_o, rays_d, 1024, 64 * 1024, None,
            ladder_rand(64, 1024, 4, device=dev))
    got = sampler.sample_compact(*args, sections=True)
    want = sampler.sample_compact(*args, count=sampler.sample_count_reference, sections=True)
    _sampler_equal(got, want)
    assert torch.equal(got["len"], want["len"])
    assert bool((got["cnt"] == 1024).all())


@pytest.mark.parametrize("name", ["neus_step", "neus_step_half"])
def test_march_alpha_mode_on_the_sections_stream(dev, name):
    # kernels C and F in the alpha mode on the sections the sampler writes
    # for the NeuS cell (segments of up to ~600 sections, so the carry
    # crosses many groups), alphas under 0.05 so every group still carries
    # light: within 2e-5 of the plain versions (f32 sums in another order)
    out = sampler.sample_compact(*_sampler_inputs(name, dev), sections=True)
    z, off, cnt = out["z"], out["off"], out["cnt"]
    assert int(cnt.max()) > 8 * ray_helper.TRAIN_GROUP
    rng = np.random.default_rng(7)
    alpha = torch.as_tensor(rng.random(z.shape[0], dtype=np.float32) * 0.05, device=dev)
    rgb = torch.as_tensor(rng.random((z.shape[0], 3), dtype=np.float32), device=dev)
    g_rgb, g_depth, g_mask, bkg = (torch.as_tensor(g, device=dev) for g in ray_gradients(off.shape[0], 8))
    got = ray_helper.segment_march_fwd(alpha, rgb, z, off, cnt, False, bkg, False, alpha=True)
    want = segment_march_reference(alpha, rgb, z, off, cnt, False, bkg, False, alpha=True)
    for k in ("rgb", "depth", "mask", "trans_end"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5, atol=2e-5)
    args = (alpha, rgb, z, off, cnt, g_rgb, g_depth, g_mask, False, bkg, False)
    for a, b in zip(segment_march_bwd(*args, alpha=True), segment_march_bwd_reference(*args, alpha=True)):
        torch.testing.assert_close(a, b, rtol=2e-5, atol=2e-5)


NEUS_ARGV = ["--model.geometry.encoder.hashmap_size", "12", "--model.geometry.encoder.n_levels", "4",
             "--model.obj_bound.volume.n_grid", "16", "--model.rays.n_sample", "64",
             "--model.obj_bound.log_max_allowance", "13", "--model.obj_bound.epoch_optim_warmup", "4",
             "--dataset.train.n_imgs", "2", "--dataset.train.wh", "[16,16]", "--dataset.val.n_imgs", "1",
             "--dataset.val.wh", "[16,16]", "--n_rays", "256", "--device", "cuda:0"]


def _neus_trainer(tmp_path, name, scan_steps):
    import os

    from arcnerf_torch.trainer import ArcNerfTrainer
    from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfgs = update_configs_by_dotlist(load_configs(os.path.join(root, "configs/expr/synthetic_neus_ngp.yaml")),
                                     NEUS_ARGV + ["--dir.expr_dir", str(tmp_path / name), "--progress.scan_steps",
                                                  str(scan_steps)])
    return ArcNerfTrainer(cfgs)


def test_neus_graph_strides_follow_the_eager_steps(dev, tmp_path):
    # NeuS-NGP's whole step, double backward, AdamW and EMA included, as a
    # CUDA graph per bucket against eager steps: the same draws and section
    # counts, losses within the atomics' order (GRAPH_LOSS_TOL), the
    # kernels K and L launched at the warm-up step and the capture only
    eager, graph = _neus_trainer(tmp_path, "eager", 1), _neus_trainer(tmp_path, "graph", 4)
    counts = [int(eager.train_steps(e, 1)["n_valid_pts"]) for e in range(8)]
    launches = (encoding.hash_encode_dx.launches, encoding.hash_dx_bwd.launches)
    graph_counts = []
    for e in range(0, 8, 4):
        graph.train_steps(e, 4)
        graph_counts += [int(c) for c in graph.step_graphs[(256, None)].ring["n_valid_pts"]]
    torch.cuda.synchronize()
    assert (encoding.hash_encode_dx.launches, encoding.hash_dx_bwd.launches) == (launches[0] + 2, launches[1] + 2)
    assert graph_counts == counts and all(c > 0 for c in counts)
    losses_e, losses_g = torch.stack(eager.loss_history).cpu(), torch.stack(graph.loss_history).cpu()
    torch.testing.assert_close(losses_g, losses_e, rtol=GRAPH_LOSS_TOL, atol=0)
    shadow_e, shadow_g = eager.eval_params(), graph.eval_params()
    for name, v in shadow_e.items():
        rel = float((shadow_g[name] - v).norm() / v.norm().clamp_min(1e-12))
        assert rel < GRAPH_PARAM_TOL, (name, rel)


# ------------------------------------------- the exact tier's frame graphs

SERVE_WH, SERVE_CAP = 800, 16  # the serving cell's frame: 39 chunks of 16384 rays and one of 1024
WHITE = (1.0, 1.0, 1.0)


def _graph_engines(dev, cfg, argv, n_grid):
    """(frame-graph engine, eager engine: render inside its ``eager()``)
    on one model of ``cfg`` with seeded weights (table features large
    enough that the field varies) and the spheres' occupancy."""
    import os

    from arcnerf_torch.datasets.synthetic_dataset import sphere_scene_bitfield
    from arcnerf_torch.models import build_model
    from arcnerf_torch.render.engine import RenderEngine
    from arcnerf_torch.utils.cfgs import load_configs, update_configs_by_dotlist

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfgs = update_configs_by_dotlist(load_configs(os.path.join(root, cfg)), list(argv))
    model = build_model(cfgs, generator=torch.Generator().manual_seed(0)).to(dev).eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("embeddings"):
                p.mul_(1000.0)
    bound = model.init_bound_state(dev)
    bound["fg"]["bitfield"] = torch.from_numpy(sphere_scene_bitfield(n_grid, 2.0)).to(dev)
    return RenderEngine(model, cfgs, bound, dev), RenderEngine(model, cfgs, bound, dev)


def _poses(n, wh, dev):
    from arcnerf_torch.datasets import get_dataset
    from arcnerf_torch.utils.cfgs import dict_to_obj

    ds = get_dataset(dict_to_obj({"val": {"type": "Synthetic", "n_imgs": n, "wh": [wh, wh], "cam_radius": 2.5,
                                          "white_bkg": True, "center_pixel": True}}), "data", "val")
    return [{"rays_o": torch.as_tensor(ds[i]["rays_o"]).to(dev), "rays_d": torch.as_tensor(ds[i]["rays_d"]).to(dev),
             "H": wh, "W": wh} for i in range(n)]


def _traced(fn, eager=None):
    """``fn()`` with tracing on (inside ``eager.eager()`` where an engine is
    given); returns (its result, the counters)."""
    import contextlib

    from arcnerf_torch.utils import profiler

    profiler.enable()
    try:
        with eager.eager() if eager is not None else contextlib.nullcontext():
            out = fn()
        torch.cuda.synchronize()
    finally:
        profiler.disable()
    return out, profiler.collect()["counters"]


def _assert_frames_equal(got, want):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_exact_frames_replay_the_frame_graphs_bit_for_bit(dev):
    # the serving cell's shapes: five poses of 800x800 at cap 16 (39 chunks
    # of 16384 rays and the 1024-ray tail) through one graph, captured at
    # the first frame; each frame bit for bit the eager loop's, 40 chunks
    # replayed, the counters the eager chunks count (from the chunks' static
    # counts), and no frame overwritten by the next; a windowed frame
    # replays nothing
    graphs, eager = _graph_engines(dev, "configs/expr/synthetic_ngp.yaml", (), 128)
    for e in (graphs, eager):
        e.set_render_cap(SERVE_CAP)
    assert graphs._chunk_for_mesh() == 16384
    frames = []
    for i, sample in enumerate(_poses(5, SERVE_WH, dev)):
        got, counters = _traced(lambda: graphs.render_image(sample, bkg_color=WHITE))
        want, eager_counters = _traced(lambda: eager.render_image(sample, bkg_color=WHITE), eager)
        _assert_frames_equal(got, want)
        frames.append((got, want))
        assert int(graphs.last_n_valid_pts) == int(eager.last_n_valid_pts) > 0
        assert counters.get("render.captures", 0) == (1 if i == 0 else 0) and counters["render.replays"] == 40
        for k in ("compact.valid", "compact.dropped", "sample.fused"):
            assert counters[k] == eager_counters[k], k
        assert "render.replays" not in eager_counters and not eager.graphs and eager_counters["render.eager"] == 1
        assert "render.eager" not in counters
    for got, want in frames:
        _assert_frames_equal(got, want)
    (graph,) = graphs.graphs.values()
    assert (graph.n_rays, graph.chunk_rays, graph.n_chunks) == (SERVE_WH**2, 16384, 40) and graph.graph is not None
    graphs.set_render_cap(8, window=True)
    assert not graphs.graphs
    (win, _), counters = _traced(lambda: graphs.render_image_windowed(sample, bkg_color=WHITE))
    assert win["rgb"].shape == (SERVE_WH, SERVE_WH, 3) and "render.replays" not in counters and not graphs.graphs


def test_neus_exact_frames_replay_the_frame_graphs_bit_for_bit(dev):
    # NeuS-NGP's chunk takes its normals by autograd inside the graph: two
    # poses at 64x64 in chunks of 1000 rays and a 96-ray tail, every output
    # (the normal map too) bit for bit the eager loop's
    argv = ("--model.geometry.encoder.hashmap_size", "14", "--model.obj_bound.volume.n_grid", "32",
            "--model.rays.n_sample", "128", "--model.obj_bound.log_max_allowance", "14")
    graphs, eager = _graph_engines(dev, "configs/expr/synthetic_neus_ngp.yaml", argv, 32)
    for e in (graphs, eager):
        e.set_render_cap(SERVE_CAP)
    for i, sample in enumerate(_poses(2, 64, dev)):
        got, counters = _traced(lambda: graphs.render_image(sample, chunk_rays=1000, bkg_color=WHITE))
        want, eager_counters = _traced(lambda: eager.render_image(sample, chunk_rays=1000, bkg_color=WHITE), eager)
        assert "normal" in want and 0.0 < float(want["mask"].mean()) < 1.0
        _assert_frames_equal(got, want)
        assert counters.get("render.captures", 0) == (1 if i == 0 else 0) and counters["render.replays"] == 5
        for k in ("compact.valid", "sdf.normal_pts", "sample.fused"):
            assert counters[k] == eager_counters[k], k
