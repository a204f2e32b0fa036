"""arcnerf_torch's CUDA kernels (A-F) vs their plain PyTorch versions on the
card, and the autograd Functions' dispatch to them.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips where CUDA is
unavailable. The card's machine has no JAX, so run this file without the
suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""

import pytest
import torch

import arcnerf_torch.models.base_modules.encoding as encoding
import arcnerf_torch.ops.fused_mlp as fused_mlp_mod
import arcnerf_torch.render.ray_helper as ray_helper
from arcnerf_torch.models.base_modules.encoding import (HashGridEmbedder, hash_encode, hash_encode_bwd,
                                                       hash_encode_bwd_reference, hash_encode_reference)
from arcnerf_torch.ops.fused_mlp import (fused_mlp, fused_mlp_bwd, fused_mlp_bwd_reference, fused_mlp_fwd,
                                         fused_mlp_reference)
from arcnerf_torch.render.ray_helper import (segment_march, segment_march_bwd, segment_march_bwd_reference,
                                             segment_march_reference)

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


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_encode_bwd_kernel_matches_plain(dev, variant):
    # 1e-4 of the largest entry: f32 atomics add in another order
    gen = torch.Generator(device=dev).manual_seed(5)
    enc = HashGridEmbedder(n_levels=16, n_feat_per_entry=2, hashmap_size=19, side=2.0, include_input=False)
    xyz = torch.rand((8192, 3), generator=gen, device=dev) * 2.1 - 1.05
    g = torch.randn((8192, 32), generator=gen, device=dev)
    args = (xyz, g, (16, 1 << 19, 2), enc.resolutions, enc.aabb_min, enc.aabb_len, variant)
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
