"""arcnerf_torch's CUDA kernels vs their plain PyTorch versions on the card.

Needs an NVIDIA GPU (sm_90a) and nvcc; every test skips where CUDA is
unavailable. The card's machine has no JAX, so run this file without the
suite's conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -p no:cacheprovider -q
"""

import pytest
import torch

from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode, hash_encode_reference
from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from arcnerf_torch.render.ray_helper import segment_march, segment_march_reference

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


def test_fused_mlp_kernel_refuses_autograd(dev):
    w = torch.randn((32, 64), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="backward"):
        fused_mlp(torch.randn((8, 32), device=dev), [w, torch.randn((64, 16), device=dev)])


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
