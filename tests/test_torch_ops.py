"""arcnerf_torch ops vs the JAX package on the same numpy inputs (CPU):
the fused MLP, the SH basis and the hash-grid encoding (all three hash
variants), plus the wrappers' device dispatch. Each comparison states its
tolerance and why."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from arcnerf_tpu.models.base_modules.encoding import HashGridEmbedder as JaxHashGrid
from arcnerf_tpu.models.base_modules.encoding import sh_basis as jax_sh_basis
from arcnerf_tpu.ops.fused_mlp import fused_mlp as jax_fused_mlp
from arcnerf_torch.models.base_modules.encoding import HashGridEmbedder, hash_encode, hash_encode_reference, sh_basis
from arcnerf_torch.ops.fused_mlp import fused_mlp, fused_mlp_reference
from arcnerf_torch.render.ray_helper import segment_march

torch.set_num_threads(1)


def _net(dims, seed):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(dims[i], dims[i + 1])) / np.sqrt(dims[i])).astype(np.float32)
            for i in range(len(dims) - 1)]


@pytest.mark.parametrize("dims,b", [([32, 64, 16], 100), ([18, 64, 64, 3], 257), ([31, 64, 64, 3], 64)])
def test_fused_mlp_reference_matches_pallas(dims, b):
    # rtol = atol = 2e-2: one-ulp bf16 flips between layers from another
    # order of f32 summation (the JAX package's own kernel tolerance)
    ws = _net(dims, 0)
    x = np.random.default_rng(1).normal(size=(b, dims[0])).astype(np.float32)
    want = np.asarray(jax_fused_mlp(jnp.asarray(x), [jnp.asarray(w) for w in ws], tile=128, interpret=True))
    got = fused_mlp_reference(torch.from_numpy(x), [torch.from_numpy(w) for w in ws]).numpy()
    assert got.shape == (b, dims[-1])
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("degree", [1, 2, 3, 4, 5])
def test_sh_basis_matches_jax(degree):
    # 1e-6: the same polynomial in f32, evaluated in another op order
    d = np.random.default_rng(degree).normal(size=(200, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    want = np.asarray(jax_sh_basis(jnp.asarray(d), degree))
    got = sh_basis(torch.from_numpy(d), degree).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


# 4 levels over T = 2^12: level 0 (res 15, 16^3 = T entries) is dense,
# levels 1-3 are hashed
_HASH_KW = dict(n_levels=4, n_feat_per_entry=2, hashmap_size=12, base_res=16, max_res=2048, side=2.0,
                include_input=False, dtype="bfloat16")
_VARIANT_FLAGS = {"quad": dict(quad_hash=True), "pair": dict(quad_hash=False, pair_hash=True),
                  "ngp": dict(quad_hash=False, pair_hash=False)}


@pytest.mark.parametrize("variant", ["quad", "pair", "ngp"])
def test_hash_encode_matches_jax(variant):
    # atol 1e-5: the same bf16-read entries and f32 weights, summed over the
    # 8 corners in another order
    rng = np.random.default_rng(3)
    table = rng.uniform(-1, 1, size=(4, 1 << 12, 2)).astype(np.float32)
    xyz = rng.uniform(-1.02, 1.02, size=(512, 3)).astype(np.float32)  # a few points outside: clipped corners
    jax_enc = JaxHashGrid(**_HASH_KW, **_VARIANT_FLAGS[variant])
    want = np.asarray(jax_enc.apply({"params": {"embeddings": jnp.asarray(table)}}, jnp.asarray(xyz)))

    enc = HashGridEmbedder(**_HASH_KW, **_VARIANT_FLAGS[variant])
    assert enc.variant == variant and enc.resolutions == jax_enc._resolutions().tolist()
    assert (enc.resolutions[0] + 1) ** 3 <= 1 << 12 < (enc.resolutions[1] + 1) ** 3
    with torch.no_grad():
        enc.embeddings.copy_(torch.from_numpy(table))
        got = enc(torch.from_numpy(xyz)).numpy()
    assert got.shape == (512, 8)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_hash_encode_f32_read_and_include_input():
    # dtype float32 reads the table unrounded; include_input prepends xyz
    rng = np.random.default_rng(4)
    table = rng.uniform(-1, 1, size=(4, 1 << 12, 2)).astype(np.float32)
    xyz = rng.uniform(-1, 1, size=(64, 3)).astype(np.float32)
    kw = dict(_HASH_KW, dtype="float32", include_input=True)
    want = np.asarray(JaxHashGrid(**kw).apply({"params": {"embeddings": jnp.asarray(table)}}, jnp.asarray(xyz)))
    enc = HashGridEmbedder(**kw)
    with torch.no_grad():
        enc.embeddings.copy_(torch.from_numpy(table))
        got = enc(torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_wrappers_take_the_plain_version_on_cpu():
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(33, 32)).astype(np.float32))
    ws = [torch.from_numpy(w) for w in _net([32, 64, 16], 6)]
    assert torch.equal(fused_mlp(x, ws), fused_mlp_reference(x, ws))
    enc = HashGridEmbedder(**_HASH_KW)
    xyz = torch.rand(50, 3) * 2 - 1
    args = (xyz, enc.embeddings.detach(), enc.resolutions, enc.aabb_min, enc.aabb_len, enc.variant)
    assert torch.equal(hash_encode(*args), hash_encode_reference(*args))


def test_wrappers_never_fall_back_off_the_cpu():
    # a tensor that is not on the CPU goes to the kernel path, which refuses
    # what is not a CUDA tensor instead of computing the plain version
    x = torch.empty((8, 32), device="meta")
    ws = [torch.empty((32, 16), device="meta"), torch.empty((16, 4), device="meta")]
    with pytest.raises(ValueError, match="CUDA"):
        fused_mlp(x, ws)
    with pytest.raises(ValueError, match="CUDA"):
        hash_encode(torch.empty((8, 3), device="meta"), torch.empty((2, 16, 2), device="meta"), [3, 7],
                    np.zeros(3, np.float32), np.ones(3, np.float32), "ngp")
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        segment_march(torch.empty(8, **meta), torch.empty((8, 3), **meta), torch.empty(8, **meta),
                      torch.zeros(2, dtype=torch.int64, **meta), torch.zeros(2, dtype=torch.int64, **meta))


def test_trunc_exp_clips_only_the_gradient():
    from arcnerf_torch.ops.trunc_exp import trunc_exp

    x = torch.tensor([-20.0, 0.5, 20.0], requires_grad=True)
    y = trunc_exp(x)
    y.sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.exp([-20.0, 0.5, 20.0]).astype(np.float32), rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.exp([-15.0, 0.5, 15.0]).astype(np.float32), rtol=1e-6)
    jax_grad = jax.grad(lambda v: __import__("arcnerf_tpu.ops.trunc_exp", fromlist=["x"]).trunc_exp(v).sum())(
        jnp.asarray([-20.0, 0.5, 20.0]))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jax_grad), rtol=1e-6)
