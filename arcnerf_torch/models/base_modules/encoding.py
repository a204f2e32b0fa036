"""Input encoders: spherical harmonics and the multi-resolution hash grid
with kernel B.

Counterpart of ``arcnerf_tpu/models/base_modules/encoding.py`` (sh_basis,
SHEmbedder, hash_variant_from_cfgs, HashGridEmbedder). ``hash_encode``
replaces the TPU lookup (``_hash_lookup_fused`` and its siblings) with the
CUDA kernel in ``csrc/hash_encode.cu``; ``hash_encode_reference`` is the plain version of
the JAX CPU element path (``_gather_cols_f32``): the same entry math and
corner order, each table entry read rounded to bf16, sums in f32.

All encoders expose ``out_dim`` and ``forward(x) -> (B, out_dim)``.
"""

import math

import numpy as np
import torch
from torch import nn

from ...ops import cuda_lib
from ...utils.cfgs import get_value_from_cfgs_field
from ...utils.registry import ENCODER_REGISTRY

# instant-ngp xor-hash primes (first is 1 so x varies fastest)
_HASH_PRIMES = (1, 2654435761, 805459861)
_QUAD_SY = 31
_QUAD_STRIDE = 32
_U32 = 0xFFFFFFFF

# corner offsets (8, 3) in z-outer order shared with geometry.volume
_CORNER_OFFSETS = ((0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (0, 1, 1), (1, 0, 1), (1, 1, 1))
_VARIANTS = {"ngp": 0, "pair": 1, "quad": 2}


def sh_basis(dirs, degree):
    """Real spherical-harmonic basis values up to ``degree`` (1..5).

    dirs (B, 3) unit vectors -> (B, degree^2).
    """
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    comps = [torch.full_like(x, 0.28209479177387814)]
    if degree >= 2:
        comps += [
            -0.4886025119029199 * y,
            0.4886025119029199 * z,
            -0.4886025119029199 * x,
        ]
    if degree >= 3:
        comps += [
            1.0925484305920792 * xy,
            -1.0925484305920792 * yz,
            0.31539156525252005 * (2.0 * zz - xx - yy),
            -1.0925484305920792 * xz,
            0.5462742152960396 * (xx - yy),
        ]
    if degree >= 4:
        comps += [
            -0.5900435899266435 * y * (3.0 * xx - yy),
            2.890611442640554 * xy * z,
            -0.4570457994644658 * y * (4.0 * zz - xx - yy),
            0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            -0.4570457994644658 * x * (4.0 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy),
            -0.5900435899266435 * x * (xx - 3.0 * yy),
        ]
    if degree >= 5:
        comps += [
            2.5033429417967046 * xy * (xx - yy),
            -1.7701307697799304 * yz * (3.0 * xx - yy),
            0.9461746957575601 * xy * (7.0 * zz - 1.0),
            -0.6690465435572892 * yz * (7.0 * zz - 3.0),
            0.10578554691520431 * (35.0 * zz * zz - 30.0 * zz + 3.0),
            -0.6690465435572892 * xz * (7.0 * zz - 3.0),
            0.47308734787878004 * (xx - yy) * (7.0 * zz - 1.0),
            -1.7701307697799304 * xz * (xx - 3.0 * yy),
            0.6258357354491761 * (xx * (xx - 3.0 * yy) - yy * (3.0 * xx - yy)),
        ]
    return torch.stack(comps, dim=-1)


@ENCODER_REGISTRY.register()
class SHEmbedder(nn.Module):
    """Spherical-harmonics direction encoding, degree = n_freqs in 1..5."""

    def __init__(self, input_dim=3, n_freqs=4, include_input=False):
        super().__init__()
        assert 1 <= n_freqs <= 5, "SH degree must be 1..5"
        self.input_dim, self.n_freqs, self.include_input = input_dim, n_freqs, include_input

    @property
    def out_dim(self):
        return self.include_input * self.input_dim + self.n_freqs**2

    def forward(self, dirs):
        out = [dirs] if self.include_input else []
        out.append(sh_basis(dirs, self.n_freqs))
        return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def hash_variant_from_cfgs(model_cfgs):
    """Resolved hash variant of the model's hashgrid encoder ('quad' |
    'pair' | 'ngp'), or None when the geometry encoder is not a HashGrid.
    Recorded in checkpoints and checked at load. Same test as the JAX
    package, including its type name 'HashGrid' (ROADMAP Queue 3: the
    registered name is 'HashGridEmbedder', so configs resolve to None)."""
    geo = get_value_from_cfgs_field(model_cfgs, "geometry", None)
    enc = get_value_from_cfgs_field(geo, "encoder", None)
    if enc is None or str(get_value_from_cfgs_field(enc, "type", "")) != "HashGrid":
        return None
    if bool(get_value_from_cfgs_field(enc, "quad_hash", True)):
        return "quad"
    if bool(get_value_from_cfgs_field(enc, "pair_hash", True)):
        return "pair"
    return "ngp"


def _corner_entries(i0, res, table_size, variant):
    """(B, L, 3) int64 lower corners -> list of 8 (B, L) int64 entries in
    _CORNER_OFFSETS order. uint32 wrapping is int64 arithmetic & 2^32-1."""
    mask = table_size - 1
    n1 = (res + 1)[None, :]  # (1, L)
    dense = (n1 * n1 * n1 <= table_size)
    x0, y0, z0 = i0[..., 0], i0[..., 1], i0[..., 2]
    p1, p2 = _HASH_PRIMES[1], _HASH_PRIMES[2]
    entries = []
    for cx, cy, cz in _CORNER_OFFSETS:
        e_dense = (x0 + cx) * (n1 * n1) + (y0 + cy) * n1 + z0 + cz
        if variant == "quad":
            qb = ((x0 + cx) * p1 + y0 * _QUAD_SY + z0) & mask
            e_hash = (qb + cy * _QUAD_SY + cz) & mask
        elif variant == "pair":
            base = (((x0 + cx) ^ (((y0 + cy) * p1) & _U32)) + z0) & mask
            e_hash = (base + cz) & mask
        else:
            e_hash = ((x0 + cx) ^ (((y0 + cy) * p1) & _U32) ^ (((z0 + cz) * p2) & _U32)) & mask
        entries.append(torch.where(dense, e_dense, e_hash))
    return entries


def hash_encode_reference(xyz, table, res, aabb_min, aabb_len, variant, read_bf16=True):
    """Plain version: xyz (B, 3) -> (B, L * F), the JAX CPU element path.

    table (L, T, F) f32; res (L,) level resolutions; aabb_min/aabb_len (3,)
    f32 volume corner and side lengths; variant 'quad' | 'pair' | 'ngp'."""
    n_levels, table_size, n_feat = table.shape
    dev = xyz.device
    res_i = torch.as_tensor(np.asarray(res), dtype=torch.int64, device=dev)
    mn = torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev)
    ln = torch.as_tensor(np.asarray(aabb_len, np.float32), device=dev)
    norm = (xyz - mn) / ln  # (B, 3)
    p = norm[:, None, :] * res_i.to(torch.float32)[None, :, None]  # (B, L, 3)
    i0 = torch.minimum(torch.floor(p).to(torch.int64).clamp_min(0), (res_i - 1)[None, :, None])
    f = p - i0.to(torch.float32)
    wts = (1.0 - f, f)

    tab = table.reshape(n_levels * table_size, n_feat)
    if read_bf16:
        tab = tab.to(torch.bfloat16).float()
    level_off = (torch.arange(n_levels, device=dev, dtype=torch.int64) * table_size)[None, :]
    acc = torch.zeros(xyz.shape[0], n_levels, n_feat, dtype=torch.float32, device=dev)
    for (cx, cy, cz), e in zip(_CORNER_OFFSETS, _corner_entries(i0, res_i, table_size, variant)):
        w = wts[cx][..., 0] * wts[cy][..., 1] * wts[cz][..., 2]  # (B, L)
        acc = acc + tab[e + level_off] * w[..., None]
    return acc.reshape(xyz.shape[0], n_levels * n_feat)


def hash_encode(xyz, table, res, aabb_min, aabb_len, variant, read_bf16=True, res_dev=None):
    """Hash-grid encoding. A CPU tensor takes ``hash_encode_reference``; a
    CUDA tensor launches kernel B or raises. ``res_dev`` optionally gives
    ``res`` as an int32 tensor already on the device."""
    if xyz.device.type == "cpu":
        return hash_encode_reference(xyz, table, res, aabb_min, aabb_len, variant, read_bf16)
    cuda_lib.require_cuda("hash_encode", xyz, table)
    if torch.is_grad_enabled() and table.requires_grad:
        raise RuntimeError("hash_encode: the CUDA backward (table scatter) is not ported yet (inference only)")
    n_levels, table_size, n_feat = table.shape
    log2_t = int(table_size).bit_length() - 1
    if 1 << log2_t != table_size:
        raise ValueError("hash_encode: the table size must be a power of two")
    if res_dev is None:
        res_dev = torch.as_tensor(np.asarray(res), dtype=torch.int32, device=xyz.device)
    out = torch.empty((xyz.shape[0], n_levels * n_feat), dtype=torch.float32, device=xyz.device)
    if xyz.shape[0] == 0:
        return out
    status = cuda_lib.lib().arcnerf_hash_encode_fwd(
        xyz.data_ptr(), xyz.shape[0], table.data_ptr(), n_levels, log2_t, n_feat, res_dev.data_ptr(),
        cuda_lib.float3(aabb_min), cuda_lib.float3(aabb_len), _VARIANTS[variant], int(bool(read_bf16)),
        out.data_ptr(), cuda_lib.stream_handle(xyz.device))
    cuda_lib.check(status, "hash_encode")
    hash_encode.launches += 1
    return out


hash_encode.launches = 0


@ENCODER_REGISTRY.register()
class HashGridEmbedder(nn.Module):
    """Multi-resolution hash grid (instant-ngp): one (L, T, F) table; level
    resolution r_l = ceil(base * s^l - 1) with s = exp(ln(max/base)/(L-1));
    levels with (r_l + 1)^3 <= T index densely, the others hash.

    ``dtype`` is the table READ precision (storage stays f32), as in the JAX
    package; ``quad_hash``/``pair_hash`` pick the hash of hashed levels."""

    def __init__(self, input_dim=3, n_levels=16, n_feat_per_entry=2, hashmap_size=19, base_res=16,
                 max_res=2048, origin=(0.0, 0.0, 0.0), side=None, xyz_len=None, include_input=True,
                 dtype="float32", init_std=1e-4, pair_hash=True, quad_hash=True, generator=None):
        super().__init__()
        assert side is not None or xyz_len is not None, "hashgrid needs a volume size"
        self.input_dim, self.n_levels, self.n_feat = input_dim, n_levels, n_feat_per_entry
        self.table_size = 2**hashmap_size
        self.include_input = include_input
        self.read_bf16 = str(dtype) in ("bfloat16", "bf16")
        scale = math.exp(math.log(max_res / base_res) / (n_levels - 1))
        self.resolutions = [int(math.ceil(base_res * (scale**i) - 1.0)) for i in range(n_levels)]
        self.register_buffer("_res", torch.tensor(self.resolutions, dtype=torch.int32), persistent=False)
        origin = np.asarray(origin, dtype=np.float32)
        lens = np.array([side] * 3, dtype=np.float32) if side is not None else np.asarray(xyz_len, np.float32)
        self.aabb_min = origin - lens / 2.0
        self.aabb_len = (origin + lens / 2.0) - self.aabb_min
        quad_ok = quad_hash and n_feat_per_entry == 2 and self.table_size % _QUAD_STRIDE == 0
        self.variant = "quad" if quad_ok else ("pair" if pair_hash else "ngp")
        table = torch.rand((n_levels, self.table_size, n_feat_per_entry), generator=generator)
        self.embeddings = nn.Parameter(table * (2 * init_std) - init_std)

    @property
    def out_dim(self):
        return self.n_levels * self.n_feat + self.include_input * self.input_dim

    def forward(self, xyz):
        """xyz (B, 3) world coords inside the volume -> (B, out_dim)."""
        embed = hash_encode(xyz, self.embeddings, self.resolutions, self.aabb_min, self.aabb_len, self.variant,
                            self.read_bf16, res_dev=self._res)
        if self.include_input:
            return torch.cat([xyz, embed], dim=-1)
        return embed
