"""Input encoders: spherical harmonics, sin/cos frequencies and the
multi-resolution hash grid with kernels B and E.

Counterpart of ``arcnerf_tpu/models/base_modules/encoding.py`` (sh_basis,
SHEmbedder, FreqEmbedder, hash_variant_from_cfgs, HashGridEmbedder). ``hash_encode``
replaces the TPU lookup (``_hash_lookup_fused`` and its siblings) with the
CUDA kernel in ``csrc/hash_encode.cu`` (kernel B) and its table gradient
with the scatter in ``csrc/hash_encode_bwd.cu`` (kernel E);
``hash_encode_reference`` and ``hash_encode_bwd_reference`` are the plain
versions of the JAX CPU element path (``_gather_cols_f32`` and its VJP):
the same entry math and corner order, each table entry read rounded to
bf16, sums and the table gradient in f32.

Where the points require a gradient (an SDF's normal), the encoding also
gives d/dxyz: ``hash_encode_dx`` (kernel K, ``csrc/hash_dx.cu``) takes
dL/d(encoding) through the derivatives of the trilinear weights, and its
own backward (kernel L, ``hash_dx_bwd``) goes into the table (a scatter
like E's, with derivative weights) and into dL/d(encoding) (a gather like
B's). The JAX package takes the same derivative with ``jax.grad`` through
the unfused element path; ``hash_encode_dx_reference`` and
``hash_dx_bwd_reference`` are the plain versions.

All encoders expose ``out_dim`` and ``forward(x) -> (B, out_dim)``.
"""

import contextlib
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


@ENCODER_REGISTRY.register()
class FreqEmbedder(nn.Module):
    """sin/cos positional encoding: x -> [x?, sin(f_0 x), cos(f_0 x), sin(f_1
    x), ...] with f_i = 2^i (``log_sampling``) or evenly spaced in [1,
    2^(n_freqs - 1)]; n_freqs 0 with the input is the identity. The bands are
    host numbers (a power of two scales exactly), so the captured step reads
    no host tensor."""

    def __init__(self, input_dim=3, n_freqs=10, log_sampling=True, include_input=True):
        super().__init__()
        self.input_dim, self.n_freqs, self.include_input = input_dim, n_freqs, include_input
        if n_freqs == 0:
            self.bands = []
        elif log_sampling:
            self.bands = [float(f) for f in 2.0 ** np.linspace(0.0, n_freqs - 1, n_freqs)]
        else:
            self.bands = [float(f) for f in np.linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs)]

    @property
    def out_dim(self):
        return self.include_input * self.input_dim + self.input_dim * 2 * self.n_freqs

    def forward(self, x):
        out = [x] if self.include_input else []
        for f in self.bands:
            scaled = x * f
            out += [torch.sin(scaled), torch.cos(scaled)]
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


def _corners_and_weights(xyz, res, aabb_min, aabb_len, table_size, variant):
    """xyz (B, 3) -> per corner (in _CORNER_OFFSETS order) the (B, L) int64
    entries and (B, L) f32 trilinear weights, the JAX CPU element path's
    math."""
    dev = xyz.device
    res_i = torch.as_tensor(np.asarray(res), dtype=torch.int64, device=dev)
    mn = torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev)
    ln = torch.as_tensor(np.asarray(aabb_len, np.float32), device=dev)
    norm = (xyz - mn) / ln  # (B, 3)
    p = norm[:, None, :] * res_i.to(torch.float32)[None, :, None]  # (B, L, 3)
    i0 = torch.minimum(torch.floor(p).to(torch.int64).clamp_min(0), (res_i - 1)[None, :, None])
    f = p - i0.to(torch.float32)
    wts = (1.0 - f, f)
    entries = _corner_entries(i0, res_i, table_size, variant)
    weights = [wts[cx][..., 0] * wts[cy][..., 1] * wts[cz][..., 2] for cx, cy, cz in _CORNER_OFFSETS]
    return entries, weights


def hash_encode_reference(xyz, table, res, aabb_min, aabb_len, variant, read_bf16=True):
    """Plain version: xyz (B, 3) -> (B, L * F), the JAX CPU element path.

    table (L, T, F) f32; res (L,) level resolutions; aabb_min/aabb_len (3,)
    f32 volume corner and side lengths; variant 'quad' | 'pair' | 'ngp'."""
    n_levels, table_size, n_feat = table.shape
    entries, weights = _corners_and_weights(xyz, res, aabb_min, aabb_len, table_size, variant)
    tab = table.reshape(n_levels * table_size, n_feat)
    if read_bf16:
        tab = tab.to(torch.bfloat16).float()
    level_off = (torch.arange(n_levels, device=xyz.device, dtype=torch.int64) * table_size)[None, :]
    acc = torch.zeros(xyz.shape[0], n_levels, n_feat, dtype=torch.float32, device=xyz.device)
    for e, w in zip(entries, weights):
        acc = acc + tab[e + level_off] * w[..., None]
    return acc.reshape(xyz.shape[0], n_levels * n_feat)


def hash_encode_bwd_reference(xyz, g, table_shape, res, aabb_min, aabb_len, variant):
    """Plain version of the table gradient (the JAX ``_gather_cols_f32_bwd``):
    every corner adds w * g into a zero (L, T, F) f32 table with
    ``index_add_``, straight through the forward's bf16 read."""
    n_levels, table_size, n_feat = table_shape
    entries, weights = _corners_and_weights(xyz, res, aabb_min, aabb_len, table_size, variant)
    g = g.reshape(xyz.shape[0], n_levels, n_feat)
    level_off = (torch.arange(n_levels, device=xyz.device, dtype=torch.int64) * table_size)[None, :]
    grad = torch.zeros(n_levels * table_size, n_feat, dtype=torch.float32, device=xyz.device)
    for e, w in zip(entries, weights):
        grad.index_add_(0, (e + level_off).reshape(-1), (g * w[..., None]).reshape(-1, n_feat))
    return grad.reshape(table_shape)


def _corner_weight_grads(xyz, res, aabb_min, aabb_len, table_size, variant):
    """As ``_corners_and_weights``, plus per corner the (B, L, 3) derivative
    of its weight with respect to the point's fraction in the cell along
    each axis: d w_c / d f_a = (+1 or -1) times the other two axes'
    factors. Returns (entries, dweights)."""
    dev = xyz.device
    res_i = torch.as_tensor(np.asarray(res), dtype=torch.int64, device=dev)
    mn = torch.as_tensor(np.asarray(aabb_min, np.float32), device=dev)
    ln = torch.as_tensor(np.asarray(aabb_len, np.float32), device=dev)
    p = ((xyz - mn) / ln)[:, None, :] * res_i.to(torch.float32)[None, :, None]
    i0 = torch.minimum(torch.floor(p).to(torch.int64).clamp_min(0), (res_i - 1)[None, :, None])
    f = p - i0.to(xyz.dtype)
    wts, sign = (1.0 - f, f), (-1.0, 1.0)
    entries = _corner_entries(i0, res_i, table_size, variant)
    dweights = []
    for cx, cy, cz in _CORNER_OFFSETS:
        wx, wy, wz = wts[cx][..., 0], wts[cy][..., 1], wts[cz][..., 2]
        dweights.append(torch.stack([sign[cx] * (wy * wz), sign[cy] * (wx * wz), sign[cz] * (wx * wy)], -1))
    return entries, dweights


def _read_table(table, read_bf16):
    n_levels, table_size, n_feat = table.shape
    tab = table.reshape(n_levels * table_size, n_feat)
    return tab.to(torch.bfloat16).to(table.dtype) if read_bf16 else tab


def _level_scale(xyz, res, aabb_len):
    """(1, L, 3): d f / d xyz per level and axis, res_l / len_a."""
    res_f = torch.as_tensor(np.asarray(res), dtype=xyz.dtype, device=xyz.device)
    ln = torch.as_tensor(np.asarray(aabb_len, np.float32), device=xyz.device).to(xyz.dtype)
    return res_f[None, :, None] / ln[None, None, :]


def hash_encode_dx_reference(xyz, table, g, res, aabb_min, aabb_len, variant, read_bf16=True):
    """Plain version of the encoding's input gradient: dL/dxyz (B, 3) for
    dL/d(encoding) ``g`` (B, L F), the table read as the forward reads it.
    Per level and axis sum_c sum_f g_f T[e_c, f] d w_c / d f_a, times
    res_l / len_a, summed over the levels. The floor and the clip of the
    cell index carry no gradient (as under ``jax.grad``)."""
    n_levels, table_size, n_feat = table.shape
    entries, dweights = _corner_weight_grads(xyz, res, aabb_min, aabb_len, table_size, variant)
    tab = _read_table(table, read_bf16)
    g = g.reshape(xyz.shape[0], n_levels, n_feat)
    level_off = (torch.arange(n_levels, device=xyz.device, dtype=torch.int64) * table_size)[None, :]
    gp = torch.zeros(xyz.shape[0], n_levels, 3, dtype=g.dtype, device=xyz.device)
    for e, dw in zip(entries, dweights):
        gp = gp + (tab[e + level_off] * g).sum(-1)[..., None] * dw
    return (gp * _level_scale(xyz, res, aabb_len)).sum(1)


def hash_dx_bwd_reference(xyz, table, g, g_dx, res, aabb_min, aabb_len, variant, read_bf16=True):
    """Plain version of the input gradient's backward for its gradient
    ``g_dx`` (B, 3): (the table's (L, T, F), straight through the bf16
    read; g's (B, L F)). With u_c = sum_a g_dx_a res_l / len_a d w_c / d f_a
    per point, level and corner: the table gains u_c g at entry e_c, and g
    gains sum_c u_c T[e_c]. No gradient goes to the points."""
    n_levels, table_size, n_feat = table.shape
    entries, dweights = _corner_weight_grads(xyz, res, aabb_min, aabb_len, table_size, variant)
    tab = _read_table(table, read_bf16)
    g = g.reshape(xyz.shape[0], n_levels, n_feat)
    q = g_dx[:, None, :] * _level_scale(xyz, res, aabb_len)  # (B, L, 3)
    level_off = (torch.arange(n_levels, device=xyz.device, dtype=torch.int64) * table_size)[None, :]
    d_table = torch.zeros(n_levels * table_size, n_feat, dtype=table.dtype, device=xyz.device)
    d_g = torch.zeros_like(g)
    for e, dw in zip(entries, dweights):
        u = (dw * q).sum(-1)[..., None]  # (B, L, 1)
        d_table.index_add_(0, (e + level_off).reshape(-1), (u * g).reshape(-1, n_feat))
        d_g = d_g + u * tab[e + level_off]
    return d_table.reshape(table.shape), d_g.reshape(xyz.shape[0], n_levels * n_feat)


def _kernel_args(xyz, table_shape, res, res_dev, name):
    n_levels, table_size, n_feat = table_shape
    log2_t = int(table_size).bit_length() - 1
    if 1 << log2_t != table_size:
        raise ValueError("{}: the table size must be a power of two".format(name))
    if res_dev is None:
        res_dev = torch.as_tensor(np.asarray(res), dtype=torch.int32, device=xyz.device)
    return n_levels, log2_t, n_feat, res_dev


def hash_encode_fwd(xyz, table, res, aabb_min, aabb_len, variant, read_bf16=True, res_dev=None):
    """Kernel B on CUDA tensors -> (B, L * F) f32, or raises."""
    _, log2_t, _, res_dev = _kernel_args(xyz, table.shape, res, res_dev, "hash_encode")
    out = cuda_lib.ops().hash_encode_fwd(xyz, table, res_dev, log2_t, aabb_min, aabb_len, _VARIANTS[variant],
                                         bool(read_bf16))
    if xyz.shape[0] > 0:
        hash_encode.launches += 1
    return out


def hash_encode_bwd(xyz, g, table_shape, res, aabb_min, aabb_len, variant, res_dev=None):
    """Table gradient (L, T, F) f32 of the encoding for its gradient ``g``
    (B, L * F). A CPU tensor takes ``hash_encode_bwd_reference``; a CUDA
    tensor launches kernel E or raises."""
    if xyz.is_cpu:
        return hash_encode_bwd_reference(xyz, g, table_shape, res, aabb_min, aabb_len, variant)
    n_levels, log2_t, n_feat, res_dev = _kernel_args(xyz, table_shape, res, res_dev, "hash_encode_bwd")
    grad = cuda_lib.ops().hash_encode_bwd(xyz, g, res_dev, n_levels, log2_t, n_feat, aabb_min, aabb_len,
                                          _VARIANTS[variant])
    if xyz.shape[0] > 0:
        hash_encode_bwd.launches += 1
    return grad


def hash_encode_dx(xyz, table, g, res, aabb_min, aabb_len, variant, read_bf16=True, res_dev=None):
    """dL/dxyz (B, 3) of the encoding for its gradient ``g`` (B, L F). A
    CPU tensor takes ``hash_encode_dx_reference``; a CUDA tensor launches
    kernel K or raises."""
    if xyz.is_cpu:
        return hash_encode_dx_reference(xyz, table, g, res, aabb_min, aabb_len, variant, read_bf16)
    _, log2_t, _, res_dev = _kernel_args(xyz, table.shape, res, res_dev, "hash_encode_dx")
    dx = cuda_lib.ops().hash_dx(xyz, table, g, res_dev, log2_t, aabb_min, aabb_len, _VARIANTS[variant],
                                bool(read_bf16))
    if xyz.shape[0] > 0:
        hash_encode_dx.launches += 1
    return dx


def hash_dx_bwd(xyz, table, g, g_dx, res, aabb_min, aabb_len, variant, read_bf16=True, res_dev=None):
    """(table gradient (L, T, F), g's gradient (B, L F)) of
    ``hash_encode_dx`` for its gradient ``g_dx`` (B, 3). A CPU tensor takes
    ``hash_dx_bwd_reference``; a CUDA tensor launches kernel L or raises."""
    if xyz.is_cpu:
        return hash_dx_bwd_reference(xyz, table, g, g_dx, res, aabb_min, aabb_len, variant, read_bf16)
    _, log2_t, _, res_dev = _kernel_args(xyz, table.shape, res, res_dev, "hash_dx_bwd")
    d_table, d_g = cuda_lib.ops().hash_dx_bwd(xyz, table, g, g_dx, res_dev, log2_t, aabb_min, aabb_len,
                                              _VARIANTS[variant], bool(read_bf16))
    if xyz.shape[0] > 0:
        hash_dx_bwd.launches += 1
    return d_table, d_g


class _HashDxFunction(torch.autograd.Function):
    """The input gradient as a function of the table and of g, with kernel
    L (its plain version on the CPU) as its backward: the eikonal loss and
    the radiance net reach the table and the geometry chain through the
    normal. The points get no gradient: they are not learned."""

    @staticmethod
    def forward(ctx, xyz, table, g, res, aabb_min, aabb_len, variant, read_bf16, res_dev):
        ctx.save_for_backward(xyz, table, g)
        ctx.args = (res, aabb_min, aabb_len, variant, read_bf16, res_dev)
        return hash_encode_dx(xyz, table, g.contiguous(), res, aabb_min, aabb_len, variant, read_bf16, res_dev)

    @staticmethod
    def backward(ctx, g_dx):
        xyz, table, g = ctx.saved_tensors
        d_table, d_g = hash_dx_bwd(xyz, table, g.contiguous(), g_dx.contiguous(), *ctx.args)
        return None, d_table, d_g, None, None, None, None, None, None


# the open ``input_grad`` blocks, innermost last
_INPUT_GRAD = []


@contextlib.contextmanager
def input_grad():
    """Encodings of points that require a gradient, made inside the block,
    give d/dxyz until the block ends; afterwards their backward gives the
    table's gradient alone. An SDF takes its normal inside the block, and
    the loss's backward then spends no launch on the points' gradient,
    which nothing reads."""
    live = {"on": True}
    _INPUT_GRAD.append(live)
    try:
        yield
    finally:
        live["on"] = False
        _INPUT_GRAD.remove(live)


class _HashInputLink(torch.autograd.Function):
    """Passes the encoding through unchanged and adds its xyz gradient:
    ``hash_encode_dx`` of the gradient that reaches the encoding, a
    differentiable function of it and of the table when the backward
    builds a graph (``create_graph``). The encoding's table gradient stays
    with ``_HashEncodeFunction``, so taking a normal launches no kernel E."""

    @staticmethod
    def forward(ctx, enc, xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev, live):
        ctx.save_for_backward(xyz, table)
        ctx.args = (res, aabb_min, aabb_len, variant, read_bf16, res_dev)
        ctx.live = live
        return enc.view_as(enc)

    @staticmethod
    def backward(ctx, g):
        dx = None
        if ctx.live is None or ctx.live["on"]:
            xyz, table = ctx.saved_tensors
            if torch.is_grad_enabled():
                dx = _HashDxFunction.apply(xyz.detach(), table, g, *ctx.args)
            else:
                dx = hash_encode_dx(xyz.detach(), table.detach(), g.contiguous(), *ctx.args)
        return g, dx, None, None, None, None, None, None, None, None


class _HashEncodeFunction(torch.autograd.Function):
    """Encoding with the table scatter as its backward: kernels B and E on
    the card, their plain versions on the CPU. No xyz gradient."""

    @staticmethod
    def forward(ctx, xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev):
        if xyz.is_cpu:
            out = hash_encode_reference(xyz, table, res, aabb_min, aabb_len, variant, read_bf16)
        else:
            out = hash_encode_fwd(xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev)
        ctx.save_for_backward(xyz)
        ctx.args = (tuple(table.shape), res, aabb_min, aabb_len, variant, res_dev)
        return out

    @staticmethod
    def backward(ctx, g):
        (xyz,) = ctx.saved_tensors
        table_shape, res, aabb_min, aabb_len, variant, res_dev = ctx.args
        grad = hash_encode_bwd(xyz, g.contiguous(), table_shape, res, aabb_min, aabb_len, variant, res_dev)
        return None, grad, None, None, None, None, None, None


def hash_encode(xyz, table, res, aabb_min, aabb_len, variant, read_bf16=True, res_dev=None):
    """Hash-grid encoding. A CPU tensor takes the plain versions; a CUDA
    tensor launches kernel B, and kernel E in the backward, or raises.
    Points that require a gradient also get d/dxyz (``_HashInputLink``:
    kernel K, and kernel L in its backward). ``res_dev`` optionally gives
    ``res`` as an int32 tensor already on the device."""
    if not (xyz.is_cpu or xyz.is_cuda):  # the binding checks the rest; this spares a build
        raise ValueError("hash_encode: expected CPU or CUDA tensors, got {}".format(xyz.device))
    if torch.is_grad_enabled() and xyz.requires_grad:
        enc = _encode(xyz.detach(), table, res, aabb_min, aabb_len, variant, read_bf16, res_dev)
        live = _INPUT_GRAD[-1] if _INPUT_GRAD else None
        return _HashInputLink.apply(enc, xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev, live)
    return _encode(xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev)


def _encode(xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev):
    if torch.is_grad_enabled() and table.requires_grad:
        return _HashEncodeFunction.apply(xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev)
    if xyz.is_cpu:
        return hash_encode_reference(xyz, table, res, aabb_min, aabb_len, variant, read_bf16)
    return hash_encode_fwd(xyz, table, res, aabb_min, aabb_len, variant, read_bf16, res_dev)


hash_encode.launches = 0
hash_encode_bwd.launches = 0
hash_encode_dx.launches = 0
hash_dx_bwd.launches = 0


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

    def input_gradient(self, xyz, g):
        """d/dxyz (B, 3) of the table's features for their gradient ``g`` (B,
        L F), the points given apart (kernel K): differentiable in the table
        and ``g`` (kernel L in the backward) where grad mode is on and
        either requires a gradient. The geometry chain's fused path
        (``sdf_model.geo_with_grad``) takes the normal here."""
        args = (self.resolutions, self.aabb_min, self.aabb_len, self.variant, self.read_bf16, self._res)
        if torch.is_grad_enabled() and (g.requires_grad or self.embeddings.requires_grad):
            return _HashDxFunction.apply(xyz, self.embeddings, g, *args)
        return hash_encode_dx(xyz, self.embeddings, g.contiguous(), *args)
