"""The rounding design of kernel D (``csrc/fused_mlp_bwd.cu``) emulated in
plain PyTorch on the CPU, against ``fused_mlp_bwd_reference``.

The kernel runs both products of the backward on bf16 tensor cores with f32
accumulation. A layer's input (bf16(x) or relu of a bf16 pre-activation) is
exact in bf16, but the gradient g is f32, so dW = input^T g takes g as two
bf16 operands, g_hi = bf16(g) and g_lo = bf16(g - g_hi), summed into one f32
accumulator: about 2^-17 relative error per term. The emulation keeps the
kernel's operands and its sum structure (f32 sums over 64-row tiles, then a
sum over the tiles) and holds every output within 1e-4 x max|ref|, the
tolerance the card holds the kernel to. It also records that g rounded to
bf16 alone (2^-9 per term) does not stay within it, which is why g is split,
and that the dX products whose results are rounded to bf16 again cannot
take another summation order at all, which is why the kernel runs them as
sequential f32 FMAs in the plain version's order.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import arcnerf_torch.ops.fused_mlp as fused_mlp_mod
from arcnerf_torch.ops.fused_mlp import fused_mlp_bwd_reference, fused_mlp_reference

ROWS, TILE, TOL = 1 << 16, 64, 1e-4


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _emulate(x, g, weights, pre, split):
    """dX and [dW] with kernel D's operands: dW from P^T (g_hi + g_lo) (or
    P^T bf16(g) without ``split``) summed in f32 per 64-row tile and then
    over the tiles; dX from bf16(g) x bf16(W)^T in f32."""
    n = len(weights)
    posts = [_bf16(x)] + [torch.relu(pre[i].float()) for i in range(n - 1)]
    g = g.float()
    dws = [None] * n
    for i in reversed(range(n)):
        if i < n - 1:
            g = g * (pre[i].float() > 0)
        hi = _bf16(g)
        p_t = posts[i].reshape(-1, TILE, posts[i].shape[1]).transpose(1, 2)
        tiles = torch.bmm(p_t, hi.reshape(-1, TILE, hi.shape[1]))
        if split:
            tiles = tiles + torch.bmm(p_t, _bf16(g - hi).reshape(-1, TILE, hi.shape[1]))
        dws[i] = tiles.sum(0)
        g = hi @ _bf16(weights[i]).T
    return g, dws


def _worst(out, ref):
    # largest |out - ref| relative to max|ref|, for dX and each dW
    dx, dws = out
    dx_ref, dws_ref = ref
    return [float((a - b).abs().max()) / float(b.abs().max()) for a, b in zip([dx] + dws, [dx_ref] + dws_ref)]


@pytest.mark.parametrize("dims", [[32, 64, 16], [18, 64, 64, 3]])
def test_split_g_emulation_meets_the_card_tolerance(dims):
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(ROWS, dims[0])).astype(np.float32))
    ws = [torch.from_numpy((rng.normal(size=(dims[i], dims[i + 1])) / dims[i] ** 0.5).astype(np.float32))
          for i in range(len(dims) - 1)]
    g = torch.from_numpy(rng.normal(size=(ROWS, dims[-1])).astype(np.float32))
    _, pre = fused_mlp_reference(x, ws, save_pre=True)
    ref = fused_mlp_bwd_reference(x, g, ws, pre)

    split = _worst(_emulate(x, g, ws, pre, split=True), ref)
    assert max(split) <= TOL, split
    # g rounded to bf16 alone: dX is unchanged (it rounds g anyway), but
    # some dW leaves the tolerance
    alone = _worst(_emulate(x, g, ws, pre, split=False), ref)
    assert alone[0] <= TOL and max(alone[1:]) > TOL, alone


def _reordered(x, g, weights, pre):
    # the plain backward with each dX product summed in float64 and rounded
    # to f32: another summation order of the same exact products
    n = len(weights)
    posts = [_bf16(x)] + [torch.relu(pre[i].float()) for i in range(n - 1)]
    g = g.float()
    dws = [None] * n
    for i in reversed(range(n)):
        if i < n - 1:
            g = g * (pre[i].float() > 0)
        dws[i] = posts[i].T @ g
        g = (_bf16(g).double() @ _bf16(weights[i]).double().T).float()
    return g, dws


@pytest.mark.parametrize("dims", [[32, 64, 16], [18, 64, 64, 3]])
def test_rerounded_dx_products_need_the_plain_summation_order(dims):
    # at 2^18 rows another f32 order of the hidden dX products flips bf16
    # roundings of g, and dX leaves 1e-4 x max|ref| while dW stays far inside
    rows = 1 << 18
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(rows, dims[0])).astype(np.float32))
    ws = [torch.from_numpy((rng.normal(size=(dims[i], dims[i + 1])) / dims[i] ** 0.5).astype(np.float32))
          for i in range(len(dims) - 1)]
    g = torch.from_numpy(rng.normal(size=(rows, dims[-1])).astype(np.float32))
    _, pre = fused_mlp_reference(x, ws, save_pre=True)
    worst = _worst(_reordered(x, g, ws, pre), fused_mlp_bwd_reference(x, g, ws, pre))
    assert worst[0] > TOL and max(worst[1:]) < TOL / 10, worst


def test_wrapper_sizes_kernel_d_as_its_source_does():
    # fused_mlp_bwd allocates the per-CTA dW scratch and checks the depth
    # with the kernel's own limits
    src = (Path(fused_mlp_mod.__file__).parents[1] / "csrc" / "fused_mlp_bwd.cu").read_text()
    assert "constexpr int kMaxParts = {};".format(fused_mlp_mod.D_MAX_PARTS) in src
    assert "constexpr int kMaxHidden = {};".format(fused_mlp_mod.D_MAX_HIDDEN) in src
