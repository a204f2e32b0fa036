"""Fused bias-free MLP: kernels A (forward) and D (backward), their plain
PyTorch versions, and the autograd Function that joins them.

Counterpart of ``arcnerf_tpu/ops/fused_mlp.py``. ``fused_mlp`` replaces the
Pallas forward (``_run_forward`` / ``_fwd_kernel``) with the CUDA kernel in
``csrc/fused_mlp.cu`` and, where autograd needs it, the Pallas backward
(``_fused_mlp_bwd`` / ``_bwd_kernel``) with the one in
``csrc/fused_mlp_bwd.cu``. Forward semantics are those of the JAX
package's Pallas and XLA backends: bf16 operands, f32 accumulation, the
activation on every layer but the last, bf16 between layers, f32
(bf16-valued) output. The backward follows the Pallas kernel's rounding
(``fused_mlp_bwd_reference``), not XLA's autodiff, which rounds
cotangents to bf16.
"""

import torch

from . import cuda_lib


def fused_mlp_reference(x, weights, activation=torch.relu, save_pre=False):
    """Plain version: x (B, D_in) through weights [(D_i, D_{i+1})] -> (B, D_out)
    f32. With ``save_pre`` also returns the hidden pre-activations rounded
    to bf16, stacked (n_hidden, B, W)."""
    h = x.to(torch.bfloat16)
    pres = []
    for i, w in enumerate(weights):
        # bf16 x bf16 products are exact in f32, so an f32 matmul of the
        # rounded operands is the f32-accumulated bf16 product
        h = h.float() @ w.to(torch.bfloat16).float()
        if i < len(weights) - 1:
            if save_pre:
                pres.append(h.to(torch.bfloat16))
            h = activation(h)
        h = h.to(torch.bfloat16)
    if save_pre:
        return h.float(), torch.stack(pres)
    return h.float()


def fused_mlp_bwd_reference(x, g, weights, pre):
    """Plain version of the backward of a ReLU chain from the saved bf16
    pre-activations ``pre`` (n_hidden, B, W), with the Pallas kernel's
    rounding: layer inputs bf16(x) / bf16(relu(pre)), g in f32 through the
    ReLU mask and into dW = input^T g, g rounded to bf16 only for the dX
    product. Returns dX (B, D_in) f32 and [dW_i] f32."""
    n = len(weights)
    posts = [x.to(torch.bfloat16).float()] + [torch.relu(pre[i].float()) for i in range(n - 1)]
    g = g.float()
    dws = [None] * n
    for i in reversed(range(n)):
        if i < n - 1:
            g = g * (pre[i].float() > 0)
        dws[i] = posts[i].T @ g
        g = g.to(torch.bfloat16).float() @ weights[i].to(torch.bfloat16).float().T
    return g, dws


# kernel D's limits: kMaxHidden and kMaxParts in csrc/fused_mlp_bwd.cu
D_MAX_HIDDEN, D_MAX_PARTS = 3, 1024


def _pads(d_in, d_out):
    return (32 if d_in <= 32 else 64), (4 if d_out <= 4 else 16)


def pack_weights(weights, din_pad, dout_pad, device):
    """Weights of one chain -> the kernels' single zero-padded bf16 buffer on
    ``device``: W_0 (din_pad, W), the hidden (W, W) blocks, W_out (W, dout_pad)."""
    width = weights[0].shape[1]
    blocks = []
    for i, w in enumerate(weights):
        rows = din_pad if i == 0 else width
        cols = dout_pad if i == len(weights) - 1 else width
        blk = torch.zeros((rows, cols), dtype=torch.bfloat16, device=device)
        blk[: w.shape[0], : w.shape[1]] = w.to(torch.bfloat16)
        blocks.append(blk.reshape(-1))
    return torch.cat(blocks)


def unpack_grads(buf, weights, din_pad, dout_pad):
    """The packed f32 dW buffer of kernel D -> [dW_i] shaped like ``weights``."""
    width = weights[0].shape[1]
    out, pos = [], 0
    for i, w in enumerate(weights):
        rows = din_pad if i == 0 else width
        cols = dout_pad if i == len(weights) - 1 else width
        out.append(buf[pos:pos + rows * cols].view(rows, cols)[: w.shape[0], : w.shape[1]])
        pos += rows * cols
    return out


def _check_chain(x, weights):
    width = weights[0].shape[1]
    if width != 64 or any(w.shape != (64, 64) for w in weights[1:-1]) or weights[-1].shape[0] != 64:
        raise ValueError("fused_mlp: kernels A and D are built for 64-wide chains")
    if x.shape[1] > 64 or weights[-1].shape[1] > 16:
        raise ValueError("fused_mlp: kernels A and D take D_in <= 64 and D_out <= 16")


def fused_mlp_fwd(x, weights, save_pre=False, packed=None):
    """Kernel A on CUDA tensors: (B, D_out) f32, plus the (n_hidden, B, 64)
    bf16 pre-activations with ``save_pre``. ``packed`` is the chain's
    ``pack_weights`` buffer, made here when not given. Raises on what it does
    not take."""
    _check_chain(x, weights)
    d_out = weights[-1].shape[1]
    din_pad, dout_pad = _pads(x.shape[1], d_out)
    if packed is None:
        packed = pack_weights(weights, din_pad, dout_pad, x.device)
    out, pre = cuda_lib.ops().fused_mlp_fwd(x, packed, din_pad, len(weights) - 1, d_out, dout_pad, save_pre)
    if x.shape[0] > 0:
        fused_mlp.launches += 1
    return (out, pre) if save_pre else out


def fused_mlp_bwd(x, g, weights, pre, packed=None):
    """Backward of a ReLU chain from the saved pre-activations -> (dX, [dW]).
    A CPU tensor takes ``fused_mlp_bwd_reference``; a CUDA tensor launches
    kernel D (at most ``D_MAX_HIDDEN`` hidden layers) or raises. ``packed``
    is kernel A's buffer of the same weights, made here when not given."""
    if x.is_cpu:
        return fused_mlp_bwd_reference(x, g, weights, pre)
    _check_chain(x, weights)
    if len(weights) - 1 > D_MAX_HIDDEN:
        raise ValueError("fused_mlp_bwd: kernel D takes at most {} hidden layers".format(D_MAX_HIDDEN))
    d_out = weights[-1].shape[1]
    din_pad, dout_pad = _pads(x.shape[1], d_out)
    if packed is None:
        packed = pack_weights(weights, din_pad, dout_pad, x.device)
    # one row of partial sums per CTA, each written whole; row 0 ends as dW
    dx, parts = cuda_lib.ops().fused_mlp_bwd(x, g, packed, pre, din_pad, len(weights) - 1, d_out, dout_pad)
    if x.shape[0] > 0:
        fused_mlp_bwd.launches += 1
    return dx, unpack_grads(parts[0], weights, din_pad, dout_pad)


class _FusedMLPFunction(torch.autograd.Function):
    """ReLU chain with the saved-pre-activation backward: kernels A and D on
    the card, their plain versions on the CPU."""

    @staticmethod
    def forward(ctx, x, *weights):
        packed = None
        if x.is_cpu:
            out, pre = fused_mlp_reference(x, weights, save_pre=True)
        else:
            # kernel D reads the buffer kernel A read: packed once per step
            _check_chain(x, weights)
            packed = pack_weights(weights, *_pads(x.shape[1], weights[-1].shape[1]), x.device)
            out, pre = fused_mlp_fwd(x, weights, save_pre=True, packed=packed)
        ctx.save_for_backward(x, pre, packed, *weights)
        return out

    @staticmethod
    def backward(ctx, g):
        x, pre, packed, *weights = ctx.saved_tensors
        dx, dws = fused_mlp_bwd(x, g.contiguous(), weights, pre, packed=packed)
        return (dx if ctx.needs_input_grad[0] else None, *dws)


def fused_mlp(x, weights, activation=torch.relu):
    """Fused no-bias MLP chain. A CPU tensor takes the plain versions; a CUDA
    tensor launches kernel A, and kernel D in the backward (ReLU chains 64
    wide, D_in <= 64, D_out <= 16), or raises."""
    if activation is not torch.relu:
        if x.is_cpu:
            return fused_mlp_reference(x, weights, activation)
        raise ValueError("fused_mlp: kernels A and D implement ReLU chains only")
    if not (x.is_cpu or x.is_cuda):  # the binding checks the rest; this spares a build
        raise ValueError("fused_mlp: expected CPU or CUDA tensors, got {}".format(x.device))
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        return _FusedMLPFunction.apply(x, *weights)
    if x.is_cpu:
        return fused_mlp_reference(x, weights)
    return fused_mlp_fwd(x, weights)


fused_mlp.launches = 0
fused_mlp_bwd.launches = 0
