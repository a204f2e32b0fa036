"""The SDF nets' softplus(beta x) / beta as one pass a derivative order
(kernel P, ``csrc/softplus.cu``).

PyTorch writes the activation as three elementwise passes,
``F.softplus(beta * x) / beta``, and autograd differentiates each of them
(three more passes for the backward, more again for the eikonal loss's
double backward). ``Softplus`` computes the same values in one pass, and
its backward ``SoftplusBackward`` (a Function, so that ``create_graph``
differentiates it) its gradient in one pass and its own gradients in one
more. With y = beta x, inv = fl(1 / beta) (the f32 reciprocal the card
multiplies by for a division by a number) and z = exp(y):

    out = (y > 20 ? y : log1p(z)) inv
    d_x = (y > 20 ? g1 : g1 z / (z + 1)) beta,       g1 = d_out inv
    g_dout = (y > 20 ? gg2 : gg2 z / (z + 1)) inv,   gg2 = gg beta
    g_x = gg2 g1 (1 - sig) sig [y < 20] beta,         sig = 1 / (1 + exp(-y))

each as PyTorch's CUDA kernels order the three-op form's operations, so the
forward and the backward equal it bit for bit on the card. The JAX package
leaves the activation to XLA (``arcnerf_tpu/models/base_modules/
activation.py``). ``softplus_fwd_reference``, ``softplus_bwd_reference`` and
``softplus_bwd2_reference`` are the plain versions: a CPU tensor takes them,
a CUDA tensor launches the kernels or raises.
"""

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib

THRESHOLD = 20.0  # PyTorch's softplus threshold (of beta x)


def _inv(beta, x):
    """1 / beta rounded to x's dtype, as the card's division by a number
    multiplies by it."""
    return (torch.ones((), dtype=x.dtype) / beta).item()


def softplus_fwd_reference(x, beta):
    """Plain version of the forward: softplus(beta x) / beta."""
    y = x * beta
    return torch.where(y > THRESHOLD, y, torch.log1p(torch.exp(y))) * _inv(beta, x)


def softplus_bwd_reference(x, d_out, beta):
    """Plain version of the backward: d_x for the gradient d_out."""
    y = x * beta
    g1 = d_out * _inv(beta, x)
    z = torch.exp(y)
    return torch.where(y > THRESHOLD, g1, g1 * z / (z + 1.0)) * beta


def softplus_bwd2_reference(x, d_out, gg, beta):
    """Plain version of the double backward: (g_x, g_dout), the backward's
    gradients of x and of d_out for the gradient gg of d_x."""
    inv = _inv(beta, x)
    y = x * beta
    gg2 = gg * beta
    z = torch.exp(y)
    g_dout = torch.where(y > THRESHOLD, gg2, gg2 * z / (z + 1.0)) * inv
    sig = 1.0 / (1.0 + torch.exp(-y))
    g_y = (gg2 * (d_out * inv)) * (1.0 - sig) * sig * (y < THRESHOLD).to(x.dtype)
    return g_y * beta, g_dout


def softplus_fwd(x, beta):
    """The forward: ``softplus_fwd_reference`` for a CPU tensor, kernel P
    for a CUDA tensor (or raises)."""
    if x.is_cpu:
        return softplus_fwd_reference(x, beta)
    out = cuda_lib.ops().softplus_fwd(x.contiguous(), float(beta))
    if x.numel() > 0:
        softplus_fwd.launches += 1
    return out


def softplus_bwd(x, d_out, beta):
    """The backward: ``softplus_bwd_reference`` for a CPU tensor, kernel P
    for a CUDA tensor (or raises)."""
    if x.is_cpu:
        return softplus_bwd_reference(x, d_out, beta)
    d_x = cuda_lib.ops().softplus_bwd(x.contiguous(), d_out.contiguous(), float(beta))
    if x.numel() > 0:
        softplus_bwd.launches += 1
    return d_x


def softplus_bwd2(x, d_out, gg, beta):
    """The double backward: ``softplus_bwd2_reference`` for a CPU tensor,
    kernel P for a CUDA tensor (or raises)."""
    if x.is_cpu:
        return softplus_bwd2_reference(x, d_out, gg, beta)
    grads = cuda_lib.ops().softplus_bwd2(x.contiguous(), d_out.contiguous(), gg.contiguous(), float(beta))
    if x.numel() > 0:
        softplus_bwd2.launches += 1
    return grads


softplus_fwd.launches = 0
softplus_bwd.launches = 0
softplus_bwd2.launches = 0


class Softplus(torch.autograd.Function):
    """x -> softplus(beta x) / beta; saves x alone."""

    @staticmethod
    def forward(ctx, x, beta):
        ctx.save_for_backward(x)
        ctx.beta = beta
        return softplus_fwd(x, beta)

    @staticmethod
    def backward(ctx, d_out):
        (x,) = ctx.saved_tensors
        return SoftplusBackward.apply(x, d_out, ctx.beta), None


class SoftplusBackward(torch.autograd.Function):
    """(x, d_out) -> d_x, differentiable once more (the eikonal loss's
    double backward) through the one-pass double backward."""

    @staticmethod
    def forward(ctx, x, d_out, beta):
        ctx.save_for_backward(x, d_out)
        ctx.beta = beta
        return softplus_bwd(x, d_out, beta)

    @staticmethod
    @once_differentiable
    def backward(ctx, gg):
        x, d_out = ctx.saved_tensors
        g_x, g_dout = softplus_bwd2(x, d_out, gg, ctx.beta)
        return g_x, g_dout, None

