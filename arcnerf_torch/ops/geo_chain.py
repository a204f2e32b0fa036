"""NeuS-NGP's geometry chain as one explicit first-order computation
(kernels M and N, ``csrc/geo_chain.cu``).

The recipe's ``GeoNet`` (hash-grid features (N, 32) -> 64 -> 17 in f32,
softplus(beta z) / beta, no bias) maps ``enc`` to ``out`` (sdf, feature)
and, for the normal, to ``g`` = d sdf / d enc; the loss's backward then
takes (d_out, d_g) to (d_enc, dW1, dW2) in one pass, where autograd would
differentiate the create-graph derivative a second time (~40 elementwise
and GEMM kernels a step). With W1 (32, 64), W2 (64, 17), w = W2[:, 0],
sigma = softplus'(beta z) and sigma' its derivative:

    z = enc W1, a = softplus(beta z) / beta, out = a W2, g = (sigma w) W1^T
    u = d_g W1, v = sigma w, dz = u w sigma' + (d_out W2^T) sigma
    d_enc = dz W1^T, dW1 = d_g^T v + enc^T dz, dW2 = a^T d_out (+ sum(u sigma) in column 0)

softplus is PyTorch's (threshold 20 on beta z, the derivative as e / (e + 1)),
so the chain lands within f32 rounding of the autograd path's. The JAX
package takes the same derivatives with ``jax.grad`` of ``jax.grad``
(``arcnerf_tpu/models/sdf_model.py``); ``geo_chain_fwd_reference`` and
``geo_chain_bwd_reference`` are the plain versions. A CPU tensor takes
them; a CUDA tensor launches the kernels or raises.

``n_rows``, where given, is a () int64 tensor on the rows' device: the
rows to compute (a compacted stream's kept rows). Rows at or past it come
out 0 and add nothing to the weights' gradients, with no host read, so a
CUDA graph can capture the calls.
"""

import torch
from torch.autograd.function import once_differentiable

from . import cuda_lib

IN, HIDDEN, OUT = 32, 64, 17  # the one chain the kernels are built for
THRESHOLD = 20.0  # PyTorch's softplus threshold (of beta z)


def _keep(x, n_rows):
    """x with its rows at or past ``n_rows`` set to 0 (all rows kept for None)."""
    if n_rows is None:
        return x
    keep = torch.arange(x.shape[0], device=x.device) < n_rows
    return torch.where(keep[:, None], x, 0.0)


def _softplus(z, beta):
    """(a, sigma, sigma'): softplus(beta z) / beta, its derivative and the
    derivative's, as PyTorch's softplus and its backward compute them
    (above the threshold a = z, sigma = 1, sigma' = 0)."""
    y = z * beta
    over = y > THRESHOLD
    e = torch.exp(torch.where(over, 0.0, y))
    a = torch.where(over, y, torch.log1p(e)) * (1.0 / beta)
    sigma = torch.where(over, 1.0, e / (e + 1.0))
    dsigma = torch.where(over, 0.0, beta * e / ((e + 1.0) * (e + 1.0)))
    return a, sigma, dsigma


def geo_chain_fwd_reference(enc, w1, w2, beta, n_rows=None):
    """Plain version of kernel M: (out (N, 17), g (N, 32))."""
    enc = _keep(enc, n_rows)
    a, sigma, _ = _softplus(enc @ w1, beta)
    return _keep(a @ w2, n_rows), _keep((sigma * w2[:, 0]) @ w1.t(), n_rows)


def geo_chain_bwd_reference(enc, w1, w2, d_out, d_g, beta, n_rows=None):
    """Plain version of kernel N and its reduce: (d_enc (N, 32), dW1 (32,
    64), dW2 (64, 17)) for the gradients d_out (N, 17) and d_g (N, 32)."""
    enc, d_out, d_g = _keep(enc, n_rows), _keep(d_out, n_rows), _keep(d_g, n_rows)
    a, sigma, dsigma = _softplus(enc @ w1, beta)
    w = w2[:, 0]
    u = d_g @ w1
    dz = u * w * dsigma + (d_out @ w2.t()) * sigma
    dw1 = d_g.t() @ (sigma * w) + enc.t() @ dz
    dw2 = a.t() @ d_out
    dw2[:, 0] += (u * sigma).sum(0)
    return dz @ w1.t(), dw1, dw2


def _aligned(t):
    """t contiguous and 16-byte aligned, as the kernels read it."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def geo_chain_fwd(enc, w1, w2, beta, n_rows=None):
    """(out, g) of the chain: ``geo_chain_fwd_reference`` for a CPU
    tensor, kernel M for a CUDA tensor (or raises)."""
    if enc.is_cpu:
        return geo_chain_fwd_reference(enc, w1, w2, beta, n_rows)
    out, g = cuda_lib.ops().geo_chain_fwd(_aligned(enc), w1.contiguous(), w2.contiguous(), n_rows, float(beta))
    if enc.shape[0] > 0:
        geo_chain_fwd.launches += 1
    return out, g


def geo_chain_bwd(enc, w1, w2, d_out, d_g, beta, n_rows=None):
    """(d_enc, dW1, dW2) of the chain: ``geo_chain_bwd_reference`` for a
    CPU tensor, kernel N and its reduce for a CUDA tensor (or raises)."""
    if enc.is_cpu:
        return geo_chain_bwd_reference(enc, w1, w2, d_out, d_g, beta, n_rows)
    grads = cuda_lib.ops().geo_chain_bwd(_aligned(enc), w1.contiguous(), w2.contiguous(), d_out.contiguous(),
                                         _aligned(d_g), n_rows, float(beta))
    if enc.shape[0] > 0:
        geo_chain_bwd.launches += 1
    return grads


geo_chain_fwd.launches = 0
geo_chain_bwd.launches = 0


class GeoChain(torch.autograd.Function):
    """(enc, W1, W2) -> (out, g) with kernel N as its backward: a plain
    backward, as nothing takes a third derivative."""

    @staticmethod
    def forward(ctx, enc, w1, w2, beta, n_rows):
        ctx.save_for_backward(enc, w1, w2, n_rows)
        ctx.beta = beta
        return geo_chain_fwd(enc, w1, w2, beta, n_rows)

    @staticmethod
    @once_differentiable
    def backward(ctx, d_out, d_g):
        enc, w1, w2, n_rows = ctx.saved_tensors
        d_enc, dw1, dw2 = geo_chain_bwd(enc, w1, w2, d_out, d_g, ctx.beta, n_rows)
        return d_enc, dw1, dw2, None, None


def geo_chain(enc, w1, w2, beta, n_rows=None):
    """(out (N, 17), g (N, 32)): differentiable through ``GeoChain`` where
    grad mode is on and an input requires a gradient."""
    if torch.is_grad_enabled() and (enc.requires_grad or w1.requires_grad or w2.requires_grad):
        return GeoChain.apply(enc, w1, w2, beta, n_rows)
    return geo_chain_fwd(enc, w1, w2, beta, n_rows)
