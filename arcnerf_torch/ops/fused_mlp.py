"""Fused bias-free MLP forward: kernel A and its plain PyTorch version.

Counterpart of ``arcnerf_tpu/ops/fused_mlp.py``: ``fused_mlp`` replaces the
Pallas forward (``_run_forward`` / ``_fwd_kernel``) with the CUDA kernel in
``csrc/fused_mlp.cu``; ``fused_mlp_reference`` is the plain version. Both
compute the same function as the JAX package's Pallas and XLA backends:
bf16 operands, f32 accumulation, the activation on every layer but the
last, bf16 between layers, f32 (bf16-valued) output.

The backward kernel (the TPU ``_bwd_kernel``) lands with training; until
then the CUDA path refuses to run where autograd would need it.
"""

import torch

from . import cuda_lib


def fused_mlp_reference(x, weights, activation=torch.relu):
    """Plain version: x (B, D_in) through weights [(D_i, D_{i+1})] -> (B, D_out) f32."""
    h = x.to(torch.bfloat16)
    for i, w in enumerate(weights):
        # bf16 x bf16 products are exact in f32, so an f32 matmul of the
        # rounded operands is the f32-accumulated bf16 product
        h = h.float() @ w.to(torch.bfloat16).float()
        if i < len(weights) - 1:
            h = activation(h)
        h = h.to(torch.bfloat16)
    return h.float()


def _round_up(n, m):
    return -(-n // m) * m


def pack_weights(weights, din_pad, dout_pad, device):
    """Weights of one chain -> the kernel's single zero-padded bf16 buffer on
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


def fused_mlp(x, weights, activation=torch.relu):
    """Fused no-bias MLP chain. A CPU tensor takes ``fused_mlp_reference``;
    a CUDA tensor launches kernel A (ReLU chains 64 wide, D_in <= 64,
    D_out <= 16) or raises."""
    if x.device.type == "cpu":
        return fused_mlp_reference(x, weights, activation)
    cuda_lib.require_cuda("fused_mlp", x)
    if torch.is_grad_enabled() and (x.requires_grad or any(w.requires_grad for w in weights)):
        raise RuntimeError("fused_mlp: the CUDA backward kernel is not ported yet (inference only)")
    if activation is not torch.relu:
        raise ValueError("fused_mlp: kernel A implements ReLU chains only")
    n_rows, d_in = x.shape
    width, d_out = weights[0].shape[1], weights[-1].shape[1]
    if width != 64 or any(w.shape != (64, 64) for w in weights[1:-1]) or weights[-1].shape[0] != 64:
        raise ValueError("fused_mlp: kernel A is built for 64-wide chains")
    din_pad = 32 if d_in <= 32 else 64
    dout_pad = 4 if d_out <= 4 else 16
    packed = pack_weights(weights, din_pad, dout_pad, x.device)
    out = torch.empty((n_rows, d_out), dtype=torch.float32, device=x.device)
    if n_rows == 0:
        return out
    status = cuda_lib.lib().arcnerf_fused_mlp_fwd(
        x.data_ptr(), n_rows, d_in, din_pad, packed.data_ptr(), width, len(weights) - 1, d_out, dout_pad,
        out.data_ptr(), cuda_lib.stream_handle(x.device))
    cuda_lib.check(status, "fused_mlp")
    fused_mlp.launches += 1
    return out


fused_mlp.launches = 0
