"""exp with a truncated-input gradient (instant-ngp's trunc_exp).

Counterpart of ``arcnerf_tpu/ops/trunc_exp.py``: the forward is the plain
exp; only the backward clips its input, grad * exp(clip(x, -15, 15)).
"""

import torch

_CLIP = 15.0


class _TruncExp(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(x.clamp(-_CLIP, _CLIP))


def trunc_exp(x):
    return _TruncExp.apply(x)
