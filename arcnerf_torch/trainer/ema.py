"""Debiased exponential moving average of the parameters (counterpart of
``arcnerf_tpu/trainer/ema.py``): shadow = decay * shadow + (1 - decay) *
param, read as shadow / (1 - decay^step). Shadows are f32 tensors keyed by
parameter name; the update is in place."""

import torch


def ema_init(named_params):
    return {name: torch.zeros_like(p, dtype=torch.float32) for name, p in named_params}


@torch.no_grad()
def ema_update(ema, named_params, decay=0.95):
    for name, p in named_params:
        ema[name].mul_(decay).add_(p.detach().float(), alpha=1.0 - decay)
    return ema


def ema_debiased(ema, step, decay=0.95):
    factor = 1.0 - decay ** max(int(step), 1)
    return {name: s / factor for name, s in ema.items()}
