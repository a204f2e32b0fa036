"""Optimizer and learning-rate schedule (counterpart of
``arcnerf_tpu/trainer/optimizer.py``: ``build_lr_schedule``,
``build_optimizer``).

The optimizer is ``torch.optim.Adam`` (``AdamW`` under a weight decay)
with ``fused=True`` and ``capturable=True``, its rate a one-value tensor on
the parameters' device, so that a whole step, the rate included, can be captured in a CUDA graph;
the same optimizer runs on the CPU. The schedule is a function of the
number of updates already applied, t (0 for the first update), given as an
f32 tensor on the device - the count optax reads before incrementing it -
and returns the rate as an f32 tensor there, so no host value enters the
step. MultiStepLR gives update t the rate lr * gamma^(number of boundaries
<= t), as optax's ``piecewise_constant_schedule`` does; ExponentialLR gives
lr * gamma^(t / lr_steps[0]), as ``optax.exponential_decay``.
"""

import torch

from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.device_consts import device_constant


def build_lr_schedule(optim_cfgs):
    """cfgs.optim -> schedule(t) -> lr: t the updates applied (a number or
    a f32 tensor), the rate a f32 tensor on t's device. MultiStepLR picks
    its rate from the f32 roundings of lr * gamma^k."""
    base_lr = float(get_value_from_cfgs_field(optim_cfgs, "lr", 5e-4))
    sched_cfgs = get_value_from_cfgs_field(optim_cfgs, "lr_scheduler", None)
    stype = get_value_from_cfgs_field(sched_cfgs, "type", "ExponentialLR") if sched_cfgs is not None else None
    gamma = float(get_value_from_cfgs_field(sched_cfgs, "lr_gamma", 0.1))
    steps = [int(s) for s in get_value_from_cfgs_field(sched_cfgs, "lr_steps", [200000])]
    if stype not in (None, "MultiStepLR", "ExponentialLR"):
        raise NotImplementedError("lr scheduler {} is not ported yet (ROADMAP Queue 1, item 4)".format(stype))
    rates = [base_lr * gamma**k for k in range(len(steps) + 1)]

    def schedule(t):
        t = torch.as_tensor(t, dtype=torch.float32)
        if stype is None:
            return torch.full_like(t, base_lr)
        if stype == "MultiStepLR":
            passed = sum(((t >= s).long() for s in steps), torch.zeros_like(t, dtype=torch.long))
            return torch.take(device_constant(rates, device=t.device), passed)  # a tensor of its own
        return base_lr * gamma ** (t / steps[0])

    return schedule


def build_optimizer(optim_cfgs, params, device=None):
    """cfgs.optim -> (Adam over ``params`` on ``device``, schedule): Adam,
    or with optim.weight_decay > 0 AdamW, whose decay is decoupled from the
    moments as ``optax.adamw`` decays (p <- p - lr (update + wd p); ArcNerf's
    own ``Adam(weight_decay)`` adds wd p to the gradient instead). Gradient
    clipping is not ported. The rate is a tensor on ``device`` (the CPU by
    default) that the caller sets from ``schedule`` before each step."""
    otype = str(get_value_from_cfgs_field(optim_cfgs, "optim_type", "adam")).lower()
    if otype != "adam":
        raise NotImplementedError("optimizer {} is not ported yet (ROADMAP Queue 1, item 4)".format(otype))
    if float(get_value_from_cfgs_field(optim_cfgs, "clip_gradients", 0.0)) > 0:
        raise NotImplementedError("optim.clip_gradients is not ported yet (ROADMAP Queue 1, item 4)")
    eps = float(get_value_from_cfgs_field(optim_cfgs, "eps", 1e-8))
    weight_decay = float(get_value_from_cfgs_field(optim_cfgs, "weight_decay", 0.0))
    schedule = build_lr_schedule(optim_cfgs)
    lr = schedule(torch.zeros((), device=device))
    kwargs = dict(lr=lr, betas=(0.9, 0.999), eps=eps, fused=True, capturable=True)
    if weight_decay > 0:
        return torch.optim.AdamW(params, weight_decay=weight_decay, **kwargs), schedule
    return torch.optim.Adam(params, **kwargs), schedule
