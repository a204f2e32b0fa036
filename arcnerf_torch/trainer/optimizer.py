"""Optimizer and learning-rate schedule (counterpart of
``arcnerf_tpu/trainer/optimizer.py``: ``build_lr_schedule``,
``build_optimizer``).

The optimizer is ``torch.optim.Adam``; the schedule is a function of the
number of updates already applied, t (0 for the first update), set on the
optimizer before each step - the count optax reads before incrementing it.
MultiStepLR gives update t the rate lr * gamma^(number of boundaries <= t),
as optax's ``piecewise_constant_schedule`` does; ExponentialLR gives
lr * gamma^(t / lr_steps[0]), as ``optax.exponential_decay``.
"""

import torch

from ..utils.cfgs import get_value_from_cfgs_field


def build_lr_schedule(optim_cfgs):
    """cfgs.optim -> schedule(t) -> lr (float)."""
    base_lr = float(get_value_from_cfgs_field(optim_cfgs, "lr", 5e-4))
    sched_cfgs = get_value_from_cfgs_field(optim_cfgs, "lr_scheduler", None)
    if sched_cfgs is None:
        return lambda t: base_lr
    stype = get_value_from_cfgs_field(sched_cfgs, "type", "ExponentialLR")
    gamma = float(get_value_from_cfgs_field(sched_cfgs, "lr_gamma", 0.1))
    steps = [int(s) for s in get_value_from_cfgs_field(sched_cfgs, "lr_steps", [200000])]
    if stype == "MultiStepLR":
        return lambda t: base_lr * gamma ** sum(1 for s in steps if t >= s)
    if stype == "ExponentialLR":
        return lambda t: base_lr * gamma ** (t / steps[0])
    raise NotImplementedError("lr scheduler {} is not ported yet (ROADMAP Queue 1, item 4)".format(stype))


def build_optimizer(optim_cfgs, params):
    """cfgs.optim -> (torch.optim.Adam over ``params``, schedule). Adam
    without weight decay or gradient clipping is what is ported."""
    otype = str(get_value_from_cfgs_field(optim_cfgs, "optim_type", "adam")).lower()
    if otype != "adam":
        raise NotImplementedError("optimizer {} is not ported yet (ROADMAP Queue 1, item 4)".format(otype))
    for key in ("weight_decay", "clip_gradients"):
        if float(get_value_from_cfgs_field(optim_cfgs, key, 0.0)) > 0:
            raise NotImplementedError("optim.{} is not ported yet (ROADMAP Queue 1, item 4)".format(key))
    eps = float(get_value_from_cfgs_field(optim_cfgs, "eps", 1e-8))
    schedule = build_lr_schedule(optim_cfgs)
    return torch.optim.Adam(params, lr=schedule(0), betas=(0.9, 0.999), eps=eps), schedule
