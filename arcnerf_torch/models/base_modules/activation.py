"""Activation factory (counterpart of
``arcnerf_tpu/models/base_modules/activation.py``).

Supports relu / softplus(beta) / leakyrelu / sine(w0) / sigmoid / truncexp /
identity, selected from a cfg dict/Obj with a ``type`` field.
"""

import torch
import torch.nn.functional as F

from ...ops.trunc_exp import trunc_exp
from ...utils.cfgs import Obj, obj_to_dict


def get_activation(cfg=None, default_cfg=None):
    """cfg: Obj/dict with 'type' (+ optional params) -> callable.

    Returns ReLU when cfg is None and no default given.
    """
    if cfg is None:
        cfg = default_cfg
    if cfg is None:
        return torch.relu
    if isinstance(cfg, Obj):
        cfg = obj_to_dict(cfg)
    if isinstance(cfg, str):
        cfg = {"type": cfg}
    act_type = cfg.get("type", "ReLU").lower()

    if act_type == "relu":
        return torch.relu
    if act_type == "softplus":
        beta = float(cfg.get("beta", 1.0))
        return lambda x: F.softplus(beta * x) / beta
    if act_type == "leakyrelu":
        slope = float(cfg.get("slope", 0.01))
        return lambda x: F.leaky_relu(x, negative_slope=slope)
    if act_type == "sine":
        w0 = float(cfg.get("w", 30.0))
        return lambda x: torch.sin(w0 * x)
    if act_type == "sigmoid":
        return torch.sigmoid
    if act_type == "truncexp":
        return trunc_exp
    if act_type == "identity":
        return lambda x: x
    raise NotImplementedError("activation {} not supported".format(act_type))
