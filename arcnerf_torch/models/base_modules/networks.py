"""Fused bf16 MLP geometry and radiance nets (instant-ngp style).

Counterpart of ``_FusedMLP``, ``FusedMLPGeoNet`` and ``FusedMLPRadianceNet``
in ``arcnerf_tpu/models/base_modules/networks.py``. Weights are bias-free
``(in, out)`` parameters named ``fc_0 ... fc_{D-1}, fc_out``; the chain runs
through ``ops.fused_mlp`` (kernel A on the card).

FusedMLPGeoNet(x) -> (geo (B, 1), feat (B, W_feat) | None)
FusedMLPRadianceNet(x, view_dirs, normals, feat) -> rgb (B, 3)
"""

import math

import torch
from torch import nn

from ...geometry.transformation import normalize
from ...ops.fused_mlp import fused_mlp
from ...utils.cfgs import dict_to_obj
from ...utils.registry import GEO_MODEL_REGISTRY, RADIANCE_MODEL_REGISTRY
from .activation import get_activation

# flax's lecun_normal: a normal truncated at 2 std, rescaled to unit variance
_TRUNC_STD = 0.87962566103423978


class _FusedMLP(nn.Module):
    """bf16 MLP: no bias, hidden widths {16, 32, 64}, f32 accumulation."""

    def __init__(self, in_dim, W=64, D=2, out_dim=16, act_cfg=None, generator=None):
        super().__init__()
        assert W in (16, 32, 64, 128), "FusedMLP widths limited like tcnn"
        self.act = get_activation(act_cfg)
        self.names = ["fc_{}".format(i) for i in range(D)] + ["fc_out"]
        dims = [in_dim] + [W] * D + [out_dim]
        for i, name in enumerate(self.names):
            std = math.sqrt(1.0 / dims[i]) / _TRUNC_STD
            w = torch.empty(dims[i], dims[i + 1])
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            setattr(self, name, nn.Parameter(w))

    def forward(self, x):
        return fused_mlp(x, [getattr(self, n) for n in self.names], self.act)


@GEO_MODEL_REGISTRY.register()
class FusedMLPGeoNet(nn.Module):
    """Encoder + fused bf16 MLP; geo and feat come from one head."""

    def __init__(self, W=64, D=1, encoder=None, W_feat=15, act_cfg=None, out_act_cfg=None, generator=None):
        super().__init__()
        from . import build_encoder

        self.encoder = build_encoder(encoder, generator)
        self.W_feat = W_feat
        self.mlp = _FusedMLP(self.encoder.out_dim, W=W, D=D, out_dim=1 + max(W_feat, 0), act_cfg=act_cfg,
                             generator=generator)
        self.out_act = get_activation(out_act_cfg) if out_act_cfg is not None else None

    def forward(self, x):
        out = self.mlp(self.encoder(x))
        geo, feat = out[:, :1], (out[:, 1:] if self.W_feat > 0 else None)
        if self.out_act is not None:
            geo = self.out_act(geo)
        return geo, feat


@RADIANCE_MODEL_REGISTRY.register()
class FusedMLPRadianceNet(nn.Module):
    """Fused bf16 MLP radiance net over [pts?, view?, normal?, feat?].

    The JAX package looks ``encoder.pts`` / ``encoder.view`` up with a helper
    that misses the frozen dict flax turns the config into, so both inputs
    enter unencoded (pts as xyz, view as the normalised direction) whatever
    the config names (ROADMAP Queue 3). The port computes the same function,
    so JAX checkpoints load as they are."""

    def __init__(self, mode="vf", W=64, D=2, encoder=None, W_feat_in=15, act_cfg=None, out_act_cfg=None,
                 generator=None):
        super().__init__()
        self.mode, self.W_feat_in = mode, W_feat_in
        in_dim = 3 * sum(m in mode for m in "pvn") + (W_feat_in if "f" in mode and W_feat_in > 0 else 0)
        self.mlp = _FusedMLP(in_dim, W=W, D=D, out_dim=3, act_cfg=act_cfg, generator=generator)
        self.out_act = get_activation(out_act_cfg, dict_to_obj({"type": "Sigmoid"}))

    def forward(self, x, view_dirs, normals, geo_feat):
        inputs = {}
        if "p" in self.mode:
            inputs["p"] = x
        if "v" in self.mode:
            inputs["v"] = normalize(view_dirs)
        if "n" in self.mode:
            inputs["n"] = normals
        if "f" in self.mode and self.W_feat_in > 0:
            inputs["f"] = geo_feat
        h = torch.cat([inputs[m] for m in "pvnf" if m in inputs], dim=-1)
        return self.out_act(self.mlp(h))
