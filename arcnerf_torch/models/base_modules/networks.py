"""Geometry and radiance nets: the plain f32 ``GeoNet`` of the SDF models
and the fused bf16 MLP nets (instant-ngp style).

Counterpart of ``GeoNet``, ``_FusedMLP``, ``FusedMLPGeoNet`` and
``FusedMLPRadianceNet`` in ``arcnerf_tpu/models/base_modules/networks.py``.
The fused nets' weights are bias-free ``(in, out)`` parameters named
``fc_0 ... fc_{D-1}, fc_out``; their chain runs through ``ops.fused_mlp``
(kernel A on the card). ``GeoNet`` runs plain PyTorch in f32, so that an
SDF can differentiate it twice (its normal, then the eikonal loss).

GeoNet(x), FusedMLPGeoNet(x) -> (geo (B, 1), feat (B, W_feat) | None)
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
# flax's WeightNorm: v * rsqrt(sum(v^2) + eps) * scale, per output column
_WN_EPS = 1e-12


@GEO_MODEL_REGISTRY.register()
class GeoNet(nn.Module):
    """Encoder + plain f32 MLP: xyz -> (sdf or sigma (B, 1), feature).

    Mirrors the JAX ``GeoNet``: skip connections (concat [h, embed], with
    ``skip_reduce_output`` / ``norm_skip``), the geometric init (first
    layer normal on the first ``input_ch`` inputs and zero on the rest,
    hidden layers normal with std sqrt(2 / W), the last layer
    sqrt(pi / W_in) + N(0, 1e-4) and bias -radius_init on the sdf) and
    flax's weight norm (kernel ``fc_i`` (in, out) times a per-column
    ``wn_i`` that starts at 1, over the column's norm). With the hash grid
    and ``include_input: false``, as in the NeuS-NGP recipe, the first
    ``input_ch`` inputs are the coarsest level's features, as in the JAX
    net. SIREN layers are not ported."""

    def __init__(self, W=256, D=8, skips=(4,), encoder=None, input_ch=3, W_feat=256, use_bias=True,
                 skip_reduce_output=False, norm_skip=False, act_cfg=None, geometric_init=False, radius_init=1.0,
                 use_siren=False, weight_norm=False, out_act_cfg=None, generator=None):
        super().__init__()
        from . import build_encoder

        if use_siren:
            raise NotImplementedError("SIREN layers (use_siren) are not ported yet (ROADMAP Queue 1, item 4)")
        self.encoder = build_encoder(encoder, generator)
        self.D, self.W_feat, self.skips = D, W_feat, list(skips or [])
        self.norm_skip, self.weight_norm, self.use_bias = norm_skip, weight_norm, use_bias
        self.act = get_activation(act_cfg)
        self.out_act = get_activation(out_act_cfg) if out_act_cfg is not None else None
        embed_dim = self.encoder.out_dim
        has_embed_tail = embed_dim > input_ch
        dim = embed_dim
        for i in range(D + 1):
            last = i == D
            if last:
                out_dim = 1 + W_feat if W_feat > 0 else 1
            elif skip_reduce_output and i in self.skips:
                out_dim = W - embed_dim
            else:
                out_dim = W
            w, b = self._init(i, dim, out_dim, last, geometric_init, has_embed_tail, input_ch, embed_dim,
                              radius_init, generator)
            setattr(self, "fc_{}".format(i), nn.Parameter(w))
            if use_bias:
                setattr(self, "fc_{}_bias".format(i), nn.Parameter(b))
            if weight_norm:
                setattr(self, "wn_{}".format(i), nn.Parameter(torch.ones(out_dim)))
            dim = out_dim + (embed_dim if i in self.skips and not last else 0)

    def _init(self, i, in_dim, out_dim, last, geometric, has_embed_tail, input_ch, embed_dim, radius_init, gen):
        w = torch.empty(in_dim, out_dim)
        b = torch.zeros(out_dim)
        if not geometric:
            std = math.sqrt(1.0 / in_dim) / _TRUNC_STD
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=gen)
            return w, b
        if last:
            w.normal_(0.0, 1e-4, generator=gen).add_(math.sqrt(math.pi) / math.sqrt(in_dim))
            b[0] = -radius_init
            return w, b
        w.normal_(0.0, math.sqrt(2.0) / math.sqrt(out_dim), generator=gen)
        rows = torch.arange(in_dim)[:, None]
        if i == 0 and has_embed_tail:
            w = torch.where(rows < input_ch, w, 0.0)
        elif i > 0 and (i - 1) in self.skips and has_embed_tail:
            w = torch.where(rows >= in_dim - (embed_dim - input_ch), 0.0, w)
        return w, b

    def layer_weight(self, i):
        """Layer i's effective (in, out) kernel."""
        w = getattr(self, "fc_{}".format(i))
        if self.weight_norm:
            w = w * torch.rsqrt((w * w).sum(0, keepdim=True) + _WN_EPS) * getattr(self, "wn_{}".format(i))
        return w

    def forward(self, x):
        x_embed = self.encoder(x)
        h = x_embed
        for i in range(self.D + 1):
            h = h @ self.layer_weight(i)
            if self.use_bias:
                h = h + getattr(self, "fc_{}_bias".format(i))
            if i < self.D:
                h = self.act(h)
                if i in self.skips:
                    h = torch.cat([h, x_embed], dim=-1)
                    if self.norm_skip:
                        h = h / math.sqrt(2.0)
        geo, feat = (h[:, :1], h[:, 1:]) if self.W_feat > 0 else (h, None)
        if self.out_act is not None:
            geo = self.out_act(geo)
        return geo, feat


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
