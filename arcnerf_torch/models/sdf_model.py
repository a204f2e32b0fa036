"""SDF model base: surface normals through the geometry chain, and sampling
into an SDF's sections on the fused sampler's stream.

Counterpart of ``arcnerf_tpu/models/sdf_model.py`` (``geo_with_grad``,
``SdfModel``). The normal is d sdf / d pts. A GeoNet of the NeuS-NGP
recipe's shape (``fuses_geo_chain``) takes the chain through
``ops.geo_chain`` (kernel M: sdf, feature and g = d sdf / d features; in
the loss's backward kernel N) and the hash grid's input gradient of g
(kernel K; in the backward kernel L). Every other GeoNet takes
``torch.autograd.grad`` of the sdf with respect to the points, with
``create_graph`` in training so that the eikonal loss and the radiance net
differentiate it again; through the hash grid it reaches kernels K and L
as well (``encoding``). The model samples through the fused sampler in its
sections mode (``sample_compact``: the JAX ``Neus.handle_mid_pts`` on
left-compacted rows, written as a stream); the (rays, samples) grid path of
the JAX SDF models (left-compacted masks, ``compact_point_eval``'s
repeat-last fill) is not ported. Surface rendering (sphere tracing) is not ported either.
"""

import torch

from ..ops import geo_chain
from ..utils import profiler
from .base_modules import encoding
from .base_modules.networks import GeoNet
from .fg_model import FgModel


def fuses_geo_chain(geo_net):
    """Whether ``geo_with_grad`` takes the geometry chain through kernels M
    and N: a ``GeoNet`` of the shape they are built for (the hash grid's
    32 features without the points, one hidden layer of 64, 17 outputs, no
    bias, no skip, softplus, no output activation)."""
    return (isinstance(geo_net, GeoNet) and geo_net.D == 1 and not geo_net.skips and not geo_net.use_bias
            and getattr(geo_net.act, "beta", None) is not None and geo_net.out_act is None
            and isinstance(geo_net.encoder, encoding.HashGridEmbedder) and not geo_net.encoder.include_input
            and tuple(geo_net.fc_0.shape) == (geo_chain.IN, geo_chain.HIDDEN)
            and tuple(geo_net.fc_1.shape) == (geo_chain.HIDDEN, geo_chain.OUT))


def geo_with_grad(geo_net, pts, create_graph=False, n_rows=None):
    """(sdf (B, 1), feature (B, W_feat), normal (B, 3)) at (B, 3) points:
    the normal is d sdf / d pts, itself differentiable with
    ``create_graph``. Runs under any grad mode, inference mode included;
    without ``create_graph`` the results carry no graph. ``n_rows``, a ()
    int64 tensor on the points' device, bounds the rows that matter (a
    compacted stream's kept rows) for the fused chain alone
    (``fuses_geo_chain``), which computes no row at or past it and gives
    such rows 0; the autograd path computes every row."""
    if fuses_geo_chain(geo_net):
        return _fused_with_grad(geo_net, pts, create_graph, n_rows)
    return _autograd_with_grad(geo_net, pts, create_graph)


def _fused_with_grad(geo_net, pts, create_graph, n_rows):
    """The chain as kernel M (N in the backward) and the hash grid's input
    gradient of its g as kernel K (L in the backward); the points take no
    gradient."""
    grad = torch.enable_grad() if create_graph else torch.no_grad()
    with profiler.span("model.normal"), grad:
        x = pts.detach()
        enc = geo_net.encoder(x)
        out, g = geo_chain.geo_chain(enc, geo_net.layer_weight(0), geo_net.layer_weight(1), geo_net.act.beta,
                                     n_rows)
        normal = geo_net.encoder.input_gradient(x, g)
    return out[:, :1], out[:, 1:], normal


def _autograd_with_grad(geo_net, pts, create_graph):
    """The normal by ``torch.autograd.grad`` of the sdf (the points are
    copied out of inference mode)."""
    with profiler.span("model.normal"), torch.inference_mode(False), torch.enable_grad(), encoding.input_grad():
        x = (pts.clone() if pts.is_inference() else pts).detach().requires_grad_(True)
        sdf, feat = geo_net(x)
        (normal,) = torch.autograd.grad(sdf, x, torch.ones_like(sdf), create_graph=create_graph)
    if not create_graph:
        sdf, normal = sdf.detach(), normal.detach()
        feat = feat.detach() if feat is not None else None
    return sdf, feat, normal


class SdfModel(FgModel):

    @staticmethod
    def sigma_reverse():
        return True

    def stream_sections(self):
        return True

    def count_normal_pts(self, n):
        """Tracing's counters of the rows whose normals a call takes (a
        device tensor or a number): ``sdf.normal_pts``, and ``sdf.geo_fused``
        where the geometry chain runs fused (``fuses_geo_chain``)."""
        if not profiler.active():
            return
        profiler.count("sdf.normal_pts", n)
        if fuses_geo_chain(self.get_net()[0]):
            profiler.count("sdf.geo_fused", n)

    def get_est_opacity(self, dt, pts):
        raise NotImplementedError("implement in the concrete sdf model")
