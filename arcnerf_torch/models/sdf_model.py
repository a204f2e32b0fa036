"""SDF model base: surface normals by autograd through the geometry chain,
and sampling into an SDF's sections on the fused sampler's stream.

Counterpart of ``arcnerf_tpu/models/sdf_model.py`` (``geo_with_grad``,
``SdfModel``). The normal is ``torch.autograd.grad`` of the sdf with
respect to the points, with ``create_graph`` in training so that the
eikonal loss and the radiance net differentiate it again; through the hash
grid it reaches kernel K, and its backward kernel L (``encoding``). The
model samples through the fused sampler in its sections mode
(``sample_compact``: the JAX ``Neus.handle_mid_pts`` on left-compacted
rows, written as a stream); the (rays, samples) grid path of the JAX SDF
models (left-compacted masks, ``compact_point_eval``'s repeat-last fill)
is not ported. Surface rendering (sphere tracing) is not ported either.
"""

import torch

from ..utils import profiler
from .base_modules import encoding
from .fg_model import FgModel


def geo_with_grad(geo_net, pts, create_graph=False):
    """(sdf (B, 1), feature (B, W_feat), normal (B, 3)) at (B, 3) points:
    the normal is d sdf / d pts by autograd, itself differentiable with
    ``create_graph``. Runs under any grad mode, inference mode included
    (the points are copied out of it); without ``create_graph`` the
    results carry no graph."""
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

    def get_est_opacity(self, dt, pts):
        raise NotImplementedError("implement in the concrete sdf model")
