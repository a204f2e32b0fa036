"""Base modules: encoders, geo/radiance nets, object bounds.

Counterpart of ``arcnerf_tpu/models/base_modules/__init__.py``
(build_encoder, build_geo_model, build_radiance_model). Config subtrees
are plain dicts or ``Obj`` trees; keys a module does not declare are
dropped, as the JAX factories drop them.
"""

import inspect

from ...utils.cfgs import Obj, obj_to_dict
from ...utils.registry import ENCODER_REGISTRY, GEO_MODEL_REGISTRY, RADIANCE_MODEL_REGISTRY
from .encoding import HashGridEmbedder, SHEmbedder  # noqa: F401
from .networks import FusedMLPGeoNet, FusedMLPRadianceNet, GeoNet  # noqa: F401


def to_plain_dict(cfgs):
    return obj_to_dict(cfgs) if isinstance(cfgs, Obj) else dict(cfgs)


def _build(registry, cfgs, default_type, generator):
    kwargs = to_plain_dict(cfgs)
    cls = registry.get(kwargs.pop("type", default_type))
    params = inspect.signature(cls.__init__).parameters
    if "generator" in params:
        kwargs["generator"] = generator
    return cls(**{k: v for k, v in kwargs.items() if k in params})


def build_encoder(cfgs, generator=None):
    """Encoder factory (SHEmbedder, HashGridEmbedder so far)."""
    if cfgs is None:
        raise NotImplementedError("the default FreqEmbedder is not ported yet (ROADMAP Queue 1, item 4)")
    return _build(ENCODER_REGISTRY, cfgs, "FreqEmbedder", generator)


def build_geo_model(cfgs, generator=None):
    """Geometry net factory: GeoNet (the default) and FusedMLPGeoNet."""
    return _build(GEO_MODEL_REGISTRY, cfgs, "GeoNet", generator)


def build_radiance_model(cfgs, generator=None):
    """Radiance net factory. Only the fused net is ported."""
    return _build(RADIANCE_MODEL_REGISTRY, cfgs, "RadianceNet", generator)
