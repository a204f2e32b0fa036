"""Model factory (counterpart of ``arcnerf_tpu/models/__init__.py``)."""

from ..utils.cfgs import valid_key_in_cfgs
from ..utils.registry import MODEL_REGISTRY


def build_model(cfgs, logger=None, generator=None):
    """Build the fg model (cfgs.model.type) into a FullModel; its weights
    are drawn from ``generator``. Background models are not ported yet."""
    from .full_model import FullModel

    if valid_key_in_cfgs(cfgs.model, "background") and valid_key_in_cfgs(cfgs.model.background, "type"):
        raise NotImplementedError("background models are not ported yet (ROADMAP Queue 1, item 4)")
    fg_model = MODEL_REGISTRY.get(cfgs.model.type)(cfgs, generator=generator)
    if logger is not None:
        logger.add_log("Built model {} (bkg: None)".format(cfgs.model.type))
    return FullModel(cfgs, fg_model)


from . import nerf_model, neus_model, volsdf_model  # noqa: F401, E402
