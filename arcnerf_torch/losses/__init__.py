"""Loss factory and weighted-sum composition (counterpart of
``arcnerf_tpu/losses/__init__.py``: ``_error_fn``, ``_masked_mean``,
``ImgLoss``, ``AllLoss``, ``build_loss``).

A loss is ``loss(inputs, output) -> scalar tensor``; ``AllLoss`` sums the
configured ones with their weights and returns {names, sum, <name>: value}
as the JAX package does. Only the image loss is ported so far.
"""

import torch

from ..utils.cfgs import get_value_from_cfgs_field
from ..utils.registry import LOSS_REGISTRY


def _error_fn(loss_type, delta=1.0):
    lt = (loss_type or "MSE").lower()
    if lt == "mse":
        return lambda pred, gt: (pred - gt) ** 2
    if lt == "l1":
        return lambda pred, gt: (pred - gt).abs()
    if lt == "huber":
        def huber(pred, gt):
            err = (pred - gt).abs()
            return torch.where(err <= delta, 0.5 * err**2, delta * (err - 0.5 * delta))

        return huber
    if lt == "bce":
        def bce(pred, gt):
            pred = pred.clamp(1e-7, 1 - 1e-7)
            return -(gt * torch.log(pred) + (1 - gt) * torch.log(1 - pred))

        return bce
    raise NotImplementedError("loss type {} not supported".format(loss_type))


def _masked_mean(err, mask=None):
    """err (B, N, ...) averaged; with a mask (B, N), over the valid rays only."""
    if mask is None:
        return err.mean()
    while mask.ndim < err.ndim:
        mask = mask[..., None]
    denom = torch.clamp_min(mask.sum(), 1.0) * (err.numel() / mask.numel())
    return (err * mask).sum() / denom


@LOSS_REGISTRY.register()
class ImgLoss:
    """Photometric loss over the ``rgb*`` output keys (each configured key
    plain, ``_coarse`` and ``_fine``), with optional per-key weights and
    mask-mean."""

    def __init__(self, cfgs=None):
        self.loss_type = get_value_from_cfgs_field(cfgs, "loss_type", "MSE")
        self.use_mask = get_value_from_cfgs_field(cfgs, "use_mask", False)
        self.keys = get_value_from_cfgs_field(cfgs, "keys", ["rgb"])
        self.internal_weights = get_value_from_cfgs_field(cfgs, "internal_weights", None)
        self.fn = _error_fn(self.loss_type, float(get_value_from_cfgs_field(cfgs, "delta", 1.0)))

    def __call__(self, inputs, output):
        gt = inputs["img"]
        mask = inputs.get("mask") if self.use_mask else None
        total, count = 0.0, 0
        for i, base in enumerate(self.keys):
            w = self.internal_weights[i] if self.internal_weights else 1.0
            for suffix in ("", "_coarse", "_fine"):
                key = base + suffix
                if output.get(key) is not None:
                    total = total + w * _masked_mean(self.fn(output[key], gt), mask)
                    count += 1
        return total if count else torch.zeros((), device=gt.device)


class AllLoss:
    """Weighted sum of the configured losses: {names, sum, <name>: value}."""

    def __init__(self, cfgs):
        self.losses, self.weights = {}, {}
        loss_cfgs = cfgs.loss if hasattr(cfgs, "loss") else cfgs
        for name in loss_cfgs.keys():
            sub = getattr(loss_cfgs, name)
            loss_type = get_value_from_cfgs_field(sub, "type", name)
            if loss_type not in LOSS_REGISTRY:
                raise NotImplementedError("loss {} is not ported yet (ROADMAP Queue 1, item 4)".format(loss_type))
            self.losses[name] = LOSS_REGISTRY.get(loss_type)(sub)
            self.weights[name] = get_value_from_cfgs_field(sub, "weight", 1.0)

    def __call__(self, inputs, output):
        out = {"names": list(self.losses.keys())}
        total = 0.0
        for name, loss in self.losses.items():
            out[name] = loss(inputs, output)
            total = total + self.weights[name] * out[name]
        out["sum"] = total
        return out


def build_loss(cfgs, logger=None):
    allloss = AllLoss(cfgs)
    if logger is not None:
        logger.add_log("Built losses: {}".format(list(allloss.losses.keys())))
    return allloss
