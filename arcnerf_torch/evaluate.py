"""Evaluation entry of the port (counterpart of the repo's ``evaluate.py``).

Usage:
    python -m arcnerf_torch.evaluate --configs <cfg.yaml> --model_pt <port checkpoint> [--device cuda:0]
        [--dotted.overrides ...]

Renders the eval split under ``torch.inference_mode()`` on ``device``
(default ``cuda:0``), reports PSNR/SSIM, and writes images and
eval_log.txt under ``dir.eval_dir`` (default ``results/<name>``). The
checkpoint is one written by ``utils.model_io.save_model``, e.g. by
``scripts/export_jax_ckpt_to_torch.py`` from a JAX checkpoint.
"""

import os
import sys

import torch

from .datasets import get_dataset
from .evaluation.eval_func import run_eval
from .models import build_model
from .models.base_modules.encoding import hash_variant_from_cfgs
from .render.engine import RenderEngine
from .utils.cfgs import get_value_from_cfgs_field, parse_configs
from .utils.logger import Logger
from .utils.model_io import load_model


def eval_bkg_color(cfgs):
    """Background to composite at eval: only when training fed one
    (dataset.train.scheduler.bkg_color); then the eval split's
    augmentation.blend_bkg_color, or white under white_bkg."""
    ds_cfgs = get_value_from_cfgs_field(cfgs.dataset, "eval", None)
    train_ds = get_value_from_cfgs_field(cfgs.dataset, "train", None)
    sched = get_value_from_cfgs_field(train_ds, "scheduler", None)
    trained_with_bkg = get_value_from_cfgs_field(
        get_value_from_cfgs_field(sched, "bkg_color", None), "color", None) is not None
    if not trained_with_bkg:
        return None
    blend = get_value_from_cfgs_field(get_value_from_cfgs_field(ds_cfgs, "augmentation", None), "blend_bkg_color", None)
    if blend is not None:
        return blend
    if get_value_from_cfgs_field(ds_cfgs, "white_bkg", False):
        return [1.0, 1.0, 1.0]
    return None


def load_for_eval(cfgs, device, logger=None):
    """Build the model from ``cfgs`` and restore ``cfgs.model_pt`` onto
    ``device`` -> (model, bound_state)."""
    model_pt = get_value_from_cfgs_field(cfgs, "model_pt", None)
    if model_pt is None or not os.path.exists(str(model_pt)):
        raise FileNotFoundError("model_pt {} does not exist: evaluation needs a checkpoint".format(model_pt))
    model = build_model(cfgs, logger)
    hv = hash_variant_from_cfgs(cfgs.model)
    state_dict, bound_state, step = load_model(str(model_pt), {"hash_variant": hv} if hv else None, device)
    model.load_state_dict(state_dict)
    model.to(device).eval()
    if not bound_state:
        bound_state = model.init_bound_state(device)
    if logger is not None:
        logger.add_log("restored checkpoint {} (step {})".format(model_pt, step))
    return model, bound_state


def main(argv=None):
    cfgs = parse_configs(sys.argv[1:] if argv is None else argv)
    device = torch.device(get_value_from_cfgs_field(cfgs, "device", "cuda:0"))
    eval_dir = get_value_from_cfgs_field(cfgs.dir, "eval_dir", None) if hasattr(cfgs, "dir") else None
    eval_dir = eval_dir or os.path.join("results", get_value_from_cfgs_field(cfgs, "name", "eval"))
    os.makedirs(eval_dir, exist_ok=True)
    logger = Logger(os.path.join(eval_dir, "eval_log_run.log"))

    data_dir = get_value_from_cfgs_field(cfgs.dir, "data_dir", "data") if hasattr(cfgs, "dir") else "data"
    dataset = get_dataset(cfgs.dataset, data_dir, "eval", None, logger)
    model, bound_state = load_for_eval(cfgs, device, logger)
    engine = RenderEngine(model, cfgs, bound_state, device)
    max_samples = get_value_from_cfgs_field(cfgs.progress, "max_samples_eval", 25) if hasattr(cfgs, "progress") else 25
    summary, results = run_eval(engine, dataset, logger, eval_dir, max_samples=max_samples,
                                bkg_color=eval_bkg_color(cfgs))
    print("Eval done:", summary)
    return summary, results


if __name__ == "__main__":
    main()
