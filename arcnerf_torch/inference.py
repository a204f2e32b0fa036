"""Inference entry of the port (counterpart of the repo's ``inference.py``).

Usage:
    python -m arcnerf_torch.inference --configs <cfg.yaml> --model_pt <port checkpoint> [--device cuda:0]
        [--inference.render.type circle --inference.render.n_cam 20 ...] [--dotted.overrides ...]
        [--trace <trace.json>]

Renders a novel-view video for each camera path of ``inference.render``
(circle, spiral, swing, regular, random or a custom json path) on
``device`` (default ``cuda:0``; ``--device cpu`` runs the kernels' plain
versions), with the eval split's intrinsic and size, and writes them
under ``dir.eval_dir`` (default ``results/<name>``): mp4 through OpenCV,
else numbered PNG frames. The checkpoint is one written by
``utils.model_io.save_model`` (the trainer's, or
``scripts/export_jax_ckpt_to_torch.py``'s from a JAX checkpoint).
Point-cloud and mesh extraction (``inference.volume``) and the
surface-render video are not ported and raise NotImplementedError.
``--trace <path>`` records the renders' spans and counters
(``utils.profiler``) and writes them to ``path`` as a Chrome trace on the
clock of ``torch.profiler``'s events.
"""

import argparse
import os
import sys

import torch

from .datasets import get_dataset
from .evaluate import load_for_eval
from .evaluation.infer_func import Inferencer
from .render.engine import RenderEngine
from .utils import profiler
from .utils.cfgs import get_value_from_cfgs_field, parse_configs, valid_key_in_cfgs
from .utils.logger import Logger


def main(argv=None):
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--trace", default=None, help="write the renders' spans and counters here (Chrome trace)")
    known, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfgs = parse_configs(rest)
    device = torch.device(get_value_from_cfgs_field(cfgs, "device", "cuda:0"))
    out_dir = get_value_from_cfgs_field(cfgs.dir, "eval_dir", None) if hasattr(cfgs, "dir") else None
    out_dir = out_dir or os.path.join("results", get_value_from_cfgs_field(cfgs, "name", "infer"))
    os.makedirs(out_dir, exist_ok=True)
    logger = Logger(os.path.join(out_dir, "infer.log"))
    if not valid_key_in_cfgs(cfgs, "inference"):
        raise ValueError("cfgs.inference missing: nothing to infer")

    # the render cameras take the intrinsic and size of the first split that loads
    data_dir = get_value_from_cfgs_field(cfgs.dir, "data_dir", "data") if hasattr(cfgs, "dir") else "data"
    dataset = None
    for mode in ("eval", "val", "train"):
        if valid_key_in_cfgs(cfgs.dataset, mode):
            try:
                dataset = get_dataset(cfgs.dataset, data_dir, mode, None, logger)
                break
            except (KeyError, NotImplementedError, OSError) as err:
                logger.add_log("dataset split {} does not load: {}".format(mode, err))
    if dataset is None:
        raise ValueError("need at least one loadable dataset split for the camera intrinsic")
    inferencer = Inferencer(cfgs.inference, dataset.get_intrinsic(), (dataset.W, dataset.H), logger)

    model, bound_state = load_for_eval(cfgs, device, logger)
    engine = RenderEngine(model, cfgs, bound_state, device)
    if known.trace:
        profiler.enable()
    try:
        results = inferencer.run_infer(engine, out_dir)
    finally:
        if known.trace:
            profiler.disable()
            profiler.write_chrome_trace(profiler.collect(), known.trace)
            logger.add_log("wrote the spans and counters to {}".format(known.trace))
    print("Inference done:", results)
    return results


if __name__ == "__main__":
    main()
