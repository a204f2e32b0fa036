"""Convert an arcnerf_tpu (JAX) checkpoint into an arcnerf_torch checkpoint.

Runs where JAX is installed: it reads the JAX checkpoint with
``arcnerf_tpu.utils.model_io.load_raw_state``, maps its params and bound
state onto the port's names (``arcnerf_torch.utils.model_io.state_from_jax``)
and writes a port checkpoint that ``python -m arcnerf_torch.evaluate`` serves.

Usage:
    python scripts/export_jax_ckpt_to_torch.py --configs <cfg.yaml> --model_pt <jax ckpt or dir> \
        --out <port.pt> [--dotted.overrides ...]

The config (with its overrides) must be the one the model was trained
with: it resolves the hash variant recorded in the checkpoint's meta.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    from arcnerf_tpu.models.base_modules.encoding import hash_variant_from_cfgs
    from arcnerf_tpu.utils.cfgs import get_value_from_cfgs_field, parse_configs
    from arcnerf_tpu.utils.model_io import load_raw_state
    from arcnerf_torch.utils.model_io import save_model, state_from_jax

    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--out", required=True)
    known, rest = parser.parse_known_args(sys.argv[1:] if argv is None else argv)
    cfgs = parse_configs(rest)
    model_pt = get_value_from_cfgs_field(cfgs, "model_pt", None)
    if model_pt is None or not os.path.exists(str(model_pt)):
        raise FileNotFoundError("model_pt {} does not exist".format(model_pt))

    hv = hash_variant_from_cfgs(cfgs.model)
    raw, step = load_raw_state(str(model_pt), expected_meta={"hash_variant": hv} if hv else None)
    state_dict, bound_state = state_from_jax(raw["params"], raw.get("bound_state") or {})
    save_model(known.out, state_dict, bound_state, meta={"hash_variant": hv} if hv else {}, step=step)
    print("wrote {} ({} tensors, step {}) from {}".format(known.out, len(state_dict), step, model_pt))


if __name__ == "__main__":
    main()
