"""YAML config system: nested attribute tree + dotted CLI overrides.

Counterpart of ``arcnerf_tpu/utils/cfgs.py``: a YAML file (with a
top-level ``__parent__`` include) becomes a nested attribute object, and
``--a.b.c value`` command-line overrides are mapped to python types. The
port reads the same files under ``configs/``.
"""

import argparse
import copy
import os

import yaml


class Obj:
    """Nested attribute view over a dict (cfgs node)."""

    def __init__(self, d=None):
        if d:
            for k, v in d.items():
                setattr(self, str(k), Obj(v) if isinstance(v, dict) else v)

    def __contains__(self, key):
        return key in self.__dict__

    def __getitem__(self, key):
        return self.__dict__[key]

    def __setitem__(self, key, value):
        self.__dict__[key] = value

    def __iter__(self):
        return iter(self.__dict__)

    def __repr__(self):
        return "Obj(" + repr(obj_to_dict(self)) + ")"

    def __eq__(self, other):
        if isinstance(other, Obj):
            return obj_to_dict(self) == obj_to_dict(other)
        return NotImplemented

    def keys(self):
        return self.__dict__.keys()

    def items(self):
        return self.__dict__.items()

    def get(self, key, default=None):
        return self.__dict__.get(key, default)


def dict_to_obj(d):
    return Obj(d)


def obj_to_dict(obj):
    if not isinstance(obj, Obj):
        return obj
    return {k: obj_to_dict(v) for k, v in obj.__dict__.items()}


def remap_value(s):
    """Map a CLI string to bool/int/float/None/list/str (reference
    cfgs_utils.py:52-99 behavior)."""
    if not isinstance(s, str):
        return s
    text = s.strip()
    low = text.lower()
    if low in ("true", "false"):
        return low == "true"
    if low in ("none", "null"):
        return None
    if "," in text or (text.startswith("[") and text.endswith("]")):
        inner = text[1:-1] if text.startswith("[") else text
        return [remap_value(t) for t in inner.split(",") if t.strip() != ""]
    try:
        return int(text)
    except ValueError:
        pass
    try:
        return float(text)
    except ValueError:
        pass
    return text


def load_configs(path):
    """Load a yaml file into an Obj tree. Supports a top-level
    ``__parent__: other.yaml`` include (resolved relative to ``path``)."""
    with open(path, "r") as f:
        d = yaml.safe_load(f) or {}
    parent = d.pop("__parent__", None)
    if parent:
        parent_path = parent if os.path.isabs(parent) else os.path.join(os.path.dirname(path), parent)
        base = obj_to_dict(load_configs(parent_path))
        d = _deep_update(base, d)
    return dict_to_obj(d)


def _deep_update(base, new):
    out = copy.deepcopy(base)
    for k, v in new.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = _deep_update(out[k], v)
        else:
            out[k] = v
    return out


def update_configs_by_dotlist(cfgs, dotlist):
    """Apply ``["a.b.c", "value", ...]`` pairs onto the tree in place."""
    assert len(dotlist) % 2 == 0, "expect --key value pairs, got {}".format(dotlist)
    for key, value in zip(dotlist[0::2], dotlist[1::2]):
        key = key.lstrip("-")
        node = cfgs
        parts = key.split(".")
        for p in parts[:-1]:
            if not hasattr(node, p) or not isinstance(getattr(node, p), Obj):
                setattr(node, p, Obj())
            node = getattr(node, p)
        setattr(node, parts[-1], remap_value(value))
    return cfgs


def parse_configs(argv=None, default_cfg_path=None):
    """``--configs path.yaml`` plus arbitrary dotted overrides."""
    parser = argparse.ArgumentParser(add_help=False)
    parser.add_argument("--configs", type=str, default=default_cfg_path)
    known, unknown = parser.parse_known_args(argv)
    cfgs = load_configs(known.configs) if known.configs else Obj()
    return update_configs_by_dotlist(cfgs, unknown)


def valid_key_in_cfgs(cfgs, key):
    """True iff ``cfgs.key`` exists and is not None (reference
    cfgs_utils.py:170). Looks in __dict__ only, so Obj method names
    (keys/items/get) can be used as config fields too."""
    if cfgs is None:
        return False
    if isinstance(cfgs, Obj):
        return cfgs.__dict__.get(key) is not None
    if isinstance(cfgs, dict):
        return cfgs.get(key) is not None
    return getattr(cfgs, key, None) is not None


def get_value_from_cfgs_field(cfgs, key, default=None):
    """``cfgs.key`` or default (reference cfgs_utils.py:177)."""
    if cfgs is None:
        return default
    if isinstance(cfgs, Obj):
        val = cfgs.__dict__.get(key)
    elif isinstance(cfgs, dict):
        val = cfgs.get(key)
    else:
        val = getattr(cfgs, key, None)
    return default if val is None else val


def dump_configs(cfgs, path):
    """Write the config tree as YAML (the run's record of its settings)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(obj_to_dict(cfgs), f, sort_keys=False)
