"""Checkpoints of the port, and the bridge from the JAX package's weights.

A port checkpoint is one ``torch.save`` of
``{"step", "state_dict", "bound_state", "meta"}``: the FullModel's state
dict, its occupancy state (``{"fg": {"bitfield", "opafield"}}``) and
compatibility markers (``meta.hash_variant``, checked at load as the JAX
package checks it). ``state_from_jax`` maps a JAX ``FullModel`` param tree
and bound state (nested dicts of numpy arrays) onto the port's names.
"""

import os

import numpy as np
import torch

# flax module-scope names -> the port's submodule names
_JAX_SCOPES = {"HashGridEmbedder_0": "encoder", "_FusedMLP_0": "mlp"}


def check_ckpt_meta(meta, expected_meta, path=""):
    """Raise if a loaded checkpoint's ``meta`` disagrees with
    ``expected_meta`` on a key both set (e.g. the hash variant: a table
    trained under one hash decodes as noise under another)."""
    if not meta or not expected_meta:
        return
    for k, want in expected_meta.items():
        got = meta.get(k)
        if got is not None and want is not None and got != want:
            raise ValueError("checkpoint {} was saved with {}={!r} but the current model resolves {}={!r}".format(
                path, k, got, k, want))


def save_model(path, state_dict, bound_state, meta=None, step=0):
    """Write a port checkpoint (tensors moved to the CPU)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    record = {
        "step": int(step),
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "bound_state": {name: {k: v.detach().cpu() for k, v in sub.items()} for name, sub in bound_state.items()},
        "meta": dict(meta or {}),
    }
    torch.save(record, path)


def load_model(path, expected_meta=None, device=None):
    """Read a port checkpoint -> (state_dict, bound_state, step), tensors on
    ``device``. ``expected_meta`` hard-fails on a marker mismatch."""
    record = torch.load(path, map_location=device, weights_only=True)
    check_ckpt_meta(record.get("meta"), expected_meta, path)
    return record["state_dict"], record["bound_state"], record["step"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def state_from_jax(params_np, bound_state_np):
    """JAX FullModel params (the ``params`` collection) and bound state, as
    nested dicts of numpy arrays -> (port state dict, port bound state).

    Dense kernels are stored ``(in, out)`` in both packages, and the hash
    table ``(L, T, F)``, so values carry over unchanged; only the names
    change (``HashGridEmbedder_0`` -> ``encoder``, ``_FusedMLP_0`` -> ``mlp``,
    a ``kernel`` leaf folds into its layer)."""
    state = {}
    for path, value in _flatten(params_np):
        names = [_JAX_SCOPES.get(p, p) for p in path]
        if names[-1] == "kernel":
            names = names[:-1]
        state[".".join(names)] = torch.from_numpy(np.array(value, dtype=np.float32))
    bound = {}
    for path, value in _flatten(bound_state_np):
        arr = np.array(value)
        sub = bound.setdefault(path[0], {})
        sub[".".join(path[1:])] = torch.from_numpy(arr)
    return state, bound
