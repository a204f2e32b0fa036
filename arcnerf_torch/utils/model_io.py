"""Checkpoints of the port, and the bridge from the JAX package's weights.

A port checkpoint is one ``torch.save`` of
``{"step", "state_dict", "bound_state", "meta"}``: the FullModel's state
dict, its occupancy state (``{"fg": {"bitfield", "opafield"}}``) and
compatibility markers (``meta.hash_variant``, checked at load as the JAX
package checks it). A training checkpoint adds ``"adam"`` (the Adam state
per parameter name) and ``"ema"`` when EMA is on. ``state_from_jax`` maps a
JAX ``FullModel`` param tree and bound state (nested dicts of numpy arrays)
onto the port's names; ``adam_state_from_jax`` maps the optax Adam state
(``count``, ``mu``, ``nu``) onto ``torch.optim.Adam``'s, so that a JAX
training state resumes in the port.
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


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def save_model(path, state_dict, bound_state, meta=None, step=0, adam=None, ema=None):
    """Write a port checkpoint (tensors moved to the CPU). ``adam``: the
    Adam state by parameter name ({name: {step, exp_avg, exp_avg_sq}});
    ``ema``: the EMA shadows by name."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    record = {
        "step": int(step),
        "state_dict": _to_cpu(dict(state_dict)),
        "bound_state": _to_cpu(dict(bound_state)),
        "meta": dict(meta or {}),
    }
    if adam is not None:
        record["adam"] = _to_cpu(adam)
    if ema is not None:
        record["ema"] = _to_cpu(ema)
    torch.save(record, path)


def load_record(path, expected_meta=None, device=None):
    """Read a whole port checkpoint dict, tensors on ``device``.
    ``expected_meta`` hard-fails on a marker mismatch."""
    record = torch.load(path, map_location=device, weights_only=True)
    check_ckpt_meta(record.get("meta"), expected_meta, path)
    return record


def load_model(path, expected_meta=None, device=None):
    """Read a port checkpoint -> (state_dict, bound_state, step), tensors on
    ``device``. ``expected_meta`` hard-fails on a marker mismatch."""
    record = load_record(path, expected_meta, device)
    return record["state_dict"], record["bound_state"], record["step"]


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _port_name(path):
    names = [_JAX_SCOPES.get(p, p) for p in path]
    if names[-1] == "kernel" or names[-1].endswith("/kernel/scale"):  # a weight norm's scale is its scope (wn_i)
        names = names[:-1]
    return ".".join(names)


def state_from_jax(params_np, bound_state_np):
    """JAX FullModel params (the ``params`` collection) and bound state, as
    nested dicts of numpy arrays -> (port state dict, port bound state).

    Dense kernels are stored ``(in, out)`` in both packages, and the hash
    table ``(L, T, F)``, so values carry over unchanged; only the names
    change (``HashGridEmbedder_0`` -> ``encoder``, ``_FusedMLP_0`` -> ``mlp``,
    a ``kernel`` leaf folds into its layer, and a weight norm's
    ``wn_i/fc_i/kernel/scale`` into ``wn_i``)."""
    state = {}
    for path, value in _flatten(params_np):
        state[_port_name(path)] = torch.from_numpy(np.array(value, dtype=np.float32))
    bound = {}
    for path, value in _flatten(bound_state_np):
        arr = np.array(value)
        sub = bound.setdefault(path[0], {})
        sub[".".join(path[1:])] = torch.from_numpy(arr)
    return state, bound


def adam_state_from_jax(count, mu_np, nu_np):
    """The optax Adam state - ``count`` (updates applied) and the ``mu`` /
    ``nu`` moment trees shaped like the params, as nested dicts of numpy
    arrays - -> the port's Adam state by parameter name:
    {name: {"step", "exp_avg", "exp_avg_sq"}}. The two optimizers keep the
    same moments and the same bias correction (1 - beta^count), so the
    values carry over unchanged."""
    nu = {_port_name(path): v for path, v in _flatten(nu_np)}
    out = {}
    for path, m in _flatten(mu_np):
        name = _port_name(path)
        out[name] = {"step": torch.tensor(float(count)),
                     "exp_avg": torch.from_numpy(np.array(m, dtype=np.float32)),
                     "exp_avg_sq": torch.from_numpy(np.array(nu[name], dtype=np.float32))}
    return out
