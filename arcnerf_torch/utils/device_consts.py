"""Constants made on a device once and kept.

A training step captured as a CUDA graph may not copy from pageable host
memory: the copy is refused while a stream captures, and a captured one
would replay from a host buffer long freed. The few host-side constants
that the step reads (the volume's range and voxel size, a fixed background
colour, a sphere's radius and centre) are made here on first use, one
tensor for each value, dtype and device, and reused after that. The first
step at a batch bucket runs eagerly before its capture, so every constant
the step reads exists before the capture starts. Callers only read them.
"""

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _constant(values, dtype, device):
    return torch.tensor(values, dtype=dtype, device=device)


def _frozen(values):
    """numpy arrays, lists and scalars -> nested tuples of Python numbers
    (exact for float32 values)."""
    values = np.asarray(values).tolist()
    if isinstance(values, list):
        return tuple(_frozen(v) for v in values)
    return values


def device_constant(values, dtype=torch.float32, device=None):
    """The tensor of ``values`` (a number, a nested sequence or a numpy
    array) as ``dtype`` on ``device`` (the CPU by default), made once."""
    return _constant(_frozen(values), dtype, torch.device("cpu" if device is None else device))
