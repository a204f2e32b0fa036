"""Vector helpers (counterpart of ``arcnerf_tpu/geometry/transformation.py``)."""

import torch


def normalize(vec, eps=1e-8):
    """Normalize last dim. (..., 3) -> (..., 3)."""
    return vec / (torch.linalg.vector_norm(vec, dim=-1, keepdim=True) + eps)
