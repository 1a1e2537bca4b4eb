"""1-D temporal box utilities (port of ``dvc_tpu/utils/box_ops.py``)."""

from __future__ import annotations

import torch


def box_cl_to_xy(x):
    """(center, length) -> (start, end)."""
    c, l = x[..., 0], x[..., 1]
    return torch.stack([c - 0.5 * l, c + 0.5 * l], dim=-1)


def inverse_sigmoid(x, eps: float = 1e-5):
    """Numerically clamped logit, same eps and clamps as the JAX version."""
    x = x.clamp(0, 1)
    x1 = x.clamp(min=eps)
    x2 = (1 - x).clamp(min=eps)
    return torch.log(x1 / x2)
