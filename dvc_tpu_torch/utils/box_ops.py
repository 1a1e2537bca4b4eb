"""1-D temporal box utilities (port of ``dvc_tpu/utils/box_ops.py``): boxes
live on a normalized [0, 1] timeline as (center, length) or (start, end)."""

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


def box_length(boxes):
    return boxes[..., 1] - boxes[..., 0]


def box_iou(boxes1, boxes2):
    """Pairwise IoU of (start, end) boxes: (..., N, 2) x (..., M, 2) ->
    (..., N, M), and the union (reference ``box_ops.py:8-26``, eps 1e-5)."""
    area1 = box_length(boxes1)
    area2 = box_length(boxes2)
    lt = torch.maximum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    rb = torch.minimum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    inter = (rb - lt).clamp(min=0)
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / (union + 1e-5), union


def generalized_box_iou(boxes1, boxes2):
    """1-D gIoU (reference ``box_ops.py:34-48``): IoU - (hull - union) /
    hull, eps 1e-5."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, 0], boxes2[..., None, :, 0])
    rb = torch.maximum(boxes1[..., :, None, 1], boxes2[..., None, :, 1])
    hull = (rb - lt).clamp(min=0)
    return iou - (hull - union) / (hull + 1e-5)
