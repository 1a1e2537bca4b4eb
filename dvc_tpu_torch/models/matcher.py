"""Hungarian set matcher (port of ``dvc_tpu/models/matcher.py`` and
``dvc_tpu/ops/assignment.py::masked_assignment``).

The focal-class + L1 + gIoU cost matrix is built on the device exactly as
the reference (``pdvc/matcher.py:84-100``); the assignment is solved on the
host with scipy's ``linear_sum_assignment``, the reference PDVC's own
choice (``matcher.py:115-119``).  Gt events are padded to G slots with a
validity mask: the real rows get their optimal queries, and each padded row
gets a distinct unused query, which callers mask out (the contract of the
JAX ``masked_assignment``).  Every decoder layer is matched in one call, as
the JAX criterion's vmapped matcher: one copy to the host and one upload a
step.  Matching is not differentiated.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from ..utils.box_ops import box_cl_to_xy, generalized_box_iou


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    cost_class: float = 1.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    cost_alpha: float = 0.25
    cost_gamma: float = 2.0

    @classmethod
    def from_opt(cls, opt):
        return cls(cost_class=opt.set_cost_class, cost_bbox=opt.set_cost_bbox,
                   cost_giou=opt.set_cost_giou, cost_alpha=opt.cost_alpha,
                   cost_gamma=opt.cost_gamma)


def match_cost_matrix(cfg: MatcherConfig, pred_logits, pred_boxes, gt_labels,
                      gt_boxes):
    """Per-video cost matrix (B, Nq, G)."""
    alpha, gamma = cfg.cost_alpha, cfg.cost_gamma
    prob = torch.sigmoid(pred_logits)                       # (B, Nq, K)
    neg = (1 - alpha) * (prob ** gamma) * (-torch.log(1 - prob + 1e-8))
    pos = alpha * ((1 - prob) ** gamma) * (-torch.log(prob + 1e-8))
    lab = gt_labels.long()[:, None, :].expand(-1, prob.shape[1], -1)
    cost_class = torch.gather(pos, 2, lab) - torch.gather(neg, 2, lab)
    cost_bbox = (pred_boxes[:, :, None, :]
                 - gt_boxes[:, None, :, :]).abs().sum(-1)   # L1 cdist
    cost_giou = -generalized_box_iou(box_cl_to_xy(pred_boxes),
                                     box_cl_to_xy(gt_boxes))
    return (cfg.cost_bbox * cost_bbox + cfg.cost_class * cost_class
            + cfg.cost_giou * cost_giou)


def stacked_cost_matrices(cfg: MatcherConfig, pred_logits, pred_boxes,
                          gt_labels, gt_boxes):
    """Every layer's :func:`match_cost_matrix`, stacked (D', B, Nq, G):
    each computed from its own layer's tensors, as a single layer's call
    computes it, so bit for bit the same on any device."""
    return torch.stack([match_cost_matrix(cfg, logits, boxes, gt_labels,
                                          gt_boxes)
                        for logits, boxes in zip(pred_logits, pred_boxes)])


def masked_assignment(cost: np.ndarray, row_mask: np.ndarray) -> np.ndarray:
    """cost (R, C), row_mask (R,): col4row (R,) int64, optimal over the
    real rows; padded rows get distinct unused columns in order while
    there are any.  With more real rows than columns (more gt events than
    queries) C of them are matched, as the reference's scipy solve on the
    (Nq, n_gt) matrix matches them, and the rest keep -1, as do padded
    rows left without a free column (the JAX solver refuses R > C; where
    R <= C the two agree)."""
    R, C = cost.shape
    cost = np.nan_to_num(cost, nan=1e9, posinf=1e9, neginf=-1e9)
    rows = np.flatnonzero(row_mask)
    col4row = np.full(R, -1, np.int64)
    if len(rows):
        r, c = linear_sum_assignment(cost[rows])
        col4row[rows[r]] = c
    free = np.setdiff1d(np.arange(C), col4row[rows])
    pad = np.flatnonzero(~row_mask)[:len(free)]
    col4row[pad] = free[:len(pad)]
    return col4row


@torch.no_grad()
def hungarian_match(cfg: MatcherConfig, pred_logits, pred_boxes, gt_labels,
                    gt_boxes, gt_mask):
    """Match gt events to queries in every given decoder layer with one
    round trip to the host.  pred_logits (D', B, Nq, K) and pred_boxes
    (D', B, Nq, 2) stack the layers; gt_* are (B, G, ...).  Each layer's
    (B, Nq, G) cost matrix is computed as a single layer's would be (so
    bit for bit the same), the D' of them and the mask come to the host in
    one copy, scipy solves each (layer, video), and the indices go back in
    one upload.  Returns col4row (D', B, G) int64 on the predictions'
    device: the query assigned to each gt slot (meaningless where
    ``gt_mask`` is False; -1 for a gt event left unmatched, see
    :func:`matched_mask`)."""
    D, B, Nq, _ = pred_logits.shape
    G = gt_mask.shape[-1]
    costs = stacked_cost_matrices(cfg, pred_logits, pred_boxes, gt_labels,
                                  gt_boxes)
    packed = torch.cat([costs.transpose(2, 3).float().reshape(-1),
                        gt_mask.float().reshape(-1)]).cpu().numpy()
    hungarian_match.copies += 1
    C = packed[:D * B * G * Nq].reshape(D, B, G, Nq)
    mask = packed[D * B * G * Nq:].reshape(B, G) > 0
    idx = np.stack([[masked_assignment(C[l, b], mask[b]) for b in range(B)]
                    for l in range(D)])
    return torch.from_numpy(idx).to(pred_logits.device)


# device-to-host copies made (one a call), read and reset like the kernels'
# launch counts
hungarian_match.copies = 0


def matched_mask(col4row, gt_mask):
    """The gt slots with a matched query, (B, G) bool: the real ones,
    less those left unmatched where a video has more gt events than
    queries (col4row -1); with G <= Nq, ``gt_mask`` itself."""
    return gt_mask & (col4row >= 0)
