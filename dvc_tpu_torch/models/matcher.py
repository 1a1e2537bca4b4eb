"""Hungarian set matcher (port of ``dvc_tpu/models/matcher.py``).

The focal-class + L1 + gIoU cost matrix is built on the device exactly as
the reference (``pdvc/matcher.py:84-100``), and the assignment is solved on
the same device by ``ops/assignment.py`` (on the card its hand-written
kernel; JAX's Jonker-Volgenant solver in place of the reference's scipy
call, ``matcher.py:115-119``).  Gt events are padded to G slots with a
validity mask; padded rows get constant cost and distinct columns, which
callers mask out (``matched_mask``).  Every decoder layer is matched in one
call, as the JAX criterion's vmapped matcher: one kernel launch a step and
no copy to the host.  Matching is not differentiated.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.assignment import (assignment, many_to_one_assignment,
                              masked_assignment)
from ..utils.box_ops import box_cl_to_xy, generalized_box_iou

__all__ = ['MatcherConfig', 'hungarian_match', 'hungarian_match_m2o',
           'masked_assignment', 'match_cost_matrix', 'matched_mask',
           'stacked_cost_matrices']


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


@torch.no_grad()
def hungarian_match(cfg: MatcherConfig, pred_logits, pred_boxes, gt_labels,
                    gt_boxes, gt_mask):
    """Match gt events to queries in every given decoder layer in one
    solve on the predictions' device.  pred_logits (D', B, Nq, K) and
    pred_boxes (D', B, Nq, 2) stack the layers; gt_* are (B, G, ...).  Each
    layer's (B, Nq, G) cost matrix is computed as a single layer's would be
    (so bit for bit the same), and the D' x B problems of G slots x Nq
    queries go to :func:`ops.assignment.assignment` together (one kernel
    launch on the card).  Returns col4row (D', B, G) int64 on the
    predictions' device: the query assigned to each gt slot (meaningless
    where ``gt_mask`` is False; -1 for a gt event left unmatched where a
    video has more gt events than queries, see :func:`matched_mask`)."""
    costs = stacked_cost_matrices(cfg, pred_logits, pred_boxes, gt_labels,
                                  gt_boxes)
    return assignment(costs.transpose(2, 3).float(), gt_mask)


# device-to-host copies made: none since the solver runs on the device;
# read and reset like the kernels' launch counts, so a run can show it
hungarian_match.copies = 0


@torch.no_grad()
def hungarian_match_m2o(cfg: MatcherConfig, pred_logits, pred_boxes,
                        gt_labels, gt_boxes, gt_mask, rate: int = 4):
    """Many-to-one match of one decoder layer (the reference's
    ``rl_indices``, matcher.py:120-123; JAX's ``hungarian_match_m2o``):
    each gt event gets up to ``rate`` distinct queries from the assignment
    on the gt-tiled cost matrix.  pred_logits (B, Nq, K), pred_boxes (B,
    Nq, 2); returns col4row (B, rate, G) int64.  Only the reference's
    vestigial ``caption_cost_type='rl'`` path would consume it, so nothing
    on the train path calls it."""
    cost = match_cost_matrix(cfg, pred_logits, pred_boxes, gt_labels,
                             gt_boxes)
    return many_to_one_assignment(cost.transpose(1, 2).float(), gt_mask,
                                  rate)


def matched_mask(col4row, gt_mask):
    """The gt slots with a matched query, (B, G) bool: the real ones,
    less those left unmatched where a video has more gt events than
    queries (col4row -1); with G <= Nq, ``gt_mask`` itself."""
    return gt_mask & (col4row >= 0)
