"""Set-prediction criterion (port of ``dvc_tpu/models/criterion.py``,
reference ``pdvc/criterion.py``).

Losses per decoder layer: sigmoid focal classification (times Nq), the
Gaussian-masked event-count cross-entropy with a class-rate prior, L1 and
gIoU box losses on the matched pairs, plus the log-only self-IoU and
cardinality diagnostics.  Everything is masked over G padded gt slots;
matching comes from :func:`dvc_tpu_torch.models.matcher.hungarian_match`.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.box_ops import box_cl_to_xy, box_iou, generalized_box_iou
from .matcher import MatcherConfig, hungarian_match, matched_mask

# Empirical event-count prior (reference criterion.py:37-44, hard-coded).
COUNTER_CLASS_RATE = np.array([
    0.00000000e+00, 0.00000000e+00, 1.93425917e-01, 4.12129084e-01,
    1.88929963e-01, 7.81296833e-02, 5.09541413e-02, 3.12718553e-02,
    1.84833650e-02, 8.39244680e-03, 6.59406534e-03, 4.49595364e-03,
    2.19802178e-03, 1.79838146e-03, 5.99460486e-04, 4.99550405e-04,
    4.99550405e-04, 1.99820162e-04, 2.99730243e-04, 3.99640324e-04,
    2.99730243e-04, 0.00000000e+00, 1.99820162e-04, 0.00000000e+00,
    0.00000000e+00, 0.00000000e+00, 9.99100809e-05, 9.99100809e-05],
    dtype=np.float32)


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    lloss_gau_mask: int = 1
    lloss_beta: float = 1.0
    matcher: MatcherConfig = dataclasses.field(default_factory=MatcherConfig)

    @classmethod
    def from_opt(cls, opt):
        return cls(focal_alpha=opt.focal_alpha, focal_gamma=opt.focal_gamma,
                   lloss_gau_mask=opt.lloss_gau_mask,
                   lloss_beta=opt.lloss_beta,
                   matcher=MatcherConfig.from_opt(opt))


def _bce_with_logits(logits, targets):
    return (logits.clamp(min=0) - logits * targets
            + torch.log1p(torch.exp(-logits.abs())))


def sigmoid_focal_loss(inputs, targets, num_boxes, alpha, gamma):
    """Reference criterion.py:222-248 (mean over queries, / num_boxes)."""
    prob = torch.sigmoid(inputs)
    ce = _bce_with_logits(inputs, targets)
    p_t = prob * targets + (1 - prob) * (1 - targets)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * targets + (1 - alpha) * (1 - targets)) * loss
    return loss.mean(dim=1).sum() / num_boxes


def counter_loss(cfg: CriterionConfig, pred_count, gt_count, n_videos=None):
    """Gaussian-masked BCE over the event-count logits
    (reference criterion.py:200-220 + loss_labels:67-76), averaged over
    the videos (:func:`batch_mean`)."""
    E1 = pred_count.shape[1]                   # max_eseq_length + 1
    tgt = gt_count.clamp(0, E1 - 1).long()
    onehot = F.one_hot(tgt, E1).to(pred_count.dtype)
    rate = np.zeros((E1,), np.float32)
    n = min(E1, len(COUNTER_CLASS_RATE))
    rate[:n] = COUNTER_CLASS_RATE[:n]
    weight = 1.0 - torch.from_numpy(rate).to(pred_count.device)
    loss = _bce_with_logits(pred_count, onehot) * weight
    if cfg.lloss_gau_mask:
        mu = torch.arange(E1, dtype=torch.float32, device=pred_count.device)
        gauss = torch.exp(-(mu[:, None] - mu[None, :]) ** 2 / (2 * 2.0 ** 2))
        mask = gauss[tgt]                       # (B, E1)
        coef = onehot + ((1 - mask) ** cfg.lloss_beta) * (1 - onehot)
    else:
        coef = torch.ones_like(onehot)
    return batch_mean((loss * coef).mean(dim=1), n_videos)


def batch_mean(per_video, n_videos=None):
    """The mean over the batch's videos of ``per_video`` (B,); with
    ``n_videos`` (the global batch's count) this rank's share of the
    global batch's mean."""
    return per_video.mean() if n_videos is None else \
        per_video.sum() / n_videos


def layer_losses(cfg: CriterionConfig, pred_logits, pred_count, pred_boxes,
                 gt_labels, gt_boxes, gt_mask, num_boxes, col4row,
                 n_videos=None):
    """Losses of one decoder layer for the matching ``col4row`` (B, G):
    the pair losses over the matched gt slots (:func:`matched_mask`), the
    event count over every real one, each normalised by ``num_boxes``;
    the means over videos by ``n_videos`` where given (:func:`batch_mean`)."""
    B, Nq, K = pred_logits.shape
    m = matched_mask(col4row, gt_mask).to(pred_logits.dtype)
    col4row = col4row.clamp(min=0)
    # target_classes_onehot (B, Nq, K): 1 at (matched query, its label)
    q_onehot = F.one_hot(col4row, Nq).to(m.dtype) * m[..., None]   # (B,G,Nq)
    l_onehot = F.one_hot(gt_labels.long(), K).to(m.dtype)          # (B,G,K)
    target = torch.einsum('bgq,bgk->bqk', q_onehot, l_onehot).clamp(0, 1)
    loss_ce = sigmoid_focal_loss(pred_logits, target, num_boxes,
                                 cfg.focal_alpha, cfg.focal_gamma) * Nq

    gt_count = gt_mask.sum(-1)
    loss_counter = counter_loss(cfg, pred_count, gt_count, n_videos)

    src_boxes = torch.gather(pred_boxes, 1,
                             col4row[..., None].expand(-1, -1, 2))  # (B,G,2)
    loss_bbox = ((src_boxes - gt_boxes).abs().sum(-1) * m).sum() / num_boxes
    giou = generalized_box_iou(box_cl_to_xy(src_boxes),
                               box_cl_to_xy(gt_boxes))
    giou_diag = torch.diagonal(giou, dim1=1, dim2=2)               # (B, G)
    loss_giou = ((1 - giou_diag) * m).sum() / num_boxes

    with torch.no_grad():
        # self-IoU diagnostic (log-only; reference criterion.py:114-121)
        iou_mat, _ = box_iou(box_cl_to_xy(src_boxes), box_cl_to_xy(src_boxes))
        pair = m[:, :, None] * m[:, None, :]
        triu = torch.triu(torch.ones_like(iou_mat), diagonal=1)
        n_valid = m.sum(-1)
        denom = 0.5 * n_valid * (n_valid - 1)
        per_video = (iou_mat * pair * triu).sum((1, 2)) / denom.clamp(min=1.0)
        loss_self_iou = torch.where(denom > 0, per_video, 0.0).sum()
        # cardinality (log-only; reference criterion.py:80-92)
        card_pred = (pred_logits.argmax(-1) != K - 1).sum(-1)
        card_err = batch_mean((card_pred.float() - gt_count.float()).abs(),
                              n_videos)

    return {'loss_ce': loss_ce, 'loss_counter': loss_counter,
            'loss_bbox': loss_bbox, 'loss_giou': loss_giou,
            'loss_self_iou': loss_self_iou, 'cardinality_error': card_err}


@dataclasses.dataclass
class Matching:
    """The matching of the criterion's decoder layers and the batch's
    counts that normalise the losses: ``idx`` {layer: col4row (B, G)},
    ``num_boxes`` (the real gt events, at least 1), ``n_matched`` {layer:
    its matched gt slots, at least 1} (the caption losses' denominators)
    and ``n_videos`` (None in one process, where the means over videos
    are taken as they are)."""
    idx: dict
    num_boxes: torch.Tensor
    n_matched: dict
    n_videos: torch.Tensor | None = None


def match_layers(cfg: CriterionConfig, outputs, gt_labels, gt_boxes, gt_mask,
                 aux_loss=True, global_sum=None) -> Matching:
    """Every criterion layer's matching (one solve on the device for all
    of them, no copy to the host) and the counts of :class:`Matching`.
    ``global_sum`` (``parallel.global_sum`` on a data-parallel rank) sums
    the counts over the ranks in one all-reduce, so that each rank's
    losses are its shares of the global batch's."""
    D = outputs['pred_logits'].shape[0]
    layer_ids = list(range(D)) if aux_loss else [D - 1]
    idx = dict(zip(layer_ids, hungarian_match(
        cfg.matcher, outputs['pred_logits'][layer_ids],
        outputs['pred_boxes'][layer_ids], gt_labels, gt_boxes, gt_mask)))
    counts = torch.stack(
        [gt_mask.sum(), gt_mask.new_full((), gt_mask.shape[0],
                                         dtype=torch.long)]
        + [matched_mask(idx[l], gt_mask).sum() for l in layer_ids]).float()
    if global_sum is not None:
        counts = global_sum(counts)
    return Matching(idx=idx, num_boxes=counts[0].clamp(min=1.0),
                    n_matched={l: counts[2 + i].clamp(min=1.0)
                               for i, l in enumerate(layer_ids)},
                    n_videos=None if global_sum is None else counts[1])


def criterion_forward(cfg: CriterionConfig, outputs, gt_labels, gt_boxes,
                      gt_mask, aux_loss=True,
                      matching: Matching | None = None):
    """Full criterion over the last and (``aux_loss``) earlier decoder
    layers.  outputs: 'pred_logits' (D, B, Nq, K), 'pred_count' (D, B, E+1),
    'pred_boxes' (D, B, Nq, 2), stacked over the layers; ``matching`` (of
    :func:`match_layers`) made here when not given.  Returns (losses,
    last_idx, aux_idx); aux losses carry the reference's ``_{i}``
    suffixes."""
    D = outputs['pred_logits'].shape[0]
    if matching is None:
        matching = match_layers(cfg, outputs, gt_labels, gt_boxes, gt_mask,
                                aux_loss)
    idx = matching.idx

    def losses_of(l):
        return layer_losses(cfg, outputs['pred_logits'][l],
                            outputs['pred_count'][l], outputs['pred_boxes'][l],
                            gt_labels, gt_boxes, gt_mask, matching.num_boxes,
                            idx[l], matching.n_videos)

    losses = losses_of(D - 1)
    aux_idx = []
    if aux_loss:
        for i in range(D - 1):
            losses.update({f'{k}_{i}': v for k, v in losses_of(i).items()})
            aux_idx.append(idx[i])
    return losses, idx[D - 1], aux_idx


def build_weight_dict(opt):
    """Loss-weight table incl. aux suffixes (reference pdvc.py:583-595).
    Two-stage on gt proposals the localisation losses are off: every
    ``loss_length``, ``loss_ce``, ``loss_bbox`` and ``loss_giou`` weight,
    aux ones included, is 0 (reference decide_two_stage,
    misc/utils.py:31-49)."""
    weight_dict = {'loss_ce': opt.cls_loss_coef,
                   'loss_bbox': opt.bbox_loss_coef,
                   'loss_giou': opt.giou_loss_coef,
                   'loss_counter': opt.count_loss_coef,
                   'loss_caption': opt.caption_loss_coef}
    if opt.aux_loss:
        aux = {}
        for i in range(opt.dec_layers - 1):
            aux.update({f'{k}_{i}': v for k, v in weight_dict.items()})
        weight_dict.update(aux)
    if opt.transformer_input_type == 'gt_proposals':
        for key in weight_dict:
            if any(q in key for q in ('loss_length', 'loss_ce', 'loss_bbox',
                                      'loss_giou')):
                weight_dict[key] = 0
    return weight_dict
