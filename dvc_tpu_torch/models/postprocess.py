"""PDVC outputs -> per-video event lists (port of
``dvc_tpu/models/postprocess.py``).

Per video: sigmoid the class logits, rank the (query, class) pairs, convert
boxes to (start, end), clamp to [0, 1], scale by the duration, score each
caption by the sum of its masked token log-probs, and read the event count
from the counter head.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.box_ops import box_cl_to_xy


def postprocess(out, target_sizes):
    """Tensor part.  out: eval outputs of the last decoder layer;
    target_sizes (B,) durations.  Returns dict of (B, Nq, ...) tensors
    sorted by score, descending (ties keep the lower index, as
    ``jax.lax.top_k``)."""
    logits = out['pred_logits']
    B, Nq, K = logits.shape
    prob = torch.sigmoid(logits).reshape(B, Nq * K)
    scores, topk_idx = torch.sort(prob, dim=1, descending=True, stable=True)
    scores, topk_idx = scores[:, :Nq], topk_idx[:, :Nq]
    topk_boxes = torch.div(topk_idx, K, rounding_mode='floor')
    boxes = box_cl_to_xy(out['pred_boxes']).clamp(0.0, 1.0)
    boxes = torch.gather(boxes, 1, topk_boxes[..., None].expand(B, Nq, 2))
    result = {'scores': scores, 'labels': topk_idx % K,
              'boxes': boxes * target_sizes[:, None, None],
              'query_id': topk_boxes,
              'pred_count': out['pred_count'].argmax(-1).clamp(min=1)}
    if 'seq' in out:
        seq = out['seq']                                      # (B, Nq, Lmax)
        cap_scores = ((seq > 0).float() * out['cap_prob_eval']).sum(-1)
        result['seq'] = torch.gather(
            seq, 1, topk_boxes[..., None].expand(B, Nq, seq.shape[-1]))
        result['caption_scores'] = torch.gather(cap_scores, 1, topk_boxes)
    return result


def to_dvc_records(post, video_keys, durations, translator):
    """Host side: one batch of postprocessed arrays -> dvc-json records."""
    post = {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in post.items()}
    scores, boxes = post['scores'], post['boxes']
    qids, counts = post['query_id'], post['pred_count']
    seq = post.get('seq')
    cap_scores = post.get('caption_scores')
    results = {}
    for b, vid in enumerate(video_keys):
        items = []
        for q in range(scores.shape[1]):
            ts = [float(boxes[b, q, 0]), float(boxes[b, q, 1])]
            items.append({
                'timestamp': ts,
                # the reference's records carry raw_box == timestamp
                'raw_box': list(ts),
                'proposal_score': float(scores[b, q]),
                'sentence': (translator.rtranslate(seq[b, q])
                             if seq is not None else ''),
                'sentence_score': (float(cap_scores[b, q])
                                   if cap_scores is not None else -1e5),
                'query_id': int(qids[b, q]),
                'vid_duration': float(durations[b]),
                'pred_event_count': int(counts[b]),
            })
        results[vid] = items
    return results
