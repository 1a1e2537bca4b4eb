"""The evaluation loop: run the model over a loader, write the dvc json,
rerank, aggregate metrics (the port's counterpart of
``dvc_tpu/eval/eval_utils.py``).

``save_dvc_json``, ``get_topn_from_dvcjson``,
``convert_tapjson_from_dvcjson``, ``reranking`` and ``eval_metrics`` are
copies of that module's; ``evaluate`` runs the port's ``Trainer``.

Reference: ``eval_utils.py`` (evaluate:160-230, eval_metrics:109-129,
reranking:138-157, save_dvc_json:132-136).
"""

from __future__ import annotations

import collections
import json

import numpy as np
import torch

from ..data.prefetch import DevicePrefetchLoader
from ..models import postprocess, to_dvc_records
from ..models.criterion import build_weight_dict
from .dvc_eval import eval_dvc
from .para_eval import eval_para
from .soda import eval_soda


def save_dvc_json(out_json, path):
    out_json['valid_video_num'] = len(out_json['results'])
    out_json['avg_proposal_num'] = float(np.mean(
        [len(v) for v in out_json['results'].values()])) if out_json['results'] else 0.0
    with open(path, 'w') as f:
        json.dump(out_json, f)


def get_topn_from_dvcjson(dvc_json, out_json, top_n=3,
                          ranking_key='proposal_score', score_thres=-1e8):
    """Keep the top-N events per video by a ranking key
    (reference eval_utils.py:82-107)."""
    with open(dvc_json) as f:
        data = json.load(f)['results']
    out = {'version': 'VERSION 1.0',
           'external_data': {'used:': True, 'details': 'GT proposals'},
           'results': {}}
    for video_name, info in data.items():
        kept = sorted(info, key=lambda x: x[ranking_key], reverse=True)
        kept = [p for p in kept if p[ranking_key] > score_thres][:top_n]
        # the reference drops videos whose proposals were all filtered out
        # (eval_utils.py:99-101); keeping empty lists would change
        # valid_video_num / avg_proposal_num downstream
        if kept:
            out['results'][video_name] = kept
    save_dvc_json(out, out_json)
    return out_json


def convert_tapjson_from_dvcjson(anno_json, tap_json):
    """Ground-truth annotations -> temporal-action-proposal json
    (reference eval_utils.py:60-79)."""
    with open(anno_json) as f:
        data = json.load(f)
    out = {'version': 'VERSION 1.0',
           'external_data': {'used:': True, 'details': 'GT proposals'},
           'results': {}}
    for video_name, entry in data.items():
        out['results'][video_name[2:]] = [
            {'segment': ts, 'score': 1.0, 'sentence': s}
            for ts, s in zip(entry['timestamps'], entry['sentences'])]
    with open(tap_json, 'w') as f:
        json.dump(out, f)
    return tap_json


def reranking(p_src, alpha, temperature):
    """Counter-guided reranking (reference eval_utils.py:138-157): joint
    score = alpha * sentence_score / len^temperature + proposal_score; keep
    the top pred_event_count, re-sorted by time."""
    with open(p_src) as f:
        d = json.load(f)
    for k, v in list(d['results'].items()):
        sent_scores = [p['sentence_score']
                       / (float(len(p['sentence'].split())) ** temperature + 1e-5)
                       for p in v]
        prop_scores = [p['proposal_score'] for p in v]
        joint = alpha * np.array(sent_scores) + np.array(prop_scores)
        for i, p in enumerate(v):
            p['joint_score'] = float(joint[i])
        v = sorted(v, key=lambda x: x['joint_score'], reverse=True)
        top_n = v[0]['pred_event_count'] if v else 0
        v = v[:top_n]
        v = sorted(v, key=lambda x: x['timestamp'])
        d['results'][k] = v
    save_path = p_src + f'_rerank_alpha{alpha}_temp{temperature}.json'
    save_dvc_json(d, save_path)
    return save_path


def eval_metrics(dvc_filename, gt_filenames, para_gt_filenames, alpha=0.3,
                 rerank=False, dvc_eval_version='2018', verbose=True):
    """Aggregate DVC + SODA + paragraph metrics
    (reference eval_utils.py:109-129)."""
    score = collections.defaultdict(lambda: -1)
    if rerank:
        dvc_filename = reranking(dvc_filename, alpha=alpha, temperature=2.0)
    dvc_score = eval_dvc(json_path=dvc_filename, reference=gt_filenames,
                         version=dvc_eval_version, verbose=verbose)
    dvc_score = {k: sum(v) / len(v) for k, v in dvc_score.items()}
    dvc_score.update(eval_soda(dvc_filename, ref_list=gt_filenames))
    if para_gt_filenames:
        dvc_score.update(eval_para(dvc_filename,
                                   referneces=para_gt_filenames))
    score.update(dvc_score)
    return score


def evaluate(trainer, loader, dvc_json_path, logger=None, score_threshold=0,
             alpha=0.3, dvc_eval_version='2018', debug=False,
             skip_lang_eval=False):
    """Model evaluation loop (reference eval_utils.py:160-230): the eval
    step of the port's ``Trainer`` on every batch of ``loader``
    (prefetched under ``--device_prefetch 1``; its losses, weighted as in
    training, and the captions), the
    postprocessed records into ``dvc_json_path``, then the metrics.
    Returns (scores, mean losses), or (None, None) with
    ``skip_lang_eval``."""
    opt = trainer.opt
    out_json = {'results': {}, 'version': 'VERSION 1.0',
                'external_data': {'used:': True, 'details': None}}
    weight_dict = build_weight_dict(opt)
    loss_sum = collections.OrderedDict()
    n_batches = 0
    translator = loader.ds.translator

    # collation in a worker thread, the next batch's upload during this
    # step (dvc_tpu/eval/eval_utils.py:125-127)
    iter_loader = (DevicePrefetchLoader(loader, trainer.prepare_eval_batch)
                   if opt.device_prefetch else loader)
    for batch, meta in iter_loader:
        out, losses = trainer.eval_step(batch)
        n_batches += 1
        # one copy to the host for all the losses
        losses = dict(zip(losses, torch.stack(
            [v.float() for v in losses.values()]).tolist()))
        total = sum(losses[k] * w for k, w in weight_dict.items()
                    if k in losses and w)
        for k, v in losses.items():
            loss_sum[k] = loss_sum.get(k, 0.0) + v
        loss_sum['total_loss'] = loss_sum.get('total_loss', 0.0) + total

        with torch.inference_mode():
            post = postprocess(out, torch.tensor(
                meta['durations'], dtype=torch.float32,
                device=trainer.device))
        records = to_dvc_records(post, meta['keys'], meta['durations'],
                                 translator)
        # trim tail padding (a loader that repeats its last sample to keep
        # the batch shape says how many are real)
        n_real = meta.get('n_real')
        if n_real is not None and n_real < len(meta['keys']):
            keep = set(meta['keys'][:n_real])
            records = {k: v for k, v in records.items() if k in keep}
        if score_threshold:
            records = {k: [p for p in v
                           if p['proposal_score'] > score_threshold]
                       for k, v in records.items()}
        out_json['results'].update(records)
        if debug and len(out_json['results']) > 5:
            break

    save_dvc_json(out_json, dvc_json_path)
    if skip_lang_eval:
        return None, None

    for k in loss_sum:
        loss_sum[k] = round(loss_sum[k] / (n_batches + 1e-5), 3)
    if logger:
        logger.info(f'validation loss: {dict(loss_sum)}')
    scores = eval_metrics(dvc_json_path, gt_filenames=opt.gt_file_for_eval,
                          para_gt_filenames=opt.gt_file_for_para_eval,
                          alpha=alpha, rerank=(opt.count_loss_coef > 0),
                          dvc_eval_version=dvc_eval_version)
    out_json.update(scores)
    save_dvc_json(out_json, dvc_json_path)
    return scores, loss_sum
