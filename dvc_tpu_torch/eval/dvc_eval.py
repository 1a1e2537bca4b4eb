"""Dense-video-captioning evaluation (2018 + 2021 protocols; the port's
copy of ``dvc_tpu/eval/dvc_eval.py``, drawing the 2021 garbage caption
from Python's global ``random`` as that module does).

Reference: ``densevid_eval3/evaluate2018.py`` / ``evaluate2021.py``.  For
each tIoU in {0.3, 0.5, 0.7, 0.9}: every (prediction, gt) caption pair with
IoU above threshold is scored; predictions overlapping nothing are scored
against a garbage caption ('abc123!@#' in 2018; a random string in 2021 —
the only difference between the protocols).  Localization precision/recall
are computed per tIoU over covered prediction/reference sets.
"""

from __future__ import annotations

import json
import random
import string

import numpy as np

from .scorers import Bleu, Cider, Meteor, Rouge, tokenize_dict

TIOUS = (0.3, 0.5, 0.7, 0.9)


def remove_nonascii(text):
    return ''.join(i if ord(i) < 128 else ' ' for i in text)


def iou_1d(a, b):
    start_i, end_i = a[0], a[1]
    start, end = b[0], b[1]
    intersection = max(0, min(end, end_i) - max(start, start_i))
    union = min(max(end, end_i) - min(start, start_i),
                end - start + end_i - start_i)
    return float(intersection) / (union + 1e-8)


class DVCEvaluator:
    def __init__(self, ground_truth_filenames, prediction_filename,
                 tious=TIOUS, max_proposals=1000, verbose=False,
                 no_lang_eval=False, version='2018'):
        self.tious = list(tious)
        self.max_proposals = max_proposals
        self.verbose = verbose
        self.no_lang_eval = no_lang_eval
        self.version = version
        self.ground_truths = []
        for fn in ground_truth_filenames:
            with open(fn) as f:
                self.ground_truths.append(json.load(f))
        if isinstance(prediction_filename, str):
            with open(prediction_filename) as f:
                submission = json.load(f)
        else:
            submission = prediction_filename
        self.prediction = {vid: items[:max_proposals]
                           for vid, items in submission['results'].items()}
        if verbose:
            self.scorers = [(Bleu(4), ['Bleu_1', 'Bleu_2', 'Bleu_3',
                                       'Bleu_4']),
                            (Meteor(), 'METEOR'), (Rouge(), 'ROUGE_L'),
                            (Cider(), 'CIDEr')]
        else:
            self.scorers = [(Meteor(), 'METEOR')]

    def get_gt_vid_ids(self):
        vid_ids = set()
        for gt in self.ground_truths:
            vid_ids |= set(gt.keys())
        return list(vid_ids)

    def _garbage(self):
        if self.version == '2018':
            return 'abc123!@#'
        # 2021: random string (evaluate2021.py:27-30)
        return ''.join(random.choice(string.ascii_lowercase)
                       for _ in range(10))

    def evaluate(self):
        scores = {}
        if not self.no_lang_eval:
            for tiou in self.tious:
                out = self.evaluate_tiou(tiou)
                for metric, score in out.items():
                    scores.setdefault(metric, []).append(score)
        scores['Recall'] = []
        scores['Precision'] = []
        for tiou in self.tious:
            precision, recall = self.evaluate_detection(tiou)
            scores['Recall'].append(recall)
            scores['Precision'].append(precision)
        self.scores = scores
        return scores

    def evaluate_detection(self, tiou):
        """Localization P/R per tIoU (reference evaluate2018.py:127-158)."""
        gt_vid_ids = self.get_gt_vid_ids()
        recall = []
        precision = []
        for vid_id in gt_vid_ids:
            best_recall = 0.0
            best_precision = 0.0
            for gt in self.ground_truths:
                if vid_id not in gt:
                    continue
                refs = gt[vid_id]
                ref_covered = set()
                pred_covered = set()
                preds = self.prediction.get(vid_id, [])
                if preds:
                    for pred_i, pred in enumerate(preds):
                        for ref_i, ref_ts in enumerate(refs['timestamps']):
                            if iou_1d(pred['timestamp'], ref_ts) > tiou:
                                ref_covered.add(ref_i)
                                pred_covered.add(pred_i)
                    best_precision = max(best_precision,
                                         len(pred_covered) / len(preds))
                best_recall = max(best_recall,
                                  len(ref_covered) / len(refs['timestamps']))
            recall.append(best_recall)
            precision.append(best_precision)
        return (sum(precision) / len(precision) if precision else 0.0,
                sum(recall) / len(recall) if recall else 0.0)

    def evaluate_tiou(self, tiou):
        """Caption metrics over IoU-matched pairs
        (reference evaluate2018.py:160-252)."""
        gt_vid_ids = self.get_gt_vid_ids()
        unique_index = 0
        vid2capid = {}
        cur_res = {}
        cur_gts = {}
        for vid_id in gt_vid_ids:
            vid2capid[vid_id] = []
            for pred in self.prediction.get(vid_id, []):
                has_added = False
                for gt in self.ground_truths:
                    if vid_id not in gt:
                        continue
                    gt_caps = gt[vid_id]
                    for ci, ts in enumerate(gt_caps['timestamps']):
                        if iou_1d(pred['timestamp'], ts) >= tiou:
                            cur_res[unique_index] = [
                                {'caption': remove_nonascii(pred['sentence'])}]
                            cur_gts[unique_index] = [
                                {'caption': remove_nonascii(
                                    gt_caps['sentences'][ci])}]
                            vid2capid[vid_id].append(unique_index)
                            unique_index += 1
                            has_added = True
                if not has_added:
                    cur_res[unique_index] = [
                        {'caption': remove_nonascii(pred['sentence'])}]
                    cur_gts[unique_index] = [{'caption': self._garbage()}]
                    vid2capid[vid_id].append(unique_index)
                    unique_index += 1

        tok_res = tokenize_dict(cur_res)
        tok_gts = tokenize_dict(cur_gts)
        output = {}
        for scorer, method in self.scorers:
            all_scores = {}
            for vid_id in gt_vid_ids:
                res_v = {i: tok_res[i] for i in vid2capid[vid_id]}
                gts_v = {i: tok_gts[i] for i in vid2capid[vid_id]}
                if len(res_v) == 0 or len(gts_v) == 0:
                    score = [0] * len(method) if isinstance(method, list) else 0
                else:
                    score, _ = scorer.compute_score(gts_v, res_v)
                all_scores[vid_id] = score
            if isinstance(method, list):
                means = np.mean(list(all_scores.values()), axis=0)
                for m, name in enumerate(method):
                    output[name] = float(means[m])
            else:
                output[method] = float(np.mean(list(all_scores.values())))
        return output


def eval_dvc(json_path, reference, no_lang_eval=False, topN=1000,
             version='2018', verbose=True):
    """Wrapper matching ``densevid_eval3/eval_dvc.py:4-14``; returns
    {metric: [per-tIoU values]}."""
    ev = DVCEvaluator(ground_truth_filenames=reference,
                      prediction_filename=json_path, tious=TIOUS,
                      max_proposals=topN, verbose=verbose,
                      no_lang_eval=no_lang_eval, version=version)
    return ev.evaluate()
