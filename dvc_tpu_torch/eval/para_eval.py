"""Paragraph captioning evaluation (the port's copy of
``dvc_tpu/eval/para_eval.py``).

Reference: ``densevid_eval3/para_evaluate.py`` + ``eval_para.py``.  Each
video's predicted sentences (time-ordered as produced) are joined into one
paragraph and scored with BLEU/METEOR/ROUGE/CIDEr against paragraph ground
truths; metric keys get a ``para_`` prefix.
"""

from __future__ import annotations

import json
import re



from .scorers import Bleu, Cider, Meteor, Rouge


def parse_sent(sent):
    res = re.sub('[^a-zA-Z]', ' ', sent)
    return res.strip().lower().split()


class ParaEvaluator:
    def __init__(self, ground_truth_filenames, prediction, all_scorer=True):
        self.ground_truths = []
        for fn in ground_truth_filenames:
            with open(fn) as f:
                self.ground_truths.append(self._ensure_key(json.load(f)))
        if isinstance(prediction, str):
            with open(prediction) as f:
                prediction = json.load(f)
        submission = prediction['results']
        para = {}
        for vid, items in submission.items():
            para[vid] = ''.join(info['sentence'] + '. ' for info in items)
        self.prediction = self._ensure_key(para)
        self.scorers = [
            (Bleu(4), ['Bleu_1', 'Bleu_2', 'Bleu_3', 'Bleu_4']),
            (Meteor(), 'METEOR'), (Rouge(), 'ROUGE_L'), (Cider(), 'CIDEr')]
        if not all_scorer:
            self.scorers = [(Meteor(), 'METEOR')]

    @staticmethod
    def _ensure_key(data):
        """Prefix 'v_' ids (reference para_evaluate.py:63-68)."""
        if len(data) == 0:
            return data
        if not list(data.keys())[0].startswith('v_'):
            return {'v_' + k: v for k, v in data.items()}
        return data

    def get_gt_vid_ids(self):
        vid_ids = set()
        for gt in self.ground_truths:
            vid_ids |= set(gt.keys())
        return list(vid_ids)

    def evaluate(self):
        gt_vid_ids = self.get_gt_vid_ids()
        vid2idx = {k: i for i, k in enumerate(gt_vid_ids)}
        gts = {vid2idx[k]: [] for k in gt_vid_ids}
        for gt in self.ground_truths:
            for k in gt_vid_ids:
                if k in gt:
                    gts[vid2idx[k]].append(' '.join(parse_sent(gt[k])))
        res = {vid2idx[k]:
               [' '.join(parse_sent(self.prediction[k]))]
               if k in self.prediction and len(self.prediction[k]) > 0
               else [''] for k in gt_vid_ids}
        output = {}
        for scorer, method in self.scorers:
            score, _ = scorer.compute_score(gts, res)
            if isinstance(method, list):
                for m, name in enumerate(method):
                    output[name] = float(score[m])
            else:
                output[method] = float(score)
        return output


def eval_para(prediction, referneces, verbose=False):
    """Wrapper matching ``densevid_eval3/eval_para.py:3-21`` — keys are
    prefixed ``para_``."""
    ev = ParaEvaluator(referneces, prediction, all_scorer=True)
    out = ev.evaluate()
    return {f'para_{k}': v for k, v in out.items()}
