"""SODA — Story Oriented Dense video cAptioning evaluation (soda_c; the
port's copy of ``dvc_tpu/eval/soda.py``).

Reference: ``densevid_eval3/SODA/soda.py`` + ``SODA/dataset.py``.  For each
video, a dynamic-programming assignment (monotonic, LCS-style) maximizes the
sum of IoU × METEOR over (gt, prediction) pairs; precision = score / n_pred,
recall = score / n_gt, and soda_c is the mean F1.  The DP here is iterative
(the reference's recursive ``chased_dp_assignment`` overflows Python's
recursion limit on long videos; same recurrence, bottom-up).
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

from .dvc_eval import iou_1d, remove_nonascii
from .scorers import Meteor, Cider, tokenize_dict


def chased_dp_assignment(scores: np.ndarray):
    """max Σ scores over monotonic non-crossing pairs
    (reference soda.py:143-181, bottom-up)."""
    M, N = scores.shape
    dp = np.zeros((M, N))
    path = np.zeros((M, N), np.int64)
    for i in range(M):
        for j in range(N):
            cands = [dp[i - 1, j] if i > 0 else -1,
                     dp[i, j - 1] if j > 0 else -1,
                     (dp[i - 1, j - 1] if i > 0 and j > 0 else 0)
                     + scores[i, j]]
            k = int(np.argmax(cands))
            dp[i, j] = cands[k]
            path[i, j] = k
    # traceback
    pairs = []
    i, j = M - 1, N - 1
    while i >= 0 and j >= 0:
        k = path[i, j]
        if k == 2:
            pairs.append((i, j))
            i, j = i - 1, j - 1
        elif k == 0:
            i -= 1
        else:
            j -= 1
    return float(dp[M - 1, N - 1]), pairs[::-1]


def _make_scorer(name: str):
    """Scorer registry (reference soda.py:26-28 uses ``eval(scorer)()``).

    ``BertScore``/``MoverScore`` (reference SODA/nlpeval/) need pretrained
    LM weights; they are supported when a local model directory is supplied
    via ``DVC_BERTSCORE_MODEL`` (zero-egress environments cannot download
    one) and raise a clear error otherwise.
    """
    from .scorers import Bleu, Rouge
    if name == 'Meteor':
        return Meteor()
    if name == 'Cider':
        return Cider()
    if name == 'Rouge':
        return Rouge()
    if name == 'Bleu':
        return _Bleu4(Bleu(4))
    if name == 'BertScore':
        return BertScore()
    if name == 'MoverScore':
        return MoverScore()
    raise ValueError(f'unknown SODA scorer {name!r}')


class _Bleu4:
    """Per-instance BLEU-4 row (pycocoevalcap Bleu returns one list per n;
    SODA needs a flat per-instance vector)."""

    def __init__(self, inner):
        self.inner = inner

    def compute_score(self, gts, res):
        final, per_n = self.inner.compute_score(gts, res)
        return final[-1], per_n[-1]


class BertScore:
    """Recall-oriented BERTScore (reference SODA/nlpeval/bert_r_score.py):
    greedy token-embedding recall between hypothesis and reference, using a
    locally available HF encoder (``DVC_BERTSCORE_MODEL``)."""

    def __init__(self, model_dir=None):
        import os
        model_dir = model_dir or os.environ.get('DVC_BERTSCORE_MODEL')
        if not model_dir:
            raise RuntimeError(
                'BertScore needs a local encoder: set DVC_BERTSCORE_MODEL '
                'to a HF model directory (no network access here)')
        from transformers import AutoModel, AutoTokenizer
        self.tok = AutoTokenizer.from_pretrained(model_dir)
        self.model = AutoModel.from_pretrained(model_dir)
        self.model.eval()

    def _embed(self, sents):
        import torch
        with torch.no_grad():
            enc = self.tok(sents, return_tensors='pt', padding=True,
                           truncation=True)
            out = self.model(**enc).last_hidden_state
            norm = out / out.norm(dim=-1, keepdim=True).clamp(min=1e-8)
            return norm, enc['attention_mask']

    def compute_score(self, gts, res):
        import torch
        keys = sorted(gts.keys())
        hyp = [res[k][0] if isinstance(res[k], list) else res[k]
               for k in keys]
        ref = [gts[k][0] if isinstance(gts[k], list) else gts[k]
               for k in keys]
        h_emb, h_mask = self._embed(hyp)
        r_emb, r_mask = self._embed(ref)
        sims = torch.einsum('bld,bmd->blm', r_emb, h_emb)
        sims = sims.masked_fill(~h_mask[:, None, :].bool(), -1e9)
        best = sims.max(-1).values                  # (B, Lr)
        m = r_mask.float()
        recall = (best * m).sum(-1) / m.sum(-1).clamp(min=1)
        scores = [float(s) for s in recall]
        return float(np.mean(scores)), scores


def emd_transport(a, b, cost):
    """Exact earth mover's distance: min Σ cost·x s.t. row sums = a,
    col sums = b (a, b sum to 1).  Solved as the transportation LP with
    scipy's linprog; sentence-sized instances (tens of tokens) only."""
    from scipy.optimize import linprog
    m, n = cost.shape
    # equality rows: m row-marginals + n col-marginals (one is redundant,
    # keep all — HiGHS handles the degeneracy)
    A = np.zeros((m + n, m * n))
    for i in range(m):
        A[i, i * n:(i + 1) * n] = 1.0
    for j in range(n):
        A[m + j, j::n] = 1.0
    res = linprog(cost.reshape(-1), A_eq=A,
                  b_eq=np.concatenate([a, b]), bounds=(0, None),
                  method='highs')
    if not res.success:
        raise RuntimeError(f'EMD LP failed: {res.message}')
    return float(res.fun)


class MoverScore:
    """Word Mover's Distance over contextual embeddings (Zhao et al. 2019).

    The reference scores SODA with the ``moverscore`` pip package
    (``SODA/nlpeval/mover.py``: ``word_mover_score(refs, cands, idf_ref,
    idf_hyp, stop_words=[], n_gram=1, remove_subwords=True)``).  When that
    package is importable it is used verbatim; otherwise this class runs a
    native unigram-WMD implementation gated on a local HF encoder
    (``DVC_BERTSCORE_MODEL`` — zero-egress environments cannot download
    one):

    * IDF mass per wordpiece id: ``log((N+1)/(df+1))`` over the corpus
      registered via ``make_dict`` (df = number of sentences containing the
      token), unseen tokens get ``log(N+1)`` — the package's
      ``get_idf_dict`` semantics.
    * embeddings: the encoder's last hidden layer, L2-normalized;
      subword continuations (``##…``) and special tokens are dropped
      (``remove_subwords=True``).
    * exact EMD between the IDF-normalized token masses under the Euclidean
      cost, reported as ``1 / (1 + distance)`` per pair, mean over pairs.

    Interface parity with the reference wrapper: ``make_dict(all_gts,
    all_res, vids)`` then ``compute_score(gts, res)``.
    """

    def __init__(self, model_dir=None):
        import os
        self.idf_dict_ref = None
        self.idf_dict_hyp = None
        try:
            from moverscore import get_idf_dict, word_mover_score
            self._pkg = (get_idf_dict, word_mover_score)
        except ImportError:
            self._pkg = None
            model_dir = model_dir or os.environ.get('DVC_BERTSCORE_MODEL')
            if not model_dir:
                raise RuntimeError(
                    'MoverScore needs either the moverscore package or a '
                    'local encoder: set DVC_BERTSCORE_MODEL to a HF model '
                    'directory (no network access here)')
            from transformers import AutoModel, AutoTokenizer
            self.tok = AutoTokenizer.from_pretrained(model_dir)
            self.model = AutoModel.from_pretrained(model_dir)
            self.model.eval()

    def method(self):
        return 'MoverScore'

    # -- idf over the whole corpus (reference mover.py:28-34)
    def _idf_dict(self, sents):
        if self._pkg:
            return self._pkg[0](sents)
        from collections import Counter, defaultdict
        from math import log
        df = Counter()
        for s in sents:
            df.update(set(self.tok(s)['input_ids']))
        n = len(sents)
        d = defaultdict(lambda: log((n + 1) / 1.0))
        d.update({t: log((n + 1) / (c + 1)) for t, c in df.items()})
        return d

    def make_dict(self, all_gts, all_res, vids):
        gold, pred = [], []
        for vid in vids:
            gold.extend(all_gts[vid]['sentences'])
            pred.extend([p['sentence'] for p in all_res[vid]])
        self.fit_corpus(gold, pred)

    def fit_corpus(self, gold_sents, pred_sents):
        """Build the corpus IDF dicts (the reference wrapper requires
        ``make_dict`` before scoring; mover.py:17 asserts it — SODA itself
        never calls it, so reference-SODA MoverScore crashes; SODAC wires
        this properly)."""
        self.idf_dict_ref = self._idf_dict(gold_sents)
        self.idf_dict_hyp = self._idf_dict(pred_sents)

    def _tokens(self, sent, idf_dict):
        """(embeddings, idf masses) for content wordpieces of one sentence."""
        import torch
        enc = self.tok(sent, return_tensors='pt')
        ids = enc['input_ids'][0]
        with torch.no_grad():
            emb = self.model(**enc).last_hidden_state[0]
        emb = emb / emb.norm(dim=-1, keepdim=True).clamp(min=1e-8)
        toks = self.tok.convert_ids_to_tokens(ids)
        special = set(self.tok.all_special_tokens)
        keep = [i for i, t in enumerate(toks)
                if t not in special and not t.startswith('##')]
        if not keep:
            keep = list(range(len(toks)))
        idf = np.array([idf_dict[int(ids[i])] for i in keep], np.float64)
        return emb[keep].numpy().astype(np.float64), idf

    def compute_score(self, gts, res):
        assert gts.keys() == res.keys()
        assert self.idf_dict_ref is not None and self.idf_dict_hyp is not None
        cands = [v[0] for v in res.values()]
        refs = [v[0] for v in gts.values()]
        if self._pkg:
            scores = self._pkg[1](refs, cands, self.idf_dict_ref,
                                  self.idf_dict_hyp, stop_words=[],
                                  n_gram=1, remove_subwords=True)
            return float(np.mean(scores)), list(map(float, scores))
        scores = []
        for ref, cand in zip(refs, cands):
            r_emb, r_idf = self._tokens(ref, self.idf_dict_ref)
            c_emb, c_idf = self._tokens(cand, self.idf_dict_hyp)
            cost = np.sqrt(np.maximum(
                ((r_emb[:, None] - c_emb[None, :]) ** 2).sum(-1), 0.0))
            a = r_idf / max(r_idf.sum(), 1e-12)
            b = c_idf / max(c_idf.sum(), 1e-12)
            scores.append(1.0 / (1.0 + emd_transport(a, b, cost)))
        return float(np.mean(scores)), scores


class SODAC:
    """SODA evaluation, types a/b/c/d (reference soda.py:31-47).

    * ``a`` — DP on the tIoU matrix, scored by the caption metric over the
      chosen pairs, averaged over tIoU thresholds (0.9/0.7/0.5/0.3).
    * ``b`` — same as ``a`` at a single threshold (default 0).
    * ``c`` — DP on tIoU × caption-metric (the headline soda_c).
    * ``d`` — DP on tIoU alone (no captions).
    """

    def __init__(self, preds, gts, gt_vids, scorer='Meteor', verbose=False,
                 soda_type='c', tious=None):
        self.preds = preds
        self.gts = gts
        self.gt_vids = gt_vids
        self.soda_type = soda_type
        if tious is None:
            tious = [0.9, 0.7, 0.5, 0.3] if soda_type == 'a' else [0.0]
        self.tious = tious
        if soda_type == 'd':
            self.scorer = None
        else:
            self.scorer = _make_scorer(scorer)
            if hasattr(self.scorer, 'fit_corpus'):
                # corpus-level IDF for MoverScore (the reference wrapper
                # requires make_dict before scoring but reference-SODA
                # never calls it — wired properly here)
                gold = [s for gt in gts for v in gt.values()
                        for s in v['sentences']]
                pred = [s for v in preds.values() for s in v['sentences']]
                self.scorer.fit_corpus(gold, pred)
        self.scorer_name = scorer
        self.verbose = verbose

    def calc_iou_matrix(self, preds, golds):
        return np.array([[iou_1d(p, ct) for p in preds['timestamps']]
                         for ct in golds['timestamps']])

    def calc_score_matrix(self, preds, golds):
        # note the reference's argument order (soda.py:66-70): the gold
        # sentence is the *hypothesis* and each prediction the reference —
        # kept verbatim since METEOR is asymmetric
        p_sent, g_sent = preds['sentences'], golds['sentences']
        gts_arg = {i: [p] for i, p in enumerate(p_sent)}
        return np.array([
            self.scorer.compute_score(
                gts_arg, {i: [g] for i in range(len(p_sent))})[1]
            for g in g_sent])

    def _soda_func(self, iou_mat, scores):
        """One DP solve per (iou, score) matrix pair (soda.py:121-139)."""
        if self.soda_type in ('a', 'b'):
            _, pairs = chased_dp_assignment(iou_mat)
            if not pairs:
                return 0.0
            r, c = zip(*pairs)
            return float(scores[list(r), list(c)].sum())
        if self.soda_type == 'c':
            max_score, _ = chased_dp_assignment(iou_mat * scores)
            return max_score
        # 'd'
        max_score, _ = chased_dp_assignment(iou_mat)
        return max_score

    def evaluate(self):
        nt = len(self.tious)
        p_best = [[] for _ in range(nt)]
        r_best = [[] for _ in range(nt)]
        f_best = [[] for _ in range(nt)]
        for vid in self.gt_vids:
            _p = [[] for _ in range(nt)]
            _r = [[] for _ in range(nt)]
            _f = [[] for _ in range(nt)]
            pred = self.preds[vid]
            for gt in self.gts:
                if vid not in gt:
                    continue
                gold = gt[vid]
                if len(pred['sentences']) == 0:
                    for i in range(nt):
                        _p[i].append(0.0)
                        _r[i].append(0.0)
                        _f[i].append(0.0)
                    continue
                _iou = self.calc_iou_matrix(pred, gold)
                if self.soda_type == 'd':
                    scores = np.zeros_like(_iou)
                else:
                    scores = self.calc_score_matrix(pred, gold)
                for i, tiou in enumerate(self.tious):
                    cut = np.copy(_iou)
                    cut[cut < tiou] = 0.0
                    max_score = self._soda_func(cut, scores)
                    n_g, n_p = cut.shape
                    p = max_score / n_p
                    r = max_score / n_g
                    _p[i].append(p)
                    _r[i].append(r)
                    _f[i].append(2 * p * r / (p + r) if p + r > 0 else 0.0)
            if not _f[0]:
                continue
            for i in range(nt):
                best = int(np.argmax(_f[i]))
                p_best[i].append(_p[i][best])
                r_best[i].append(_r[i][best])
                f_best[i].append(_f[i][best])
        # average over videos, then over tIoU thresholds (soda.py:107-118)
        def _avg(xs):
            per_tiou = [float(np.mean(x)) if x else 0.0 for x in xs]
            return float(np.mean(per_tiou)) if per_tiou else 0.0
        return [_avg(p_best), _avg(r_best), _avg(f_best)]


def _load_gts(filenames, multi_reference=False):
    """(reference SODA/dataset.py:load_ground_truth)."""
    gt_vids = set()
    gts = []
    for fn in filenames:
        with open(fn) as f:
            g = json.load(f)
        gt_vids.update(g.keys())
        gts.append(g)
    if not multi_reference:
        merged = defaultdict(dict)
        for vid in gt_vids:
            t, s = [], []
            for g in gts:
                if vid not in g:
                    continue
                t += [list(x) for x in g[vid]['timestamps']]
                s += list(g[vid]['sentences'])
            order = sorted(range(len(t)), key=lambda i: t[i][0])
            merged[vid]['timestamps'] = [t[i] for i in order]
            merged[vid]['sentences'] = [s[i] for i in order]
        gts = [dict(merged)]
    return gts, gt_vids


def _preprocess(preds, gts, gt_vids):
    """Tokenize everything once (reference SODA/dataset.py:preprocess)."""
    out_preds = {}
    for vid in gt_vids:
        items = sorted(preds[vid], key=lambda x: x['timestamp'][0])
        sents = tokenize_dict({0: [{'caption': remove_nonascii(
            p['sentence'])} for p in items]})[0]
        out_preds[vid] = {'timestamps': [p['timestamp'] for p in items],
                          'sentences': sents}
    out_gts = []
    for g in gts:
        ng = {}
        for vid in gt_vids:
            if vid not in g:
                continue
            sents = tokenize_dict({0: [{'caption': remove_nonascii(s)}
                                       for s in g[vid]['sentences']]})[0]
            ng[vid] = {'timestamps': g[vid]['timestamps'],
                       'sentences': sents}
        out_gts.append(ng)
    return out_preds, out_gts


def eval_soda(prediction, ref_list, verbose=False, soda_type='c',
              scorer='Meteor', tious=None):
    """Per-reference SODA averaged (reference eval_soda.py:45-54)."""
    if isinstance(prediction, str):
        with open(prediction) as f:
            prediction = json.load(f)
    scores = []
    for ref in ref_list:
        gts, gt_vids = _load_gts([ref], multi_reference=False)
        gt_vids = [v for v in gt_vids if v in prediction['results']]
        preds, gts = _preprocess(prediction['results'], gts, gt_vids)
        s = SODAC(preds, gts, gt_vids, verbose=verbose, soda_type=soda_type,
                  scorer=scorer, tious=tious).evaluate()
        scores.append(s)
    avg = np.mean(scores, axis=0)
    return {f'soda_{soda_type}': float(avg[-1])}
