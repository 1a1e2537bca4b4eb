#!/usr/bin/env python3
"""Host time of the port's metric stack (``dvc_tpu_torch.eval``) on a
synthetic validation set: the records of 16 videos (100 queries each,
captions of one word repeated 29 times, as a random-weight greedy decode
writes them) against ground truth of 3-40 events of 3-27 random words,
scored as a validation scores them (``eval_metrics`` with reranking),
timed by part (rerank, dvc, SODA, paragraph).

    python tools/metric_stack_cost.py [--vocab letters|digits] [--seed 0]

``--vocab digits`` names the words ``word1 .. word1607``; the paragraph
metric keeps letters only, so all of them become one word there, which
is the degenerate case. Runs on the host CPU; its times say nothing
about the card.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import letter_words  # noqa: E402
from dvc_tpu_torch.eval import eval_utils  # noqa: E402


def write_set(root, words, seed, n_videos=16, n_queries=100):
    rng = np.random.default_rng(seed)
    gt, para, results = {}, {}, {}
    for v in range(n_videos):
        key = f'v_valid{v:06d}'
        dur = float(rng.uniform(60, 600))
        n = int(rng.integers(3, 41))
        starts = np.sort(rng.uniform(0, 0.9, n)) * dur
        ends = np.minimum(starts + rng.uniform(0.02, 0.2, n) * dur, dur)
        sents = [' '.join(rng.choice(words, int(rng.integers(3, 28))))
                 for _ in range(n)]
        gt[key] = {'duration': dur, 'sentences': sents,
                   'timestamps': [[float(a), float(b)]
                                  for a, b in zip(starts, ends)]}
        para[key] = ' '.join(sents)
        count = int(rng.integers(1, 21))
        items = []
        for q in range(n_queries):
            a = float(rng.uniform(0, 0.9) * dur)
            b = min(a + float(rng.uniform(0.02, 0.5)) * dur, dur)
            word = rng.choice(words[:50], 1)[0]
            items.append({'timestamp': [a, b], 'raw_box': [a, b],
                          'proposal_score': float(rng.uniform()),
                          'sentence': ' '.join([word] * 29) + '.',
                          'sentence_score': float(-rng.uniform(1, 60)),
                          'query_id': q, 'vid_duration': dur,
                          'pred_event_count': count})
        results[key] = items
    paths = {}
    for name, obj in (('gt', gt), ('para', para),
                      ('pred', {'results': results})):
        paths[name] = os.path.join(root, f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(obj, f)
    return paths


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--vocab', choices=['letters', 'digits'],
                        default='letters')
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    words = (letter_words(1607) if args.vocab == 'letters'
             else [f'word{i}' for i in range(1, 1608)])
    seconds = {}
    for name in ('reranking', 'eval_dvc', 'eval_soda', 'eval_para'):
        fn = getattr(eval_utils, name)

        def timed(*a, _fn=fn, _name=name, **k):
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            seconds[_name] = time.perf_counter() - t0
            return out
        setattr(eval_utils, name, timed)
    with tempfile.TemporaryDirectory() as root:
        paths = write_set(root, words, args.seed)
        t0 = time.perf_counter()
        scores = eval_utils.eval_metrics(paths['pred'], [paths['gt']],
                                         [paths['para']], alpha=1.0,
                                         rerank=True)
        total = time.perf_counter() - t0
    print(json.dumps({'vocab': args.vocab, 'host_seconds': seconds,
                      'total_s': total,
                      'scores': {k: scores[k] for k in
                                 ('METEOR', 'soda_c', 'para_METEOR')}}))


if __name__ == '__main__':
    main()
