"""A synthetic dense-captioning dataset made from a seed (the port's own
copy of the JAX repo's test fixture ``tests/synth.py``): ``.npy``
features, the annotation JSON and the vocabulary.  The measurement tools
(``bench_epoch``) train on it; for the same arguments it writes the same
files as the fixture does."""

from __future__ import annotations

import json
import os

import numpy as np

WORDS = ['add', 'the', 'mix', 'stir', 'pan', 'oil', 'salt', 'cook', 'cut',
         'onion', 'bowl', 'water', 'heat', 'place', 'pot']


def make_synth_dataset(root, n_videos=6, feat_dim=16, n_frames=40, seed=0,
                       n_words=None):
    """Writes ``features/``, ``train.json`` and ``vocab.json`` under root.
    Returns (anno_path, feature_folder, vocab_path, vocab_size).

    Each video is 60 s long with 2-3 events, each event's span marked in
    its features, and each caption 3-5 words of ``WORDS``.  ``n_words``
    pads the vocabulary with synthetic words to a target size (the
    flagship's shapes need the real 1607-word projection)."""
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, 'features')
    os.makedirs(feat_dir, exist_ok=True)

    vocab_words = sorted(set(WORDS))
    if n_words and n_words - 1 > len(vocab_words):
        vocab_words += [f'w{i:05d}' for i in range(n_words - 1
                                                   - len(vocab_words))]
    vocab_words = vocab_words + ['UNK']
    ix_to_word = {str(i + 1): w for i, w in enumerate(vocab_words)}
    word_to_ix = {w: i + 1 for i, w in enumerate(vocab_words)}
    vocab_path = os.path.join(root, 'vocab.json')
    with open(vocab_path, 'w') as f:
        json.dump({'ix_to_word': ix_to_word, 'word_to_ix': word_to_ix}, f)

    anno = {}
    for v in range(n_videos):
        key = f'v_synth{v:07d}'
        duration = 60.0
        n_events = int(rng.integers(2, 4))
        starts = np.sort(rng.uniform(0, 0.7, n_events)) * duration
        ends = starts + rng.uniform(0.1, 0.25, n_events) * duration
        ends = np.minimum(ends, duration)
        sents = []
        feats = rng.standard_normal((n_frames, feat_dim)).astype(
            np.float32) * 0.1
        for j in range(n_events):
            ws = rng.choice(WORDS, size=int(rng.integers(3, 6)))
            sents.append(' '.join(ws))
            # a feature signature inside the event's span, so that a model
            # can localize it
            s = int(starts[j] / duration * n_frames)
            e = max(s + 1, int(ends[j] / duration * n_frames))
            feats[s:e, j % feat_dim] += 2.0
        np.save(os.path.join(feat_dir, key[:13] + '.npy'), feats)
        anno[key] = {'duration': duration,
                     'timestamps': [[float(s), float(e)]
                                    for s, e in zip(starts, ends)],
                     'sentences': sents}
    anno_path = os.path.join(root, 'train.json')
    with open(anno_path, 'w') as f:
        json.dump(anno, f)
    return anno_path, feat_dir, vocab_path, len(vocab_words)
