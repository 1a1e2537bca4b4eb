"""Vocabulary ``Translator`` of the port: the same JSON format and id <-> word
rules as ``dvc_tpu/data/vocabulary.py`` (reference
``data/video_dataset.py:152-180``), in the port's own copy.

Token ids: 0 is BOS/EOS, 1.. are words, ``vocab_size`` is UNK.  The vocab
JSON is the reference's ({'ix_to_word': {id: word}, 'word_to_ix': {word:
id}}), so released vocab files load unchanged.
"""

from __future__ import annotations

import json
from collections import defaultdict

import numpy as np

_STRIP_TOKENS = [',', ':', '!', '_', ';', '-', '.', '?', '/', '"', '\\n', '\\', '.']


class Translator:
    def __init__(self, translator_json: str, vocab_size: int):
        self.vocab_size = vocab_size
        with open(translator_json, 'r') as f:
            vocab = json.load(f)
        if vocab_size != len(vocab['word_to_ix']):
            raise ValueError(f'{translator_json} holds '
                             f'{len(vocab["word_to_ix"])} words, the run '
                             f'expects vocab_size {vocab_size}')
        self.word_to_ix = defaultdict(lambda: self.vocab_size,
                                      vocab['word_to_ix'])
        self.ix_to_word = defaultdict(lambda: self.vocab_size,
                                      vocab['ix_to_word'])

    def translate(self, sentence: str, max_len: int) -> np.ndarray:
        """Sentence -> [BOS=0, ids..., EOS=0], truncated to max_len."""
        for tok in _STRIP_TOKENS:
            sentence = sentence.replace(tok, ' ')
        words = sentence.replace('.', ' . ').replace(',', ' , ').lower().split()
        ids = [self.word_to_ix[w] for w in words][:max_len - 2]
        return np.array([0] + ids + [0], dtype=np.int64)

    def rtranslate(self, sent_ids) -> str:
        """Ids -> sentence, truncated at the first 0 (EOS)."""
        sent_ids = list(sent_ids)
        for i, t in enumerate(sent_ids):
            if t == 0:
                sent_ids = sent_ids[:i]
                break
        if len(sent_ids):
            return ' '.join(self.ix_to_word[str(int(i))]
                            for i in sent_ids) + '.'
        return ''
