"""The port's metric stack (``dvc_tpu_torch.eval``) against the JAX
package's (``dvc_tpu.eval``) on the same seeded inputs: the same arithmetic
on the same JSON, so every float is compared with ``==``.

Also the one place the copies differ: the jar-mode PTB tokenizer of the
port raises when the jar prints another number of lines than it got
captions, and ``tokenize_dict`` then falls back to the Python tokenizer
(a fake ``java`` on ``PATH`` stands in for the jar).
"""
import json
import os
import random
import stat

import numpy as np
import pytest

import dvc_tpu.eval as jax_eval
import dvc_tpu.eval.eval_utils as jax_eval_utils
import dvc_tpu_torch.eval as port_eval
import dvc_tpu_torch.eval.eval_utils as port_eval_utils

WORDS = ['add', 'the', 'onion', 'stir', 'pan', 'oil', 'salt', 'cook', 'cut',
         'into', 'pieces', 'a', 'bowl', 'of', 'water', 'heat', 'place', 'pot',
         'mix', 'well', 'chopped', 'garlic', 'and', 'pepper']


def _sentence(rng, lo=2, hi=12):
    return ' '.join(rng.choice(WORDS, int(rng.integers(lo, hi))))


def _corpus(seed, n=24):
    """gts / res in the scorers' interface: id -> [tokenized sentence]."""
    rng = np.random.default_rng(seed)
    gts = {i: [_sentence(rng) for _ in range(int(rng.integers(1, 4)))]
           for i in range(n)}
    res = {i: [_sentence(rng)] for i in range(n)}
    res[0] = [gts[0][0]]                       # one exact hit
    return gts, res


@pytest.mark.parametrize('name', ['Bleu', 'Meteor', 'Rouge', 'Cider'])
def test_scorer_matches_jax(name):
    gts, res = _corpus(3)
    kw = {'Bleu': (4,)}.get(name, ())
    want = getattr(jax_eval, name)(*kw).compute_score(gts, res)
    got = getattr(port_eval, name)(*kw).compute_score(gts, res)
    assert got == want
    corpus = np.asarray(want[0], float)
    assert np.all(corpus > 0)              # the corpus overlaps somewhere


def test_ptb_tokenize_and_porter_stem_match_jax():
    words = ["Don't", 'stir-fry', 'the', 'PAN;', '"oil"', "80's", '3.5',
             '1,000', 'cooking', 'sliced', 'happily', 'relational',
             'agreed', 'generalization', '(garnish)', 'well...', 'mixes']
    sentence = ' '.join(words)
    assert port_eval.ptb_tokenize(sentence) == jax_eval.ptb_tokenize(sentence)
    for w in words + sentence.split():
        assert port_eval.porter_stem(w.lower()) == \
            jax_eval.porter_stem(w.lower()), w


def _dvc_files(root, seed=0, n_videos=5):
    """A ground-truth file, a paragraph file and a prediction json with the
    records' keys, written under root."""
    rng = np.random.default_rng(seed)
    gt, para, results = {}, {}, {}
    for v in range(n_videos):
        key = f'v_metric{v:05d}'
        duration = float(rng.uniform(40, 200))
        n = int(rng.integers(2, 6))
        starts = np.sort(rng.uniform(0, 0.8, n)) * duration
        ends = np.minimum(starts + rng.uniform(0.05, 0.3, n) * duration,
                          duration)
        sents = [_sentence(rng) for _ in range(n)]
        gt[key] = {'duration': duration, 'sentences': sents,
                   'timestamps': [[float(a), float(b)]
                                  for a, b in zip(starts, ends)]}
        para[key] = ' '.join(sents)
        items = []
        count = int(rng.integers(1, 5))
        for q in range(8):
            a = float(rng.uniform(0, 0.9) * duration)
            b = float(min(a + rng.uniform(0.02, 0.4) * duration, duration))
            items.append({'timestamp': [a, b], 'raw_box': [a, b],
                          'proposal_score': float(rng.uniform()),
                          'sentence': (_sentence(rng) if q % 3 else
                                       sents[q % n]),
                          'sentence_score': float(-rng.uniform(1, 20)),
                          'query_id': q, 'vid_duration': duration,
                          'pred_event_count': count})
        results[key] = items
    paths = {}
    for name, obj in (('gt', gt), ('para', para),
                      ('pred', {'version': 'VERSION 1.0', 'results': results,
                                'external_data': {'used:': True,
                                                  'details': None}})):
        paths[name] = os.path.join(root, f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(obj, f)
    return paths


@pytest.mark.parametrize('version', ['2018', '2021'])
def test_eval_dvc_matches_jax(tmp_path, version):
    paths = _dvc_files(str(tmp_path))
    random.seed(11)                # the 2021 garbage caption draws from it
    want = jax_eval.eval_dvc(paths['pred'], [paths['gt']], version=version)
    random.seed(11)
    got = port_eval.eval_dvc(paths['pred'], [paths['gt']], version=version)
    assert got == want
    assert sorted(want) == ['Bleu_1', 'Bleu_2', 'Bleu_3', 'Bleu_4', 'CIDEr',
                            'METEOR', 'Precision', 'ROUGE_L', 'Recall']
    assert max(want['METEOR']) > 0


@pytest.mark.parametrize('shape', [(1, 1), (3, 7), (6, 4), (9, 9)])
def test_chased_dp_assignment_matches_jax(shape):
    rng = np.random.default_rng(sum(shape))
    scores = rng.uniform(0, 1, shape) * (rng.uniform(0, 1, shape) > 0.3)
    assert port_eval.chased_dp_assignment(scores) == \
        jax_eval.chased_dp_assignment(scores)


def test_eval_soda_and_para_match_jax(tmp_path):
    paths = _dvc_files(str(tmp_path), seed=1)
    want = jax_eval.eval_soda(paths['pred'], ref_list=[paths['gt']])
    assert port_eval.eval_soda(paths['pred'], ref_list=[paths['gt']]) == want
    assert want['soda_c'] > 0
    want = jax_eval.eval_para(paths['pred'], referneces=[paths['para']])
    assert port_eval.eval_para(paths['pred'],
                               referneces=[paths['para']]) == want
    assert want['para_METEOR'] > 0


def _files_of(folder):
    return {name: open(os.path.join(folder, name)).read()
            for name in sorted(os.listdir(folder))}


@pytest.mark.parametrize('rerank', [False, True])
def test_eval_metrics_matches_jax(tmp_path, rerank):
    scores = {}
    for name, module in (('jax', jax_eval_utils), ('port', port_eval_utils)):
        folder = tmp_path / name
        folder.mkdir()
        paths = _dvc_files(str(folder), seed=2)
        scores[name] = dict(module.eval_metrics(
            paths['pred'], [paths['gt']], [paths['para']], alpha=0.3,
            rerank=rerank))
    assert scores['port'] == scores['jax']
    assert scores['jax']['METEOR'] > 0 and scores['jax']['soda_c'] > 0
    # the reranked json, where written, is the same file
    assert _files_of(tmp_path / 'port') == _files_of(tmp_path / 'jax')


def test_reranking_topn_and_save_json_match_jax(tmp_path):
    for name, module in (('jax', jax_eval_utils), ('port', port_eval_utils)):
        folder = tmp_path / name
        folder.mkdir()
        paths = _dvc_files(str(folder), seed=4)
        module.reranking(paths['pred'], alpha=0.3, temperature=2.0)
        module.get_topn_from_dvcjson(paths['pred'],
                                     str(folder / 'top2.json'), top_n=2,
                                     score_thres=0.4)
        module.convert_tapjson_from_dvcjson(paths['gt'],
                                            str(folder / 'tap.json'))
        with open(paths['pred']) as f:
            out = json.load(f)
        out['results'] = dict(list(out['results'].items())[:3])
        module.save_dvc_json(out, str(folder / 'saved.json'))
    got, want = _files_of(tmp_path / 'port'), _files_of(tmp_path / 'jax')
    assert got == want
    assert len(want) == 7          # 3 inputs, reranked, top-2, tap, saved


_FAKE_JAVA = """#!/bin/sh
# stands in for the PTB tokenizer jar: prints the last argument's lines
# lowercased{drop}
for last; do :; done
{cmd} "$last" | tr 'A-Z' 'a-z'; echo
"""


@pytest.mark.parametrize('drop', [False, True])
def test_jar_tokenizer_line_count(tmp_path, monkeypatch, drop):
    """A jar that prints every line is used; one that drops a line is
    refused, and the port falls back to the Python tokenizer instead of
    moving the captions onto other ids."""
    java = tmp_path / 'java'
    java.write_text(_FAKE_JAVA.format(
        drop=', without its first line' if drop else '',
        cmd='tail -n +2' if drop else 'cat'))
    java.chmod(java.stat().st_mode | stat.S_IEXEC)
    jar = tmp_path / 'stanford-corenlp.jar'
    jar.write_text('')
    caps = {0: [{'caption': 'Stir the Onion'}],
            1: [{'caption': 'add salt'}, {'caption': 'Cut the PAN'}],
            2: [], 3: [{'caption': 'heat the oil'}]}
    python = port_eval.tokenize_dict(caps)
    monkeypatch.setenv('PATH', f'{tmp_path}{os.pathsep}{os.environ["PATH"]}')
    monkeypatch.setenv('DVC_PTB_JAR', str(jar))
    got = port_eval.tokenize_dict(caps)
    if drop:
        assert got == python
        # the JAX package's copy zips the short output onto the ids
        assert jax_eval.tokenize_dict(caps) != python
    else:
        assert got == {0: ['stir the onion'],
                       1: ['add salt', 'cut the pan'], 2: [],
                       3: ['heat the oil']}
        assert got == jax_eval.tokenize_dict(caps)
