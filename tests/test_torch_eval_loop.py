"""Port parity of the evaluation path: ``dvc_tpu_torch.eval.evaluate``
over a tiny FusionPDVC against ``dvc_tpu.eval.evaluate`` on the same
weights (``from_jax_params``) and the same synthetic val set; the
validation of ``dvc_tpu_torch.new_train`` (``epoch1.json``,
``model-best.pth``, ``info.json``); and ``dvc_tpu_torch.run_eval`` on a
port run and on a JAX run folder, in eval and test mode, and in a
subprocess that imports neither JAX nor ``dvc_tpu``.

Tolerances: record timestamps and scores rtol/atol 2e-4 (the repo's
torch-parity tolerance), captions, query ids and event counts identical;
the eval step's losses 1e-4 relative; ``evaluate``'s mean losses, which
both packages round to 3 decimals, within one unit of that rounding; each
score 1e-5.
"""
import json
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from synth import WORDS  # noqa: I100
from torch_port import fusion_batch, jax_fusion_params, tiny_opt, to_torch

from dvc_tpu.data.fusion_dataset import FusionBatchLoader as JaxLoader
from dvc_tpu.data.fusion_dataset import FusionDataset as JaxDataset
from dvc_tpu.eval import evaluate as jax_evaluate
from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from dvc_tpu.train.trainer import save_info_json as jax_save_info_json
from dvc_tpu_torch import run_eval
from dvc_tpu_torch.data import FusionBatchLoader, FusionDataset
from dvc_tpu_torch.eval import evaluate
from dvc_tpu_torch.models import from_jax_params
from dvc_tpu_torch.new_train import main as train_main
from dvc_tpu_torch.serve import DenseCaptioner
from dvc_tpu_torch.train import Trainer, load_checkpoint
from dvc_tpu_torch.utils.config import parse_opts

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)
SCORES = ('METEOR', 'soda_c', 'para_METEOR', 'Recall', 'Precision',
          'Bleu_4', 'CIDEr')


def _varied(params, seed=0, scale=0.1):
    """params with every all-zero kernel of the flax init (sampling offsets
    and attention weights, the last box layer) drawn at random, so that
    the predictions depend on the video."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        x = np.asarray(x)
        if getattr(path[-1], 'key', '').endswith(('kernel', '_w')) \
                and x.ndim == 2 and not x.any():
            return (rng.standard_normal(x.shape) * scale).astype(x.dtype)
        return x
    return jax.tree_util.tree_map_with_path(draw, params)


def _write_data(root, n_videos=5):
    """Synthetic val set: 13-character keys (one feature file each), 30-50
    clip features with a planted event signature, durations of 40-200 s,
    2-3 events a video (no gt subsampling at G=3), cached sound for 3
    videos, a vocabulary and the paragraph gt file."""
    rng = np.random.default_rng(3)
    feats, sound = root / 'features', root / 'sound'
    feats.mkdir()
    sound.mkdir()
    words = sorted(set(WORDS))
    vocab = root / 'vocab.json'
    vocab.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    data = {}
    for v in range(n_videos):
        key = f'v_eval{v:07d}'
        n, duration = int(rng.integers(30, 50)), float(rng.uniform(40, 200))
        x = rng.standard_normal((n, 16)).astype(np.float32)
        k = int(rng.integers(2, 4))
        starts = np.sort(rng.uniform(0, 0.7, k))
        ends = np.minimum(starts + rng.uniform(0.1, 0.3, k), 1.0)
        for j, (a, b) in enumerate(zip(starts, ends)):
            x[int(a * n):max(int(b * n), int(a * n) + 1), j] += 2.0
        np.save(feats / f'{key}.npy', x)
        if v < 3:
            np.save(sound / f'{key}.npy',
                    rng.standard_normal((n, 16)).astype(np.float32))
        data[key] = {'duration': duration,
                     'timestamps': [[float(a * duration), float(b * duration)]
                                    for a, b in zip(starts, ends)],
                     'sentences': [' '.join(rng.choice(words, int(
                         rng.integers(3, 7)))) for _ in range(k)]}
    anno = root / 'val.json'
    anno.write_text(json.dumps(data))
    anno = str(anno)
    para = root / 'para.json'
    para.write_text(json.dumps({k: ' '.join(v['sentences'])
                                for k, v in data.items()}))
    return dict(train_caption_file=anno, val_caption_file=anno,
                gt_file_for_eval=[anno], gt_file_for_para_eval=[str(para)],
                dict_file=str(vocab), vocab_size=len(words),
                visual_feature_type='tsp', visual_feature_folder=str(feats),
                invalid_video_json=[],
                sound_feature_folder=str(sound), feature_dim=16,
                frame_embedding_num=24, gt_proposal_sample_num=3,
                max_caption_len=8)


@pytest.fixture(scope='module')
def val(tmp_path_factory):
    """(opt, flax params, JAX evaluate's (scores, losses, records)) of a
    tiny FusionPDVC on the synthetic val set, at B=2 (its last batch
    repeats a video)."""
    root = tmp_path_factory.mktemp('val')
    opt = tiny_opt(**_write_data(root), count_loss_coef=0.5,
                   batch_size_for_eval=2, device_prefetch=0)
    params = _varied(jax_fusion_params(opt, fusion_batch(0), seed=1))
    ds = JaxDataset(opt.val_caption_file, opt.visual_feature_folder,
                    opt.dict_file, False, opt)
    trainer = JaxTrainer(opt, model=jax_make_fusion(opt))
    path = str(root / 'jax.json')
    scores, losses = jax_evaluate(
        trainer, {'params': jax.tree_util.tree_map(jnp.asarray, params)},
        JaxLoader(ds, opt.batch_size_for_eval, False, opt), path,
        alpha=opt.ec_alpha, dvc_eval_version=opt.eval_tool_version)
    batch, _ = next(iter(JaxLoader(ds, 2, False, opt)))
    _, step_losses = trainer.eval_step(
        {'params': jax.tree_util.tree_map(jnp.asarray, params)}, batch)
    return dict(opt=opt, params=params, root=root, scores=dict(scores),
                losses=dict(losses), step_losses=step_losses, batch=batch,
                records=json.load(open(path))['results'])


def _port_trainer(opt, params):
    trainer = Trainer(opt, device='cpu')
    trainer.model.load_state_dict(
        {k: to_torch(v) for k, v in from_jax_params(params).items()},
        strict=True)
    return trainer


def _assert_same_records(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert len(got[key]) == len(want[key]) >= 1, key
        for g, w in zip(got[key], want[key]):
            for k in ('sentence', 'query_id', 'pred_event_count'):
                assert g[k] == w[k], (key, k)
            np.testing.assert_allclose(
                g['timestamp'] + [g['proposal_score'], g['sentence_score'],
                                  g['vid_duration']],
                w['timestamp'] + [w['proposal_score'], w['sentence_score'],
                                  w['vid_duration']], err_msg=key, **TOL)


def _assert_same_scores(got, want):
    for k in SCORES:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    assert want['METEOR'] > 0 and want['Recall'] > 0


def test_evaluate_matches_jax(val, tmp_path):
    opt = val['opt']
    trainer = _port_trainer(opt, val['params'])
    ds = FusionDataset(opt.val_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt)
    path = str(tmp_path / 'port.json')
    scores, losses = evaluate(trainer, FusionBatchLoader(ds, 2, False, opt),
                              path, alpha=opt.ec_alpha,
                              dvc_eval_version=opt.eval_tool_version)
    got = json.load(open(path))
    _assert_same_records(got['results'], val['records'])
    assert any(e['sentence'] for v in got['results'].values() for e in v)
    _assert_same_scores(scores, val['scores'])
    assert got['valid_video_num'] == 5 and got['METEOR'] == scores['METEOR']

    # the eval step's losses on one batch, then evaluate's rounded means
    _, step = trainer.eval_step(val['batch'])
    assert sorted(step) == sorted(val['step_losses'])
    assert 'loss_ce_0' in step and not any('caption' in k for k in step)
    for k, v in val['step_losses'].items():
        np.testing.assert_allclose(float(step[k]), float(v), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    assert sorted(losses) == sorted(val['losses'])
    for k, v in val['losses'].items():
        assert abs(losses[k] - v) <= 1e-3 + 1e-9, k


def _recipe(root, **over):
    cfg = dict(base_cfg_path='cfgs/yc2_newModel_sound.yml', id='tiny',
               save_dir=str(root / 'save'), **_write_data(root),
               hidden_dim=64, nheads=4, enc_layers=1, dec_layers=2,
               transformer_ff_dim=64, num_queries=8, input_encoding_size=32,
               rnn_size=64, att_hid_size=32, cap_nheads=2, batch_size=2,
               epoch=1, max_eseq_length=8, fusion_heads=4, **over)
    path = root / 'tiny.yml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope='module')
def port_run(tmp_path_factory):
    """A port run folder: new_train.main --debug for one epoch on the
    CPU, which validates after it."""
    root = tmp_path_factory.mktemp('port_run')
    opt = parse_opts(['--cfg_path', _recipe(root), '--debug', '--device',
                      'cpu'], root=REPO)
    folder, _ = train_main(opt)
    return folder


def test_new_train_validates_and_keeps_the_best(port_run):
    folder = port_run
    names = set(os.listdir(folder))
    assert {'epoch1.json', 'model-best.pth', 'model-last.pth', 'info.json',
            'train.log'} <= names
    info = json.load(open(os.path.join(folder, 'info.json')))
    history = info['val_history']['1']
    assert np.isfinite(history['METEOR']) and np.isfinite(history['soda_c'])
    assert info['best_val_score'] == history['METEOR'] + history['soda_c']
    assert info['best']['epoch'] == info['last']['epoch'] == 1
    dvc = json.load(open(os.path.join(folder, 'epoch1.json')))
    assert dvc['valid_video_num'] == 5 and dvc['METEOR'] == history['METEOR']
    best = load_checkpoint(os.path.join(folder, 'model-best.pth'))
    last = load_checkpoint(os.path.join(folder, 'model-last.pth'))
    assert best['epoch'] == 1
    for k, v in best['model'].items():
        assert torch.equal(v, last['model'][k]), k
    assert 'validation loss' in open(os.path.join(folder, 'train.log')).read()

    dc = DenseCaptioner(folder, device='cpu')         # which='best'
    rng = np.random.default_rng(1)
    events = dc.caption_features(
        rng.standard_normal((30, 16)).astype(np.float32), 45.0,
        sound=rng.standard_normal((30, 16)).astype(np.float32))
    assert events and all(isinstance(e['sentence'], str) for e in events)


def _check_dvc_json(path, n_videos=5, scored=True):
    out = json.load(open(path))
    assert out['valid_video_num'] == n_videos
    for events in out['results'].values():
        for e in events:
            assert 0 <= e['timestamp'][0] <= e['timestamp'][1] \
                <= e['vid_duration'] * (1 + 1e-6)
            assert isinstance(e['sentence'], str)
    assert ('METEOR' in out) == scored
    return out


@pytest.mark.parametrize('mode', ['eval', 'test'])
def test_run_eval_on_a_port_run(port_run, mode):
    path, scores = run_eval.main(['--eval_save_dir', port_run, '--eval_mode',
                                  mode, '--eval_device', 'cpu'])
    name = 'eval_results.json' if mode == 'eval' else 'dvc_results.json'
    assert path == os.path.join(port_run, name)
    out = _check_dvc_json(path, scored=mode == 'eval')
    if mode == 'eval':
        assert np.isfinite(scores['METEOR']) and out['soda_c'] == \
            scores['soda_c']
        # the best weights on the val set new_train scored them on
        epoch1 = json.load(open(os.path.join(port_run, 'epoch1.json')))
        _assert_same_records(out['results'], epoch1['results'])
    else:
        assert scores is None


def test_run_eval_samples_under_the_sampling_flags(port_run):
    """--caption_sample_max 0 --caption_sample_temperature T: the captions
    come from the stepwise word steps (never the fused greedy decode),
    from a generator seeded with the run's seed, so a second run repeats
    them."""
    from dvc_tpu_torch.ops import dsa_greedy_scan_ref
    from dvc_tpu_torch.ops.dsa_step import sample_attend_table_ref
    args = ['--eval_save_dir', port_run, '--eval_mode', 'test',
            '--eval_device', 'cpu']
    sampled = ['--caption_sample_max', '0', '--caption_sample_temperature',
               '0.5']
    calls = (dsa_greedy_scan_ref.calls, sample_attend_table_ref.calls)
    runs = [_check_dvc_json(run_eval.main(args + sampled)[0], scored=False)
            for _ in range(2)]
    assert dsa_greedy_scan_ref.calls == calls[0]
    assert sample_attend_table_ref.calls > calls[1]
    greedy = _check_dvc_json(run_eval.main(args)[0], scored=False)
    assert runs[0]['results'] == runs[1]['results']

    def sentences(out):
        return sorted(e['sentence'] for v in out['results'].values()
                      for e in v)
    assert sentences(runs[0]) != sentences(greedy)


@pytest.fixture(scope='module')
def jax_run(val, tmp_path_factory):
    """A run folder as the JAX trainer writes it, of ``val``'s weights."""
    folder = str(tmp_path_factory.mktemp('jax_run'))
    params = val['params']
    state = {'params': params, 'opt_state': optax.adamw(1e-4).init(params),
             'step': jnp.asarray(3, jnp.int32)}
    jax_save_checkpoint(folder, 'best', state, epoch=2)
    jax_save_info_json(folder, {'best': {'epoch': 2,
                                         'opt': val['opt'].to_dict()}})
    return folder


def test_run_eval_on_a_jax_run_matches_jax_evaluate(val, jax_run):
    path, scores = run_eval.main(['--eval_save_dir', jax_run,
                                  '--eval_device', 'cpu'])
    out = _check_dvc_json(path)
    _assert_same_records(out['results'], val['records'])
    _assert_same_scores(scores, val['scores'])


def test_run_eval_evaluates_a_run_trained_on_a_data_mesh(val, jax_run,
                                                        tmp_path):
    """A JAX run trained with ``--tpu_mesh_data 2`` evaluates on one
    device: the mesh splits only training (the port's drivers train it
    on ranks, ``dvc_tpu_torch.parallel``); run_eval builds its Trainer
    from the saved options all the same, in one process."""
    folder = str(tmp_path / 'mesh_run')
    shutil.copytree(jax_run, folder)
    path = os.path.join(folder, 'info.json')
    info = json.load(open(path))
    info['best']['opt']['tpu_mesh_data'] = 2
    json.dump(info, open(path, 'w'))
    out = _check_dvc_json(run_eval.main(['--eval_save_dir', folder,
                                         '--eval_device', 'cpu'])[0])
    _assert_same_records(out['results'], val['records'])


def test_run_eval_evaluates_a_streaming_run(tmp_path):
    """A streaming run (``--streaming_features 1``, in-process TSP
    extraction) evaluates: run_eval featurizes the videos of its
    ``video_folder`` (R3D-18, clip_len 4, seeded random weights) on the
    CPU and scores them, writing no feature file; the video without a
    file gets zero features.  (Plain PDVC runs in general:
    tests/test_torch_run_train.py; the streaming train path:
    tests/test_torch_streaming.py.)"""
    pytest.importorskip('cv2')
    from torch_tsp_env import STREAM_PDVC, write_stream_env

    from dvc_tpu_torch.models import make_pdvc_model
    from dvc_tpu_torch.new_train import save_info_json
    from dvc_tpu_torch.train import save_checkpoint
    from dvc_tpu_torch.utils.config import load_config
    over = dict(STREAM_PDVC, **write_stream_env(tmp_path), device='cpu')
    opt = load_config(over.pop('base_cfg_path'), root=REPO, **over)
    folder = str(tmp_path / 'run')
    trainer = Trainer(opt, device='cpu',
                      model=make_pdvc_model(opt, 'cpu', seed=0))
    save_checkpoint(folder, 'best', trainer, 1)
    save_info_json(folder, {'best': {'epoch': 1, 'opt': opt.to_dict()}})
    path, scores = run_eval.main(['--eval_save_dir', folder, '--eval_device',
                                  'cpu', '--eval_batch_size', '4'])
    out = json.load(open(path))
    assert sorted(out['results']) == sorted(
        json.load(open(opt.val_caption_file)))
    assert all(np.isfinite(scores[k]) for k in SCORES)
    assert not [f for _, _, files in os.walk(tmp_path) for f in files
                if f.endswith('.npy')]


_NO_JAX = """
import json, os, runpy, sys
sys.argv = ['run_eval', '--eval_save_dir', sys.argv[1], '--eval_device',
            'cpu', '--eval_mode', 'test', '--eval_batch_size', '3']
runpy.run_module('dvc_tpu_torch.run_eval', run_name='__main__')
pkg = os.path.join(os.getcwd(), 'dvc_tpu') + os.sep
print(json.dumps(sorted(
    n for n, m in list(sys.modules.items())
    if n.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'dvc_tpu')
    or (getattr(m, '__file__', None) or '').startswith(pkg))))
"""


def test_run_eval_imports_neither_jax_nor_the_jax_package(jax_run):
    proc = subprocess.run([sys.executable, '-c', _NO_JAX, jax_run],
                          capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
    _check_dvc_json(os.path.join(jax_run, 'dvc_results.json'), scored=False)
