"""``python -m dvc_tpu_torch.train_tsp`` against the root ``train_tsp.py``
on cv2-written videos and a groundtruth CSV (R3D-18, --clip-len 4, the
clips cropped to 32x32 in both packages):

* from one ``--seed`` both drivers build the same batches, in the same
  order, over two epochs: the clips exactly (the same decode, crop
  offsets and flips), the labels equal (each driver's ``train_step``
  patched to record its batches);
* JAX trains epoch 0 with validation; both drivers resume from its
  ``tsp-last.ckpt`` (weights and SGD momentum) for epoch 1: the
  ``metrics.jsonl`` train losses within 1e-4, the ``results.txt``
  accuracies equal;
* ``--valid-only`` on the port's ``tsp-last.pth`` repeats its epoch-1
  validation line;
* the port's ``tsp-best.pth`` of a run from its own seeded weights is
  read by ``extract_features`` as it is;
* without ``--device cpu`` on a machine with no card the driver raises;
* ``--mesh-data 2`` trains as two gloo ranks (tests/torch_mesh_workers.py),
  rank 0 alone writing the output folder.
"""
import csv
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch

from torch_mesh_workers import spawn, tsp_driver  # noqa: I100
from torch_tsp_env import write_video

from dvc_tpu.data import video_clips as jvc
from dvc_tpu.train import tsp_trainer as jtrain
from dvc_tpu_torch import extract_features, train_tsp
from dvc_tpu_torch.data import video_clips as pvc
from dvc_tpu_torch.train import tsp_trainer as ptrain

pytestmark = pytest.mark.heavy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(resize=(40, 48), crop=(32, 32))


@pytest.fixture
def env(tmp_path, monkeypatch):
    """Three 2 s videos, two segments each, and the common flags."""
    for module in (jvc, pvc):
        monkeypatch.setitem(module.BACKBONE_INPUT, 'r3d_18', SMALL)
    vids = []
    for i in range(3):
        path = tmp_path / f'v_tspdrv{i:05d}.mp4'
        write_video(path, n_frames=60, seed=i)
        vids.append(str(path))
    gt = tmp_path / 'gt.csv'
    with open(gt, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=['filename', 'fps', 't-start',
                                          't-end', 'video-duration',
                                          'action-label',
                                          'temporal-region-label'])
        w.writeheader()
        for i, v in enumerate(vids):
            for t in (0.0, 0.8):
                w.writerow({'filename': v, 'fps': 30, 't-start': t,
                            't-end': t + 1.1, 'video-duration': 2.0,
                            'action-label': (i + int(t > 0)) % 3,
                            'temporal-region-label': (i + 1) % 2})
    flags = ['--train-csv', str(gt), '--backbone', 'r3d_18',
             '--clip-len', '4', '--clips-per-segment', '2',
             '--batch-size', '4', '--backbone-lr', '0.0001',
             '--fc-lr', '0.002', '--seed', '11']
    return tmp_path, flags


def _jax_main(argv):
    spec = importlib.util.spec_from_file_location(
        'train_tsp_jax', os.path.join(ROOT, 'train_tsp.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    try:
        sys.argv = ['train_tsp.py'] + argv
        mod.main()
    finally:
        sys.argv = old


def _recorded(monkeypatch, owner, to_numpy, state=None):
    """Patch ``owner.train_step`` to record each batch and return zero
    losses without computing (and ``init_state`` to return ``state``, where
    one is given, in place of a model)."""
    seen = []

    def record(self, state, batch, iteration):
        seen.append({k: to_numpy(v) for k, v in batch.items()})
        return state, {'total': 0.0, 'head0': 0.0, 'head1': 0.0}
    monkeypatch.setattr(owner, 'train_step', record)
    if state is not None:
        monkeypatch.setattr(owner, 'init_state',
                            lambda self, *a, **k: dict(state))
    return seen


def test_both_drivers_build_the_same_batches(env, monkeypatch):
    tmp, flags = env
    jax_seen = _recorded(monkeypatch, jtrain.TSPTrainer, np.asarray,
                         {'variables': {}, 'opt_state': {}})
    _jax_main(flags + ['--epochs', '2', '--output-dir', str(tmp / 'jax')])
    port_seen = _recorded(monkeypatch, ptrain.TSPTrainer,
                          lambda t: t.numpy())
    train_tsp.main(flags + ['--epochs', '2', '--output-dir',
                            str(tmp / 'port'), '--device', 'cpu'])
    assert len(port_seen) == len(jax_seen) == 2 * (12 // 4)
    for got, want in zip(port_seen, jax_seen):
        assert set(got) == set(want) == {'clip', 'label0', 'label1'}
        assert got['clip'].shape == want['clip'].shape == (4, 4, 32, 32, 3)
        np.testing.assert_array_equal(got['clip'], want['clip'])
        for k in ('label0', 'label1'):
            np.testing.assert_array_equal(got[k], want[k])
    flips = [float(np.abs(b['clip'] - b['clip'][:, :, :, ::-1]).max())
             for b in port_seen]
    assert max(flips) > 0


def _valid_lines(path):
    return [l for l in open(path).read().splitlines()
            if l.startswith('** Valid Epoch')]


def _accuracies(line):
    return [float(a) for a in re.findall(r'Accuracy ([0-9.]+)', line)]


def test_resume_from_a_jax_checkpoint(env):
    """JAX trains and validates epoch 0; each driver resumes from its
    tsp-last.ckpt for epoch 1; then the port's --valid-only and its
    tsp-best.pth through extract_features."""
    tmp, flags = env
    flags = flags + ['--valid-csv', flags[1]]
    _jax_main(flags + ['--epochs', '1', '--output-dir', str(tmp / 'jax0')])
    ckpt = str(tmp / 'jax0' / 'tsp-last.ckpt')
    resume = flags + ['--epochs', '2', '--resume', ckpt]
    _jax_main(resume + ['--output-dir', str(tmp / 'jax1')])
    train_tsp.main(resume + ['--output-dir', str(tmp / 'port'),
                             '--device', 'cpu'])

    def epoch1(folder):
        (rec,) = [json.loads(l) for l in
                  open(tmp / folder / 'metrics.jsonl').read().splitlines()]
        (line,) = _valid_lines(tmp / folder / 'results.txt')
        return rec, line

    (jrec, jline), (prec, pline) = epoch1('jax1'), epoch1('port')
    assert jrec['epoch'] == prec['epoch'] == 1
    assert set(prec['train']) == set(jrec['train']) == {'total', 'head0',
                                                         'head1'}
    for k, v in jrec['train'].items():
        assert abs(prec['train'][k] - v) <= 1e-4 + 1e-9, (k, prec, jrec)
    assert jline.startswith('** Valid Epoch 1:')
    assert _accuracies(pline) == _accuracies(jline)
    assert prec['valid_avg_accuracy'] == jrec['valid_avg_accuracy']

    ck = torch.load(tmp / 'port' / 'tsp-last.pth', weights_only=True)
    assert (ck['epoch'], ck['iteration']) == (1, 6)
    assert set(ck) == {'model', 'optimizer', 'epoch', 'iteration',
                       'best_acc', 'args'}
    train_tsp.main(flags + ['--valid-only', '--output-dir',
                            str(tmp / 'port'), '--device', 'cpu',
                            '--resume', str(tmp / 'port' / 'tsp-last.pth')])
    lines = _valid_lines(tmp / 'port' / 'results.txt')
    assert len(lines) == 2 and lines[1] == lines[0]

    # a run of the port from its own seeded weights writes a tsp-best.pth
    train_tsp.main(flags + ['--epochs', '1', '--output-dir',
                            str(tmp / 'port0'), '--device', 'cpu'])
    best = tmp / 'port0' / 'tsp-best.pth'
    assert torch.load(best, weights_only=True)['epoch'] == 0
    written = extract_features.main(
        ['--video-dir', str(tmp), '--output-dir', str(tmp / 'feats'),
         '--local-checkpoint', str(best), '--backbone', 'r3d_18',
         '--clip-len', '4', '--stride', '8', '--dtype', 'float32',
         '--device', 'cpu'])
    assert len(written) == 3
    for path in written:
        feats = np.load(path)
        assert feats.shape[1] == 512 and np.isfinite(feats).all()


def test_no_card_raises(env):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    tmp, flags = env
    with pytest.raises(RuntimeError, match='no CUDA device'):
        train_tsp.main(flags + ['--output-dir', str(tmp / 'out')])


def test_mesh_data_two_trains_on_two_ranks(env):
    """``train_tsp --mesh-data 2 --train-bn 1`` as two ranks: one output
    folder, written by rank 0 alone; the ranks' final weights equal and
    those of tsp-last.pth; its validation line that of a one-process
    ``--valid-only`` on tsp-last.pth."""
    tmp, flags = env
    out = tmp / 'out'
    flags = flags + ['--valid-csv', flags[1], '--device', 'cpu',
                     '--train-bn', '1']
    ranks = spawn(tsp_driver, 2, tmp / 'ranks', flags + [
        '--mesh-data', '2', '--epochs', '1', '--output-dir', str(out)],
        {'r3d_18': SMALL})
    for key in ranks[0]:
        assert torch.equal(ranks[0][key], ranks[1][key]), key
    assert sorted(os.listdir(out)) == ['metrics.jsonl', 'results.txt',
                                       'tsp-best.pth', 'tsp-last.pth']
    ck = torch.load(out / 'tsp-last.pth', weights_only=True)
    assert (ck['epoch'], ck['iteration']) == (0, 3)
    for key, v in ranks[0].items():
        assert torch.equal(ck['model'][key], v), key
    with open(out / 'metrics.jsonl') as f:
        assert len(f.read().splitlines()) == 1
    (line,) = _valid_lines(out / 'results.txt')
    assert re.findall(r'Accuracy ([0-9.]+)', line)
    train_tsp.main(flags + ['--valid-only', '--output-dir', str(tmp / 'one'),
                            '--resume', str(out / 'tsp-last.pth')])
    assert _valid_lines(tmp / 'one' / 'results.txt') == [line]


def test_head_meters_and_label_mappings_match_jax(tmp_path):
    """The port's meters give the JAX driver's accuracies, losses and
    results line on the same updates; the label mappings are JAX's."""
    spec = importlib.util.spec_from_file_location(
        'train_tsp_units_jax', os.path.join(ROOT, 'train_tsp.py'))
    jmod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmod)
    rng = np.random.default_rng(2)
    cols = ['action-label', 'temporal-region-label']
    got, want = train_tsp.HeadMeters(cols), jmod.HeadMeters(cols)
    for _ in range(3):
        logits = [rng.standard_normal((6, 5)), rng.standard_normal((6, 2))]
        labels = [rng.integers(-1, 5, 6), rng.integers(-1, 2, 6)]
        losses = list(rng.random(2))
        for m in (got, want):
            m.update(logits, labels, losses, sum(losses))
    got.sync()
    assert got.results_line(4) == want.results_line(4)
    assert got.avg_accuracy() == want.avg_accuracy()
    path = tmp_path / 'map.json'
    path.write_text(json.dumps(['grilled cheese', 'pizza']))
    assert train_tsp.load_label_mappings([str(path)]) == \
        jmod.load_label_mappings([str(path)])
