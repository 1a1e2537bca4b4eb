"""The port's input pipeline (``dvc_tpu_torch.data.prefetch``, the
counterpart of ``dvc_tpu/data/prefetch.py``) and its use by ``new_train``:
``DevicePrefetchLoader`` only reorders work, so the batches, their order
and every loss are those of the plain loop (mirrors
``tests/test_device_prefetch.py``).

On the CPU a prepared batch is the collated arrays wrapped as tensors
(nothing pinned, no stream); the pinned copy on the trainer's copy stream
runs only on a CUDA device (``chip_smoke.py``).  Losses and weights are
compared exactly: the same operations run on the same data in the same
order.
"""
import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from test_torch_train import _synthetic_recipe  # noqa: I100
from torch_port import tiny_opt, train_batch

from dvc_tpu_torch.data import DevicePrefetchLoader, PrefetchLoader
from dvc_tpu_torch.new_train import main as train_main
from dvc_tpu_torch.train import Trainer, load_checkpoint
from dvc_tpu_torch.utils.config import parse_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _items(n=3):
    return [(train_batch(i), {'i': i}) for i in range(n)]


def test_device_prefetch_matches_the_plain_loop():
    """Three Trainer.train_steps: the same batches in the same order, and
    the same losses and weights, with and without the prefetch."""
    opt = tiny_opt()
    items = _items()

    def run(prefetch):
        trainer = Trainer(opt, device='cpu')
        loader = (DevicePrefetchLoader(items, trainer.prepare_batch)
                  if prefetch else items)
        order, losses = [], []
        for batch, meta in loader:
            assert batch.get('_prepared', False) == prefetch
            out = trainer.train_step(batch, 1e-4)
            order.append(meta['i'])
            losses.append({k: float(v) for k, v in out.items()})
        return order, losses, trainer.model.state_dict()

    want_order, want, want_sd = run(False)
    got_order, got, got_sd = run(True)
    assert got_order == want_order == [0, 1, 2]
    assert got == want
    for k, v in want_sd.items():
        assert torch.equal(got_sd[k], v), k


def test_prepared_batches_are_marked_and_bucketed():
    trainer = Trainer(tiny_opt(), device='cpu')
    raw = train_batch(0)
    prepared = trainer.prepare_batch(dict(raw))
    assert prepared.pop('_prepared') is True and '_ready' not in prepared
    # caption-length bucketing, and the arrays as CPU tensors
    assert prepared['cap_tensor'].shape[-1] <= raw['cap_tensor'].shape[-1]
    assert all(isinstance(v, torch.Tensor) and v.device.type == 'cpu'
               and not v.is_pinned() for v in prepared.values())
    eval_prepared = trainer.prepare_eval_batch(dict(raw))
    assert eval_prepared['cap_tensor'].shape == raw['cap_tensor'].shape
    # the eval step takes either form and gives the same losses
    _, want = trainer.eval_step(raw)
    _, got = trainer.eval_step(eval_prepared)
    assert {k: float(v) for k, v in got.items()} == \
        {k: float(v) for k, v in want.items()}


def test_worker_exceptions_reach_the_consumer():
    def bad():
        yield ({'x': np.zeros(2)}, {'i': 0})
        raise RuntimeError('boom')

    with pytest.raises(RuntimeError, match='boom'):
        list(PrefetchLoader(bad()))
    with pytest.raises(RuntimeError, match='boom'):
        list(DevicePrefetchLoader(bad(), dict))


@pytest.mark.parametrize('loader', ['host', 'device'])
def test_an_early_break_reaps_the_worker(loader):
    """Abandoning the loader mid-epoch (a --debug break, an exception in
    the step) must not leave the worker parked in its queue."""
    items = [({'x': np.zeros(4)}, {'i': i}) for i in range(50)]
    before = threading.active_count()
    for _ in range(5):
        it = (PrefetchLoader(items) if loader == 'host'
              else DevicePrefetchLoader(items, dict))
        for j, _item in enumerate(it):
            if j == 1:
                break
    gc.collect()
    deadline = time.monotonic() + 5
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def _epoch_lines(folder):
    with open(os.path.join(folder, 'train.log')) as f:
        return [line.split('] ', 1)[1].rsplit(' (', 1)[0] for line in f
                if '] epoch ' in line and 'steps' in line]


@pytest.mark.heavy
def test_new_train_is_the_same_with_and_without_prefetch(tmp_path):
    """new_train.main --device cpu, two --debug epochs under
    --device_prefetch 0 and 1: the same per-epoch losses, weights and
    validation records (its evaluate prefetches too)."""
    runs = {}
    for prefetch in (0, 1):
        root = tmp_path / f'p{prefetch}'
        root.mkdir()
        opt = parse_opts(['--cfg_path', _synthetic_recipe(root), '--debug',
                          '--device', 'cpu', '--device_prefetch',
                          str(prefetch)], root=REPO)
        opt.epoch = 2
        folder, losses = train_main(opt)
        with open(os.path.join(folder, 'epoch2.json')) as f:
            records = json.load(f)['results']
        weights = load_checkpoint(os.path.join(folder, 'model-last.pth'))
        runs[prefetch] = (_epoch_lines(folder), losses, records,
                          weights['model'])
    (lines0, loss0, rec0, sd0), (lines1, loss1, rec1, sd1) = runs[0], runs[1]
    assert len(lines0) == 2 and lines1 == lines0
    assert loss1 == loss0 and all(np.isfinite(v) for v in loss0.values())
    assert rec1 == rec0
    for k, v in sd0.items():
        assert torch.equal(sd1[k], v), k
