"""``python -m dvc_tpu_torch.tools.bench_epoch`` on the CPU against the
JAX repo's ``tools/bench_epoch.py``.

``--loader-only`` of both tools on the same synthetic dataset gives the
same record and the same batches an epoch; a ``--tiny`` training run
gives the JAX tool's training keys (the validation's only with
validation, the step-rate ratio only with ``--step-rate``), each record
naming its device; with no card and no ``--device cpu`` the tool
raises.  The times themselves are the CPU's and say nothing of a card.
"""
import ast
import importlib.util
import json
import os

import pytest
import torch

from dvc_tpu_torch.data import dataset as port_dataset
from dvc_tpu_torch.tools import bench_epoch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, 'tools', 'bench_epoch.py')
SMALL = ['--tiny', '--n-videos', '8', '--val-videos', '4', '--batch', '4',
         '--epochs', '2', '--feat-dim', '16', '--frames', '30']
LOADER_KEYS = {'metric', 'n_videos', 'batch', 'ms_per_batch_by_epoch',
               'videos_per_sec_by_epoch', 'host_videos_per_sec'}
TRAIN_KEYS = {'metric', 'n_videos', 'batch', 'epochs', 'steps_per_dispatch',
              'streaming', 'dataset_gen_s', 'total_wall_s',
              'train_videos_per_sec_by_epoch', 'train_loop_s_by_epoch',
              'steady_state_train_videos_per_sec'}
EVAL_KEYS = {'steady_epoch_wall_s', 'eval_ckpt_overhead_s',
             'sustained_videos_per_sec_incl_eval'}
STEP_RATE_KEYS = {'compiled_step_videos_per_sec', 'pipeline_efficiency'}


def test_the_keys_are_the_jax_tools():
    names = {n.value for n in ast.walk(ast.parse(open(JAX_TOOL).read()))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert LOADER_KEYS | TRAIN_KEYS | EVAL_KEYS | STEP_RATE_KEYS \
        | {'host_headroom_over_step'} <= names


def _counting(cls, counts):
    """``cls.__iter__`` that appends the batches of each pass to counts."""
    iterate = cls.__iter__

    def counted(self):
        n = 0
        for batch in iterate(self):
            n += 1
            yield batch
        counts.append(n)
    return counted


def test_loader_only_is_the_jax_tools(tmp_path, monkeypatch):
    from dvc_tpu.data import dataset as jax_dataset
    spec = importlib.util.spec_from_file_location('jax_bench_epoch',
                                                  JAX_TOOL)
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    counts = {'jax': [], 'port': []}
    monkeypatch.setattr(jax_dataset.BatchLoader, '__iter__',
                        _counting(jax_dataset.BatchLoader, counts['jax']))
    monkeypatch.setattr(port_dataset.BatchLoader, '__iter__',
                        _counting(port_dataset.BatchLoader, counts['port']))
    want = jax_tool.main([*SMALL, '--loader-only', '--step-rate', '50',
                          '--workdir', str(tmp_path / 'jax')])
    got = bench_epoch.main([*SMALL, '--loader-only', '--step-rate', '50',
                            '--device', 'cpu', '--workdir',
                            str(tmp_path / 'port')])
    assert set(want) == LOADER_KEYS | {'compiled_step_videos_per_sec',
                                       'host_headroom_over_step'}
    assert set(got) == set(want) | {'device'} and got['device'] == 'cpu'
    assert counts['port'] == counts['jax'] == [2, 2]
    for k in ('metric', 'n_videos', 'batch', 'compiled_step_videos_per_sec'):
        assert got[k] == want[k], k
    assert len(got['videos_per_sec_by_epoch']) == 2
    assert got['host_videos_per_sec'] > 0


@pytest.mark.parametrize('skip_eval,step_rate', [(False, None), (True, 50.0)])
def test_a_tiny_training_run_gives_the_jax_tools_keys(tmp_path, capsys,
                                                      skip_eval, step_rate):
    argv = [*SMALL, '--device', 'cpu', '--workdir', str(tmp_path),
            '--out', str(tmp_path / 'rec.json')]
    argv += ['--skip-eval'] * skip_eval
    argv += ['--step-rate', str(step_rate)] if step_rate else []
    rec = bench_epoch.main(argv)
    want = TRAIN_KEYS | (set() if skip_eval else EVAL_KEYS) \
        | (STEP_RATE_KEYS if step_rate else set())
    assert set(rec) == want | {'device'}
    assert rec['device'] == 'cpu' and rec['metric'] == \
        'end_to_end_epoch_throughput'
    assert len(rec['train_videos_per_sec_by_epoch']) == 2
    assert rec['steady_state_train_videos_per_sec'] == \
        rec['train_videos_per_sec_by_epoch'][1] > 0
    run = tmp_path / 'save' / 'epoch_bench'
    assert sorted(p.name for p in run.glob('epoch*.json')) == (
        [] if skip_eval else ['epoch1.json', 'epoch2.json'])
    if not skip_eval:
        assert rec['sustained_videos_per_sec_incl_eval'] > 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(out) == rec == json.loads((tmp_path / 'rec.json')
                                                .read_text())


@pytest.mark.parametrize('mode', [[], ['--loader-only']])
def test_no_card_and_no_device_cpu_raises(tmp_path, mode):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match='no CUDA device'):
        bench_epoch.main([*SMALL, *mode, '--workdir', str(tmp_path)])
