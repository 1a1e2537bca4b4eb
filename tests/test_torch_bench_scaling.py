"""``python -m dvc_tpu_torch.tools.bench_scaling`` on gloo ranks on the
CPU (``--virtual``), as ``tests/test_bench_scaling.py`` drives the JAX
repo's ``tools/bench_scaling.py`` on its virtual mesh: each sweep point's
ranks, the per-card batch scaling, the two-point timing, the efficiency
and all-reduce summary with the JAX tool's keys (and ``device``), and the
refusals.  The times are the CPU's and say nothing of a card.
"""
import ast
import os

import pytest
import torch

from dvc_tpu_torch.tools import bench_scaling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROW_KEYS = {'chips', 'batch_global', 'step_ms', 'videos_per_sec',
            'videos_per_sec_per_chip', 'scaling_efficiency',
            'psum_overhead_ms'}
SUMMARY_KEYS = {'metric', 'model', 'virtual', 'baseline_chips', 'platform',
                'rows'}
SMALL = ['--virtual', '2', '--batch-per-chip', '2', '--n1', '1', '--n2',
         '2', '--device', 'cpu']


def test_the_keys_are_the_jax_tools():
    src = open(os.path.join(REPO, 'tools', 'bench_scaling.py')).read()
    names = {n.value for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert ROW_KEYS | SUMMARY_KEYS <= names


def test_virtual_sweep_of_the_plain_model():
    summary = bench_scaling.main([*SMALL, '--chips', '1', '2', '--model',
                                  'pdvc'])
    assert set(summary) == SUMMARY_KEYS | {'device'}
    rows = summary['rows']
    assert [r['chips'] for r in rows] == [1, 2]
    for r in rows:
        assert set(r) == ROW_KEYS
        assert r['batch_global'] == 2 * r['chips']
        assert r['step_ms'] > 0 and r['videos_per_sec'] > 0
    assert rows[0]['scaling_efficiency'] == 1.0
    assert rows[0]['psum_overhead_ms'] == 0.0
    assert (summary['platform'], summary['device'], summary['virtual'],
            summary['baseline_chips'], summary['model']) == \
        ('cpu', 'cpu', True, 1, 'pdvc')


def test_one_fusion_point_on_two_ranks(tmp_path):
    summary = bench_scaling.main([*SMALL, '--chips', '2', '--out',
                                  str(tmp_path / 'sweep.json')])
    assert summary['model'] == 'fusion' and summary['baseline_chips'] == 2
    assert [r['chips'] for r in summary['rows']] == [2]
    assert summary['rows'][0]['scaling_efficiency'] == 1.0
    assert (tmp_path / 'sweep.json').exists()


@pytest.mark.parametrize('argv,message', [
    ([*SMALL, '--chips', '4'], 'asked for 4 devices, only 2 visible'),
    (['--chips', '1'], 'no CUDA device'),
    (['--virtual', '2'], '--virtual runs gloo ranks on the CPU'),
    (['--device', 'cpu', '--chips', '2'], 'asked for 2 devices, only 1'),
])
def test_refusals(argv, message):
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match=message):
        bench_scaling.main(argv)
