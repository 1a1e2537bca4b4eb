"""``python -m dvc_tpu_torch.tools.bench_extract`` on the CPU: the JAX
repo's ``tools/bench_extract.py``'s keys (``platform`` and ``device`` in
place of ``backend``), a positive two-point step time, the FLOPs of a
forward, and ``--profile`` saying the CPU has no device activity.  The
FLOP count is held to MViTv2's block table (``mvit_macs``): the counter
sees every product but the CLS key column's attention-value product, which
the backbone computes as a broadcast multiply.  The times themselves are
the CPU's and say nothing of a card.
"""
import ast
import json
import os

import pytest
import torch

from dvc_tpu_torch.models.tsp import FeatureExtractor
from dvc_tpu_torch.models.tsp.backbones import (MViTConfig, mvit_block_specs,
                                                mvit_macs, patch_grid, pooled)
from dvc_tpu_torch.tools import bench_extract
from dvc_tpu_torch.utils.roofline import forward_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {'backbone', 'batch', 'dtype', 'protocol', 'step_ms', 'ms_per_clip',
        'clips_per_sec', 'gflops_per_clip', 'mfu'}
TINY = MViTConfig(embed_dim=8, depths=(1, 2), heads=(1, 2), temporal_size=4,
                  spatial_size=224, feature_dim=16)
SMALL = ['--device', 'cpu', '--batch', '2', '--clip-len', '4', '--n1', '1',
         '--n2', '4']


def test_the_keys_are_the_jax_tools():
    src = open(os.path.join(REPO, 'tools', 'bench_extract.py')).read()
    names = {n.value for n in ast.walk(ast.parse(src))
             if isinstance(n, ast.Constant) and isinstance(n.value, str)}
    assert KEYS | {'backend'} <= names


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_a_small_backbone_gives_the_jax_tools_keys(capsys, dtype):
    row = bench_extract.main([*SMALL, '--dtype', dtype], config=TINY)
    out = capsys.readouterr().out.strip().splitlines()
    assert json.loads(out[-1]) == row
    assert set(row) == KEYS | {'platform', 'device'}
    assert (row['platform'], row['device'], row['dtype']) == \
        ('cpu', 'cpu', dtype)
    assert row['step_ms'] > 0 and row['clips_per_sec'] > 0
    assert row['ms_per_clip'] == pytest.approx(row['step_ms'] / 2, rel=1e-3)
    # no data-sheet peak on the CPU
    assert row['mfu'] is None
    ex = FeatureExtractor('mvit_v2_s', clip_len=4, dtype='float32',
                          device='cpu', config=TINY)
    x = torch.zeros(2, 3, 4, 224, 224)
    assert row['gflops_per_clip'] == round(forward_flops(ex.model, x) / 2e9,
                                           3)


def cls_value_macs(cfg):
    """The multiply-adds of each block's CLS key column times its value
    (heads x (1 + queries) x head width), a broadcast multiply in the
    backbone."""
    thw, macs = patch_grid(cfg), 0
    for s in mvit_block_specs(cfg):
        q = pooled(thw, s.q_stride)
        macs += s.heads * (1 + q[0] * q[1] * q[2]) * (s.out_ch // s.heads)
        thw = q
    return macs


@pytest.mark.parametrize('cfg', [
    TINY, MViTConfig(embed_dim=8, depths=(1, 2, 1), heads=(1, 2, 4),
                     temporal_size=4, spatial_size=64, feature_dim=16)])
def test_forward_flops_is_the_block_table_but_the_cls_value_product(cfg):
    ex = FeatureExtractor('mvit_v2_s', clip_len=cfg.temporal_size,
                          dtype='float32', device='cpu', config=cfg)
    x = torch.zeros(1, 3, cfg.temporal_size, cfg.spatial_size,
                    cfg.spatial_size)
    table = 2 * mvit_macs(cfg)
    counted = forward_flops(ex.model, x)
    assert counted == table - 2 * cls_value_macs(cfg)
    assert 0 < (table - counted) / table < 3e-3


def test_profile_on_the_cpu_reports_no_device_activity(tmp_path, capsys):
    bench_extract.main([*SMALL, '--dtype', 'float32', '--profile',
                        str(tmp_path)], config=TINY)
    out = capsys.readouterr().out
    summary = json.loads(out[out.index('{\n'):])
    assert summary['device_activity'] is False
    assert 'no device activity' in summary['note']
    assert 'top_ops_ms' not in summary and 'idle' not in summary
    with open(tmp_path / 'trace.json') as f:
        names = {e.get('name') for e in json.load(f)['traceEvents']}
    assert 'bench_extract mvit_v2_s float32 x6' in names


def test_no_card_and_no_device_cpu_raises():
    assert not torch.cuda.is_available()
    with pytest.raises(SystemExit, match='no CUDA device'):
        bench_extract.main(['--batch', '1'])
