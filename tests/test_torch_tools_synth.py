"""The port's synthetic dataset (``dvc_tpu_torch/tools/synth.py``, which
``bench_epoch`` trains on) writes the same files as the JAX repo's test
fixture ``tests/synth.py`` for the same arguments, byte for byte."""
import os

import pytest
from synth import make_synth_dataset

from dvc_tpu_torch.tools import synth


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.mark.parametrize('seed,n_words', [(0, None), (7, 1607)])
def test_the_ports_dataset_is_the_fixtures(tmp_path, seed, n_words):
    kw = dict(n_videos=5, feat_dim=12, n_frames=30, seed=seed,
              n_words=n_words)
    want = make_synth_dataset(str(tmp_path / 'fixture'), **kw)
    got = synth.make_synth_dataset(str(tmp_path / 'port'), **kw)
    rel = [lambda p, r=r: os.path.relpath(p, r)
           for r in (tmp_path / 'port', tmp_path / 'fixture')]
    assert [rel[0](p) for p in got[:3]] == [rel[1](p) for p in want[:3]]
    assert got[3] == want[3]
    files = _files(tmp_path / 'fixture')
    assert _files(tmp_path / 'port') == files
    # a feature file a 13-character key prefix (YouCook2's rule), so
    # videos 0-9 share one
    assert files == ['features/v_synth000000.npy', 'train.json',
                     'vocab.json']
    for f in files:
        assert (tmp_path / 'port' / f).read_bytes() == \
            (tmp_path / 'fixture' / f).read_bytes(), f
