"""The run folder of the port's ``run_train`` against ``train.py``'s:
``MetricsWriter`` lines byte for byte against the JAX package's writer
given the same calls; the tags and steps of ``metrics.jsonl`` after two
--debug epochs (each validated) on the same tiny plain-PDVC recipe,
equal to those ``train.py``'s ``train`` writes, at --steps_per_dispatch 1
and 2; the ``backup/`` folder (``cfgs/``, the package without
``__pycache__`` or ``_build/``, the top-level ``.py`` files) and the
option table in ``train.log``.  The values are the run's own (its losses
and scores are held to JAX's by tests/test_torch_run_train.py).
"""
import json
import math
import os
import sys

import numpy as np
import pytest

from test_torch_run_train import write_recipe  # noqa: I100

from dvc_tpu.utils.config import load_config as jax_load_config
from dvc_tpu.utils.logging import MetricsWriter as JaxMetricsWriter
from dvc_tpu_torch.run_train import main as train_main
from dvc_tpu_torch.utils.config import parse_opts
from dvc_tpu_torch.utils.logging import MetricsWriter

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)          # train.py, as tests/test_driver_e2e.py


def test_metrics_writer_lines_equal_jax(tmp_path):
    calls = [('lr', 1e-4, 0), ('videos_per_sec', np.float32(12.5), 2),
             ('train/loss', 3, np.int64(2)), ('val/METEOR', 0.1234567891, 4)]
    files = []
    for name, writer in (('jax', JaxMetricsWriter), ('port', MetricsWriter)):
        w = writer(str(tmp_path / name))
        for c in calls:
            w.add_scalar(*c)
        w.close()
        files.append((tmp_path / name / 'metrics.jsonl').read_bytes())
    assert files[0] == files[1]
    assert len(files[0].splitlines()) == len(calls)


def _tags_and_steps(folder):
    lines = [json.loads(x) for x in
             open(os.path.join(folder, 'metrics.jsonl')).read().splitlines()]
    assert all(math.isfinite(x['value']) for x in lines)
    return [(x['tag'], x['step']) for x in lines]


@pytest.mark.parametrize('K', [1, 2])
def test_run_train_writes_the_run_folder_of_train_py(tmp_path, K):
    recipe = write_recipe(tmp_path, 'light', epoch=2,
                          save_checkpoint_every=1, min_epoch_when_save=0,
                          steps_per_dispatch=K, device_prefetch=0)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu'],
                     root=REPO)
    folder, _ = train_main(opt)
    got = _tags_and_steps(folder)

    from train import train
    jax_opt = jax_load_config(recipe, root=REPO, debug=True,
                              id='jax', save_dir=str(tmp_path / 'jax'))
    want = _tags_and_steps(train(jax_opt))
    assert got == want
    # two steps an epoch (5 videos at B=2, drop_last), each validated
    assert ('lr', 2) in got and ('lr', 4) in got
    assert {t for t, _ in got} >= {'lr', 'videos_per_sec',
                                   'train/total_loss', 'val/METEOR',
                                   'val/soda_c'}

    backup = os.path.join(folder, 'backup')
    assert os.path.isfile(os.path.join(backup, 'cfgs', 'yc2_tsp_pdvc.yml'))
    assert os.path.isfile(os.path.join(backup, 'dvc_tpu_torch',
                                       'run_train.py'))
    assert os.path.isfile(os.path.join(backup, 'train.py'))
    for _, dirs, _ in os.walk(backup):
        assert not {'__pycache__', '_build'} & set(dirs)
    log = open(os.path.join(folder, 'train.log')).read()
    assert '|  option  |  value  |' in log
    assert f'| steps_per_dispatch | {K} |' in log
