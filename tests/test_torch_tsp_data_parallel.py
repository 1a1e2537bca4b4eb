"""Data-parallel TSP training of the port (``dvc_tpu_torch.parallel``): two
gloo ranks of a CPU process group under ``--train-bn 1`` against the JAX
``TSPTrainer`` on a 2-device data mesh, whose BatchNorm takes the global
batch's statistics (flax under a sharded batch: SyncBatchNorm).  (The
``train_tsp`` driver with ``--mesh-data 2``:
tests/test_torch_train_tsp_driver.py.)

Tolerances: BatchNorm's running statistics rtol 1e-5 / atol 1e-6 (the JAX
package's own 1- against 8-device tolerance, tests/test_tsp_trainer.py);
the losses rtol 1e-5 and the parameters and SGD momentum within a
relative L2 error of 1e-4 (tests/test_torch_tsp_train.py's f32 steps).
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_tsp_train import (ITERS, LAUNCHER, _batches,  # noqa: I100
                                  _close, _jax_run, _opt)
from torch_mesh_workers import spawn, tsp_steps

from dvc_tpu.utils.config import load_config as jax_config
from dvc_tpu_torch.models.tsp import (tsp_from_jax_params,
                                      tsp_momentum_from_jax)
from dvc_tpu_torch.utils.config import load_config as port_config

pytestmark = pytest.mark.heavy

STEPS = 2


@pytest.fixture(scope='module')
def jax_mesh_run():
    """Two steps of the JAX TSPTrainer (R3D-18, --train-bn 1) on a
    2-device mesh from noisy variables, at a global batch of 4 clips."""
    batches = _batches('r3d_18', False, n=STEPS, B=4, seed=7)
    variables, metrics, state = _jax_run(
        _opt(jax_config, 'r3d_18', train_bn=1, tpu_mesh_data=2, **LAUNCHER),
        batches)
    final = tsp_from_jax_params(jax.tree_util.tree_map(
        np.asarray, state['variables']))
    momentum = tsp_momentum_from_jax(jax.tree_util.tree_map(
        np.asarray, state['opt_state']))
    return batches, variables, metrics, final, momentum


def test_two_ranks_match_the_jax_data_mesh_under_train_bn(jax_mesh_run,
                                                          tmp_path):
    batches, variables, want, final, momentum = jax_mesh_run
    opt = _opt(port_config, 'r3d_18', train_bn=1, tpu_mesh_data=2,
               **LAUNCHER)
    ranks = spawn(tsp_steps, 2, tmp_path, opt, tsp_from_jax_params(variables),
                  batches, ITERS[:STEPS])
    for key in ranks[0]['state']:
        assert torch.equal(ranks[0]['state'][key], ranks[1]['state'][key])
    for r in ranks:
        for got, w in zip(r['metrics'], want):
            assert set(got) == set(w) == {'total', 'head0', 'head1'}
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-5,
                                           err_msg=k)
    state = ranks[0]['state']
    stats = [k for k in final if k.endswith(('running_mean', 'running_var'))]
    assert stats
    initial = tsp_from_jax_params(variables)
    for k in stats:
        # the global batch's statistics moved them
        assert not torch.equal(final[k], initial[k]), k
        np.testing.assert_allclose(state[k].numpy(), final[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    _close(state, {k: v for k, v in final.items()
                   if not k.endswith('num_batches_tracked')}, 'state')
    _close(ranks[0]['momentum'], momentum, 'momentum')
