"""Data-parallel PDVC training of the port (``dvc_tpu_torch.parallel``):
two gloo ranks of a CPU process group against the JAX ``Trainer`` on
``make_mesh(n_data=2)`` (the global-batch step: each rank holds its
contiguous half of the batch, ``P('data')``), and against the port in one
process on the global batch; the per-host order, the metric sync and the
ranks' rows of the loaders; the refusals.  (The drivers as ranks:
tests/test_torch_mesh_refusal.py, tests/test_torch_train_tsp_driver.py;
TSP: tests/test_torch_tsp_data_parallel.py.)

Tolerances (tests/test_torch_train.py's Trainer test): per-step losses
rtol 1e-4 against JAX (1e-5 against the port's one process: the same
arithmetic but for the order of the sums); the final parameters atol 2e-5
+ rtol 1e-3, except alpha_net's bias and the key third of each attention's
in_proj_bias, whose exact gradients are zero and whose Adam steps are
rounding noise; the summed first-step gradients within a relative L2 error
of 1e-4 + 1e-6 of the one process's.  The ranks' parameters are equal bit
for bit.  Dropout is off; the JAX deformable attention runs its plain
reference (``msda_impl='ref'``), as in tests/test_sharding.py.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import (REPO, _synthetic_recipe,  # noqa: I100
                              off_boundary)
from torch_mesh_workers import (assert_equal_states, collective_cases,
                                pdvc_steps, spawn)
from torch_port import tiny_opt, to_torch, train_batch

from dvc_tpu.data import BatchLoader as JaxBatchLoader
from dvc_tpu.data import DenseCaptionDataset as JaxDataset
from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.parallel import make_mesh
from dvc_tpu.parallel.mesh import replicate_tree
from dvc_tpu.parallel.multihost import host_shard_order as jax_shard_order
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu_torch import parallel
from dvc_tpu_torch.data import (BatchLoader, DenseCaptionDataset,
                                FusionBatchLoader, FusionDataset)
from dvc_tpu_torch.models import from_jax_params, make_pdvc_model
from dvc_tpu_torch.new_train import main as new_train_main
from dvc_tpu_torch.train import Trainer
from dvc_tpu_torch.utils.config import load_config, parse_opts

pytestmark = pytest.mark.heavy

TRAIN = dict(transformer_dropout_prob=0.0, drop_prob=0.0, lr=1e-3,
             weight_decay=1e-2, optimizer_type='adamw', grad_clip=1.0,
             caption_loss_coef=2.0, count_loss_coef=0.5)
LRS = (1e-3, 5e-4)


def global_batch(seed):
    """B=4: two of tests/torch_port.py's train batches, stacked."""
    a, b = train_batch(seed), train_batch(seed + 1)
    return {k: np.concatenate([a[k], b[k]]) for k in a}


def port_opt(opt):
    """The port's options with a JAX test's values (a spawned rank may
    not unpickle the JAX package's Config)."""
    return load_config(**opt.to_dict())


def exempt(name, got, ref):
    """(got, ref) without the entries whose exact gradient is zero."""
    if name.endswith('alpha_net.bias'):
        return None
    if name.endswith('in_proj_bias'):       # drop the key bias
        E = len(ref) // 3
        return (np.delete(got, np.s_[E:2 * E]),
                np.delete(ref, np.s_[E:2 * E]))
    return got, ref


def assert_params_close(got, want):
    for name, g in got.items():
        pair = exempt(name, np.asarray(g), np.asarray(want[name]))
        if pair is not None:
            np.testing.assert_allclose(*pair, rtol=1e-3, atol=2e-5,
                                       err_msg=name)


def one_process(opt, sd, batches, plain=False):
    """The port's Trainer in this process on the global batches: (losses
    per step, final state_dict, the first step's gradients)."""
    model = make_pdvc_model(opt, 'cpu', seed=0) if plain else None
    trainer = Trainer(opt, device='cpu', model=model)
    trainer.model.load_state_dict(sd, strict=True)
    losses, grads = [], None
    for b, lr in zip(batches, LRS):
        out = trainer.train_step(b, lr)
        losses.append({k: float(v) for k, v in out.items()})
        if grads is None:
            grads = {n: p.grad.clone()
                     for n, p in trainer.model.named_parameters()}
    return losses, trainer.model.state_dict(), grads


def assert_ranks_match_one_process(ranks, losses, state, grads):
    assert_equal_states(ranks[0]['state'], ranks[1]['state'])
    for r in ranks:
        for got, want in zip(r['losses'], losses):
            assert sorted(got) == sorted(want)
            for k in want:
                np.testing.assert_allclose(got[k], want[k], rtol=1e-5,
                                           atol=1e-7, err_msg=k)
    assert_params_close(ranks[0]['state'], state)
    for name, g in ranks[0]['grads'].items():
        err = float((g - grads[name]).norm())
        assert err <= 1e-4 * float(grads[name].norm()) + 1e-6, name


@pytest.fixture(scope='module')
def jax_mesh_run():
    """Two AdamW steps of the JAX Trainer on a 2-device data mesh, from
    flax params moved off the tap boundaries: (opt, batches, the initial
    state_dict, per-step losses, the final state_dict)."""
    opt = tiny_opt(**TRAIN)
    batches = [global_batch(10), global_batch(12)]
    mesh = make_mesh(n_data=2)
    trainer = JaxTrainer(opt, mesh=mesh, model=jax_make_fusion(opt))
    model = trainer.model
    params = off_boundary(jax.jit(lambda r, b: model.init(
        {'params': r}, b, eval_mode=False, deterministic=True,
        ss_enabled=False))(jax.random.PRNGKey(0),
                           {k: jnp.asarray(v) for k, v in batches[0].items()}))
    state = {'params': replicate_tree(params, mesh),
             'opt_state': replicate_tree(trainer.tx.init(params), mesh),
             'step': 0}
    losses = []
    for b, lr in zip(batches, LRS):
        state, out = trainer.train_step(state, dict(b), lr, 0.0,
                                        jax.random.PRNGKey(0))
        losses.append({k: float(v) for k, v in out.items()})
    final = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                   state['params']))
    return opt, batches, from_jax_params(params), losses, final


def test_two_ranks_match_the_jax_data_mesh(jax_mesh_run, tmp_path):
    """FusionPDVC: the JAX mesh's losses and parameters, and the port's
    one-process step on the global batch (losses, parameters, the summed
    gradients)."""
    opt, batches, sd, want, final = jax_mesh_run
    popt = port_opt(opt)
    sd = {k: to_torch(v) for k, v in sd.items()}
    ranks = spawn(pdvc_steps, 2, tmp_path, popt, sd, batches, LRS)
    for r in ranks:
        for step, (got, w) in enumerate(zip(r['losses'], want)):
            assert sorted(got) == sorted(w)
            for k in w:
                np.testing.assert_allclose(got[k], w[k], rtol=1e-4,
                                           atol=1e-6, err_msg=f'{step} {k}')
    assert_params_close(ranks[0]['state'], final)
    assert_ranks_match_one_process(ranks, *one_process(popt, sd, batches))


def test_two_ranks_match_one_process_plain_pdvc(tmp_path):
    """run_train's plain PDVC: two ranks against one process."""
    opt = port_opt(tiny_opt(**TRAIN))
    sd = make_pdvc_model(opt, 'cpu', seed=0).state_dict()
    batches = [global_batch(20), global_batch(22)]
    ranks = spawn(pdvc_steps, 2, tmp_path, opt, sd, batches, LRS, True)
    assert_ranks_match_one_process(ranks,
                                   *one_process(opt, sd, batches, True))


@pytest.mark.parametrize('n,epoch,shuffle,index,count', [
    (10, 0, True, 0, 1), (10, 3, True, 1, 3), (7, 1, False, 2, 4),
    (9, 2, True, 0, 2)])
def test_host_shard_order_matches_jax(n, epoch, shuffle, index, count):
    np.testing.assert_array_equal(
        parallel.host_shard_order(n, epoch, shuffle, 5, index, count),
        jax_shard_order(n, epoch, shuffle, 5, index, count))


def test_the_collectives_on_two_ranks(tmp_path):
    """``sync_metrics``: two ranks' metrics averaged as the JAX
    sync_metrics does (the mean of the gathered values), in the given key
    order, and one process's copied; ``sum_gradients`` sums in place over
    buckets of every size and dtype; ``all_reduce_sum`` sums forward and
    backward; ``from_main`` gives rank 0's result and ``broadcast_module``
    rank 0's weights."""
    cases = [[{'b': 1.0, 'a': 4.0}, {'b': 3.0, 'a': -2.0}],
             [{'loss_n': 3.0, 'correct0': 5.0}, {'loss_n': 3.0,
                                                 'correct0': 1.0}]]
    got = spawn(collective_cases, 2, tmp_path, cases)
    for r in range(2):
        for case, out in zip(cases, got[r]['sync']):
            assert list(out) == list(case[0])
            for k in out:
                assert out[k] == np.mean([c[k] for c in case])
        for g in got[r]['grads']:
            assert bool((g == 3).all())
        assert [g.dtype for g in got[r]['grads']] == [
            torch.float32, torch.float32, torch.float64, torch.float32]
        assert got[r]['y'].tolist() == [3.0, 3.0, 3.0]
        # each rank's loss is y . [0, 1, 2] with y = sum_r (r + 1) x_r:
        # d(both losses)/dx_r = 2 (r + 1) [0, 1, 2]
        assert got[r]['x_grad'].tolist() == [0.0, 2 * (r + 1), 4 * (r + 1)]
        assert got[r]['main'] == 'rank 0'
        assert bool((got[r]['weight'] == 0).all())
    single = {'x': 2}
    assert parallel.sync_metrics(single) == single and \
        parallel.sync_metrics(single) is not single


@pytest.mark.parametrize('loader,skip', [
    ('BatchLoader', False), ('FusionBatchLoader', False),
    ('FusionBatchLoader', True)])
def test_the_ranks_rows_make_the_one_process_batch(tmp_path, loader, skip):
    """The ranks' rows of each global batch, stacked, are the one-process
    batch (the dataset's gt subsample draws included: G 2 < the videos'
    events), and every rank's meta['keys'] are the global batch's; with
    visited videos skipped (``skip_keys``, FusionBatchLoader's restart)."""
    opt = parse_opts(['--cfg_path', _synthetic_recipe(tmp_path, n_videos=9)],
                     root=REPO)
    opt.gt_proposal_sample_num = 2
    with open(opt.train_caption_file) as f:
        assert max(len(v['timestamps']) for v in json.load(f).values()) > 2
    dataset = FusionDataset if loader == 'FusionBatchLoader' else \
        DenseCaptionDataset

    def batches(part):
        ds = dataset(opt.train_caption_file, opt.visual_feature_folder,
                     opt.dict_file, opt, seed=3)
        skip_keys = set(ds.keys[2:4]) if skip else None
        if loader == 'FusionBatchLoader':
            it = FusionBatchLoader(ds, 4, True, opt, seed=1,
                                   skip_keys=skip_keys, part=part)
        else:
            it = BatchLoader(ds, 4, True, opt, seed=1, part=part)
            it.set_epoch(2)
        return list(it)

    whole = batches((0, 1))
    ranks = [batches((r, 2)) for r in range(2)]
    assert len(whole) == len(ranks[0]) == len(ranks[1]) == 2 - skip
    for i, (batch, meta) in enumerate(whole):
        for r in range(2):
            assert ranks[r][i][1]['keys'] == meta['keys']
            assert len(ranks[r][i][1]['durations']) == 2
        for k, v in batch.items():
            np.testing.assert_array_equal(
                np.concatenate([ranks[r][i][0][k] for r in range(2)]), v,
                err_msg=k)


@pytest.mark.parametrize('index,count', [(0, 2), (1, 2), (2, 3)])
def test_batch_loader_per_host_split_matches_jax(tmp_path, index, count):
    """``process_index`` / ``process_count``: the JAX BatchLoader's
    per-host batches (DistributedSampler semantics)."""
    recipe = _synthetic_recipe(tmp_path, n_videos=9)
    opt = parse_opts(['--cfg_path', recipe], root=REPO)
    args = (opt.train_caption_file, opt.visual_feature_folder, opt.dict_file)
    got = BatchLoader(DenseCaptionDataset(*args, opt, seed=3), 2, True, opt,
                      seed=4, process_index=index, process_count=count)
    want = JaxBatchLoader(JaxDataset(*args, True, opt, seed=3), 2, True, opt,
                          seed=4, process_index=index, process_count=count)
    assert len(got) == len(want)
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gm['keys'] == wm['keys']
        for k in wb:
            np.testing.assert_array_equal(gb[k], wb[k], err_msg=k)


def test_no_group_issues_no_collective(monkeypatch):
    """Without a process group the Trainer's step calls no collective."""
    def refuse(*a, **k):
        raise AssertionError('a collective without a group')

    for name in ('all_reduce', 'broadcast', 'barrier'):
        monkeypatch.setattr(torch.distributed, name, refuse)
    opt = port_opt(tiny_opt(**TRAIN))
    trainer = Trainer(opt, device='cpu')
    parallel.broadcast_module(trainer.model)
    parallel.barrier()
    assert not trainer.data_parallel
    out = trainer.train_step(train_batch(3), 1e-3)
    assert np.isfinite(float(out['total_loss']))


@pytest.mark.parametrize('batch_size,n', [(3, 2), (4, 3)])
def test_a_batch_that_does_not_split_is_refused(tmp_path, batch_size, n):
    opt = parse_opts(['--cfg_path', _synthetic_recipe(tmp_path), '--debug',
                      '--device', 'cpu', '--tpu_mesh_data', str(n)],
                     root=REPO)
    opt.batch_size = batch_size
    with pytest.raises(ValueError, match='does not split'):
        new_train_main(opt)
    assert not os.path.exists(opt.save_dir)


def test_torchrun_world_size_must_match(tmp_path, monkeypatch):
    """Under torchrun (``WORLD_SIZE`` set) a world other than
    ``--tpu_mesh_data`` is refused before any work."""
    monkeypatch.setenv('WORLD_SIZE', '2')
    monkeypatch.setenv('RANK', '0')
    opt = parse_opts(['--cfg_path', _synthetic_recipe(tmp_path), '--debug',
                      '--device', 'cpu', '--tpu_mesh_data', '1'], root=REPO)
    with pytest.raises(ValueError, match='WORLD_SIZE 2'):
        new_train_main(opt)
    assert not os.path.exists(opt.save_dir)


@pytest.mark.cuda
def test_more_ranks_than_cards_are_refused(tmp_path):
    """No two ranks on one card and no carry-on on the CPU: one rank more
    than the visible cards is refused before any work."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    opt = parse_opts(['--cfg_path', _synthetic_recipe(tmp_path), '--debug',
                      '--tpu_mesh_data', str(torch.cuda.device_count() + 1)],
                     root=REPO)
    opt.batch_size = 2 * (torch.cuda.device_count() + 1)
    with pytest.raises(RuntimeError, match='visible'):
        new_train_main(opt)
    assert not os.path.exists(opt.save_dir)
