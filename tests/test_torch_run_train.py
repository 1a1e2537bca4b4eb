"""The plain-PDVC driver of the port, ``python -m dvc_tpu_torch.run_train``
(the counterpart of ``train.py``), and evaluation and serving of plain
runs: a --debug epoch on the CPU over a tiny synthetic recipe for the
light, none and two-stage variants (the files it writes, model-best by
either criterion); one ``Trainer`` step against the JAX ``Trainer`` on
the same weights and batch; ``BatchLoader`` against JAX's; ``--steps_per_
dispatch 2`` against two single steps; ``--start_from last``; ``run_eval``
and ``DenseCaptioner`` on a plain run folder that the JAX
``save_checkpoint`` wrote, against JAX's ``evaluate`` and
``DenseCaptioner``; and ``run_eval`` on a FusionPDVC run whose recipe has
no sound folder (the weights, not the recipe, say it is FusionPDVC).

Tolerances: one step's losses rtol 1e-4 (the Trainer test of
tests/test_torch_train.py); the two-step stack against two single steps
parameters within atol 1e-6 + rtol 1e-5 and losses 1e-6 (the same
arithmetic, one caption bucket for both steps instead of one each: the
extra word steps are fully masked); records and scores as
tests/test_torch_eval_loop.py (2e-4, captions identical; scores 1e-5);
the loader's batches exactly.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_eval_loop import (_assert_same_records,  # noqa: I100
                                  _assert_same_scores, _check_dvc_json,
                                  _write_data)
from test_torch_pdvc_variants import off_boundary
from torch_port import to_torch

from dvc_tpu.data import BatchLoader as JaxBatchLoader
from dvc_tpu.data import DenseCaptionDataset as JaxDataset
from dvc_tpu.eval import evaluate as jax_evaluate
from dvc_tpu.serve import DenseCaptioner as JaxDenseCaptioner
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from dvc_tpu.train.trainer import save_info_json as jax_save_info_json
from dvc_tpu_torch import run_eval
from dvc_tpu_torch.data import BatchLoader, DenseCaptionDataset
from dvc_tpu_torch.models import (make_fusion_model, make_pdvc_model,
                                  pdvc_from_jax_params)
from dvc_tpu_torch.run_train import host_losses
from dvc_tpu_torch.run_train import main as train_main
from dvc_tpu_torch.serve import DenseCaptioner
from dvc_tpu_torch.train import Trainer, load_checkpoint
from dvc_tpu_torch.utils.config import load_config, parse_opts

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(hidden_dim=32, nheads=4, enc_layers=1, dec_layers=2,
             transformer_ff_dim=32, num_queries=8, input_encoding_size=16,
             rnn_size=32, cap_nheads=2, max_eseq_length=8, msda_impl='ref',
             transformer_dropout_prob=0.0, drop_prob=0.0)
VARIANTS = {
    'light': dict(base_cfg_path='cfgs/anet_c3d_pdvcl.yml'),
    'none': dict(base_cfg_path='cfgs/anet_c3d_props.yml'),
    'gt_proposals': dict(base_cfg_path='cfgs/anet_c3d_pdvcl_gt.yml'),
    'standard': dict(base_cfg_path='cfgs/anet_c3d_pdvc.yml', att_hid_size=16),
}


def data_opts(root):
    """The synthetic val set of tests/test_torch_eval_loop.py (5 videos, a
    letters-only vocabulary, the gt files of the metrics), as a plain run's
    train and val data."""
    d = _write_data(root)
    d['sound_feature_folder'] = None
    return d


def write_recipe(root, variant, **over):
    cfg = dict(VARIANTS[variant], id=variant, save_dir=str(root / 'save'),
               **data_opts(root), **SMALL, batch_size=2, epoch=1,
               batch_size_for_eval=2)
    cfg.update(over)
    path = root / f'{variant}.yml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize('variant', ['light', 'none', 'gt_proposals'])
def test_run_train_debug_epoch_writes_the_run(tmp_path, variant):
    """One --debug epoch (2 steps at B=2 over 5 videos, drop_last), then
    validation: epoch1.json, model-best.pth and model-last.pth (epoch 1,
    2 steps), info.json with val_history and loss_history; 'none' writes
    empty sentences with finite Recall and Precision."""
    opt = parse_opts(['--cfg_path', write_recipe(tmp_path, variant),
                      '--debug', '--device', 'cpu'], root=REPO)
    copies = host_losses.copies
    folder, losses = train_main(opt)
    assert host_losses.copies - copies == 2          # one a step, 2 steps
    assert {'epoch1.json', 'model-best.pth', 'model-last.pth', 'info.json',
            'train.log'} <= set(os.listdir(folder))
    assert all(np.isfinite(v) for v in losses.values())
    assert ('loss_caption' in losses) == (variant != 'none')
    info = json.load(open(os.path.join(folder, 'info.json')))
    history = info['val_history']['1']
    assert np.isfinite(history['Recall']) and np.isfinite(
        history['Precision'])
    assert info['best_val_score'] == history['METEOR'] + history['soda_c']
    assert info['best']['epoch'] == info['last']['epoch'] == 1
    assert sorted(info['loss_history']['0']) == sorted(losses)
    ck = load_checkpoint(os.path.join(folder, 'model-best.pth'))
    assert ck['epoch'] == 1 and ck['step'] == 2
    dvc = json.load(open(os.path.join(folder, 'epoch1.json')))
    sentences = [e['sentence'] for v in dvc['results'].values() for e in v]
    assert sentences and all(isinstance(s, str) for s in sentences)
    if variant == 'none':
        assert set(sentences) == {''}
    if variant == 'gt_proposals':
        # G queries, each with the box of its gt event
        assert {len(v) for v in dvc['results'].values()} == {
            opt.gt_proposal_sample_num}
    else:
        dc = DenseCaptioner(folder, device='cpu')
        events = dc.caption_features(np.random.default_rng(1).standard_normal(
            (30, opt.feature_dim)).astype(np.float32), 45.0)
        assert events and all(isinstance(e['sentence'], str) for e in events)


def test_criteria_pc_saves_all_checkpoints_and_resumes(tmp_path):
    """--criteria_for_best_ckpt pc picks model-best by the paragraph
    scores; --save_all_checkpoint keeps model-epoch{N}.pth; --start_from
    last resumes at epoch 1 with the optimizer state, to epoch 2."""
    # the recipe overlays the command line, so the flag goes in it
    recipe = write_recipe(tmp_path, 'light', criteria_for_best_ckpt='pc',
                          save_all_checkpoint=True)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu'],
                     root=REPO)
    folder, _ = train_main(opt)
    info = json.load(open(os.path.join(folder, 'info.json')))
    h = info['val_history']['1']
    assert info['best_val_score'] == pytest.approx(
        h['para_METEOR'] + h['para_CIDEr'] + h['para_Bleu_4'])
    assert os.path.exists(os.path.join(folder, 'model-epoch1.pth'))
    opt2 = parse_opts(['--cfg_path', recipe, '--device', 'cpu', '--debug',
                       '--start_from', opt.id], root=REPO)
    opt2.epoch = 2
    train_main(opt2)
    ck = load_checkpoint(os.path.join(folder, 'model-last.pth'))
    assert ck['epoch'] == 2 and ck['step'] == 4
    info = json.load(open(os.path.join(folder, 'info.json')))
    assert info['last']['epoch'] == 2
    assert sorted(info['loss_history']) == ['0', '1']


@pytest.mark.parametrize('shuffle', [True, False])
def test_batch_loader_matches_jax(tmp_path, shuffle):
    opt = load_config(**{**SMALL, **data_opts(tmp_path),
                         'gt_proposal_sample_num': 2})
    ds = DenseCaptionDataset(opt.train_caption_file,
                             opt.visual_feature_folder, opt.dict_file, opt,
                             seed=3)
    jds = JaxDataset(opt.train_caption_file, opt.visual_feature_folder,
                     opt.dict_file, True, opt, seed=3)
    loader = BatchLoader(ds, 2, shuffle, opt, seed=5)
    jloader = JaxBatchLoader(jds, 2, shuffle, opt, seed=5)
    assert len(loader) == len(jloader) == (2 if shuffle else 3)
    for epoch in (0, 1, 0):
        loader.set_epoch(epoch)
        jloader.set_epoch(epoch)
        for (b, m), (jb, jm) in zip(loader, jloader):
            assert m['keys'] == jm['keys'] and m['n_real'] == jm['n_real']
            assert m['raw_captions'] == jm['raw_captions']
            assert sorted(b) == sorted(jb)
            for k in jb:
                np.testing.assert_array_equal(b[k], jb[k], err_msg=k)


def _trainer_pair(opt, batch):
    """A JAX Trainer state and a port Trainer of a plain PDVC on the same
    weights."""
    jtrainer = JaxTrainer(opt)
    state = jtrainer.init_state({k: jnp.asarray(v) for k, v in batch.items()},
                                seed=0)
    state['params'] = jax.tree_util.tree_map(
        jnp.asarray, off_boundary(state['params']))
    trainer = Trainer(opt, device='cpu', model=make_pdvc_model(opt, 'cpu'))
    trainer.model.load_state_dict(
        {k: to_torch(v) for k, v in pdvc_from_jax_params(
            jax.tree_util.tree_map(np.asarray, state['params'])).items()},
        strict=True)
    return jtrainer, state, trainer


def _batches(opt, n=2):
    ds = DenseCaptionDataset(opt.train_caption_file,
                             opt.visual_feature_folder, opt.dict_file, opt)
    loader = BatchLoader(ds, 2, True, opt, seed=1)
    loader.set_epoch(0)
    return [b for b, _ in loader][:n]


def test_one_step_matches_the_jax_trainer(tmp_path):
    opt = load_config(write_recipe(tmp_path, 'light'), root=REPO,
                      lr=1e-3, optimizer_type='adamw', weight_decay=1e-2,
                      grad_clip=1.0)
    batch = _batches(opt, 1)[0]
    jtrainer, state, trainer = _trainer_pair(opt, batch)
    _, jlosses = jtrainer.train_step(state, batch, 1e-3, 0.0,
                                     jax.random.PRNGKey(0))
    losses = trainer.train_step(batch, 1e-3)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


def test_steps_per_dispatch_matches_single_steps(tmp_path):
    """Two stacked steps (one caption bucket, the losses stacked on the
    device) against two single steps from the same weights, dropout
    off."""
    opt = load_config(write_recipe(tmp_path, 'standard'), root=REPO,
                      lr=1e-3)
    batches = _batches(opt)
    a = Trainer(opt, device='cpu', model=make_pdvc_model(opt, 'cpu'))
    b = Trainer(opt, device='cpu', model=make_pdvc_model(opt, 'cpu'))
    stacked = a.train_steps(batches, 1e-3)
    singles = [b.train_step(x, 1e-3) for x in batches]
    assert a.step == b.step == 2
    for k, v in stacked.items():
        assert v.shape == (2,)
        np.testing.assert_allclose(
            v.numpy(), [float(s[k]) for s in singles], rtol=1e-6, atol=1e-6,
            err_msg=k)
    for (n, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=n)
    assert host_losses(stacked).keys() == stacked.keys()


def test_run_train_steps_per_dispatch_flushes_the_tail(tmp_path):
    """--steps_per_dispatch 2 over an epoch of 5 batches (5 videos at
    B=1): two stacked dispatches and the trailing batch alone, three host
    copies."""
    recipe = write_recipe(tmp_path, 'light', steps_per_dispatch=2,
                          batch_size=1)
    opt = parse_opts(['--cfg_path', recipe, '--device', 'cpu'], root=REPO)
    copies = host_losses.copies
    folder, _ = train_main(opt)
    assert host_losses.copies - copies == 3          # 5 steps: 2 + 2 + 1
    assert load_checkpoint(os.path.join(folder, 'model-last.pth'))[
        'step'] == 5


@pytest.fixture(scope='module')
def jax_plain_run(tmp_path_factory):
    """A plain-PDVC (light head) run folder as the JAX trainer writes it,
    and JAX evaluate's records and scores on it."""
    root = tmp_path_factory.mktemp('jax_plain')
    opt = load_config(write_recipe(root, 'light'), root=REPO,
                      device_prefetch=0)
    batch = _batches(opt, 1)[0]
    jtrainer = JaxTrainer(opt)
    state = jtrainer.init_state({k: jnp.asarray(v) for k, v in batch.items()},
                                seed=4)
    params = jax.tree_util.tree_map(np.asarray, state['params'])
    folder = str(root / 'run')
    jax_save_checkpoint(folder, 'best', {
        'params': params, 'opt_state': optax.adamw(1e-4).init(params),
        'step': jnp.asarray(3, jnp.int32)}, epoch=2)
    jax_save_info_json(folder, {'best': {'epoch': 2, 'opt': opt.to_dict()}})
    ds = JaxDataset(opt.val_caption_file, opt.visual_feature_folder,
                    opt.dict_file, False, opt)
    path = str(root / 'jax.json')
    scores, _ = jax_evaluate(
        jtrainer, {'params': jax.tree_util.tree_map(jnp.asarray, params)},
        JaxBatchLoader(ds, 2, False, opt), path, alpha=opt.ec_alpha,
        dvc_eval_version=opt.eval_tool_version)
    return folder, dict(scores), json.load(open(path))['results']


def test_run_eval_and_serving_of_a_jax_plain_run(jax_plain_run):
    folder, scores, records = jax_plain_run
    path, got = run_eval.main(['--eval_save_dir', folder, '--eval_batch_size',
                               '2', '--eval_device', 'cpu'])
    out = _check_dvc_json(path)
    _assert_same_records(out['results'], records)
    _assert_same_scores(got, scores)
    feats = np.random.default_rng(2).standard_normal((30, 16)).astype(
        np.float32)
    want = JaxDenseCaptioner(folder).caption_features(feats, 45.0)
    events = DenseCaptioner(folder, device='cpu').caption_features(feats, 45.0)
    assert [e['sentence'] for e in events] == [e['sentence'] for e in want]
    np.testing.assert_allclose([e['timestamp'] for e in events],
                               [e['timestamp'] for e in want], rtol=2e-4,
                               atol=2e-4)


def test_run_eval_takes_a_fusion_run_without_a_sound_folder(tmp_path):
    """A FusionPDVC run whose recipe has no sound folder (as
    cfgs/yc2_newModel_mvit_3.yml): the weights' pdvcModel. keys make it a
    fusion run, evaluated with zero sound (at the features' width, as the
    HuBERT default is the mvit recipe's)."""
    opt = load_config('cfgs/yc2_newModel_sound.yml', root=REPO,
                      **data_opts(tmp_path), **SMALL, fusion_heads=4,
                      batch_size_for_eval=2, sound_feature_dim=16)
    assert opt.sound_feature_folder is None
    folder = tmp_path / 'fusion'
    folder.mkdir()
    model = make_fusion_model(opt, 'cpu', seed=2)
    torch.save({'model': model.state_dict(), 'epoch': 1},
               folder / 'model-best.pth')
    (folder / 'info.json').write_text(json.dumps(
        {'best': {'epoch': 1, 'opt': opt.to_dict()}}))
    path, _ = run_eval.main(['--eval_save_dir', str(folder), '--eval_mode',
                             'test', '--eval_device', 'cpu'])
    _check_dvc_json(path, scored=False)
