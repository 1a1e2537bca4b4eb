"""``--pretrain full|encoder|decoder`` in the port: the warm start of a
FusionPDVC's PDVC from a plain-PDVC checkpoint (``newTrain.py:65-77``)
takes the same parameter set as ``newTrain.py``.

A tiny plain-PDVC JAX run is written as the JAX package writes it (a
``.ckpt`` pickle), and as a reference-layout ``.pth`` (``export_pdvc``).
For each mode and source ``newTrain.py``'s restore (its
``load_checkpoint`` and ``filtered_restore`` into the fusion model's
``pdvc`` scope) is converted with ``from_jax_params``; the port's restore
of the same source into the same fusion weights must equal it exactly
(values are copied, not computed).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_train import _synthetic_recipe  # noqa: I100
from torch_port import fusion_batch, jax_fusion_params, tiny_opt, to_torch

from dvc_tpu.models.pdvc import PDVC as JaxPDVC
from dvc_tpu.models.pdvc import PDVCConfig as JaxPDVCConfig
from dvc_tpu.models.pdvc_converter import export_pdvc
from dvc_tpu.train.trainer import filtered_restore as jax_filtered_restore
from dvc_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from dvc_tpu.train.trainer import save_checkpoint as jax_save_checkpoint
from dvc_tpu_torch.models import from_jax_params, make_fusion_model
from dvc_tpu_torch.new_train import main as train_main
from dvc_tpu_torch.serve import load_pdvc_weights
from dvc_tpu_torch.train import (filtered_restore, is_encoder_param,
                                 load_checkpoint)
from dvc_tpu_torch.utils.config import parse_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """(opt, fusion target params, {format: source path}): a plain-PDVC
    source of another seed, as a JAX .ckpt and as a reference .pth."""
    root = tmp_path_factory.mktemp('pretrain')
    opt = tiny_opt()
    batch = fusion_batch(0)
    target = jax_fusion_params(opt, batch, seed=0)
    plain = {k: jnp.asarray(v) for k, v in batch.items()
             if k != 'sound_tensor'}
    model = JaxPDVC(JaxPDVCConfig.from_opt(opt))
    source = jax.tree_util.tree_map(np.asarray, jax.jit(
        lambda r, b: model.init(r, b, eval_mode=True))(
            jax.random.PRNGKey(7), plain))
    ckpt = jax_save_checkpoint(str(root), 'best', {
        'params': source, 'opt_state': {}, 'step': 0}, epoch=3)
    pth = str(root / 'pdvc.pth')
    torch.save({'model': {k: torch.tensor(np.asarray(v)) for k, v in
                          export_pdvc(source['params']).items()}}, pth)
    return opt, target, {'ckpt': ckpt, 'pth': pth}


def _jax_restore(target, path, which):
    """newTrain.py:65-77 on the flax params: the FusionPDVC state_dict of
    the restored tree."""
    pdvc = target['params']['pdvc']
    ck = jax_load_checkpoint(path, flax_params={'params': pdvc})
    restored = jax_filtered_restore(
        {'params': pdvc}, {'params': ck['params'].get('params', ck['params'])},
        which)
    params = {'params': {**target['params'], 'pdvc': jax.tree_util.tree_map(
        np.asarray, restored['params'])}}
    return from_jax_params(params)


@pytest.mark.parametrize('source', ['ckpt', 'pth'])
@pytest.mark.parametrize('which', ['full', 'encoder', 'decoder'])
def test_restore_takes_the_jax_parameter_set(run, source, which):
    opt, target, paths = run
    want = _jax_restore(target, paths[source], which)
    model = make_fusion_model(opt, 'cpu')
    start = {k: to_torch(v) for k, v in from_jax_params(target).items()}
    model.load_state_dict(start, strict=True)
    taken = filtered_restore(model, load_pdvc_weights(paths[source]), which)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], to_torch(want[k])), k
    # what was taken: the encoder, the rest of the PDVC, or all of it
    pdvc = [k for k in got if k.startswith('pdvcModel.')]
    enc = [k for k in pdvc if is_encoder_param(k[len('pdvcModel.'):])]
    expect = {'full': pdvc, 'encoder': enc,
              'decoder': [k for k in pdvc if k not in enc]}[which]
    assert sorted(taken) == sorted(expect) and enc
    changed = [k for k in got if not torch.equal(got[k], start[k])]
    assert set(changed) <= set(expect) and changed


def test_restore_refuses_an_incomplete_full_source(run):
    opt, _, paths = run
    sd = load_pdvc_weights(paths['ckpt'])
    sd.pop('query_embed.weight')
    model = make_fusion_model(opt, 'cpu')
    with pytest.raises(KeyError, match='query_embed'):
        filtered_restore(model, sd, 'full')
    filtered_restore(model, sd, 'decoder')      # partial: takes what is there


@pytest.mark.heavy
def test_new_train_warm_starts_from_pretrain_path(tmp_path):
    """new_train.main --pretrain full at lr 0: the run's PDVC is the
    source's (the steps at lr 0 change nothing), the fusion blocks the
    seeded initialisation."""
    recipe = _synthetic_recipe(tmp_path)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu',
                      '--pretrain', 'full', '--pretrain_path',
                      str(tmp_path / 'source.pth')], root=REPO)
    opt.lr = 0.0
    source = make_fusion_model(opt, 'cpu', seed=5).state_dict()
    torch.save({'model': source}, tmp_path / 'source.pth')
    fresh = make_fusion_model(opt, 'cpu', seed=opt.seed).state_dict()
    folder, losses = train_main(opt)
    assert all(np.isfinite(v) for v in losses.values())
    got = load_checkpoint(os.path.join(folder, 'model-last.pth'))['model']
    for k, v in got.items():
        want = source[k] if k.startswith('pdvcModel.') else fresh[k]
        assert torch.equal(v, want), k
    with open(os.path.join(folder, 'train.log')) as f:
        assert 'loading pretrained PDVC (full)' in f.read()
