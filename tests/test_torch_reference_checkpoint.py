"""The reference's own checkpoints in the port's serving and ``run_eval``:
a PDVC or NewModel ``.pth`` as the reference saves it (``{'model':
state_dict, 'epoch', 'optimizer'}``, keys under ``module.``, with the keys
it saves but never uses: the caption sampler's dead attention weights and
output projection, the decoder's ``bbox_head`` aliases, the dormant
``pos_trans`` branch, ``enc_output``, and a NewModel's HuBERT
``sound_model.*``), made from the JAX package's ``export_pdvc`` /
``export_fusion`` of tiny seeded flax params.

``DenseCaptioner`` of the port on that file is held to the JAX
``DenseCaptioner`` on the run's ``.ckpt`` (the same weights; events within
the 2e-4 of tests/test_torch_slice.py, captions identical), and the JAX
package's own reader of the file (``load_checkpoint``) gives back those
weights exactly; ``run_eval --eval_checkpoint_path`` on the file writes the
records of the ``.ckpt`` route; an unknown extra key raises in both
packages.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_eval_loop import _assert_same_records, _write_data  # noqa: I100
from test_torch_slice import _assert_same_events, _requests
from torch_port import fusion_batch, jax_fusion_params, tiny_opt, train_batch

from dvc_tpu.models.pdvc_converter import export_fusion, export_pdvc
from dvc_tpu.serve import DenseCaptioner as JaxDenseCaptioner
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu.train.trainer import load_checkpoint as jax_load_checkpoint
from dvc_tpu.train.trainer import save_checkpoint, save_info_json
from dvc_tpu_torch import run_eval
from dvc_tpu_torch.serve import (DenseCaptioner, is_fusion_state, load_run,
                                 load_weights, reference_state_dict)

pytestmark = pytest.mark.heavy


def reference_layout(sd, fusion, extra=None):
    """``sd`` (the export's state_dict) as the reference's trainer saves
    it: every key under ``module.``, plus the tensors it saves but never
    uses, plus ``extra``."""
    pre = 'pdvcModel.' if fusion else ''
    dead = {}
    for k in sd:
        if k.startswith(pre + 'caption_head.') and k.endswith(
                'deformable_att.sampling_offsets.weight'):
            base = k[:-len('sampling_offsets.weight')]
            for name in ('attention_weights', 'output_proj'):
                dead[f'{base}{name}.weight'] = np.ones((3, 4), np.float32)
                dead[f'{base}{name}.bias'] = np.ones(3, np.float32)
    assert dead, 'the standard head has a sampler'
    for k in [k for k in sd if k.startswith(pre + 'bbox_head.')]:
        dead[pre + 'transformer.decoder.' + k[len(pre):]] = sd[k]
    for k in ('transformer.pos_trans.weight', 'transformer.pos_trans.bias',
              'transformer.pos_trans_norm.weight',
              'transformer.pos_trans_norm.bias',
              'transformer.enc_output.weight'):
        dead[pre + k] = np.zeros(4, np.float32)
    if fusion:
        dead['sound_model.feature_extractor.conv_layers.0.conv.weight'] = \
            np.zeros((8, 1, 10), np.float32)
    model = {f'module.{k}': torch.as_tensor(np.array(v))
             for k, v in {**sd, **dead, **(extra or {})}.items()}
    return {'model': model, 'epoch': 7,
            'optimizer': {'state': {}, 'param_groups': [{'lr': 1e-4}]}}


@pytest.fixture(scope='module', params=['fusion', 'plain'])
def run(request, tmp_path_factory):
    """(kind, opt, flax params, run folder): the JAX run folder
    (``model-best.ckpt``, ``info.json``) and the reference's ``.pth`` of
    the same weights beside it."""
    fusion = request.param == 'fusion'
    root = tmp_path_factory.mktemp(request.param)
    opt = tiny_opt(**_write_data(root), batch_size_for_eval=2)
    if fusion:
        params = jax_fusion_params(opt, fusion_batch(0))
    else:
        batch = train_batch(0, vocab=opt.vocab_size)
        batch.pop('sound_tensor')
        params = JaxTrainer(opt).init_state(
            {k: jnp.asarray(v) for k, v in batch.items()}, seed=3)['params']
        params = jax.tree_util.tree_map(np.asarray, params)
    folder = str(root / 'run')
    save_checkpoint(folder, 'best', {
        'params': params, 'opt_state': optax.adamw(1e-4).init(params),
        'step': jnp.asarray(3, jnp.int32)}, epoch=1)
    save_info_json(folder, {'best': {'opt': opt.to_dict()}})
    sd = (export_fusion if fusion else export_pdvc)(params)
    torch.save(reference_layout(sd, fusion),
               os.path.join(folder, 'reference.pth'))
    return request.param, opt, params, folder


def test_reference_pth_serves_as_the_jax_ckpt(run):
    kind, opt, params, folder = run
    path = os.path.join(folder, 'reference.pth')
    # the JAX package's own reader gives back the run's weights exactly
    converted = jax_load_checkpoint(path, flax_params=params)['params']
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           jax.tree_util.tree_map(np.asarray, converted),
                           params)
    raw = load_weights(path)
    assert all(k.startswith('module.') for k in raw)
    assert is_fusion_state(raw) == (kind == 'fusion')
    dc = DenseCaptioner(opt=opt, state_dict=raw, device='cpu')
    _, want = load_run(folder)
    assert dc.fusion == (kind == 'fusion')
    got = dc.model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    jdc = JaxDenseCaptioner(folder)
    feats, durs, sounds = _requests()
    if kind == 'plain':
        sounds = [None] * len(feats)
    for f, d, s in zip(feats, durs, sounds):
        _assert_same_events(dc.caption_features(f, d, sound=s),
                            jdc.caption_features(f, d, sound=s))


def test_run_eval_of_a_reference_pth(run):
    """``--eval_checkpoint_path`` on the reference's file and on the JAX
    ``.ckpt`` (the options from the ``info.json`` beside them): the same
    records."""
    _, _, _, folder = run
    records = {}
    for name, file in (('ref', 'reference.pth'), ('ckpt', 'model-best.ckpt')):
        path, _ = run_eval.main([
            '--eval_save_dir', folder, '--eval_folder', name,
            '--eval_checkpoint_path', os.path.join(folder, file),
            '--eval_mode', 'test', '--eval_device', 'cpu'])
        records[name] = json.load(open(path))['results']
    _assert_same_records(records['ref'], records['ckpt'])


def test_an_unknown_key_raises_in_both_packages(run, tmp_path):
    kind, opt, params, _ = run
    fusion = kind == 'fusion'
    sd = (export_fusion if fusion else export_pdvc)(params)
    extra = {('pdvcModel.' if fusion else '') + 'query_embed.extra':
             np.zeros(3, np.float32)}
    path = str(tmp_path / 'bad.pth')
    torch.save(reference_layout(sd, fusion, extra), path)
    with pytest.raises(ValueError, match='query_embed.extra'):
        DenseCaptioner(opt=opt, state_dict=load_weights(path), device='cpu')
    with pytest.raises(ValueError, match='query_embed.extra'):
        jax_load_checkpoint(path, flax_params=params)


@pytest.mark.parametrize('input_type', ['queries', 'learnt_proposals',
                                        'gt_proposals'])
@pytest.mark.parametrize('fusion', [False, True])
def test_reference_state_dict_drops_what_the_converters_drop(input_type,
                                                             fusion):
    """The dormant branch by input type; the dead sampler keys only of a
    head with a sampler (a light head's raise, as in ``convert_pdvc``);
    ``sound_model.*`` only of a NewModel."""
    pre = 'pdvcModel.' if fusion else ''
    kept = ['transformer.level_embed', 'caption_head.0.embed.weight',
            'caption_head.0.core.deformable_att.sampling_offsets.weight',
            'caption_head.1.core.deformable_att.sampling_offsets.weight',
            'bbox_head.0.layers.0.weight',
            ('transformer.pos_trans.weight' if input_type == 'gt_proposals'
             else 'transformer.reference_points.weight')]
    dropped = ['transformer.decoder.bbox_head.0.layers.0.weight',
               'transformer.enc_output.weight',
               'transformer.reference_points_cap.weight',
               'caption_head.1.core.deformable_att.output_proj.bias',
               'caption_head.0.core.deformable_att.attention_weights.weight',
               ('transformer.reference_points.bias'
                if input_type == 'gt_proposals'
                else 'transformer.pos_trans_norm.weight')]
    unknown = ['caption_head.2.core.deformable_att.output_proj.bias']
    keys = [pre + k for k in kept + dropped + unknown]
    keys += ['sound_model.encoder.layer_norm.weight']
    sd = {f'module.{k}': torch.zeros(1) for k in keys}
    got = reference_state_dict(sd, input_type)
    want = [pre + k for k in kept + unknown]
    if not fusion:
        want.append('sound_model.encoder.layer_norm.weight')
    assert sorted(got) == sorted(want)
