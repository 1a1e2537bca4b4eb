"""The port's matcher takes every decoder layer in one round trip to the
host (the JAX criterion's vmapped matching): its stacked cost matrices
against per-layer ones (bitwise: the train agreement's matching flips on
a few ulps), its assignment against one call per layer, the criterion
against ``dvc_tpu.models.criterion.criterion_forward`` (the training
slice's tolerance, 1e-5), and its device-to-host copies (one a call, one
a train or eval step).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import tiny_opt, to_numpy, to_torch, train_batch  # noqa: I100

from dvc_tpu.models.criterion import CriterionConfig as JaxCriterionConfig
from dvc_tpu.models.criterion import criterion_forward as jax_criterion
from dvc_tpu_torch.models.criterion import CriterionConfig, criterion_forward
from dvc_tpu_torch.models.matcher import (hungarian_match, match_cost_matrix,
                                          stacked_cost_matrices)
from dvc_tpu_torch.train import Trainer

D, B, NQ, G = 3, 4, 12, 5


def _boxes(rng, *shape):
    return np.stack([rng.uniform(0.1, 0.9, shape),
                     rng.uniform(0.02, 0.4, shape)], -1).astype(np.float32)


def _layers(seed):
    """D layers of random predictions and gt events with padded slots
    (video 1 has 3 of G, video 3 none)."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, G), bool)
    mask[1, 3:] = False
    mask[3] = False
    return {'pred_logits': rng.standard_normal((D, B, NQ, 1)),
            'pred_count': rng.standard_normal((D, B, 7)),
            'pred_boxes': np.stack([_boxes(rng, B, NQ) for _ in range(D)]),
            'gt_labels': np.zeros((B, G), np.int32),
            'gt_boxes': _boxes(rng, B, G) * mask[..., None],
            'gt_mask': mask}


def _torch(arrays):
    return {k: to_torch(v.astype(np.float32) if v.dtype == np.float64 else v)
            for k, v in arrays.items()}


def _cfg():
    return CriterionConfig.from_opt(tiny_opt(max_eseq_length=6)).matcher


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_stacked_match_equals_per_layer_calls(seed):
    t = _torch(_layers(seed))
    gt = (t['gt_labels'], t['gt_boxes'])
    costs = stacked_cost_matrices(_cfg(), t['pred_logits'], t['pred_boxes'],
                                  *gt)
    assert costs.shape == (D, B, NQ, G)
    got = hungarian_match(_cfg(), t['pred_logits'], t['pred_boxes'], *gt,
                          t['gt_mask'])
    assert got.shape == (D, B, G) and got.dtype == torch.int64
    for layer in range(D):
        one = match_cost_matrix(_cfg(), t['pred_logits'][layer],
                                t['pred_boxes'][layer], *gt)
        assert torch.equal(costs[layer], one)               # bit for bit
        want = hungarian_match(_cfg(), t['pred_logits'][layer:layer + 1],
                               t['pred_boxes'][layer:layer + 1], *gt,
                               t['gt_mask'])[0]
        assert torch.equal(got[layer], want)
        for b in range(B):              # distinct queries, padded rows too
            assert len(set(got[layer, b].tolist())) == G


@pytest.mark.parametrize('aux_loss', [True, False])
def test_criterion_matches_jax(aux_loss):
    arrays = _layers(5)
    opt = tiny_opt(max_eseq_length=6, aux_loss=int(aux_loss))
    outputs = {k: arrays[k].astype(np.float32)
               for k in ('pred_logits', 'pred_count', 'pred_boxes')}
    gt = [arrays[k] for k in ('gt_labels', 'gt_boxes', 'gt_mask')]
    want, want_last, want_aux = jax_criterion(
        JaxCriterionConfig.from_opt(opt),
        {k: jnp.asarray(v) for k, v in outputs.items()},
        *map(jnp.asarray, gt), aux_loss=aux_loss)
    got, got_last, got_aux = criterion_forward(
        CriterionConfig.from_opt(opt),
        {k: to_torch(v) for k, v in outputs.items()}, *map(to_torch, gt),
        aux_loss=aux_loss)
    assert sorted(got) == sorted(want)
    assert len(got_aux) == len(want_aux) == (D - 1 if aux_loss else 0)
    for k in want:
        np.testing.assert_allclose(to_numpy(got[k]), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_one_copy_to_the_host_a_call_and_a_step():
    t = _torch(_layers(3))
    outputs = {k: t[k] for k in ('pred_logits', 'pred_count', 'pred_boxes')}
    gt = [t[k] for k in ('gt_labels', 'gt_boxes', 'gt_mask')]
    hungarian_match.copies = 0
    hungarian_match(_cfg(), t['pred_logits'], t['pred_boxes'], *gt)
    assert hungarian_match.copies == 1
    criterion_forward(CriterionConfig.from_opt(tiny_opt(max_eseq_length=6)),
                      outputs, *gt)                  # D layers, aux losses
    assert hungarian_match.copies == 2
    # a train step and an eval step match their 2 decoder layers in one
    trainer = Trainer(tiny_opt(), device='cpu')
    batch = train_batch(0)
    hungarian_match.copies = 0
    trainer.train_step(batch, 1e-4)
    assert hungarian_match.copies == 1
    trainer.eval_step(batch)
    assert hungarian_match.copies == 2
