"""The port's matcher takes every decoder layer in one solve on the
predictions' device (the JAX criterion's vmapped matching): its stacked
cost matrices against per-layer ones (bitwise: the train agreement's
matching flips on a few ulps), its assignment against one call per layer,
its indices against JAX's ``hungarian_match`` exactly on shared cost
matrices (ties included), the criterion against
``dvc_tpu.models.criterion.criterion_forward`` (the training slice's
tolerance, 1e-5), and no device-to-host copy in a call, a train step or an
eval step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import tiny_opt, to_numpy, to_torch, train_batch  # noqa: I100

from dvc_tpu.models.criterion import CriterionConfig as JaxCriterionConfig
from dvc_tpu.models.criterion import criterion_forward as jax_criterion
from dvc_tpu.models.matcher import hungarian_match as jax_match
from dvc_tpu_torch.models import matcher
from dvc_tpu_torch.models.criterion import CriterionConfig, criterion_forward
from dvc_tpu_torch.models.matcher import (hungarian_match, match_cost_matrix,
                                          stacked_cost_matrices)
from dvc_tpu_torch.ops.assignment import linear_sum_assignment_ref
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


@pytest.mark.parametrize('costs', ['jax', 'ties'])
def test_indices_equal_jax_on_shared_costs(monkeypatch, costs):
    """Both matchers on the same cost matrices, per layer: JAX's own (the
    port's differ from them in ulps) or integers from a small range, where
    ties abound; padded slots included."""
    import dvc_tpu.models.matcher as jax_matcher
    arrays = _layers(4)
    gt = [arrays[k] for k in ('gt_labels', 'gt_boxes', 'gt_mask')]
    cfg_j = JaxCriterionConfig.from_opt(tiny_opt(max_eseq_length=6)).matcher
    if costs == 'jax':
        shared = np.stack([np.array(jax_matcher.match_cost_matrix(
            cfg_j, jnp.asarray(arrays['pred_logits'][layer], jnp.float32),
            jnp.asarray(arrays['pred_boxes'][layer], jnp.float32),
            *map(jnp.asarray, gt[:2]))) for layer in range(D)])
    else:
        shared = np.random.default_rng(4).integers(
            0, 3, (D, B, NQ, G)).astype(np.float32)
    want = []
    for layer in range(D):
        monkeypatch.setattr(jax_matcher, 'match_cost_matrix',
                            lambda *a, c=shared[layer]: jnp.asarray(c))
        # a new function a layer, so that jit traces each with its costs
        match = jax.jit(lambda *a: jax_match(cfg_j, *a))
        want.append(np.asarray(match(
            jnp.asarray(arrays['pred_logits'][layer]),
            jnp.asarray(arrays['pred_boxes'][layer]), *map(jnp.asarray, gt))))
    monkeypatch.setattr(matcher, 'stacked_cost_matrices',
                        lambda *a: torch.from_numpy(shared))
    t = _torch(arrays)
    got = hungarian_match(_cfg(), t['pred_logits'], t['pred_boxes'],
                          t['gt_labels'], t['gt_boxes'], t['gt_mask'])
    np.testing.assert_array_equal(got.numpy(), np.stack(want))


def test_no_copy_to_the_host_a_call_and_a_step():
    t = _torch(_layers(3))
    outputs = {k: t[k] for k in ('pred_logits', 'pred_count', 'pred_boxes')}
    gt = [t[k] for k in ('gt_labels', 'gt_boxes', 'gt_mask')]
    hungarian_match.copies = 0
    hungarian_match(_cfg(), t['pred_logits'], t['pred_boxes'], *gt)
    criterion_forward(CriterionConfig.from_opt(tiny_opt(max_eseq_length=6)),
                      outputs, *gt)                  # D layers, aux losses
    assert hungarian_match.copies == 0
    # a train step and an eval step match their 2 decoder layers in one
    # solve each, with no copy
    trainer = Trainer(tiny_opt(), device='cpu')
    batch = train_batch(0)
    calls = linear_sum_assignment_ref.calls
    trainer.train_step(batch, 1e-4)
    assert hungarian_match.copies == 0
    assert linear_sum_assignment_ref.calls == calls + 1
    trainer.eval_step(batch)
    assert hungarian_match.copies == 0
    assert linear_sum_assignment_ref.calls == calls + 2
