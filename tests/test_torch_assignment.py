"""The port's assignment solver (``dvc_tpu_torch/ops/assignment.py``, the
plain version that the CPU runs and the card's kernel is held to) against
the JAX package's (``dvc_tpu/ops/assignment.py``) on the same numpy-seeded
f32 costs: col4row exactly equal, ties included (both run the same f32
arithmetic in the same order), for ``linear_sum_assignment``,
``masked_assignment`` (padded rows, a video with no events, nan and +-inf
entries), ``many_to_one_assignment`` and the matcher's
``hungarian_match_m2o``.  Where there are more gt slots than queries (JAX
refuses it) the port's own rule is held to scipy: the total cost within
1e-6 relative in a float64 sum, distinct columns, and -1 where the rule
says.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from torch_port import tiny_opt, to_torch  # noqa: I100

from dvc_tpu.models.criterion import CriterionConfig as JaxCriterionConfig
from dvc_tpu.models.matcher import hungarian_match_m2o as jax_m2o
from dvc_tpu.ops.assignment import linear_sum_assignment as jax_lsa
from dvc_tpu.ops.assignment import many_to_one_assignment as jax_m2o_solve
from dvc_tpu.ops.assignment import masked_assignment as jax_masked
from dvc_tpu_torch.models import matcher
from dvc_tpu_torch.models.criterion import CriterionConfig
from dvc_tpu_torch.ops.assignment import (assignment,
                                          linear_sum_assignment_ref,
                                          many_to_one_assignment,
                                          masked_assignment)

_jax_lsa = jax.jit(jax.vmap(jax_lsa))
_jax_masked = jax.jit(jax.vmap(jax_masked))


def _costs(rng, kind, *shape):
    """f32 costs: standard normal, or integers from a small range (ties
    abound)."""
    if kind == 'ties':
        return rng.integers(0, 3, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('kind,P,R,C', [
    ('normal', 4, 7, 7), ('normal', 4, 5, 12), ('ties', 4, 6, 9),
    ('ties', 3, 8, 8), ('normal', 2, 1, 5), ('ties', 2, 30, 100)])
def test_plain_solver_equals_jax(kind, P, R, C):
    cost = _costs(np.random.default_rng(R * C), kind, P, R, C)
    want = np.asarray(_jax_lsa(jnp.asarray(cost)))
    got = linear_sum_assignment_ref(torch.from_numpy(cost))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    # the wrapper on CPU tensors with every row real: the same
    np.testing.assert_array_equal(assignment(torch.from_numpy(cost)),
                                  want)


def _mask(rng, case, B, G):
    mask = rng.random((B, G)) < 0.6
    mask[:, 0] = True
    if case == 'empty':
        mask[1] = False                  # a video with no events
    return mask


@pytest.mark.parametrize('case,B,G,Nq', [
    ('padded', 5, 6, 9), ('empty', 4, 6, 6), ('nonfinite', 5, 6, 9),
    ('ties', 6, 7, 10), ('ties', 3, 30, 100)])
def test_masked_assignment_equals_jax(case, B, G, Nq):
    rng = np.random.default_rng(B * G + Nq)
    cost = _costs(rng, 'ties' if case == 'ties' else 'normal', B, G, Nq)
    mask = _mask(rng, case, B, G)
    if case == 'nonfinite':
        cost[0, 0, 2] = np.nan
        cost[1, 0, :3] = np.inf
        cost[2, 0, 4] = -np.inf
        cost[3, G - 1, 1] = np.nan       # padded or not, as drawn
        cost[4, :, 0] = np.inf
    want = np.asarray(_jax_masked(jnp.asarray(cost), jnp.asarray(mask)))
    got = masked_assignment(torch.from_numpy(cost), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    for b in range(B):                   # distinct columns, padded rows too
        assert len(set(want[b].tolist())) == G


def _check_more_slots(cost, mask, got):
    """The R > C rule against scipy on one problem's real rows."""
    R, C = cost.shape
    rows = np.flatnonzero(mask)
    real = got[rows]
    kept = real >= 0
    assert kept.sum() == min(len(rows), C)
    used = got[got >= 0]
    assert len(set(used.tolist())) == len(used) and (used < C).all()
    r, c = scipy_lsa(cost[rows].astype(np.float64))
    want = cost[rows][r, c].astype(np.float64).sum()
    total = cost[rows[kept], real[kept]].astype(np.float64).sum()
    np.testing.assert_allclose(total, want, rtol=1e-6, atol=1e-9)
    padded = got[~mask]
    if len(rows) <= C:                   # the unused columns in order, then -1
        free = np.setdiff1d(np.arange(C), real)
        want_pad = np.full(len(padded), -1)
        want_pad[:min(len(free), len(padded))] = free[:len(padded)]
        np.testing.assert_array_equal(padded, want_pad)
    else:
        assert (padded == -1).all()


@pytest.mark.parametrize('sub', ['n <= Nq', 'n > Nq'])
@pytest.mark.parametrize('kind', ['normal', 'ties'])
def test_more_slots_than_queries_against_scipy(sub, kind):
    rng = np.random.default_rng(len(sub) + len(kind))
    B, G, Nq = 8, 12, 5
    cost = _costs(rng, kind, B, G, Nq)
    counts = (rng.integers(0, Nq + 1, B) if sub == 'n <= Nq'
              else rng.integers(Nq + 1, G + 1, B))
    mask = np.zeros((B, G), bool)
    for b, n in enumerate(counts):
        mask[b, rng.permutation(G)[:n]] = True
    got, steps = assignment(torch.from_numpy(cost), torch.from_numpy(mask),
                            with_steps=True)
    got = got.numpy()
    for b in range(B):
        _check_more_slots(cost[b], mask[b], got[b])
    # a Dijkstra step at least for each row the rule solves
    np.testing.assert_array_less(np.minimum(counts, Nq) - 1, steps.numpy())


@pytest.mark.parametrize('rate', [4, 2])
def test_many_to_one_assignment_equals_jax(rate):
    rng = np.random.default_rng(rate)
    B, R, C = 4, 3, 13
    cost = _costs(rng, 'normal', B, R, C)
    cost[3] = np.round(cost[3])          # ties
    mask = np.array([[1, 1, 1], [1, 0, 1], [0, 0, 0], [1, 1, 0]], bool)
    want = np.asarray(jax.jit(jax.vmap(
        lambda c, m: jax_m2o_solve(c, m, rate)))(
            jnp.asarray(cost), jnp.asarray(mask)))
    got = many_to_one_assignment(torch.from_numpy(cost),
                                 torch.from_numpy(mask), rate)
    assert got.shape == (B, rate, R)
    np.testing.assert_array_equal(got.numpy(), want)


def test_hungarian_match_m2o_equals_jax(monkeypatch):
    """Both packages' m2o matchers on shared cost matrices (JAX's: the two
    packages' own differ in ulps, and XLA's fusions move JAX's too) give
    the same indices; the port's own costs agree with JAX's to the
    training slice's 1e-5."""
    import dvc_tpu.models.matcher as jax_matcher
    rng = np.random.default_rng(11)
    B, Nq, G = 3, 12, 3
    logits = rng.standard_normal((B, Nq, 1)).astype(np.float32)
    boxes = np.stack([rng.uniform(0.1, 0.9, (B, Nq)),
                      rng.uniform(0.02, 0.4, (B, Nq))], -1).astype(np.float32)
    gt_boxes = np.stack([rng.uniform(0.1, 0.9, (B, G)),
                         rng.uniform(0.02, 0.4, (B, G))], -1).astype(np.float32)
    labels = np.zeros((B, G), np.int32)
    mask = np.array([[1, 1, 1], [1, 0, 0], [0, 0, 0]], bool)
    opt = tiny_opt()
    cfg_j = JaxCriterionConfig.from_opt(opt).matcher
    cfg_t = CriterionConfig.from_opt(opt).matcher
    arrays = (logits, boxes, labels, gt_boxes)
    shared = np.array(jax_matcher.match_cost_matrix(
        cfg_j, *map(jnp.asarray, arrays)))
    np.testing.assert_allclose(
        matcher.match_cost_matrix(cfg_t, *map(to_torch, arrays)).numpy(),
        shared, rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(jax_matcher, 'match_cost_matrix',
                        lambda *a: jnp.asarray(shared))
    monkeypatch.setattr(matcher, 'match_cost_matrix',
                        lambda *a: torch.from_numpy(shared))
    # a function of its own, so that jit traces it with the shared costs
    want = np.asarray(jax.jit(lambda *a: jax_m2o(cfg_j, *a, rate=4))(
        *map(jnp.asarray, arrays), jnp.asarray(mask)))
    got = matcher.hungarian_match_m2o(cfg_t, *map(to_torch, arrays),
                                      to_torch(mask), rate=4)
    assert got.shape == (B, 4, G) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_cpu_tensors_take_the_plain_version():
    cost = torch.from_numpy(_costs(np.random.default_rng(0), 'normal',
                                   2, 3, 4))
    calls, launches = (linear_sum_assignment_ref.calls,
                       assignment.launches)
    assignment(cost, torch.ones(2, 3, dtype=torch.bool))
    assert linear_sum_assignment_ref.calls == calls + 1
    assert assignment.launches == launches
    with pytest.raises(ValueError, match='R <= C'):
        linear_sum_assignment_ref(cost.transpose(1, 2))
