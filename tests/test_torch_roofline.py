"""The port's step count (``dvc_tpu_torch/utils/roofline.py``) against JAX.

(a) Each hand-written op's count function against a walk of the JAX
    oracle's jaxpr (or of its VJP given the residuals, for a backward):
    products (``dot_general``, ``conv``) 2 FLOPs a multiply-add, ``scan``
    bodies times their length, each elementwise arithmetic primitive 1 FLOP
    an output element, a reduction its input's size, a scatter-add its
    updates' size, data movement free.  An op is counted by the least work
    of its function, so the walk's stated gaps are closed first
    (``least_work``): the DSA oracles' one-hot lerp matrix and its product
    with value_t become a gather and lerp, and the scores' taps . Wc (the
    decode's embed[it] . token_w) take the table form where it is less.
    Products must then be equal; the total may differ by at most 5% (the
    largest gap each op showed is written beside its case).
(b) A small FusionPDVC's f32 train step and eval step: the port's torch
    part (FlopCounterMode outside the hand-written ops) against the
    ``dot_general``/``conv`` FLOPs of the JAX train step's and eval
    apply's jaxprs outside every ``pallas_call``, within 1%.
(c) The same step counted twice, the second time with every plain version
    inside a wrapper swapped for a stub that charges the same count and
    runs no torch product: the counts are equal.
(d) ``roofline()`` against JAX's on the same costs, time and peaks.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import tiny_opt, train_batch  # noqa: I100

from dvc_tpu.ops.dsa_greedy import dsa_greedy_scan_ref as jax_greedy
from dvc_tpu.ops.dsa_scan import dsa_teacher_scan_ref as jax_scan
from dvc_tpu.ops.dsa_step import dsa_lstm_step_ref as jax_lstm_step
from dvc_tpu.ops.dsa_step import dsa_sample_attend_ref as jax_step
from dvc_tpu.ops.ms_deform_attn import ms_deform_attn_ref as jax_msda
from dvc_tpu_torch.ops import dsa_greedy, dsa_scan, dsa_step
from dvc_tpu_torch.ops.ms_deform_attn import msda_bwd_cost, msda_cost
from dvc_tpu_torch.utils import roofline

# --------------------------------------------------------------------------
# the jaxpr walk
# --------------------------------------------------------------------------

ELEMENTWISE = {
    'add', 'add_any', 'sub', 'mul', 'div', 'neg', 'max', 'min', 'abs', 'sign',
    'floor', 'ceil', 'round', 'exp', 'exp2', 'log', 'log1p', 'expm1', 'tanh',
    'logistic', 'sqrt', 'rsqrt', 'cbrt', 'pow', 'integer_pow', 'square',
    'erf', 'erf_inv', 'select_n', 'clamp', 'eq', 'ne', 'lt', 'le', 'gt', 'ge',
    'and', 'or', 'not', 'xor', 'rem', 'atan2', 'sin', 'cos', 'is_finite',
    'nextafter'}
REDUCTIONS = {'reduce_sum', 'reduce_max', 'reduce_min', 'reduce_prod',
              'reduce_and', 'reduce_or', 'argmax', 'argmin', 'cumsum',
              'cummax', 'cummin', 'cumprod', 'cumlogsumexp'}


def _size(aval):
    return int(np.prod(aval.shape))


def _sub_jaxprs(eqn):
    for v in eqn.params.values():
        j = getattr(v, 'jaxpr', v)
        if hasattr(j, 'eqns'):
            yield j


def walk(jaxpr, mult=1, acc=None, skip=('pallas_call',), tag=None):
    """FLOPs of a jaxpr by the convention above: {'product': ...,
    'elementwise': ...}; equations named in ``skip`` count nothing.
    ``tag(eqn, kind)`` may name another key for an equation ('product' or
    'elementwise' then counts it not)."""
    acc = collections.Counter() if acc is None else acc

    def add(eqn, kind, flops):
        acc[(tag and tag(eqn, kind)) or kind] += mult * flops
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        if name in skip:
            continue
        if name == 'scan':
            walk(eqn.params['jaxpr'].jaxpr, mult * eqn.params['length'], acc,
                 skip, tag)
        elif name == 'cond':
            acc.update(max((walk(b.jaxpr, mult, skip=skip, tag=tag)
                            for b in eqn.params['branches']),
                           key=lambda c: sum(c.values())))
        elif name == 'dot_general':
            (contract, _), _ = eqn.params['dimension_numbers']
            k = int(np.prod([eqn.invars[0].aval.shape[i] for i in contract]))
            add(eqn, 'product', 2 * _size(eqn.outvars[0].aval) * k)
        elif name == 'conv_general_dilated':
            # a transposed (input-dilated) convolution's inserted zeros
            # are not multiply-adds
            rhs = eqn.invars[1].aval.shape
            fan_in = int(np.prod(rhs)) // rhs[
                eqn.params['dimension_numbers'].rhs_spec[0]]
            zeros = int(np.prod(eqn.params['lhs_dilation']))
            add(eqn, 'product', 2 * _size(eqn.outvars[0].aval) * fan_in
                // zeros)
        elif name in ELEMENTWISE:
            add(eqn, 'elementwise', _size(eqn.outvars[0].aval))
        elif name in REDUCTIONS:
            add(eqn, 'elementwise', _size(eqn.invars[0].aval))
        elif name == 'scatter-add':
            add(eqn, 'elementwise', _size(eqn.invars[2].aval))
        elif name != 'scatter':
            for j in _sub_jaxprs(eqn):
                walk(j, mult, acc, skip, tag)
    return acc


def lerp_tagger(rows, score_shape=None, embed_shape=None):
    """``walk``'s ``tag`` that names the work the oracles do in a form no
    least count takes: every product and elementwise equation with an axis
    of a value-row count in ``rows`` (S, or a level's length), the one-hot
    lerp matrix, its product with value_t and their VJPs ('one_hot_*'),
    where a gather and lerp does the same; and the products with a weight
    of ``score_shape`` (Wc, (Dh, A): taps . Wc and its VJP, 'score') or
    ``embed_shape`` (token_w, (E, 4R): embed[it] . token_w, 'embed'),
    which a table form may do for less."""
    def tag(eqn, kind):
        avals = [v.aval for v in (eqn.invars + eqn.outvars)
                 if hasattr(v.aval, 'shape')]
        shapes = [tuple(a.shape) for a in avals]
        if any(d in rows for s in shapes for d in s):
            return f'one_hot_{kind}'
        if kind != 'product':
            return None
        for name, w in (('score', score_shape), ('embed', embed_shape)):
            if w is not None and any(s in (w, w[::-1]) for s in shapes):
                return name
        return None
    return tag


def oracle_count(fn, args, backward=False, tag=None):
    """The walk of ``fn(*args)``, or with ``backward`` of its VJP given the
    residuals (``jax.vjp``'s function, traced on its own)."""
    if not backward:
        return walk(jax.make_jaxpr(fn)(*args).jaxpr, tag=tag)
    out, vjp = jax.vjp(fn, *args)
    return walk(jax.make_jaxpr(vjp)(out).jaxpr, tag=tag)


# --------------------------------------------------------------------------
# (a) each op's count against its oracle
# --------------------------------------------------------------------------

DTYPES = {'float32': (jnp.float32, torch.float32),
          'bfloat16': (jnp.bfloat16, torch.bfloat16)}


def _pair(shapes, dtype):
    """The same shapes as JAX zeros and torch (empty) tensors."""
    jd, td = DTYPES[dtype]
    return ([jnp.zeros(s, jd) for s in shapes],
            [torch.zeros(s, dtype=td) for s in shapes])


MSDA_SHAPES = {'small': dict(B=2, Q=5, H=2, D=8, P=3, levels=(7, 4)),
               'wide': dict(B=1, Q=6, H=4, D=16, P=2, levels=(9, 5, 3))}
# no other axis of an operand is as long as S or a level, and none but Wc
# is (Dh, A) or token_w (E, 4R) (``lerp_tagger``); the scores take the
# table form in the scans and the wide word step, the embedding's
# product the table form in the small decode
STEP_SHAPES = {'small': dict(B=2, H=2, Dh=8, Q=3, P=2, A=10, R=6, K=3,
                             levels=(7, 5), V1=9, E=4),
               'wide': dict(B=1, H=4, Dh=16, Q=4, P=3, A=12, R=6, K=2,
                            levels=(11, 13, 5), V1=10, E=4)}


def _msda_case(shape, dtype):
    c = MSDA_SHAPES[shape]
    B, Q, H, D, P, levels = (c[k] for k in ('B', 'Q', 'H', 'D', 'P',
                                            'levels'))
    L, S = len(levels), sum(levels)
    jargs, targs = _pair([(B, S, H, D), (B, Q, H, L, P), (B, Q, H, L, P)],
                         dtype)
    return levels, jargs, targs


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', list(MSDA_SHAPES))
@pytest.mark.parametrize('backward', [False, True])
def test_msda_count_is_the_oracles(shape, dtype, backward):
    """Gap: 0 (forward), 0 (backward)."""
    levels, jargs, targs = _msda_case(shape, dtype)
    want = oracle_count(lambda v, l, a: jax_msda(v, levels, l, a), jargs,
                        backward)
    cost = msda_bwd_cost if backward else msda_cost
    _check(cost(targs[0], levels, *targs[1:])[0], want, 0)


def _check(got, want, products, tol=0.05):
    total = want['product'] + want['elementwise']
    gap = abs(got - total) / total
    assert products == want['product']
    assert gap <= tol, f'{got} against {total}: gap {gap:.4f}'


def least_work(c, fn, args, taps, backward=False):
    """The walk of a DSA oracle with its stated gaps closed (the least work
    of its function): the one-hot lerp matrix, its product with value_t
    and their VJPs (``lerp_tagger``) taken as a gather and lerp, 3*Dh a
    tap (the word steps' oracles gather in the forward), and its VJP as
    ``ms_deform_attn_ref``'s gather's, 8*Dh a tap;
    the scores' taps . Wc (and the decode's embed[it] . token_w) in the
    table form where that is less: VW = value . Wc once (two products of
    its size in the backward) and a lerp of two of its rows a tap (3A; its
    VJP 8A), embed . token_w once.  ``taps``: the taps of the call."""
    B, H, Dh, A, R, E, V1 = (c[k] for k in ('B', 'H', 'Dh', 'A', 'R', 'E',
                                             'V1'))
    levels = c['levels']
    S = sum(levels)
    k = 2 if backward else 1
    walked = oracle_count(fn, args, backward, lerp_tagger(
        set(levels) | {S}, (Dh, A), (E, 4 * R)))
    # the walk takes each tap's row times Wc
    assert walked['score'] == 2 * k * taps * Dh * A
    scores = min((walked['score'], 0),
                 (2 * k * B * H * S * Dh * A, (8 if backward else 3) * taps
                  * A), key=sum)
    # the word steps' forward gathers already
    gather = (8 if backward else 3) * taps * Dh if walked[
        'one_hot_product'] else 0
    return {'product': (walked['product'] + scores[0]
                        + min(walked['embed'], 2 * V1 * E * 4 * R)),
            'elementwise': walked['elementwise'] + scores[1] + gather}


def _scan_shapes(c, greedy=False):
    B, H, Dh, Q, P, A, R, K, levels = (c[k] for k in (
        'B', 'H', 'Dh', 'Q', 'P', 'A', 'R', 'K', 'levels'))
    S, LP = sum(levels), len(levels) * P
    head = [(B, H, S, Dh), (B, H, Q, LP), (B, Q, LP)]
    mid = ([(B, Q, 4 * R), (c['V1'], c['E']), (c['E'], 4 * R),
            (R, c['V1']), (c['V1'],)] if greedy else [(B, K, Q, 4 * R)])
    weights = [(H, R, LP), (R, A), (A,), (Dh, A), (A,), (A,), (),
               (H, Dh, 4 * R), (R, 4 * R)]
    return head + mid + weights


def _taps(c, steps=1):
    return steps * c['B'] * c['H'] * c['Q'] * len(c['levels']) * c['P']


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', list(STEP_SHAPES))
@pytest.mark.parametrize('backward', [False, True])
def test_scan_count_is_the_oracles(shape, dtype, backward):
    """Gap: 0 (forward); 0.009-0.031% (backward: per-step constants of
    the weights' cotangent sums that the count leaves out)."""
    c = STEP_SHAPES[shape]
    levels = c['levels']
    jargs, targs = _pair(_scan_shapes(c), dtype)
    # the oracle's carry takes value_t's type and its taps are f32: value_t
    # stays f32 in the bf16 case (as the bf16 head keeps it)
    jargs[0], targs[0] = jargs[0].astype(jnp.float32), targs[0].float()
    want = least_work(c, lambda *a: jax_scan(*a, levels)[0], jargs,
                      _taps(c, c['K']), backward)
    cost = dsa_scan.scan_bwd_cost if backward else dsa_scan.scan_cost
    products = dsa_scan.scan_flops(*targs, backward=backward)[0]
    _check(cost(*targs)[0], want, products)


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', list(STEP_SHAPES))
def test_greedy_count_is_the_oracles(shape, dtype):
    """Gap: 0."""
    c = STEP_SHAPES[shape]
    levels, K = c['levels'], c['K']
    jargs, targs = _pair(_scan_shapes(c, greedy=True), dtype)
    want = least_work(c, lambda *a: jax_greedy(*a, levels, K), jargs,
                      _taps(c, K))
    products = dsa_greedy.greedy_flops(targs[0], targs[1], targs[4],
                                       targs[9], targs[16], K)[0]
    _check(dsa_greedy.greedy_cost(*targs, levels, K)[0], want, products)


def _step_shapes(c, lstm):
    B, H, Dh, Q, P, A, R, levels = (c[k] for k in (
        'B', 'H', 'Dh', 'Q', 'P', 'A', 'R', 'levels'))
    L, S = len(levels), sum(levels)
    jax_shapes = [(B, S, H, Dh), (B, Q, H, L, P), (B, Q, L), (B, Q, L),
                  (B, Q, A)]
    if lstm:
        jax_shapes += [(B, Q, 4 * R), (B, Q, R), (B, Q, R), (H * Dh, 4 * R),
                       (R, 4 * R)]
    jax_shapes += [(Dh, A), (A,), (A,), ()]
    # the port's boundary: value_t (B, H, S, Dh), pos (B, H, Q, LP), hvec, h
    port = [(B, H, S, Dh), (B, H, Q, L * P), (B, Q, A), (B, Q, R)]
    return jax_shapes, port


@pytest.mark.parametrize('dtype', list(DTYPES))
@pytest.mark.parametrize('shape', list(STEP_SHAPES))
@pytest.mark.parametrize('lstm', [False, True])
@pytest.mark.parametrize('backward', [False, True])
def test_word_step_count_is_the_oracles(shape, dtype, lstm, backward):
    """Gap: 0 (forwards); 0.007-0.038% (backwards: terms of a few elements
    a query that the count leaves out)."""
    c = STEP_SHAPES[shape]
    levels = c['levels']
    jax_shapes, port_shapes = _step_shapes(c, lstm)
    jargs, _ = _pair(jax_shapes, dtype)
    _, (value_t, pos, hvec, h) = _pair(port_shapes, dtype)
    oracle = jax_lstm_step if lstm else jax_step
    want = least_work(c, lambda *a: oracle(*a, levels), jargs, _taps(c),
                      backward)
    L = len(levels)
    if lstm:
        got = (dsa_step.lstm_step_bwd_cost(value_t, pos, hvec, h, L)
               if backward else dsa_step.lstm_step_cost(value_t, pos, hvec,
                                                        h))[0]
    else:
        got = (dsa_step.sample_attend_bwd_cost(value_t, pos, hvec, L)
               if backward else dsa_step.sample_attend_cost(value_t, pos,
                                                            hvec))[0]
    products = dsa_step.step_flops(value_t, pos, hvec, h if lstm else None,
                                   L if backward else None)[0]
    _check(got, want, products)


@pytest.mark.parametrize('shape', list(STEP_SHAPES))
@pytest.mark.parametrize('backward', [False, True])
def test_word_step_with_vw_given_counts_the_lerp_alone(shape, backward):
    """The count of a kernel alone with VW = value . Wc given: the step's
    least work less the table's products, and its lerp where the step took
    the direct form; the bytes read VW for Wc."""
    c = STEP_SHAPES[shape]
    _, (value_t, pos, hvec, _) = _pair(_step_shapes(c, False)[1], 'float32')
    L = len(c['levels']) if backward else None
    n, A, Dh = _taps(c), c['A'], c['Dh']
    full = dsa_step.step_flops(value_t, pos, hvec, L=L)
    given = dsa_step.step_flops(value_t, pos, hvec, L=L, vw_given=True)
    k = 2 if backward else 1
    lerp = (8 if backward else 3) * n * A
    table = 2 * k * c['B'] * c['H'] * sum(c['levels']) * Dh * A
    if full[1] == given[1]:                     # the table form
        assert full[0] - given[0] == table
    else:                                       # the direct form
        assert (full[0] - given[0], given[1] - full[1]) == (
            2 * k * n * Dh * A, lerp)
    vw = c['B'] * c['H'] * sum(c['levels']) * A
    cost = dsa_step.sample_attend_cost
    assert (cost(value_t, pos, hvec, vw_given=True)[1]
            - cost(value_t, pos, hvec)[1]) == 4 * (vw - Dh * A)


# --------------------------------------------------------------------------
# (b) the step outside the kernels
# --------------------------------------------------------------------------

def _jax_products(closed):
    """Products of a jaxpr outside its ``pallas_call`` equations, after
    dead-code elimination (what XLA would compile)."""
    from jax._src.interpreters import partial_eval as pe
    jaxpr, _ = pe.dce_jaxpr(closed.jaxpr, [True] * len(closed.jaxpr.outvars))
    return walk(jaxpr)['product']


def _box_head_recompute(opt, B):
    """FLOPs of the JAX heads' bbox MLP (d -> d -> d -> 2) over one decoder
    layer's B*Nq queries, which the JAX model computes once more than the
    port: under ``with_box_refine`` the port takes the last layer's box
    deltas from the decoder's refinement."""
    d, n = opt.hidden_dim, B * opt.num_queries
    return 2 * n * (2 * d * d + 2 * d) if opt.with_box_refine else 0


@pytest.fixture(scope='module')
def flagship_small(monkeypatch_module):
    """A small FusionPDVC (2+2 layers, narrow widths) in both packages: the
    JAX trainer with every kernel a ``pallas_call`` (interpret mode; the
    MSDA backward the analytic kernel's), its parameters' shapes, and the
    port's CPU trainer."""
    import importlib
    from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
    from dvc_tpu.train.trainer import Trainer as JaxTrainer
    from dvc_tpu_torch.train import Trainer
    monkeypatch_module.setattr(
        importlib.import_module('dvc_tpu.ops.ms_deform_attn'), '_BWD_IMPL',
        'pallas')
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   msda_impl='pallas_interpret')
    batch = train_batch(1)
    jt = JaxTrainer(opt, model=jax_make_fusion(opt))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.eval_shape(lambda b: jt.model.init(
        {'params': jax.random.PRNGKey(0)}, b, eval_mode=False,
        deterministic=True, ss_enabled=False), jb)
    opt_state = jax.eval_shape(jt.tx.init, params)
    return opt, batch, jt, jb, params, opt_state, Trainer(opt, device='cpu')


@pytest.fixture(scope='module')
def monkeypatch_module():
    with pytest.MonkeyPatch.context() as mp:
        yield mp


def test_train_step_products_outside_the_kernels_are_jaxs(flagship_small):
    """Measured: the port 0.82% under JAX before the named hoist, 0.21%
    after it; the rest is the embedding lookup's one-hot VJP in JAX
    (``dvc_tpu/ops/embed.py``), a product the port's index backward does
    not make."""
    opt, batch, jt, jb, params, opt_state, trainer = flagship_small
    want = _jax_products(jax.make_jaxpr(lambda p, o, b: jt._train_step_impl(
        p, o, b, 1e-3, 0.0, jax.random.PRNGKey(0)))(params, opt_state, jb))
    got = roofline.step_costs(lambda b: trainer.train_step(b, 1e-3), batch,
                              weights=trainer.params, train=True)
    assert {'msda_fwd', 'msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd',
            'assignment'} <= set(got['ops'])
    port = got['torch_flops'] + _box_head_recompute(opt, 2)
    assert abs(port - want) <= 0.01 * want, (port, want)


def test_eval_step_products_outside_the_kernels_are_jaxs(flagship_small):
    """Measured: the port 1.95% under JAX before the named hoist, equal
    after it."""
    opt, batch, jt, jb, params, opt_state, trainer = flagship_small
    want = _jax_products(jax.make_jaxpr(
        lambda p, b: jt.model.apply(p, b, eval_mode=True))(params, jb))
    got = roofline.step_costs(trainer.eval_step, batch,
                              weights=trainer.params)
    assert {'msda_fwd', 'dsa_greedy', 'assignment'} <= set(got['ops'])
    port = got['torch_flops'] + _box_head_recompute(opt, 2)
    assert abs(port - want) <= 0.01 * want, (port, want)


# --------------------------------------------------------------------------
# (c) the switch between a wrapper's branches
# --------------------------------------------------------------------------

class _Stub(torch.autograd.Function):
    """Zeros of the given shapes and types in place of a plain version's
    outputs, no product in either direction; the backward gives each input
    a zero gradient, so the graph around the wrapper runs as before."""

    @staticmethod
    def forward(ctx, outs, *inputs):
        ctx.meta = [(t.shape, t.dtype) for t in inputs]
        res = tuple(torch.zeros(s, dtype=d) for s, d in outs)
        ctx.mark_non_differentiable(*[r for r in res
                                      if not r.is_floating_point()])
        return res

    @staticmethod
    def backward(ctx, *grads):
        return (None, *[torch.zeros(s, dtype=d) if d.is_floating_point
                        else None for s, d in ctx.meta])


def _stubbed(outs):
    """A stand-in for a plain version whose outputs ``outs(*args)`` gives
    as (shape, dtype) pairs."""
    def plain(*args, **kw):
        res = _Stub.apply(outs(*args), *[a for a in args
                                         if torch.is_tensor(a)])
        return res[0] if len(res) == 1 else res
    return plain


def _stub_plain_versions(mp):
    import importlib
    f32, i32 = torch.float32, torch.int32
    msda = importlib.import_module('dvc_tpu_torch.ops.ms_deform_attn')
    mp.setattr(msda, 'ms_deform_attn_ref', _stubbed(
        lambda v, shapes, loc, a: [(loc.shape[:2] + (v.shape[2] * v.shape[3],),
                                    f32)]))
    mp.setattr(dsa_scan, 'dsa_teacher_scan_ref', _stubbed(
        lambda *a: [(a[3].shape[:3] + (a[12].shape[0],), f32)] * 2))
    mp.setattr(dsa_greedy, 'dsa_greedy_scan_ref', _stubbed(
        lambda *a: [((a[0].shape[0], a[18], a[3].shape[1]), i32),
                    ((a[0].shape[0], a[18], a[3].shape[1]), f32)]))
    assignment = importlib.import_module('dvc_tpu_torch.ops.assignment')
    mp.setattr(assignment, 'assignment_ref',
               lambda cost, mask=None, with_steps=False: torch.arange(
                   cost.shape[-2]).expand(cost.shape[:-1]).clone())


@pytest.mark.parametrize('what', ['train', 'eval'])
def test_the_plain_versions_leak_nothing_into_the_count(flagship_small,
                                                        what):
    opt, batch, jt, jb, params, opt_state, trainer = flagship_small

    def count():
        if what == 'train':
            return roofline.step_costs(
                lambda b: trainer.train_step(b, 1e-3), batch,
                weights=trainer.params, train=True)
        return roofline.step_costs(trainer.eval_step, batch,
                                   weights=trainer.params)
    plain = count()
    with pytest.MonkeyPatch.context() as mp:
        _stub_plain_versions(mp)
        stubbed = count()
    assert plain['ops'] == stubbed['ops']
    assert plain['torch_flops'] == stubbed['torch_flops']
    assert (plain['flops'], plain['bytes']) == (stubbed['flops'],
                                                 stubbed['bytes'])


# --------------------------------------------------------------------------
# (d) roofline() against JAX's
# --------------------------------------------------------------------------

@pytest.mark.parametrize('costs', [
    {'flops': 3.2e12, 'bytes': 1.1e9, 'source': 'counted'},
    {'flops': 7.5e11, 'bytes': 2.6e10, 'source': 'counted'},
    {'flops': 5e11, 'bytes': None}])
@pytest.mark.parametrize('seconds', [0.0131, 0.25])
def test_roofline_fields_are_jaxs(monkeypatch, costs, seconds):
    from dvc_tpu.utils import roofline as jax_roofline
    peak = (989e12, 3.35e12)
    monkeypatch.setattr(jax_roofline, 'device_peak', lambda device=None: peak)
    monkeypatch.setattr(roofline, 'device_peak', lambda device=None: peak)
    assert roofline.roofline(costs, seconds) == jax_roofline.roofline(
        costs, seconds)
    assert roofline.roofline(costs, float('nan')) is None


def test_device_peak_reads_the_cards_name(monkeypatch):
    """The data-sheet rows by the card's name; the CPU and unknown cards
    have none."""
    assert roofline.device_peak('cpu') is None
    for name, want in (('NVIDIA H100 80GB HBM3', (989e12, 3.35e12)),
                       ('NVIDIA H100 PCIe', (756e12, 2.0e12)),
                       ('NVIDIA H100 NVL', (835.5e12, 3.9e12)),
                       ('NVIDIA A100-SXM4-80GB', None)):
        monkeypatch.setattr(torch.cuda, 'get_device_name',
                            lambda device=None, n=name: n)
        assert roofline.device_peak(torch.device('cuda', 0)) == want
    assert roofline.roofline({'flops': 1.0, 'bytes': 1.0}, 1.0,
                             'cpu') is None


def test_step_bytes_are_the_least_any_implementation_moves():
    """Weights read once (train: also written, and two AdamW moments read
    and written), the batch read once, the outputs written once; the
    intermediates and the hand-written ops' own bytes add nothing."""
    lin = torch.nn.Linear(8, 4)
    x = torch.randn(3, 8)
    weights = list(lin.parameters())
    w_bytes = roofline.nbytes(*weights)

    def step(x):
        loss = (lin(x).tanh() ** 2).sum()
        loss.backward()
        return loss
    got = roofline.step_costs(step, x, weights=weights, train=True)
    assert got['bytes'] == x.nbytes + 4 + 6 * w_bytes
    # the product and the weight's gradient (x needs none)
    assert got['flops'] == got['torch_flops'] == 2 * 2 * 3 * 8 * 4
    got = roofline.step_costs(lambda x: lin(x), x, weights=weights)
    assert got['bytes'] == x.nbytes + 3 * 4 * 4 + w_bytes
    assert got['source'] == 'counted' and got['ops'] == {}
