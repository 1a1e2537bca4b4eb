"""Port parity of the stepwise caption path in bf16 (``--tpu_compute_dtype
bfloat16`` with scheduled sampling, ``--dsa_scan_fuse 0``,
``--dsa_greedy_fuse 0``, ``--dsa_lstm_fuse 1``, ``--caption_sample_max 0``
or ``--num_layers`` 2): the plain bf16 word steps of
``dvc_tpu_torch.ops.dsa_bf16`` (K7-bf16 to K10-bf16's plain versions)
against the JAX package's Pallas kernels in interpret mode at
``precision='bfloat16'`` (``_pallas_core``, ``_pallas_lstm_core``), which
round both operands of every in-kernel product to bf16 and accumulate in
f32; the JAX jnp references ignore ``precision``, so interpret mode is the
reference.  Then the bf16 caption head's stepwise routes against the JAX
head (``att_impl='pallas_interpret'``, ``att_precision='bfloat16'``) on the
same weights (the Trainer: ``tests/test_torch_bf16_step_train.py``).

Tolerances of the word steps (those of K4-K6's plain bf16 versions): the
same rounding points with f32 accumulation, so outputs within 1e-5, each
gradient within 1e-4 of its largest magnitude, and d alpha_b (zero in
exact arithmetic) within 1e-5 absolute; sampling points drawn off the tap boundaries
(``test_torch_dsa_step.make_inputs``).

The card kernels compute the table form (``table=True``: the scores a lerp
of two rows of bf16(value) . bf16(Wc), the taps never rounded; dvalue's
scores term and dWc from bf16(G)).  Its gap to the product form is held
below the plain f32 version's distance from the product form, output by
output and gradient by gradient (relative L2), and the bf16 versions lie
a nonzero distance from f32 (they round).

The head against JAX, with ``tests/test_torch_bf16_model.py``'s head
tests' tolerances: the port's CPU head runs the plain bf16 word steps in
the TPU kernels' product form (the card's table form lies from JAX up to
1.1x as far as f32 does in the head's weight gradients, ctx2att's and
alpha_net's), so log-probs within 1e-4 relative L2, weight gradients 1e-3
(+1e-6 absolute for alpha_net's bias), greedy tokens equal up to a query's
first near-tie (top-2 logit margin under 1e-3 in the port's decode) and
their log-probs within 1e-4 there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import (caption_head_state_dict, to_numpy,  # noqa: I100
                        to_torch)

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxHead
from dvc_tpu.ops.dsa_step import _pallas_core, _pallas_lstm_core
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.ops import dsa_bf16
from dvc_tpu_torch.ops.dsa_step import (
    LSTM_NAMES, STEP_NAMES, dsa_lstm_step_bwd, dsa_lstm_step_core,
    dsa_lstm_step_fwd, dsa_lstm_step_table_core, dsa_sample_attend_bwd,
    dsa_sample_attend_core, dsa_sample_attend_fwd,
    dsa_sample_attend_table_core, lstm_step_bwd_ref, lstm_step_ref,
    sample_attend_bwd_ref, sample_attend_ref)
from dvc_tpu_torch.ops.dsa_tables import (dsa_value_table, table_gemm,
                                          table_gemm_bwd, table_gemm_ref)
from test_torch_dsa_step import TS, boundary, make_inputs

BF16 = 'bfloat16'
MARGIN = 1e-3


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def step_ops(H, lstm, seed, **kw):
    """The kernels' operands at the JAX boundary (numpy) of one word step,
    B=2, Q=3, points off the tap boundaries."""
    return boundary(make_inputs(seed=seed, H=H, R=24 if lstm else None, **kw),
                    lstm=lstm)


def jax_kernel(ops, lstm, cot=None):
    """The JAX Pallas kernel of the step at precision='bfloat16' in
    interpret mode: its output(s), or with the cotangent(s) ``cot`` its
    backward kernel's gradients in the operands' order."""
    jops = [jnp.asarray(a) for a in ops]
    B, H, Q, LP = ops[1].shape
    jops[1] = jops[1].reshape(B, H, Q * LP)
    core = _pallas_lstm_core if lstm else _pallas_core
    if cot is None:
        out = core(*jops, TS, Q, True, BF16)
        return tuple(out) if lstm else (out,)
    g = tuple(map(jnp.asarray, cot)) if lstm else jnp.asarray(cot[0])
    return core(*jops, TS, Q, True, BF16, backward=True, g=g)


def plain(lstm):
    """(forward, backward, operand names) of the plain bf16 word step."""
    if lstm:
        return dsa_bf16.lstm_step_fwd, dsa_bf16.lstm_step_bwd, LSTM_NAMES
    return dsa_bf16.sample_attend_fwd, dsa_bf16.sample_attend_bwd, STEP_NAMES


def tup(x):
    return x if isinstance(x, tuple) else (x,)


def cotangents(outs):
    return tuple(torch.sin(3.0 * o) if i == 0 else torch.cos(2.0 * o)
                 for i, o in enumerate(outs))


@pytest.mark.parametrize('lstm', [False, True])
@pytest.mark.parametrize('H', [1, 2])
def test_plain_bf16_word_step_matches_jax_kernel(H, lstm):
    """Forward and every gradient (7 of K8, 12 of K10) of the plain bf16
    word step against the JAX kernels at precision='bfloat16'."""
    ops = step_ops(H, lstm, seed=20 + H)
    targs = [to_torch(a) for a in ops]
    fwd, bwd, names = plain(lstm)
    outs = tup(fwd(*targs, TS))
    for a, b in zip(outs, jax_kernel(ops, lstm)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    cot = cotangents(outs)
    got = bwd(*targs, TS, *cot)
    want = jax_kernel(ops, lstm, [to_numpy(c) for c in cot])
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        b = np.asarray(b)
        tol = 1e-5 if name == 'ab' else 1e-4 * np.abs(b).max()
        np.testing.assert_allclose(to_numpy(a).reshape(b.shape), b, rtol=0,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize('lstm', [False, True])
@pytest.mark.parametrize('H', [1, 2])
def test_table_form_gap(H, lstm):
    """The card kernels' table form against the product form: the output(s)
    and each gradient (but d alpha_b) closer to it than the plain f32
    version is, and the product form a nonzero distance from f32."""
    ops = [to_torch(a) for a in step_ops(H, lstm, seed=30 + H, Q=4)]
    fwd, bwd, names = plain(lstm)
    f32_fwd, f32_bwd = ((lstm_step_ref, lstm_step_bwd_ref) if lstm
                        else (sample_attend_ref, sample_attend_bwd_ref))
    outs = tup(fwd(*ops, TS))
    table = tup(fwd(*ops, TS, table=True))
    f32 = tup(f32_fwd(*ops, TS))
    for o, t, f in zip(outs, table, f32):
        assert 0 < rel_l2(t, o) < rel_l2(f, o)
    cot = cotangents(outs)
    want = bwd(*ops, TS, *cot)
    got = bwd(*ops, TS, *cot, table=True)
    f32 = f32_bwd(*ops, TS, *cot)
    for name, t, w, f in zip(names, got, want, f32):
        if name != 'ab':
            assert 0 < rel_l2(f, w), name
            assert rel_l2(t, w) < rel_l2(f, w), name


def test_cpu_wrappers_run_the_plain_bf16_versions():
    """On CPU tensors at precision='bfloat16' the ``*_core`` wrappers (cw
    given) run the plain product form, each counted as its plain version's
    call, no launch; autograd through them gives the bf16 backward (not
    autograd through the forward's roundings); the ``*_table_core``
    wrappers (vw given) have no CPU bf16 form and raise; the kernels alone
    take CUDA tensors only, and the precision is checked."""
    ops = [to_torch(a) for a in step_ops(2, True, seed=40)]
    step = ops[:3] + ops[8:]
    launches = [(f.launches, f.launches_bf16) for f in (
        dsa_sample_attend_fwd, dsa_sample_attend_bwd, dsa_lstm_step_fwd,
        dsa_lstm_step_bwd, table_gemm, table_gemm_bwd)]
    for lstm, args, core in ((False, step, dsa_sample_attend_core),
                             (True, ops, dsa_lstm_step_core)):
        fwd, bwd, _ = plain(lstm)
        counter = lstm_step_ref if lstm else sample_attend_ref
        calls = counter.calls
        leaves = [a.clone().requires_grad_() for a in args]
        outs = tup(core(*leaves, TS, precision=BF16))
        assert counter.calls == calls + 1
        for a, b in zip(outs, tup(fwd(*args, TS))):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
        cot = cotangents(tuple(o.detach() for o in outs))
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
        for leaf, w in zip(leaves, bwd(*args, TS, *cot)):
            torch.testing.assert_close(leaf.grad, w.reshape(leaf.shape),
                                       rtol=0, atol=0)
    # the table-operand wrappers: no CPU bf16 form
    vw = dsa_value_table(ops[0], ops[8], BF16)
    with pytest.raises(NotImplementedError, match='cw'):
        dsa_sample_attend_table_core(ops[0], vw, *ops[1:3], *ops[9:], TS,
                                     BF16)
    with pytest.raises(NotImplementedError, match='cw'):
        dsa_lstm_step_table_core(ops[0], vw, *ops[1:8], *ops[9:], TS, BF16)
    assert launches == [(f.launches, f.launches_bf16) for f in (
        dsa_sample_attend_fwd, dsa_sample_attend_bwd, dsa_lstm_step_fwd,
        dsa_lstm_step_bwd, table_gemm, table_gemm_bwd)]
    g = torch.ones(2, 2, 3, ops[0].shape[-1])
    with pytest.raises(ValueError):
        dsa_sample_attend_fwd(ops[0], vw, *ops[1:3], *ops[9:], TS,
                              precision=BF16)
    with pytest.raises(ValueError):
        dsa_sample_attend_bwd(ops[0], vw, *ops[1:3], *ops[9:], TS, g,
                              precision=BF16)
    with pytest.raises(ValueError):
        dsa_lstm_step_fwd(ops[0], vw, *ops[1:8], *ops[9:], TS,
                          precision=BF16)
    with pytest.raises(ValueError):
        dsa_lstm_step_bwd(ops[0], vw, *ops[1:8], *ops[9:], TS, ops[4],
                          ops[5], precision=BF16)
    with pytest.raises(ValueError, match='precision'):
        dsa_sample_attend_core(*step, TS, precision='float16')


def test_value_table_in_the_bf16_mode():
    """``dsa_value_table(precision='bfloat16')`` on the CPU: VW =
    bf16(value) . bf16(cw), and its backward bf16(G) . bf16(cw)^T and
    bf16(value)^T bf16(G), one plain call each way."""
    rng = np.random.default_rng(41)
    value_t = to_torch(rng.standard_normal((2, 2, 18, 8)).astype(np.float32))
    cw = to_torch(rng.standard_normal((8, 16)).astype(np.float32))
    G = to_torch(rng.standard_normal((2, 2, 18, 16)).astype(np.float32))
    leaves = (value_t.clone().requires_grad_(), cw.clone().requires_grad_())
    calls = table_gemm_ref.calls
    vw = dsa_value_table(*leaves, BF16)
    assert table_gemm_ref.calls == calls + 1
    b = dsa_bf16.bf16
    torch.testing.assert_close(vw, b(value_t) @ b(cw), rtol=0, atol=0)
    assert rel_l2(vw.detach(), value_t @ cw) > 1e-4          # it rounds
    (vw * G).sum().backward()
    torch.testing.assert_close(leaves[0].grad, b(G) @ b(cw).T, rtol=1e-6,
                               atol=1e-6)
    torch.testing.assert_close(
        leaves[1].grad, b(value_t).reshape(-1, 8).T @ b(G).reshape(-1, 16),
        rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError, match='precision'):
        dsa_value_table(value_t, cw, 'bf16')


# ----------------------------------------------------------------------------
# the caption head
# ----------------------------------------------------------------------------

@pytest.fixture(scope='module')
def head_params():
    """Flax params of a one-layer and a two-layer LSTM-DSA head with
    attention, the offset kernel off the tap boundary and a logit
    projection wide enough that the distributions are not flat."""
    from test_torch_caption_core import BASE, head_inputs, seq_of
    inputs = head_inputs(3)
    out = {}
    for layers in (1, 2):
        cfg = dict(BASE, num_layers=layers, att_hid_size=20)
        params = JaxHead(JaxHeadConfig(**cfg), att_impl='ref').init(
            jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]), (12, 6),
            jnp.asarray(inputs[4]), jnp.asarray(seq_of(1)))['params']
        params = jax.tree_util.tree_map(np.array, params)
        w = params['dsa_sampling_offsets_w']
        params['dsa_sampling_offsets_w'] = (np.random.default_rng(
            2).standard_normal(w.shape) * 0.05).astype(np.float32)
        params['logit_w'] = (params['logit_w'] * 20).astype(np.float32)
        out[layers] = (cfg, params)
    return out


def heads(head_params, layers=1, **flags):
    """The JAX head (interpret mode, bf16) and the port's bf16 head with
    the same stepwise flags and weights."""
    cfg, params = head_params[layers]
    jhead = JaxHead(JaxHeadConfig(**cfg), att_impl='pallas_interpret',
                    att_precision=BF16, **flags)
    head = DSACaptionHead(CaptionHeadConfig(**cfg, precision=BF16, **flags))
    head.load_state_dict({k: to_torch(v) for k, v in
                          caption_head_state_dict(params).items()},
                         strict=True)
    return jhead, head, params


def inputs_of(seed):
    from test_torch_caption_core import head_inputs
    return head_inputs(seed)


def _jax_apply(jhead, params, inputs, *args, **kw):
    return jhead.apply({'params': params}, *map(jnp.asarray, inputs[:4]),
                       (12, 6), jnp.asarray(inputs[4]), *args, **kw)


def _check_grads(head, jgrads):
    want = caption_head_state_dict(jax.tree_util.tree_map(np.asarray,
                                                          jgrads))
    for name, p in head.named_parameters():
        err = np.linalg.norm(to_numpy(p.grad) - want[name])
        assert err <= 1e-3 * np.linalg.norm(want[name]) + 1e-6, name


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_bf16_stepwise_greedy_matches_jax(head_params, lstm_fuse):
    """--dsa_greedy_fuse 0: the word steps (K7-bf16, or K9-bf16 under
    lstm_fuse; their plain bf16 versions on the CPU, no table) against the
    JAX head's ``_greedy_sample``: tokens and log-probs up to each query's
    first near-tie."""
    jhead, head, params = heads(head_params, greedy_fuse=False,
                                lstm_fuse=lstm_fuse)
    inputs = inputs_of(5)
    want_seq, want_lp = _jax_apply(jhead, params, inputs, mode='sample')
    counter = lstm_step_ref if lstm_fuse else sample_attend_ref
    calls, tables = counter.calls, table_gemm_ref.calls
    margins = []
    real = head.logit.forward

    def logit(x):
        out = real(x)
        top2 = torch.topk(out, 2, dim=-1).values
        margins.append(top2[..., 0] - top2[..., 1])
        return out

    head.logit.forward = logit
    with torch.no_grad():
        seq, lp = head(*map(to_torch, inputs[:4]), (12, 6),
                       to_torch(inputs[4]))
    K = head.cfg.max_caption_len
    assert (counter.calls, table_gemm_ref.calls) == (calls + K, tables)
    ok = np.cumprod(to_numpy(torch.stack(margins, 1)) > MARGIN, 1)  # B,K,Pq
    ok = ok.transpose(0, 2, 1).reshape(-1, K).astype(bool)
    same = np.cumprod(to_numpy(seq) == np.asarray(want_seq), 1).astype(bool)
    assert ok.mean() > 0.8 and np.all(same | ~ok)
    assert rel_l2(to_numpy(lp)[ok], np.asarray(want_lp)[ok]) <= 1e-4


def jax_ss_noise(n, K, V1):
    """The uniforms and Gumbel noise of the JAX head's scheduled-sampling
    body when deterministic (base key PRNGKey(0)), step by step."""
    us, gs = [], []
    for i in range(K):
        r_b, r_c = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), i))
        us.append(np.asarray(jax.random.uniform(r_b, (n,))))
        gs.append(np.asarray(jax.random.gumbel(r_c, (n, V1))))
    return to_torch(np.stack(us)), to_torch(np.stack(gs))


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_bf16_scheduled_sampling_matches_jax(head_params, lstm_fuse):
    """Scheduled sampling (ss_prob 0.5) in bf16, the port fed the JAX
    body's uniforms and Gumbel noise: log-probs and every weight
    gradient."""
    from test_torch_caption_core import seq_of
    jhead, head, params = heads(head_params, lstm_fuse=lstm_fuse)
    inputs, seq = inputs_of(3), seq_of(4)
    K, V1 = seq.shape[1] - 1, head.cfg.vocab_size + 1
    n = seq.shape[0]
    wts = np.cos(np.arange(n * K * V1, dtype=np.float32)).reshape(n, K, V1)

    def loss(p):
        lp = _jax_apply(jhead, p, inputs, jnp.asarray(seq), ss_prob=0.5,
                        deterministic=True, ss_enabled=True)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    DSACaptionHead.fed_samples.clear()
    lp = head.teacher_forcing(*map(to_torch, inputs[:4]), (12, 6),
                              to_torch(inputs[4]), to_torch(seq),
                              ss_prob=0.5, noise=jax_ss_noise(n, K, V1))
    (lp * to_torch(wts)).sum().backward()
    assert DSACaptionHead.fed_sample_count() > 0
    assert rel_l2(to_numpy(lp), want) <= 1e-4
    _check_grads(head, jgrads)


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_bf16_sampled_decode_matches_jax(head_params, lstm_fuse):
    """--caption_sample_max 0 in bf16 at a fixed generator seed: the
    log-probability the port emits for each sampled token against the JAX
    head's bf16 teacher forcing of those tokens (stepwise), up to each
    caption's first EOS."""
    jhead, head, params = heads(head_params, lstm_fuse=lstm_fuse)
    inputs = inputs_of(6)
    with torch.no_grad():
        seq, lp = head(*map(to_torch, inputs[:4]), (12, 6),
                       to_torch(inputs[4]), sample_max=False,
                       temperature=0.7, gen=torch.Generator().manual_seed(3))
    seq, lp = to_numpy(seq), to_numpy(lp)
    tf = np.concatenate([np.zeros((len(seq), 1), np.int32), seq], 1)
    want = np.asarray(_jax_apply(jhead, params, inputs, jnp.asarray(tf),
                                 ss_prob=0.0, deterministic=True,
                                 ss_enabled=True))
    want = np.take_along_axis(want, seq[..., None], -1)[..., 0]
    live = np.cumprod(np.concatenate([np.ones((len(seq), 1)),
                                      seq[:, :-1] > 0], 1), 1).astype(bool)
    assert (seq > 0).sum() > 0
    assert rel_l2(lp[live], want[live]) <= 1e-4


def test_bf16_two_layer_core_matches_jax(head_params):
    """A two-layer core in bf16 (never fused: K7-bf16 a word step, the
    layers and ``ctx . ctx_w`` f32 outside it): teacher forcing's log-probs
    and weight gradients, and the greedy decode."""
    from test_torch_caption_core import seq_of
    jhead, head, params = heads(head_params, layers=2)
    inputs, seq = inputs_of(7), seq_of(8)
    K, V1 = seq.shape[1] - 1, head.cfg.vocab_size + 1
    n = seq.shape[0]
    wts = np.cos(np.arange(n * K * V1, dtype=np.float32)).reshape(n, K, V1)

    def loss(p):
        lp = _jax_apply(jhead, p, inputs, jnp.asarray(seq),
                        deterministic=True)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    calls = sample_attend_ref.calls
    lp = head.teacher_forcing(*map(to_torch, inputs[:4]), (12, 6),
                              to_torch(inputs[4]), to_torch(seq))
    (lp * to_torch(wts)).sum().backward()
    assert sample_attend_ref.calls == calls + K
    assert rel_l2(to_numpy(lp.detach()), want) <= 1e-4
    _check_grads(head, jgrads)
    want_seq, want_lp = _jax_apply(jhead, params, inputs, mode='sample')
    with torch.no_grad():
        got_seq, got_lp = head(*map(to_torch, inputs[:4]), (12, 6),
                               to_torch(inputs[4]))
    same = np.cumprod(to_numpy(got_seq) == np.asarray(want_seq),
                      1).astype(bool)
    assert same.mean() > 0.9
    assert rel_l2(to_numpy(got_lp)[same], np.asarray(want_lp)[same]) <= 1e-4
