"""The per-video table form of the LSTM-DSA attention, which the CUDA kernels
K4 and K5 (the scan and its backward), K6 (greedy decode), K8 (the word
step's backward) and K9/K10 (the fused LSTM word step) use, held against
the JAX package on the CPU.

A plain-PyTorch mirror of the kernels' decomposition lives here (never on
the port's path):

* scores from ``VW = value . Wc`` (B, H, S, A): a tap is the lerp of two
  value rows, so ``taps . Wc`` is the same lerp of two VW rows;
* the backward of one step's attention as the kernels form it: ``du`` from
  the scores, ``G`` = the lerp-scatter of ``du`` onto the value rows,
  ``dWc = value^T G``, ``dvalue`` = the lerp-scatter of ``wts * dctx`` plus
  ``G . Wc^T``, and ``dpos`` = ``(v[hi] - v[lo]) . wts dctx`` plus
  ``(VW[hi] - VW[lo]) . du``;
* the greedy step with the token's share of z gathered from
  ``TW = embed . token_w`` (V+1, 4R).

The teacher-forcing scan built on that step is held against the JAX oracle
``dsa_teacher_scan_ref`` (forward) and ``jax.vjp`` of it (the 13
gradients); the greedy loop against ``dsa_greedy_scan_ref``; one step's
backward (K8's function) against ``jax.vjp`` of the JAX word step's custom
VJP with its Pallas kernels in interpret mode.  The port's own table forms of
the word step and of the fused LSTM step (``sample_attend_table_ref`` and
``lstm_step_table_ref`` on ``dsa_value_table``, the caption head's CPU
route under either ``lstm_fuse``) are held against ``jax.vjp`` of the JAX
steps' custom VJPs in interpret mode, and the table GEMM's plain backward
against autograd.  numpy inputs from a seed,
H = 1, 2 and 8, LP = 4, ragged Q, positions past both borders of each level
(where the two taps clamp to one row).  Tolerance rtol 2e-4, atol 1e-6
(f32, sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.dsa_greedy import dsa_greedy_scan_ref as jax_greedy_ref
from dvc_tpu.ops.dsa_scan import dsa_teacher_scan_ref as jax_scan_ref
from dvc_tpu.ops.dsa_step import _dsa_core, _dsa_lstm_core
from dvc_tpu_torch.ops.dsa_greedy import (_level_bounds, greedy_pick,
                                          lstm_cell, step_pos_hvec)
from dvc_tpu_torch.ops.dsa_scan import NAMES
from dvc_tpu_torch.ops.dsa_step import (LSTM_NAMES, STEP_NAMES,
                                        lstm_step_ref, lstm_step_table_ref,
                                        sample_attend_ref,
                                        sample_attend_table_ref)
from dvc_tpu_torch.ops.dsa_tables import (dsa_value_table, table_gemm,
                                          table_gemm_bwd, table_gemm_bwd_ref,
                                          table_gemm_ref)

RTOL, ATOL = 2e-4, 1e-6
TS = (12, 6)       # two levels; P = 2, so LP = 4


def _tap_pairs(pos, hib, s0):
    """Border-mode tap pair of every (b, h, q, p): flat S indices (lo, hi)
    and lerp weights (wl, wh)."""
    zero = torch.zeros((), dtype=pos.dtype)
    i_lo = torch.floor(pos)
    wh = pos - i_lo
    lo = torch.minimum(torch.maximum(i_lo, zero), hib).long() + s0
    hi = torch.minimum(torch.maximum(i_lo + 1.0, zero), hib).long() + s0
    return lo, hi, 1.0 - wh, wh


def _rows(table, idx):
    """table (B, H, S, W) rows at idx (B, H, Q, LP) -> (B, H, Q, LP, W)."""
    B, H, Q, LP = idx.shape
    W = table.shape[-1]
    i = idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, W)
    return torch.gather(table, 2, i).reshape(B, H, Q, LP, W)


def _scatter(rows, idx, S):
    """The transpose of _rows: rows (B, H, Q, LP, W) added at idx into
    (B, H, S, W)."""
    B, H, Q, LP, W = rows.shape
    out = rows.new_zeros((B, H, S, W))
    i = idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, W)
    return out.scatter_add(2, i, rows.reshape(B, H, Q * LP, W))


class TableAttend(torch.autograd.Function):
    """One word step's attention from the table VW = value . Wc, with the
    kernels' backward."""

    @staticmethod
    def forward(ctx, value, pos, hvec, cw, cb, aw, ab, hib, s0):
        vw = torch.einsum('bhsd,da->bhsa', value, cw)
        lo, hi, wl, wh = _tap_pairs(pos, hib, s0)
        u = torch.tanh(wl[..., None] * _rows(vw, lo) + wh[..., None] * _rows(vw, hi)
                       + cb + hvec[:, None, :, None, :])
        wts = torch.softmax(u @ aw + ab, dim=-1)                 # (B, H, Q, LP)
        taps = wl[..., None] * _rows(value, lo) + wh[..., None] * _rows(value, hi)
        ctx.save_for_backward(value, cw, aw, vw, lo, hi, wl, wh, u, wts, taps)
        return torch.einsum('bhqp,bhqpd->bhqd', wts, taps)

    @staticmethod
    def backward(ctx, dctx):
        value, cw, aw, vw, lo, hi, wl, wh, u, wts, taps = ctx.saved_tensors
        S = value.shape[2]
        dwts = (taps * dctx[..., None, :]).sum(-1)
        ddot = wts * (dwts - (wts * dwts).sum(-1, keepdim=True))
        du = ddot[..., None] * aw * (1.0 - u * u)                # (B,H,Q,LP,A)
        # G: du scattered onto the value rows with the lerp weights
        G = _scatter(wl[..., None] * du, lo, S) + _scatter(wh[..., None] * du, hi, S)
        d_cw = torch.einsum('bhsd,bhsa->da', value, G)
        t = wts[..., None] * dctx[..., None, :]                  # (B,H,Q,LP,Dh)
        dvalue = (_scatter(wl[..., None] * t, lo, S) + _scatter(wh[..., None] * t, hi, S)
                  + torch.einsum('bhsa,da->bhsd', G, cw))
        dpos = (((_rows(value, hi) - _rows(value, lo)) * t).sum(-1)
                + ((_rows(vw, hi) - _rows(vw, lo)) * du).sum(-1))
        dhvec = du.sum((1, 3))
        dcb = du.sum((0, 1, 2, 3))
        daw = (ddot[..., None] * u).sum((0, 1, 2, 3))
        return dvalue, dpos, dhvec, d_cw, dcb, daw, ddot.sum(), None, None


def table_scan(value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b,
               cw, cb, aw, ab, ctx_w3, w_hh, temporal_shapes):
    """The teacher-forcing scan with each step's attention in the table
    form.  Returns hs (B, K, Q, R)."""
    B, K, Q = z_all.shape[:3]
    R = w_hh.shape[0]
    P = scale_t.shape[-1] // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, 'cpu')
    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    hs = []
    for k in range(K):
        pos, hvec = step_pos_hvec(h, base_pos, scale_t, off_w_h, h2att_w, h2att_b)
        ctx = TableAttend.apply(value_t, pos, hvec, cw, cb, aw, ab, hib, s0)
        z = z_all[:, k] + h @ w_hh + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3)
        h, c = lstm_cell(z, c)
        hs.append(h)
    return torch.stack(hs, 1)


def table_greedy(value_t, base_pos, scale_t, const_z, embed, token_w, logit_w,
                 logit_b, off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3,
                 w_hh, temporal_shapes, K):
    """The greedy decode with scores from VW and the fed-back token's share
    of z a row of TW = embed . token_w.  Returns (tok, lp), (B, K, Q)."""
    B, Q = const_z.shape[:2]
    R = w_hh.shape[0]
    P = scale_t.shape[-1] // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, 'cpu')
    tw = embed @ token_w                                      # (V+1, 4R)
    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    it = torch.zeros((B, Q), dtype=torch.long)
    toks, lps = [], []
    for _ in range(K):
        pos, hvec = step_pos_hvec(h, base_pos, scale_t, off_w_h, h2att_w, h2att_b)
        ctx = TableAttend.apply(value_t, pos, hvec, cw, cb, aw, ab, hib, s0)
        z = const_z + tw[it] + h @ w_hh + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3)
        h, c = lstm_cell(z, c)
        it, lp = greedy_pick(h @ logit_w + logit_b)
        toks.append(it.to(torch.int32))
        lps.append(lp)
    return torch.stack(toks, 1), torch.stack(lps, 1)


def _base_pos(rng, B, H, Q, P):
    """Level-relative base positions from 2 below each level's start to 1.5
    past its end, so both borders clamp some taps to one row."""
    T = np.repeat(np.asarray(TS, np.float32), P)
    return (rng.uniform(0.0, 1.0, (B, H, Q, len(TS) * P)) * (T + 3.5)
            - 2.0).astype(np.float32)


def scan_args(H, Q, seed, B=2, Dh=8, A=16, R=8, K=3, P=2):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    LP = len(TS) * P
    return (f(B, H, sum(TS), Dh), _base_pos(rng, B, H, Q, P),
            rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32),
            f(B, K, Q, 4 * R, scale=0.3), f(H, R, LP, scale=0.2),
            f(R, A, scale=0.3), f(A, scale=0.1), f(Dh, A, scale=0.3),
            f(A, scale=0.1), f(A, scale=0.3), np.float32(0.05),
            f(H, Dh, 4 * R, scale=0.2), f(R, 4 * R, scale=0.2))


def _clamped_rows(base_pos, P=2):
    """How many taps of base_pos sit below 0 and past T_l - 1 of their
    level: the rows where both taps are one row."""
    T = np.repeat(np.asarray(TS, np.float32), P)
    return int((base_pos < 0).sum()), int((base_pos > T - 1).sum())


@pytest.mark.parametrize('H,Q', [(1, 5), (2, 9), (2, 3)])
def test_table_scan_matches_jax_oracle_and_its_vjp(H, Q):
    args = scan_args(H, Q, seed=10 * H + Q)
    below, above = _clamped_rows(args[1])
    assert below > 0 and above > 0
    leaves = [to_torch(a).requires_grad_() for a in args]
    hs = table_scan(*leaves, TS)
    jargs = [jnp.asarray(a) for a in args]
    want_hs, _ = jax_scan_ref(*jargs, TS)
    np.testing.assert_allclose(to_numpy(hs), np.asarray(want_hs), rtol=RTOL,
                               atol=ATOL)
    g = np.sin(3.0 * np.asarray(want_hs)).astype(np.float32)
    got = torch.autograd.grad(hs, leaves, to_torch(g))
    _, vjp = jax.vjp(lambda *a: jax_scan_ref(*a, TS)[0], *jargs)
    for name, a, b in zip(NAMES, got, vjp(jnp.asarray(g))):
        assert tuple(a.shape) == np.shape(b), name
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


def test_table_backward_terms_are_the_kernels_decomposition():
    """The gradients of one step's attention: the table form's dvalue, dpos
    and dWc against autograd through the direct form (taps . Wc)."""
    rng = np.random.default_rng(7)
    B, H, Q, Dh, A, P = 2, 2, 5, 8, 16, 2
    value = to_torch(rng.standard_normal((B, H, sum(TS), Dh)).astype(np.float32))
    pos = to_torch(_base_pos(rng, B, H, Q, P))
    hvec = to_torch(rng.standard_normal((B, Q, A)).astype(np.float32) * 0.5)
    cw = to_torch(rng.standard_normal((Dh, A)).astype(np.float32) * 0.3)
    cb = to_torch(rng.standard_normal(A).astype(np.float32) * 0.1)
    aw = to_torch(rng.standard_normal(A).astype(np.float32) * 0.3)
    ab = torch.tensor(0.05)
    hib, s0 = _level_bounds(TS, P, 'cpu')
    dctx = to_torch(rng.standard_normal((B, H, Q, Dh)).astype(np.float32))
    from dvc_tpu_torch.ops.dsa_greedy import attend
    ops = [t.clone().requires_grad_() for t in (value, pos, hvec, cw, cb, aw, ab)]
    want = torch.autograd.grad(attend(*ops, hib, s0), ops, dctx)
    ops = [t.clone().requires_grad_() for t in (value, pos, hvec, cw, cb, aw, ab)]
    out = TableAttend.apply(*ops, hib, s0)
    np.testing.assert_allclose(to_numpy(out), to_numpy(attend(
        value, pos, hvec, cw, cb, aw, ab, hib, s0)), rtol=RTOL, atol=ATOL)
    got = torch.autograd.grad(out, ops, dctx)
    for name, a, b in zip(('value', 'pos', 'hvec', 'cw', 'cb', 'aw', 'ab'),
                          got, want):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=RTOL,
                                   atol=ATOL, err_msg=name)


@pytest.mark.parametrize('H,Q', [(1, 5), (2, 9), (8, 3)])
def test_table_step_backward_matches_jax_kernel_vjp(H, Q):
    """K8's function in the kernel's table form (``TableAttend``: the scores
    and du from VW = value . Wc, G scattered onto the value rows, dvalue's
    G . Wc^T, dWc = value^T G, dpos from the tap rows directly) at the
    kernels' boundary against ``jax.vjp`` of the JAX word step's custom VJP
    (``_dsa_core``, its Pallas kernels in interpret mode) for a unit-scale
    cotangent of ctx; Q ragged against the card's query tiles.  d alpha_b
    is zero in exact arithmetic (the softmax's gradients sum to zero), so
    both sides hold only the rounding of a sum of N = B*H*Q*LP terms: its
    atol is chip_smoke.check_step's floor, 64 unit roundoffs times sqrt(N)
    times the terms' mean magnitude, where that exceeds 1e-6."""
    rng = np.random.default_rng(30 + 10 * H + Q)
    B, Dh, A, P = 2, 8, 16, 2
    LP = len(TS) * P

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    pos = _base_pos(rng, B, H, Q, P)
    below, above = _clamped_rows(pos)
    assert below > 0 and above > 0
    args = (f(B, H, sum(TS), Dh), pos, f(B, Q, A, scale=0.5),
            f(Dh, A, scale=0.3), f(A, scale=0.1), f(A, scale=0.3),
            np.float32(0.05))
    dctx = f(B, H, Q, Dh)
    hib, s0 = _level_bounds(TS, P, 'cpu')
    leaves = [to_torch(a).requires_grad_() for a in args]
    ctx = TableAttend.apply(*leaves, hib, s0)
    got = torch.autograd.grad(ctx, leaves, to_torch(dctx))
    jops = [jnp.asarray(a) for a in args]
    jops[1] = jops[1].reshape(B, H, Q * LP)
    want_ctx, vjp = jax.vjp(lambda *a: _dsa_core(*a, TS, Q, True, 'float32'),
                            *jops)
    np.testing.assert_allclose(to_numpy(ctx), np.asarray(want_ctx),
                               rtol=RTOL, atol=ATOL)
    # d alpha_b's terms, one per tap row (alpha_b broadcast to every row)
    from dvc_tpu_torch.ops.dsa_greedy import attend
    rows = to_torch(args[6]).expand(B, H, Q, LP).clone().requires_grad_()
    terms, = torch.autograd.grad(
        attend(*map(to_torch, args[:6]), rows, hib, s0), rows, to_torch(dctx))
    atol = {'ab': max(ATOL, 2.0 ** -18 * terms.numel() ** 0.5
                      * float(terms.abs().mean()))}
    for name, a, b in zip(('value', 'pos', 'hvec', 'cw', 'cb', 'aw', 'ab'),
                          got, vjp(jnp.asarray(dctx))):
        np.testing.assert_allclose(to_numpy(a).reshape(np.shape(b)),
                                   np.asarray(b), rtol=RTOL,
                                   atol=atol.get(name, ATOL), err_msg=name)


@pytest.mark.parametrize('H,Q', [(1, 5), (2, 9), (8, 3)])
def test_table_lstm_step_matches_jax_kernel_vjp(H, Q):
    """K9's and K10's function in the table form: ``lstm_step_table_ref``
    on VW = value . Wc from ``dsa_value_table`` (the plain table under
    autograd, one call) against ``jax.vjp`` of the JAX fused word step's
    custom VJP (``_dsa_lstm_core``, its Pallas kernels in interpret mode):
    (h', c') and the 12 gradients at the JAX boundary, value's and Wc's
    through the table's chain rule (the context's term of value plus
    G . Wc^T, and value^T G).  Unit-scale cotangents of (h', c'); d alpha_b
    has the floor of ``test_table_step_backward_matches_jax_kernel_vjp``
    over its terms' rounding."""
    rng = np.random.default_rng(60 + 10 * H + Q)
    B, Dh, A, P, R = 2, 8, 16, 2, 12
    LP = len(TS) * P

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    pos = _base_pos(rng, B, H, Q, P)
    below, above = _clamped_rows(pos)
    assert below > 0 and above > 0
    args = (f(B, H, sum(TS), Dh), pos, f(B, Q, A, scale=0.5),
            f(B, Q, 4 * R, scale=0.5), f(B, Q, R, scale=0.5),
            f(B, Q, R, scale=0.5), f(H, Dh, 4 * R, scale=0.2),
            f(R, 4 * R, scale=0.2), f(Dh, A, scale=0.3), f(A, scale=0.1),
            f(A, scale=0.3), np.float32(0.05))
    leaves = [to_torch(a).requires_grad_() for a in args]
    calls = (table_gemm_ref.calls, lstm_step_table_ref.calls)
    vw = dsa_value_table(leaves[0], leaves[8])
    out = lstm_step_table_ref(leaves[0], vw, *leaves[1:8], *leaves[9:], TS)
    assert (table_gemm_ref.calls, lstm_step_table_ref.calls) == \
        (calls[0] + 1, calls[1] + 1)
    jops = [jnp.asarray(a) for a in args]
    jops[1] = jops[1].reshape(B, H, Q * LP)
    want_out, vjp = jax.vjp(
        lambda *a: _dsa_lstm_core(*a, TS, Q, True, 'float32'), *jops)
    for a, b in zip(out, want_out):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=RTOL,
                                   atol=ATOL)
    cot = (f(B, Q, R), f(B, Q, R))
    got = torch.autograd.grad(out, leaves, [to_torch(c) for c in cot])
    # d alpha_b's terms, one per tap row (alpha_b broadcast to every row)
    rows = to_torch(args[11]).expand(B, H, Q, LP).clone().requires_grad_()
    terms, = torch.autograd.grad(
        lstm_step_ref(*map(to_torch, args[:11]), rows, TS), rows,
        [to_torch(c) for c in cot])
    atol = {'ab': max(ATOL, 2.0 ** -18 * terms.numel() ** 0.5
                      * float(terms.abs().mean()))}
    for name, a, b in zip(LSTM_NAMES, got, vjp(tuple(map(jnp.asarray, cot)))):
        np.testing.assert_allclose(to_numpy(a).reshape(np.shape(b)),
                                   np.asarray(b), rtol=RTOL,
                                   atol=atol.get(name, ATOL), err_msg=name)


@pytest.mark.parametrize('H,Q', [(1, 5), (2, 9), (8, 3)])
def test_table_sample_attend_matches_jax_kernel_vjp(H, Q):
    """K7's and K8's function in the table form: ``sample_attend_table_ref``
    on VW = value . Wc from ``dsa_value_table`` (the plain table under
    autograd, one call) against ``jax.vjp`` of the JAX word step's custom
    VJP (``_dsa_core``, its Pallas kernels in interpret mode): ctx and the
    7 gradients at the JAX boundary, value's and Wc's through the table's
    chain rule.  Positions past both borders of each level; a unit-scale
    cotangent of ctx; d alpha_b has the floor of
    ``test_table_step_backward_matches_jax_kernel_vjp`` over its terms'
    rounding."""
    rng = np.random.default_rng(80 + 10 * H + Q)
    B, Dh, A, P = 2, 8, 16, 2
    LP = len(TS) * P

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    pos = _base_pos(rng, B, H, Q, P)
    below, above = _clamped_rows(pos)
    assert below > 0 and above > 0
    args = (f(B, H, sum(TS), Dh), pos, f(B, Q, A, scale=0.5),
            f(Dh, A, scale=0.3), f(A, scale=0.1), f(A, scale=0.3),
            np.float32(0.05))
    leaves = [to_torch(a).requires_grad_() for a in args]
    calls = (table_gemm_ref.calls, sample_attend_table_ref.calls)
    vw = dsa_value_table(leaves[0], leaves[3])
    ctx = sample_attend_table_ref(leaves[0], vw, *leaves[1:3], *leaves[4:],
                                  TS)
    assert (table_gemm_ref.calls, sample_attend_table_ref.calls) == \
        (calls[0] + 1, calls[1] + 1)
    jops = [jnp.asarray(a) for a in args]
    jops[1] = jops[1].reshape(B, H, Q * LP)
    want_ctx, vjp = jax.vjp(lambda *a: _dsa_core(*a, TS, Q, True, 'float32'),
                            *jops)
    np.testing.assert_allclose(to_numpy(ctx), np.asarray(want_ctx),
                               rtol=RTOL, atol=ATOL)
    dctx = f(B, H, Q, Dh)
    got = torch.autograd.grad(ctx, leaves, to_torch(dctx))
    # d alpha_b's terms, one per tap row (alpha_b broadcast to every row)
    rows = to_torch(args[6]).expand(B, H, Q, LP).clone().requires_grad_()
    terms, = torch.autograd.grad(
        sample_attend_ref(*map(to_torch, args[:6]), rows, TS), rows,
        to_torch(dctx))
    atol = {'ab': max(ATOL, 2.0 ** -18 * terms.numel() ** 0.5
                      * float(terms.abs().mean()))}
    for name, a, b in zip(STEP_NAMES, got, vjp(jnp.asarray(dctx))):
        np.testing.assert_allclose(to_numpy(a).reshape(np.shape(b)),
                                   np.asarray(b), rtol=RTOL,
                                   atol=atol.get(name, ATOL), err_msg=name)


def greedy_args(H, seed, B=2, Dh=8, Q=5, A=16, R=8, V=130, E=12, P=2):
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    LP = len(TS) * P
    return (f(B, H, sum(TS), Dh), _base_pos(rng, B, H, Q, P),
            rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32),
            f(B, Q, 4 * R, scale=0.3), f(V + 1, E, scale=0.3),
            f(E, 4 * R, scale=0.3), f(R, V + 1, scale=0.5),
            f(V + 1, scale=0.1), f(H, R, LP, scale=0.2), f(R, A, scale=0.3),
            f(A, scale=0.1), f(Dh, A, scale=0.3), f(A, scale=0.1),
            f(A, scale=0.3), np.float32(0.05), f(H, Dh, 4 * R, scale=0.2),
            f(R, 4 * R, scale=0.2))


@pytest.mark.parametrize('H,seed', [(1, 10), (2, 10)])
def test_table_greedy_matches_jax_oracle(H, seed):
    """Q = 5 (a ragged tile on the card); tokens equal, log-probs within the
    tolerance; the seeds give no near-tie (top-2 margin > 1e-3)."""
    K = 5
    args = greedy_args(H, seed)
    below, above = _clamped_rows(args[1])
    assert below > 0 and above > 0
    want_tok, want_lp = jax_greedy_ref(*map(jnp.asarray, args), TS, K)
    from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan_ref
    _, _, margin = dsa_greedy_scan_ref(*map(to_torch, args), TS, K,
                                       with_margin=True)
    assert float(margin.min()) > 1e-3
    tok, lp = table_greedy(*map(to_torch, args), TS, K)
    np.testing.assert_array_equal(to_numpy(tok), np.asarray(want_tok))
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want_lp), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize('N,k,n', [(37, 8, 16), (131, 12, 32), (1, 5, 3)])
def test_table_gemm_takes_the_plain_product_on_the_cpu(N, k, n):
    """The table GEMM's wrapper sends CPU tensors to its plain version,
    never to the kernel."""
    rng = np.random.default_rng(N)
    x = rng.standard_normal((N, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    calls, launches = table_gemm_ref.calls, table_gemm.launches
    got = table_gemm(to_torch(x), to_torch(w))
    assert (table_gemm_ref.calls, table_gemm.launches) == (calls + 1, launches)
    np.testing.assert_allclose(to_numpy(got), x.astype(np.float64) @ w,
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('N,k,n', [(37, 8, 16), (131, 12, 32), (1, 5, 3)])
def test_table_gemm_backward_matches_autograd(N, k, n):
    """The table GEMM's backward, (g . w^T, x^T . g), takes its plain
    version on the CPU, never the kernel, and equals autograd through the
    plain product; ``dsa_value_table``'s gradients on the CPU are the
    same."""
    rng = np.random.default_rng(N + 1)
    x = rng.standard_normal((N, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32)
    g = rng.standard_normal((N, n)).astype(np.float32)
    calls, launches = table_gemm_bwd_ref.calls, table_gemm_bwd.launches
    got = table_gemm_bwd(to_torch(x), to_torch(w), to_torch(g))
    assert (table_gemm_bwd_ref.calls, table_gemm_bwd.launches) == \
        (calls + 1, launches)
    leaves = [to_torch(a).requires_grad_() for a in (x, w)]
    want = torch.autograd.grad(torch.einsum('nk,km->nm', *leaves), leaves,
                               to_torch(g))
    value = to_torch(x).reshape(1, 1, N, k).requires_grad_()
    cw = to_torch(w).requires_grad_()
    table = torch.autograd.grad(dsa_value_table(value, cw), (value, cw),
                                to_torch(g).reshape(1, 1, N, n))
    for a, b, c in zip(got, want, table):
        np.testing.assert_allclose(to_numpy(a), to_numpy(b), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(to_numpy(c).reshape(a.shape), to_numpy(b),
                                   rtol=RTOL, atol=ATOL)


def test_phase_split_edits_match_the_sources():
    """Each edit of chip_smoke.py's phase split of the redesigned kernels
    (K1/K2, K4-K10; one phase's code taken out of a copy of csrc/) finds its
    text exactly once in the sources, so the split's variants build."""
    import os
    import chip_smoke
    from dvc_tpu_torch.ops import _cuda
    for kernel, (source, phases) in chip_smoke.SPLITS['current'].items():
        assert os.path.exists(os.path.join(_cuda.CSRC, source)), kernel
        for phase, edits in phases:
            for name, old, _ in edits:
                with open(os.path.join(_cuda.CSRC, name)) as f:
                    assert f.read().count(old) == 1, (kernel, phase)
