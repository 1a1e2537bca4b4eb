"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  A CUDA kernel has no CPU build, so without a CUDA device every
test here skips.  On a machine with one (JAX is not needed there, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: MSDA max abs error <= 1e-4 * max|out| (f32, same taps summed in
another order; the forward at every lane width, copy width and query tile
edge of its staged head slice), and the same for each of its gradients
(dvalue is summed with atomics in no fixed order; the backward on its
shared dvalue slice at the same widths and edges, on encoder locations,
and at the shared-memory limit that both passes share); greedy tokens
equal and log-probs within 1e-3 wherever the plain version's top-2 logit
margin exceeded 1e-3 at that step and every earlier one (past a near-tie
the fed-back tokens may legitimately differ); teacher-forcing scan hs and cs within 1e-4 * max|ref|
and each of its 13 gradients within 1e-3 * max|ref| + 1e-5 (K recurrent
steps of f32 sums in another order, atomics in dvalue, dWc and the bias
sums; the floor is for d alpha_b, which is zero in exact arithmetic since
the softmax's gradients sum to zero, so both sides hold only rounding);
the word-step kernels (K7-K10) to the same: outputs within 1e-4 * max|ref|,
gradients within 1e-3 * max|ref| + 1e-5; in these newer cases d alpha_b
has the floor 5e-5 (``_grad_close``), the rounding of a sum of every tap
row's term in no fixed order, and at the train widths the floors of
chip_smoke's ``check_scan`` and ``check_step``.  K7-K10 take the table
VW = value . Wc: they are held against the plain table-form steps
(``sample_attend_table_ref``, ``lstm_step_table_ref``) and, composed with
the table GEMM and its backward, against the plain steps at the JAX
boundary; the table GEMM's
backward against torch.einsum within 1e-5 * sqrt(terms) of each output's
largest value.  The shared GEMM itself (``dsa::gemm``, 3xTF32 on the tensor
cores, through the library's ``dvc_dsa_gemm``) is held to torch.einsum at
the same tolerance on every operand layout, ragged edges, a strided operand
and accumulation, at a long term axis also in units of its products
(``chip_smoke.product_err``) against one-pass TF32, and its outputs are
bitwise equal from run to run.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (GEMM_PRODUCT_TOL, near_integer, product_err,
                        scan_positions, tf32_matmul)
from dvc_tpu_torch.models.deformable_transformer import \
    encoder_reference_points
from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan, dsa_greedy_scan_ref
from dvc_tpu_torch.ops.dsa_tables import (dsa_value_table, table_gemm,
                                          table_gemm_bwd)
from dvc_tpu_torch.ops.dsa_step import (LSTM_NAMES, LSTM_TABLE_NAMES,
                                        STEP_NAMES, STEP_TABLE_NAMES,
                                        dsa_lstm_step_bwd,
                                        dsa_lstm_step_core, dsa_lstm_step_fwd,
                                        dsa_lstm_step_grads,
                                        dsa_lstm_step_table_core,
                                        dsa_sample_attend_bwd,
                                        dsa_sample_attend_core,
                                        dsa_sample_attend_fwd,
                                        dsa_sample_attend_grads,
                                        dsa_sample_attend_table_core,
                                        lstm_step_bwd_ref,
                                        lstm_step_ref, lstm_step_table_bwd_ref,
                                        lstm_step_table_ref,
                                        sample_attend_bwd_ref,
                                        sample_attend_ref,
                                        sample_attend_table_bwd_ref,
                                        sample_attend_table_ref)
from dvc_tpu_torch.ops.dsa_scan import (NAMES, dsa_teacher_scan,
                                        dsa_teacher_scan_bwd,
                                        dsa_teacher_scan_bwd_ref,
                                        dsa_teacher_scan_fwd,
                                        dsa_teacher_scan_ref)
from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                              ms_deform_attn_bwd,
                                              ms_deform_attn_bwd_ref,
                                              ms_deform_attn_ref)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU build')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _t(x, dev):
    return torch.from_numpy(np.asarray(x)).to(dev)


@pytest.mark.parametrize('shapes', [(8, 4, 2, 1), (12, 6, 3), (7,),
                                    (200, 100, 50, 25)])
def test_msda_kernel_matches_plain(cuda, shapes):
    rng = np.random.default_rng(len(shapes))
    B, Q, H, D, P, L = 2, 37, 3, 20, 3, len(shapes)
    value = _t(rng.standard_normal((B, sum(shapes), H, D), np.float32), cuda)
    loc = _t(rng.uniform(-0.3, 1.3, (B, Q, H, L, P)).astype(np.float32), cuda)
    attn = rng.uniform(0, 1, (B, Q, H, L, P)).astype(np.float32)
    attn = _t(attn / attn.sum(axis=(3, 4), keepdims=True), cuda)
    launches = ms_deform_attn.launches
    out = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == launches + 1
    ref = ms_deform_attn_ref(value, shapes, loc, attn)
    assert float((out - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.parametrize('H', [1, 2, 8])
def test_greedy_kernel_matches_plain(cuda, H):
    """Q = 13 spans a full and a ragged query tile; V+1 = 131."""
    rng = np.random.default_rng(H)
    B, Q, Dh, A, R, E, V, K, P = 2, 13, 8, 16, 24, 12, 130, 7, 2
    ts = (12, 6)
    S, LP = sum(ts), len(ts) * P

    def f(*s, scale=1.0):
        return _t((rng.standard_normal(s) * scale).astype(np.float32), cuda)

    args = (f(B, H, S, Dh),
            _t(rng.uniform(-0.5, 11.5, (B, H, Q, LP)).astype(np.float32), cuda),
            _t(rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32), cuda),
            f(B, Q, 4 * R, scale=0.3), f(V + 1, E, scale=0.3),
            f(E, 4 * R, scale=0.3), f(R, V + 1, scale=0.5),
            f(V + 1, scale=0.1), f(H, R, LP, scale=0.2), f(R, A, scale=0.3),
            f(A, scale=0.1), f(Dh, A, scale=0.3), f(A, scale=0.1),
            f(A, scale=0.3), 0.05, f(H, Dh, 4 * R, scale=0.2),
            f(R, 4 * R, scale=0.2))
    launches = dsa_greedy_scan.launches
    tok, lp = dsa_greedy_scan(*args, ts, K)
    torch.cuda.synchronize()
    assert dsa_greedy_scan.launches == launches + 1
    ref_tok, ref_lp, margin = dsa_greedy_scan_ref(*args, ts, K,
                                                  with_margin=True)
    ok = torch.cumprod((margin > 1e-3).to(torch.int32), dim=1).bool()
    assert float(ok.float().mean()) > 0.5
    assert not bool(((tok != ref_tok) & ok).any())
    assert float(((lp - ref_lp).abs() * ok).max()) <= 1e-3


def test_kernels_refuse_what_they_do_not_implement(cuda):
    value = torch.zeros((1, 6, 1, 4), device=cuda)
    loc = torch.zeros((1, 2, 1, 1, 2), device=cuda)
    attn = torch.zeros((1, 2, 1, 1, 2), device=cuda)
    with pytest.raises(ValueError):
        ms_deform_attn(value, (5,), loc, attn)
    with pytest.raises(TypeError):
        ms_deform_attn(value.double(), (6,), loc, attn)
    with pytest.raises(ValueError):
        ms_deform_attn_bwd(value, (6,), loc, attn,
                           torch.zeros((1, 3, 4), device=cuda))
    args = scan_args(cuda, np.random.default_rng(0), B=1, H=1, Q=2, K=1)
    with pytest.raises(ValueError):
        dsa_teacher_scan_fwd(*args, (12, 7))


def _close(got, want, rel, atol=1e-7):
    err = float((got - want).abs().max())
    return err <= rel * float(want.abs().max()) + atol, err


@pytest.mark.parametrize('shapes', [(8, 4, 2, 1), (12, 6, 3), (7,),
                                    (200, 100, 50, 25)])
def test_msda_backward_kernel_matches_plain(cuda, shapes):
    """The kernel's (dvalue, dloc, dattn), and autograd through the
    wrapper, against autograd through the plain version."""
    rng = np.random.default_rng(10 + len(shapes))
    B, Q, H, D, P, L = 2, 37, 3, 20, 3, len(shapes)
    value = _t(rng.standard_normal((B, sum(shapes), H, D), np.float32), cuda)
    loc = _t(rng.uniform(-0.3, 1.3, (B, Q, H, L, P)).astype(np.float32), cuda)
    attn = rng.uniform(0, 1, (B, Q, H, L, P)).astype(np.float32)
    attn = _t(attn / attn.sum(axis=(3, 4), keepdims=True), cuda)
    g = _t(rng.standard_normal((B, Q, H * D), np.float32), cuda)
    launches = ms_deform_attn_bwd.launches
    got = ms_deform_attn_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd.launches == launches + 1
    want = ms_deform_attn_bwd_ref(value, shapes, loc, attn, g)
    for name, a, b in zip(('dvalue', 'dloc', 'dattn'), got, want):
        ok, err = _close(a, b, 1e-4)
        assert ok, (name, err)
    leaves = [t.clone().requires_grad_() for t in (value, loc, attn)]
    (ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]) * g).sum() \
        .backward()
    for a, b in zip(leaves, want):
        assert _close(a.grad, b, 1e-4)[0]


def scan_args(dev, rng, B=2, H=2, Q=13, K=5, Dh=8, A=16, R=24, P=2,
              ts=(12, 6)):
    S, LP = sum(ts), len(ts) * P

    def f(*s, scale=1.0):
        return _t((rng.standard_normal(s) * scale).astype(np.float32), dev)

    return (f(B, H, S, Dh),
            _t(rng.uniform(-0.5, max(ts) - 0.5, (B, H, Q, LP))
               .astype(np.float32), dev),
            _t(rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32), dev),
            f(B, K, Q, 4 * R, scale=0.3), f(H, R, LP, scale=0.2),
            f(R, A, scale=0.3), f(A, scale=0.1), f(Dh, A, scale=0.3),
            f(A, scale=0.1), f(A, scale=0.3),
            torch.tensor(0.05, device=dev), f(H, Dh, 4 * R, scale=0.2),
            f(R, 4 * R, scale=0.2))


@pytest.mark.parametrize('H,Q,K', [(1, 13, 5), (2, 13, 5), (2, 8, 1),
                                   (1, 3, 29)])
def test_scan_kernels_match_plain(cuda, H, Q, K):
    """Forward (hs, cs) and the 13 gradients; Q = 13 spans a full and a
    ragged query tile, Q = 8 exactly one tile."""
    rng = np.random.default_rng(100 * H + Q + K)
    ts = (12, 6)
    args = scan_args(cuda, rng, H=H, Q=Q, K=K, ts=ts)
    launches = (dsa_teacher_scan_fwd.launches, dsa_teacher_scan_bwd.launches)
    hs, cs = dsa_teacher_scan_fwd(*args, ts)
    g = torch.sin(3.0 * hs)
    grads = dsa_teacher_scan_bwd(*args, ts, hs, cs, g)
    torch.cuda.synchronize()
    assert (dsa_teacher_scan_fwd.launches, dsa_teacher_scan_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1)
    ref_hs, ref_cs = dsa_teacher_scan_ref(*args, ts)
    assert _close(hs, ref_hs, 1e-4)[0] and _close(cs, ref_cs, 1e-4)[0]
    want = dsa_teacher_scan_bwd_ref(*args, ts, ref_hs, ref_cs, g)
    for name, a, b in zip(NAMES, grads, want):
        assert a.shape == b.shape, name
        ok, err = _close(a, b, 1e-3, 1e-5)
        assert ok, (name, err, float(b.abs().max()))
    # the autograd Function hands the same gradients to the leaves
    leaves = [t.clone().requires_grad_() for t in args]
    (dsa_teacher_scan(*leaves, ts) * g).sum().backward()
    for name, a, b in zip(NAMES, leaves, want):
        assert _close(a.grad, b, 1e-3, 1e-5)[0], name


def _grad_close(name, got, want):
    """1e-3 relative + 1e-5; d alpha_b (zero in exact arithmetic: the
    softmax's gradients sum to zero) only rounding, so its floor is 5e-5."""
    return _close(got, want, 1e-3, 5e-5 if name == 'ab' else 1e-5)


def test_scan_backward_kernel_at_eight_heads(cuda):
    """K5 at cap_nheads 8 with R = A = 512 and LP = 16: its block fits the
    card's shared memory; small B, Q, K."""
    rng = np.random.default_rng(8)
    ts = (200, 100, 50, 25)
    args = scan_args(cuda, rng, B=1, H=8, Q=11, K=2, Dh=64, A=512, R=512,
                     P=4, ts=ts)
    hs, cs = dsa_teacher_scan_fwd(*args, ts)
    g = torch.sin(3.0 * hs)
    grads = dsa_teacher_scan_bwd(*args, ts, hs, cs, g)
    torch.cuda.synchronize()
    want = dsa_teacher_scan_bwd_ref(*args, ts, hs, cs, g)
    for name, a, b in zip(NAMES, grads, want):
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))


def step_args(dev, rng, B=2, H=2, Q=13, Dh=8, A=16, R=24, P=2, ts=(12, 6),
              lstm=False):
    """Operands of K7 (and with ``lstm`` of K9) at the kernels' boundary;
    positions drawn over each level's range and past its ends."""
    S, LP = sum(ts), len(ts) * P

    def f(*s, scale=1.0):
        return _t((rng.standard_normal(s) * scale).astype(np.float32), dev)

    T = np.repeat(np.asarray(ts, np.float32), P)
    pos = rng.uniform(-0.1, 1.1, (B, H, Q, LP)) * T - 0.5
    head = (f(B, H, S, Dh), _t(pos.astype(np.float32), dev),
            f(B, Q, A, scale=0.5))
    tail = (f(Dh, A, scale=0.3), f(A, scale=0.1), f(A, scale=0.3),
            torch.tensor(0.05, device=dev))
    if not lstm:
        return head + tail
    return head + (f(B, Q, 4 * R, scale=0.5), f(B, Q, R, scale=0.5),
                   f(B, Q, R, scale=0.5), f(H, Dh, 4 * R, scale=0.2),
                   f(R, 4 * R, scale=0.2)) + tail


@pytest.mark.parametrize('H,Q', [(1, 13), (2, 13), (2, 8), (8, 3)])
def test_step_kernels_match_plain(cuda, H, Q):
    """K7 and K8 with VW given (ctx and its 7 gradients, G among them)
    against the plain table-form step; K8 composed with the table and its
    backward (the 7 gradients at the JAX boundary) and autograd through the
    wrapper, against the plain step; Q = 13 spans a full and a ragged query
    tile."""
    rng = np.random.default_rng(200 + 10 * H + Q)
    ts = (12, 6)
    args = step_args(cuda, rng, H=H, Q=Q, ts=ts)
    kargs = _table_args(args)
    launches = (dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches)
    ctx = dsa_sample_attend_fwd(*kargs, ts)
    g = torch.sin(3.0 * ctx)
    grads = dsa_sample_attend_bwd(*kargs, ts, g)
    torch.cuda.synchronize()
    assert (dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1)
    for ref in (sample_attend_table_ref(*kargs, ts),
                sample_attend_ref(*args, ts)):
        assert _close(ctx, ref, 1e-4)[0]
    want = sample_attend_table_bwd_ref(*kargs, ts, g)
    for name, a, b in zip(STEP_TABLE_NAMES, grads, want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    want = sample_attend_bwd_ref(*args, ts, g)
    for name, a, b in zip(STEP_NAMES, dsa_sample_attend_grads(*args, ts, g),
                          want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    leaves = [t.clone().requires_grad_() for t in args]
    (dsa_sample_attend_core(*leaves, ts) * g).sum().backward()
    for name, a, b in zip(STEP_NAMES, leaves, want):
        assert _grad_close(name, a.grad, b)[0], name


def _table_args(args):
    """The kernels' operands from the JAX boundary's (``step_args``, with
    ``lstm`` or without): value_t, VW = value_t . cw (torch.einsum), then
    the rest without cw."""
    i = 8 if len(args) == len(LSTM_NAMES) else 3
    vw = torch.einsum('bhsd,da->bhsa', args[0], args[i])
    return (args[0], vw) + tuple(args[1:i]) + tuple(args[i + 1:])


def test_sample_attend_steps_share_one_table(cuda):
    """Three word steps through K7/K8 on one VW (``dsa_value_table``, as
    the caption head builds it once per forward pass, each step's hvec fed
    by the last one's ctx): one table launch, one table backward on the
    summed G, and the gradients of the plain steps on the table."""
    rng = np.random.default_rng(351)
    ts = (12, 6)
    args = step_args(cuda, rng, H=2, Q=13, ts=ts)
    launches = (table_gemm.launches, table_gemm_bwd.launches,
                dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches)

    def run(table, step):
        leaves = [t.clone().requires_grad_() for t in args]
        value_t, pos, hvec, cw = leaves[:4]
        vw = table(value_t, cw)
        out = 0.0
        for _ in range(3):
            ctx = step(value_t, vw, pos, hvec, *leaves[4:], ts)
            hvec = hvec + torch.tanh(ctx).sum((1, 3))[..., None]
            out = out + (ctx * torch.sin(3.0 * ctx.detach())).sum()
        out.backward()
        return [t.grad for t in leaves]

    got = run(dsa_value_table, dsa_sample_attend_table_core)
    torch.cuda.synchronize()
    assert (table_gemm.launches, table_gemm_bwd.launches,
            dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1, launches[2] + 3, launches[3] + 3)
    want = run(lambda v, w: torch.einsum('bhsd,da->bhsa', v, w),
               sample_attend_table_ref)
    for name, a, b in zip(STEP_NAMES, got, want):
        assert _grad_close(name, a, b)[0], name


@pytest.mark.parametrize('H,Q', [(1, 13), (2, 8), (8, 3)])
def test_lstm_step_kernels_match_plain(cuda, H, Q):
    """K9 and K10 with VW given ((h', c') and their 12 gradients, G among
    them, for both cotangents) against the plain table-form step; K10
    composed with the table and its backward (the 12 gradients at the JAX
    boundary) and autograd through the wrapper, against the plain step."""
    rng = np.random.default_rng(300 + 10 * H + Q)
    ts = (12, 6)
    args = step_args(cuda, rng, H=H, Q=Q, ts=ts, lstm=True)
    kargs = _table_args(args)
    launches = (dsa_lstm_step_fwd.launches, dsa_lstm_step_bwd.launches)
    h_new, c_new = dsa_lstm_step_fwd(*kargs, ts)
    gh, gc = torch.sin(3.0 * h_new), torch.cos(2.0 * c_new)
    grads = dsa_lstm_step_bwd(*kargs, ts, gh, gc)
    torch.cuda.synchronize()
    assert (dsa_lstm_step_fwd.launches, dsa_lstm_step_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1)
    for ref_h, ref_c in (lstm_step_table_ref(*kargs, ts),
                         lstm_step_ref(*args, ts)):
        assert _close(h_new, ref_h, 1e-4)[0] and _close(c_new, ref_c, 1e-4)[0]
    want = lstm_step_table_bwd_ref(*kargs, ts, gh, gc)
    for name, a, b in zip(LSTM_TABLE_NAMES, grads, want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    want = lstm_step_bwd_ref(*args, ts, gh, gc)
    for name, a, b in zip(LSTM_NAMES, dsa_lstm_step_grads(*args, ts, gh, gc),
                          want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    leaves = [t.clone().requires_grad_() for t in args]
    h2, c2 = dsa_lstm_step_core(*leaves, ts)
    ((h2 * gh).sum() + (c2 * gc).sum()).backward()
    for name, a, b in zip(LSTM_NAMES, leaves, want):
        assert _grad_close(name, a.grad, b)[0], name


def test_lstm_steps_share_one_table(cuda):
    """Three fused steps on one VW (``dsa_value_table``, as the caption head
    builds it once per forward pass): one table launch, one table backward
    on the summed G, and the gradients of the plain steps on the table."""
    rng = np.random.default_rng(350)
    ts = (12, 6)
    args = step_args(cuda, rng, H=2, Q=13, ts=ts, lstm=True)
    launches = (table_gemm.launches, table_gemm_bwd.launches)

    def run(table, step):
        leaves = [t.clone().requires_grad_() for t in args]
        value_t, cw = leaves[0], leaves[8]
        vw = table(value_t, cw)
        h, c = leaves[4], leaves[5]
        for _ in range(3):
            h, c = step(value_t, vw, *leaves[1:4], h, c, *leaves[6:8],
                        *leaves[9:], ts)
        ((h * torch.sin(3.0 * h.detach())).sum() + c.sum()).backward()
        return [t.grad for t in leaves]

    got = run(dsa_value_table, dsa_lstm_step_table_core)
    torch.cuda.synchronize()
    assert (table_gemm.launches, table_gemm_bwd.launches) == \
        (launches[0] + 1, launches[1] + 1)
    want = run(lambda v, w: torch.einsum('bhsd,da->bhsa', v, w),
               lstm_step_table_ref)
    for name, a, b in zip(LSTM_NAMES, got, want):
        assert _grad_close(name, a, b)[0], name


def test_lstm_step_kernels_refuse_what_they_do_not_implement(cuda):
    """K9 and K10 take A <= 512 and A, Dh, R multiples of 4: their
    wrappers raise outside those limits; K10 reads the gate weights' rows
    as float4, so its wrapper copies a misaligned view (the gradients still
    match) and its entry point refuses a misaligned pointer."""
    from dvc_tpu_torch.ops import _cuda
    rng = np.random.default_rng(360)
    ts = (12, 6)
    for kw in ({'A': 18}, {'Dh': 6}, {'R': 6}):
        kargs = _table_args(step_args(cuda, rng, ts=ts, lstm=True, **kw))
        with pytest.raises(ValueError):
            dsa_lstm_step_fwd(*kargs, ts)
    B, H, Q, Dh, A, R, S, LP = 2, 2, 13, 8, 16, 24, 18, 4
    kargs = list(_table_args(step_args(cuda, rng, ts=ts, lstm=True)))
    gh, gc = (_t(rng.standard_normal((B, Q, R)).astype(np.float32), cuda)
              for _ in range(2))
    want = lstm_step_table_bwd_ref(*kargs, ts, gh, gc)
    buf = torch.empty(kargs[8].numel() + 1, device=cuda)      # w_hh
    view = buf[1:].view(kargs[8].shape)
    view.copy_(kargs[8])
    assert view.data_ptr() % 16
    kargs[8] = view
    for name, a, b in zip(LSTM_TABLE_NAMES,
                          dsa_lstm_step_bwd(*kargs, ts, gh, gc), want):
        assert _grad_close(name, a, b)[0], name

    def zeros(*shape):
        return torch.zeros(shape, device=cuda)

    outs = (zeros(B, H, S, Dh), zeros(B, H, S, A), zeros(B, H, Q, LP),
            zeros(B, Q, A), zeros(B, Q, 4 * R), zeros(B, Q, R), zeros(B, Q, R),
            zeros(H, Dh, 4 * R), zeros(R, 4 * R), zeros(A), zeros(A), zeros(1),
            zeros(B, Q, H * Dh),
            _cuda.gemm_work(cuda, (R, 4 * R, B * Q), (H * Dh, 4 * R, B * Q)))
    ab = kargs[11].reshape(1)
    code = _cuda.lib().cdll.dvc_dsa_lstm_bwd(
        *(t.data_ptr() for t in kargs[:11]), ab.data_ptr(), gh.data_ptr(),
        gc.data_ptr(), _cuda.levels_array(ts),
        *(t.data_ptr() for t in outs), B, H, S, Dh, Q, LP, len(ts), A, R,
        outs[-1].numel(), 0, _cuda.stream_ptr(cuda))
    assert code == 1                                    # cudaErrorInvalidValue


def test_step_kernels_at_the_recipe_width(cuda):
    """K7-K10 at R = A = 512, Dh = 512, S = 375, LP = 16 on a few queries
    (with VW given, and K10 composed with the table's backward)."""
    rng = np.random.default_rng(400)
    ts = (200, 100, 50, 25)
    args = step_args(cuda, rng, B=1, H=1, Q=10, Dh=512, A=512, R=512, P=4,
                     ts=ts, lstm=True)
    kargs = _table_args(args)
    h_new, c_new = dsa_lstm_step_fwd(*kargs, ts)
    ref_h, ref_c = lstm_step_ref(*args, ts)
    assert _close(h_new, ref_h, 1e-4)[0] and _close(c_new, ref_c, 1e-4)[0]
    gh, gc = torch.sin(3.0 * h_new), torch.cos(2.0 * c_new)
    want = lstm_step_table_bwd_ref(*kargs, ts, gh, gc)
    for name, a, b in zip(LSTM_TABLE_NAMES,
                          dsa_lstm_step_bwd(*kargs, ts, gh, gc), want):
        assert _grad_close(name, a, b)[0], name
    want = lstm_step_bwd_ref(*args, ts, gh, gc)
    for name, a, b in zip(LSTM_NAMES, dsa_lstm_step_grads(*args, ts, gh, gc),
                          want):
        assert _grad_close(name, a, b)[0], name
    step = args[:3] + args[8:]
    ctx = dsa_sample_attend_fwd(*_table_args(step), ts)
    assert _close(ctx, sample_attend_ref(*step, ts), 1e-4)[0]


def _wide_args(dev, rng, B, H, Q, greedy, K=29, d=512, R=512, A=512, E=512,
               V1=1608, P=4, ts=(200, 100, 50, 25)):
    """Operands of K6 (``greedy``) or the scan at the caption head's
    widths, scaled like fan-in-normalised weights; positions over each
    level's range and past both its ends."""
    Dh, L, S = d // H, len(ts), sum(ts)
    LP = L * P

    def w(*s, fan_in):
        return _t((rng.standard_normal(s) / fan_in ** 0.5).astype(np.float32),
                  dev)

    T = np.repeat(np.asarray(ts, np.float32), P)
    pos = (rng.uniform(-0.1, 1.1, (B, H, Q, LP)) * T - 0.5).astype(np.float32)
    head = (_t(rng.standard_normal((B, H, S, Dh)).astype(np.float32), dev),
            _t(pos, dev),
            _t(rng.uniform(0.2, 2.2, (B, Q, LP)).astype(np.float32), dev))
    attn = (w(H, R, LP, fan_in=R), w(R, A, fan_in=R), w(A, fan_in=100),
            w(Dh, A, fan_in=Dh), w(A, fan_in=100), w(A, fan_in=A),
            torch.tensor(0.05, device=dev))
    tail = (w(H, Dh, 4 * R, fan_in=d), w(R, 4 * R, fan_in=R))
    if not greedy:
        return head + (w(B, K, Q, 4 * R, fan_in=4),) + attn + tail
    return (head + (w(B, Q, 4 * R, fan_in=4), w(V1, E, fan_in=4),
                    w(E, 4 * R, fan_in=E), w(R, V1, fan_in=R / 4),
                    w(V1, fan_in=100)) + attn + tail)


@pytest.mark.parametrize('B,H', [(1, 1), (16, 1), (1, 8), (16, 8)])
def test_greedy_kernel_at_the_serving_width(cuda, B, H):
    """K6 (tables value . Wc and embed . token_w, then the decode) at
    R = A = E = 512, V+1 = 1608, S = 375, LP = 16, Q = 100 (a ragged tile),
    K = 30: B = 16 takes the 16-query tiles, B = 1 the 8-query ones."""
    rng = np.random.default_rng(500 + 10 * B + H)
    ts = (200, 100, 50, 25)
    args = _wide_args(cuda, rng, B, H, 100, greedy=True)
    with torch.inference_mode():
        tok, lp = dsa_greedy_scan(*args, ts, 30)
        ref_tok, ref_lp, margin = dsa_greedy_scan_ref(*args, ts, 30,
                                                      with_margin=True)
    ok = torch.cumprod((margin > 1e-3).to(torch.int32), dim=1).bool()
    assert float(ok.float().mean()) > 0.5
    assert not bool(((tok != ref_tok) & ok).any())
    assert float(((lp - ref_lp).abs() * ok).max()) <= 1e-3


def _off_boundary(args, hs, g):
    """g with zero rows for every query that has, at any step, a tap
    position within 2e-6 + 2^-23 |pos| of a level-relative integer (from
    the trajectory hs, in float64; chip_smoke's ``scan_positions`` and
    ``near_integer``), and the share of queries so dropped.
    There the tap pair, and so the gradient with respect to the position,
    jumps, and the kernel's and the plain version's sums of h . off_w may
    round to either side (ROADMAP C): at B=16, H=8 one tap 5e-7 below an
    integer moves its query's dbase by 0.3 and, through dh, every earlier
    step of that query.  A query with a zero cotangent adds exactly zero
    to every gradient on both sides."""
    drop = near_integer(scan_positions(args, hs))                  # (B, Q)
    return g * (~drop)[:, None, :, None], float(drop.float().mean())


@pytest.mark.parametrize('B,H', [(1, 1), (16, 1), (1, 8), (16, 8)])
def test_scan_backward_kernel_at_the_train_width(cuda, B, H):
    """K5 (table value . Wc, the reverse scan, G . Wc^T into dvalue, the
    split-K outer sums) at R = A = 512, S = 375, LP = 16, Q = 90 (a ragged
    tile), K = 29, to check_scan's tolerances: each gradient within 1e-3 *
    max|ref| + 1e-5, d alpha_b's floor max(5e-5, 2.5e-10 * B*K*Q*H*LP);
    queries with a tap on a level-relative integer get a zero cotangent
    (``_off_boundary``; at most a tenth of them)."""
    rng = np.random.default_rng(600 + 10 * B + H)
    ts = (200, 100, 50, 25)
    Q, K, LP = 90, 29, 16
    args = _wide_args(cuda, rng, B, H, Q, greedy=False, K=K)
    hs, cs = dsa_teacher_scan_fwd(*args, ts)
    g = _t(rng.standard_normal(tuple(hs.shape)).astype(np.float32), cuda)
    g, dropped = _off_boundary(args, hs, g)
    assert dropped <= 0.1, dropped
    launches = dsa_teacher_scan_bwd.launches
    grads = dsa_teacher_scan_bwd(*args, ts, hs, cs, g)
    torch.cuda.synchronize()
    assert dsa_teacher_scan_bwd.launches == launches + 1
    want = dsa_teacher_scan_bwd_ref(*args, ts, hs, cs, g)
    floor = max(5e-5, 2.5e-10 * B * K * Q * H * LP)
    for name, a, b in zip(NAMES, grads, want):
        ok, err = _close(a, b, 1e-3, floor if name == 'ab' else 1e-5)
        assert ok, (name, err, float(b.abs().max()))


@pytest.mark.parametrize('B,H', [(1, 1), (2, 1), (8, 1), (16, 1), (1, 8)])
def test_scan_forward_kernel_at_the_train_width(cuda, B, H):
    """K4 (table value . Wc, then the K-step scan) at R = A = 512, S = 375,
    LP = 16, Q = 90, K = 29, at each query tile the host picks on a 132-SM
    card: 4 queries (B = 1: 23 blocks with a ragged last tile, at H = 1 and
    8; B = 2: 46), 8 (B = 8), 16 (B = 16): hs and cs within 1e-4 *
    max|ref|."""
    rng = np.random.default_rng(650 + 10 * B + H)
    ts = (200, 100, 50, 25)
    args = _wide_args(cuda, rng, B, H, 90, greedy=False, K=29)
    launches = dsa_teacher_scan_fwd.launches
    hs, cs = dsa_teacher_scan_fwd(*args, ts)
    torch.cuda.synchronize()
    assert dsa_teacher_scan_fwd.launches == launches + 1
    ref_hs, ref_cs = dsa_teacher_scan_ref(*args, ts)
    for name, a, b in (('hs', hs, ref_hs), ('cs', cs, ref_cs)):
        ok, err = _close(a, b, 1e-4)
        assert ok, (name, err, float(b.abs().max()))


def _wide_step_args(dev, rng, B, H, Q, d=512, A=512, P=4,
                    ts=(200, 100, 50, 25)):
    """K7's operands at the caption head's widths (as chip_smoke's
    ``step_inputs``): positions over each level's range and past both its
    ends, weights scaled like fan-in-normalised ones."""
    Dh, S = d // H, sum(ts)
    LP = len(ts) * P

    def w(*s, fan_in):
        return _t((rng.standard_normal(s) / fan_in ** 0.5).astype(np.float32),
                  dev)

    T = np.repeat(np.asarray(ts, np.float32), P)
    pos = (rng.uniform(-0.1, 1.1, (B, H, Q, LP)) * T - 0.5).astype(np.float32)
    return (_t(rng.standard_normal((B, H, S, Dh)).astype(np.float32), dev),
            _t(pos, dev), w(B, Q, A, fan_in=4), w(Dh, A, fan_in=Dh),
            w(A, fan_in=100), w(A, fan_in=A), torch.tensor(0.05, device=dev))


@pytest.mark.parametrize('B,Q,H', [(1, 90, 1), (16, 100, 1), (16, 100, 8)])
def test_step_forward_kernel_at_the_word_step_widths(cuda, B, Q, H):
    """K7 with VW given at A = 512, Dh = 512 / H, S = 375, LP = 16 and the
    stepwise path's shapes (B = 1 takes 4-query tiles, B = 16 16-query
    ones; Q = 90 and 100 leave a ragged tile), to check_step's tolerance:
    ctx within 1e-4 * max|ref| of the plain table-form step and of the
    plain step (their scores differ only in rounding)."""
    rng = np.random.default_rng(650 + 10 * B + H)
    ts = (200, 100, 50, 25)
    args = _wide_step_args(cuda, rng, B, H, Q)
    kargs = _table_args(args)
    launches = dsa_sample_attend_fwd.launches
    ctx = dsa_sample_attend_fwd(*kargs, ts)
    torch.cuda.synchronize()
    assert dsa_sample_attend_fwd.launches == launches + 1
    for ref in (sample_attend_table_ref(*kargs, ts),
                sample_attend_ref(*args, ts)):
        ok, err = _close(ctx, ref, 1e-4)
        assert ok, (err, float(ref.abs().max()))


@pytest.mark.parametrize('B,Q,H', [(1, 90, 1), (16, 100, 1), (16, 100, 8)])
def test_step_backward_kernel_at_the_word_step_widths(cuda, B, Q, H):
    """K8 with VW given (the step's backward from VW; dvalue's context term
    and G = dL/dVW) at A = 512, Dh = 512 / H, S = 375, LP = 16 and the
    stepwise path's shapes (B = 1 takes 2-query tiles, B = 16 8-query
    ones; Q = 90 and 100 leave a ragged tile), against the plain table-form
    step, and composed with the table and its backward
    (``dsa_sample_attend_grads``) against the plain step, to check_step's
    tolerances: each gradient within 1e-3 * max|ref| + 1e-5, d alpha_b's
    floor max(5e-5, 2.5e-10 * N, 2^-18 * sqrt(N) * the mean |term|) over
    its N = B*H*Q*LP terms; queries with a tap within an ulp of a
    level-relative integer get a zero cotangent (chip_smoke's
    ``near_integer``, as ``_off_boundary`` does for the scan; at most a
    tenth of them)."""
    rng = np.random.default_rng(700 + 10 * B + H)
    ts = (200, 100, 50, 25)
    args = _wide_step_args(cuda, rng, B, H, Q)
    kargs = _table_args(args)
    g = _t(rng.standard_normal((B, H, Q, 512 // H)).astype(np.float32), cuda)
    drop = near_integer(args[1].double())
    assert float(drop.float().mean()) <= 0.1
    g = g * (~drop)[:, None, :, None]
    launches = dsa_sample_attend_bwd.launches
    grads = dsa_sample_attend_bwd(*kargs, ts, g)
    torch.cuda.synchronize()
    assert dsa_sample_attend_bwd.launches == launches + 1
    # d alpha_b's terms, one per tap row (alpha_b broadcast to every row)
    rows = args[6].expand(args[1].shape).clone().requires_grad_()
    terms, = torch.autograd.grad(sample_attend_ref(*args[:6], rows, ts),
                                 rows, g)
    N = terms.numel()
    floor = max(5e-5, 2.5e-10 * N,
                2.0 ** -18 * N ** 0.5 * float(terms.abs().mean()))
    for names, got, want in (
            (STEP_TABLE_NAMES, grads, sample_attend_table_bwd_ref(*kargs, ts, g)),
            (STEP_NAMES, dsa_sample_attend_grads(*args, ts, g),
             sample_attend_bwd_ref(*args, ts, g))):
        for name, a, b in zip(names, got, want):
            assert a.shape == b.shape, name
            ok, err = _close(a, b, 1e-3, floor if name == 'ab' else 1e-5)
            assert ok, (name, err, float(b.abs().max()))


def test_step_backward_copies_a_misaligned_operand(cuda):
    """K8 reads value rows, VW rows, cb and alpha_w as float4: the wrapper
    copies a view whose storage is not 16-byte aligned (the gradients still
    match the plain version's), and the entry point refuses such a pointer
    with cudaErrorInvalidValue."""
    from dvc_tpu_torch.ops import _cuda
    rng = np.random.default_rng(800)
    ts = (12, 6)
    B, H, Q, Dh, A, S, LP = 2, 2, 13, 8, 16, 18, 4
    args = list(_table_args(step_args(cuda, rng, B=B, H=H, Q=Q, Dh=Dh, A=A,
                                      ts=ts)))
    g = _t(rng.standard_normal((B, H, Q, Dh)).astype(np.float32), cuda)
    want = sample_attend_table_bwd_ref(*args, ts, g)
    for i in (0, 1, 4, 5):                              # value_t, vw, cb, aw
        buf = torch.empty(args[i].numel() + 1, device=cuda)
        view = buf[1:].view(args[i].shape)
        view.copy_(args[i])
        assert view.data_ptr() % 16
        args[i] = view
    for name, a, b in zip(STEP_TABLE_NAMES,
                          dsa_sample_attend_bwd(*args, ts, g), want):
        assert _grad_close(name, a, b)[0], name

    def zeros(*shape):
        return torch.zeros(shape, device=cuda)

    outs = (zeros(B, H, S, Dh), zeros(B, H, S, A), zeros(B, H, Q, LP),
            zeros(B, Q, A), zeros(A), zeros(A), zeros(1))
    ab = args[6].reshape(1)
    code = _cuda.lib().cdll.dvc_dsa_step_bwd(
        *(t.data_ptr() for t in args[:6]), ab.data_ptr(), g.data_ptr(),
        _cuda.levels_array(ts), *(t.data_ptr() for t in outs), B, H, S, Dh,
        Q, LP, len(ts), A, 0, _cuda.stream_ptr(cuda))
    assert code == 1                                    # cudaErrorInvalidValue


def _msda_args(dev, rng, B, Q, H, D, P, shapes):
    value = _t(rng.standard_normal((B, sum(shapes), H, D), np.float32), dev)
    loc = _t(rng.uniform(-0.3, 1.3, (B, Q, H, len(shapes), P))
             .astype(np.float32), dev)
    attn = rng.uniform(0, 1, (B, Q, H, len(shapes), P)).astype(np.float32)
    attn = _t(attn / attn.sum(axis=(3, 4), keepdims=True), dev)
    return value, loc, attn


@pytest.mark.parametrize('B,Q,H,D,P', [(1, 375, 8, 64, 4), (1, 1, 8, 64, 4),
                                       (1, 41, 8, 64, 4), (16, 100, 8, 64, 4),
                                       (3, 53, 2, 5, 3), (2, 29, 3, 66, 2),
                                       (2, 17, 2, 128, 9)])
def test_msda_forward_kernel_at_one_video_and_tile_edges(cuda, B, Q, H, D,
                                                          P):
    """The forward on its staged head slice at the recipe's widths (S = 375,
    H = 8, D = 64, L = P = 4) at B = 1 (8 (b, h) pairs, so the tile rule
    splits Q into many tiles; Q = 1 and 41 leave ragged tiles) and at the
    decoder's B = 16, Q = 100; and at widths that take the other lane and
    copy widths: D = 5 (one float a lane, 4-byte copies), D = 66 (two
    column chunks of float2, 8-byte copies), D = 128 (float4), and L*P = 36
    points (two chunks of 32 lanes)."""
    rng = np.random.default_rng(900 + B + Q + D)
    shapes = (200, 100, 50, 25)
    value, loc, attn = _msda_args(cuda, rng, B, Q, H, D, P, shapes)
    launches = ms_deform_attn.launches
    out = ms_deform_attn(value, shapes, loc, attn)
    torch.cuda.synchronize()
    assert ms_deform_attn.launches == launches + 1
    ref = ms_deform_attn_ref(value, shapes, loc, attn)
    ok, err = _close(out, ref, 1e-4)
    assert ok, (err, float(ref.abs().max()))


def test_msda_forward_kernel_stages_a_misaligned_slice(cuda):
    """A value view whose storage starts 4 bytes past a 16-byte boundary
    (the slice's rows then copy 4 bytes at a time), and the refusal of a
    head slice above the card's opt-in shared memory of a block (S*D*4
    bytes)."""
    rng = np.random.default_rng(950)
    shapes = (40, 20)
    value, loc, attn = _msda_args(cuda, rng, 2, 23, 3, 20, 3, shapes)
    buf = torch.empty(value.numel() + 1, device=cuda)
    view = buf[1:].view(value.shape)
    view.copy_(value)
    assert view.data_ptr() % 16
    out = ms_deform_attn(view, shapes, loc, attn)
    ok, err = _close(out, ms_deform_attn_ref(value, shapes, loc, attn), 1e-4)
    assert ok, err
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    S = optin // (4 * 64) + 1
    value, loc, attn = _msda_args(cuda, rng, 1, 3, 1, 64, 1, (S,))
    with pytest.raises(RuntimeError):
        ms_deform_attn(value, (S,), loc, attn)


def _msda_bwd_close(got, value, shapes, loc, attn, g):
    """Each of the kernel's (dvalue, dloc, dattn) within 1e-4 of its max
    |ref| of the plain backward (dvalue summed by atomics in no fixed
    order)."""
    want = ms_deform_attn_bwd_ref(value, shapes, loc, attn, g)
    for name, a, b in zip(('dvalue', 'dloc', 'dattn'), got, want):
        ok, err = _close(a, b, 1e-4)
        assert ok, (name, err, float(b.abs().max()))


@pytest.mark.parametrize('B,Q,H,D,P', [(1, 375, 8, 64, 4), (1, 41, 8, 64, 4),
                                       (1, 1, 8, 64, 4), (16, 100, 8, 64, 4),
                                       (16, 375, 8, 64, 4), (3, 53, 2, 5, 3),
                                       (2, 29, 3, 66, 2), (2, 17, 2, 128, 9)])
def test_msda_backward_kernel_at_one_video_and_tile_edges(cuda, B, Q, H, D,
                                                           P):
    """K3 on its shared dvalue slice at the recipe's widths (S = 375, H = 8,
    D = 64, L = P = 4): at B = 1 (8 (b, h) pairs, so Q is split into tiles
    whose slices are added into dvalue; Q = 41 leaves a ragged tile, Q = 1
    one tile) and at the train step's B = 16, Q = 100 and 375 (one tile a
    pair, the slice stored); and at widths that take the other lane widths
    and copies: D = 5 (one column a lane, 4-byte copies and stores), D = 66
    (two column chunks, 8-byte ones), D = 128 (four columns a lane), and
    L*P = 36 points (three chunks of 16)."""
    rng = np.random.default_rng(1900 + B + Q + D)
    shapes = (200, 100, 50, 25)
    value, loc, attn = _msda_args(cuda, rng, B, Q, H, D, P, shapes)
    g = _t(rng.standard_normal((B, Q, H * D), np.float32), cuda)
    launches = ms_deform_attn_bwd.launches
    got = ms_deform_attn_bwd(value, shapes, loc, attn, g)
    torch.cuda.synchronize()
    assert ms_deform_attn_bwd.launches == launches + 1
    _msda_bwd_close(got, value, shapes, loc, attn, g)


def test_msda_backward_kernel_stages_a_misaligned_slice(cuda):
    """value and g as views whose storage starts 4 bytes past a 16-byte
    boundary: the value slice is staged 4 bytes at a time."""
    rng = np.random.default_rng(1950)
    shapes = (40, 20)
    value, loc, attn = _msda_args(cuda, rng, 2, 23, 3, 20, 3, shapes)
    g = _t(rng.standard_normal((2, 23, 60), np.float32), cuda)
    views = []
    for t in (value, g):
        buf = torch.empty(t.numel() + 1, device=cuda)
        views.append(buf[1:].view(t.shape))
        views[-1].copy_(t)
        assert views[-1].data_ptr() % 16
    got = ms_deform_attn_bwd(views[0], shapes, loc, attn, views[1])
    _msda_bwd_close(got, value, shapes, loc, attn, g)


@pytest.mark.parametrize('D', [64, 5, 128])
def test_msda_kernels_share_the_shared_memory_limit(cuda, D):
    """Both passes take a head slice of S*D floats up to the card's opt-in
    shared memory of a block and refuse one float row more.  Just under the
    limit the backward's value rows do not fit beside its dvalue slice, so
    it reads them through L2; at B = 1 its 40 queries are split into tiles
    whose slices are added into dvalue."""
    rng = np.random.default_rng(1970 + D)
    optin = torch.cuda.get_device_properties(cuda) \
        .shared_memory_per_block_optin
    S = optin // (4 * D)
    value, loc, attn = _msda_args(cuda, rng, 1, 40, 1, D, 2, (S,))
    g = _t(rng.standard_normal((1, 40, D), np.float32), cuda)
    out = ms_deform_attn(value, (S,), loc, attn)
    ok, err = _close(out, ms_deform_attn_ref(value, (S,), loc, attn), 1e-4)
    assert ok, err
    got = ms_deform_attn_bwd(value, (S,), loc, attn, g)
    _msda_bwd_close(got, value, (S,), loc, attn, g)
    value, loc, attn = _msda_args(cuda, rng, 1, 40, 1, D, 2, (S + 1,))
    with pytest.raises(RuntimeError):
        ms_deform_attn(value, (S + 1,), loc, attn)
    with pytest.raises(RuntimeError):
        ms_deform_attn_bwd(value, (S + 1,), loc, attn, g)


@pytest.mark.parametrize('B', [1, 16])
def test_msda_backward_kernel_on_encoder_locations(cuda, B):
    """The encoder's self-attention at the recipe's widths: a query per
    position (Q = S = 375) samples near its reference point
    (``encoder_reference_points``) at offsets of up to 3 frames, so the
    taps of neighbouring queries collide on the same dvalue rows of the
    shared slice."""
    rng = np.random.default_rng(1990 + B)
    shapes, H, D, P = (200, 100, 50, 25), 8, 64, 4
    S, L = sum(shapes), len(shapes)
    ref = encoder_reference_points(shapes, torch.ones((B, L), device=cuda))
    off = _t(rng.uniform(-3, 3, (B, S, H, L, P)).astype(np.float32), cuda)
    T = torch.tensor(shapes, dtype=torch.float32, device=cuda)
    loc = ref[:, :, None, :, None, 0] + off / T[:, None]
    value, _, attn = _msda_args(cuda, rng, B, S, H, D, P, shapes)
    g = _t(rng.standard_normal((B, S, H * D), np.float32), cuda)
    got = ms_deform_attn_bwd(value, shapes, loc, attn, g)
    _msda_bwd_close(got, value, shapes, loc, attn, g)


@pytest.mark.parametrize('N,k,n', [(375, 512, 512), (6000, 64, 512),
                                   (1608, 512, 2048), (37, 5, 3)])
def test_table_gemm_matches_einsum(cuda, N, k, n):
    """The tables' GEMM (value . Wc at B*H*S rows, embed . token_w) against
    torch.einsum, f32 with TF32 off: within 1e-5 * sqrt(k) of the largest
    product (sums of k terms in another order)."""
    rng = np.random.default_rng(N + k + n)
    x = _t(rng.standard_normal((N, k)).astype(np.float32), cuda)
    w = _t(rng.standard_normal((k, n)).astype(np.float32), cuda)
    launches = table_gemm.launches
    got = table_gemm(x, w)
    torch.cuda.synchronize()
    assert table_gemm.launches == launches + 1
    want = torch.einsum('nk,km->nm', x, w)
    err = float((got - want).abs().max())
    assert err <= 1e-5 * k ** 0.5 * float(want.abs().max()), err


@pytest.mark.parametrize('N,k,n', [(375, 512, 512), (6000, 64, 512),
                                   (37, 5, 3)])
def test_table_gemm_backward_matches_einsum(cuda, N, k, n):
    """The table GEMM's backward (dx = g . w^T, dw = x^T . g: the table VW's
    backward, once per backward pass of the fused LSTM steps) against
    torch.einsum, f32 with TF32 off: each within 1e-5 * sqrt(terms) of its
    largest value."""
    rng = np.random.default_rng(N + k + n + 1)
    x, w, g = (_t(rng.standard_normal(s).astype(np.float32), cuda)
               for s in ((N, k), (k, n), (N, n)))
    launches = table_gemm_bwd.launches
    dx, dw = table_gemm_bwd(x, w, g)
    torch.cuda.synchronize()
    assert table_gemm_bwd.launches == launches + 1
    for got, want, terms in ((dx, torch.einsum('nm,km->nk', g, w), n),
                             (dw, torch.einsum('nk,nm->km', x, g), N)):
        err = float((got - want).abs().max())
        assert err <= 1e-5 * terms ** 0.5 * float(want.abs().max()), err


# dsa::gemm's three operand layouts: (X along the terms, Y along the terms)
# as the tables (False, True), G . Wc^T (False, False), the outer sums
# (True, True)
GEMM_LAYOUTS = [(False, True), (False, False), (True, True)]


def _gemm(x, x_by_term, y, y_by_term, M, N, T, out, accumulate=False,
          work=None):
    """out (M, N) (+)= X' Y' by dsa::gemm; x and y may be strided views
    (their row stride is the leading dimension).  Returns the C code."""
    from dvc_tpu_torch.ops import _cuda
    if work is None:
        work = _cuda.gemm_work(out.device, (M, N, T))
    code = _cuda.lib().cdll.dvc_dsa_gemm(
        x.data_ptr(), x.stride(0), int(x_by_term), y.data_ptr(), y.stride(0),
        int(y_by_term), M, N, T, int(accumulate), out.data_ptr(),
        work.data_ptr(), work.numel(), 0, _cuda.stream_ptr(out.device))
    torch.cuda.synchronize()
    return code


def _gemm_operands(dev, rng, M, N, T, x_by_term, y_by_term, pad=0):
    """X' (M, T) and Y' (T, N) stored in the given layouts, each inside a
    buffer ``pad`` columns wider than its row; with their plain values."""
    def stored(rows, cols):
        buf = _t(rng.standard_normal((rows, cols + pad)).astype(np.float32),
                 dev)
        return buf[:, :cols]
    x = stored(T, M) if x_by_term else stored(M, T)
    y = stored(T, N) if y_by_term else stored(N, T)
    return x, y, (x.T if x_by_term else x), (y if y_by_term else y.T)


def _gemm_close(got, want, T):
    err = float((got - want).abs().max())
    return err <= 1e-5 * max(T, 1) ** 0.5 * float(want.abs().max()), err


@pytest.mark.parametrize('layout', GEMM_LAYOUTS, ids=str)
@pytest.mark.parametrize('M,N,T', [(129, 129, 31), (65, 65, 1), (129, 65, 100),
                                   (37, 5, 3), (5, 3, 0)])
def test_gemm_ragged_shapes(cuda, layout, M, N, T):
    """Shapes that are no multiple of a tile or a slice: T below one slice
    of 32 terms (and none at all: zeros), M and N one past a tile of 128 or
    64; aligned rows (16-byte copies) and rows of odd length (4-byte ones)
    against torch.einsum within 1e-5 * sqrt(T) of the largest value."""
    rng = np.random.default_rng(M * N + T)
    for pad in (0, 1):
        x, y, xp, yp = _gemm_operands(cuda, rng, M, N, T, *layout, pad=pad)
        out = torch.full((M, N), float('nan'), device=cuda)
        assert _gemm(x, layout[0], y, layout[1], M, N, T, out) == 0
        ok, err = _gemm_close(out, xp @ yp if T else torch.zeros_like(out), T)
        assert ok, (pad, err)


def _plan(cuda, M, N, T):
    """(128 x 128 tiles, chunks, terms a chunk) of the C rule on this card."""
    import ctypes
    from dvc_tpu_torch.ops import _cuda
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    out = (ctypes.c_int * 3)()
    _cuda.lib().cdll.dvc_dsa_gemm_plan(M, N, T, sms, out)
    return tuple(out)


def test_gemm_accumulates_as_dvalue_takes_g_wc(cuda):
    """accumulate=True as K5 and K8 add G . Wc^T into dvalue (both along
    their rows): out0 + G Wc^T, with split-K at the B=1 table's shape (the
    partial tiles' sum adds out0 once) and without at a small one."""
    rng = np.random.default_rng(11)
    for M, N, T in ((375, 512, 512), (37, 8, 16)):
        G, wc, Gp, wcp = _gemm_operands(cuda, rng, M, N, T, False, False)
        out0 = _t(rng.standard_normal((M, N)).astype(np.float32), cuda)
        out = out0.clone()
        assert _gemm(G, False, wc, False, M, N, T, out, accumulate=True) == 0
        ok, err = _gemm_close(out - out0, Gp @ wcp, T)
        assert ok, (M, N, T, err, _plan(cuda, M, N, T))


@pytest.mark.parametrize('pad', [4, 3])
def test_gemm_outer_sum_of_a_strided_operand(cuda, pad):
    """The outer sums take X and Y along the terms with a leading dimension
    above the width (a column block of a wider buffer, as hs_prev would be
    inside (B, K, Q, R + pad)): aligned (pad 4) and not (pad 3)."""
    rng = np.random.default_rng(pad)
    M, N, T = 96, 200, 3000
    x, y, xp, yp = _gemm_operands(cuda, rng, M, N, T, True, True, pad=pad)
    assert x.stride(0) == M + pad and y.stride(0) == N + pad
    out = torch.empty((M, N), device=cuda)
    assert _gemm(x, True, y, True, M, N, T, out) == 0
    ok, err = _gemm_close(out, xp @ yp, T)
    assert ok, err


@pytest.mark.parametrize('layout', GEMM_LAYOUTS, ids=str)
def test_gemm_is_bitwise_deterministic(cuda, layout):
    """Two runs on the same inputs give equal bits: split-K partial tiles
    are added in chunk order (6000 terms: 16 chunks of the outer sum)."""
    rng = np.random.default_rng(5)
    M, N, T = (512, 512, 6000) if layout[0] else (2000, 512, 512)
    x, y, _, _ = _gemm_operands(cuda, rng, M, N, T, *layout)
    a, b = (torch.empty((M, N), device=cuda) for _ in range(2))
    assert _gemm(x, layout[0], y, layout[1], M, N, T, a) == 0
    assert _gemm(x, layout[0], y, layout[1], M, N, T, b) == 0
    assert torch.equal(a, b)


def test_table_gemm_splits_at_the_b1_shape(cuda):
    """The table at B=1 (375 x 512 . 512 x 512) is split into chunks of the
    terms (its 64 x 64 tiles alone fill a third of the SMs); the wrapper's
    workspace is exactly what the C rule takes, and one float less is
    refused (cudaErrorInvalidValue) rather than cut into fewer chunks."""
    from dvc_tpu_torch.ops import _cuda
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    N, k, n = 375, 512, 512
    assert _plan(cuda, N, n, k)[1] > 1
    rng = np.random.default_rng(375)
    x = _t(rng.standard_normal((N, k)).astype(np.float32), cuda)
    w = _t(rng.standard_normal((k, n)).astype(np.float32), cuda)
    got = table_gemm(x, w)
    ok, err = _gemm_close(got, torch.einsum('nk,km->nm', x, w), k)
    assert ok, err
    need = _cuda.gemm_work_floats(sms, (N, n, k))
    work = torch.empty(need, device=cuda)
    table = torch.empty((N, n), device=cuda)
    fn = _cuda.lib().cdll.dvc_dsa_table_gemm
    for floats, code in ((need, 0), (need - 1, 1)):
        assert fn(x.data_ptr(), w.data_ptr(), table.data_ptr(),
                  work.data_ptr(), N, k, n, floats, 0,
                  _cuda.stream_ptr(cuda)) == code
    torch.cuda.synchronize()


def test_gemm_outer_sum_at_a_long_term_axis_is_f32(cuda):
    """The outer sums' 128 x 128 tiles over 6,144 terms (four chunks), as
    K5's hs_prev^T dz at 512 x 2048: against torch.einsum within 1e-5 *
    sqrt(T) of the largest value, and in units of each output's products
    within GEMM_PRODUCT_TOL, which one-pass TF32 (torch.matmul with TF32
    allowed, same operands) exceeds."""
    rng = np.random.default_rng(6144)
    M, N, T = 512, 2048, 6144
    assert _plan(cuda, M, N, T)[:2] == (1, 4)
    x, y, xp, yp = _gemm_operands(cuda, rng, M, N, T, True, True)
    out = torch.empty((M, N), device=cuda)
    assert _gemm(x, True, y, True, M, N, T, out) == 0
    ok, err = _gemm_close(out, torch.einsum('tm,tn->mn', x, y), T)
    assert ok, err
    unit_err, tf32_err = (product_err(got, xp, yp)
                          for got in (out, tf32_matmul(xp, yp)))
    assert unit_err <= GEMM_PRODUCT_TOL < tf32_err, (unit_err, tf32_err)
