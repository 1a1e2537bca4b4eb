"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  A CUDA kernel has no CPU build, so without a CUDA device every
test here skips.  On a machine with one (JAX is not needed there, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: MSDA max abs error <= 1e-4 * max|out| (f32, same taps summed in
another order), and the same for each of its gradients (dvalue is summed
with atomics in no fixed order); greedy tokens equal and log-probs within
1e-3 wherever the plain version's top-2 logit margin exceeded 1e-3 at that
step and every earlier one (past a near-tie the fed-back tokens may
legitimately differ); teacher-forcing scan hs and cs within 1e-4 * max|ref|
and each of its 13 gradients within 1e-3 * max|ref| + 1e-5 (K recurrent
steps of f32 sums in another order, atomics in dvalue, dWc and the bias
sums; the floor is for d alpha_b, which is zero in exact arithmetic since
the softmax's gradients sum to zero, so both sides hold only rounding);
the word-step kernels (K7-K10) to the same: outputs within 1e-4 * max|ref|,
gradients within 1e-3 * max|ref| + 1e-5; in these newer cases d alpha_b
has the floor 5e-5 (``_grad_close``), the rounding of a sum of every tap
row's term in no fixed order.
"""
import numpy as np
import pytest
import torch

from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan, dsa_greedy_scan_ref
from dvc_tpu_torch.ops.dsa_tables import table_gemm
from dvc_tpu_torch.ops.dsa_step import (LSTM_NAMES, STEP_NAMES,
                                        dsa_lstm_step_bwd, dsa_lstm_step_core,
                                        dsa_lstm_step_fwd,
                                        dsa_sample_attend_bwd,
                                        dsa_sample_attend_core,
                                        dsa_sample_attend_fwd, lstm_step_bwd_ref,
                                        lstm_step_ref, sample_attend_bwd_ref,
                                        sample_attend_ref)
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
    """K7 and K8 (ctx and its 7 gradients), and autograd through the
    wrapper; Q = 13 spans a full and a ragged query tile."""
    rng = np.random.default_rng(200 + 10 * H + Q)
    ts = (12, 6)
    args = step_args(cuda, rng, H=H, Q=Q, ts=ts)
    launches = (dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches)
    ctx = dsa_sample_attend_fwd(*args, ts)
    g = torch.sin(3.0 * ctx)
    grads = dsa_sample_attend_bwd(*args, ts, g)
    torch.cuda.synchronize()
    assert (dsa_sample_attend_fwd.launches, dsa_sample_attend_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1)
    assert _close(ctx, sample_attend_ref(*args, ts), 1e-4)[0]
    want = sample_attend_bwd_ref(*args, ts, g)
    for name, a, b in zip(STEP_NAMES, grads, want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    leaves = [t.clone().requires_grad_() for t in args]
    (dsa_sample_attend_core(*leaves, ts) * g).sum().backward()
    for name, a, b in zip(STEP_NAMES, leaves, want):
        assert _grad_close(name, a.grad, b)[0], name


@pytest.mark.parametrize('H,Q', [(1, 13), (2, 8), (8, 3)])
def test_lstm_step_kernels_match_plain(cuda, H, Q):
    """K9 and K10 ((h', c') and their 12 gradients for both cotangents),
    and autograd through the wrapper."""
    rng = np.random.default_rng(300 + 10 * H + Q)
    ts = (12, 6)
    args = step_args(cuda, rng, H=H, Q=Q, ts=ts, lstm=True)
    launches = (dsa_lstm_step_fwd.launches, dsa_lstm_step_bwd.launches)
    h_new, c_new = dsa_lstm_step_fwd(*args, ts)
    gh, gc = torch.sin(3.0 * h_new), torch.cos(2.0 * c_new)
    grads = dsa_lstm_step_bwd(*args, ts, gh, gc)
    torch.cuda.synchronize()
    assert (dsa_lstm_step_fwd.launches, dsa_lstm_step_bwd.launches) \
        == (launches[0] + 1, launches[1] + 1)
    ref_h, ref_c = lstm_step_ref(*args, ts)
    assert _close(h_new, ref_h, 1e-4)[0] and _close(c_new, ref_c, 1e-4)[0]
    want = lstm_step_bwd_ref(*args, ts, gh, gc)
    for name, a, b in zip(LSTM_NAMES, grads, want):
        assert a.shape == b.shape, name
        ok, err = _grad_close(name, a, b)
        assert ok, (name, err, float(b.abs().max()))
    leaves = [t.clone().requires_grad_() for t in args]
    h2, c2 = dsa_lstm_step_core(*leaves, ts)
    ((h2 * gh).sum() + (c2 * gc).sum()).backward()
    for name, a, b in zip(LSTM_NAMES, leaves, want):
        assert _grad_close(name, a.grad, b)[0], name


def test_step_kernels_at_the_recipe_width(cuda):
    """K7-K10 at R = A = 512, Dh = 512, S = 375, LP = 16 on a few queries."""
    rng = np.random.default_rng(400)
    ts = (200, 100, 50, 25)
    args = step_args(cuda, rng, B=1, H=1, Q=10, Dh=512, A=512, R=512, P=4,
                     ts=ts, lstm=True)
    h_new, c_new = dsa_lstm_step_fwd(*args, ts)
    ref_h, ref_c = lstm_step_ref(*args, ts)
    assert _close(h_new, ref_h, 1e-4)[0] and _close(c_new, ref_c, 1e-4)[0]
    gh, gc = torch.sin(3.0 * h_new), torch.cos(2.0 * c_new)
    want = lstm_step_bwd_ref(*args, ts, gh, gc)
    for name, a, b in zip(LSTM_NAMES, dsa_lstm_step_bwd(*args, ts, gh, gc),
                          want):
        assert _grad_close(name, a, b)[0], name
    step = args[:3] + args[8:]
    ctx = dsa_sample_attend_fwd(*step, ts)
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
    the trajectory hs, in float64), and the share of queries so dropped.
    There the tap pair, and so the gradient with respect to the position,
    jumps, and the kernel's and the plain version's sums of h . off_w may
    round to either side (ROADMAP C): at B=16, H=8 one tap 5e-7 below an
    integer moves its query's dbase by 0.3 and, through dh, every earlier
    step of that query.  A query with a zero cotangent adds exactly zero
    to every gradient on both sides."""
    base_pos, scale_t, off_w_h = args[1], args[2], args[4]
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1).double()
    off = torch.einsum('bkqr,hrp->bkhqp', h_prev, off_w_h.double())
    pos = base_pos.double()[:, None] + off * scale_t.double()[:, None, None]
    near = (pos - pos.round()).abs() <= 2e-6 + pos.abs() * 2.0 ** -23
    drop = near.any(dim=4).any(dim=2).any(dim=1)                    # (B, Q)
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
