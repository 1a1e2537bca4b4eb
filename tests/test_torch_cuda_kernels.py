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
the softmax's gradients sum to zero, so both sides hold only rounding).
"""
import numpy as np
import pytest
import torch

from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan, dsa_greedy_scan_ref
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
