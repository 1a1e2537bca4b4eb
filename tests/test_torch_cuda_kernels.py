"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  A CUDA kernel has no CPU build, so without a CUDA device every
test here skips.  On a machine with one (JAX is not needed there, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_kernels.py -q

Tolerances: MSDA max abs error <= 1e-4 * max|out| (f32, same taps summed in
another order); greedy tokens equal and log-probs within 1e-3 wherever the
plain version's top-2 logit margin exceeded 1e-3 at that step and every
earlier one (past a near-tie the fed-back tokens may legitimately differ).
"""
import numpy as np
import pytest
import torch

from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan, dsa_greedy_scan_ref
from dvc_tpu_torch.ops.ms_deform_attn import ms_deform_attn, ms_deform_attn_ref

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
    with pytest.raises(RuntimeError):
        ms_deform_attn(value.requires_grad_(), (6,), loc, attn)
