"""Port parity of the bf16 caption kernels' plain versions (K4-bf16, K5-bf16,
K6-bf16 of ``dvc_tpu_torch``): ``dvc_tpu_torch.ops.dsa_bf16`` against the
JAX package's Pallas kernels in interpret mode at ``precision='bfloat16'``,
which round both operands of every in-kernel product to bf16 and accumulate
in f32 (``dvc_tpu/ops/dsa_step.py::_make_dot``).  The JAX jnp references
ignore ``precision``, so interpret mode is the reference here.

Tolerances: the same rounding points with f32 accumulation, so the plain
versions agree to f32 summation order: greedy tokens equal up to a query's
first step whose top-2 logit margin is under 1e-3 (a near-tie that another
order may flip), log-probs 1e-4 relative + 1e-5; scan hs and cs 1e-5; each
of the 13 gradients within 1e-4 of its largest magnitude (d alpha_b, zero
in exact arithmetic, within 1e-5 absolute).

The card kernels compute the table form (``table=True``), which does not
round the lerped taps before their product with Wc (see the header of
``csrc/dsa_scan.cu``).  Its gap to the product form is measured here: in
relative L2 it lies at a third to an eighth of the bf16-to-f32 distance of
the same outputs at these sizes (log-probs of the compared steps, hs, each
gradient), and the tests hold it below that distance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.dsa_greedy import dsa_greedy_scan as jax_greedy
from dvc_tpu.ops.dsa_scan import _scan_core, dsa_teacher_scan as jax_scan
from dvc_tpu_torch.ops import dsa_bf16
from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan, dsa_greedy_scan_ref
from dvc_tpu_torch.ops.dsa_scan import (NAMES, dsa_teacher_scan,
                                        dsa_teacher_scan_bwd,
                                        dsa_teacher_scan_bwd_ref,
                                        dsa_teacher_scan_fwd,
                                        dsa_teacher_scan_ref)
from test_torch_dsa_greedy import make_args as greedy_args
from test_torch_dsa_scan import make_args as scan_args

BF16 = 'bfloat16'
K = 5
MARGIN = 1e-3


def comparable(margin):
    """(B, K, Q) mask of the steps before a query's first near-tie."""
    return torch.cumprod((margin > MARGIN).int(), dim=1).bool()


def rel_l2(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize('H', [1, 2])
def test_plain_bf16_greedy_matches_jax_kernel(H):
    args, ts = greedy_args(H, seed=12)
    want_tok, want_lp = jax_greedy(*map(jnp.asarray, args), ts, K,
                                   impl='pallas_interpret', precision=BF16)
    targs = [to_torch(a) for a in args]
    tok, lp, margin = dsa_greedy_scan_ref(*targs, ts, K, with_margin=True,
                                          precision=BF16)
    ok = comparable(margin)
    assert float(ok.float().mean()) > 0.9
    np.testing.assert_array_equal(to_numpy(tok)[to_numpy(ok)],
                                  np.asarray(want_tok)[to_numpy(ok)])
    np.testing.assert_allclose(to_numpy(lp)[to_numpy(ok)],
                               np.asarray(want_lp)[to_numpy(ok)], rtol=1e-4,
                               atol=1e-5)
    # the wrapper sends CPU tensors to the plain bf16 version
    calls = dsa_greedy_scan_ref.calls
    launches = (dsa_greedy_scan.launches, dsa_greedy_scan.launches_bf16)
    tok2, lp2 = dsa_greedy_scan(*targs, ts, K, precision=BF16)
    assert dsa_greedy_scan_ref.calls == calls + 1
    assert (dsa_greedy_scan.launches,
            dsa_greedy_scan.launches_bf16) == launches
    assert torch.equal(tok2, tok) and torch.equal(lp2, lp)


@pytest.mark.parametrize('H', [1, 2])
def test_plain_bf16_scan_matches_jax_kernel(H):
    args, ts = scan_args(H=H, Q=5, K=4)
    jargs = [jnp.asarray(a) for a in args]
    targs = [to_torch(a) for a in args]
    hs, cs = dsa_teacher_scan_ref(*targs, ts, precision=BF16)
    want_hs = jax_scan(*jargs, ts, impl='pallas_interpret', precision=BF16)
    np.testing.assert_allclose(to_numpy(hs), np.asarray(want_hs), rtol=1e-5,
                               atol=1e-5)
    with pytest.raises(ValueError):
        dsa_teacher_scan_fwd(*targs, ts, precision=BF16)
    g = np.sin(3.0 * to_numpy(hs)).astype(np.float32)
    with pytest.raises(ValueError):
        dsa_teacher_scan_bwd(*targs, ts, hs, cs, to_torch(g), precision=BF16)
    got = dsa_teacher_scan_bwd_ref(*targs, ts, hs, cs, to_torch(g),
                                   precision=BF16)
    _, vjp = jax.vjp(lambda *a: _scan_core(*a, ts, True, BF16), *jargs)
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(NAMES, got, want):
        b = np.asarray(b)
        assert tuple(a.shape) == b.shape, name
        tol = 1e-5 if name == 'ab' else 1e-4 * np.abs(b).max()
        np.testing.assert_allclose(to_numpy(a), b, rtol=0, atol=tol,
                                   err_msg=name)


def test_wrapper_gradients_are_the_plain_bf16_backward():
    """Autograd through ``dsa_teacher_scan(precision='bfloat16')`` on CPU
    tensors hands every operand the TPU kernel's bf16 backward (not
    autograd through the forward's roundings)."""
    args, ts = scan_args(Q=5, K=3, seed=4)
    leaves = [to_torch(a).requires_grad_() for a in args]
    calls = dsa_teacher_scan_ref.calls
    hs = dsa_teacher_scan(*leaves, ts, precision=BF16)
    assert dsa_teacher_scan_ref.calls == calls + 1
    g = torch.cos(2.0 * hs.detach())
    (hs * g).sum().backward()
    plain = [to_torch(a) for a in args]
    want = dsa_bf16.scan_bwd(*plain, ts, *dsa_bf16.scan_fwd(*plain, ts), g)
    for name, leaf, w in zip(NAMES, leaves, want):
        torch.testing.assert_close(leaf.grad, w.reshape(leaf.shape),
                                   rtol=1e-6, atol=1e-7, msg=name)


@pytest.mark.parametrize('H', [1, 2])
@pytest.mark.parametrize('seed', [12, 13])
def test_table_form_greedy_gap(H, seed):
    """(f) The card kernel's table form of the bf16 greedy decode against
    the product form, on the steps before a near-tie in all three decodes:
    log-probs within the bf16-to-f32 distance (relative L2; measured at a
    quarter to a half of it)."""
    args, ts = greedy_args(H, seed=seed, B=4, Q=9)
    targs = [to_torch(a) for a in args]
    f_tok, f_lp = dsa_greedy_scan_ref(*targs, ts, 8)
    tok, lp, margin = dsa_greedy_scan_ref(*targs, ts, 8, with_margin=True,
                                          precision=BF16)
    t_tok, t_lp = dsa_bf16.greedy_scan(*targs, ts, 8, table=True)
    ok = comparable(margin) & torch.cumprod(
        ((f_tok == tok) & (t_tok == tok)).int(), dim=1).bool()
    assert float(ok.float().mean()) > 0.9
    gap, dist = rel_l2(t_lp[ok], lp[ok]), rel_l2(f_lp[ok], lp[ok])
    assert 0 < gap < 0.6 * dist, (gap, dist)


@pytest.mark.parametrize('H', [1, 2])
def test_table_form_scan_gap(H):
    """(f) The card kernels' table form of the bf16 scan and its backward
    against the product form on the same trajectory: hs and each gradient
    within the bf16-to-f32 distance (relative L2; measured at a third to
    an eighth of it, dWc the closest at about 0.8)."""
    args, ts = scan_args(H=H, B=3, Q=7, K=6, seed=1)
    targs = [to_torch(a) for a in args]
    f_hs, f_cs = dsa_teacher_scan_ref(*targs, ts)
    hs, cs = dsa_bf16.scan_fwd(*targs, ts)
    t_hs, _ = dsa_bf16.scan_fwd(*targs, ts, table=True)
    assert rel_l2(t_hs, hs) < 0.5 * rel_l2(f_hs, hs)
    g = torch.sin(3.0 * hs)
    want = dsa_bf16.scan_bwd(*targs, ts, hs, cs, g)
    table = dsa_bf16.scan_bwd(*targs, ts, hs, cs, g, table=True)
    f32 = dsa_teacher_scan_bwd_ref(*targs, ts, f_hs, f_cs, g)
    for name, t, w, f in zip(NAMES, table, want, f32):
        if name != 'ab':
            assert rel_l2(t, w) < rel_l2(f, w), name


def test_precision_is_checked():
    args, ts = scan_args(K=2)
    targs = [to_torch(a) for a in args]
    with pytest.raises(ValueError, match='precision'):
        dsa_teacher_scan(*targs, ts, precision='float16')
    gargs, gts = greedy_args(1, seed=1)
    with pytest.raises(ValueError, match='precision'):
        dsa_greedy_scan(*[to_torch(a) for a in gargs], gts, 2,
                        precision='bf16')
