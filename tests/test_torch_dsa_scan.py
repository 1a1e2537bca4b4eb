"""Port parity: the teacher-forcing word scan of ``dvc_tpu_torch`` (plain
version of the CUDA kernels K4/K5) vs the JAX package's
``dvc_tpu/ops/dsa_scan.py``, whose Pallas kernels run in interpret mode.

Forward hs against ``dsa_teacher_scan(impl='pallas_interpret')`` and the
jnp oracle; the 13 gradients (the port's plain backward
``dsa_teacher_scan_bwd_ref``, autograd through the plain scan) against
``jax.vjp`` of the Pallas custom VJP (``_scan_core``, interpret mode).
Tolerance rtol/atol 2e-5 forward and 5e-5 for the gradients (f32, K
recurrent steps summed in another order); the shapes include Q = 5, which
the JAX kernel pads to 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.dsa_scan import _scan_core, dsa_teacher_scan as jax_scan
from dvc_tpu.ops.dsa_scan import dsa_teacher_scan_ref as jax_scan_ref
from dvc_tpu_torch.ops.dsa_scan import (NAMES, dsa_teacher_scan,
                                        dsa_teacher_scan_bwd,
                                        dsa_teacher_scan_bwd_ref,
                                        dsa_teacher_scan_fwd,
                                        dsa_teacher_scan_ref)


def make_args(B=2, H=2, Dh=8, Q=3, L=2, P=2, A=16, R=8, K=4, seed=0):
    """tests/test_dsa_scan.py::make_args, with its level table."""
    ts = (12, 6, 3)[:L]
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    LP = L * P
    args = (f(B, H, sum(ts), Dh),
            rng.uniform(-0.5, max(ts) - 0.5, (B, H, Q, LP)).astype(np.float32),
            rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32),
            f(B, K, Q, 4 * R, scale=0.3), f(H, R, LP, scale=0.2),
            f(R, A, scale=0.3), f(A, scale=0.1), f(Dh, A, scale=0.3),
            f(A, scale=0.1), f(A, scale=0.3), np.float32(0.05),
            f(H, Dh, 4 * R, scale=0.2), f(R, 4 * R, scale=0.2))
    return args, ts


SHAPES = [dict(), dict(Q=5), dict(B=1, K=1), dict(L=3, P=2), dict(H=1, Q=9)]


@pytest.mark.parametrize('shapes', SHAPES)
def test_plain_scan_matches_jax_kernel(shapes):
    args, ts = make_args(**shapes)
    targs = [to_torch(a) for a in args]
    calls, launches = dsa_teacher_scan_ref.calls, dsa_teacher_scan_fwd.launches
    # the wrapper sends CPU tensors to the plain version, never to the
    # kernel, which takes CUDA tensors only
    wrapped = dsa_teacher_scan(*targs, ts)
    with pytest.raises(ValueError):
        dsa_teacher_scan_fwd(*targs, ts)
    hs, cs = dsa_teacher_scan_ref(*targs, ts)
    assert dsa_teacher_scan_ref.calls == calls + 2
    assert dsa_teacher_scan_fwd.launches == launches
    torch.testing.assert_close(wrapped, hs, rtol=0, atol=0)
    jargs = [jnp.asarray(a) for a in args]
    want_hs = jax_scan(*jargs, ts, impl='pallas_interpret')
    ref_hs, ref_cs = jax_scan_ref(*jargs, ts)
    np.testing.assert_allclose(to_numpy(hs), np.asarray(want_hs), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(to_numpy(hs), np.asarray(ref_hs), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(to_numpy(cs), np.asarray(ref_cs), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize('shapes', [dict(K=3), dict(Q=5, K=2),
                                    dict(L=3, P=2, K=3)])
def test_plain_backward_matches_jax_kernel_vjp(shapes):
    args, ts = make_args(**shapes)
    targs = [to_torch(a) for a in args]
    hs, cs = dsa_teacher_scan_ref(*targs, ts)
    g = np.sin(3.0 * to_numpy(hs)).astype(np.float32)
    launches = dsa_teacher_scan_bwd.launches
    with pytest.raises(ValueError):
        dsa_teacher_scan_bwd(*targs, ts, hs, cs, to_torch(g))
    got = dsa_teacher_scan_bwd_ref(*targs, ts, hs, cs, to_torch(g))
    assert dsa_teacher_scan_bwd.launches == launches
    _, vjp = jax.vjp(lambda *a: _scan_core(*a, ts, True, 'float32'),
                     *(jnp.asarray(a) for a in args))
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(NAMES, got, want):
        assert tuple(a.shape) == np.shape(b), name
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=5e-5,
                                   atol=5e-5, err_msg=name)


def test_wrapper_gradients_are_the_plain_backward():
    """Autograd through ``dsa_teacher_scan`` on CPU tensors hands every
    operand the gradient of ``dsa_teacher_scan_bwd_ref``."""
    args, ts = make_args(Q=5, K=3, seed=4)
    leaves = [to_torch(a).requires_grad_() for a in args]
    hs = dsa_teacher_scan(*leaves, ts)
    g = torch.cos(2.0 * hs.detach())
    (hs * g).sum().backward()
    plain = [to_torch(a) for a in args]
    want = dsa_teacher_scan_bwd_ref(*plain, ts,
                                    *dsa_teacher_scan_ref(*plain, ts), g)
    for name, leaf, w in zip(NAMES, leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=1e-6, atol=1e-7,
                                   msg=name)


@pytest.mark.parametrize('shapes', [dict(K=3), dict(Q=5, K=2, seed=2)])
def test_plain_backward_on_a_given_trajectory(shapes):
    """chip_smoke's ``plain_scan_bwd_on`` (the plain backward with every
    step's state taken from a given trajectory, to which chip_smoke holds
    the scan backward kernel): on the plain forward's own trajectory it is
    ``dsa_teacher_scan_bwd_ref``; on another, its d z_all at the last step
    is autograd through that step alone from the given state."""
    import chip_smoke
    from dvc_tpu_torch.ops.dsa_greedy import (_level_bounds, attend_step,
                                              lstm_cell)
    args, ts = make_args(**shapes)
    targs = [to_torch(a) for a in args]
    hs, cs = dsa_teacher_scan_ref(*targs, ts)
    rng = np.random.default_rng(7)
    g = to_torch(rng.standard_normal(tuple(hs.shape)).astype(np.float32))
    want = dsa_teacher_scan_bwd_ref(*targs, ts, hs, cs, g)
    got = chip_smoke.plain_scan_bwd_on(*targs, ts, hs, cs, g)
    for name, a, b in zip(NAMES, got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=name)

    def moved(x):
        return x + to_torch(0.05 * rng.standard_normal(tuple(x.shape))
                            .astype(np.float32))

    hs2, cs2 = moved(hs), moved(cs)
    got = chip_smoke.plain_scan_bwd_on(*targs, ts, hs2, cs2, g)
    (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b, cw, cb,
     aw, ab, ctx_w3, w_hh) = targs
    K = hs.shape[1]
    z_in = z_all[:, K - 1].clone().requires_grad_()
    hib, s0 = _level_bounds(ts, scale_t.shape[-1] // len(ts), 'cpu')
    h, c = hs2[:, K - 2], cs2[:, K - 2]
    ctx = attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w,
                      h2att_b, cw, cb, aw, ab, hib, s0)
    h, _ = lstm_cell(z_in + h @ w_hh
                     + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3), c)
    dz, = torch.autograd.grad(h, z_in, g[:, K - 1])
    torch.testing.assert_close(got[3][:, K - 1], dz, rtol=1e-6, atol=1e-7)
    assert not torch.allclose(got[3][:, K - 1], want[3][:, K - 1])
