"""Port parity: fused greedy decode of ``dvc_tpu_torch`` vs the JAX package.

The plain PyTorch loop (what the port's wrapper runs on CPU tensors) is held
against the JAX oracle ``dsa_greedy_scan_ref`` and the Pallas kernel in
interpret mode.  Tokens must match exactly; the seeds are checked to give
no near-tie (top-2 logit margin) that a different f32 summation order could
flip.  Log-probabilities within 1e-5 (f32, K = 5 recurrent steps).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.dsa_greedy import dsa_greedy_scan as jax_greedy
from dvc_tpu.ops.dsa_greedy import greedy_mask_outputs as jax_mask
from dvc_tpu_torch.ops.dsa_greedy import (dsa_greedy_scan,
                                          dsa_greedy_scan_ref,
                                          greedy_mask_outputs)

K = 5


def make_args(H, seed, B=2, Dh=8, Q=5, A=16, R=8, V=130, E=12, P=2):
    """Q = 5 is not a multiple of 8 and V+1 = 131 not one of 128 (the JAX
    kernel pads both); two levels of lengths 12 and 6."""
    ts = (12, 6)
    S, LP = sum(ts), len(ts) * P
    rng = np.random.default_rng(seed)

    def f(*s, scale=1.0):
        return (rng.standard_normal(s) * scale).astype(np.float32)

    args = (f(B, H, S, Dh),
            rng.uniform(-0.5, max(ts) - 0.5, (B, H, Q, LP)).astype(np.float32),
            rng.uniform(0.2, 2.0, (B, Q, LP)).astype(np.float32),
            f(B, Q, 4 * R, scale=0.3), f(V + 1, E, scale=0.3),
            f(E, 4 * R, scale=0.3), f(R, V + 1, scale=0.5),
            f(V + 1, scale=0.1), f(H, R, LP, scale=0.2), f(R, A, scale=0.3),
            f(A, scale=0.1), f(Dh, A, scale=0.3), f(A, scale=0.1),
            f(A, scale=0.3), np.float32(0.05), f(H, Dh, 4 * R, scale=0.2),
            f(R, 4 * R, scale=0.2))
    return args, ts


@pytest.mark.parametrize('impl', ['ref', 'pallas_interpret'])
@pytest.mark.parametrize('H', [1, 2])
def test_plain_port_matches_jax(H, impl):
    args, ts = make_args(H, seed=10 + H)
    want_tok, want_lp = jax_greedy(*map(jnp.asarray, args), ts, K, impl=impl)
    targs = [to_torch(a) for a in args]
    tok, lp, margin = dsa_greedy_scan_ref(*targs, ts, K, with_margin=True)
    # no near-ties: a different f32 summation order cannot flip a token
    assert float(margin.min()) > 1e-3
    np.testing.assert_array_equal(to_numpy(tok), np.asarray(want_tok))
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)
    # the wrapper takes the plain version for CPU tensors
    calls, launches = dsa_greedy_scan_ref.calls, dsa_greedy_scan.launches
    tok2, lp2 = dsa_greedy_scan(*targs, ts, K)
    assert dsa_greedy_scan_ref.calls == calls + 1
    assert dsa_greedy_scan.launches == launches
    assert tok2.dtype == tok.dtype and np.array_equal(to_numpy(tok2),
                                                      to_numpy(tok))


def test_mask_outputs_matches_jax():
    rng = np.random.default_rng(1)
    tok = rng.integers(0, 4, (2, 6, 3)).astype(np.int32)
    lp = rng.standard_normal((2, 6, 3)).astype(np.float32)
    want_seq, want_lp = jax_mask(jnp.asarray(tok), jnp.asarray(lp))
    seq, lps = greedy_mask_outputs(to_torch(tok), to_torch(lp))
    np.testing.assert_array_equal(to_numpy(seq), np.asarray(want_seq))
    np.testing.assert_array_equal(to_numpy(lps), np.asarray(want_lp))
