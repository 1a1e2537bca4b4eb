"""Port parity: one word step of the stepwise caption path (plain versions
of the CUDA kernels K7-K10) against the JAX package's
``dvc_tpu/ops/dsa_step.py``, whose Pallas kernels run in interpret mode.

* Forward: ``dsa_sample_attend_ref`` / ``dsa_lstm_step_ref`` (JAX
  signatures) against the jnp oracles and ``impl='pallas_interpret'``.
* Backward at the kernels' boundary: the port's plain backwards
  (``sample_attend_bwd_ref``, ``lstm_step_bwd_ref``, autograd through the
  plain step) against ``jax.vjp`` of the Pallas custom VJPs (``_dsa_core``,
  ``_dsa_lstm_core``, interpret mode): the functions of K8 and K10.
* Through the JAX signature: autograd of the port's plain
  ``dsa_sample_attend_ref`` / ``dsa_lstm_step_ref`` against ``jax.grad`` of
  the JAX ops in interpret mode, offsets and references included.
* The table form of K7 (``sample_attend_table_ref`` on
  ``dsa_value_table``, the caption head's CPU route) through the JAX
  signature against the JAX ``dsa_sample_attend`` in interpret mode (its
  gradients: ``tests/test_torch_dsa_tables.py``).

Tiny shapes as in ``tests/test_dsa_step.py`` (S = 18 over 2 levels, Q = 3,
H in {1, 2}, A = 16), sampling points drawn off tap boundaries.
Tolerances: forwards rtol/atol 1e-5 (f32, the same taps summed in another
order); gradients rtol 3e-4 / atol 3e-5, as the JAX package's own test
holds its kernel against its oracle (the location gradient picks up the
rounding of ``v[hi] - v[lo]`` products).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.dsa_step import _dsa_core, _dsa_lstm_core
from dvc_tpu.ops.dsa_step import dsa_lstm_step as jax_lstm_step
from dvc_tpu.ops.dsa_step import dsa_lstm_step_ref as jax_lstm_step_ref
from dvc_tpu.ops.dsa_step import dsa_sample_attend as jax_sample_attend
from dvc_tpu.ops.dsa_step import dsa_sample_attend_ref as jax_sample_ref
from dvc_tpu_torch.ops.dsa_step import (
    LSTM_NAMES, STEP_NAMES, dsa_lstm_step_bwd, dsa_lstm_step_core,
    dsa_lstm_step_fwd, dsa_lstm_step_ref, dsa_lstm_step_table_core,
    dsa_sample_attend_bwd, dsa_sample_attend_core, dsa_sample_attend_fwd,
    dsa_sample_attend_ref, dsa_sample_attend_table_core, level_pos,
    lstm_step_bwd_ref, lstm_step_ref, lstm_step_table_ref,
    sample_attend_bwd_ref, sample_attend_ref, sample_attend_table_ref)
from dvc_tpu_torch.ops.dsa_tables import dsa_value_table

TS = (12, 6)
FWD = dict(rtol=1e-5, atol=1e-5)
GRAD = dict(rtol=3e-4, atol=3e-5)


def off_boundary(offsets, ref, scale, ts, margin=1e-3):
    """Nudge each offset so that loc * T_l - 0.5 lies at least ``margin``
    from an integer (a tap boundary, where the location gradient jumps)."""
    T = np.asarray(ts, np.float64)[None, None, None, :, None]
    loc = ref[:, :, None, :, None] + offsets * scale[:, :, None, :, None]
    pos = loc * T - 0.5
    frac = pos - np.floor(pos)
    shift = np.where(frac < margin, margin, 0.0) \
        - np.where(frac > 1 - margin, margin, 0.0)
    return (offsets + shift / (T * scale[:, :, None, :, None])).astype(
        np.float32)


def make_inputs(seed=0, B=2, H=2, Dh=8, Q=3, P=3, A=16, R=None, ts=TS):
    """The JAX signature's operands (numpy); with R also z0, h, c, ctx_w,
    w_hh of the LSTM step."""
    rng = np.random.default_rng(seed)
    L = len(ts)
    value = rng.standard_normal((B, sum(ts), H, Dh)).astype(np.float32)
    ref = rng.uniform(0.1, 0.9, (B, Q, L)).astype(np.float32)
    scale = rng.uniform(0.02, 0.3, (B, Q, L)).astype(np.float32)
    offsets = off_boundary(rng.standard_normal((B, Q, H, L, P)) * 2,
                           ref, scale, ts)
    hvec = rng.standard_normal((B, Q, A)).astype(np.float32)
    cw = (rng.standard_normal((Dh, A)) * 0.3).astype(np.float32)
    cb = (rng.standard_normal(A) * 0.1).astype(np.float32)
    aw = (rng.standard_normal(A) * 0.3).astype(np.float32)
    ab = np.float32(0.07)
    step = (value, offsets, ref, scale, hvec)
    attn = (cw, cb, aw, ab)
    if R is None:
        return step + attn
    z0 = (rng.standard_normal((B, Q, 4 * R)) * 0.5).astype(np.float32)
    h = (rng.standard_normal((B, Q, R)) * 0.5).astype(np.float32)
    c = (rng.standard_normal((B, Q, R)) * 0.5).astype(np.float32)
    ctx_w = (rng.standard_normal((H * Dh, 4 * R)) * 0.2).astype(np.float32)
    w_hh = (rng.standard_normal((R, 4 * R)) * 0.2).astype(np.float32)
    return step + (z0, h, c, ctx_w, w_hh) + attn


def boundary(args, lstm=False):
    """The kernels' operands (value_t, pos, hvec, [z0, h, c, ctx_w3,
    w_hh,] cw, cb, aw, ab) of the JAX signature's, as numpy arrays."""
    value, offsets, ref, scale, hvec = args[:5]
    loc = ref[:, :, None, :, None] + offsets * scale[:, :, None, :, None]
    pos = to_numpy(level_pos(to_torch(loc), TS))
    out = (value.transpose(0, 2, 1, 3).copy(), pos, hvec)
    if lstm:
        z0, h, c, ctx_w, w_hh = args[5:10]
        H, Dh = value.shape[2], value.shape[3]
        out += (z0, h, c, ctx_w.reshape(H, Dh, -1), w_hh)
    return out + tuple(args[-4:])


@pytest.mark.parametrize('H', [1, 2])
def test_sample_attend_forward_matches_jax(H):
    args = make_inputs(H=H)
    want = np.asarray(jax_sample_ref(*map(jnp.asarray, args), TS))
    kernel = np.asarray(jax_sample_attend(*map(jnp.asarray, args), TS,
                                          impl='pallas_interpret'))
    got = to_numpy(dsa_sample_attend_ref(*map(to_torch, args), TS))
    np.testing.assert_allclose(got, want, **FWD)
    np.testing.assert_allclose(got, kernel, **FWD)
    # the wrapper sends CPU tensors to the plain version, never the kernel
    ops = [to_torch(a) for a in boundary(args)]
    calls, launches = sample_attend_ref.calls, dsa_sample_attend_fwd.launches
    wrapped = dsa_sample_attend_core(*ops, TS)
    assert sample_attend_ref.calls == calls + 1
    assert dsa_sample_attend_fwd.launches == launches
    np.testing.assert_array_equal(to_numpy(wrapped.permute(0, 2, 1, 3)), got)


@pytest.mark.parametrize('H', [1, 2])
def test_lstm_step_forward_matches_jax(H):
    args = make_inputs(seed=1, H=H, R=24)
    want = jax_lstm_step_ref(*map(jnp.asarray, args), TS)
    kernel = jax_lstm_step(*map(jnp.asarray, args), TS,
                           impl='pallas_interpret')
    got = dsa_lstm_step_ref(*map(to_torch, args), TS)
    launches = dsa_lstm_step_fwd.launches
    wrapped = dsa_lstm_step_core(*(to_torch(a) for a in
                                   boundary(args, lstm=True)), TS)
    assert dsa_lstm_step_fwd.launches == launches
    for g, w, k, x in zip(got, want, kernel, wrapped):
        np.testing.assert_allclose(to_numpy(g), np.asarray(w), **FWD)
        np.testing.assert_allclose(to_numpy(g), np.asarray(k), **FWD)
        np.testing.assert_array_equal(to_numpy(x), to_numpy(g))


@pytest.mark.parametrize('H', [1, 2])
def test_sample_attend_backward_matches_jax_kernel_vjp(H):
    """K8's function: the 7 gradients at the boundary."""
    ops = boundary(make_inputs(seed=2, H=H))
    B, Hh, Q, LP = ops[1].shape
    targs = [to_torch(a) for a in ops]
    ctx = sample_attend_ref(*targs, TS)
    g = np.sin(3.0 * to_numpy(ctx)).astype(np.float32)
    vw = dsa_value_table(targs[0], targs[3])
    with pytest.raises(ValueError):         # the kernel takes CUDA tensors
        dsa_sample_attend_bwd(targs[0], vw, *targs[1:3], *targs[4:], TS,
                              to_torch(g))
    got = sample_attend_bwd_ref(*targs, TS, to_torch(g))
    jops = [jnp.asarray(a) for a in ops]
    jops[1] = jops[1].reshape(B, Hh, Q * LP)
    _, vjp = jax.vjp(lambda *a: _dsa_core(*a, TS, Q, True, 'float32'), *jops)
    want = vjp(jnp.asarray(g))
    for name, a, b in zip(STEP_NAMES, got, want):
        np.testing.assert_allclose(to_numpy(a).reshape(np.shape(b)),
                                   np.asarray(b), **GRAD, err_msg=name)


@pytest.mark.parametrize('H', [1, 2])
def test_lstm_step_backward_matches_jax_kernel_vjp(H):
    """K10's function: the 12 gradients at the boundary for both
    cotangents."""
    ops = boundary(make_inputs(seed=3, H=H, R=24), lstm=True)
    B, Hh, Q, LP = ops[1].shape
    targs = [to_torch(a) for a in ops]
    h_new, c_new = lstm_step_ref(*targs, TS)
    gh = np.sin(3.0 * to_numpy(h_new)).astype(np.float32)
    gc = np.cos(2.0 * to_numpy(c_new)).astype(np.float32)
    vw = dsa_value_table(targs[0], targs[8])
    with pytest.raises(ValueError):         # the kernel takes CUDA tensors
        dsa_lstm_step_bwd(targs[0], vw, *targs[1:8], *targs[9:], TS,
                          to_torch(gh), to_torch(gc))
    got = lstm_step_bwd_ref(*targs, TS, to_torch(gh), to_torch(gc))
    jops = [jnp.asarray(a) for a in ops]
    jops[1] = jops[1].reshape(B, Hh, Q * LP)
    _, vjp = jax.vjp(lambda *a: _dsa_lstm_core(*a, TS, Q, True, 'float32'),
                     *jops)
    want = vjp((jnp.asarray(gh), jnp.asarray(gc)))
    for name, a, b in zip(LSTM_NAMES, got, want):
        np.testing.assert_allclose(to_numpy(a).reshape(np.shape(b)),
                                   np.asarray(b), **GRAD, err_msg=name)


@pytest.mark.parametrize('lstm', [False, True])
def test_gradients_through_the_jax_signature(lstm):
    """Autograd of the port's ops (offsets, references and scales
    included) against ``jax.grad`` of the JAX ops in interpret mode."""
    args = make_inputs(seed=4, R=16 if lstm else None)
    rng = np.random.default_rng(5)
    port_op, jax_op = ((dsa_lstm_step_ref, jax_lstm_step) if lstm
                       else (dsa_sample_attend_ref, jax_sample_attend))

    def weights(out):
        return [rng.standard_normal(np.shape(o)).astype(np.float32)
                for o in (out if lstm else (out,))]

    jargs = [jnp.asarray(a) for a in args]
    w = weights(jax_op(*jargs, TS, impl='ref'))

    def loss(*a):
        out = jax_op(*a, TS, impl='pallas_interpret')
        return sum(jnp.sum(o * wi) for o, wi in
                   zip(out if lstm else (out,), w))

    want = jax.grad(loss, argnums=tuple(range(len(args))))(*jargs)
    leaves = [to_torch(a).requires_grad_() for a in args]
    out = port_op(*leaves, TS)
    sum((o * to_torch(wi)).sum() for o, wi in
        zip(out if lstm else (out,), w)).backward()
    for i, (leaf, b) in enumerate(zip(leaves, want)):
        np.testing.assert_allclose(to_numpy(leaf.grad), np.asarray(b),
                                   **GRAD, err_msg=f'argument {i}')


def test_border_taps_out_of_range():
    """Locations far out of range clamp to the level's edge rows (border
    mode) and give a zero location gradient, as in the JAX op."""
    args = list(make_inputs(seed=6))
    args[1] = args[1] + 50.0
    want = jax_sample_ref(*map(jnp.asarray, args), TS)
    offsets = to_torch(args[1]).requires_grad_()
    leaves = [to_torch(a) for a in args]
    leaves[1] = offsets
    got = dsa_sample_attend_ref(*leaves, TS)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), **FWD)
    (got ** 2).sum().backward()
    np.testing.assert_array_equal(to_numpy(offsets.grad), 0.0)


def test_core_wrappers_are_the_plain_versions_on_the_cpu():
    """dsa_*_core on CPU tensors run the plain versions (autograd through
    them), so the caption head's stepwise path is the plain step there; the
    table form's wrappers run the plain table-form steps, never K7 or
    K9."""
    ops = [to_torch(a) for a in boundary(make_inputs(seed=7, R=8),
                                         lstm=True)]
    step = ops[:3] + ops[8:]
    calls = (sample_attend_ref.calls, lstm_step_ref.calls,
             lstm_step_table_ref.calls, sample_attend_table_ref.calls,
             dsa_lstm_step_fwd.launches, dsa_sample_attend_fwd.launches)
    np.testing.assert_array_equal(
        to_numpy(dsa_sample_attend_core(*step, TS)),
        to_numpy(sample_attend_ref(*step, TS)))
    for a, b in zip(dsa_lstm_step_core(*ops, TS), lstm_step_ref(*ops, TS)):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    vw = dsa_value_table(ops[0], ops[8])
    table_ops = [ops[0], vw] + ops[1:8] + ops[9:]
    for a, b in zip(dsa_lstm_step_table_core(*table_ops, TS),
                    lstm_step_table_ref(*table_ops, TS)):
        np.testing.assert_array_equal(to_numpy(a), to_numpy(b))
    step_table = [ops[0], vw] + ops[1:3] + ops[9:]
    np.testing.assert_array_equal(
        to_numpy(dsa_sample_attend_table_core(*step_table, TS)),
        to_numpy(sample_attend_table_ref(*step_table, TS)))
    assert (sample_attend_ref.calls, lstm_step_ref.calls,
            lstm_step_table_ref.calls, sample_attend_table_ref.calls,
            dsa_lstm_step_fwd.launches, dsa_sample_attend_fwd.launches) == \
        (calls[0] + 2, calls[1] + 2, calls[2] + 2, calls[3] + 2, calls[4],
         calls[5])


@pytest.mark.parametrize('H', [1, 2])
def test_sample_attend_table_form_matches_jax_kernel(H):
    """K7's function in the table form, as the caption head runs it on the
    CPU: ``sample_attend_table_ref`` on VW = value . Wc from
    ``dsa_value_table``, its operands from the JAX signature's (offsets,
    references, scales), against the JAX ``dsa_sample_attend`` with its
    Pallas kernel in interpret mode.  The table form sums a tap's scores in
    another order (a lerp of Wc products, not a product of lerps), so the
    tolerance is FWD."""
    args = make_inputs(seed=8, H=H)
    kernel = np.asarray(jax_sample_attend(*map(jnp.asarray, args), TS,
                                          impl='pallas_interpret'))
    value_t, pos, hvec, cw, cb, aw, ab = map(to_torch, boundary(args))
    calls = sample_attend_table_ref.calls
    ctx = sample_attend_table_ref(value_t, dsa_value_table(value_t, cw), pos,
                                  hvec, cb, aw, ab, TS)
    assert sample_attend_table_ref.calls == calls + 1
    np.testing.assert_allclose(to_numpy(ctx.permute(0, 2, 1, 3)), kernel,
                               **FWD)
