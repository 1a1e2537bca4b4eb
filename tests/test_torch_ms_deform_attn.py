"""Port parity: trunk MSDA forward and backward of ``dvc_tpu_torch`` vs the
JAX package.

The plain PyTorch version (what the port's wrapper runs on CPU tensors) is
held against the JAX gather oracle and against the Pallas kernel run in
interpret mode, at tolerance 1e-5 (f32; the two sides sum the L*P taps in
the same order, so differences are a few ulps).  Its backward (autograd
through it, the plain version of the CUDA backward kernel) is held against
the three JAX backwards: the VJP of the gather oracle, the VJP of the dense
one-hot form (the TPU default, ``DVC_MSDA_BWD=dense``) and the analytic
Pallas backward ``_msda_bwd_kernel`` in interpret mode; tolerance 2e-5
(dvalue sums up to Q*L*P contributions per row in another order), also on
the encoder's locations, where the taps of many queries share a row.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import to_numpy, to_torch  # noqa: I100 (sets torch threads)

from dvc_tpu.ops.ms_deform_attn import _msda_pallas_bwd_impl
from dvc_tpu.ops.ms_deform_attn import ms_deform_attn as jax_msda
from dvc_tpu_torch.models.deformable_transformer import \
    encoder_reference_points
from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                              ms_deform_attn_bwd,
                                              ms_deform_attn_bwd_ref,
                                              ms_deform_attn_ref)

LEVEL_TABLES = [(8, 4, 2, 1), (12, 6, 3), (7,), (25, 13, 7, 4)]


def make_inputs(seed, shapes, B=2, Q=5, H=3, D=8, P=3):
    rng = np.random.default_rng(seed)
    S, L = sum(shapes), len(shapes)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    # locations straddle [0, 1] so out-of-range taps are exercised
    loc = rng.uniform(-0.3, 1.3, (B, Q, H, L, P)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, Q, H, L, P)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    return value, loc, attn


@pytest.mark.parametrize('impl', ['ref', 'pallas_interpret'])
@pytest.mark.parametrize('shapes', LEVEL_TABLES)
def test_plain_port_matches_jax_zeros_mode(shapes, impl):
    value, loc, attn = make_inputs(len(shapes), shapes)
    want = jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                    jnp.asarray(attn), mode='zeros', impl=impl)
    calls = ms_deform_attn_ref.calls
    launches = ms_deform_attn.launches
    got = ms_deform_attn(to_torch(value), shapes, to_torch(loc),
                         to_torch(attn))
    # CPU tensors go to the plain version, never to the kernel
    assert ms_deform_attn_ref.calls == calls + 1
    assert ms_deform_attn.launches == launches
    assert tuple(got.shape) == (2, 5, 3 * 8)
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_plain_port_matches_jax_at_exact_tap_boundaries():
    """Locations k/T and (k + 0.5)/T put pos = loc*T - 0.5 on a half or a
    whole integer, where floor() decides the tap; both edges of each level
    and one step past them are included."""
    shapes = (8, 4, 2)
    value, loc, attn = make_inputs(11, shapes)
    rng = np.random.default_rng(12)
    for l, T in enumerate(shapes):
        grid = np.arange(-1, T + 2, 0.5, dtype=np.float32) / np.float32(T)
        loc[:, :, :, l, :] = rng.choice(grid, loc[:, :, :, l, :].shape)
    want = jax_msda(jnp.asarray(value), shapes, jnp.asarray(loc),
                    jnp.asarray(attn), mode='zeros', impl='ref')
    got = ms_deform_attn(to_torch(value), shapes, to_torch(loc),
                         to_torch(attn))
    np.testing.assert_allclose(to_numpy(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_out_of_range_taps_contribute_zero():
    """Every location far outside [0, 1]: zeros mode gives exactly 0."""
    shapes = (8, 4)
    value, loc, attn = make_inputs(3, shapes)
    loc = np.where(loc > 0.5, 1.5, -0.5).astype(np.float32)
    got = ms_deform_attn(to_torch(value), shapes, to_torch(loc),
                         to_torch(attn))
    assert np.all(to_numpy(got) == 0.0)


def _jax_vjp(impl, value, shapes, loc, attn, g):
    _, vjp = jax.vjp(lambda v, l, a: jax_msda(v, shapes, l, a, mode='zeros',
                                              impl=impl),
                     jnp.asarray(value), jnp.asarray(loc), jnp.asarray(attn))
    return vjp(jnp.asarray(g))


@pytest.mark.parametrize('shapes', LEVEL_TABLES)
def test_plain_backward_matches_every_jax_backward(shapes):
    value, loc, attn = make_inputs(20 + len(shapes), shapes)
    g = np.random.default_rng(30).standard_normal((2, 5, 3 * 8)).astype(
        np.float32)
    calls = ms_deform_attn_ref.calls
    launches = ms_deform_attn_bwd.launches
    tensors = [to_torch(x) for x in (value, loc, attn, g)]
    # the backward kernel takes CUDA tensors only; the plain version is
    # autograd through the plain forward
    with pytest.raises(ValueError):
        ms_deform_attn_bwd(tensors[0], shapes, *tensors[1:])
    got = ms_deform_attn_bwd_ref(tensors[0], shapes, *tensors[1:])
    assert ms_deform_attn_ref.calls == calls + 1
    assert ms_deform_attn_bwd.launches == launches
    wants = {impl: _jax_vjp(impl, value, shapes, loc, attn, g)
             for impl in ('ref', 'dense')}
    wants['pallas_bwd'] = _msda_pallas_bwd_impl(
        jnp.asarray(value), shapes, jnp.asarray(loc), jnp.asarray(attn),
        'zeros', True, jnp.asarray(g))
    for impl, want in wants.items():
        for name, a, b in zip(('dvalue', 'dloc', 'dattn'), got, want):
            np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=2e-5,
                                       atol=2e-5, err_msg=f'{impl} {name}')


@pytest.mark.parametrize('shapes', [(25, 13, 7, 4), (12, 6, 3)])
def test_plain_backward_matches_jax_on_encoder_locations(shapes):
    """The encoder's self-attention: a query per position of the flattened
    pyramid (Q = S) samples near its reference point
    (``encoder_reference_points``) at offsets of up to 3 frames of each
    level, so the taps of neighbouring queries land on the same value rows,
    the pattern that the card's backward adds into its shared dvalue slice
    on the main path."""
    rng = np.random.default_rng(60 + len(shapes))
    B, H, D, P, L, S = 2, 3, 8, 3, len(shapes), sum(shapes)
    ref = to_numpy(encoder_reference_points(shapes, torch.ones((B, L))))
    off = rng.uniform(-3, 3, (B, S, H, L, P)).astype(np.float32)
    loc = (ref[:, :, None, :, None, 0]
           + off / np.asarray(shapes, np.float32)[:, None]).astype(np.float32)
    value = rng.standard_normal((B, S, H, D)).astype(np.float32)
    attn = rng.uniform(0, 1, (B, S, H, L, P)).astype(np.float32)
    attn /= attn.sum(axis=(3, 4), keepdims=True)
    g = rng.standard_normal((B, S, H * D)).astype(np.float32)
    # the premise: many taps on each row that any tap reaches
    pos = np.floor(loc * np.asarray(shapes, np.float32)[:, None] - 0.5)
    starts = np.cumsum((0,) + shapes[:-1])[:, None]
    rows = (pos + starts)[(pos >= 0) & (pos < np.asarray(shapes)[:, None])]
    assert rows.size >= 4 * np.unique(rows).size
    got = ms_deform_attn_bwd_ref(to_torch(value), shapes, to_torch(loc),
                                 to_torch(attn), to_torch(g))
    wants = {'ref': _jax_vjp('ref', value, shapes, loc, attn, g),
             'pallas_bwd': _msda_pallas_bwd_impl(
                 jnp.asarray(value), shapes, jnp.asarray(loc),
                 jnp.asarray(attn), 'zeros', True, jnp.asarray(g))}
    for impl, want in wants.items():
        for name, a, b in zip(('dvalue', 'dloc', 'dattn'), got, want):
            np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=2e-5,
                                       atol=2e-5, err_msg=f'{impl} {name}')


def test_wrapper_gradients_are_the_plain_backward():
    """Autograd through the wrapper on CPU tensors gives the same gradients
    as ``ms_deform_attn_bwd_ref``, out-of-range taps and padding included."""
    shapes = (8, 4, 2)
    value, loc, attn = make_inputs(40, shapes)
    g = to_torch(np.random.default_rng(41).standard_normal(
        (2, 5, 24)).astype(np.float32))
    leaves = [to_torch(x).requires_grad_() for x in (value, loc, attn)]
    (ms_deform_attn(leaves[0], shapes, leaves[1], leaves[2]) * g).sum() \
        .backward()
    want = ms_deform_attn_bwd_ref(to_torch(value), shapes, to_torch(loc),
                                  to_torch(attn), g)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=0)
