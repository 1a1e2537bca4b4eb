"""K5-bf16's gate products on the tensor cores, on the CPU: the packed bf16
gate weights that the wrapper makes once a launch
(``dvc_tpu_torch.ops.dsa_scan.pack_gate_weights``), a plain mirror of the
kernel's fragment-order products (``gate_products_tiles``: each 16 x 8
tile from the packed A fragments as the kernel addresses them), and the
bf16 operand helpers that the wrappers call (``dsa_bf16.bf16_operand``,
``shifted_bf16``).  The kernel itself runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``).

Tolerances: the packing is exact (bit for bit against bf16(W)); the
mirror's products sum bf16 x bf16 products (exact in f32) in f32 in
another order than JAX's ``_make_dot('bfloat16')`` and ``dsa_bf16``'s
gate terms, so they agree within 1e-5 of each output's products'
root-sum-square (``product_units``; f32 summation over at most 1,024
terms errs by a few 1e-7 of it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401,I100 (sets torch threads)

from dvc_tpu.ops.dsa_step import _make_dot
from dvc_tpu_torch.ops import dsa_bf16
from dvc_tpu_torch.ops.dsa_scan import (gate_geometry, gate_index,
                                        gate_products_tiles,
                                        pack_gate_weights,
                                        unpack_gate_weights)

# (R, H, Dh): the flagship's widths cut down, odd tile edges (R not a
# multiple of 32, R + H*Dh not one of 64), one and several heads
SHAPES = [(32, 1, 32), (40, 2, 12), (16, 4, 4), (64, 8, 8)]


def weights(R, H, Dh, seed):
    rng = np.random.default_rng(seed)
    w_hh = rng.standard_normal((R, 4 * R)).astype(np.float32)
    ctx_w3 = rng.standard_normal((H, Dh, 4 * R)).astype(np.float32)
    return torch.from_numpy(w_hh), torch.from_numpy(ctx_w3)


def natural(R):
    """The natural gate column (gate * R + unit) of each packed column of
    P, and which of them hold a unit (the rest is padding)."""
    Rp, _ = gate_geometry(R, 0)
    rho = torch.arange(4 * Rp)
    unit = rho // 32 * 8 + rho % 8
    return (rho % 32) // 8 * R + unit, unit < R


def bits(x):
    return x.view(torch.int16)


@pytest.mark.parametrize('R,H,Dh', SHAPES)
def test_packed_gate_weights_unpack_to_bf16_weights(R, H, Dh):
    """Unpacking the recompute's P^T and the backprop's P gives bf16 of
    [W_hh; ctx_w3] with its columns in unit-block order, bit for bit, and
    zeros where the units or the terms are padded."""
    w_hh, ctx_w3 = weights(R, H, Dh, seed=R + H)
    HD = H * Dh
    Rp, KKp = gate_geometry(R, HD)
    assert Rp % 32 == 0 and KKp % 64 == 0 and Rp >= R and KKp >= R + HD
    packed = pack_gate_weights(w_hh, ctx_w3)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == 2 * 4 * Rp * KKp
    PT, P = unpack_gate_weights(packed, R, HD)
    assert torch.equal(bits(PT), bits(P.T.contiguous()))
    col, unit = natural(R)
    W = torch.cat([w_hh, ctx_w3.reshape(HD, 4 * R)]).to(torch.bfloat16)
    KK = R + HD
    assert torch.equal(bits(P[:KK][:, unit]), bits(W[:, col[unit]]))
    assert not P[KK:].float().any() and not P[:, ~unit].float().any()
    # each natural gate column appears exactly once
    assert sorted(col[unit].tolist()) == list(range(4 * R))


def test_gate_index_is_made_once_per_shape():
    """One index per (R, H*Dh, device); it points past the weights (at the
    appended zero) only where the shape is padded."""
    a = gate_index(32, 32, torch.device('cpu'))
    assert gate_index(32, 32, torch.device('cpu')) is a
    assert a.dtype == torch.int64 and int(a.max()) == 64 * 4 * 32 - 1
    assert int(gate_index(40, 24, torch.device('cpu')).max()) == 64 * 4 * 40


def test_fragment_order_puts_a_units_four_gates_in_one_lane():
    """In the recompute's packing m-tiles 2ub and 2ub + 1 hold unit block
    ub's gates (i, f) and (g, o): lane l's rows l/4 and l/4 + 8 of the two
    tiles are the four gates of unit ub*8 + l/4, so the mma accumulators
    of a lane (rows g and g + 8, queries 2q, 2q + 1) hold all four."""
    R, HD = 32, 32
    Rp, KKp = gate_geometry(R, HD)
    idx = gate_index(R, HD, torch.device('cpu'))
    frags = idx[:4 * Rp * KKp].reshape(4 * Rp // 16, KKp // 16, 32, 8)
    for ub in range(Rp // 8):
        for lane in range(32):
            g = lane // 4
            unit = ub * 8 + g
            if unit >= R:
                continue
            # a0's first element: (row g, term 2q); a1's: (row g + 8, term 2q)
            term = 2 * (lane % 4)
            got = [int(frags[2 * ub + t, 0, lane, e])
                   for t in (0, 1) for e in (0, 2)]
            want = [term * 4 * R + gate * R + unit for gate in range(4)]
            assert got == want, (ub, lane, got, want)


def product_units(got, a, b):
    """Largest error of got = a @ b in units of each output's products'
    root-sum-square (float64 reference)."""
    a, b = a.double(), b.double()
    rss = ((a * a) @ (b * b)).sqrt().clamp_min(1e-30)
    return float(((got.double() - a @ b).abs() / rss).max())


def differ_units(got, want, a, b):
    """Largest |got - want| in units of the products of a @ b."""
    a, b = a.double(), b.double()
    rss = ((a * a) @ (b * b)).sqrt().clamp_min(1e-30)
    return float(((got.double() - want.double()).abs() / rss).max())


@pytest.mark.parametrize('QT', [2, 4, 8])
@pytest.mark.parametrize('R,H,Dh', SHAPES)
def test_fragment_mirror_matches_jax_bf16_products(R, H, Dh, QT):
    """The mirror's z = [h | ctx] P and [dh | dctx] = dz P^T, tile by tile
    from the packed fragments, against JAX's ``_make_dot('bfloat16')``
    (bf16 operands, f32 accumulation) of the same operands, and against
    ``dsa_bf16``'s gate terms (``_gates``; dh = bf16(dz) . W_hh^T, dctx =
    bf16(dz) . ctx_w3^T as in ``dsa_bf16.scan_bwd``): each within 1e-5 of
    the float64 product in units of the products, and within 2e-5 of each
    other."""
    rng = np.random.default_rng(100 * R + QT)
    w_hh, ctx_w3 = weights(R, H, Dh, seed=R * H + QT)
    HD = H * Dh
    h = torch.from_numpy(rng.standard_normal((QT, R)).astype(np.float32))
    ctx = torch.from_numpy(rng.standard_normal((QT, HD)).astype(np.float32))
    dz = torch.from_numpy(rng.standard_normal((QT, 4 * R)).astype(np.float32))
    x = torch.cat([h, ctx], 1)
    z, dx = gate_products_tiles(pack_gate_weights(w_hh, ctx_w3), x, dz, R, HD)
    W = torch.cat([w_hh, ctx_w3.reshape(HD, 4 * R)])
    Wb = W.to(torch.bfloat16).float()
    xb, dzb = dsa_bf16.bf16(x), dsa_bf16.bf16(dz)
    assert product_units(z, xb, Wb) <= 1e-5
    assert product_units(dx, dzb, Wb.T) <= 1e-5
    # JAX's bf16 products, h . W_hh + ctx . ctx_w3 and their transposes
    dot = _make_dot('bfloat16')
    w3 = ctx_w3.reshape(HD, 4 * R).numpy()
    jz = torch.from_numpy(np.asarray(dot(jnp.asarray(h.numpy()),
                                         jnp.asarray(w_hh.numpy())))
                          + np.asarray(dot(jnp.asarray(ctx.numpy()),
                                           jnp.asarray(w3))))
    jdx = torch.from_numpy(np.concatenate(
        [np.asarray(dot(jnp.asarray(dz.numpy()), jnp.asarray(w_hh.numpy().T))),
         np.asarray(dot(jnp.asarray(dz.numpy()), jnp.asarray(w3.T)))], 1))
    assert product_units(jz, xb, Wb) <= 1e-5
    assert product_units(jdx, dzb, Wb.T) <= 1e-5
    assert differ_units(z, jz, xb, Wb) <= 2e-5
    assert differ_units(dx, jdx, dzb, Wb.T) <= 2e-5
    # dsa_bf16's gate terms (the plain K5-bf16 backward's)
    o = {'w_hh': dsa_bf16.bf16(w_hh), 'ctx_w3': dsa_bf16.bf16(ctx_w3)}
    st = {'hb': dsa_bf16.bf16(h)[None],
          'ctx': ctx.reshape(QT, H, Dh).permute(1, 0, 2)[None]}
    plain_z = dsa_bf16._gates(torch.zeros((1, QT, 4 * R)), st, o)[0]
    plain_dx = torch.cat([dzb @ o['w_hh'].T,
                          torch.einsum('qr,hdr->qhd', dzb, o['ctx_w3'])
                          .reshape(QT, HD)], 1)
    assert differ_units(z, plain_z, xb, Wb) <= 2e-5
    assert differ_units(dx, plain_dx, dzb, Wb.T) <= 2e-5


def test_bf16_operand_is_contiguous_aligned_bf16():
    """The wrappers' bf16 operands (value_t, cw): torch.bfloat16, the
    values rounded to nearest even, contiguous, 16-byte aligned, also from
    a transposed view and from an unaligned one."""
    x = torch.randn(7, 33)
    xb = x.to(torch.bfloat16)
    shifted = xb.reshape(-1)[1:]                    # 2 bytes past alignment
    assert shifted.data_ptr() % 16 == 2
    for src in (x, x.T, x[:, 1:], xb, shifted):
        y = dsa_bf16.bf16_operand(src)
        assert y.dtype == torch.bfloat16 and y.is_contiguous()
        assert y.data_ptr() % 16 == 0
        assert torch.equal(y.float(), dsa_bf16.bf16(src))
    assert dsa_bf16.bf16_operand(xb) is xb          # already one: no copy


def test_shifted_bf16_is_h_one_step_later():
    """K5-bf16's h_{k-1} (B, K, Q, R): zeros at step 0, then hs rounded to
    bf16, contiguous and 16-byte aligned."""
    hs = torch.randn(2, 5, 3, 8)
    got = dsa_bf16.shifted_bf16(hs)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    assert got.data_ptr() % 16 == 0
    assert not got[:, 0].float().any()
    assert torch.equal(got[:, 1:].float(), dsa_bf16.bf16(hs[:, :-1]))
