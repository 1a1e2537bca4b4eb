"""K4-bf16's and K6-bf16's products on the tensor cores, on the CPU: the
packed bf16 weights that the wrappers make once a launch (the gate
weights' P^T half, ``dvc_tpu_torch.ops.dsa_scan.pack_gate_weights``; the
products h . W of the hidden state, K6-bf16's vocab projection logit_w and
hvec's h2att_w, ``pack_hidden_weights``), plain mirrors of the kernels'
fragment-order products (``gate_products_tiles`` at one and two n8 tiles,
``hidden_products_tiles``) and of K6-bf16's online choice of a token
(``logits_pick_tiles``: the per-lane (max, sum-exp, first-max index), the
lanes, the warps), and the scan's one packing a forward and backward.  The
kernels themselves run only on the card (``tests/test_torch_cuda_kernels.py``,
marker ``cuda``; ``chip_smoke.py`` phase 16).

Tolerances: the packings are exact (bit for bit against bf16(W)); the
mirrors' products sum bf16 x bf16 products (exact in f32) in f32 in
another order than JAX's ``_make_dot('bfloat16')``, so they agree within
1e-5 of each output's products' root-sum-square (``product_units``; f32
summation over at most 1,024 terms errs by a few 1e-7 of it), and within
2e-5 of each other.  The choice of a token is exact (the first maximum);
its log-probability lp = max - (max + log(sum-exp)) within 4 f32 ulps of
the largest |max| (``lp_tol``: the sum rounds at the max's scale, and its
exps are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401,I100 (sets torch threads)

from dvc_tpu.ops.dsa_step import _make_dot
from dvc_tpu_torch.ops import dsa_bf16, dsa_scan
from dvc_tpu_torch.ops.dsa_greedy import greedy_pick
from dvc_tpu_torch.ops.dsa_scan import (gate_geometry, gate_products_tiles,
                                        hidden_geometry, hidden_index,
                                        hidden_products_tiles,
                                        logits_pick_tiles, pack_gate_weights,
                                        pack_hidden_weights,
                                        unpack_hidden_weights)

# (R, H, Dh) as tests/test_torch_bf16_gates.py: odd tile edges, one and
# several heads
SHAPES = [(32, 1, 32), (40, 2, 12), (16, 4, 4), (64, 8, 8)]
# (R, V1): the vocab never a multiple of 16, R one of 64 or not
LOGIT_SHAPES = [(32, 45), (64, 83), (40, 17)]
# (R, N) of the products h . W: the vocab's, and hvec's (N = A)
HIDDEN_SHAPES = LOGIT_SHAPES + [(64, 32), (40, 48)]
QTS = [2, 4, 8, 16]


def rnd(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def bits(x):
    return x.view(torch.int16)


def jdot(a, b):
    """JAX's bf16 product (bf16 operands, f32 accumulation) of torch
    tensors."""
    dot = _make_dot('bfloat16')
    return torch.from_numpy(np.array(dot(jnp.asarray(a.numpy()),
                                         jnp.asarray(b.numpy()))))


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


@pytest.mark.parametrize('R,H,Dh', SHAPES)
def test_forward_pack_is_the_recompute_half(R, H, Dh):
    """K6-bf16's gate pack (``backprop=False``) is the first 4Rp x KKp
    elements of K5-bf16's, bit for bit: the fragments of P^T, which K4-bf16
    also reads from the full pack."""
    rng = np.random.default_rng(R + H)
    w_hh, ctx_w3 = rnd(rng, R, 4 * R), rnd(rng, H, Dh, 4 * R)
    Rp, KKp = gate_geometry(R, H * Dh)
    half = pack_gate_weights(w_hh, ctx_w3, backprop=False)
    full = pack_gate_weights(w_hh, ctx_w3)
    assert half.numel() == 4 * Rp * KKp and full.numel() == 2 * half.numel()
    assert torch.equal(bits(half), bits(full[:half.numel()]))


@pytest.mark.parametrize('R,V1', HIDDEN_SHAPES)
def test_packed_hidden_weights_unpack_to_bf16_weights(R, V1):
    """A packed W (R, V1) of a product h . W (the vocab projection logit_w,
    hvec's h2att_w) unpacks to bf16(W)^T, bit for bit, zero in the padded
    rows (V1 to V1p) and terms (R to Rl); V1p a multiple of 16, Rl of 64;
    one index per (R, V1, device)."""
    rng = np.random.default_rng(R * V1)
    logit_w = rnd(rng, R, V1)
    V1p, Rl = hidden_geometry(R, V1)
    assert V1p % 16 == 0 and V1p - 16 < V1 <= V1p
    assert Rl % 64 == 0 and Rl - 64 < R <= Rl
    packed = pack_hidden_weights(logit_w)
    assert packed.dtype == torch.bfloat16 and packed.numel() == V1p * Rl
    W = unpack_hidden_weights(packed, R, V1)
    assert W.shape == (V1p, Rl)
    assert torch.equal(bits(W[:V1, :R]),
                       bits(logit_w.T.contiguous().to(torch.bfloat16)))
    assert not W[V1:].float().any() and not W[:, R:].float().any()
    idx = hidden_index(R, V1, torch.device('cpu'))
    assert hidden_index(R, V1, torch.device('cpu')) is idx
    padded = V1 % 16 != 0 or R % 64 != 0
    assert int(idx.max()) == R * V1 - 1 + padded  # the appended zero: padding


def test_flagship_logit_pack_pads_1608_to_1616_rows():
    """At the flagship's R = 512 and V1 = 1608: 1616 rows of 512 terms,
    101 m-tiles, 1.65 MB in bf16 (3.3 MB in f32 unpacked); h2att_w at A =
    512 is whole tiles."""
    assert hidden_geometry(512, 1608) == (1616, 512)
    assert hidden_geometry(512, 512) == (512, 512)


@pytest.mark.parametrize('QT', QTS)
@pytest.mark.parametrize('R,H,Dh', SHAPES)
def test_forward_gate_mirror_matches_jax_bf16_products(R, H, Dh, QT):
    """The forward gates z = [h | ctx] P from the P^T half alone, tile by
    tile (two n8 tiles at QT = 16, each A fragment feeding both), against
    JAX's ``_make_dot('bfloat16')`` of the same operands and the dense
    product of the bf16-rounded operands: within 1e-5 of the float64
    product in units of the products, and within 2e-5 of JAX's.  At QT = 16
    each 8-query half equals the mirror of that half alone, bit for bit:
    the n8 tiles are independent columns."""
    rng = np.random.default_rng(100 * R + QT)
    w_hh, ctx_w3 = rnd(rng, R, 4 * R), rnd(rng, H, Dh, 4 * R)
    HD = H * Dh
    h, ctx = rnd(rng, QT, R), rnd(rng, QT, HD)
    x = torch.cat([h, ctx], 1)
    half = pack_gate_weights(w_hh, ctx_w3, backprop=False)
    z, none = gate_products_tiles(half, x, None, R, HD)
    assert none is None and z.shape == (QT, 4 * R)
    W = torch.cat([w_hh, ctx_w3.reshape(HD, 4 * R)])
    Wb, xb = dsa_bf16.bf16(W), dsa_bf16.bf16(x)
    assert product_units(z, xb, Wb) <= 1e-5
    jz = jdot(h, w_hh) + jdot(ctx, ctx_w3.reshape(HD, 4 * R))
    assert differ_units(z, jz, xb, Wb) <= 2e-5
    # the full pack (K4-bf16 reads its first half) gives the same z
    z_full, _ = gate_products_tiles(pack_gate_weights(w_hh, ctx_w3), x,
                                    torch.zeros((QT, 4 * R)), R, HD)
    assert torch.equal(z, z_full)
    if QT > 8:
        for lo in (0, 8):
            part, _ = gate_products_tiles(half, x[lo:lo + 8], None, R, HD)
            assert torch.equal(z[lo:lo + 8], part)


@pytest.mark.parametrize('QT', QTS)
@pytest.mark.parametrize('R,V1', HIDDEN_SHAPES)
def test_hidden_mirror_matches_jax_bf16_products(R, V1, QT):
    """The logits h . logit_w (and hvec's h . h2att_w, the same form) tile
    by tile from the packed W^T, against JAX's ``_make_dot('bfloat16')``
    and the dense product of the bf16-rounded operands (within 1e-5 of the
    float64 product in units of the products, 2e-5 of JAX's); the padded
    rows are exactly zero."""
    rng = np.random.default_rng(7 * R + V1 + QT)
    logit_w, h = rnd(rng, R, V1), rnd(rng, QT, R)
    logits = hidden_products_tiles(pack_hidden_weights(logit_w), h, R, V1)
    V1p, _ = hidden_geometry(R, V1)
    assert logits.shape == (QT, V1p)
    assert not logits[:, V1:].any()
    hb, wb = dsa_bf16.bf16(h), dsa_bf16.bf16(logit_w)
    assert product_units(logits[:, :V1], hb, wb) <= 1e-5
    assert differ_units(logits[:, :V1], jdot(h, logit_w), hb, wb) <= 2e-5


def lp_tol(logits):
    """4 f32 ulps of the largest |logit|: how far two f32 evaluations of
    max - (max + log(sum-exp)) may differ."""
    return 4 * float(np.spacing(np.float32(logits.abs().max())))


def jax_pick(logits, logit_b, V1):
    """The JAX kernel's choice (``_make_greedy_kernel``): logit_b padded
    with -inf to the padded width, the first index of the maximum, and
    lp = max - logsumexp."""
    V1p = logits.shape[1]
    lb = jnp.pad(jnp.asarray(logit_b.numpy()), (0, V1p - V1),
                 constant_values=-jnp.inf)
    x = jnp.asarray(logits.numpy()) + lb
    m = jnp.max(x, axis=-1, keepdims=True)
    iota = jnp.arange(V1p, dtype=jnp.float32)[None]
    win = jnp.min(jnp.where(x == m, iota, float(V1p)), axis=-1)
    lse = m + jnp.log(jnp.sum(jnp.exp(x - m), axis=-1, keepdims=True))
    return (torch.from_numpy(np.array(win).astype(np.int32)),
            torch.from_numpy(np.array(m - lse)[:, 0]))


@pytest.mark.parametrize('QT', QTS)
@pytest.mark.parametrize('R,V1', LOGIT_SHAPES)
def test_pick_mirror_matches_the_plain_and_jax_choice(R, V1, QT):
    """K6-bf16's merge of the tile logits into a token and its
    log-probability (``logits_pick_tiles``) gives the plain version's
    ``greedy_pick`` and the JAX kernel's choice on the same logits: the
    same token, lp within ``lp_tol``."""
    rng = np.random.default_rng(3 * R + V1 + QT)
    logit_w, h, logit_b = rnd(rng, R, V1), rnd(rng, QT, R), rnd(rng, V1)
    logits = hidden_products_tiles(pack_hidden_weights(logit_w), h, R, V1)
    tok, lp = logits_pick_tiles(logits, logit_b, V1)
    want_tok, want_lp = greedy_pick(logits[:, :V1] + logit_b)
    j_tok, j_lp = jax_pick(logits, logit_b, V1)
    assert torch.equal(tok.long(), want_tok) and torch.equal(tok, j_tok)
    tol = lp_tol(logits[:, :V1] + logit_b)
    assert float((lp - want_lp).abs().max()) <= tol
    assert float((lp - j_lp).abs().max()) <= tol


@pytest.mark.parametrize('QT', [4, 16])
def test_no_padded_row_wins_and_ties_keep_the_first_index(QT):
    """Every real logit negative: a zero-padded row (logit 0) would beat
    them all, as the argmax over the padded logits shows, but the kernel's
    merge skips the rows past V1 and picks a real one.  Ties at the maximum
    (vocab columns of zero weights and one bias: rows 5 and 13 in one lane,
    10 in another lane of the same warp, 21 and 77 in other warps) keep the
    first index, as jnp.argmax does."""
    R, V1 = 32, 83                     # V1p = 96: rows 83-95 padded
    rng = np.random.default_rng(5)
    h = torch.from_numpy(np.abs(rng.standard_normal((QT, R)))
                         .astype(np.float32))
    logit_w = -torch.from_numpy(np.abs(rng.standard_normal((R, V1)))
                                .astype(np.float32)) - 0.5
    logit_b = -torch.from_numpy(np.abs(rng.standard_normal(V1))
                                .astype(np.float32)) - 1.0
    tied = (5, 10, 13, 21, 77)
    for n in tied:
        logit_w[:, n] = 0.0
        logit_b[n] = -0.25
    logits = hidden_products_tiles(pack_hidden_weights(logit_w), h, R, V1)
    real = logits[:, :V1] + logit_b
    assert float(real.max()) < 0
    padded = torch.cat([real, logits[:, V1:]], 1)     # zero-padded rows
    assert bool((padded.argmax(-1) >= V1).all())      # the trap is real
    for n in tied:
        assert bool((real[:, n] == real.max(-1).values).all())
    assert bool((real.argmax(-1) == 5).all())
    tok, lp = logits_pick_tiles(logits, logit_b, V1)
    assert bool((tok == 5).all())
    j_tok, j_lp = jax_pick(logits, logit_b, V1)
    assert torch.equal(tok, j_tok)
    assert float((lp - j_lp).abs().max()) <= lp_tol(real)
    # the ties merged the other way round still keep the first index
    assert dsa_scan.lse_merge((np.float32(-1), np.float32(1), 77),
                              (np.float32(-1), np.float32(1), 5))[2] == 5


def test_scan_function_packs_once_and_the_backward_reuses_it(monkeypatch):
    """In bf16 ``DSATeacherScanFunction`` packs the gate weights and h2att_w
    once, in the forward (``pack_scan_weights``), hands the packs to
    K4-bf16 and the same tensors to K5-bf16; in f32 it packs nothing.  The
    two kernels are stood in for by recorders (they run only on the
    card)."""
    seen, made = [], []
    real_pack = dsa_scan.pack_scan_weights

    def pack(*a):
        made.append(real_pack(*a))
        return made[-1]

    def fwd(*args, precision, packs):
        seen.append(('fwd', precision, packs))
        *ops, _ = args
        B, K, Q = ops[3].shape[:3]
        hs = torch.zeros((B, K, Q, ops[12].shape[0]))
        return hs, hs.clone()

    def bwd(*args, precision, packs):
        seen.append(('bwd', precision, packs))
        return tuple(torch.zeros_like(torch.as_tensor(t)) for t in args[:13])

    monkeypatch.setattr(dsa_scan, 'pack_scan_weights', pack)
    monkeypatch.setattr(dsa_scan, 'dsa_teacher_scan_fwd', fwd)
    monkeypatch.setattr(dsa_scan, 'dsa_teacher_scan_bwd', bwd)
    rng = np.random.default_rng(0)
    B, K, Q, R, H, Dh, A, LP, S = 1, 3, 2, 16, 1, 8, 8, 4, 6
    shapes = ((B, H, S, Dh), (B, H, Q, LP), (B, Q, LP), (B, K, Q, 4 * R),
              (H, R, LP), (R, A), (A,), (Dh, A), (A,), (A,), (1,),
              (H, Dh, 4 * R), (R, 4 * R))
    for precision, packed in (('bfloat16', True), ('float32', False)):
        seen.clear()
        made.clear()
        ops = [rnd(rng, *s).requires_grad_() for s in shapes]
        hs = dsa_scan.DSATeacherScanFunction.apply(*ops, (S,), precision)
        hs.sum().backward()
        assert [s[:2] for s in seen] == [('fwd', precision),
                                         ('bwd', precision)]
        if packed:
            assert len(made) == 1
            assert seen[0][2] is made[0] and seen[1][2] is made[0]
            gates, hvec = made[0]
            assert torch.equal(bits(gates),
                               bits(pack_gate_weights(ops[12], ops[11])))
            assert torch.equal(bits(hvec), bits(pack_hidden_weights(ops[5])))
        else:
            assert not made and seen[0][2] is None and seen[1][2] is None
