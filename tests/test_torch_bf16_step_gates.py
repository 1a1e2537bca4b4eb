"""K9-bf16's and K10-bf16's gate products on the tensor cores, on the CPU:
the gate weights [W_hh; ctx_w3] packed once a forward pass
(``dvc_tpu_torch.ops.dsa_scan.pack_gate_weights``) and handed to both
kernels (``DSALSTMStepFunction``, the caption head's ``_stepper``, the
kernels stood in for by recorders: they run only on the card), and plain
fragment-order mirrors of the kernels' gates against the JAX package's
bf16 word step (``_pallas_lstm_core`` at ``precision='bfloat16'`` in
interpret mode): K9-bf16's forward (``gate_products_tiles`` on the packed
P^T, then the cell) at query tiles of 2, 4, 8 and 16, and K10-bf16's gate
backward (the same recompute, the cell backward, [dh | dctx] = dz P from
the pack's second half) at its tiles of 2, 4 and 8, at R = 36 (padded to
64 units) and H*Dh = 16 (R + H*Dh = 52 terms padded to 64).  The kernels
themselves: ``tests/test_torch_cuda_kernels.py`` (marker ``cuda``) and
``chip_smoke.py`` phase 16.

Tolerances.  The pack is exact (bit for bit).  A mirror's product sums
bf16 x bf16 products (exact in f32) in f32 in 16-term chunks, in another
order than JAX's ``_make_dot('bfloat16')`` (which sums h . W_hh and each
head's ctx . ctx_w3 apart, then adds them to z0): within 1e-5 of the
float64 product in units of each output's products' root-sum-square
(``product_units``), as ``tests/test_torch_bf16_fwd_gates.py``.  Against
JAX, in f32 ulps (2^-23) of a scale: h' and c' (a cell of slopes below 1)
within CELL_ULPS of their gates' scale, the largest over the unit's four
gates of the products' root-sum-square plus |z0| (and c' another ulp of
|c|; read: at most 0.65 and 1.04); dz within DZ_ULPS of that scale times
|gh| + |gc| (read: 1.39); dh and dctx, the products of JAX's own bf16(dz)
from the pack's second half, within PRODUCT_ULPS of their products'
root-sum-square (read: 6.4).  The JAX kernel's
context, which its gate products read, is K7's at bf16 (``_pallas_core``,
the same ``_fwd_math``), so both sides round the same ctx.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401,I100 (sets torch threads)

from dvc_tpu.ops.dsa_step import _make_dot
from dvc_tpu_torch.models import caption_heads
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.ops import dsa_bf16, dsa_step
from dvc_tpu_torch.ops.dsa_greedy import lstm_cell
from dvc_tpu_torch.ops.dsa_scan import (gate_geometry, gate_products_tiles,
                                        pack_gate_weights)
from dvc_tpu_torch.ops.dsa_step import (LSTM_TABLE_NAMES,
                                        DSALSTMStepFunction,
                                        lstm_step_table_ref)
from test_torch_bf16_step import jax_kernel
from test_torch_dsa_step import TS, boundary, make_inputs

BF16 = 'bfloat16'
R, H, Dh, B, Q = 36, 2, 8, 2, 8          # B * Q = 16 query rows
QTS = [2, 4, 8, 16]
CELL_ULPS, DZ_ULPS, PRODUCT_ULPS = 4, 8, 16   # f32 ulps of a scale
ULP = 2.0 ** -23


def bits(x):
    return x.view(torch.int16)


def table_ops(rng):
    """K9's 12 operands (``LSTM_TABLE_NAMES``) on the CPU, seeded, each a
    leaf that wants a gradient."""
    S, LP, A = sum(TS), 2 * len(TS), 16
    shapes = {'value_t': (B, H, S, Dh), 'vw': (B, H, S, A),
              'pos': (B, H, Q, LP), 'hvec': (B, Q, A), 'z0': (B, Q, 4 * R),
              'h': (B, Q, R), 'c': (B, Q, R), 'ctx_w3': (H, Dh, 4 * R),
              'w_hh': (R, 4 * R), 'cb': (A,), 'aw': (A,), 'ab': ()}
    return [torch.from_numpy(rng.standard_normal(shapes[n]).astype(
        np.float32)).requires_grad_() for n in LSTM_TABLE_NAMES]


def test_step_function_hands_one_pack_to_both_kernels(monkeypatch):
    """``DSALSTMStepFunction`` packs nothing itself: in bf16 it hands the
    caller's pack (``pack_gate_weights(w_hh, ctx_w3)``, bit for bit) to
    K9-bf16 and the same tensor to K10-bf16 in its backward, and in f32
    none to either; the gradients of ctx_w3 and w_hh are the kernel's, the
    pack gets none.  The kernels are stood in for by recorders."""
    seen, made = [], []
    real_pack = dsa_step.pack_gate_weights

    def pack(*a, **kw):
        made.append(real_pack(*a, **kw))
        return made[-1]

    def fwd(*args, precision, pack):
        seen.append(('fwd', precision, pack))
        h = args[5]
        return torch.zeros_like(h), torch.zeros_like(h)

    def bwd(*args, precision, pack):
        seen.append(('bwd', precision, pack))
        return tuple(torch.full_like(t, 2.0) for t in args[:12])

    monkeypatch.setattr(dsa_step, 'pack_gate_weights', pack)
    monkeypatch.setattr(dsa_step, 'dsa_lstm_step_fwd', fwd)
    monkeypatch.setattr(dsa_step, 'dsa_lstm_step_bwd', bwd)
    rng = np.random.default_rng(0)
    for precision in (BF16, 'float32'):
        seen.clear()
        ops = table_ops(rng)
        given = (real_pack(ops[8].detach(), ops[7].detach())
                 if precision == BF16 else None)
        h, c = DSALSTMStepFunction.apply(*ops, TS, precision, given)
        (h.sum() + c.sum()).backward()
        assert [s[:2] for s in seen] == [('fwd', precision),
                                         ('bwd', precision)]
        assert seen[0][2] is given and seen[1][2] is given
        assert not made
        assert torch.equal(ops[7].grad, torch.full_like(ops[7], 2.0))
        assert torch.equal(ops[8].grad, torch.full_like(ops[8], 2.0))
        if given is not None:
            assert not given.requires_grad
            assert torch.equal(bits(given), bits(pack_gate_weights(
                ops[8].detach(), ops[7].detach())))


def test_gate_pack_rule():
    """The wrappers' rule for the pack (``dsa_step._gate_pack``): bf16
    requires one of ``pack_gate_weights``' size and type on the operands'
    device and makes none; f32 refuses one."""
    w_hh = torch.randn(R, 4 * R)
    ctx_w3 = torch.randn(H, Dh, 4 * R)
    pack = pack_gate_weights(w_hh, ctx_w3)
    Rp, KKp = gate_geometry(R, H * Dh)
    assert pack.numel() == 8 * Rp * KKp and pack.dtype == torch.bfloat16
    dims = (B, H, sum(TS), Dh, Q, 4, len(TS), 16, R)
    cpu = torch.device('cpu')
    assert dsa_step._gate_pack(pack, True, dims, cpu) is pack
    assert dsa_step._gate_pack(None, False, dims, cpu) is None
    for bad in (None, pack[:-8], pack.float(),
                pack_gate_weights(w_hh, ctx_w3, backprop=False)):
        with pytest.raises(ValueError, match='pack'):
            dsa_step._gate_pack(bad, True, dims, cpu)
    with pytest.raises(ValueError, match='pack'):
        dsa_step._gate_pack(pack, False, dims, cpu)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so that the caption
    head takes its kernel route (the table, the rounding of value_t, the
    gate pack) while the kernels are stood in for."""

    @property
    def is_cuda(self):
        return True


def _head(precision, lstm_fuse=True):
    from test_torch_caption_core import BASE
    head = DSACaptionHead(CaptionHeadConfig(
        **BASE, num_layers=1, att_hid_size=20, greedy_fuse=False,
        lstm_fuse=lstm_fuse, precision=precision))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return head


@pytest.mark.parametrize('precision', [BF16, 'float32'])
def test_one_stepwise_forward_pass_makes_one_pack(monkeypatch, precision):
    """A stepwise decode (``--dsa_greedy_fuse 0 --dsa_lstm_fuse 1``) on the
    card's route: in bf16 ``_stepper`` packs the gate weights once for all
    max_caption_len word steps (the fused word step sees that one tensor at
    every step, bit-equal to ``pack_gate_weights(w_hh, ctx_w3)`` of the
    head's weights) and rounds value_t alone; in f32 it packs nothing.  The CPU bf16 route (the plain product form) packs nothing
    either.  The table and the word-step kernels are stood in for."""
    from test_torch_caption_core import head_inputs
    from torch_port import to_torch
    packs, steps = [], []
    real_pack = caption_heads.pack_gate_weights
    real_hoist = DSACaptionHead._hoist
    real_round = caption_heads.RoundBf16.apply

    def pack(*a, **kw):
        packs.append(real_pack(*a, **kw))
        return packs[-1]

    def hoist(self, *a):
        out = real_hoist(self, *a)
        return (out[0].as_subclass(_OnCard),) + out[1:]

    rounded = []

    def round_bf16(x, *rest):
        rounded.append(tuple(x.shape))
        return real_round(x, *rest)

    def table(value_t, cw, precision, value16=None):
        return (dsa_bf16.bf16(value_t.as_subclass(torch.Tensor))
                @ dsa_bf16.bf16(cw))

    def step(value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh, cb, aw, ab,
             temporal_shapes, precision, pack=None):
        steps.append(pack)
        return lstm_step_table_ref(value_t.as_subclass(torch.Tensor), vw,
                                   pos, hvec, z0, h, c, ctx_w3, w_hh, cb, aw,
                                   ab, temporal_shapes)

    monkeypatch.setattr(caption_heads, 'pack_gate_weights', pack)
    monkeypatch.setattr(caption_heads, 'dsa_value_table', table)
    monkeypatch.setattr(caption_heads, 'dsa_lstm_step_table_core', step)
    monkeypatch.setattr(caption_heads.RoundBf16, 'apply', round_bf16)
    head = _head(precision)
    inputs = [to_torch(a) for a in head_inputs(4)]
    with torch.no_grad():
        plain_seq, _ = head(*inputs[:4], (12, 6), inputs[4])
    assert not packs and not rounded        # the CPU route: no pack
    monkeypatch.setattr(DSACaptionHead, '_hoist', hoist)
    steps.clear()
    with torch.no_grad():
        seq, lp = head(*inputs[:4], (12, 6), inputs[4])
    K = head.cfg.max_caption_len
    assert len(steps) == K and seq.shape == plain_seq.shape
    assert torch.isfinite(lp).all()
    if precision == 'float32':
        assert not packs and not rounded and all(p is None for p in steps)
        return
    assert len(packs) == 1 and all(p is packs[0] for p in steps)
    E, d = head.cfg.input_encoding_size, head.cfg.hidden_dim
    w_ih = head.core.rnn.weight_ih_l0
    want = pack_gate_weights(head.core.rnn.weight_hh_l0.T,
                             w_ih[:, E:E + d].T)
    assert torch.equal(bits(packs[0]), bits(want))
    # value_t (B, H, S, Dh) alone is rounded
    assert rounded == [(B, head.cfg.cap_nheads, sum(TS),
                        d // head.cfg.cap_nheads)]


# ----------------------------------------------------------------------------
# the fragment-order mirrors against JAX's bf16 word step
# ----------------------------------------------------------------------------

@pytest.fixture(scope='module')
def jax_step():
    """The step's operands at the kernels' boundary (numpy; B = 2, Q = 8,
    R = 36, H = 2, Dh = 8), JAX's bf16 context (K7's kernel), (h', c') and
    the cotangents' gradients of K9's / K10's kernels at bf16, interpret
    mode."""
    ops = boundary(make_inputs(seed=19, B=B, H=H, Dh=Dh, Q=Q, R=R),
                   lstm=True)
    ctx, = jax_kernel(ops[:3] + ops[8:], False)
    h_new, c_new = (np.array(t) for t in jax_kernel(ops, True))
    rng = np.random.default_rng(20)
    gh = rng.standard_normal(h_new.shape).astype(np.float32)
    gc = rng.standard_normal(c_new.shape).astype(np.float32)
    grads = [np.asarray(g) for g in jax_kernel(ops, True, (gh, gc))]
    return dict(ops=[torch.from_numpy(np.array(a)) for a in ops],
                ctx=torch.from_numpy(np.array(ctx)),
                h=torch.from_numpy(h_new), c=torch.from_numpy(c_new),
                gh=torch.from_numpy(gh), gc=torch.from_numpy(gc),
                dz=torch.from_numpy(grads[3]), dh=torch.from_numpy(grads[4]),
                dc=torch.from_numpy(grads[5]))


def rss(a, b):
    """Root-sum-square of the products of a @ b (float64)."""
    a, b = a.double(), b.double()
    return ((a * a) @ (b * b)).sqrt()


def product_units(got, a, b):
    a, b = a.double(), b.double()
    return float(((got.double() - a @ b).abs()
                  / rss(a, b).clamp_min(1e-30)).max())


def cell_bwd(z, c, gh, gc):
    """The kernels' cell backward (dsa_common.cuh ``cell_bwd``), in f32:
    (dz (N, 4R), dc_prev)."""
    zi, zf, zg, zo = z.chunk(4, -1)
    si, sf, tg, so = (torch.sigmoid(zi), torch.sigmoid(zf), torch.tanh(zg),
                      torch.sigmoid(zo))
    th = torch.tanh(sf * c + si * tg)
    dc = gc + gh * so * (1 - th * th)
    return torch.cat([dc * tg * si * (1 - si), dc * c * sf * (1 - sf),
                      dc * si * (1 - tg * tg), gh * th * so * (1 - so)],
                     -1), dc * sf


def rows(t):
    """(B, Q, X) -> (B*Q, X)."""
    return t.reshape(B * Q, -1)


@pytest.mark.parametrize('QT', QTS)
def test_gate_mirrors_match_jax_bf16_word_step(jax_step, QT):
    """K9-bf16's forward and K10-bf16's gate backward tile by tile (query
    tiles of QT rows of the B*Q queries) from one pack: the products z =
    [h | ctx] P within 1e-5 of their root-sum-square; h' and c' against
    JAX's K9 at bf16, within CELL_ULPS of their gates' scale; the
    recompute equal to the forward bit for bit; dz against JAX's dz0
    within DZ_ULPS; dh and dctx (from JAX's bf16(dz), the pack's second
    half) against JAX's dh and its bf16 dz . ctx_w3^T within PRODUCT_ULPS
    of their root-sum-square and 1e-5 of it as products."""
    j = jax_step
    value_t, pos, hvec, z0, h, c, ctx_w3, w_hh = j['ops'][:8]
    HD = H * Dh
    pack = pack_gate_weights(w_hh, ctx_w3)
    W = torch.cat([w_hh, ctx_w3.reshape(HD, 4 * R)])        # P (KK, 4R)
    ctx = j['ctx'].permute(0, 2, 1, 3).reshape(B * Q, HD)   # (h, d) order
    x = torch.cat([rows(h), ctx], 1)
    xb, Wb = dsa_bf16.bf16(x), dsa_bf16.bf16(W)
    z0r, cr = rows(z0), rows(c)
    scale = (rss(xb, Wb) + z0r.double().abs())               # (N, 4R)
    gate_scale = scale.reshape(B * Q, 4, R).amax(1)          # (N, R)
    for t0 in range(0, B * Q, QT):
        sl = slice(t0, t0 + QT)
        zp, _ = gate_products_tiles(pack, x[sl], None, R, HD)
        assert product_units(zp, xb[sl], Wb) <= 1e-5
        z = zp + z0r[sl]                  # the kernel adds z0 after the sum
        h1, c1 = lstm_cell(z, cr[sl])
        tol = CELL_ULPS * ULP * gate_scale[sl]
        assert ((h1 - rows(j['h'])[sl]).abs() <= tol).all()
        assert ((c1 - rows(j['c'])[sl]).abs()
                <= tol + ULP * cr[sl].abs().double() + ULP).all()
        if QT > 8:                        # K10-bf16's tiles hold at most 8
            continue
        # K10-bf16: the recompute, then dz . P from the second half
        zr, dx = gate_products_tiles(pack, x[sl], rows(j['dz'])[sl], R, HD)
        assert torch.equal(zr, zp)
        dz, dc = cell_bwd(zr + z0r[sl], cr[sl], rows(j['gh'])[sl],
                          rows(j['gc'])[sl])
        g = (rows(j['gh'])[sl].abs() + rows(j['gc'])[sl].abs()).double()
        dz_tol = DZ_ULPS * ULP * gate_scale[sl] * g + ULP
        assert ((dz - rows(j['dz'])[sl]).abs().reshape(-1, 4, R)
                <= dz_tol[:, None]).all()
        assert ((dc - rows(j['dc'])[sl]).abs() <= dz_tol).all()
        dzb = dsa_bf16.bf16(rows(j['dz'])[sl])
        assert product_units(dx, dzb, Wb.T) <= 1e-5
        dot = _make_dot(BF16)
        dctx_jax = torch.from_numpy(np.array(dot(
            jnp.asarray(rows(j['dz'])[sl].numpy()),
            jnp.asarray(ctx_w3.reshape(HD, 4 * R).T.numpy()))))
        scale_back = rss(dzb, Wb.T)                          # (QT, KK)
        tol = PRODUCT_ULPS * ULP * scale_back
        assert ((dx[:, :R] - rows(j['dh'])[sl]).abs() <= tol[:, :R]).all()
        assert ((dx[:, R:] - dctx_jax).abs() <= tol[:, R:]).all()
