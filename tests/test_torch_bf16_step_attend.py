"""K7-bf16's and K8-bf16's product form on the tensor cores, on the CPU:
Wc packed once a forward pass in bf16 in the kernels' B-fragment order
(``dvc_tpu_torch.ops.dsa_step.pack_attend_weights``: Wc^T's tiles for
taps . Wc, then Wc's for du . Wc^T), the wrappers' rule for it, its
hand-over from ``DSASampleAttendFunction``'s forward to its backward and
from the caption head's unfused stepwise route (``_stepper``, the kernels
stood in for by recorders: they run only on the card), and a plain mirror
of the kernels' products tile by tile (``attend_products_tiles``) and of
their dcw summed in 16-row chunks against the JAX package's bf16 word step
(``_pallas_core`` at ``precision='bfloat16'`` in interpret mode) at
cap_nheads 1 and 8.  The kernels themselves:
``tests/test_torch_cuda_kernels.py`` (marker ``cuda``) and
``chip_smoke.py`` phase 16.

Tolerances.  The pack is exact (bit for bit).  A mirror's product sums
bf16 x bf16 products (exact in f32) in f32 a 16 x 16 tile at a time, in
another order than JAX's ``_make_dot('bfloat16')``: within 1e-5 of the
float64 product in units of each output's products' root-sum-square
(``product_units``).  Against JAX, those of the plain bf16 word steps
(``tests/test_torch_bf16_step.py``: the same rounding points, f32 sums in
another order): ctx within 1e-5, each gradient within 1e-4 of its largest
magnitude, d alpha_b (zero in exact arithmetic) within 1e-5 absolute.
"""
import numpy as np
import pytest
import torch

import torch_port  # noqa: F401,I100 (sets torch threads)

from dvc_tpu_torch.models import caption_heads
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.ops import dsa_bf16, dsa_step
from dvc_tpu_torch.ops.dsa_greedy import _level_bounds
from dvc_tpu_torch.ops.dsa_scan import hidden_geometry, pack_hidden_weights
from dvc_tpu_torch.ops.dsa_step import (STEP_NAMES, DSASampleAttendFunction,
                                        attend_pack_geometry,
                                        attend_products_tiles,
                                        pack_attend_weights,
                                        unpack_attend_weights)
from test_torch_bf16_step import jax_kernel
from test_torch_bf16_step_gates import _OnCard, bits, product_units
from test_torch_dsa_step import TS, boundary, make_inputs

BF16 = 'bfloat16'


def b_tiles(w, M, K):
    """The (K, M) operand w of a product x . w as the kernels read its B
    fragments: (M/16, K/16, 32, 8), tile (j, kt) lane l's 8 elements those
    of the n8 tiles 2j and 2j + 1 (rows k = 16kt + 2(l%4) + {0, 1, 8, 9},
    column n = 16j + l/4, then + 8)."""
    lane = torch.arange(32)
    g, t = lane // 4, 2 * (lane % 4)
    kk = torch.stack([t, t + 1, t + 8, t + 9] * 2, 1)
    nn = torch.stack([g] * 4 + [g + 8] * 4, 1)
    j = torch.arange(M // 16)[:, None, None, None]
    kt = torch.arange(K // 16)[None, :, None, None]
    return w[16 * kt + kk, 16 * j + nn]


@pytest.mark.parametrize('Dh,A', [(16, 32), (64, 512), (24, 40)])
def test_wc_pack_holds_wc_in_b_fragment_order(Dh, A):
    """``pack_attend_weights(cw)``: a flat torch.bfloat16 tensor, no
    gradient, of ``attend_pack_geometry``'s size; unpacked in plain torch,
    bf16(Wc)^T and bf16(Wc) bit for bit; its halves the B fragments of
    taps . Wc (Wc (Dh, A), Dh padded to 64 terms, A to 16 columns) and of
    du . Wc^T (Wc^T (A, Dh), A padded to 64, Dh to 16), zero where padded,
    tile by tile and lane by lane."""
    rng = np.random.default_rng(Dh + A)
    cw = torch.from_numpy(rng.standard_normal((Dh, A)).astype(np.float32))
    cw.requires_grad_()
    pack = pack_attend_weights(cw)
    first, n = attend_pack_geometry(Dh, A)
    assert pack.dtype == torch.bfloat16 and pack.numel() == n
    assert not pack.requires_grad
    wt, w = unpack_attend_weights(pack, Dh, A)
    wb = cw.detach().bfloat16()
    assert torch.equal(bits(wt), bits(wb.t().contiguous()))
    assert torch.equal(bits(w), bits(wb))
    for half, (rows, cols), src in ((pack[:first], hidden_geometry(Dh, A), wb),
                                    (pack[first:], hidden_geometry(A, Dh),
                                     wb.t())):
        Np, Rl = rows, cols                   # B columns (n), terms (k)
        padded = torch.zeros((Rl, Np), dtype=torch.bfloat16)
        padded[:src.shape[0], :src.shape[1]] = src
        assert torch.equal(bits(half.reshape(Np // 16, Rl // 16, 32, 8)),
                           bits(b_tiles(padded, Np, Rl)))
    # the same elements as pack_hidden_weights' A fragments, reordered
    assert torch.equal(bits(pack.reshape(-1, 8)[:, [0, 1, 4, 5, 2, 3, 6, 7]]),
                       bits(torch.cat([pack_hidden_weights(cw),
                                       pack_hidden_weights(cw.t())])
                            .reshape(-1, 8)))


def test_wc_pack_rule():
    """The wrappers' rule for the Wc pack (``dsa_step._attend_pack``):
    K7-bf16 and K8-bf16 require one of ``pack_attend_weights``' size and
    type on the operands' device and make none; the f32 K7/K8 refuse one;
    the bf16 wrappers refuse the table vw (before looking at the device),
    and the table-form wrapper refuses bf16 on the CPU and on the card."""
    B, H, Dh, Q, A = 2, 2, 16, 3, 32
    S, LP = sum(TS), 2 * len(TS)
    cw = torch.randn(Dh, A)
    pack = pack_attend_weights(cw)
    dims = (B, H, S, Dh, Q, LP, len(TS), A, 0)
    cpu = torch.device('cpu')
    assert dsa_step._attend_pack(pack, True, dims, cpu) is pack
    assert dsa_step._attend_pack(None, False, dims, cpu) is None
    for bad in (None, pack[:-8], pack.float(), pack_hidden_weights(cw),
                pack_attend_weights(torch.randn(Dh, A + 16))):
        with pytest.raises(ValueError, match='pack'):
            dsa_step._attend_pack(bad, True, dims, cpu)
    with pytest.raises(ValueError, match='pack'):
        dsa_step._attend_pack(pack, False, dims, cpu)
    value16 = torch.randn(B, H, S, Dh).bfloat16()
    rest = (torch.randn(B, H, Q, LP), torch.randn(B, Q, A), torch.randn(A),
            torch.randn(A), torch.tensor(0.1))
    vw = torch.randn(B, H, S, A)
    launches = (dsa_step.dsa_sample_attend_fwd.launches_bf16,
                dsa_step.dsa_sample_attend_bwd.launches_bf16)
    with pytest.raises(ValueError, match='vw'):
        dsa_step.dsa_sample_attend_fwd(value16, vw, *rest, TS,
                                       precision=BF16, pack=pack)
    with pytest.raises(ValueError, match='vw'):
        dsa_step.dsa_sample_attend_bwd(value16, vw, *rest, TS,
                                       torch.zeros(B, H, Q, Dh),
                                       precision=BF16, pack=pack)
    with pytest.raises(ValueError, match='CUDA'):
        dsa_step.dsa_sample_attend_fwd(value16, None, *rest, TS,
                                       precision=BF16, pack=pack)
    value_t = torch.randn(B, H, S, Dh)
    for v in (value_t, value_t.as_subclass(_OnCard)):
        with pytest.raises(NotImplementedError, match='dsa_sample_attend_core'):
            dsa_step.dsa_sample_attend_table_core(v, vw, *rest, TS, BF16)
    assert launches == (dsa_step.dsa_sample_attend_fwd.launches_bf16,
                        dsa_step.dsa_sample_attend_bwd.launches_bf16)


def _step_ops(rng, B=2, H=2, Q=3, Dh=16, A=32):
    """K7-bf16's operands at the JAX boundary (``STEP_NAMES``), each a leaf
    that wants a gradient."""
    S, LP = sum(TS), 2 * len(TS)
    shapes = {'value_t': (B, H, S, Dh), 'pos': (B, H, Q, LP),
              'hvec': (B, Q, A), 'cw': (Dh, A), 'cb': (A,), 'aw': (A,),
              'ab': ()}
    return [torch.from_numpy(rng.standard_normal(shapes[n]).astype(
        np.float32)).requires_grad_() for n in STEP_NAMES]


def test_step_function_hands_one_pack_to_both_kernels(monkeypatch):
    """``DSASampleAttendFunction`` packs and rounds nothing itself: in bf16
    it hands the caller's Wc pack and value16 to K7-bf16 (no vw, cw left
    out) and the same two tensors to K8-bf16 in its backward, and the
    kernel's seven gradients, JAX's order, are the operands' (value_t's is
    its dvalue, cw's its dcw); in f32 it hands the table vw and no pack to
    K7/K8, whose G is vw's gradient.  The kernels are stood in for by
    recorders."""
    seen = []

    def fwd(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes,
            precision, pack):
        seen.append(('fwd', precision, value_t, vw, pack))
        B, H, _, Dh = value_t.shape
        return torch.zeros((B, H, pos.shape[2], Dh))

    def bwd(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes, g,
            precision, pack):
        seen.append(('bwd', precision, value_t, vw, pack))
        if precision == BF16:
            shapes = (value_t.shape, pos.shape, hvec.shape,
                      (value_t.shape[-1], hvec.shape[-1]), cb.shape,
                      aw.shape, ab.shape)
        else:
            shapes = (value_t.shape, vw.shape, pos.shape, hvec.shape,
                      cb.shape, aw.shape, ab.shape)
        return tuple(torch.full(s, 2.0) for s in shapes)

    monkeypatch.setattr(dsa_step, 'dsa_sample_attend_fwd', fwd)
    monkeypatch.setattr(dsa_step, 'dsa_sample_attend_bwd', bwd)
    monkeypatch.setattr(dsa_step, 'pack_attend_weights', None)  # none made
    rng = np.random.default_rng(0)
    ops = _step_ops(rng)
    pack = pack_attend_weights(ops[3].detach())
    value16 = dsa_bf16.bf16_operand(ops[0].detach())
    ctx = DSASampleAttendFunction.apply(*ops, TS, BF16, pack, value16)
    ctx.sum().backward()
    assert [s[:2] for s in seen] == [('fwd', BF16), ('bwd', BF16)]
    for s in seen:
        assert s[2] is value16 and s[3] is None and s[4] is pack
    for leaf in ops:
        assert torch.equal(leaf.grad, torch.full_like(leaf, 2.0))
    # f32: the table form, no pack
    seen.clear()
    ops = _step_ops(rng)
    vw = torch.randn(*ops[0].shape[:3], ops[2].shape[-1], requires_grad=True)
    targs = (ops[0], vw, ops[1], ops[2], *ops[4:])
    DSASampleAttendFunction.apply(*targs, TS, 'float32', None, None) \
        .sum().backward()
    assert [s[:2] for s in seen] == [('fwd', 'float32'), ('bwd', 'float32')]
    assert all(s[2] is ops[0] and s[3] is vw and s[4] is None for s in seen)
    assert torch.equal(vw.grad, torch.full_like(vw, 2.0))
    assert ops[3].grad is None                   # cw is not an operand here


def _head(precision, **over):
    from test_torch_caption_core import BASE
    head = DSACaptionHead(CaptionHeadConfig(
        **{**BASE, **dict(num_layers=1, att_hid_size=20, greedy_fuse=False,
                          scan_fuse=False, lstm_fuse=False,
                          precision=precision), **over}))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for p in head.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return head


@pytest.mark.parametrize('num_layers', [1, 2])
@pytest.mark.parametrize('precision', [BF16, 'float32'])
def test_unfused_stepwise_pass_makes_one_wc_pack(monkeypatch, precision,
                                                 num_layers):
    """The unfused stepwise route (``--dsa_lstm_fuse 0``, or a core of two
    layers, which never fuses) on the card's route: in bf16 ``_stepper``
    builds no table, rounds value_t once (value16) and packs Wc once for
    all the pass's word steps, and K7-bf16 at every step and K8-bf16 at
    every step of the backward see those two tensors (the pack bit-equal to
    ``pack_attend_weights`` of the head's Wc); in f32 one table, no pack.
    The CPU bf16 route (the plain product form) makes neither.  The
    kernels and the table are stood in for by recorders: the kernels by
    the plain product form on the unpacked Wc."""
    from test_torch_caption_core import head_inputs, seq_of
    from torch_port import to_torch
    packs, tables, steps = [], [], []
    real_pack = caption_heads.pack_attend_weights
    real_hoist = DSACaptionHead._hoist

    def pack(cw):
        packs.append(real_pack(cw))
        return packs[-1]

    def table(value_t, cw, precision, value16=None):
        tables.append(precision)
        return value_t.as_subclass(torch.Tensor) @ cw

    def plain(t):
        return t.as_subclass(torch.Tensor)

    def fwd(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes,
            precision, pack):
        steps.append(('fwd', value_t, vw, pack))
        if vw is not None:
            return dsa_step.sample_attend_table_ref(
                plain(value_t), plain(vw), pos, hvec, cb, aw, ab,
                temporal_shapes)
        cw = unpack_attend_weights(pack, value_t.shape[-1], hvec.shape[-1])[1]
        return dsa_bf16.sample_attend_fwd(plain(value_t).float(), pos, hvec,
                                          cw.float(), cb, aw, ab,
                                          temporal_shapes)

    def bwd(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes, g,
            precision, pack):
        steps.append(('bwd', value_t, vw, pack))
        if vw is not None:
            return dsa_step.sample_attend_table_bwd_ref(
                plain(value_t), plain(vw), pos, hvec, cb, aw, ab,
                temporal_shapes, g)
        cw = unpack_attend_weights(pack, value_t.shape[-1], hvec.shape[-1])[1]
        return dsa_bf16.sample_attend_bwd(plain(value_t).float(), pos, hvec,
                                          cw.float(), cb, aw, ab,
                                          temporal_shapes, g)

    def hoist(self, *a):
        out = real_hoist(self, *a)
        return (out[0].as_subclass(_OnCard),) + out[1:]

    monkeypatch.setattr(caption_heads, 'pack_attend_weights', pack)
    monkeypatch.setattr(caption_heads, 'dsa_value_table', table)
    monkeypatch.setattr(dsa_step, 'dsa_value_table', table)
    monkeypatch.setattr(dsa_step, 'dsa_sample_attend_fwd', fwd)
    monkeypatch.setattr(dsa_step, 'dsa_sample_attend_bwd', bwd)
    head = _head(precision, num_layers=num_layers)
    inputs = [to_torch(a) for a in head_inputs(5)]
    seq = torch.from_numpy(seq_of(6))
    with torch.no_grad():
        head(*inputs[:4], (12, 6), inputs[4])
    assert not packs and not steps and tables == ['float32'] * (
        precision == 'float32')                  # the CPU route
    tables.clear()
    monkeypatch.setattr(DSACaptionHead, '_hoist', hoist)
    K = head.cfg.max_caption_len
    with torch.no_grad():                        # a stepwise decode
        head(*inputs[:4], (12, 6), inputs[4])
    lp = head.teacher_forcing(*inputs[:4], (12, 6), inputs[4], seq)
    lp.sum().backward()
    n_fwd = K + seq.shape[-1] - 1
    assert [s[0] for s in steps] == ['fwd'] * n_fwd + ['bwd'] * (
        seq.shape[-1] - 1)
    if precision == 'float32':
        assert not packs and tables == ['float32', 'float32']
        assert all(s[3] is None and s[2] is not None for s in steps)
        return
    assert not tables and len(packs) == 2        # one a forward pass
    want = pack_attend_weights(head.core.ctx2att.weight.T)
    assert all(torch.equal(bits(p), bits(want)) for p in packs)
    decode, train = steps[:K], steps[K:]
    for part, p in ((decode, packs[0]), (train, packs[1])):
        assert all(s[2] is None and s[3] is p for s in part)
        assert len({id(s[1]) for s in part}) == 1   # one value16 a pass
        assert part[0][1].dtype == torch.bfloat16
    assert head.core.ctx2att.weight.grad is not None


# ----------------------------------------------------------------------------
# the kernels' products against JAX's bf16 word step
# ----------------------------------------------------------------------------

def _taps(value_t, pos):
    """(the taps (B, H, Q, LP, Dh) in f32 of bf16(value_t), lo, hi, wl, wh)
    as the kernels form them (``dsa_bf16.tap_pair``)."""
    LP = pos.shape[-1]
    hib, s0 = _level_bounds(TS, LP // len(TS), 'cpu')
    lo, hi, wl, wh = dsa_bf16.tap_pair(pos, hib, s0)
    v = dsa_bf16.bf16(value_t)
    taps = (wl[..., None] * dsa_bf16._gather(v, lo)
            + wh[..., None] * dsa_bf16._gather(v, hi))
    return taps, lo, hi, wl, wh


def attend_tiles(value_t, pos, hvec, cw, cb, aw, ab, g):
    """K7-bf16's and K8-bf16's arithmetic on the CPU with their products
    as the tensor cores address them: taps . Wc and bf16(du) . Wc^T tile by
    tile from the Wc pack (``attend_products_tiles``), dcw = bf16(taps)^T
    bf16(du) summed in f32 a 16-row chunk at a time.  Returns (ctx, the
    seven gradients in ``STEP_NAMES`` order, ((taps, pre), (du, dprod)))."""
    B, H, S, Dh = value_t.shape
    Q, LP, A = pos.shape[2], pos.shape[3], hvec.shape[-1]
    pack = pack_attend_weights(cw)
    taps, lo, hi, wl, wh = _taps(value_t, pos)
    rows = taps.reshape(-1, Dh)
    pre = attend_products_tiles(pack, rows, None, Dh, A)[0]
    a = torch.tanh((pre.reshape(B, H, Q, LP, A) + cb)
                   + hvec[:, None, :, None, :])
    wts = torch.softmax(a @ aw + ab, dim=-1)
    ctx = (wts[..., None] * taps).sum(3)
    dwts = (taps * g[:, :, :, None, :]).sum(-1)
    ddot = wts * (dwts - (wts * dwts).sum(-1, keepdim=True))
    du = (ddot[..., None] * aw) * (1.0 - a * a)
    dub = dsa_bf16.bf16(du).reshape(-1, A)
    dprod = attend_products_tiles(pack, rows, dub, Dh, A)[1]
    dtaps = (wts[..., None] * g[:, :, :, None, :]
             + dprod.reshape(B, H, Q, LP, Dh))
    tb = dsa_bf16.bf16(rows)
    dcw = torch.zeros(Dh, A)
    for r in range(0, rows.shape[0], 16):
        dcw += tb[r:r + 16].T @ dub[r:r + 16]
    v = dsa_bf16.bf16(value_t)
    dpos = (dtaps * (dsa_bf16._gather(v, hi)
                     - dsa_bf16._gather(v, lo))).sum(-1)
    dvalue = torch.zeros(B, H, S, Dh)
    t16 = dsa_bf16.bf16(dtaps)
    dsa_bf16._scatter(dvalue, lo, wl[..., None] * t16)
    dsa_bf16._scatter(dvalue, hi, wh[..., None] * t16)
    grads = (dvalue, dpos, du.sum((1, 3)), dcw, du.sum((0, 1, 2, 3)),
             (a * ddot[..., None]).sum((0, 1, 2, 3)), ddot.sum())
    return ctx, grads, ((rows, pre), (dub, dprod))


@pytest.mark.parametrize('H,Dh,A', [(1, 32, 32), (8, 16, 48)])
def test_attend_mirror_matches_jax_bf16_word_step(H, Dh, A):
    """The plain mirror of K7-bf16 and K8-bf16 (``attend_tiles``): its
    products within 1e-5 of their root-sum-square of the float64 products
    of the bf16 operands; ctx and the seven gradients against JAX's K7 and
    K8 at bf16 in interpret mode, at cap_nheads 1 and 8 (B = 2, Q = 3, 2
    levels of 2 points, points off the tap boundaries)."""
    ops = boundary(make_inputs(seed=50 + H, B=2, H=H, Dh=Dh, Q=3, P=2, A=A))
    targs = [torch.from_numpy(np.array(a)) for a in ops]
    value_t, pos, hvec, cw, cb, aw, ab = targs
    rng = np.random.default_rng(60 + H)
    g = rng.standard_normal((2, H, 3, Dh)).astype(np.float32)
    ctx, grads, ((rows, pre), (dub, dprod)) = attend_tiles(
        *targs, torch.from_numpy(g))
    cwb = dsa_bf16.bf16(cw)
    assert product_units(pre, dsa_bf16.bf16(rows), cwb) <= 1e-5
    assert product_units(dprod, dub, cwb.T) <= 1e-5
    want, = jax_kernel(ops, False)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want = jax_kernel(ops, False, (g,))
    for name, a, b in zip(STEP_NAMES, grads, want):
        b = np.asarray(b)
        tol = 1e-5 if name == 'ab' else 1e-4 * np.abs(b).max()
        np.testing.assert_allclose(a.numpy().reshape(b.shape), b, rtol=0,
                                   atol=tol, err_msg=name)
