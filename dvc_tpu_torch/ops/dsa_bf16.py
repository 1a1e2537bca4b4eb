"""Plain bf16-operand versions of the fused caption kernels K4-K6: the
greedy decode and the teacher-forcing scan's forward and backward as the
JAX package's Pallas kernels compute them under
``--tpu_compute_dtype bfloat16``.

There every in-kernel product rounds both its operands to bf16 and
accumulates in f32 (``dvc_tpu/ops/dsa_step.py::_make_dot('bfloat16')``,
``dsa_scan.py::scan_fwd_math`` and ``_make_scan_bwd_kernel``,
``dsa_greedy.py::_make_greedy_kernel``): hvec ``h . h2att_w``, the offsets
``h . off_w``, the taps ``M . value`` (the lerp weights in the one-hot
matrix M rounded too; where both taps of a point clamp to one row, M holds
bf16(w_lo + w_hi) there), the scores ``taps . Wc``, the gates ``h . W_hh``
and ``ctx . ctx_w3``, the token share ``embed[tok] . token_w``, the logits
``h . logit_w``, and in the backward every transposed product and weight
gradient's outer sum.  Positions, the LSTM cell, tanh and the softmax stay
f32.  The JAX package's jnp references ignore the precision, so these are
ports of the kernels' bodies, not of those references.

``table=True`` mirrors the card's kernels instead (``csrc/dsa_greedy.cu``,
``csrc/dsa_scan.cu`` in their bf16-operand mode), which score a tap as the
lerp of two rows of the table bf16(value) . bf16(Wc) and so never round the
lerped taps; their backward forms dvalue's scores term as bf16(G) .
bf16(Wc)^T and dWc as bf16(value)^T bf16(G), G the lerp-scatter of
bf16(du).  The tests measure the gap between the two forms.

Arguments and returns are those of :func:`dvc_tpu_torch.ops.dsa_greedy.
dsa_greedy_scan_ref` and :mod:`dvc_tpu_torch.ops.dsa_scan`.
"""

from __future__ import annotations

import torch

from .dsa_greedy import _level_bounds, greedy_pick, lstm_cell

# the operands that enter only products: rounded to bf16 once
ROUNDED = ('value_t', 'off_w_h', 'h2att_w', 'cw', 'ctx_w3', 'w_hh')


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def mm(a, b):
    """a @ b on bf16-rounded operands with f32 accumulation."""
    return bf16(a) @ bf16(b)


def _gather(table, idx):
    """Rows idx (B, H, Q, LP) of table (B, H, S, W): (B, H, Q, LP, W)."""
    B, H, Q, LP = idx.shape
    W = table.shape[-1]
    i = idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, W)
    return torch.gather(table, 2, i).reshape(B, H, Q, LP, W)


def _scatter(dst, idx, rows):
    """dst (B, H, S, W) += rows (B, H, Q, LP, W) at idx (B, H, Q, LP)."""
    B, H, Q, LP = idx.shape
    W = dst.shape[-1]
    dst.scatter_add_(2, idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, W),
                     rows.reshape(B, H, Q * LP, W))


def tap_pair(pos, hib, s0):
    """Border-mode tap pair of the positions pos (B, H, Q, LP): flat row
    indices (lo, hi) and the bf16 lerp weights (wl, wh) of the TPU
    kernel's M (one row's weight bf16(w_lo + w_hi) where both clamp to
    it)."""
    zero = torch.zeros((), device=pos.device)
    i_lo = torch.floor(pos)
    w_hi = pos - i_lo
    w_lo = 1.0 - w_hi
    lo = torch.minimum(torch.maximum(i_lo, zero), hib).long() + s0
    hi = torch.minimum(torch.maximum(i_lo + 1.0, zero), hib).long() + s0
    same = lo == hi
    wl = bf16(torch.where(same, w_lo + w_hi, w_lo))
    wh = torch.where(same, 0.0, bf16(w_hi))
    return lo, hi, wl, wh


def rounded_operands(ops):
    """The scan's or the greedy decode's operands by name with value_t and
    the weights of the step's products rounded to bf16 (``ROUNDED``)."""
    return {k: bf16(v) if k in ROUNDED else v for k, v in ops.items()}


def attend(h, o, hib, s0, vw=None):
    """One word step's attention from the hidden state h (B, Q, R) with
    bf16 operands; o the operands by name, value_t and the weights already
    rounded (:func:`rounded_operands`).  vw (B, H, S, A), the table
    value_t . cw, selects the kernels' table form.  Returns the step's
    intermediates: hb = bf16(h), off, (lo, hi, wl, wh), the taps
    (B, H, Q, LP, Dh), the tanh activations a (B, H, Q, LP, A), the softmax
    weights wts and ctx (B, H, Q, Dh)."""
    hb = bf16(h)
    hvec = hb @ o['h2att_w'] + o['h2att_b']
    off = torch.einsum('bqr,hrp->bhqp', hb, o['off_w_h'])
    pos = o['base_pos'] + off * o['scale_t'][:, None]
    lo, hi, wl, wh = tap_pair(pos, hib, s0)
    v = o['value_t']
    taps = (wl[..., None] * _gather(v, lo) + wh[..., None] * _gather(v, hi))
    if vw is None:
        pre = bf16(taps) @ o['cw']
    else:
        pre = wl[..., None] * _gather(vw, lo) + wh[..., None] * _gather(vw, hi)
    a = torch.tanh(pre + o['cb'] + hvec[:, None, :, None, :])
    wts = torch.softmax(a @ o['aw'] + o['ab'], dim=-1)        # (B, H, Q, LP)
    ctx = torch.einsum('bhqp,bhqpd->bhqd', wts, taps)
    return dict(hb=hb, off=off, taps=(lo, hi, wl, wh), tv=taps, a=a, wts=wts,
                ctx=ctx)


def _gates(z0, st, o):
    """z0 + bf16(h) . W_hh + bf16(ctx) . ctx_w3 (B, Q, 4R)."""
    return (z0 + st['hb'] @ o['w_hh']
            + torch.einsum('bhqd,hdr->bqr', bf16(st['ctx']), o['ctx_w3']))


def _setup(names, args, temporal_shapes, table):
    o = rounded_operands(dict(zip(names, args)))
    o['ab'] = torch.as_tensor(o['ab'], dtype=torch.float32,
                              device=o['value_t'].device)
    P = o['scale_t'].shape[-1] // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, o['value_t'].device)
    vw = o['value_t'] @ o['cw'] if table else None
    return o, hib, s0, vw


def greedy_scan(value_t, base_pos, scale_t, const_z, embed, token_w, logit_w,
                logit_b, off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3,
                w_hh, temporal_shapes, K, with_margin=False, table=False):
    """The K-step greedy decode with bf16 operands (K6-bf16's plain
    version; ``table=True``: the card kernel's table form).  Returns (tok,
    lp), each (B, K, Q), and with ``with_margin`` each step's top-2 logit
    margin (B, K, Q)."""
    o, hib, s0, vw = _setup(
        ('value_t', 'base_pos', 'scale_t', 'off_w_h', 'h2att_w', 'h2att_b',
         'cw', 'cb', 'aw', 'ab', 'ctx_w3', 'w_hh'),
        (value_t, base_pos, scale_t, off_w_h, h2att_w, h2att_b, cw, cb, aw,
         ab, ctx_w3, w_hh), temporal_shapes, table)
    tw = mm(embed, token_w)                                   # (V+1, 4R)
    lw = bf16(logit_w)
    B, Q = const_z.shape[:2]
    R = w_hh.shape[0]
    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    it = torch.zeros((B, Q), dtype=torch.long, device=value_t.device)
    toks, lps, margins = [], [], []
    for _ in range(K):
        st = attend(h, o, hib, s0, vw)
        h, c = lstm_cell(_gates(const_z + tw[it], st, o), c)
        logits = bf16(h) @ lw + logit_b
        it, lp = greedy_pick(logits)
        toks.append(it.to(torch.int32))
        lps.append(lp)
        if with_margin:
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append(top2[..., 0] - top2[..., 1])
    out = (torch.stack(toks, 1), torch.stack(lps, 1))
    return out + (torch.stack(margins, 1),) if with_margin else out


def scan_fwd(*args, table=False):
    """(hs, cs), each (B, K, Q, R), of the teacher-forcing scan with bf16
    operands (K4-bf16's plain version; ``table=True``: the card kernel's
    table form).  ``args`` = the 13 operands (``dsa_scan.NAMES``),
    temporal_shapes."""
    from .dsa_scan import NAMES
    *ops, temporal_shapes = args
    o, hib, s0, vw = _setup(NAMES, ops, temporal_shapes, table)
    z_all = o['z_all']
    B, K, Q = z_all.shape[:3]
    R = o['w_hh'].shape[0]
    h = z_all.new_zeros((B, Q, R))
    c = z_all.new_zeros((B, Q, R))
    hs, cs = [], []
    for k in range(K):
        h, c = lstm_cell(_gates(z_all[:, k], attend(h, o, hib, s0, vw), o), c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


def cell_bwd(z, c_prev, gh, gc):
    """Backward of the bias-free LSTM cell from its preactivation z
    (..., 4R) and c_prev: (dz, dc_prev) (the JAX ``_lstm_cell_bwd``)."""
    zi, zf, zg, zo = z.chunk(4, dim=-1)
    si, sf, so = torch.sigmoid(zi), torch.sigmoid(zf), torch.sigmoid(zo)
    tg = torch.tanh(zg)
    th = torch.tanh(sf * c_prev + si * tg)
    dc_tot = gc + gh * so * (1.0 - th * th)
    dz = torch.cat([dc_tot * tg * si * (1.0 - si),
                    dc_tot * c_prev * sf * (1.0 - sf),
                    dc_tot * si * (1.0 - tg * tg),
                    gh * th * so * (1.0 - so)], -1)
    return dz, dc_tot * sf


def scan_bwd(*args, table=False):
    """The 13 gradients of :func:`scan_fwd` for the cotangent g of hs, as
    the TPU kernel's bf16 backward computes them (a reverse-time scan that
    recomputes each step from (h_{k-1}, c_{k-1}); ``table=True``: the card
    kernel's table form).  ``args`` = the 13 operands, temporal_shapes, hs,
    cs, g.  Returns the gradients in the operands' order."""
    from .dsa_scan import NAMES
    *ops, temporal_shapes, hs, cs, g = args
    ab_shape = torch.as_tensor(ops[10]).shape
    o, hib, s0, vw = _setup(NAMES, ops, temporal_shapes, table)
    v, z_all = o['value_t'], o['z_all']
    B, H, S, Dh = v.shape
    K, Q = z_all.shape[1:3]
    R, A = o['h2att_w'].shape
    LP = o['scale_t'].shape[-1]
    hs_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
    cs_prev = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], 1)
    zeros = v.new_zeros
    dvalue, G = zeros(B, H, S, Dh), zeros(B, H, S, A)
    dbase, dscale = zeros(B, H, Q, LP), zeros(B, Q, LP)
    dz_all = zeros(B, K, Q, 4 * R)
    doffw, dh2w, dcw = zeros(H, R, LP), zeros(R, A), zeros(Dh, A)
    dcb, daw, dab = zeros(A), zeros(A), zeros(())
    dcw3, dwhh = zeros(H, Dh, 4 * R), zeros(R, 4 * R)
    dh, dc = zeros(B, Q, R), zeros(B, Q, R)
    for k in reversed(range(K)):
        st = attend(hs_prev[:, k], o, hib, s0, vw)
        hb, ctxb = st['hb'], bf16(st['ctx'])
        lo, hi, wl, wh = st['taps']
        dz, dc = cell_bwd(_gates(z_all[:, k], st, o), cs_prev[:, k],
                          g[:, k] + dh, dc)
        dz_all[:, k] = dz
        dzb = bf16(dz)
        dwhh += hb.reshape(-1, R).T @ dzb.reshape(-1, 4 * R)
        dh = dzb @ o['w_hh'].T
        dctx = torch.einsum('bqr,hdr->bhqd', dzb, o['ctx_w3'])
        dcw3 += torch.einsum('bhqd,bqr->hdr', ctxb, dzb)
        # attention backward (ctx = sum_p wts_p taps_p)
        wts, a, taps = st['wts'], st['a'], st['tv']
        dwts = (taps * dctx[:, :, :, None]).sum(-1)           # (B, H, Q, LP)
        ddot = wts * (dwts - (wts * dwts).sum(-1, keepdim=True))
        du = ddot[..., None] * o['aw'] * (1.0 - a * a)        # (B,H,Q,LP,A)
        dub = bf16(du)
        dtaps = wts[..., None] * dctx[:, :, :, None]          # (B,H,Q,LP,Dh)
        vdiff = _gather(v, hi) - _gather(v, lo)
        if table:
            # the context's term and the scores' term apart: dvalue gets
            # the lerp-scatter of bf16(wts dctx) now and bf16(G) . Wc^T at
            # the end; dpos the scores' term from the table's rows
            tb = bf16(dtaps)
            dpos = (dtaps * vdiff).sum(-1) + (
                dub * (_gather(vw, hi) - _gather(vw, lo))).sum(-1)
            _scatter(G, lo, wl[..., None] * dub)
            _scatter(G, hi, wh[..., None] * dub)
        else:
            dtaps = dtaps + dub @ o['cw'].T
            dcw += bf16(taps).reshape(-1, Dh).T @ dub.reshape(-1, A)
            tb = bf16(dtaps)
            dpos = (dtaps * vdiff).sum(-1)
        _scatter(dvalue, lo, wl[..., None] * tb)
        _scatter(dvalue, hi, wh[..., None] * tb)
        dhvec = bf16(du.sum((1, 3)))                          # (B, Q, A)
        dcb += du.sum((0, 1, 2, 3))
        daw += (a * ddot[..., None]).sum((0, 1, 2, 3))
        dab += ddot.sum()
        dh = dh + dhvec @ o['h2att_w'].T
        dh2w += hb.reshape(-1, R).T @ dhvec.reshape(-1, A)
        # sampling backward: pos = base_pos + off * scale_t
        dbase += dpos
        dscale += (dpos * st['off']).sum(1)
        doff = bf16(dpos * o['scale_t'][:, None])             # (B, H, Q, LP)
        dh = dh + torch.einsum('bhqp,hrp->bqr', doff, o['off_w_h'])
        doffw += torch.einsum('bqr,bhqp->hrp', hb, doff)
    if table:
        dvalue += bf16(G) @ o['cw'].T
        dcw = v.reshape(-1, Dh).T @ bf16(G).reshape(-1, A)
    return (dvalue, dbase, dscale, dz_all, doffw, dh2w, dcb.clone(), dcw, dcb,
            daw, dab.reshape(ab_shape), dcw3, dwhh)


class PlainScanBf16(torch.autograd.Function):
    """The bf16 scan on the CPU: forward :func:`scan_fwd`, backward
    :func:`scan_bwd` (the TPU kernel's bf16 backward, which autograd
    through the forward's roundings would not give); the last argument is
    the level table."""

    @staticmethod
    def forward(ctx, *args):
        *ops, temporal_shapes = args
        hs, cs = scan_fwd(*ops, temporal_shapes)
        ctx.temporal_shapes = temporal_shapes
        ctx.save_for_backward(*ops, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        *ops, hs, cs = ctx.saved_tensors
        return (*scan_bwd(*ops, ctx.temporal_shapes, hs, cs, g), None)
