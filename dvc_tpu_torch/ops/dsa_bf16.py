"""Plain bf16-operand versions of the caption kernels K4-K10: the greedy
decode, the teacher-forcing scan's forward and backward, and one word step
of the stepwise path (sampling and attention, K7/K8; with the LSTM cell,
K9/K10) with its backward, as the JAX package's Pallas kernels compute them
under ``--tpu_compute_dtype bfloat16``.

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

The word steps (``dsa_step.py``'s ``_make_fwd_kernel`` to
``_make_lstm_bwd_kernel``) take hvec and the positions from f32 products
outside the kernel and return ctx (K7), dhvec and dpos to such products,
so those stay unrounded; inside, the taps, the scores, h . W_hh, ctx .
ctx_w3 and, in the backward, du . Wc^T, taps^T du, M^T dtaps, dz . W_hh^T,
h^T dz, dz . ctx_w3^T and ctx^T dz take bf16 operands.

``table=True`` mirrors the card's table-form kernels instead
(``csrc/dsa_greedy.cu``, ``csrc/dsa_scan.cu``, K9/K10 of
``csrc/dsa_step.cu`` in their bf16-operand mode; K7-bf16 and K8-bf16
compute the product form itself),
which score a tap as the lerp of two rows of the table bf16(value) .
bf16(Wc) and so never round the lerped taps; their backward forms dvalue's
scores term as bf16(G) . bf16(Wc)^T and dWc as bf16(value)^T bf16(G), G
the lerp-scatter of bf16(du).  The tests measure the gap between the two
forms.  :class:`PlainWordStepBf16` joins a word step's forward and backward
for autograd on the CPU.

Arguments and returns are those of :func:`dvc_tpu_torch.ops.dsa_greedy.
dsa_greedy_scan_ref`, :mod:`dvc_tpu_torch.ops.dsa_scan` and
:mod:`dvc_tpu_torch.ops.dsa_step`.
"""

from __future__ import annotations

import torch

from .dsa_greedy import _level_bounds, greedy_pick, lstm_cell

# the operands that enter only products: rounded to bf16 once
ROUNDED = ('value_t', 'off_w_h', 'h2att_w', 'cw', 'ctx_w3', 'w_hh')


def bf16(x):
    """x rounded to bf16 (to nearest even), as f32."""
    return x.to(torch.bfloat16).to(torch.float32)


def bf16_operand(x):
    """x rounded to bf16 as a contiguous torch.bfloat16 tensor, its data
    16-byte aligned: an operand that the kernels' GEMMs read in bf16 (one
    device activity where x is f32; a bf16 x that is contiguous and aligned
    as it is)."""
    y = x.to(torch.bfloat16).contiguous()
    return y.clone() if y.data_ptr() % 16 else y


def shifted_bf16(hs):
    """hs (B, K, Q, R) one step later in bf16: zeros at step 0, then
    hs[:, :-1] rounded (the h_{k-1} that K5-bf16 recomputes step k from and
    its outer sums read); contiguous and 16-byte aligned (two device
    activities)."""
    out = torch.empty(hs.shape, dtype=torch.bfloat16, device=hs.device)
    out[:, 0].zero_()
    out[:, 1:].copy_(hs[:, :-1])
    return out


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


class RoundBf16(torch.autograd.Function):
    """x rounded to bf16 with the gradient passed through as it is: an
    operand that enters only the bf16-operand kernels, whose gradient with
    respect to the unrounded x is the kernel's own (as the TPU kernels
    round their operands inside).  The optional second argument is x
    already rounded, in torch.bfloat16 (it is returned as f32)."""

    @staticmethod
    def forward(ctx, x, xb=None):
        return bf16(x) if xb is None else xb.float()

    @staticmethod
    def backward(ctx, g):
        return g, None


def rounded_operands(ops):
    """The operands of a step by name with value_t and the weights of the
    step's products rounded to bf16 (``ROUNDED``)."""
    return {k: bf16(v) if k in ROUNDED else v for k, v in ops.items()}


def attend_at(o, pos, hvec, hib, s0, vw=None):
    """One word step's attention at the level-relative positions pos
    (B, H, Q, LP) with hvec (B, Q, A), bf16 operands; o the operands by
    name, value_t and cw already rounded (:func:`rounded_operands`).  vw
    (B, H, S, A), the table value_t . cw, selects the kernels' table form.
    Returns the step's intermediates: (lo, hi, wl, wh), the taps
    (B, H, Q, LP, Dh), the tanh activations a (B, H, Q, LP, A), the softmax
    weights wts and ctx (B, H, Q, Dh)."""
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
    return dict(taps=(lo, hi, wl, wh), tv=taps, a=a, wts=wts, ctx=ctx)


def attend(h, o, hib, s0, vw=None):
    """One word step's attention from the hidden state h (B, Q, R) with
    bf16 operands (hvec and the offsets are products of the step too);
    o the operands by name, value_t and the weights already rounded.
    Returns :func:`attend_at`'s intermediates and hb = bf16(h) and the
    offsets off."""
    hb = bf16(h)
    hvec = hb @ o['h2att_w'] + o['h2att_b']
    off = torch.einsum('bqr,hrp->bhqp', hb, o['off_w_h'])
    pos = o['base_pos'] + off * o['scale_t'][:, None]
    return dict(attend_at(o, pos, hvec, hib, s0, vw), hb=hb, off=off)


def attend_bwd(st, dctx, o, dvalue, vw=None, G=None):
    """Backward of :func:`attend_at` (the intermediates ``st``) for the
    cotangent dctx (B, H, Q, Dh), as the TPU kernels' bf16 backward
    (``_attn_bwd_from_g``) computes it: du . Wc^T, taps^T du and M^T dtaps
    on bf16 operands.  Adds dvalue's terms to dvalue.  With vw, the card
    kernels' table form: dvalue gets only the context's term, the
    lerp-scatter of bf16(wts dctx), and G (B, H, S, A) the lerp-scatter of
    bf16(du) (the scores' term and dWc come from G: :func:`table_bwd`).
    Returns (dpos (B, H, Q, LP), du, ddot, dWc or None)."""
    v = o['value_t']
    Dh, A = v.shape[-1], o['cb'].shape[-1]
    lo, hi, wl, wh = st['taps']
    wts, a, taps = st['wts'], st['a'], st['tv']
    dwts = (taps * dctx[:, :, :, None]).sum(-1)               # (B, H, Q, LP)
    ddot = wts * (dwts - (wts * dwts).sum(-1, keepdim=True))
    du = ddot[..., None] * o['aw'] * (1.0 - a * a)            # (B,H,Q,LP,A)
    dub = bf16(du)
    dtaps = wts[..., None] * dctx[:, :, :, None]              # (B,H,Q,LP,Dh)
    vdiff = _gather(v, hi) - _gather(v, lo)
    dcw = None
    if vw is not None:
        # the context's term and the scores' term apart: dvalue gets the
        # lerp-scatter of bf16(wts dctx) now and bf16(G) . Wc^T at the
        # end; dpos the scores' term from the table's rows
        tb = bf16(dtaps)
        dpos = (dtaps * vdiff).sum(-1) + (
            dub * (_gather(vw, hi) - _gather(vw, lo))).sum(-1)
        _scatter(G, lo, wl[..., None] * dub)
        _scatter(G, hi, wh[..., None] * dub)
    else:
        dtaps = dtaps + dub @ o['cw'].T
        dcw = bf16(taps).reshape(-1, Dh).T @ dub.reshape(-1, A)
        tb = bf16(dtaps)
        dpos = (dtaps * vdiff).sum(-1)
    _scatter(dvalue, lo, wl[..., None] * tb)
    _scatter(dvalue, hi, wh[..., None] * tb)
    return dpos, du, ddot, dcw


def table_bwd(value_t, cw, G):
    """The table VW = bf16(value_t) . bf16(cw)'s backward for its
    cotangent G: (bf16(G) . cw^T, value_t^T bf16(G)), value_t and cw
    already rounded."""
    Gb = bf16(G)
    return (Gb @ cw.T,
            value_t.reshape(-1, value_t.shape[-1]).T
            @ Gb.reshape(-1, Gb.shape[-1]))


def _gates(z0, st, o):
    """z0 + bf16(h) . W_hh + bf16(ctx) . ctx_w3 (B, Q, 4R)."""
    return (z0 + st['hb'] @ o['w_hh']
            + torch.einsum('bhqd,hdr->bqr', bf16(st['ctx']), o['ctx_w3']))


def _setup(names, args, temporal_shapes, table):
    """(the operands by name, rounded as :func:`rounded_operands`, ab a
    tensor; the tap bounds; the table vw (``table``) or None) of a step,
    the scan or the greedy decode."""
    o = rounded_operands(dict(zip(names, args)))
    dev = o['value_t'].device
    o['ab'] = torch.as_tensor(o['ab'], dtype=torch.float32, device=dev)
    LP = o['scale_t' if 'scale_t' in o else 'pos'].shape[-1]
    hib, s0 = _level_bounds(temporal_shapes, LP // len(temporal_shapes), dev)
    return o, hib, s0, (o['value_t'] @ o['cw'] if table else None)


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
        dz, dc = cell_bwd(_gates(z_all[:, k], st, o), cs_prev[:, k],
                          g[:, k] + dh, dc)
        dz_all[:, k] = dz
        dzb = bf16(dz)
        dwhh += hb.reshape(-1, R).T @ dzb.reshape(-1, 4 * R)
        dh = dzb @ o['w_hh'].T
        dctx = torch.einsum('bqr,hdr->bhqd', dzb, o['ctx_w3'])
        dcw3 += torch.einsum('bhqd,bqr->hdr', ctxb, dzb)
        # attention backward (ctx = sum_p wts_p taps_p)
        dpos, du, ddot, step_dcw = attend_bwd(st, dctx, o, dvalue, vw, G)
        if step_dcw is not None:
            dcw += step_dcw
        dhvec = bf16(du.sum((1, 3)))                          # (B, Q, A)
        dcb += du.sum((0, 1, 2, 3))
        daw += (st['a'] * ddot[..., None]).sum((0, 1, 2, 3))
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
        dx, dcw = table_bwd(v, o['cw'], G)
        dvalue += dx
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


# ----------------------------------------------------------------------------
# one word step of the stepwise path (K7-K10-bf16)
# ----------------------------------------------------------------------------

# the operands of K7/K8 and K9/K10 at the JAX boundary (cw given), as
# ``dsa_step.STEP_NAMES`` and ``LSTM_NAMES``
STEP = ('value_t', 'pos', 'hvec', 'cw', 'cb', 'aw', 'ab')
LSTM = ('value_t', 'pos', 'hvec', 'z0', 'h', 'c', 'ctx_w3', 'w_hh', 'cw',
        'cb', 'aw', 'ab')


def _word_fwd(o, hib, s0, vw):
    """The step's intermediates (:func:`attend_at`'s); with the LSTM cell
    (o has 'h') also hb = bf16(h), the gates' preactivation z and out =
    (h_new, c_new), else out = ctx."""
    st = attend_at(o, o['pos'], o['hvec'], hib, s0, vw)
    if 'h' not in o:
        return dict(st, out=st['ctx'])
    st['hb'] = bf16(o['h'])
    z = _gates(o['z0'], st, o)
    return dict(st, z=z, out=lstm_cell(z, o['c']))


def _word_bwd(o, hib, s0, vw, cot):
    """The step's gradients by operand name for the cotangent(s) cot of its
    output, as the TPU kernels' bf16 backward (with vw: the card kernels'
    table form, value_t's the context's term only and vw's G under 'vw')."""
    st = _word_fwd(o, hib, s0, vw)
    v = o['value_t']
    B, H, S, Dh = v.shape
    A = o['hvec'].shape[-1]
    d = dict(value_t=v.new_zeros(B, H, S, Dh))
    if vw is not None:
        d['vw'] = v.new_zeros(B, H, S, A)
    if 'h' in o:
        gh, gc = cot
        R = o['h'].shape[-1]
        dz, d['c'] = cell_bwd(st['z'], o['c'], gh, gc)
        dzb = bf16(dz)
        d['z0'] = dz
        d['h'] = dzb @ o['w_hh'].T
        d['w_hh'] = st['hb'].reshape(-1, R).T @ dzb.reshape(-1, 4 * R)
        d['ctx_w3'] = torch.einsum('bhqd,bqr->hdr', bf16(st['ctx']), dzb)
        dctx = torch.einsum('bqr,hdr->bhqd', dzb, o['ctx_w3'])
    else:
        dctx, = cot
    d['pos'], du, ddot, d['cw'] = attend_bwd(st, dctx, o, d['value_t'], vw,
                                             d.get('vw'))
    d['hvec'] = du.sum((1, 3))                                # f32, (B, Q, A)
    d['cb'] = du.sum((0, 1, 2, 3))
    d['aw'] = (st['a'] * ddot[..., None]).sum((0, 1, 2, 3))
    d['ab'] = ddot.sum()
    return d


def _grads(names, args, temporal_shapes, cot, table):
    ab_shape = torch.as_tensor(args[-1]).shape
    o, hib, s0, vw = _setup(names, args, temporal_shapes, table)
    d = _word_bwd(o, hib, s0, vw, cot)
    if table:
        dx, d['cw'] = table_bwd(o['value_t'], o['cw'], d.pop('vw'))
        d['value_t'] = d['value_t'] + dx
    d['ab'] = d['ab'].reshape(ab_shape)
    return tuple(d[n] for n in names)


def sample_attend_fwd(*args, table=False):
    """ctx (B, H, Q, Dh) of one word step's sampling and attention with bf16
    operands (K7-bf16's plain version, the form it computes; ``table=True``:
    the table form, K9/K10-bf16's).  ``args`` = the 7 operands (``STEP``),
    temporal_shapes."""
    *ops, temporal_shapes = args
    return _word_fwd(*_setup(STEP, ops, temporal_shapes, table))['out']


def sample_attend_bwd(*args, table=False):
    """The 7 gradients of :func:`sample_attend_fwd` for the cotangent g of
    ctx (K8-bf16's plain version).  ``args`` = the 7 operands,
    temporal_shapes, g.  Returns the gradients in the operands' order."""
    *ops, temporal_shapes, g = args
    return _grads(STEP, ops, temporal_shapes, (g,), table)


def lstm_step_fwd(*args, table=False):
    """(h_new, c_new), each (B, Q, R), of one fused word step with bf16
    operands (K9-bf16's plain version).  ``args`` = the 12 operands
    (``LSTM``), temporal_shapes."""
    *ops, temporal_shapes = args
    return _word_fwd(*_setup(LSTM, ops, temporal_shapes, table))['out']


def lstm_step_bwd(*args, table=False):
    """The 12 gradients of :func:`lstm_step_fwd` for the cotangents gh, gc
    of (h_new, c_new) (K10-bf16's plain version).  ``args`` = the 12
    operands, temporal_shapes, gh, gc."""
    *ops, temporal_shapes, gh, gc = args
    return _grads(LSTM, ops, temporal_shapes, (gh, gc), table)


class PlainWordStepBf16(torch.autograd.Function):
    """A bf16 word step on the CPU, over the operands at the JAX boundary
    (``STEP`` or ``LSTM``, cw given): forward and backward of the plain
    bf16 product form, which the tests hold to JAX.  The backward is K8's
    or K10's bf16 one, which autograd through the forward's roundings would
    not give.  The last argument is the level table."""

    @staticmethod
    def forward(ctx, *args):
        *ops, temporal_shapes = args
        ctx.temporal_shapes = temporal_shapes
        ctx.save_for_backward(*ops)
        fwd = lstm_step_fwd if len(ops) == len(LSTM) else sample_attend_fwd
        return fwd(*ops, temporal_shapes)

    @staticmethod
    def backward(ctx, *cot):
        bwd = (lstm_step_bwd if len(ctx.saved_tensors) == len(LSTM)
               else sample_attend_bwd)
        return (*bwd(*ctx.saved_tensors, ctx.temporal_shapes, *cot), None)
