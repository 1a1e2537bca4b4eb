"""One word step of the LSTM-DSA caption head, for the stepwise caption
path (port of ``dvc_tpu/ops/dsa_step.py``): tap sampling and additive
attention (the JAX ``dsa_sample_attend``), optionally with the bias-free
LSTM cell (``dsa_lstm_step``), each with its backward.

* :func:`dsa_sample_attend_ref` / :func:`dsa_lstm_step_ref` — the plain
  versions with the JAX signatures (value (B, S, H, Dh), offsets
  (B, Q, H, L, P), ref_center / offset_scale (B, Q, L), ...), which the
  parity tests hold against the JAX ops.
* :func:`sample_attend_ref` / :func:`lstm_step_ref` — the plain versions at
  the kernels' boundary, which the JAX package's custom VJPs also draw:
  value_t (B, H, S, Dh) head-major, pos (B, H, Q, LP) level-relative f32
  positions (``level_pos``), hvec (B, Q, A), cw (Dh, A), cb (A,), aw (A,),
  ab a 0-d tensor; the LSTM step adds z0 (B, Q, 4R), h and c (B, Q, R),
  ctx_w3 (H, Dh, 4R) and w_hh (R, 4R).  Their backwards are autograd
  through them (:func:`sample_attend_bwd_ref`, :func:`lstm_step_bwd_ref`).
* :func:`sample_attend_table_ref` / :func:`lstm_step_table_ref` — the same
  in the kernels' table form: vw = value_t . cw (B, H, S, A) in place of
  cw, each tap's scores a lerp of two vw rows.  The caption head builds vw
  once per forward pass (:func:`dvc_tpu_torch.ops.dsa_tables.dsa_value_table`),
  so a step's gradient with respect to vw, G, is summed over the word
  steps before the table's backward turns it into value_t's and cw's.
* :func:`dsa_sample_attend_table_core` / :func:`dsa_lstm_step_table_core`
  — the differentiable wrappers the caption head calls: CUDA tensors go to
  the autograd Functions over the hand-written kernels of
  ``csrc/dsa_step.cu`` (K7 ``dvc_dsa_step_fwd``, K8 ``dvc_dsa_step_bwd``,
  K9 ``dvc_dsa_lstm_fwd``, K10 ``dvc_dsa_lstm_bwd``); CPU tensors go to the
  plain table-form versions.  :func:`dsa_sample_attend_core` /
  :func:`dsa_lstm_step_core` are the steps at the JAX boundary (cw given):
  the table, then the kernels, on the card; ``sample_attend_ref`` /
  ``lstm_step_ref`` on the CPU.
* :func:`dsa_sample_attend_fwd` and the other three — the kernels alone,
  with vw given (K7-bf16 and K8-bf16: value16 and the Wc pack): they take
  CUDA tensors only and count their launches.
  :func:`dsa_sample_attend_grads` / :func:`dsa_lstm_step_grads` compose
  the table, K8 or K10 and the table's backward into the 7 or 12
  gradients at the JAX boundary (K8-bf16 returns them itself).

The sampling and attention arithmetic is the greedy decode's and the scan's
(:func:`dvc_tpu_torch.ops.dsa_greedy.attend`).

``precision='bfloat16'`` (``--tpu_compute_dtype bfloat16`` on the stepwise
path) is the TPU kernels' bf16 variant: every in-kernel product on
bf16-rounded operands with f32 accumulation; hvec, the positions and what
the step returns meet f32 products outside.  On CPU tensors the ``*_core``
wrappers (cw given) run its plain version,
:class:`~dvc_tpu_torch.ops.dsa_bf16.PlainWordStepBf16` (the TPU kernels'
product form, which rounds its operands itself); the ``*_table_core``
wrappers (vw given) have no CPU bf16 form.  On the card the kernels run in
their bf16 mode, counted apart in ``launches_bf16``:

* K7-bf16 and K8-bf16 compute the product form itself on the tensor cores,
  with no table and no G: they take value_t in bf16 (``value16``, a
  torch.bfloat16 tensor) in place of value_t, no vw, and ``pack`` =
  :func:`pack_attend_weights` (cw), Wc in bf16 in fragment order, which
  they require; K8-bf16 returns the JAX kernel's seven gradients, dcw
  among them.  The caption head rounds value_t and packs Wc once per
  forward pass, :class:`DSASampleAttendFunction` hands both to K7-bf16 and
  to K8-bf16, and ``dsa_sample_attend_core`` / ``dsa_sample_attend_grads``
  make them once a call where they are not given.
  :func:`dsa_sample_attend_table_core` refuses bf16.
* K9-bf16 and K10-bf16 keep the table form, on the table's bf16 mode and
  value_t rounded to bf16 by the caller (the caption head once per forward
  pass, :class:`~dvc_tpu_torch.ops.dsa_bf16.RoundBf16`; the JAX-boundary
  wrappers in each call); their gate products run on the tensor cores from
  ``pack``, the gate weights packed in bf16
  (:func:`~dvc_tpu_torch.ops.dsa_scan.pack_gate_weights` (w_hh, ctx_w3)),
  which they require, in place of ctx_w3 and w_hh (then unread): the
  caption head packs once per forward pass, :class:`DSALSTMStepFunction`
  hands the forward's pack to the backward, and the JAX-boundary wrappers
  pack once per call.

The f32 kernels refuse a pack.
"""

from __future__ import annotations

import torch

from . import _cuda, dsa_bf16
from .dsa_greedy import _level_bounds, attend, check_precision, lstm_cell
from .dsa_scan import (_ptr, _tile_product, gate_geometry, hidden_geometry,
                       pack_gate_weights, pack_hidden_weights,
                       unpack_hidden_weights)
from .dsa_tables import dsa_value_table, table_gemm, table_gemm_bwd

STEP_NAMES = ('value_t', 'pos', 'hvec', 'cw', 'cb', 'aw', 'ab')
# the operands of K7 and K8 (and of sample_attend_table_ref)
STEP_TABLE_NAMES = ('value_t', 'vw', 'pos', 'hvec', 'cb', 'aw', 'ab')
LSTM_NAMES = ('value_t', 'pos', 'hvec', 'z0', 'h', 'c', 'ctx_w3', 'w_hh',
              'cw', 'cb', 'aw', 'ab')
# the operands of K9 and K10 (and of lstm_step_table_ref)
LSTM_TABLE_NAMES = ('value_t', 'vw', 'pos', 'hvec', 'z0', 'h', 'c', 'ctx_w3',
                    'w_hh', 'cb', 'aw', 'ab')


def level_pos(loc, temporal_shapes):
    """loc (B, Q, H, L, P) normalised per-level locations -> level-relative
    positions (B, H, Q, L*P) = loc * T_l - 0.5, in f32 whatever loc's type
    (the JAX ``_level_pos``)."""
    B, Q, H, L, P = loc.shape
    t = torch.tensor(temporal_shapes, dtype=torch.float32, device=loc.device)
    pos = loc.float() * t[:, None] - 0.5
    return pos.permute(0, 2, 1, 3, 4).reshape(B, H, Q, L * P)


def _jax_boundary(value, offsets, ref_center, offset_scale, temporal_shapes):
    """(value_t, pos) of the JAX signature's operands."""
    loc = (ref_center[:, :, None, :, None]
           + offsets * offset_scale[:, :, None, :, None])
    return value.permute(0, 2, 1, 3), level_pos(loc, temporal_shapes)


# ----------------------------------------------------------------------------
# plain versions
# ----------------------------------------------------------------------------

def sample_attend_ref(value_t, pos, hvec, cw, cb, aw, ab, temporal_shapes):
    """Plain K7: ctx (B, H, Q, Dh)."""
    sample_attend_ref.calls += 1
    hib, s0 = _level_bounds(temporal_shapes,
                            pos.shape[-1] // len(temporal_shapes),
                            value_t.device)
    return attend(value_t, pos, hvec, cw, cb, aw, ab, hib, s0)


sample_attend_ref.calls = 0


def lstm_step_ref(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw, ab,
                  temporal_shapes):
    """Plain K9: (h_new, c_new), each (B, Q, R), of the cell on
    z = z0 + h w_hh + ctx ctx_w3."""
    lstm_step_ref.calls += 1
    hib, s0 = _level_bounds(temporal_shapes,
                            pos.shape[-1] // len(temporal_shapes),
                            value_t.device)
    ctx = attend(value_t, pos, hvec, cw, cb, aw, ab, hib, s0)
    z = z0 + h @ w_hh + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3)
    return lstm_cell(z, c)


lstm_step_ref.calls = 0


def _lerp_rows(table, pos, hib, s0):
    """The border-mode lerp of two rows of table (B, H, S, W) at each
    level-relative position of pos (B, H, Q, LP), as ``attend`` forms its
    taps: (B, H, Q, LP, W)."""
    B, H, S, W = table.shape
    Q, LP = pos.shape[2], pos.shape[3]
    zero = torch.zeros((), device=table.device)
    i_lo = torch.floor(pos)
    w_hi = pos - i_lo
    idx_lo = torch.minimum(torch.maximum(i_lo, zero), hib).long() + s0
    idx_hi = torch.minimum(torch.maximum(i_lo + 1.0, zero), hib).long() + s0

    def gather(idx):
        i = idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, W)
        return torch.gather(table, 2, i).reshape(B, H, Q, LP, W)

    return (1.0 - w_hi)[..., None] * gather(idx_lo) \
        + w_hi[..., None] * gather(idx_hi)


def _attend_table(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes):
    """ctx (B, H, Q, Dh) of one step with a tap's scores tanh(lerp of two
    vw rows + cb + hvec) . aw + ab."""
    hib, s0 = _level_bounds(temporal_shapes,
                            pos.shape[-1] // len(temporal_shapes),
                            value_t.device)
    u = torch.tanh(_lerp_rows(vw, pos, hib, s0) + cb
                   + hvec[:, None, :, None, :])
    wts = torch.softmax(u @ aw + ab, dim=-1)                  # (B, H, Q, LP)
    return torch.einsum('bhqp,bhqpd->bhqd', wts,
                        _lerp_rows(value_t, pos, hib, s0))


def sample_attend_table_ref(value_t, vw, pos, hvec, cb, aw, ab,
                            temporal_shapes):
    """Plain K7 in the table form: :func:`sample_attend_ref` with the table
    vw = value_t . cw (B, H, S, A) in place of cw.  Returns ctx
    (B, H, Q, Dh).  Autograd through it gives K8's gradients: value_t's is
    the context's term only, vw's is G."""
    sample_attend_table_ref.calls += 1
    return _attend_table(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes)


sample_attend_table_ref.calls = 0


def lstm_step_table_ref(value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh, cb,
                        aw, ab, temporal_shapes):
    """Plain K9 in the table form: :func:`lstm_step_ref` with the table
    vw = value_t . cw (B, H, S, A) in place of cw.  Returns (h_new,
    c_new).  Autograd through it gives K10's gradients: value_t's is the
    context's term only, vw's is G."""
    lstm_step_table_ref.calls += 1
    ctx = _attend_table(value_t, vw, pos, hvec, cb, aw, ab, temporal_shapes)
    z = z0 + h @ w_hh + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3)
    return lstm_cell(z, c)


lstm_step_table_ref.calls = 0


def _grads_ref(fn, ops, temporal_shapes, cotangents):
    with torch.enable_grad():
        ops = [torch.as_tensor(t).detach().requires_grad_() for t in ops]
        outs = fn(*ops, temporal_shapes)
        outs = outs if isinstance(outs, tuple) else (outs,)
        return torch.autograd.grad(outs, ops, cotangents)


def sample_attend_bwd_ref(*args):
    """Plain K8: autograd through :func:`sample_attend_ref`.  ``args`` = the
    7 operands, temporal_shapes, g (B, H, Q, Dh).  Returns the 7 gradients
    in argument order."""
    *ops, temporal_shapes, g = args
    return _grads_ref(sample_attend_ref, ops, temporal_shapes, (g,))


def sample_attend_table_bwd_ref(*args):
    """Plain K8: autograd through :func:`sample_attend_table_ref`.  ``args``
    = its 7 operands, temporal_shapes, g.  Returns the 7 gradients."""
    *ops, temporal_shapes, g = args
    return _grads_ref(sample_attend_table_ref, ops, temporal_shapes, (g,))


def lstm_step_bwd_ref(*args):
    """Plain K10: autograd through :func:`lstm_step_ref`.  ``args`` = the 12
    operands, temporal_shapes, gh, gc.  Returns the 12 gradients."""
    *ops, temporal_shapes, gh, gc = args
    return _grads_ref(lstm_step_ref, ops, temporal_shapes, (gh, gc))


def lstm_step_table_bwd_ref(*args):
    """Plain K10: autograd through :func:`lstm_step_table_ref`.  ``args`` =
    its 12 operands, temporal_shapes, gh, gc.  Returns the 12 gradients."""
    *ops, temporal_shapes, gh, gc = args
    return _grads_ref(lstm_step_table_ref, ops, temporal_shapes, (gh, gc))


def dsa_sample_attend_ref(value, offsets, ref_center, offset_scale, hvec,
                          ctx_w, ctx_b, alpha_w, alpha_b, temporal_shapes):
    """The JAX ``dsa_sample_attend_ref``: value (B, S, H, Dh); offsets
    (B, Q, H, L, P); ref_center / offset_scale (B, Q, L); hvec (B, Q, A);
    ctx_w (Dh, A); ctx_b, alpha_w (A,); alpha_b ().  Returns ctx
    (B, Q, H, Dh)."""
    value_t, pos = _jax_boundary(value, offsets, ref_center, offset_scale,
                                 temporal_shapes)
    return sample_attend_ref(value_t, pos, hvec, ctx_w, ctx_b, alpha_w,
                             alpha_b, temporal_shapes).permute(0, 2, 1, 3)


def dsa_lstm_step_ref(value, offsets, ref_center, offset_scale, hvec, z0, h,
                      c, ctx_w, w_hh, ctx2att_w, ctx2att_b, alpha_w, alpha_b,
                      temporal_shapes):
    """The JAX ``dsa_lstm_step_ref``: as :func:`dsa_sample_attend_ref` plus
    z0 (B, Q, 4R), h and c (B, Q, R), ctx_w (H*Dh, 4R), w_hh (R, 4R).
    Returns (h_new, c_new)."""
    value_t, pos = _jax_boundary(value, offsets, ref_center, offset_scale,
                                 temporal_shapes)
    H, Dh = value_t.shape[1], value_t.shape[3]
    return lstm_step_ref(value_t, pos, hvec, z0, h, c,
                         ctx_w.reshape(H, Dh, -1), w_hh, ctx2att_w, ctx2att_b,
                         alpha_w, alpha_b, temporal_shapes)


# ----------------------------------------------------------------------------
# the kernels
# ----------------------------------------------------------------------------

def _operands(names, args, temporal_shapes, unread=(), value16=False):
    """Check the operands of a kernel launch, and the limits of the
    kernels' float4 reads; returns (dims, contiguous operands with ab as a
    one-element device tensor, None for the operands ``unread``, whose
    shapes are checked but which the launch does not read).  ``value16``:
    value_t in torch.bfloat16 (K7-bf16, K8-bf16), A and Dh multiples of
    16."""
    ops = dict(zip(names, args))
    dev = ops['value_t'].device
    if dev.type != 'cuda':
        raise ValueError('the word-step kernels take CUDA tensors; the plain '
                         'versions are sample_attend_table_ref and '
                         'lstm_step_table_ref')
    ops['ab'] = torch.as_tensor(ops['ab'], dtype=torch.float32,
                                device=dev).reshape(1)
    want = {n: torch.bfloat16 if value16 and n == 'value_t' else torch.float32
            for n in ops}
    if any(t.dtype != want[n] or t.device != dev for n, t in ops.items()):
        raise TypeError('the word-step kernels take float32 tensors on one '
                        'device (K7-bf16 and K8-bf16: value_t in bfloat16)')
    B, H, S, Dh = ops['value_t'].shape
    Q, LP = ops['pos'].shape[2], ops['pos'].shape[3]
    A = ops['hvec'].shape[-1]
    R = ops['h'].shape[-1] if 'h' in ops else 0
    L = len(temporal_shapes)
    expect = {'value_t': (B, H, S, Dh), 'vw': (B, H, S, A),
              'pos': (B, H, Q, LP), 'hvec': (B, Q, A), 'cb': (A,),
              'aw': (A,), 'ab': (1,), 'z0': (B, Q, 4 * R), 'h': (B, Q, R),
              'c': (B, Q, R), 'ctx_w3': (H, Dh, 4 * R), 'w_hh': (R, 4 * R)}
    bad = [n for n, t in ops.items() if tuple(t.shape) != expect[n]]
    if bad or LP % L or sum(temporal_shapes) != S:
        raise ValueError(f'word-step kernel: inconsistent shapes of {bad}')
    if value16 and (A % 16 or Dh % 16):
        raise ValueError(f'K7-bf16/K8-bf16: A = {A} and Dh = {Dh} must be '
                         f'multiples of 16')
    if not value16 and (A > 512 or A % 4 or Dh % 4 or R % 4):
        raise ValueError(f'word-step kernel: A = {A} must be at most 512, '
                         f'and A, Dh = {Dh} and R = {R} multiples of 4')
    # the kernels read rows as float4: a view's storage offset may leave
    # them unaligned, a copy does not
    tensors = [None if n in unread else ops[n].contiguous() for n in names]
    return ((B, H, S, Dh, Q, LP, L, A, R),
            [t.clone() if t is not None and t.data_ptr() % 16 else t
             for t in tensors])


def _gate_pack(pack, rb, dims, dev):
    """The packed gate weights of a K9/K10 launch: required in bf16 (a
    flat torch.bfloat16 tensor of ``pack_gate_weights``' size on ``dev``,
    16-byte aligned), refused in f32.  Nothing is packed here."""
    if not rb:
        if pack is not None:
            raise ValueError('the f32 K9/K10 take ctx_w3 and w_hh, not a '
                             'gate pack')
        return None
    if pack is None:
        raise ValueError('K9-bf16 and K10-bf16 take the gate weights packed '
                         'once a forward pass: pack=pack_gate_weights(w_hh, '
                         'ctx_w3)')
    H, Dh, R = dims[1], dims[3], dims[8]
    Rp, KKp = gate_geometry(R, H * Dh)
    if (pack.dtype != torch.bfloat16 or pack.device != dev
            or pack.numel() != 8 * Rp * KKp or not pack.is_contiguous()
            or pack.data_ptr() % 16):
        raise ValueError(f'K9/K10-bf16: the gate pack must be a contiguous, '
                         f'16-byte aligned torch.bfloat16 tensor of '
                         f'{8 * Rp * KKp} elements on {dev} '
                         f'(pack_gate_weights)')
    return pack


# the operands that K9-bf16 and K10-bf16 read from the pack instead
_PACKED = ('ctx_w3', 'w_hh')


def attend_pack_geometry(Dh, A):
    """(elements of the Wc pack's first half, of the whole pack) for Wc
    (Dh, A): ``pack_hidden_weights``' extents of cw and of cw^T."""
    (n1, k1), (n2, k2) = hidden_geometry(Dh, A), hidden_geometry(A, Dh)
    return n1 * k1, n1 * k1 + n2 * k2


def _b_order(frags):
    """``pack_hidden_weights``' A fragments (16 bytes a lane: words a0a1,
    a2a3, a4a5, a6a7) in the kernels' B order: words 0, 2, 1, 3, so that n8
    tile 2j's two B registers come first, then 2j + 1's (its own inverse)."""
    return frags.view(torch.int32).reshape(-1, 4)[:, [0, 2, 1, 3]] \
        .reshape(-1).view(torch.bfloat16)


def pack_attend_weights(cw):
    """Wc (Dh, A) of K7-bf16 and K8-bf16, packed once a forward pass: the
    B fragments of taps . Wc (``pack_hidden_weights(cw)``: Wc^T, A rows by
    Dh terms, zero-padded to whole tiles), then those of du . Wc^T
    (``pack_hidden_weights(cw.T)``: Wc, Dh rows by A terms), in bf16, each
    lane's 16 bytes in B order (``_b_order``), one flat torch.bfloat16
    tensor (1 MB at Dh = A = 512, 128 KB at Dh = 64).  The kernels read
    tile (j, kt) of a half, lane l's 16 bytes, as the B fragments of the n8
    tiles 2j and 2j + 1 (csrc/dsa_step.cu, ``Attend16Geom``).  Seven device
    activities."""
    with torch.no_grad():       # a kernel operand: its gradient is the kernel's
        return _b_order(torch.cat([pack_hidden_weights(cw),
                                   pack_hidden_weights(cw.t())]))


def unpack_attend_weights(pack, Dh, A):
    """(Wc^T (A, Dh), Wc (Dh, A)) in bf16 from ``pack_attend_weights``'
    output (the inverse of the fragment order, the padding dropped)."""
    first, _ = attend_pack_geometry(Dh, A)
    frags = _b_order(pack)
    return (unpack_hidden_weights(frags[:first], Dh, A)[:A, :Dh],
            unpack_hidden_weights(frags[first:], A, Dh)[:Dh, :A])


def attend_products_tiles(pack, taps, du, Dh, A):
    """Plain mirror of K7-bf16's and K8-bf16's products as the kernels
    address them: pre = bf16(taps) . Wc (taps (N, Dh)) and, with du (N, A),
    du . Wc^T from bf16(du), tile by tile from the pack's halves, each
    16 x 16 tile's product summed over the k-tiles in order in f32
    (``_tile_product``; the tap rows the n side, as the mma's m side holds
    them: its sums are the same).  Returns (pre (N, A), dtaps (N, Dh) or
    None)."""
    first, _ = attend_pack_geometry(Dh, A)
    pack = _b_order(pack)
    Np, Rl = hidden_geometry(Dh, A)
    pre = torch.cat([_tile_product(pack[:first], Np, Rl, taps[i:i + 16])
                     for i in range(0, taps.shape[0], 16)], 1)[:A].T
    if du is None:
        return pre, None
    Np, Rl = hidden_geometry(A, Dh)
    dt = torch.cat([_tile_product(pack[first:], Np, Rl, du[i:i + 16])
                    for i in range(0, du.shape[0], 16)], 1)[:Dh].T
    return pre, dt


def _attend_pack(pack, rb, dims, dev):
    """The Wc pack of a K7/K8 launch: required in bf16 (a flat
    torch.bfloat16 tensor of ``pack_attend_weights``' size on ``dev``,
    16-byte aligned), refused in f32.  Nothing is packed here."""
    if not rb:
        if pack is not None:
            raise ValueError('the f32 K7/K8 take the table vw, not a Wc pack')
        return None
    if pack is None:
        raise ValueError('K7-bf16 and K8-bf16 take Wc packed once a forward '
                         'pass: pack=pack_attend_weights(cw)')
    Dh, A = dims[3], dims[7]
    _, n = attend_pack_geometry(Dh, A)
    if (pack.dtype != torch.bfloat16 or pack.device != dev
            or pack.numel() != n or not pack.is_contiguous()
            or pack.data_ptr() % 16):
        raise ValueError(f'K7/K8-bf16: the Wc pack must be a contiguous, '
                         f'16-byte aligned torch.bfloat16 tensor of {n} '
                         f'elements on {dev} (pack_attend_weights)')
    return pack


def _step_operands(rb, value_t, vw, rest, temporal_shapes, pack):
    """(dims, the launch's operands value_t, vw, pos, hvec, cb, aw, ab (vw
    None in bf16), the Wc pack or None) of K7/K8: f32 the table vw, bf16
    value_t in torch.bfloat16 and the pack in its place."""
    if not rb:
        dims, ops = _operands(STEP_TABLE_NAMES, (value_t, vw, *rest),
                              temporal_shapes)
        return dims, ops, _attend_pack(pack, rb, dims, ops[0].device)
    if vw is not None:
        raise ValueError('K7-bf16 and K8-bf16 take value_t in bf16 and the '
                         'Wc pack (pack_attend_weights), not the table vw')
    dims, ops = _operands(STEP_NAMES[:3] + STEP_NAMES[4:], (value_t, *rest),
                          temporal_shapes, value16=True)
    return dims, [ops[0], None] + ops[1:], _attend_pack(pack, rb, dims,
                                                        ops[0].device)


def _zeros(dev, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def dsa_sample_attend_fwd(value_t, vw, pos, hvec, cb, aw, ab,
                          temporal_shapes, precision='float32', pack=None):
    """ctx (B, H, Q, Dh) by the kernel ``dvc_dsa_step_fwd``: K7, that of
    :func:`sample_attend_table_ref` on the table vw; or K7-bf16 under
    ``precision='bfloat16'``, the TPU kernel's product form
    (``dsa_bf16.sample_attend_fwd``) on value_t given in torch.bfloat16,
    with vw None and ``pack`` = :func:`pack_attend_weights` (cw),
    required.  Or an error."""
    rb = check_precision(precision)
    dims, ops, pack = _step_operands(rb, value_t, vw, (pos, hvec, cb, aw, ab),
                                     temporal_shapes, pack)
    B, H, S, Dh, Q, LP, L, A, _ = dims
    dev = ops[0].device
    ctx = _empty(dev, B, H, Q, Dh)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_step_fwd(
        *map(_ptr, ops[:2]), _ptr(pack), *map(_ptr, ops[2:]),
        _cuda.levels_array(temporal_shapes), ctx.data_ptr(), B, H, S, Dh, Q,
        LP, L, A, int(rb), _cuda.stream_ptr(dev)), 'dvc_dsa_step_fwd')
    _cuda.count_launch(dsa_sample_attend_fwd, rb)
    return ctx


dsa_sample_attend_fwd.launches = 0
dsa_sample_attend_fwd.launches_bf16 = 0


def dsa_sample_attend_bwd(value_t, vw, pos, hvec, cb, aw, ab,
                          temporal_shapes, g, precision='float32', pack=None):
    """The 7 gradients of K7 for the cotangent g (B, H, Q, Dh) of ctx by the
    kernel ``dvc_dsa_step_bwd``: K8, in the order of its operands (value_t's
    the context's term only; vw's G); or K8-bf16 under
    ``precision='bfloat16'`` (operands as K7-bf16's), the JAX kernel's
    seven, in the order of ``STEP_NAMES`` (the whole dvalue, dpos, dhvec,
    dcw, dcb, d alpha_w, d alpha_b), with dcw summed in the kernel's blocks
    (a warp's share, Dh x A / 16 warps, in 64 registers a thread: Dh <= 64,
    A <= 512) or by the GEMM's outer sum of the bf16 rows of the taps and
    of du that it writes (the library's rule, ``dvc_dsa_step_dcw_rows``).
    Or an error."""
    rb = check_precision(precision)
    ab_shape = torch.as_tensor(ab).shape
    dims, ops, pack = _step_operands(rb, value_t, vw, (pos, hvec, cb, aw, ab),
                                     temporal_shapes, pack)
    B, H, S, Dh, Q, LP, L, A, _ = dims
    dev = ops[0].device
    if tuple(g.shape) != (B, H, Q, Dh):
        raise ValueError('word-step kernel: g must be (B, H, Q, Dh)')
    g = g.to(torch.float32).contiguous()
    dvalue, dpos, dhvec = (_zeros(dev, B, H, S, Dh), _empty(dev, B, H, Q, LP),
                           _empty(dev, B, Q, A))
    dcb, daw, dab = _zeros(dev, A), _zeros(dev, A), _zeros(dev, 1)
    G = dcw = rows_t = rows_u = work = None
    if not rb:
        G = _zeros(dev, B, H, S, A)
    else:
        dcw = _zeros(dev, Dh, A)
        if _cuda.lib().cdll.dvc_dsa_step_dcw_rows(Dh, A):
            N = B * Q * H * LP
            rows_t = torch.empty((N, Dh), dtype=torch.bfloat16, device=dev)
            rows_u = torch.empty((N, A), dtype=torch.bfloat16, device=dev)
            work = _cuda.gemm_work(dev, (Dh, A, N))
    _cuda.check(_cuda.lib().cdll.dvc_dsa_step_bwd(
        *map(_ptr, ops[:2]), _ptr(pack), *map(_ptr, ops[2:]), g.data_ptr(),
        _cuda.levels_array(temporal_shapes),
        *map(_ptr, (dvalue, G, dpos, dhvec, dcw, dcb, daw, dab, rows_t,
                    rows_u, work)),
        B, H, S, Dh, Q, LP, L, A, 0 if work is None else work.numel(),
        int(rb), _cuda.stream_ptr(dev)), 'dvc_dsa_step_bwd')
    _cuda.count_launch(dsa_sample_attend_bwd, rb)
    dab = dab.reshape(ab_shape)
    if rb:
        return dvalue, dpos, dhvec, dcw, dcb, daw, dab
    return dvalue, G, dpos, dhvec, dcb, daw, dab


dsa_sample_attend_bwd.launches = 0
dsa_sample_attend_bwd.launches_bf16 = 0


def dsa_lstm_step_fwd(value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh, cb,
                      aw, ab, temporal_shapes, precision='float32',
                      pack=None):
    """(h_new, c_new) of :func:`lstm_step_table_ref` by the kernel
    ``dvc_dsa_lstm_fwd`` (K9, or K9-bf16 under ``precision='bfloat16'``:
    value_t rounded to bf16 by the caller, vw the table's bf16 mode, and
    ``pack`` = ``pack_gate_weights(w_hh, ctx_w3)``, required, whose P^T
    half it reads in place of ctx_w3 and w_hh), or an error."""
    rb = check_precision(precision)
    dims, ops = _operands(LSTM_TABLE_NAMES, (value_t, vw, pos, hvec, z0, h, c,
                                             ctx_w3, w_hh, cb, aw, ab),
                          temporal_shapes, _PACKED if rb else ())
    B, H, S, Dh, Q, LP, L, A, R = dims
    dev = ops[0].device
    pack = _gate_pack(pack, rb, dims, dev)
    h_new, c_new = _empty(dev, B, Q, R), _empty(dev, B, Q, R)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_lstm_fwd(
        *map(_ptr, ops[:9]), _ptr(pack), *map(_ptr, ops[9:]),
        _cuda.levels_array(temporal_shapes),
        h_new.data_ptr(), c_new.data_ptr(), B, H, S, Dh, Q, LP, L, A, R,
        int(rb), _cuda.stream_ptr(dev)), 'dvc_dsa_lstm_fwd')
    _cuda.count_launch(dsa_lstm_step_fwd, rb)
    return h_new, c_new


dsa_lstm_step_fwd.launches = 0
dsa_lstm_step_fwd.launches_bf16 = 0


def dsa_lstm_step_bwd(value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh, cb,
                      aw, ab, temporal_shapes, gh, gc, precision='float32',
                      pack=None):
    """The 12 gradients of K9 for the cotangents gh, gc (B, Q, R) of
    (h_new, c_new), in the order of its operands (value_t's the context's
    term only; vw's G), by the kernel ``dvc_dsa_lstm_bwd`` (K10, or
    K10-bf16 under ``precision='bfloat16'``, operands as K9-bf16's: it
    reads both halves of ``pack``), or an error."""
    rb = check_precision(precision)
    ab_shape = torch.as_tensor(ab).shape
    dims, ops = _operands(LSTM_TABLE_NAMES, (value_t, vw, pos, hvec, z0, h, c,
                                             ctx_w3, w_hh, cb, aw, ab),
                          temporal_shapes, _PACKED if rb else ())
    B, H, S, Dh, Q, LP, L, A, R = dims
    dev = ops[0].device
    pack = _gate_pack(pack, rb, dims, dev)
    if tuple(gh.shape) != (B, Q, R) or tuple(gc.shape) != (B, Q, R):
        raise ValueError('word-step kernel: gh and gc must be (B, Q, R)')
    gh = gh.to(torch.float32).contiguous()
    gc = gc.to(torch.float32).contiguous()
    outs = (_zeros(dev, B, H, S, Dh), _zeros(dev, B, H, S, A),
            _empty(dev, B, H, Q, LP), _empty(dev, B, Q, A),
            _empty(dev, B, Q, 4 * R), _empty(dev, B, Q, R),
            _empty(dev, B, Q, R), _empty(dev, H, Dh, 4 * R),
            _empty(dev, R, 4 * R), _zeros(dev, A), _zeros(dev, A),
            _zeros(dev, 1))
    # the outer sums' split-K partial tiles
    work = _cuda.gemm_work(dev, (R, 4 * R, B * Q), (H * Dh, 4 * R, B * Q))
    # ctx's rows for the outer sum ctx^T dz: bf16 in K10-bf16
    ctx_all = torch.empty((B, Q, H * Dh), device=dev, dtype=torch.bfloat16
                          if rb else torch.float32)
    scratch = (ctx_all, work)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_lstm_bwd(
        *map(_ptr, ops[:9]), _ptr(pack), *map(_ptr, ops[9:]), gh.data_ptr(),
        gc.data_ptr(),
        _cuda.levels_array(temporal_shapes),
        *(t.data_ptr() for t in outs + scratch),
        B, H, S, Dh, Q, LP, L, A, R, work.numel(), int(rb),
        _cuda.stream_ptr(dev)), 'dvc_dsa_lstm_bwd')
    _cuda.count_launch(dsa_lstm_step_bwd, rb)
    return (*outs[:11], outs[11].reshape(ab_shape))


dsa_lstm_step_bwd.launches = 0
dsa_lstm_step_bwd.launches_bf16 = 0


def _boundary_grads(bwd, value_t, cw, *args, precision='float32', **kw):
    """(dvalue, the rest of ``bwd``'s gradients, dcw) at the JAX boundary,
    on the card: the table VW = value_t . cw (``table_gemm``), ``bwd(value_t,
    VW, *args)`` (f32 K8 or K10: value_t's context term and G first), and
    the table's backward (``table_gemm_bwd``) for value_t's scores' term and
    cw's gradient; under ``precision='bfloat16'`` (K10-bf16) each in its
    bf16 mode, on value_t rounded (``kw``: K10-bf16's gate pack)."""
    if check_precision(precision):
        value_t = dsa_bf16.bf16(value_t)
    B, H, S, Dh = value_t.shape
    rows = value_t.reshape(-1, Dh)
    vw = table_gemm(rows, cw, precision).reshape(B, H, S, -1)
    dvalue, G, *rest = bwd(value_t, vw, *args, precision=precision, **kw)
    dx, dcw = table_gemm_bwd(rows, cw, G.reshape(-1, G.shape[-1]), precision)
    return dvalue + dx.reshape(dvalue.shape), rest, dcw


def dsa_sample_attend_grads(value_t, pos, hvec, cw, cb, aw, ab,
                            temporal_shapes, g, precision='float32'):
    """The 7 gradients at the JAX boundary (the operands of
    :func:`sample_attend_ref`) for the cotangent g: f32 by the table, K8
    and the table's backward; under ``precision='bfloat16'`` by K8-bf16
    alone, on value_t rounded and Wc packed here, once a call."""
    if check_precision(precision):
        return dsa_sample_attend_bwd(
            dsa_bf16.bf16_operand(value_t), None, pos, hvec, cb, aw, ab,
            temporal_shapes, g, precision, pack=pack_attend_weights(cw))
    dvalue, rest, dcw = _boundary_grads(dsa_sample_attend_bwd, value_t, cw,
                                        pos, hvec, cb, aw, ab,
                                        temporal_shapes, g)
    return (dvalue, *rest[:2], dcw, *rest[2:])


def dsa_lstm_step_grads(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb,
                        aw, ab, temporal_shapes, gh, gc, precision='float32'):
    """The 12 gradients at the JAX boundary (the operands of
    :func:`lstm_step_ref`) for the cotangents gh, gc, by the table, K10 and
    the table's backward (each in its bf16 mode under
    ``precision='bfloat16'``, K10-bf16 on the gate weights packed here,
    once a call)."""
    pack = (pack_gate_weights(w_hh, ctx_w3) if check_precision(precision)
            else None)
    dvalue, rest, dcw = _boundary_grads(dsa_lstm_step_bwd, value_t, cw, pos,
                                        hvec, z0, h, c, ctx_w3, w_hh, cb, aw,
                                        ab, temporal_shapes, gh, gc,
                                        precision=precision, pack=pack)
    return (dvalue, *rest[:7], dcw, *rest[7:])


def _attend_kernel_ops(ops, value16):
    """The operands that K7/K8 read of DSASampleAttendFunction's: f32 its
    own (value_t, vw, ...); bf16 value16, no vw, and the rest but cw."""
    if value16 is None:
        return ops
    return (value16, None, *ops[1:3], *ops[4:])


class DSASampleAttendFunction(torch.autograd.Function):
    """K7 forward, K8 backward.  f32: over the operands of
    :func:`sample_attend_table_ref` (vw's gradient is G); bf16: over those
    of :func:`sample_attend_ref` (cw given), K7-bf16 and K8-bf16 reading in
    place of value_t and cw value16 (value_t in torch.bfloat16) and the Wc
    pack (``pack_attend_weights(cw)``), both made by the caller once a
    forward pass, which the forward hands to K7-bf16 and its backward, the
    same tensors, to K8-bf16; K8-bf16's dvalue and dcw are value_t's and
    cw's gradients.  The last arguments are the level table, the
    precision, the pack and value16 (None, None in f32)."""

    @staticmethod
    def forward(fctx, *args):
        *ops, temporal_shapes, precision, pack, value16 = args
        fctx.temporal_shapes, fctx.precision = temporal_shapes, precision
        fctx.pack, fctx.value16 = pack, value16
        fctx.save_for_backward(*ops)
        return dsa_sample_attend_fwd(
            *_attend_kernel_ops(ops, value16), temporal_shapes,
            precision=precision, pack=pack)

    @staticmethod
    def backward(fctx, g):
        return (*dsa_sample_attend_bwd(
            *_attend_kernel_ops(fctx.saved_tensors, fctx.value16),
            fctx.temporal_shapes, g, precision=fctx.precision,
            pack=fctx.pack), None, None, None, None)


class DSALSTMStepFunction(torch.autograd.Function):
    """K9 forward, K10 backward, over the operands of
    :func:`lstm_step_table_ref`; the last arguments are the level table,
    the precision and the gate pack (bf16: ``pack_gate_weights(w_hh,
    ctx_w3)``, made by the caller once a forward pass; f32: None), which
    the forward hands to K9-bf16 and its backward, the same tensor, to
    K10-bf16.  The gradients of ctx_w3 and w_hh are K10's outer sums; the
    pack, a kernel operand, has none."""

    @staticmethod
    def forward(fctx, *args):
        *ops, temporal_shapes, precision, pack = args
        fctx.temporal_shapes, fctx.precision = temporal_shapes, precision
        fctx.pack = pack
        fctx.save_for_backward(*ops)
        return dsa_lstm_step_fwd(*ops, temporal_shapes, precision=precision,
                                 pack=pack)

    @staticmethod
    def backward(fctx, gh, gc):
        return (*dsa_lstm_step_bwd(*fctx.saved_tensors, fctx.temporal_shapes,
                                   gh, gc, precision=fctx.precision,
                                   pack=fctx.pack),
                None, None, None)


def _table_core_precision(value_t, precision):
    """:func:`dsa_lstm_step_table_core`'s precision check: the plain bf16
    word steps on the CPU take cw (the ``*_core`` wrappers), not the
    table."""
    if check_precision(precision) and not value_t.is_cuda:
        raise NotImplementedError(
            'a bf16 word step on CPU tensors takes cw, not the table: '
            'dsa_sample_attend_core / dsa_lstm_step_core')


def dsa_sample_attend_table_core(value_t, vw, pos, hvec, cb, aw, ab,
                                 temporal_shapes, precision='float32'):
    """One word step's sampling and attention from the table vw =
    value_t . cw, differentiable (vw's gradient is G).  Returns ctx
    (B, H, Q, Dh).  CPU tensors: the plain version
    (:func:`sample_attend_table_ref`); CUDA tensors: K7/K8 or an error.
    In bf16 an error on either: K7-bf16 and K8-bf16 compute the product
    form from cw (:func:`dsa_sample_attend_core`)."""
    if check_precision(precision):
        raise NotImplementedError(
            'a bf16 word step takes cw, not the table: K7-bf16 and K8-bf16 '
            'compute the product form (dsa_sample_attend_core)')
    args = (value_t, vw, pos, hvec, cb, aw,
            torch.as_tensor(ab, device=pos.device), tuple(temporal_shapes))
    if not value_t.is_cuda:
        return sample_attend_table_ref(*args)
    return DSASampleAttendFunction.apply(*args, precision, None, None)


def dsa_sample_attend_core(value_t, pos, hvec, cw, cb, aw, ab,
                           temporal_shapes, precision='float32', pack=None,
                           value16=None):
    """One word step's sampling and attention at the kernels' boundary with
    cw given, differentiable.  Returns ctx (B, H, Q, Dh).  CPU tensors: the
    plain version (:func:`sample_attend_ref`; bf16: the plain bf16 product
    form, K7-bf16's and K8-bf16's).  CUDA tensors: f32 the table
    (:func:`dsa_value_table`), then K7/K8; bf16 K7-bf16/K8-bf16 on
    ``value16`` (value_t in torch.bfloat16) and ``pack``
    (:func:`pack_attend_weights` (cw)), each made here where not given (the
    caption head gives both, made once per forward pass); or an error."""
    rb = check_precision(precision)
    ab = torch.as_tensor(ab, device=pos.device)
    if not value_t.is_cuda:
        if rb:
            sample_attend_ref.calls += 1
            return dsa_bf16.PlainWordStepBf16.apply(
                value_t, pos, hvec, cw, cb, aw, ab, tuple(temporal_shapes))
        return sample_attend_ref(value_t, pos, hvec, cw, cb, aw, ab,
                                 temporal_shapes)
    if rb:
        if pack is None:
            pack = pack_attend_weights(cw)
        if value16 is None:
            value16 = dsa_bf16.bf16_operand(value_t.detach())
        return DSASampleAttendFunction.apply(
            value_t, pos, hvec, cw, cb, aw, ab, tuple(temporal_shapes),
            precision, pack, value16)
    return dsa_sample_attend_table_core(
        value_t, dsa_value_table(value_t, cw), pos, hvec, cb, aw, ab,
        temporal_shapes)


def dsa_lstm_step_table_core(value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh,
                             cb, aw, ab, temporal_shapes, precision='float32',
                             pack=None):
    """One fused word step (sampling, attention, LSTM cell) from the table
    vw = value_t . cw, differentiable (vw's gradient is G).  Returns
    (h_new, c_new).  CPU tensors: the plain version
    (:func:`lstm_step_table_ref`; in bf16 an error).  CUDA tensors: K9/K10
    (f32, or K9-bf16/K10-bf16 under ``precision='bfloat16'``, value_t given
    rounded and ``pack`` = ``pack_gate_weights(w_hh, ctx_w3)``, made once a
    forward pass, required) or an error."""
    _table_core_precision(value_t, precision)
    args = (value_t, vw, pos, hvec, z0, h, c, ctx_w3, w_hh, cb, aw,
            torch.as_tensor(ab, device=pos.device), tuple(temporal_shapes))
    if not value_t.is_cuda:
        return lstm_step_table_ref(*args)
    return DSALSTMStepFunction.apply(*args, precision, pack)


def dsa_lstm_step_core(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
                       ab, temporal_shapes, precision='float32'):
    """One fused word step at the kernels' boundary with cw given,
    differentiable.  Returns (h_new, c_new).  CPU tensors: the plain
    version (:func:`lstm_step_ref`; bf16: the plain bf16 product form,
    K9-bf16's and K10-bf16's).  CUDA tensors: the table
    (:func:`dsa_value_table`), then K9/K10 (each in its bf16 mode under
    ``precision='bfloat16'``, on value_t rounded and the gate weights packed
    here, once a call), or an error."""
    rb = check_precision(precision)
    if not value_t.is_cuda:
        if rb:
            lstm_step_ref.calls += 1
            return dsa_bf16.PlainWordStepBf16.apply(
                value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
                torch.as_tensor(ab, device=pos.device),
                tuple(temporal_shapes))
        return lstm_step_ref(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw,
                             cb, aw, ab, temporal_shapes)
    pack = None
    if rb:
        value_t = dsa_bf16.RoundBf16.apply(value_t)
        pack = pack_gate_weights(w_hh, ctx_w3)
    return dsa_lstm_step_table_core(
        value_t, dsa_value_table(value_t, cw, precision), pos, hvec, z0, h, c,
        ctx_w3, w_hh, cb, aw, ab, temporal_shapes, precision, pack)
