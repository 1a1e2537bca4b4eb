"""Fused greedy caption decode of the LSTM-DSA head (port of
``dvc_tpu/ops/dsa_greedy.py``).

* :func:`dsa_greedy_scan_ref` — the plain PyTorch K-step loop, a port of
  the JAX ``dsa_greedy_scan_ref`` (border-mode taps with level-relative
  f32 positions, additive attention, bias-free LSTM cell, first-max
  argmax, ``lp = max - logsumexp``).
* :func:`dsa_greedy_scan` — the wrapper the caption head calls: CUDA
  tensors go to the hand-written kernel ``csrc/dsa_greedy.cu`` (which
  first builds the tables ``value_t . cw`` and ``embed . token_w``); CPU
  tensors go to the plain version.
* :func:`greedy_mask_outputs` — EOS masking, applied outside the kernel as
  in the JAX package.

``precision='bfloat16'`` (``--tpu_compute_dtype bfloat16``) is the TPU
kernel's bf16 variant: every in-kernel product on bf16-rounded operands
with f32 accumulation.  Its plain version is
:func:`dvc_tpu_torch.ops.dsa_bf16.greedy_scan`; on the card the same
kernel runs in its bf16-operand mode (K6-bf16), counted apart in
``dsa_greedy_scan.launches_bf16``.

Arguments, as in the JAX package: value_t (B, H, S, Dh); base_pos
(B, H, Q, LP) level-relative base positions; scale_t (B, Q, LP); const_z
(B, Q, 4R); embed (V+1, E); token_w (E, 4R); logit_w (R, V+1); logit_b
(V+1,); off_w_h (H, R, LP); h2att_w (R, A); h2att_b (A,); cw (Dh, A);
cb (A,); aw (A,); ab a number or one-element tensor; ctx_w3 (H, Dh, 4R);
w_hh (R, 4R).
Returns (tok, lp), each (B, K, Q): step k's argmax token (int32, fed to
step k+1; BOS = 0 feeds step 0) and its log-probability.
"""

from __future__ import annotations

import torch

from . import _cuda

PRECISIONS = ('float32', 'bfloat16')


def check_precision(precision):
    if precision not in PRECISIONS:
        raise ValueError(f'precision {precision!r}: one of {PRECISIONS}')
    return precision == 'bfloat16'


def _level_bounds(temporal_shapes, P, device):
    """Per flat tap j = l*P + p: clamp bound T_l - 1 (f32) and level start."""
    hib, s0, acc = [], [], 0
    for T in temporal_shapes:
        hib += [float(T - 1)] * P
        s0 += [acc] * P
        acc += int(T)
    return (torch.tensor(hib, dtype=torch.float32, device=device),
            torch.tensor(s0, dtype=torch.long, device=device))


def lstm_cell(z, c_prev):
    """Bias-free LSTM cell; z (..., 4R) in gate order (i, f, g, o)."""
    i, f, g, o = z.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c_prev + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def step_pos_hvec(h, base_pos, scale_t, off_w_h, h2att_w, h2att_b):
    """The hidden state's share of a word step: the level-relative f32
    sampling positions pos = base_pos + (h off_w_h) * scale_t (B, H, Q, LP)
    and hvec = h h2att_w + h2att_b (B, Q, A)."""
    off = torch.einsum('bqr,hrp->bhqp', h, off_w_h)           # (B, H, Q, LP)
    return base_pos + off * scale_t[:, None], h @ h2att_w + h2att_b


def attend(value_t, pos, hvec, cw, cb, aw, ab, hib, s0):
    """Deformable sampling and additive attention of one word step at the
    level-relative positions pos (B, H, Q, LP) with hvec (B, Q, A):
    border-mode taps (each index clamped into its level, the lerp weights
    kept), scores tanh(taps cw + cb + hvec) . aw + ab, softmax over the LP
    taps.  hib (LP,) is each tap's bound T_l - 1, s0 its level start.
    Returns ctx (B, H, Q, Dh)."""
    B, H, S, Dh = value_t.shape
    Q, LP = pos.shape[2], pos.shape[3]
    zero = torch.zeros((), device=value_t.device)
    i_lo = torch.floor(pos)
    w_hi = pos - i_lo
    w_lo = 1.0 - w_hi
    idx_lo = torch.minimum(torch.maximum(i_lo, zero), hib).long() + s0
    idx_hi = torch.minimum(torch.maximum(i_lo + 1.0, zero), hib).long() + s0

    def gather(idx):  # (B, H, Q, LP) -> (B, H, Q, LP, Dh)
        i = idx.reshape(B, H, Q * LP, 1).expand(B, H, Q * LP, Dh)
        return torch.gather(value_t, 2, i).reshape(B, H, Q, LP, Dh)

    taps = w_lo[..., None] * gather(idx_lo) + w_hi[..., None] * gather(idx_hi)
    u = torch.tanh(taps @ cw + cb + hvec[:, None, :, None, :])
    wts = torch.softmax(u @ aw + ab, dim=-1)                  # (B, H, Q, LP)
    return torch.einsum('bhqp,bhqpd->bhqd', wts, taps)


def attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w, h2att_b,
                cw, cb, aw, ab, hib, s0):
    """One word step's attention from the hidden state h (B, Q, R), shared
    by the greedy decode and the teacher-forcing scan.  Returns ctx
    (B, H, Q, Dh)."""
    pos, hvec = step_pos_hvec(h, base_pos, scale_t, off_w_h, h2att_w,
                              h2att_b)
    return attend(value_t, pos, hvec, cw, cb, aw, ab, hib, s0)


def greedy_pick(logits):
    """A greedy step's choice from its raw logits (..., V+1): the first-max
    argmax and its log-probability max - logsumexp (the (..., V+1)
    log-softmax is never formed)."""
    m = logits.max(dim=-1).values
    lse = m + torch.log(torch.sum(torch.exp(logits - m[..., None]), -1))
    return torch.argmax(logits, dim=-1), m - lse


def dsa_greedy_scan_ref(value_t, base_pos, scale_t, const_z, embed, token_w,
                        logit_w, logit_b, off_w_h, h2att_w, h2att_b, cw, cb,
                        aw, ab, ctx_w3, w_hh, temporal_shapes, K,
                        with_margin=False, precision='float32'):
    """Plain K-step greedy loop.  ``with_margin=True`` also returns each
    step's top-2 logit margin (B, K, Q), which says where an argmax is a
    near-tie that another summation order may flip.  ``precision``
    'bfloat16': the bf16-operand products (:mod:`.dsa_bf16`)."""
    dsa_greedy_scan_ref.calls += 1
    if check_precision(precision):
        from .dsa_bf16 import greedy_scan
        return greedy_scan(value_t, base_pos, scale_t, const_z, embed,
                           token_w, logit_w, logit_b, off_w_h, h2att_w,
                           h2att_b, cw, cb, aw, ab, ctx_w3, w_hh,
                           temporal_shapes, K, with_margin=with_margin)
    B, H, S, Dh = value_t.shape
    Q = const_z.shape[1]
    R = w_hh.shape[0]
    LP = scale_t.shape[-1]
    P = LP // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, value_t.device)

    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    it = torch.zeros((B, Q), dtype=torch.long, device=value_t.device)
    toks, lps, margins = [], [], []
    for _ in range(K):
        ctx = attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, ab, hib, s0)
        z = (const_z + embed[it] @ token_w + h @ w_hh
             + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3))
        h, c = lstm_cell(z, c)
        logits = h @ logit_w + logit_b                        # (B, Q, V+1)
        it, lp = greedy_pick(logits)
        toks.append(it.to(torch.int32))
        lps.append(lp)
        if with_margin:
            top2 = torch.topk(logits, 2, dim=-1).values
            margins.append(top2[..., 0] - top2[..., 1])
    out = (torch.stack(toks, 1), torch.stack(lps, 1))
    return out + (torch.stack(margins, 1),) if with_margin else out


dsa_greedy_scan_ref.calls = 0


def greedy_mask_outputs(tok, lp):
    """(B, K, Q) raw argmax stream -> masked seq + logprobs: step t emits
    its token while no EOS (0) has been chosen up to and including it."""
    unfinished = torch.cumprod((tok > 0).to(torch.int32), dim=1,
                               dtype=torch.int32)
    return tok * unfinished, lp


def dsa_greedy_scan(value_t, base_pos, scale_t, const_z, embed, token_w,
                    logit_w, logit_b, off_w_h, h2att_w, h2att_b, cw, cb, aw,
                    ab, ctx_w3, w_hh, temporal_shapes, K,
                    precision='float32'):
    """Whole greedy decode.  CPU tensors: the plain version.  CUDA
    tensors: the kernel (forward only; f32, or K6-bf16 under
    ``precision='bfloat16'``) or an error."""
    rb = check_precision(precision)
    tensors = (value_t, base_pos, scale_t, const_z, embed, token_w, logit_w,
               logit_b, off_w_h, h2att_w, h2att_b, cw, cb, aw, ctx_w3, w_hh)
    if not value_t.is_cuda:
        return dsa_greedy_scan_ref(*tensors[:14], ab, ctx_w3, w_hh,
                                   temporal_shapes, K, precision=precision)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError('the greedy kernel is forward only')
    if any(t.dtype != torch.float32 or t.device != value_t.device
           for t in tensors):
        raise TypeError('the greedy kernel takes float32 tensors on one '
                        'device')
    B, H, S, Dh = value_t.shape
    Q = const_z.shape[1]
    R = w_hh.shape[0]
    LP = scale_t.shape[-1]
    A = h2att_w.shape[1]
    V1, E = embed.shape
    L = len(temporal_shapes)
    expect = ((B, H, S, Dh), (B, H, Q, LP), (B, Q, LP), (B, Q, 4 * R),
              (V1, E), (E, 4 * R), (R, V1), (V1,), (H, R, LP), (R, A), (A,),
              (Dh, A), (A,), (A,), (H, Dh, 4 * R), (R, 4 * R))
    bad = [i for i, (t, s) in enumerate(zip(tensors, expect))
           if tuple(t.shape) != s]
    if bad or LP % L or sum(temporal_shapes) != S:
        raise ValueError(f'greedy kernel: inconsistent shapes of arguments '
                         f'{bad}')
    # ab goes by pointer: reading a CUDA scalar on the host would wait for
    # the queued work that produces it
    ab = torch.as_tensor(ab, dtype=torch.float32, device=value_t.device)
    if ab.numel() != 1:
        raise ValueError('greedy kernel: ab must hold one value')
    if rb:
        # the operands of the step's products, rounded once (the tables'
        # GEMMs round cw, embed and token_w themselves)
        from .dsa_bf16 import bf16
        tensors = tuple(bf16(t) if i in (0, 6, 8, 9, 14, 15) else t
                        for i, t in enumerate(tensors))
    ptrs = [t.contiguous() for t in (*tensors, ab.reshape(1))]   # kept alive
    dev = value_t.device
    tok = torch.empty((B, K, Q), dtype=torch.int32, device=dev)
    lp = torch.empty((B, K, Q), dtype=torch.float32, device=dev)
    # scratch of the per-launch tables value_t . cw and embed . token_w,
    # and of their GEMMs' split-K partial tiles
    vw = torch.empty((B, H, S, A), dtype=torch.float32, device=dev)
    tw = torch.empty((V1, 4 * R), dtype=torch.float32, device=dev)
    work = _cuda.gemm_work(dev, (B * H * S, A, Dh), (V1, 4 * R, E))
    lib = _cuda.lib()
    _cuda.check(lib.cdll.dvc_dsa_greedy(
        *(t.data_ptr() for t in ptrs),
        _cuda.levels_array(temporal_shapes), tok.data_ptr(), lp.data_ptr(),
        vw.data_ptr(), tw.data_ptr(), work.data_ptr(), B, H, S, Dh, Q, LP, L,
        A, R, E, V1, K, work.numel(), int(rb), _cuda.stream_ptr(value_t.device)),
        'dvc_dsa_greedy')
    _cuda.count_launch(dsa_greedy_scan, rb)
    return tok, lp


dsa_greedy_scan.launches = 0
dsa_greedy_scan.launches_bf16 = 0
