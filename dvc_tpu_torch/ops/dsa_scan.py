"""Teacher-forcing word scan of the LSTM-DSA caption head, forward and
backward (port of ``dvc_tpu/ops/dsa_scan.py``).

* :func:`dsa_teacher_scan_ref` — the plain PyTorch K-step loop (the JAX
  ``dsa_teacher_scan_ref``): each step is the greedy decode's attention
  (:func:`dvc_tpu_torch.ops.dsa_greedy.attend_step`) and the bias-free
  LSTM cell on ``z_all[:, k] + h W_hh + ctx ctx_w3``.  Its backward is
  autograd through it (:func:`dsa_teacher_scan_bwd_ref`).
* :func:`dsa_teacher_scan` — the wrapper the caption head calls: CUDA
  tensors go to :class:`DSATeacherScanFunction` (forward kernel
  ``dvc_dsa_scan_fwd``, backward kernel ``dvc_dsa_scan_bwd`` in
  ``csrc/dsa_scan.cu``; both build the table ``value_t . cw`` first, and
  the backward adds ``G . cw^T`` to dvalue last); CPU tensors go to the
  plain version.
* :func:`dsa_teacher_scan_fwd` / :func:`dsa_teacher_scan_bwd` — the two
  kernels alone: they take CUDA tensors only.

Arguments, as in the JAX package: value_t (B, H, S, Dh); base_pos
(B, H, Q, LP) level-relative base positions; scale_t (B, Q, LP); z_all
(B, K, Q, 4R) the hoisted token and query shares of the LSTM
preactivation; off_w_h (H, R, LP); h2att_w (R, A); h2att_b (A,); cw
(Dh, A); cb (A,); aw (A,); ab a 0-d tensor; ctx_w3 (H, Dh, 4R); w_hh
(R, 4R).  The scan returns hs (B, K, Q, R), the hidden state after each
word step.

``precision='bfloat16'`` (``--tpu_compute_dtype bfloat16``) is the TPU
kernels' bf16 variant: every product of the step and of its backward on
bf16-rounded operands with f32 accumulation.  Its plain versions are
:func:`dvc_tpu_torch.ops.dsa_bf16.scan_fwd` and ``scan_bwd`` (on the CPU
:class:`~dvc_tpu_torch.ops.dsa_bf16.PlainScanBf16` joins them for
autograd); on the card the same kernels run in their bf16-operand mode
(K4-bf16, K5-bf16), counted apart in ``launches_bf16``.
"""

from __future__ import annotations

import torch

from . import _cuda, dsa_bf16
from .dsa_greedy import _level_bounds, attend_step, check_precision, lstm_cell

NAMES = ('value_t', 'base_pos', 'scale_t', 'z_all', 'off_w_h', 'h2att_w',
         'h2att_b', 'cw', 'cb', 'aw', 'ab', 'ctx_w3', 'w_hh')


def dsa_teacher_scan_ref(value_t, base_pos, scale_t, z_all, off_w_h,
                         h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh,
                         temporal_shapes, precision='float32'):
    """Plain K-step scan.  Returns (hs, cs), each (B, K, Q, R).
    ``precision`` 'bfloat16': the bf16-operand products (:mod:`.dsa_bf16`)."""
    dsa_teacher_scan_ref.calls += 1
    if check_precision(precision):
        return dsa_bf16.scan_fwd(value_t, base_pos, scale_t, z_all, off_w_h,
                                 h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3,
                                 w_hh, temporal_shapes)
    B, K, Q = z_all.shape[:3]
    R = w_hh.shape[0]
    P = scale_t.shape[-1] // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, value_t.device)
    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    hs, cs = [], []
    for k in range(K):
        ctx = attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, ab, hib, s0)
        z = (z_all[:, k] + h @ w_hh
             + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3))
        h, c = lstm_cell(z, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


dsa_teacher_scan_ref.calls = 0


def dsa_teacher_scan_bwd_ref(*args, precision='float32'):
    """Plain backward: autograd through :func:`dsa_teacher_scan_ref`.
    ``args`` = the 13 operands, temporal_shapes, hs, cs, g (hs and cs are
    recomputed, not read).  Returns the 13 gradients in argument order.
    ``precision`` 'bfloat16': the TPU kernel's bf16 backward
    (:func:`dvc_tpu_torch.ops.dsa_bf16.scan_bwd`, which reads hs and cs)."""
    if check_precision(precision):
        return dsa_bf16.scan_bwd(*args)
    *ops, temporal_shapes, _hs, _cs, g = args
    with torch.enable_grad():
        ops = [torch.as_tensor(t).detach().requires_grad_() for t in ops]
        hs, _ = dsa_teacher_scan_ref(*ops, temporal_shapes)
        return torch.autograd.grad(hs, ops, g)


def _kernel_operands(args, temporal_shapes, rb=False):
    """Check the operands of a kernel launch; returns (dims, contiguous
    operands, ab as a one-element device tensor), value_t and the weights
    of the step's products rounded to bf16 where ``rb`` (K4-bf16, K5-bf16)."""
    (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b, cw, cb,
     aw, ab, ctx_w3, w_hh) = args
    dev = value_t.device
    ab = torch.as_tensor(ab, dtype=torch.float32, device=dev).reshape(1)
    tensors = (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b,
               cw, cb, aw, ab, ctx_w3, w_hh)
    if dev.type != 'cuda':
        raise ValueError('the scan kernels take CUDA tensors; the plain '
                         'versions are dsa_teacher_scan_ref and '
                         'dsa_teacher_scan_bwd_ref')
    if any(t.dtype != torch.float32 or t.device != dev for t in tensors):
        raise TypeError('the scan kernels take float32 tensors on one device')
    B, H, S, Dh = value_t.shape
    K, Q = z_all.shape[1], z_all.shape[2]
    R = w_hh.shape[0]
    LP = scale_t.shape[-1]
    A = h2att_w.shape[1]
    L = len(temporal_shapes)
    expect = ((B, H, S, Dh), (B, H, Q, LP), (B, Q, LP), (B, K, Q, 4 * R),
              (H, R, LP), (R, A), (A,), (Dh, A), (A,), (A,), (1,),
              (H, Dh, 4 * R), (R, 4 * R))
    bad = [NAMES[i] for i, (t, s) in enumerate(zip(tensors, expect))
           if tuple(t.shape) != s]
    if bad or LP % L or sum(temporal_shapes) != S:
        raise ValueError(f'scan kernel: inconsistent shapes of {bad}')
    if rb:
        tensors = [dsa_bf16.bf16(t) if n in dsa_bf16.ROUNDED else t
                   for n, t in zip(NAMES, tensors)]
    # the backward reads rows as float4: a view's storage offset may leave
    # them unaligned, a copy does not
    tensors = [t.contiguous() for t in tensors]
    tensors = [t.clone() if t.data_ptr() % 16 else t for t in tensors]
    return (B, H, S, Dh, Q, LP, L, A, R, K), tensors


def dsa_teacher_scan_fwd(*args, precision='float32'):
    """(hs, cs) of the scan by the kernel ``dvc_dsa_scan_fwd`` (K4, or
    K4-bf16 under ``precision='bfloat16'``), or an error.  ``args`` = the
    13 operands (CUDA tensors), temporal_shapes."""
    rb = check_precision(precision)
    *ops, temporal_shapes = args
    dims, ops = _kernel_operands(ops, temporal_shapes, rb)
    B, H, S, Dh, Q, LP, L, A, R, K = dims
    hs = torch.empty((B, K, Q, R), dtype=torch.float32, device=ops[0].device)
    cs = torch.empty_like(hs)
    # scratch: the table value_t . cw that the kernel scores from, and its
    # GEMM's split-K partial tiles
    vw = torch.empty((B, H, S, A), dtype=torch.float32, device=hs.device)
    work = _cuda.gemm_work(hs.device, (B * H * S, A, Dh))
    _cuda.check(_cuda.lib().cdll.dvc_dsa_scan_fwd(
        *(t.data_ptr() for t in ops), _cuda.levels_array(temporal_shapes),
        hs.data_ptr(), cs.data_ptr(), vw.data_ptr(), work.data_ptr(), *dims,
        work.numel(), int(rb), _cuda.stream_ptr(hs.device)), 'dvc_dsa_scan_fwd')
    _cuda.count_launch(dsa_teacher_scan_fwd, rb)
    return hs, cs


dsa_teacher_scan_fwd.launches = 0
dsa_teacher_scan_fwd.launches_bf16 = 0


def dsa_teacher_scan_bwd(*args, precision='float32'):
    """The 13 gradients of the scan for the cotangent g (B, K, Q, R) of hs,
    by the kernel ``dvc_dsa_scan_bwd`` (K5, or K5-bf16 under
    ``precision='bfloat16'``), or an error.  ``args`` = the 13 operands
    (CUDA tensors), temporal_shapes, hs, cs, g."""
    rb = check_precision(precision)
    *ops, temporal_shapes, hs, cs, g = args
    ab_shape = torch.as_tensor(ops[10]).shape
    dims, ops = _kernel_operands(ops, temporal_shapes, rb)
    B, H, S, Dh, Q, LP, L, A, R, K = dims
    if (hs.shape != (B, K, Q, R) or cs.shape != hs.shape
            or g.shape != hs.shape):
        raise ValueError('scan kernel: hs, cs and g must be (B, K, Q, R)')
    dev = hs.device
    # step k's backward recomputes it from (h_{k-1}, c_{k-1})
    hs_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1)
    cs_prev = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], 1)
    g = g.to(torch.float32).contiguous()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dvalue, dbase, dscale = zeros(B, H, S, Dh), zeros(B, H, Q, LP), \
        zeros(B, Q, LP)
    dz, doffw, dh2w, dcw = empty(B, K, Q, 4 * R), empty(R, H * LP), \
        empty(R, A), empty(Dh, A)
    dcb, daw, dab = zeros(A), zeros(A), zeros(1)
    dctx_w3, dwhh = empty(H * Dh, 4 * R), empty(R, 4 * R)
    # G, the weight gradients' rows, the table value_t . cw, and the
    # split-K partial tiles of its GEMMs: the table, G . cw^T and the five
    # outer sums
    N, BHS = B * K * Q, B * H * S
    work = _cuda.gemm_work(dev, (BHS, A, Dh), (BHS, Dh, A), (R, 4 * R, N),
                           (H * Dh, 4 * R, N), (R, A, N), (R, H * LP, N),
                           (Dh, A, BHS))
    scratch = (zeros(B, H, S, A), empty(B, K, Q, H * Dh), empty(B, K, Q, A),
               empty(B, K, Q, H * LP), empty(B, H, S, A), work)
    outs = (dvalue, dbase, dscale, dz, doffw, dh2w, dcw, dcb, daw, dab,
            dctx_w3, dwhh)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_scan_bwd(
        *(t.data_ptr() for t in ops), hs_prev.data_ptr(), cs_prev.data_ptr(),
        g.data_ptr(), _cuda.levels_array(temporal_shapes),
        *(t.data_ptr() for t in outs + scratch), *dims, work.numel(), int(rb),
        _cuda.stream_ptr(dev)), 'dvc_dsa_scan_bwd')
    _cuda.count_launch(dsa_teacher_scan_bwd, rb)
    return (dvalue, dbase, dscale, dz,
            doffw.reshape(R, H, LP).permute(1, 0, 2), dh2w, dcb.clone(),
            dcw, dcb, daw, dab.reshape(ab_shape),
            dctx_w3.reshape(H, Dh, 4 * R), dwhh)


dsa_teacher_scan_bwd.launches = 0
dsa_teacher_scan_bwd.launches_bf16 = 0


class DSATeacherScanFunction(torch.autograd.Function):
    """The scan on the card: forward ``dvc_dsa_scan_fwd``, backward
    ``dvc_dsa_scan_bwd``; the last two arguments are the level table and
    the precision."""

    @staticmethod
    def forward(ctx, *args):
        *ops, temporal_shapes, precision = args
        hs, cs = dsa_teacher_scan_fwd(*ops, temporal_shapes,
                                      precision=precision)
        ctx.temporal_shapes, ctx.precision = temporal_shapes, precision
        ctx.save_for_backward(*ops, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        *ops, hs, cs = ctx.saved_tensors
        grads = dsa_teacher_scan_bwd(*ops, ctx.temporal_shapes, hs, cs, g,
                                     precision=ctx.precision)
        return (*grads, None, None)


def dsa_teacher_scan(value_t, base_pos, scale_t, z_all, off_w_h, h2att_w,
                     h2att_b, cw, cb, aw, ab, ctx_w3, w_hh, temporal_shapes,
                     precision='float32'):
    """Whole teacher-forcing scan, differentiable.  Returns hs (B, K, Q, R).
    CPU tensors: the plain version (f32: autograd through it; bf16: the
    plain bf16 forward and backward).  CUDA tensors: the kernels (f32, or
    K4-bf16 and K5-bf16 under ``precision='bfloat16'``) or an error."""
    rb = check_precision(precision)
    args = (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b,
            cw, cb, aw, ab, ctx_w3, w_hh)
    if not value_t.is_cuda:
        if rb:
            dsa_teacher_scan_ref.calls += 1
            return dsa_bf16.PlainScanBf16.apply(*args, tuple(temporal_shapes))
        hs, _ = dsa_teacher_scan_ref(*args, temporal_shapes)
        return hs
    return DSATeacherScanFunction.apply(*args, tuple(temporal_shapes),
                                        precision)
