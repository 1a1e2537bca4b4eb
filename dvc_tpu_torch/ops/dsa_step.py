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
* :func:`dsa_sample_attend_core` / :func:`dsa_lstm_step_core` — the
  differentiable wrappers the caption head calls: CUDA tensors go to the
  autograd Functions over the hand-written kernels of ``csrc/dsa_step.cu``
  (K7 ``dvc_dsa_step_fwd``, K8 ``dvc_dsa_step_bwd``, K9 ``dvc_dsa_lstm_fwd``,
  K10 ``dvc_dsa_lstm_bwd``); CPU tensors go to the plain versions.
* :func:`dsa_sample_attend_fwd` and the other three — the kernels alone:
  they take CUDA tensors only and count their launches.

The sampling and attention arithmetic is the greedy decode's and the scan's
(:func:`dvc_tpu_torch.ops.dsa_greedy.attend`).
"""

from __future__ import annotations

import torch

from . import _cuda
from .dsa_greedy import _level_bounds, attend, lstm_cell

STEP_NAMES = ('value_t', 'pos', 'hvec', 'cw', 'cb', 'aw', 'ab')
LSTM_NAMES = ('value_t', 'pos', 'hvec', 'z0', 'h', 'c', 'ctx_w3', 'w_hh',
              'cw', 'cb', 'aw', 'ab')


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


def lstm_step_bwd_ref(*args):
    """Plain K10: autograd through :func:`lstm_step_ref`.  ``args`` = the 12
    operands, temporal_shapes, gh, gc.  Returns the 12 gradients."""
    *ops, temporal_shapes, gh, gc = args
    return _grads_ref(lstm_step_ref, ops, temporal_shapes, (gh, gc))


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

def _operands(names, args, temporal_shapes):
    """Check the operands of a kernel launch; returns (dims, contiguous
    operands with ab as a one-element device tensor)."""
    ops = dict(zip(names, args))
    dev = ops['value_t'].device
    if dev.type != 'cuda':
        raise ValueError('the word-step kernels take CUDA tensors; the plain '
                         'versions are sample_attend_ref and lstm_step_ref')
    ops['ab'] = torch.as_tensor(ops['ab'], dtype=torch.float32,
                                device=dev).reshape(1)
    if any(t.dtype != torch.float32 or t.device != dev for t in ops.values()):
        raise TypeError('the word-step kernels take float32 tensors on one '
                        'device')
    B, H, S, Dh = ops['value_t'].shape
    Q, LP = ops['pos'].shape[2], ops['pos'].shape[3]
    A = ops['hvec'].shape[-1]
    R = ops['h'].shape[-1] if 'h' in ops else 0
    L = len(temporal_shapes)
    expect = {'value_t': (B, H, S, Dh), 'pos': (B, H, Q, LP),
              'hvec': (B, Q, A), 'cw': (Dh, A), 'cb': (A,), 'aw': (A,),
              'ab': (1,), 'z0': (B, Q, 4 * R), 'h': (B, Q, R), 'c': (B, Q, R),
              'ctx_w3': (H, Dh, 4 * R), 'w_hh': (R, 4 * R)}
    bad = [n for n, t in ops.items() if tuple(t.shape) != expect[n]]
    if bad or LP % L or sum(temporal_shapes) != S:
        raise ValueError(f'word-step kernel: inconsistent shapes of {bad}')
    return ((B, H, S, Dh, Q, LP, L, A, R),
            [ops[n].contiguous() for n in names])


def _zeros(dev, *shape):
    return torch.zeros(shape, dtype=torch.float32, device=dev)


def _empty(dev, *shape):
    return torch.empty(shape, dtype=torch.float32, device=dev)


def dsa_sample_attend_fwd(value_t, pos, hvec, cw, cb, aw, ab,
                          temporal_shapes):
    """ctx (B, H, Q, Dh) by the kernel ``dvc_dsa_step_fwd`` (K7), or an
    error."""
    dims, ops = _operands(STEP_NAMES, (value_t, pos, hvec, cw, cb, aw, ab),
                          temporal_shapes)
    B, H, S, Dh, Q, LP, L, A, _ = dims
    dev = ops[0].device
    ctx = _empty(dev, B, H, Q, Dh)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_step_fwd(
        *(t.data_ptr() for t in ops), _cuda.levels_array(temporal_shapes),
        ctx.data_ptr(), B, H, S, Dh, Q, LP, L, A, _cuda.stream_ptr(dev)),
        'dvc_dsa_step_fwd')
    dsa_sample_attend_fwd.launches += 1
    return ctx


dsa_sample_attend_fwd.launches = 0


def dsa_sample_attend_bwd(value_t, pos, hvec, cw, cb, aw, ab,
                          temporal_shapes, g):
    """The 7 gradients of K7 for the cotangent g (B, H, Q, Dh) of ctx, by
    the kernel ``dvc_dsa_step_bwd`` (K8), or an error."""
    ab_shape = torch.as_tensor(ab).shape
    dims, ops = _operands(STEP_NAMES, (value_t, pos, hvec, cw, cb, aw, ab),
                          temporal_shapes)
    B, H, S, Dh, Q, LP, L, A, _ = dims
    dev = ops[0].device
    if tuple(g.shape) != (B, H, Q, Dh):
        raise ValueError('word-step kernel: g must be (B, H, Q, Dh)')
    g = g.to(torch.float32).contiguous()
    outs = (_zeros(dev, B, H, S, Dh), _empty(dev, B, H, Q, LP),
            _empty(dev, B, Q, A), _empty(dev, Dh, A), _zeros(dev, A),
            _zeros(dev, A), _zeros(dev, 1))
    G, work = _zeros(dev, B, H, S, A), _empty(dev, _cuda.WORK_SPLITS * Dh * A)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_step_bwd(
        *(t.data_ptr() for t in ops), g.data_ptr(),
        _cuda.levels_array(temporal_shapes),
        *(t.data_ptr() for t in outs), G.data_ptr(), work.data_ptr(),
        B, H, S, Dh, Q, LP, L, A, work.numel(), _cuda.stream_ptr(dev)),
        'dvc_dsa_step_bwd')
    dsa_sample_attend_bwd.launches += 1
    return (*outs[:6], outs[6].reshape(ab_shape))


dsa_sample_attend_bwd.launches = 0


def dsa_lstm_step_fwd(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
                      ab, temporal_shapes):
    """(h_new, c_new) by the kernel ``dvc_dsa_lstm_fwd`` (K9), or an
    error."""
    dims, ops = _operands(LSTM_NAMES, (value_t, pos, hvec, z0, h, c, ctx_w3,
                                       w_hh, cw, cb, aw, ab), temporal_shapes)
    B, H, S, Dh, Q, LP, L, A, R = dims
    dev = ops[0].device
    h_new, c_new = _empty(dev, B, Q, R), _empty(dev, B, Q, R)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_lstm_fwd(
        *(t.data_ptr() for t in ops), _cuda.levels_array(temporal_shapes),
        h_new.data_ptr(), c_new.data_ptr(), B, H, S, Dh, Q, LP, L, A, R,
        _cuda.stream_ptr(dev)), 'dvc_dsa_lstm_fwd')
    dsa_lstm_step_fwd.launches += 1
    return h_new, c_new


dsa_lstm_step_fwd.launches = 0


def dsa_lstm_step_bwd(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
                      ab, temporal_shapes, gh, gc):
    """The 12 gradients of K9 for the cotangents gh, gc (B, Q, R) of
    (h_new, c_new), by the kernel ``dvc_dsa_lstm_bwd`` (K10), or an
    error."""
    ab_shape = torch.as_tensor(ab).shape
    dims, ops = _operands(LSTM_NAMES, (value_t, pos, hvec, z0, h, c, ctx_w3,
                                       w_hh, cw, cb, aw, ab), temporal_shapes)
    B, H, S, Dh, Q, LP, L, A, R = dims
    dev = ops[0].device
    if tuple(gh.shape) != (B, Q, R) or tuple(gc.shape) != (B, Q, R):
        raise ValueError('word-step kernel: gh and gc must be (B, Q, R)')
    gh = gh.to(torch.float32).contiguous()
    gc = gc.to(torch.float32).contiguous()
    outs = (_zeros(dev, B, H, S, Dh), _empty(dev, B, H, Q, LP),
            _empty(dev, B, Q, A), _empty(dev, B, Q, 4 * R),
            _empty(dev, B, Q, R), _empty(dev, B, Q, R),
            _empty(dev, H, Dh, 4 * R), _empty(dev, R, 4 * R),
            _empty(dev, Dh, A), _zeros(dev, A), _zeros(dev, A),
            _zeros(dev, 1))
    work = _empty(dev, _cuda.WORK_SPLITS * max(R, H * Dh) * max(4 * R, A))
    scratch = (_zeros(dev, B, H, S, A), _empty(dev, B, Q, H * Dh), work)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_lstm_bwd(
        *(t.data_ptr() for t in ops), gh.data_ptr(), gc.data_ptr(),
        _cuda.levels_array(temporal_shapes),
        *(t.data_ptr() for t in outs + scratch),
        B, H, S, Dh, Q, LP, L, A, R, work.numel(), _cuda.stream_ptr(dev)),
        'dvc_dsa_lstm_bwd')
    dsa_lstm_step_bwd.launches += 1
    return (*outs[:11], outs[11].reshape(ab_shape))


dsa_lstm_step_bwd.launches = 0


class DSASampleAttendFunction(torch.autograd.Function):
    """K7 forward, K8 backward; the last argument is the level table."""

    @staticmethod
    def forward(fctx, *args):
        *ops, temporal_shapes = args
        fctx.temporal_shapes = temporal_shapes
        fctx.save_for_backward(*ops)
        return dsa_sample_attend_fwd(*ops, temporal_shapes)

    @staticmethod
    def backward(fctx, g):
        return (*dsa_sample_attend_bwd(*fctx.saved_tensors,
                                       fctx.temporal_shapes, g), None)


class DSALSTMStepFunction(torch.autograd.Function):
    """K9 forward, K10 backward; the last argument is the level table."""

    @staticmethod
    def forward(fctx, *args):
        *ops, temporal_shapes = args
        fctx.temporal_shapes = temporal_shapes
        fctx.save_for_backward(*ops)
        return dsa_lstm_step_fwd(*ops, temporal_shapes)

    @staticmethod
    def backward(fctx, gh, gc):
        return (*dsa_lstm_step_bwd(*fctx.saved_tensors, fctx.temporal_shapes,
                                   gh, gc), None)


def dsa_sample_attend_core(value_t, pos, hvec, cw, cb, aw, ab,
                           temporal_shapes):
    """One word step's sampling and attention at the kernels' boundary,
    differentiable.  Returns ctx (B, H, Q, Dh).  CPU tensors: the plain
    version (autograd through it).  CUDA tensors: K7/K8 (f32) or an
    error."""
    if not value_t.is_cuda:
        return sample_attend_ref(value_t, pos, hvec, cw, cb, aw, ab,
                                 temporal_shapes)
    return DSASampleAttendFunction.apply(
        value_t, pos, hvec, cw, cb, aw, torch.as_tensor(ab, device=pos.device),
        tuple(temporal_shapes))


def dsa_lstm_step_core(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
                       ab, temporal_shapes):
    """One fused word step (sampling, attention, LSTM cell) at the kernels'
    boundary, differentiable.  Returns (h_new, c_new).  CPU tensors: the
    plain version.  CUDA tensors: K9/K10 (f32) or an error."""
    if not value_t.is_cuda:
        return lstm_step_ref(value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw,
                             cb, aw, ab, temporal_shapes)
    return DSALSTMStepFunction.apply(
        value_t, pos, hvec, z0, h, c, ctx_w3, w_hh, cw, cb, aw,
        torch.as_tensor(ab, device=pos.device), tuple(temporal_shapes))

