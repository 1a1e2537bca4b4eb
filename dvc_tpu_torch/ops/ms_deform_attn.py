"""1-D multi-scale deformable attention, forward and backward (port of
``dvc_tpu/ops/ms_deform_attn.py``).

* :func:`ms_deform_attn_ref` — the plain PyTorch gather/lerp version, a
  line-for-line port of the JAX ``ms_deform_attn_ref``; its backward is
  autograd through it (:func:`ms_deform_attn_bwd_ref`).
* :func:`ms_deform_attn` — the wrapper the trunk calls: CUDA tensors go to
  :class:`MSDeformAttnFunction`, whose forward is the hand-written kernel
  ``dvc_msda_fwd`` and whose backward is ``dvc_msda_bwd``
  (``csrc/ms_deform_attn.cu``, zeros mode); CPU tensors go to the plain
  version.
* :func:`ms_deform_attn_bwd` — the backward kernel alone: (dvalue, dloc,
  dattn) for an output cotangent, on CUDA tensors only.
* :func:`msda_cost`, :func:`msda_bwd_cost` — (FLOPs, bytes) of the forward
  and the backward by the JAX oracle's count (a gather and lerp, its
  function's least work; ``utils/roofline.py``), which both wrappers
  charge to a counted run.

Layout, as in the JAX package: value (B, S, H, D) with S = sum of the level
lengths; sampling locations and attention weights (B, Q, H, L, P); output
(B, Q, H*D).
"""

from __future__ import annotations

import torch

from ..utils.roofline import charged, charges, nbytes
from . import _cuda


def _level_starts(temporal_shapes):
    starts, acc = [], 0
    for t in temporal_shapes:
        starts.append(acc)
        acc += int(t)
    return starts


def _tap_indices_weights(loc, T, mode='zeros'):
    """Linear-interp taps for normalized locations at a level of length T:
    (idx_lo, idx_hi, w_lo, w_hi), indices clamped in range; ``mode``
    'zeros' zeroes the weights of out-of-range taps, 'border' keeps them
    (the clamped index realizes border padding)."""
    pos = loc * T - 0.5
    i_lo = torch.floor(pos)
    w_hi = pos - i_lo
    w_lo = 1.0 - w_hi
    i_hi = i_lo + 1.0
    if mode == 'zeros':
        w_lo = torch.where((i_lo >= 0) & (i_lo <= T - 1), w_lo, 0.0)
        w_hi = torch.where((i_hi >= 0) & (i_hi <= T - 1), w_hi, 0.0)
    elif mode != 'border':
        raise ValueError(f'unknown boundary mode: {mode}')
    idx_lo = i_lo.clamp(0, T - 1).long()
    idx_hi = i_hi.clamp(0, T - 1).long()
    return idx_lo, idx_hi, w_lo, w_hi


def ms_deform_attn_ref(value, temporal_shapes, sampling_locations,
                       attention_weights):
    """Plain gather/lerp version (zeros mode).  Returns (B, Q, H*D)."""
    ms_deform_attn_ref.calls += 1
    B, S, H, D = value.shape
    _, Q, _, L, P = sampling_locations.shape
    out = value.new_zeros((B, Q, H, D))
    for l, (T, s0) in enumerate(zip(temporal_shapes,
                                    _level_starts(temporal_shapes))):
        v_l = value[:, s0:s0 + T].permute(0, 2, 1, 3)          # (B, H, T, D)
        idx_lo, idx_hi, w_lo, w_hi = _tap_indices_weights(
            sampling_locations[:, :, :, l, :], T)            # (B, Q, H, P)
        a = attention_weights[:, :, :, l, :]

        def gather(idx):  # (B, Q, H, P) -> (B, Q, H, P, D)
            i = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1)
            g = torch.gather(v_l, 2, i.expand(B, H, Q * P, D))
            return g.reshape(B, H, Q, P, D).permute(0, 2, 1, 3, 4)

        samp = (gather(idx_lo) * w_lo[..., None]
                + gather(idx_hi) * w_hi[..., None])             # (B,Q,H,P,D)
        out = out + torch.sum(samp * a[..., None], dim=3)
    return out.reshape(B, Q, H * D)


ms_deform_attn_ref.calls = 0


def ms_deform_attn_sample_values(value, temporal_shapes, sampling_locations):
    """The raw border-mode taps of the caption head's deformable sampling
    (the JAX ``ms_deform_attn_sample_values``, the attention-free DSA
    core's): value (B, S, H, D), sampling locations (B, Q, H, L, P) ->
    (B, Q, H, L, P, D), no attention reduction.  A plain gather in JAX too
    (no Pallas kernel); its backward is autograd through it."""
    B, S, H, D = value.shape
    _, Q, _, L, P = sampling_locations.shape
    samples = []
    for l, (T, s0) in enumerate(zip(temporal_shapes,
                                    _level_starts(temporal_shapes))):
        v_l = value[:, s0:s0 + T].permute(0, 2, 1, 3)          # (B, H, T, D)
        idx_lo, idx_hi, w_lo, w_hi = _tap_indices_weights(
            sampling_locations[:, :, :, l, :], T, 'border')

        def gather(idx):  # (B, Q, H, P) -> (B, Q, H, P, D)
            i = idx.permute(0, 2, 1, 3).reshape(B, H, Q * P, 1)
            g = torch.gather(v_l, 2, i.expand(B, H, Q * P, D))
            return g.reshape(B, H, Q, P, D).permute(0, 2, 1, 3, 4)

        samples.append(gather(idx_lo) * w_lo[..., None]
                       + gather(idx_hi) * w_hi[..., None])
    return torch.stack(samples, dim=3)


def _check_kernel_args(value, temporal_shapes, sampling_locations,
                       attention_weights, *extra):
    tensors = (value, sampling_locations, attention_weights, *extra)
    if not value.is_cuda:
        raise ValueError('the MSDA kernels take CUDA tensors; the plain '
                         'versions are ms_deform_attn_ref and '
                         'ms_deform_attn_bwd_ref')
    if any(t.dtype != torch.float32 or t.device != value.device
           for t in tensors):
        raise TypeError('the MSDA kernels take float32 tensors on one device')
    B, S, H, D = value.shape
    _, Q, _, L, P = sampling_locations.shape
    if (sampling_locations.shape != (B, Q, H, L, P)
            or attention_weights.shape != (B, Q, H, L, P)
            or any(t.shape != (B, Q, H * D) for t in extra)
            or len(temporal_shapes) != L or sum(temporal_shapes) != S):
        raise ValueError('MSDA kernel: inconsistent shapes')
    return (B, S, Q, H, D, L, P), [t.contiguous() for t in tensors]


def _msda_fwd_kernel(value, temporal_shapes, sampling_locations,
                     attention_weights):
    dims, (value, loc, attn) = _check_kernel_args(
        value, temporal_shapes, sampling_locations, attention_weights)
    B, S, Q, H, D, L, P = dims
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    _cuda.check(_cuda.lib().cdll.dvc_msda_fwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, S, Q, H, D, L, P, _cuda.levels_array(temporal_shapes),
        _cuda.stream_ptr(value.device)), 'dvc_msda_fwd')
    ms_deform_attn.launches += 1
    return out


class MSDeformAttnFunction(torch.autograd.Function):
    """The trunk MSDA on the card: forward ``dvc_msda_fwd``, backward
    ``dvc_msda_bwd`` (no gradient for the level table)."""

    @staticmethod
    def forward(ctx, value, temporal_shapes, sampling_locations,
                attention_weights):
        ctx.temporal_shapes = temporal_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _msda_fwd_kernel(value, temporal_shapes, sampling_locations,
                                attention_weights)

    @staticmethod
    def backward(ctx, g):
        value, loc, attn = ctx.saved_tensors
        dvalue, dloc, dattn = ms_deform_attn_bwd(
            value, ctx.temporal_shapes, loc, attn, g)
        return dvalue, None, dloc, dattn


def msda_cost(value, temporal_shapes, sampling_locations,
              attention_weights):
    """(FLOPs, bytes) of the forward: the JAX ``ms_deform_attn_ref``'s
    arithmetic (a gather and lerp, no product).  With n = B*Q*H*L*P taps:
    per tap and channel the two lerp products, their sum, the attention
    product and the sum over P (5); per tap the position, floor, weights,
    bounds masks, clamps and the gathers' index wrap (24); per level the
    accumulation of the (B, Q, H, D) output.  Bytes: the three inputs read
    and the output written once."""
    B, S, H, D = value.shape
    n = sampling_locations.numel()
    L = len(temporal_shapes)
    flops = 5 * n * D + 24 * n + L * B * sampling_locations.shape[1] * H * D
    out = B * sampling_locations.shape[1] * H * D * value.element_size()
    return flops, nbytes(value, sampling_locations, attention_weights) + out


def msda_bwd_cost(value, temporal_shapes, sampling_locations,
                  attention_weights):
    """(FLOPs, bytes) of the backward: the JAX oracle's VJP given its
    residuals.  Per tap and channel the cotangent's products with the two
    taps' weights and the attention, the sums over D, the two gathers'
    scatter-adds (11); per tap 8, and 2 more a level past the first (the
    cotangents of the locations and weights joined across levels); the
    value's cotangent, a (B, S, H, D) sum, once a level.  Bytes: the inputs
    and the output's cotangent read, the three gradients written once."""
    B, S, H, D = value.shape
    n = sampling_locations.numel()
    L = len(temporal_shapes)
    flops = 11 * n * D + 8 * n + 2 * (L - 1) * n + L * value.numel()
    ins = nbytes(value, sampling_locations, attention_weights)
    g = B * sampling_locations.shape[1] * H * D * value.element_size()
    return flops, 2 * ins + g


def ms_deform_attn(value, temporal_shapes, sampling_locations,
                   attention_weights):
    """Trunk MSDA (zeros mode), differentiable.  CPU tensors: the plain
    version (autograd through it).  CUDA tensors: the kernels (f32) or an
    error.  Charges :func:`msda_cost` (and, in the backward,
    :func:`msda_bwd_cost`) to a counted run."""
    args = (value, temporal_shapes, sampling_locations, attention_weights)
    with charged('msda_fwd', lambda: msda_cost(*args)) as region:
        if not value.is_cuda:
            return region.plain('msda_bwd', lambda: msda_bwd_cost(*args),
                                ms_deform_attn_ref, *args)
        return MSDeformAttnFunction.apply(value, tuple(temporal_shapes),
                                          sampling_locations,
                                          attention_weights)


ms_deform_attn.launches = 0


def ms_deform_attn_bwd_ref(value, temporal_shapes, sampling_locations,
                           attention_weights, g):
    """Plain backward: autograd through :func:`ms_deform_attn_ref`.
    Returns (dvalue, dloc, dattn)."""
    with torch.enable_grad():
        args = [t.detach().requires_grad_() for t in
                (value, sampling_locations, attention_weights)]
        out = ms_deform_attn_ref(args[0], temporal_shapes, args[1], args[2])
        return torch.autograd.grad(out, args, g)


@charges('msda_bwd', lambda value, shapes, loc, attn, g: msda_bwd_cost(
    value, shapes, loc, attn))
def ms_deform_attn_bwd(value, temporal_shapes, sampling_locations,
                       attention_weights, g):
    """(dvalue, dloc, dattn) of the trunk MSDA for the output cotangent g
    (B, Q, H*D), by the kernel ``dvc_msda_bwd`` (CUDA tensors), or an
    error.  Charges :func:`msda_bwd_cost` to a counted run."""
    dims, (value, loc, attn, g) = _check_kernel_args(
        value, temporal_shapes, sampling_locations, attention_weights, g)
    B, S, Q, H, D, L, P = dims
    # written in full by the library (it zeroes dvalue itself where its
    # query tiles add into it)
    dvalue = torch.empty_like(value)
    dloc = torch.empty_like(loc)
    dattn = torch.empty_like(attn)
    _cuda.check(_cuda.lib().cdll.dvc_msda_bwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), g.data_ptr(),
        dvalue.data_ptr(), dloc.data_ptr(), dattn.data_ptr(),
        B, S, Q, H, D, L, P, _cuda.levels_array(temporal_shapes),
        _cuda.stream_ptr(value.device)), 'dvc_msda_bwd')
    ms_deform_attn_bwd.launches += 1
    return dvalue, dloc, dattn


ms_deform_attn_bwd.launches = 0
