"""1-D multi-scale deformable attention, forward (port of
``dvc_tpu/ops/ms_deform_attn.py``).

* :func:`ms_deform_attn_ref` — the plain PyTorch gather/lerp version, a
  line-for-line port of the JAX ``ms_deform_attn_ref``.
* :func:`ms_deform_attn` — the wrapper the trunk calls: CUDA tensors go to
  the hand-written kernel ``csrc/ms_deform_attn.cu`` (zeros mode); CPU
  tensors go to the plain version.

Layout, as in the JAX package: value (B, S, H, D) with S = sum of the level
lengths; sampling locations and attention weights (B, Q, H, L, P); output
(B, Q, H*D).
"""

from __future__ import annotations

import torch

from . import _cuda


def _level_starts(temporal_shapes):
    starts, acc = [], 0
    for t in temporal_shapes:
        starts.append(acc)
        acc += int(t)
    return starts


def _tap_indices_weights(loc, T):
    """Zeros-mode linear-interp taps for normalized locations at a level of
    length T: (idx_lo, idx_hi, w_lo, w_hi), indices clamped in range and
    weights of out-of-range taps zeroed."""
    pos = loc * T - 0.5
    i_lo = torch.floor(pos)
    w_hi = pos - i_lo
    w_lo = 1.0 - w_hi
    i_hi = i_lo + 1.0
    w_lo = torch.where((i_lo >= 0) & (i_lo <= T - 1), w_lo, 0.0)
    w_hi = torch.where((i_hi >= 0) & (i_hi <= T - 1), w_hi, 0.0)
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


def ms_deform_attn(value, temporal_shapes, sampling_locations,
                   attention_weights):
    """Trunk MSDA forward (zeros mode).  CPU tensors: the plain version.
    CUDA tensors: the kernel (f32, forward only) or an error."""
    if not value.is_cuda:
        return ms_deform_attn_ref(value, temporal_shapes, sampling_locations,
                                  attention_weights)
    args = (value, sampling_locations, attention_weights)
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        raise RuntimeError('the MSDA kernel is forward only (no backward yet)')
    if any(t.dtype != torch.float32 or t.device != value.device
           for t in args):
        raise TypeError('the MSDA kernel takes float32 tensors on one device')
    B, S, H, D = value.shape
    _, Q, _, L, P = sampling_locations.shape
    if (sampling_locations.shape != (B, Q, H, L, P)
            or attention_weights.shape != (B, Q, H, L, P)
            or len(temporal_shapes) != L or sum(temporal_shapes) != S):
        raise ValueError('MSDA kernel: inconsistent shapes')
    value, loc, attn = (t.contiguous() for t in args)
    out = torch.empty((B, Q, H * D), dtype=torch.float32, device=value.device)
    lib = _cuda.lib()
    _cuda.check(lib.cdll.dvc_msda_fwd(
        value.data_ptr(), loc.data_ptr(), attn.data_ptr(), out.data_ptr(),
        B, S, Q, H, D, L, P, _cuda.levels_array(temporal_shapes),
        _cuda.stream_ptr(value.device)), 'dvc_msda_fwd')
    ms_deform_attn.launches += 1
    return out


ms_deform_attn.launches = 0
