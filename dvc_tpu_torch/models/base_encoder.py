"""Multi-level 1-D conv pyramid over frame features (port of
``dvc_tpu/models/base_encoder.py``).

Level 0 is a pointwise conv of the features; levels 1..L-1 are stride-2
k=3 convs (level 1 reads the features again, later levels the previous
level), each followed by GroupNorm(32, eps 1e-5).  Per-level padding masks
are nearest-neighbour downsamples of the input mask.  The JAX package keeps
channels last (B, T, C); ``Conv1d`` and ``GroupNorm`` take (B, C, T), so the
pyramid runs channels-first and each level is returned as (B, T_l, C).
"""

from __future__ import annotations

import torch
from torch import nn

from .position_encoding import PositionEmbeddingSine


def downsample_mask(pad_mask, T_out: int):
    """Nearest downsample: out[i] = in[floor(i * T_in / T_out)]."""
    T_in = pad_mask.shape[1]
    idx = torch.arange(T_out, device=pad_mask.device) * T_in // T_out
    return pad_mask[:, idx]


class BaseEncoder(nn.Module):
    def __init__(self, num_feature_levels: int, vf_dim: int, hidden_dim: int):
        super().__init__()
        self.pos_embed = PositionEmbeddingSine(hidden_dim // 2)
        self.input_proj = nn.ModuleList()
        for l in range(num_feature_levels):
            conv = (nn.Conv1d(vf_dim, hidden_dim, 1) if l == 0 else
                    nn.Conv1d(vf_dim if l == 1 else hidden_dim, hidden_dim,
                              3, stride=2, padding=1))
            self.input_proj.append(nn.Sequential(
                conv, nn.GroupNorm(32, hidden_dim, eps=1e-5)))

    def forward(self, vf, pad_mask, duration):
        """vf (B, T, C); pad_mask (B, T) True = padding; duration (B,).
        Returns per-level lists (srcs (B, T_l, d), masks, pos embeds)."""
        srcs, masks, poses = [], [], []
        x = vf.transpose(1, 2)                                # (B, C, T)
        prev = x
        for l, proj in enumerate(self.input_proj):
            src = proj(x if l == 0 else prev)
            m = pad_mask if l == 0 else downsample_mask(pad_mask,
                                                        src.shape[2])
            srcs.append(src.transpose(1, 2))
            masks.append(m)
            poses.append(self.pos_embed(m, duration))
            if l > 0:
                prev = src
        return srcs, masks, poses
