"""Sine positional embedding plus a learned duration code (port of
``dvc_tpu/models/position_encoding.py``).

The first half of the channels is the DETR sine embedding over the valid
(unpadded) frames, normalized to 2*pi; the second half is a binary code
with the first ``int(duration)`` of 256 entries set, through a Linear and
broadcast over time.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class PositionEmbeddingSine(nn.Module):
    def __init__(self, num_pos_feats: int = 256, temperature: float = 10000.0,
                 scale: float = 2 * math.pi, max_duration: int = 256):
        super().__init__()
        self.num_pos_feats = num_pos_feats
        self.temperature = temperature
        self.scale = scale
        self.max_duration = max_duration
        self.duration_embed_layer = nn.Linear(max_duration, num_pos_feats)

    def forward(self, pad_mask, duration):
        """pad_mask (B, T) True = padding; duration (B,) seconds.
        Returns (B, T, 2 * num_pos_feats)."""
        x_embed = torch.cumsum((~pad_mask).float(), dim=1)
        x_embed = (x_embed - 0.5) / (x_embed[:, -1:] + 1e-6) * self.scale
        F = self.num_pos_feats
        dim_t = torch.arange(F, dtype=torch.float32, device=pad_mask.device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2,
                                                   rounding_mode='floor') / F)
        pos_x = x_embed[:, :, None] / dim_t                  # (B, T, F)
        pos_x = torch.stack((pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()),
                            dim=3).flatten(2)
        dur = duration.to(torch.int32).clamp(0, self.max_duration)
        binary = (torch.arange(self.max_duration, device=pad_mask.device)
                  < dur[:, None]).float()
        dur_embed = self.duration_embed_layer(binary)
        return torch.cat([pos_x, dur_embed[:, None, :].expand_as(pos_x)],
                         dim=2)
