"""TSP model head: backbone + action / temporal-region classifiers (port
of ``dvc_tpu/models/tsp/model.py``; reference
``video_backbone/TSP/models/model.py:6-96``).

One or two Linear heads over the pooled clip features; the second head
optionally reads them concatenated with a global video feature (GVF).
``return_features=True`` also returns the pooled features, the PDVC frame
features (768-d for MViTv2, 512-d for the VideoResNets).  In training mode
only the VideoResNets' BatchNorm changes (batch statistics,
:class:`~.backbones.BatchNorm3d`); the MViT's 0.5 dropout of the
reference is never applied, since the JAX package's TSP step never turns
it on.  :func:`tsp_cross_entropy` is the heads' loss.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .backbones import (MViTConfig, mvit_v2_s, r2plus1d_18, r2plus1d_34,
                        r3d_18)

BACKBONES = {
    'r2plus1d_34': (r2plus1d_34, 512),
    'r2plus1d_18': (r2plus1d_18, 512),
    'r3d_18': (r3d_18, 512),
    'mvit_v2_s': (mvit_v2_s, 768),
}

# GVF width for the mvit head (reference model.py:37-38: feature_size+512)
GVF_DIM = 512


def make_backbone(backbone: str, config: MViTConfig | None = None,
                  mid_layout: str = 'block') -> nn.Module:
    """The backbone ``backbone`` names (``config``: an MViT's widths;
    ``mid_layout``: a VideoResNet's (2+1)-D middle widths)."""
    if backbone not in BACKBONES:
        raise ValueError(f'unknown TSP backbone {backbone!r}: '
                         f'{sorted(BACKBONES)}')
    return BACKBONES[backbone][0](config, mid_layout)


class TSPModel(nn.Module):
    """``features`` (the backbone) and ``fc`` (one head) or ``fc1`` /
    ``fc2`` (two), the module names of a TSP ``.pth``.  ``gvf_dim``: the
    global video feature's width under ``concat_gvf``."""

    def __init__(self, backbone: str = 'mvit_v2_s',
                 num_classes: Sequence[int] = (1, 1), num_heads: int = 2,
                 concat_gvf: bool = False, config: MViTConfig | None = None,
                 mid_layout: str = 'block', gvf_dim: int = GVF_DIM):
        super().__init__()
        if len(num_classes) != num_heads or num_heads not in (1, 2):
            raise ValueError(f'{num_heads} heads, num_classes {num_classes}')
        self.num_heads = num_heads
        self.concat_gvf = concat_gvf
        self.features = make_backbone(backbone, config, mid_layout)
        self.feature_size = self.features.feature_size
        if num_heads == 1:
            self.fc = nn.Linear(self.feature_size, num_classes[0])
        else:
            self.fc1 = nn.Linear(self.feature_size, num_classes[0])
            self.fc2 = nn.Linear(self.feature_size
                                 + (gvf_dim if concat_gvf else 0),
                                 num_classes[1])

    def forward(self, x, gvf=None, return_features=False):
        """x: (B, 3, T, H, W) normalized clips.  Returns the heads' logits
        (a list), and the features too under ``return_features``."""
        feats = self.features(x)
        if self.num_heads == 1:
            logits = [self.fc(feats)]
        else:
            logits = [self.fc1(feats)]
            if self.concat_gvf:
                if gvf is None:
                    raise ValueError('expected a global video feature')
                logits.append(self.fc2(torch.cat([feats, gvf], -1)))
            else:
                logits.append(self.fc2(feats))
        return (logits, feats) if return_features else logits

    @torch.no_grad()
    def init_parameters_(self, gen: torch.Generator):
        """Seeded init with the distributions of the JAX package's flax
        initializers: lecun normal convs and Linears, zero biases, the
        MViT's zero rel-pos tables and class token, the heads N(0, 0.01)
        and fresh BatchNorm statistics."""
        init_backbone_(self.features, gen)
        for name in ('fc', 'fc1', 'fc2'):
            fc = getattr(self, name, None)
            if fc is not None:
                fc.weight.normal_(0.0, 0.01, generator=gen)
                nn.init.zeros_(fc.bias)


def tsp_cross_entropy(logits, labels, global_sum=None):
    """The mean cross entropy over the labels that are not -1
    (reference TSP/train/train.py:65-76), 0 where every label is -1 (a
    background or padded batch), where ``F.cross_entropy(ignore_index=-1)``
    would give NaN: the JAX package divides by max(count, 1).
    ``global_sum`` (a data-parallel rank's ``parallel.global_sum``) counts
    the labels of the global batch, so the loss is the rank's share."""
    valid = labels >= 0
    logp = F.log_softmax(logits, dim=-1)
    picked = logp.gather(-1, labels.clamp(min=0)[:, None])[:, 0]
    count = valid.sum() if global_sum is None else global_sum(valid.sum())
    return -(picked * valid).sum() / count.clamp(min=1)


def _lecun_normal_(w, gen):
    """flax lecun_normal: a truncated normal (2 std) of variance
    1/fan_in, fan_in = the input channels times the kernel's taps."""
    fan_in = w[0].numel()
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


@torch.no_grad()
def init_backbone_(model: nn.Module, gen: torch.Generator):
    for m in model.modules():
        if isinstance(m, (nn.Conv3d, nn.Linear)):
            _lecun_normal_(m.weight, gen)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, (nn.LayerNorm, nn.BatchNorm3d)):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
            if isinstance(m, nn.BatchNorm3d):
                m.reset_running_stats()
    for name, p in model.named_parameters():
        if name.endswith(('rel_pos_h', 'rel_pos_w', 'rel_pos_t',
                          'class_token')):
            nn.init.zeros_(p)


def make_tsp_model(backbone: str, device='cuda', seed: int = 0,
                   num_classes: Sequence[int] = (1,), num_heads: int = 1,
                   config: MViTConfig | None = None,
                   mid_layout: str = 'block', concat_gvf: bool = False,
                   gvf_dim: int = GVF_DIM) -> TSPModel:
    """A TSP model on ``device`` (the card unless the caller asks for the
    CPU) in eval mode, with seeded random weights drawn on the CPU from a
    ``torch.Generator``; load a checkpoint over them with
    ``load_state_dict(strict=True)``."""
    with torch.device('meta'):
        model = TSPModel(backbone, num_classes, num_heads, concat_gvf,
                         config, mid_layout, gvf_dim)
    model.to_empty(device='cpu')
    model.init_parameters_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()

