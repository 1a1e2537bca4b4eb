"""Audio-visual fusion model, the reference's ``NewModel`` (port of
``dvc_tpu/models/fusion.py``).

Clip features pass through a self-attention block, then an audio->visual
cross-attention block (audio features are the queries, the visual stream
the keys and values), and the fused sequence feeds PDVC.  Parameter names
are the reference state_dict's: ``mha1``/``ln1``/``mlp_seq1`` (visual),
``mha2``/``ln2``/``mlp_seq2`` (sound), ``pdvcModel.*``.
"""

from __future__ import annotations

import torch
from torch import nn

from .deformable_transformer import LN_EPS, MultiheadAttention, dense
from .pdvc import DTYPES, PDVC, PDVCConfig, init_mha_, lecun_normal_


def fusion_heads(opt) -> int:
    """The 32-head default, halved until it divides feature_dim."""
    heads = int(getattr(opt, 'fusion_heads', 32) or 32)
    while opt.feature_dim % heads:
        heads //= 2
    return heads


class FusionPDVC(nn.Module):
    """``fusion_dtype`` 'bfloat16' (``--fusion_dtype``) runs each block's
    attention and ``mlp_fc`` in bf16 on f32 weights; its LayerNorms and
    residual adds stay f32 (the JAX ``AttentionBlock``)."""

    def __init__(self, cfg: PDVCConfig, fusion_dim: int = 768,
                 fusion_heads: int = 32, fusion_dtype: str = 'float32'):
        super().__init__()
        self.fusion_dtype = DTYPES[fusion_dtype]
        for i in (1, 2):
            setattr(self, f'mha{i}', MultiheadAttention(
                fusion_dim, fusion_heads, dtype=self.fusion_dtype))
            setattr(self, f'ln{i}', nn.LayerNorm(fusion_dim, eps=LN_EPS))
            setattr(self, f'mlp_seq{i}', nn.Sequential(
                nn.Linear(fusion_dim, fusion_dim),
                nn.LayerNorm(fusion_dim, eps=LN_EPS)))
        self.pdvcModel = PDVC(cfg)

    def _block(self, i, query, kv):
        """MHA -> LayerNorm -> + kv, then Linear -> LayerNorm -> + residual;
        the MHA and the Linear in ``fusion_dtype``, the rest in f32."""
        x = getattr(self, f'ln{i}')(
            getattr(self, f'mha{i}')(query, kv, kv).float())
        x = x + kv
        fc, ln = getattr(self, f'mlp_seq{i}')
        return ln(dense(fc, x, self.fusion_dtype).float()) + x

    def _fuse(self, batch):
        clips = batch['video_tensor']
        fused = self._block(1, clips, clips)
        if batch.get('sound_tensor') is not None:
            fused = self._block(2, batch['sound_tensor'], fused)
        inner = {k: v for k, v in batch.items() if k != 'sound_tensor'}
        inner['video_tensor'] = fused
        return inner

    def forward(self, batch, gen=None):
        """Serving forward.  batch as PDVC's plus an optional 'sound_tensor'
        (B, T, C) aligned with the clips (zeros where audio is missing);
        ``gen`` feeds a sampling decode (:meth:`PDVC.forward`)."""
        return self.pdvcModel(self._fuse(batch), gen)

    def forward_eval(self, batch, gen=None):
        """Eval forward on a batch with gt events (:meth:`PDVC.forward_eval`):
        (outputs, losses)."""
        return self.pdvcModel.forward_eval(self._fuse(batch), gen)

    def forward_train(self, batch, gen=None, ss_prob=0.0, global_sum=None):
        """Train forward (:meth:`PDVC.forward_train`); the fusion blocks
        have no dropout, as in the reference."""
        return self.pdvcModel.forward_train(self._fuse(batch), gen, ss_prob,
                                            global_sum)

    @torch.no_grad()
    def init_parameters_(self, gen: torch.Generator):
        self.pdvcModel.init_parameters_(gen)
        for i in (1, 2):
            init_mha_(getattr(self, f'mha{i}'), gen)
            for norm in (getattr(self, f'ln{i}'), getattr(self, f'mlp_seq{i}')[1]):
                nn.init.ones_(norm.weight)
                nn.init.zeros_(norm.bias)
            fc = getattr(self, f'mlp_seq{i}')[0]
            lecun_normal_(fc.weight, gen)
            nn.init.zeros_(fc.bias)


def make_fusion_model(opt, device='cuda', seed: int = 0) -> FusionPDVC:
    """The FusionPDVC of ``opt`` on ``device`` (the card unless the caller
    asks for the CPU) in eval mode, with seeded
    random weights drawn on the CPU from a ``torch.Generator`` (so the same
    seed gives the same weights on any device); load a checkpoint over them
    with ``load_state_dict(strict=True)``.  The weights are f32 under either
    ``--fusion_dtype`` and ``--tpu_compute_dtype``."""
    with torch.device('meta'):
        model = FusionPDVC(PDVCConfig.from_opt(opt), fusion_dim=opt.feature_dim,
                           fusion_heads=fusion_heads(opt),
                           fusion_dtype=opt.fusion_dtype)
    model.to_empty(device='cpu')
    model.init_parameters_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()
