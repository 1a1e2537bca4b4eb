"""Deformable transformer encoder/decoder, 1-D temporal (port of
``dvc_tpu/models/deformable_transformer.py``).

Parameter names follow the reference torch ``state_dict`` layout that
``dvc_tpu/models/pdvc_converter.py::export_pdvc`` emits
(``transformer.encoder.layers.{i}.self_attn.sampling_offsets``, ...).
LayerNorms use eps 1e-6, the flax default the JAX package trains with
(torch's default is 1e-5).

Train mode is a ``gen`` argument: with a ``torch.Generator`` the layers
apply dropout where the JAX layers do (the FFN's hidden activation, every
residual branch, the decoder self-attention's weights), drawing the masks
from that generator; with ``gen=None`` they are deterministic.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import ms_deform_attn

LN_EPS = 1e-6


def dropout(x, p: float, gen, shape=None):
    """Inverted dropout with keep probability 1 - p and masks drawn from
    ``gen`` (flax ``nn.Dropout``); identity when ``gen`` is None or p is 0.
    ``shape`` (broadcastable to x) shares one mask along its unit axes."""
    if gen is None or p <= 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(shape or x.shape, generator=gen, device=x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def msda_offset_bias(n_heads: int, n_levels: int, n_points: int,
                     center: bool = False) -> np.ndarray:
    """Per-head directional bias of the sampling-offset projection, flat
    (H*L*P,): the x component of cos/sin(2*pi*h/H) on the unit square,
    times (point index + 1); ``center=True`` centers it over the points."""
    thetas = np.arange(n_heads, dtype=np.float32) * (2 * math.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    gx = np.tile(grid[:, 0][:, None, None], (1, n_levels, n_points))
    for i in range(n_points):
        gx[:, :, i] *= i + 1
    if center:
        gx = gx - gx.mean(2, keepdims=True)
    return gx.reshape(-1).astype(np.float32)


class MSDeformAttn(nn.Module):
    def __init__(self, d_model, n_levels=4, n_heads=8, n_points=4):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        HLP = n_heads * n_levels * n_points
        self.sampling_offsets = nn.Linear(d_model, HLP)
        self.attention_weights = nn.Linear(d_model, HLP)
        self.value_proj = nn.Linear(d_model, d_model)
        self.output_proj = nn.Linear(d_model, d_model)

    def sampling_locations(self, query, reference_points, temporal_shapes):
        B, Lq, _ = query.shape
        H, L, P = self.n_heads, self.n_levels, self.n_points
        offsets = self.sampling_offsets(query).reshape(B, Lq, H, L, P)
        attn = torch.softmax(
            self.attention_weights(query).reshape(B, Lq, H, L * P), dim=-1)
        attn = attn.reshape(B, Lq, H, L, P)
        shapes = torch.tensor(temporal_shapes, dtype=torch.float32,
                              device=query.device)
        ref = reference_points[:, :, None, :, None, 0]
        if reference_points.shape[-1] == 1:
            loc = ref + offsets / shapes[None, None, None, :, None]
        elif reference_points.shape[-1] == 2:
            loc = (ref + offsets / P
                   * reference_points[:, :, None, :, None, 1] * 0.5)
        else:
            raise ValueError('reference_points last dim must be 1 or 2')
        return loc, attn

    def forward(self, query, reference_points, input_flatten,
                temporal_shapes, pad_mask=None):
        """query (B, Lq, C); reference_points (B, Lq, L, 1|2) in [0, 1];
        input_flatten (B, S, C); pad_mask (B, S) True = padding."""
        B, S, C = input_flatten.shape
        H = self.n_heads
        value = self.value_proj(input_flatten)
        if pad_mask is not None:
            value = value.masked_fill(pad_mask[..., None], 0.0)
        value = value.reshape(B, S, H, C // H)
        loc, attn = self.sampling_locations(query, reference_points,
                                            temporal_shapes)
        out = ms_deform_attn(value, tuple(temporal_shapes), loc, attn)
        return self.output_proj(out)


class MultiheadAttention(nn.Module):
    """Biased q/k/v/out projections with the packed ``in_proj_weight``
    layout of ``torch.nn.MultiheadAttention`` (what the reference state_dict
    holds); q is scaled by 1/sqrt(head_dim) as in flax's attention."""

    def __init__(self, dim, num_heads, dropout_rate=0.0):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, key_mask=None, gen=None):
        """(B, T, C) inputs; key_mask (B, Tk) True = attend.  With ``gen``
        the attention weights get dropout, one mask shared by the batch
        and the heads (flax's ``broadcast_dropout``)."""
        B, Tq, C = query.shape
        nh = self.num_heads
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return nn.functional.linear(x, w, b).reshape(
                B, x.shape[1], nh, C // nh).transpose(1, 2)  # (B, nh, T, hd)

        q = heads(query, wq, bq) / math.sqrt(C // nh)
        k = heads(key, wk, bk)
        v = heads(value, wv, bv)
        logits = q @ k.transpose(-1, -2)                      # (B, nh, Tq, Tk)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        weights = dropout(torch.softmax(logits, dim=-1), self.dropout_rate,
                          gen, (1, 1) + logits.shape[2:])
        out = weights @ v                                     # (B, nh, Tq, hd)
        return self.out_proj(out.transpose(1, 2).reshape(B, Tq, C))


class EncoderLayer(nn.Module):
    """MS-deform self-attention + FFN."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 dropout=0.0):
        super().__init__()
        self.p = dropout
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, reference_points, temporal_shapes, pad_mask,
                gen=None):
        src2 = self.self_attn(src + pos, reference_points, src,
                              temporal_shapes, pad_mask)
        src = self.norm1(src + dropout(src2, self.p, gen))
        return self.norm2(src + ffn(self, src, gen))


class DecoderLayer(nn.Module):
    """Query self-attention + deformable cross-attention + FFN."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 dropout=0.0):
        super().__init__()
        self.p = dropout
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, reference_points, src, temporal_shapes,
                src_pad_mask, query_mask=None, gen=None):
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, query_mask, gen)
        tgt = self.norm2(tgt + dropout(tgt2, self.p, gen))
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src,
                               temporal_shapes, src_pad_mask)
        tgt = self.norm1(tgt + dropout(tgt2, self.p, gen))
        return self.norm3(tgt + ffn(self, tgt, gen))


def ffn(layer, x, gen):
    """The FFN branch of a layer: linear2(dropout(relu(linear1(x)))),
    dropped out again before the residual add."""
    h = dropout(torch.relu(layer.linear1(x)), layer.p, gen)
    return dropout(layer.linear2(h), layer.p, gen)


def encoder_reference_points(temporal_shapes, valid_ratios):
    """valid_ratios (B, L) -> per-position reference points (B, S, L, 1)."""
    refs = []
    for lvl, T in enumerate(temporal_shapes):
        ref = (torch.arange(T, dtype=torch.float32,
                            device=valid_ratios.device) + 0.5)[None, :]
        refs.append(ref / (valid_ratios[:, None, lvl] * T))
    reference_points = torch.cat(refs, dim=1)                 # (B, S)
    reference_points = reference_points[:, :, None] * valid_ratios[:, None]
    return reference_points[:, :, :, None]
