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

``dtype=torch.bfloat16`` (``--tpu_compute_dtype bfloat16``) follows the
flax layers' ``dtype``: the linears (:func:`dense`, flax ``nn.Dense``:
input, kernel and bias cast, the product and the bias add in bf16), the
decoder's self-attention and the residual adds compute in bf16 on f32
parameters; the LayerNorms normalise in f32 and cast back; the deformable
attention's offsets and weights come from the f32 query and its value
enters the f32 kernels K1/K2 as f32.  A layer returns bf16; ``PDVC`` hands
f32 on (``encode``, ``decode``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops import ms_deform_attn

LN_EPS = 1e-6


def linear(x, w, b, dtype):
    """x w^T + b as flax ``nn.Dense(dtype=dtype)`` computes it: in f32 as
    ``nn.functional.linear``; in bf16 with the input, weight and bias
    cast, the product rounded to bf16 and the bias added in bf16."""
    if dtype == torch.float32:
        return nn.functional.linear(x, w, b)
    return nn.functional.linear(x.to(dtype), w.to(dtype)) + b.to(dtype)


def dense(lin, x, dtype):
    """The ``nn.Linear`` ``lin`` applied as :func:`linear`."""
    return linear(x, lin.weight, lin.bias, dtype)


def layer_norm(norm, x, dtype):
    """``norm`` over x in f32, cast to ``dtype`` (the flax layers'
    ``LayerNorm(x.astype(f32)).astype(dtype)``)."""
    return norm(x.float()).to(dtype)


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
    def __init__(self, d_model, n_levels=4, n_heads=8, n_points=4,
                 dtype=torch.float32):
        super().__init__()
        self.n_levels, self.n_heads, self.n_points = n_levels, n_heads, n_points
        self.compute_dtype = dtype
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
        input_flatten (B, S, C); pad_mask (B, S) True = padding.  The value
        and output projections compute in ``compute_dtype``; the offsets,
        the attention weights and the sampling in f32."""
        B, S, C = input_flatten.shape
        H, dt = self.n_heads, self.compute_dtype
        value = dense(self.value_proj, input_flatten, dt)
        if pad_mask is not None:
            value = value.masked_fill(pad_mask[..., None], 0.0)
        value = value.reshape(B, S, H, C // H)
        loc, attn = self.sampling_locations(query.float(), reference_points,
                                            temporal_shapes)
        out = ms_deform_attn(value.float(), tuple(temporal_shapes), loc, attn)
        return dense(self.output_proj, out, dt)


class MultiheadAttention(nn.Module):
    """Biased q/k/v/out projections with the packed ``in_proj_weight``
    layout of ``torch.nn.MultiheadAttention`` (what the reference state_dict
    holds); q is scaled by 1/sqrt(head_dim) as in flax's attention.  With
    ``dtype=torch.bfloat16`` everything computes in bf16 as flax 0.12's
    ``MultiHeadDotProductAttention(dtype=bf16)`` does: the projections and
    the query scaling, the logits, the mask fill with bf16's minimum, the
    softmax (not forced to f32) and the weighted sum.  These products stay
    cuBLAS: the JAX package computes them with XLA ops, not a kernel."""

    def __init__(self, dim, num_heads, dropout_rate=0.0, dtype=torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * dim, dim))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * dim))
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, query, key, value, key_mask=None, gen=None):
        """(B, T, C) inputs; key_mask (B, Tk) True = attend.  With ``gen``
        the attention weights get dropout, one mask shared by the batch
        and the heads (flax's ``broadcast_dropout``)."""
        B, Tq, C = query.shape
        nh, dt = self.num_heads, self.compute_dtype
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)

        def heads(x, w, b):
            return linear(x, w, b, dt).reshape(
                B, x.shape[1], nh, C // nh).transpose(1, 2)  # (B, nh, T, hd)

        if dt == torch.float32:
            q = heads(query, wq, bq) / math.sqrt(C // nh)
        else:
            q = heads(query, wq, bq) / torch.tensor(math.sqrt(C // nh),
                                                    dtype=dt)
        k = heads(key, wk, bk)
        v = heads(value, wv, bv)
        logits = q @ k.transpose(-1, -2)                      # (B, nh, Tq, Tk)
        if key_mask is not None:
            logits = logits.masked_fill(~key_mask[:, None, None, :],
                                        torch.finfo(logits.dtype).min)
        if dt == torch.float32:
            weights = torch.softmax(logits, dim=-1)
        else:
            # jax.nn.softmax in bf16: exp and the normalising division in
            # the working type
            e = torch.exp(logits - logits.amax(-1, keepdim=True))
            weights = e / e.sum(-1, keepdim=True)
        weights = dropout(weights, self.dropout_rate, gen,
                          (1, 1) + logits.shape[2:])
        out = weights @ v                                     # (B, nh, Tq, hd)
        return dense(self.out_proj, out.transpose(1, 2).reshape(B, Tq, C), dt)


class EncoderLayer(nn.Module):
    """MS-deform self-attention + FFN."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.p = dropout
        self.compute_dtype = dtype
        self.self_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                      dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, src, pos, reference_points, temporal_shapes, pad_mask,
                gen=None):
        dt = self.compute_dtype
        src = src.to(dt)
        src2 = self.self_attn((src + pos).to(dt), reference_points, src,
                              temporal_shapes, pad_mask)
        src = layer_norm(self.norm1, src + dropout(src2, self.p, gen), dt)
        return layer_norm(self.norm2, src + ffn(self, src, gen), dt)


class DecoderLayer(nn.Module):
    """Query self-attention + deformable cross-attention + FFN."""

    def __init__(self, d_model, d_ffn, n_levels, n_heads, n_points,
                 dropout=0.0, dtype=torch.float32):
        super().__init__()
        self.p = dropout
        self.compute_dtype = dtype
        self.self_attn = MultiheadAttention(d_model, n_heads, dropout, dtype)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.cross_attn = MSDeformAttn(d_model, n_levels, n_heads, n_points,
                                       dtype)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ffn)
        self.linear2 = nn.Linear(d_ffn, d_model)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, tgt, query_pos, reference_points, src, temporal_shapes,
                src_pad_mask, query_mask=None, gen=None):
        dt = self.compute_dtype
        tgt, query_pos = tgt.to(dt), query_pos.to(dt)
        q = tgt + query_pos
        tgt2 = self.self_attn(q, q, tgt, query_mask, gen)
        tgt = layer_norm(self.norm2, tgt + dropout(tgt2, self.p, gen), dt)
        tgt2 = self.cross_attn(tgt + query_pos, reference_points, src,
                               temporal_shapes, src_pad_mask)
        tgt = layer_norm(self.norm1, tgt + dropout(tgt2, self.p, gen), dt)
        return layer_norm(self.norm3, tgt + ffn(self, tgt, gen), dt)


def ffn(layer, x, gen):
    """The FFN branch of a layer: linear2(dropout(relu(linear1(x)))),
    dropped out again before the residual add; in the layer's
    ``compute_dtype``."""
    dt = layer.compute_dtype
    h = dropout(torch.relu(dense(layer.linear1, x, dt)), layer.p, gen)
    return dropout(dense(layer.linear2, h, dt), layer.p, gen)


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
