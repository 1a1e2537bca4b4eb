"""Video backbones of TSP feature extraction (port of
``dvc_tpu/models/tsp/backbones.py``; reference
``video_backbone/TSP/models/backbone.py:15-81``).

* :class:`VideoResNet`: R3D-18, R(2+1)D-18 and R(2+1)D-34, the 3-D ResNets
  of torchvision's ``video_resnet`` with its module names, so a TSP or
  torchvision ``.pth`` loads with ``load_state_dict(strict=True)``.
* :class:`MViTV2`: MViTv2-S (16 blocks in stages [1, 2, 11, 2], widths
  [96, 192, 384, 768], heads [1, 2, 4, 8]) with pooled q/k/v attention,
  decomposed relative position biases and residual pooled queries, under
  torchvision ``mvit_v2_s``'s module names.

Inputs are torch's channels-first clips (B, 3, T, H, W); the extractor
permutes the decoder's channels-last (B, T, H, W, 3) batch on the device.
In training mode the VideoResNets' BatchNorm follows flax's
``BatchNorm`` (:class:`BatchNorm3d`), as the JAX package's TSP training
under ``--train-bn 1`` does; the MViT has no training-only path (the JAX
package never enables its dropout).

Under bfloat16 weights and inputs the attention's score tensors stay
bfloat16 while its softmax denominator accumulates in float32, and the
MLP's GELU is the tanh approximation (exact erf under float32), as in the
JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

# ---------------------------------------------------------------------------
# VideoResNet (R3D / R(2+1)D)
# ---------------------------------------------------------------------------


def midplanes(in_planes: int, out_planes: int) -> int:
    """Channels between the spatial and temporal convs of a (2+1)-D conv:
    the count that keeps its parameters near a full 3x3x3 conv's."""
    return (in_planes * out_planes * 3 * 3 * 3) // (in_planes * 3 * 3
                                                     + 3 * out_planes)


class BatchNorm3d(nn.BatchNorm3d):
    """``nn.BatchNorm3d`` (same names and buffers) with flax's
    ``BatchNorm`` semantics, the JAX package's ``_bn``.

    Eval mode normalises with the running statistics cast to the input's
    dtype (the JAX mixed-precision step casts every variable).  Training
    mode (``--train-bn 1``): the batch mean and the *biased* variance
    E[x^2] - E[x]^2 in float32, clipped at 0, normalise the batch as
    ``(x - mean) * (rsqrt(var + eps) * weight) + bias`` in float32, cast
    back to the input's dtype, and both update the running statistics as
    ``keep * old + (1 - keep) * new`` with ``keep = 1 - momentum`` (torch's
    ``nn.BatchNorm3d`` updates ``running_var`` with the unbiased variance).
    ``old`` is taken in the input's dtype, as the JAX step casts it, so
    under bfloat16 its term is rounded through bfloat16; the sum and the
    buffers stay float32.  ``num_batches_tracked`` counts as in torch.

    ``global_sum`` (``parallel.all_reduce_sum`` on a data-parallel rank;
    None, the batch's own statistics, by default) sums the per-channel
    sums of x and x^2 and the count over the ranks, gradients included,
    before the mean and the variance: flax's statistics over the global
    batch, i.e. SyncBatchNorm."""

    global_sum = None

    def forward(self, x):
        if not self.training:
            return F.batch_norm(x, self.running_mean.to(x.dtype),
                                self.running_var.to(x.dtype), self.weight,
                                self.bias, False, 0.0, self.eps)
        # at least float32, as flax promotes (float64 stays float64)
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        dims = (0, 2, 3, 4)
        if self.global_sum is None:
            mean, sq = x32.mean(dims), (x32 * x32).mean(dims)
        else:
            C = x32.shape[1]
            sums = self.global_sum(torch.cat([
                x32.sum(dims), (x32 * x32).sum(dims),
                x32.new_full((1,), x32.numel() // C)]))
            mean, sq = sums[:C] / sums[-1], sums[C:2 * C] / sums[-1]
        var = torch.clamp(sq - mean * mean, min=0.0)
        shape = (1, -1, 1, 1, 1)
        y = (x32 - mean.view(shape)) * (
            torch.rsqrt(var + self.eps) * self.weight).view(shape)
        y = y + self.bias.view(shape)
        keep = 1.0 - self.momentum
        with torch.no_grad():
            for buf, new in ((self.running_mean, mean),
                             (self.running_var, var)):
                old = buf.to(x.dtype) * torch.tensor(keep, dtype=x.dtype,
                                                      device=buf.device)
                buf.copy_(old.to(new.dtype) + (1 - keep) * new)
            self.num_batches_tracked.add_(1)
        return y.to(x.dtype)


class Conv3DSimple(nn.Conv3d):
    """Full 3x3x3 conv (R3D blocks)."""

    def __init__(self, in_planes: int, out_planes: int, stride: int = 1):
        super().__init__(in_planes, out_planes, (3, 3, 3), stride=stride,
                         padding=1, bias=False)


class Conv2Plus1D(nn.Sequential):
    """Factorized (2+1)-D conv: 1x3x3 spatial, BN, ReLU, 3x1x1 temporal
    (torchvision keys 0, 1 and 3)."""

    def __init__(self, in_planes: int, out_planes: int, mid: int,
                 stride: int = 1, bn_eps: float = 1e-5,
                 bn_momentum: float = 0.1):
        super().__init__(
            nn.Conv3d(in_planes, mid, (1, 3, 3), stride=(1, stride, stride),
                      padding=(0, 1, 1), bias=False),
            BatchNorm3d(mid, eps=bn_eps, momentum=bn_momentum),
            nn.ReLU(inplace=True),
            nn.Conv3d(mid, out_planes, (3, 1, 1), stride=(stride, 1, 1),
                      padding=(1, 0, 0), bias=False))


class BasicBlock(nn.Module):
    """Two convs with BN and a residual; a 1x1x1 conv and BN on the
    residual where the stride or the width changes.

    ``mids`` are the two (2+1)-D convs' middle widths: torchvision takes
    both from the block's input width (``midplanes(in, planes)`` twice,
    its 'block' layout); the JAX package takes each conv's own
    (``midplanes(planes, planes)`` for the second, the 'conv' layout).
    They differ only in the first block of a stage that widens."""

    def __init__(self, in_planes: int, planes: int, conv_type: str,
                 stride: int = 1, bn_eps: float = 1e-5, mids=(0, 0),
                 bn_momentum: float = 0.1):
        super().__init__()

        def conv(in_p, mid, s):
            if conv_type == 'r3d':
                return Conv3DSimple(in_p, planes, s)
            return Conv2Plus1D(in_p, planes, mid, s, bn_eps, bn_momentum)

        def bn():
            return BatchNorm3d(planes, eps=bn_eps, momentum=bn_momentum)

        self.conv1 = nn.Sequential(conv(in_planes, mids[0], stride), bn(),
                                   nn.ReLU(inplace=True))
        self.conv2 = nn.Sequential(conv(planes, mids[1], 1), bn())
        self.downsample = None
        if stride != 1 or in_planes != planes:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_planes, planes, 1, stride=stride, bias=False),
                bn())

    def forward(self, x):
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(self.conv2(self.conv1(x)) + identity)


class VideoResNet(nn.Module):
    """R3D-18 / R(2+1)D-18 / R(2+1)D-34 clip features (B, 512): the
    blocks, then the mean over (T, H, W); the classifier is stripped, as
    TSP uses it (reference model.py:70-73).  ``mid_layout`` picks the
    (2+1)-D middle widths (:class:`BasicBlock`): 'block' (torchvision's,
    of every ``.pth``) or 'conv' (the JAX package's).  ``bn_momentum`` is
    the torch convention (the new batch statistic's weight)."""

    feature_size = 512

    def __init__(self, conv_type: str = 'r2plus1d',
                 layers: Sequence[int] = (3, 4, 6, 3), bn_eps: float = 1e-5,
                 mid_layout: str = 'block', bn_momentum: float = 0.1):
        super().__init__()
        if mid_layout not in ('block', 'conv'):
            raise ValueError(f'mid_layout {mid_layout!r}: block or conv')
        self.layers = tuple(layers)
        self.mid_layout = mid_layout

        def bn(n):
            return BatchNorm3d(n, eps=bn_eps, momentum=bn_momentum)

        if conv_type == 'r2plus1d':
            self.stem = nn.Sequential(
                nn.Conv3d(3, 45, (1, 7, 7), stride=(1, 2, 2),
                          padding=(0, 3, 3), bias=False),
                bn(45), nn.ReLU(inplace=True),
                nn.Conv3d(45, 64, (3, 1, 1), padding=(1, 0, 0), bias=False),
                bn(64), nn.ReLU(inplace=True))
        elif conv_type == 'r3d':
            self.stem = nn.Sequential(
                nn.Conv3d(3, 64, (3, 7, 7), stride=(1, 2, 2),
                          padding=(1, 3, 3), bias=False),
                bn(64), nn.ReLU(inplace=True))
        else:
            raise ValueError(f'conv_type {conv_type!r}: r3d or r2plus1d')
        in_planes = 64
        for stage, (blocks, planes, stride) in enumerate(
                zip(self.layers, (64, 128, 256, 512), (1, 2, 2, 2))):
            seq = []
            for b in range(blocks):
                mid = midplanes(in_planes, planes)
                mids = (mid, mid if mid_layout == 'block'
                        else midplanes(planes, planes))
                seq.append(BasicBlock(in_planes, planes, conv_type,
                                      stride if b == 0 else 1, bn_eps, mids,
                                      bn_momentum))
                in_planes = planes
            self.add_module(f'layer{stage + 1}', nn.Sequential(*seq))

    def forward(self, x):
        x = self.stem(x)
        for stage in range(len(self.layers)):
            x = getattr(self, f'layer{stage + 1}')(x)
        return x.mean(dim=(2, 3, 4))


def r3d_18(config=None, mid_layout='block'):
    return VideoResNet('r3d', (2, 2, 2, 2), mid_layout=mid_layout)


def r2plus1d_18(config=None, mid_layout='block'):
    return VideoResNet('r2plus1d', (2, 2, 2, 2), mid_layout=mid_layout)


def r2plus1d_34(config=None, mid_layout='block'):
    # Caffe2 BN epsilon for the IG65M weights (reference backbone.py:25-28);
    # the JAX package's momentum 0.9 (torch convention) for them too
    return VideoResNet('r2plus1d', (3, 4, 6, 3), bn_eps=1e-3,
                       mid_layout=mid_layout, bn_momentum=0.9)


# ---------------------------------------------------------------------------
# MViTv2
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MViTConfig:
    embed_dim: int = 96
    depths: Sequence[int] = (1, 2, 11, 2)
    heads: Sequence[int] = (1, 2, 4, 8)
    temporal_size: int = 16
    spatial_size: int = 224
    mlp_ratio: float = 4.0
    kv_stride0: int = 8      # spatial kv pooling of stage 0 (adaptive decay)
    feature_dim: int = 768


@dataclasses.dataclass(frozen=True)
class MViTBlockSpec:
    """Per-block wiring, mirroring torchvision's mvit_v2_s block table."""
    in_ch: int
    out_ch: int
    heads: int
    q_stride: tuple
    kv_stride: tuple


def mvit_block_specs(cfg: MViTConfig):
    """Block table for MViTv2 (torchvision ``mvit_v2_s`` semantics).

    Channels AND heads double in the same block that pools Q — the first
    block of each stage after the first (the official MViTv2 config's
    DIM_MUL/HEAD_MUL at blocks 1, 3, 14 with DIM_MUL_IN_ATT=True).  The kv
    pooling stride is adaptive: it starts at ``kv_stride0`` and halves at
    every Q-pooling block (including that block itself), floored at 1.
    """
    specs = []
    dim = cfg.embed_dim
    kv = cfg.kv_stride0
    for stage, (depth, heads) in enumerate(zip(cfg.depths, cfg.heads)):
        for b in range(depth):
            pool = (b == 0 and stage > 0)
            if pool:
                kv = max(kv // 2, 1)
            out_ch = dim * 2 if pool else dim
            specs.append(MViTBlockSpec(
                dim, out_ch, heads,
                (1, 2, 2) if pool else (1, 1, 1),
                (1, max(kv, 1), max(kv, 1))))
            dim = out_ch
    return specs


def pooled(thw, stride):
    """The (t, h, w) grid after a 3x3x3 pool of ``stride`` with padding 1
    (and after the skip path's max pool, which lands on the same grid)."""
    return tuple((n - 1) // s + 1 for n, s in zip(thw, stride))


def patch_grid(cfg: MViTConfig):
    """The token grid of the patchify stem (3x7x7, stride (2, 4, 4),
    padding (1, 3, 3)) at the config's clip size."""
    return ((cfg.temporal_size - 1) // 2 + 1,
            (cfg.spatial_size - 1) // 4 + 1, (cfg.spatial_size - 1) // 4 + 1)


def mvit_macs(cfg: MViTConfig):
    """Multiply-adds of one MViTv2 clip from its block table: the patchify
    conv, and per block the qkv, depthwise pool, score, rel-pos bias,
    attention-value, projection, skip-projection and MLP products."""
    thw = patch_grid(cfg)
    n = thw[0] * thw[1] * thw[2]
    macs = n * cfg.embed_dim * 3 * 3 * 7 * 7
    for s in mvit_block_specs(cfg):
        D = s.out_ch // s.heads
        q, k = pooled(thw, s.q_stride), pooled(thw, s.kv_stride)
        lq, lk = q[0] * q[1] * q[2], k[0] * k[1] * k[2]
        macs += (1 + n) * s.in_ch * 3 * s.out_ch               # qkv
        macs += s.heads * D * 27 * (lq + 2 * lk)                # pools
        macs += 2 * s.heads * (1 + lq) * (1 + lk) * D           # q.k, a.v
        macs += s.heads * lq * D * sum(k)                       # rel-pos
        macs += (1 + lq) * s.out_ch * s.out_ch                  # project
        if s.in_ch != s.out_ch:
            macs += (1 + n) * s.in_ch * s.out_ch                # skip proj
        macs += 2 * (1 + lq) * s.out_ch * int(s.out_ch * cfg.mlp_ratio)
        thw, n = q, lq
    return macs


def _grid(x, B, thw, C):
    """(B, t*h*w, C) tokens as a contiguous (B, C, t, h, w) grid.  A
    channels-last view would skip the copy, but PyTorch then hands the
    depthwise 3-D pool conv to cuDNN's generic implicit GEMM, which ran a
    bf16 MViTv2-S batch about 1.9x slower than PyTorch's own depthwise
    kernel on the contiguous grid (NVIDIA H100 80GB HBM3, 700 W;
    ``chip_smoke.py`` phase 14, PERF.md)."""
    return x.reshape(B, *thw, C).permute(0, 4, 1, 2, 3).contiguous()


def _tokens(x):
    """(B, C, t, h, w) -> (B, t*h*w, C), tokens in (t, h, w) order."""
    return x.permute(0, 2, 3, 4, 1).reshape(x.shape[0], -1, x.shape[1])


class PoolCls(nn.Module):
    """Attention-tensor pooling with a class-token bypass (torchvision
    ``Pool``): a depthwise 3x3x3 conv (stride = the pooling stride) over
    the THW grid, the class token re-attached in front, then LayerNorm
    over the whole sequence."""

    def __init__(self, head_dim: int, stride):
        super().__init__()
        self.stride = tuple(stride)
        self.pool = nn.Conv3d(head_dim, head_dim, 3, stride=self.stride,
                              padding=1, groups=head_dim, bias=False)
        self.norm_act = nn.Sequential(nn.LayerNorm(head_dim, eps=1e-5))

    def forward(self, x, thw):
        # x: (B, heads, 1+L, D)
        B, H, _, D = x.shape
        cls_tok, grid = x[:, :, :1], x[:, :, 1:]
        g = self.pool(_grid(grid, B * H, thw, D))
        new_thw = tuple(g.shape[2:])
        g = _tokens(g).reshape(B, H, -1, D)
        return self.norm_act(torch.cat([cls_tok, g], dim=2)), new_thw


@functools.lru_cache(maxsize=None)
def _rel_idx(q_n: int, k_n: int):
    """Relative-distance table rows with asymmetric-size scaling
    (torchvision ``_add_rel_pos``): the float index cast to int64.  Made
    outside inference mode, so that the cached index can serve a training
    forward after an inference one (on the CPU it is used as it is)."""
    ratio_q = max(k_n / q_n, 1.0)
    ratio_k = max(q_n / k_n, 1.0)
    qi = np.arange(q_n)[:, None] * ratio_q
    ki = np.arange(k_n)[None, :] * ratio_k
    with torch.inference_mode(False):
        return torch.from_numpy(((qi - ki) + (k_n - 1) * ratio_k)
                                .astype(np.int64))


def attention_rel_pos(q, k, v, q_shape, k_shape, rel_h, rel_w, rel_t):
    """softmax(q.k^T / sqrt(D) + decomposed rel-pos bias).v, the bias on
    the non-CLS block only (torchvision ``_add_rel_pos`` semantics).

    The bias stays factored: the scores are reshaped to (..., kt, kh*kw)
    and take the kt term and the kh*kw outer-sum term as two broadcast
    adds, so no (B, H, Lq, kt, kh, kw) tensor is made.  The CLS key
    column (no bias) joins through a two-chunk log-sum-exp.  Under
    bfloat16 the scores stay bfloat16 and the denominator sums in float32.
    """
    B, nH, N1q, D = q.shape
    qt, qh, qw = q_shape
    kt, kh, kw = k_shape
    Lq, Lk = qt * qh * qw, kt * kh * kw
    f32 = torch.float32
    # the scale rounded to the scores' dtype, as jnp's acc(scale)
    scale = torch.tensor(D ** -0.5, dtype=q.dtype, device='cpu').item()
    dev = q.device

    q5 = q[:, :, 1:].reshape(B, nH, qt, qh, qw, D)
    Rt = rel_t[_rel_idx(qt, kt).to(dev)]
    Rh = rel_h[_rel_idx(qh, kh).to(dev)]
    Rw = rel_w[_rel_idx(qw, kw).to(dev)]
    bias_t = torch.einsum('bnthwd,tkd->bnthwk', q5, Rt).reshape(B, nH, Lq, kt)
    bias_h = torch.einsum('bnthwd,hkd->bnthwk', q5, Rh).reshape(B, nH, Lq, kh)
    bias_w = torch.einsum('bnthwd,wkd->bnthwk', q5, Rw).reshape(B, nH, Lq, kw)
    bias_hw = (bias_h[..., :, None] + bias_w[..., None, :]).reshape(
        B, nH, Lq, kh * kw)
    # a zero-bias row for the CLS query
    bias_t = F.pad(bias_t, (0, 0, 1, 0))
    bias_hw = F.pad(bias_hw, (0, 0, 1, 0))

    k_cls, k_grid = k[:, :, :1], k[:, :, 1:]
    v_cls, v_grid = v[:, :, :1], v[:, :, 1:]
    s_grid = torch.matmul(q, k_grid.transpose(-1, -2)) * scale
    s_grid = (s_grid.reshape(B, nH, N1q, kt, kh * kw)
              + bias_t[..., :, None]
              + bias_hw[..., None, :]).reshape(B, nH, N1q, Lk)
    s_cls = torch.matmul(q, k_cls.transpose(-1, -2)) * scale  # (B,H,1+Lq,1)
    m = torch.maximum(s_grid.amax(dim=-1, keepdim=True), s_cls)
    e_cls = torch.exp((s_cls - m).to(f32))
    e_grid = torch.exp(s_grid - m)
    denom = e_cls + e_grid.sum(dim=-1, keepdim=True, dtype=f32)
    out = (e_cls * v_cls.to(f32)
           + torch.matmul(e_grid, v_grid).to(f32)) / denom
    return out.to(q.dtype)


class MultiscaleAttention(nn.Module):
    """One ``qkv`` Linear split in three, pooled q/k/v (:class:`PoolCls`),
    the rel-pos attention, the pooled queries added back (CLS excluded)
    and ``project``.  ``thw`` is the input grid, which sizes the rel-pos
    tables."""

    def __init__(self, spec: MViTBlockSpec, thw):
        super().__init__()
        self.heads = spec.heads
        self.out_ch = spec.out_ch
        D = spec.out_ch // spec.heads
        self.qkv = nn.Linear(spec.in_ch, 3 * spec.out_ch)
        self.project = nn.Sequential(nn.Linear(spec.out_ch, spec.out_ch))
        self.pool_q = PoolCls(D, spec.q_stride)
        self.pool_k = PoolCls(D, spec.kv_stride)
        self.pool_v = PoolCls(D, spec.kv_stride)
        q_shape, k_shape = pooled(thw, spec.q_stride), pooled(thw,
                                                              spec.kv_stride)
        size = [2 * max(a, b) - 1 for a, b in zip(q_shape, k_shape)]
        self.rel_pos_h = nn.Parameter(torch.zeros(size[1], D))
        self.rel_pos_w = nn.Parameter(torch.zeros(size[2], D))
        self.rel_pos_t = nn.Parameter(torch.zeros(size[0], D))

    def forward(self, x, thw):
        # x: (B, 1+L, in_ch), already norm1-ed by the block
        B, N, _ = x.shape
        H, D = self.heads, self.out_ch // self.heads
        q, k, v = self.qkv(x).reshape(B, N, 3, H, D).permute(2, 0, 3, 1, 4)
        q, q_shape = self.pool_q(q, thw)
        k, k_shape = self.pool_k(k, thw)
        v, _ = self.pool_v(v, thw)
        out = attention_rel_pos(q, k, v, q_shape, k_shape, self.rel_pos_h,
                                self.rel_pos_w, self.rel_pos_t)
        # residual pooling (v2), CLS excluded
        out = torch.cat([out[:, :, :1], out[:, :, 1:] + q[:, :, 1:]], dim=2)
        out = out.transpose(1, 2).reshape(B, -1, self.out_ch)
        return self.project(out), q_shape


def skip_max_pool(x, thw, stride):
    """Residual-path max pool with a CLS bypass: kernel stride+1 where the
    stride exceeds 1, padding kernel//2 (torchvision
    ``MultiscaleBlock.pool_skip``)."""
    B, _, C = x.shape
    window = tuple(s + 1 if s > 1 else s for s in stride)
    g = F.max_pool3d(_grid(x[:, 1:], B, thw, C), window,
                     stride=tuple(stride), padding=[w // 2 for w in window])
    return torch.cat([x[:, :1], _tokens(g)], dim=1)


class Gelu(nn.Module):
    """GELU: exact erf under float32 (torchvision's ``nn.GELU``), the tanh
    approximation under bfloat16, as the JAX package computes it."""

    def forward(self, x):
        return F.gelu(x, approximate='tanh' if x.dtype == torch.bfloat16
                      else 'none')


class MultiscaleBlock(nn.Module):
    def __init__(self, spec: MViTBlockSpec, thw, mlp_ratio: float = 4.0):
        super().__init__()
        self.q_stride = tuple(spec.q_stride)
        self.norm1 = nn.LayerNorm(spec.in_ch, eps=1e-5)
        self.attn = MultiscaleAttention(spec, thw)
        self.norm2 = nn.LayerNorm(spec.out_ch, eps=1e-5)
        hidden = int(spec.out_ch * mlp_ratio)
        # torchvision MLP: Linear, GELU, Dropout, Linear, Dropout
        self.mlp = nn.Sequential(nn.Linear(spec.out_ch, hidden), Gelu(),
                                 nn.Dropout(0.0),
                                 nn.Linear(hidden, spec.out_ch),
                                 nn.Dropout(0.0))
        self.project = (nn.Linear(spec.in_ch, spec.out_ch)
                        if spec.in_ch != spec.out_ch else None)

    def forward(self, x, thw):
        h = self.norm1(x)
        attn_out, new_thw = self.attn(h, thw)
        # the skip path widens the normed input (proj_after_attn=True)
        shortcut = x if self.project is None else self.project(h)
        if self.q_stride != (1, 1, 1):
            shortcut = skip_max_pool(shortcut, thw, self.q_stride)
        x = shortcut + attn_out
        return x + self.mlp(self.norm2(x)), new_thw


class ClassToken(nn.Module):
    """torchvision's ``pos_encoding`` under ``rel_pos_embed``: only the
    class token, prepended."""

    def __init__(self, dim: int):
        super().__init__()
        self.class_token = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        cls = self.class_token.to(x.dtype).expand(x.shape[0], 1, -1)
        return torch.cat([cls, x], dim=1)


class MViTV2(nn.Module):
    """MViTv2 clip features: the final LayerNorm's CLS token (B, 768), what
    TSP keeps with the classifier stripped (TSPmodel.py:82-85).  The
    patchify stem is the plain 3x7x7 conv of stride (2, 4, 4)."""

    def __init__(self, cfg: MViTConfig = MViTConfig()):
        super().__init__()
        self.cfg = cfg
        specs = mvit_block_specs(cfg)
        self.feature_size = specs[-1].out_ch
        self.conv_proj = nn.Conv3d(3, cfg.embed_dim, (3, 7, 7),
                                   stride=(2, 4, 4), padding=(1, 3, 3))
        self.pos_encoding = ClassToken(cfg.embed_dim)
        blocks, thw = [], patch_grid(cfg)
        for spec in specs:
            blocks.append(MultiscaleBlock(spec, thw, cfg.mlp_ratio))
            thw = pooled(thw, spec.q_stride)
        self.blocks = nn.ModuleList(blocks)
        self.norm = nn.LayerNorm(self.feature_size, eps=1e-5)

    def forward(self, x):
        x = self.conv_proj(x)
        thw = tuple(x.shape[2:])
        x = self.pos_encoding(_tokens(x))
        for block in self.blocks:
            x, thw = block(x, thw)
        return self.norm(x)[:, 0]


def mvit_v2_s(config=None, mid_layout='block'):
    return MViTV2(config or MViTConfig())
