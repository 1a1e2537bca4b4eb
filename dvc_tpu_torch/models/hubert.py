"""HuBERT-base in plain PyTorch: the audio encoder whose last layer the
fusion model's sound features pool (reference ``NewModel.py:35-37``, which
loads ``facebook/hubert-base-ls960``; the JAX package runs
``transformers.HubertModel``, ``dvc_tpu/data/audio.py``).

It computes what ``transformers.HubertModel(config).eval()`` computes for
that checkpoint's layout (``feat_extract_norm='group'``,
``do_stable_layer_norm=False``): seven 1-D convolutions of the waveform (a
GroupNorm of one channel a group on the first only, exact GELU), a
LayerNorm and a Linear projection, a grouped positional convolution
(weight-normed over its kernel axis, its last output dropped for an even
kernel, GELU) added to its input, a LayerNorm, then post-LN encoder layers
(self-attention, FFN).  Masking (``masked_spec_embed``, kept so the key
sets match) and dropout belong to training and are never applied.

Module names follow the Hugging Face ``state_dict``, so
``load_state_dict(strict=True)`` is the weight bridge; the positional
convolution's weight norm loads from either spelling,
``weight_g``/``weight_v`` or ``parametrizations.weight.original0/1``.
"""

from __future__ import annotations

import dataclasses
import json

import torch
from torch import nn
from torch.nn import functional as F


@dataclasses.dataclass
class HubertConfig:
    """The fields of a Hugging Face HuBERT ``config.json`` that this
    layout reads; the defaults are ``facebook/hubert-base-ls960``'s."""
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = 'gelu'
    feat_extract_activation: str = 'gelu'
    feat_extract_norm: str = 'group'
    feat_proj_layer_norm: bool = True
    conv_dim: tuple = (512,) * 7
    conv_stride: tuple = (5, 2, 2, 2, 2, 2, 2)
    conv_kernel: tuple = (10, 3, 3, 3, 3, 2, 2)
    conv_bias: bool = False
    num_conv_pos_embeddings: int = 128
    num_conv_pos_embedding_groups: int = 16
    conv_pos_batch_norm: bool = False
    do_stable_layer_norm: bool = False
    layer_norm_eps: float = 1e-5
    mask_time_prob: float = 0.05
    mask_feature_prob: float = 0.0

    def __post_init__(self):
        for name in ('conv_dim', 'conv_stride', 'conv_kernel'):
            setattr(self, name, tuple(getattr(self, name)))
        if self.feat_extract_norm != 'group' or self.do_stable_layer_norm \
                or self.conv_pos_batch_norm:
            raise ValueError(
                'only the hubert-base layout is built (feat_extract_norm '
                "'group', do_stable_layer_norm False, conv_pos_batch_norm "
                f"False); got {self.feat_extract_norm!r}, "
                f'{self.do_stable_layer_norm}, {self.conv_pos_batch_norm}')
        for act in (self.hidden_act, self.feat_extract_activation):
            if act != 'gelu':
                raise ValueError(f'activation {act!r}: only exact gelu')

    @classmethod
    def from_json(cls, path: str) -> 'HubertConfig':
        """The config of a Hugging Face ``config.json`` (other keys
        ignored)."""
        with open(path) as f:
            d = json.load(f)
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in names})


class _ConvLayer(nn.Module):
    def __init__(self, c: HubertConfig, i: int):
        super().__init__()
        cin = c.conv_dim[i - 1] if i else 1
        self.conv = nn.Conv1d(cin, c.conv_dim[i], c.conv_kernel[i],
                              stride=c.conv_stride[i], bias=c.conv_bias)
        if i == 0:
            self.layer_norm = nn.GroupNorm(c.conv_dim[0], c.conv_dim[0])

    def forward(self, x):
        x = self.conv(x)
        if hasattr(self, 'layer_norm'):
            x = self.layer_norm(x)
        return F.gelu(x)


class _FeatureEncoder(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.conv_layers = nn.ModuleList(
            _ConvLayer(c, i) for i in range(len(c.conv_dim)))

    def forward(self, wave):
        x = wave[:, None]
        for layer in self.conv_layers:
            x = layer(x)
        return x


class _FeatureProjection(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        if c.feat_proj_layer_norm:
            self.layer_norm = nn.LayerNorm(c.conv_dim[-1],
                                           eps=c.layer_norm_eps)
        self.projection = nn.Linear(c.conv_dim[-1], c.hidden_size)

    def forward(self, x):
        if hasattr(self, 'layer_norm'):
            x = self.layer_norm(x)
        return self.projection(x)


class _PositionalConv(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        k = c.num_conv_pos_embeddings
        self.conv = nn.utils.parametrizations.weight_norm(
            nn.Conv1d(c.hidden_size, c.hidden_size, k, padding=k // 2,
                      groups=c.num_conv_pos_embedding_groups),
            name='weight', dim=2)
        self.remove = 1 if k % 2 == 0 else 0

    def forward(self, x):                       # (B, T, D)
        y = self.conv(x.transpose(1, 2))
        if self.remove:
            y = y[:, :, :-self.remove]
        return F.gelu(y).transpose(1, 2)


class _Attention(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        d = c.hidden_size
        self.heads = c.num_attention_heads
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.q_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x):
        B, T, D = x.shape
        dh = D // self.heads

        def split(y):
            return y.view(B, T, self.heads, dh).transpose(1, 2)
        q = split(self.q_proj(x))
        k, v = split(self.k_proj(x)), split(self.v_proj(x))
        w = torch.softmax(q @ k.transpose(2, 3) * dh ** -0.5, dim=-1)
        return self.out_proj((w @ v).transpose(1, 2).reshape(B, T, D))


class _FeedForward(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.intermediate_dense = nn.Linear(c.hidden_size,
                                            c.intermediate_size)
        self.output_dense = nn.Linear(c.intermediate_size, c.hidden_size)

    def forward(self, x):
        return self.output_dense(F.gelu(self.intermediate_dense(x)))


class _EncoderLayer(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.attention = _Attention(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.feed_forward = _FeedForward(c)
        self.final_layer_norm = nn.LayerNorm(c.hidden_size,
                                             eps=c.layer_norm_eps)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _Encoder(nn.Module):
    def __init__(self, c: HubertConfig):
        super().__init__()
        self.pos_conv_embed = _PositionalConv(c)
        self.layer_norm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps)
        self.layers = nn.ModuleList(
            _EncoderLayer(c) for _ in range(c.num_hidden_layers))

    def forward(self, x):
        x = self.layer_norm(x + self.pos_conv_embed(x))
        for layer in self.layers:
            x = layer(x)
        return x


# the old spelling of the positional convolution's weight norm
# (torch.nn.utils.weight_norm, as hub checkpoints store it) -> the module's
_WEIGHT_NORM_NAMES = {'weight_g': 'parametrizations.weight.original0',
                      'weight_v': 'parametrizations.weight.original1'}


class Hubert(nn.Module):
    """HuBERT-base on ``device`` (the card unless the caller asks for the
    CPU), in eval mode: ``forward(wave)`` takes (B, samples) 16 kHz
    waveforms (at least 400 samples, the conv stack's minimum) and returns
    the last hidden state (B, frames, hidden_size)."""

    def __init__(self, config: HubertConfig | None = None, device='cuda'):
        super().__init__()
        c = self.config = config or HubertConfig()
        self.feature_extractor = _FeatureEncoder(c)
        self.feature_projection = _FeatureProjection(c)
        if c.mask_time_prob > 0 or c.mask_feature_prob > 0:
            self.masked_spec_embed = nn.Parameter(
                torch.empty(c.hidden_size).uniform_())
        self.encoder = _Encoder(c)
        self._register_load_state_dict_pre_hook(self._rename_weight_norm)
        self.to(device).eval()

    @staticmethod
    def _rename_weight_norm(state_dict, prefix, *args):
        conv = f'{prefix}encoder.pos_conv_embed.conv.'
        for old, new in _WEIGHT_NORM_NAMES.items():
            if conv + old in state_dict:
                state_dict[conv + new] = state_dict.pop(conv + old)

    def forward(self, wave):
        x = self.feature_extractor(wave).transpose(1, 2)
        return self.encoder(self.feature_projection(x))

