"""LSTM-DSA caption head: greedy decode and teacher forcing (port of the
fused paths of ``dvc_tpu/models/caption_heads.py::DSACaptionHead``).

The port covers what ``num_layers=1, att_hid_size>0`` with the fused
greedy decode (``sample_max=1``) and the fused teacher-forcing scan
(scheduled sampling off) select.  Everything step-invariant (the value
projection, the event query's share of the sampling offsets folded into
``base_pos``, ``scale_t`` and the query's share of the LSTM preactivation)
is computed here with plain tensor ops; the K word steps run in
:func:`dvc_tpu_torch.ops.dsa_greedy_scan` (decode) or
:func:`dvc_tpu_torch.ops.dsa_teacher_scan` (training), and the vocab
projection and log-softmax of teacher forcing follow the scan.

Parameter names follow the reference state_dict
(``caption_head.{i}.embed``, ``.logit``, ``.core.rnn.weight_ih_l0``,
``.core.deformable_att.{sampling_offsets,value_proj}``,
``.core.{ctx2att,h2att,alpha_net}``); the reference's dead
``core.deformable_att.attention_weights/output_proj`` are not created.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import dsa_greedy_scan, dsa_teacher_scan, greedy_mask_outputs
from .deformable_transformer import dropout


def caption_nll(logprobs, target, mask):
    """Masked NLL per caption (reference ``LSTM.py:51-55``): logprobs
    (..., L, V+1), target/mask (..., L) -> -sum(logprob[target]) / len."""
    picked = torch.gather(logprobs, -1, target.long()[..., None])[..., 0]
    m = mask.to(logprobs.dtype)
    return -(picked * m).sum(-1) / (m.sum(-1) + 1e-6)


@dataclasses.dataclass(frozen=True)
class CaptionHeadConfig:
    vocab_size: int
    input_encoding_size: int
    rnn_size: int
    num_layers: int
    max_caption_len: int
    hidden_dim: int
    drop_prob: float = 0.0
    att_hid_size: int = 512
    cap_nheads: int = 8
    cap_dec_n_points: int = 4
    cap_num_feature_levels: int = 4


class _LSTMWeights(nn.Module):
    """Weights of the bias-free one-layer ``nn.LSTM`` of the reference."""

    def __init__(self, in_dim, rnn_size):
        super().__init__()
        self.weight_ih_l0 = nn.Parameter(torch.empty(4 * rnn_size, in_dim))
        self.weight_hh_l0 = nn.Parameter(torch.empty(4 * rnn_size, rnn_size))


class _DeformableSampler(nn.Module):
    def __init__(self, rnn_size, d, n_offsets):
        super().__init__()
        self.sampling_offsets = nn.Linear(rnn_size + d, n_offsets)
        self.value_proj = nn.Linear(d, d)


class _DSACore(nn.Module):
    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__()
        d, R, A = cfg.hidden_dim, cfg.rnn_size, cfg.att_hid_size
        H = cfg.cap_nheads
        HLP = H * cfg.cap_num_feature_levels * cfg.cap_dec_n_points
        self.rnn = _LSTMWeights(cfg.input_encoding_size + 2 * d, R)
        self.deformable_att = _DeformableSampler(R, d, HLP)
        self.ctx2att = nn.Linear(d // H, A)
        self.h2att = nn.Linear(R, A)
        self.alpha_net = nn.Linear(A, 1)


class DSACaptionHead(nn.Module):
    """'standard' head, LSTM-DSA: greedy decode of every event query, and
    teacher forcing of the matched ones in training."""

    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__()
        if cfg.num_layers != 1 or cfg.att_hid_size <= 0:
            raise NotImplementedError(
                'the port decodes with the fused greedy path, which needs '
                'num_layers == 1 and att_hid_size > 0')
        self.cfg = cfg
        V1 = cfg.vocab_size + 1
        self.embed = nn.Embedding(V1, cfg.input_encoding_size)
        self.logit = nn.Linear(cfg.rnn_size, V1)
        self.core = _DSACore(cfg)

    def _hoist(self, query, ref_center, offset_scale, memory,
               temporal_shapes, pad_mask):
        """Step-invariant operands of both scans.  query (B, Pq, d);
        ref_center/offset_scale (B, Pq, L): sampling location = center +
        offset * scale per level; memory (B, S, d); pad_mask (B, S) True =
        pad."""
        cfg = self.cfg
        B, Pq, d = query.shape
        H, L, P = cfg.cap_nheads, cfg.cap_num_feature_levels, cfg.cap_dec_n_points
        Dh, R, E = d // H, cfg.rnn_size, cfg.input_encoding_size
        core = self.core
        att = core.deformable_att

        value = att.value_proj(memory)
        if pad_mask is not None:
            value = value.masked_fill(pad_mask[..., None], 0.0)
        value_t = value.reshape(B, -1, H, Dh).permute(0, 2, 1, 3)

        # the step-invariant share of the offsets goes into the base
        # positions: pos = (ref + off * scale) * T_l - 0.5, f32
        off_w = att.sampling_offsets.weight                   # (HLP, R + d)
        off_const = (query @ off_w[:, R:].T
                     + att.sampling_offsets.bias).reshape(B, Pq, H, L, P)
        t_vec = torch.tensor(temporal_shapes, dtype=torch.float32,
                             device=query.device)
        base = ((ref_center[:, :, None, :, None]
                 + off_const * offset_scale[:, :, None, :, None])
                * t_vec[None, None, None, :, None] - 0.5)
        base_pos = base.permute(0, 2, 1, 3, 4).reshape(B, H, Pq, L * P)
        scale_t = (offset_scale[:, :, :, None] * t_vec[None, None, :, None]
                   ).expand(B, Pq, L, P).reshape(B, Pq, L * P)

        w_ih = core.rnn.weight_ih_l0                          # (4R, E + 2d)
        const_z = (query.reshape(B * Pq, d) @ w_ih[:, E + d:].T
                   ).reshape(B, Pq, 4 * R)
        off_w_h = off_w[:, :R].T.reshape(R, H, L * P).permute(1, 0, 2)
        step_args = (off_w_h, core.h2att.weight.T, core.h2att.bias,
                     core.ctx2att.weight.T, core.ctx2att.bias,
                     core.alpha_net.weight[0], core.alpha_net.bias[0],
                     w_ih[:, E:E + d].T.reshape(H, Dh, 4 * R),
                     core.rnn.weight_hh_l0.T)
        return value_t, base_pos, scale_t, const_z, w_ih[:, :E].T, step_args

    def forward(self, query, ref_center, offset_scale, memory,
                temporal_shapes, pad_mask):
        """Greedy decode.  Arguments as :meth:`_hoist`.  Returns (seq,
        logprobs), each (B*Pq, max_caption_len)."""
        B, Pq, _ = query.shape
        K = self.cfg.max_caption_len
        value_t, base_pos, scale_t, const_z, token_w, (
            off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh) = \
            self._hoist(query, ref_center, offset_scale, memory,
                        temporal_shapes, pad_mask)
        tok, lp = dsa_greedy_scan(
            value_t, base_pos, scale_t, const_z, self.embed.weight, token_w,
            self.logit.weight.T, self.logit.bias, off_w_h, h2att_w, h2att_b,
            cw, cb, aw, ab, ctx_w3, w_hh, tuple(temporal_shapes),
            K)                                                # (B, K, Pq)
        seq, lps = greedy_mask_outputs(tok, lp)
        return (seq.permute(0, 2, 1).reshape(B * Pq, K),
                lps.permute(0, 2, 1).reshape(B * Pq, K))

    def teacher_forcing(self, query, ref_center, offset_scale, memory,
                        temporal_shapes, pad_mask, seq, gen=None):
        """Teacher-forced word scan over the gt tokens seq (B*Pq, Lc) with
        scheduled sampling off; other arguments as :meth:`_hoist`.  With
        ``gen`` the hidden states get dropout (drop_prob) before the vocab
        projection.  Returns log-probabilities (B*Pq, Lc - 1, V+1)."""
        B, Pq, _ = query.shape
        K = seq.shape[-1] - 1
        value_t, base_pos, scale_t, const_z, token_w, step_args = \
            self._hoist(query, ref_center, offset_scale, memory,
                        temporal_shapes, pad_mask)
        # z_all directly in the scan's (B, K, Pq, 4R) order
        tokens = seq[:, :-1].reshape(B, Pq, K).transpose(1, 2)
        z_all = self.embed(tokens.long()) @ token_w + const_z[:, None]
        hs = dsa_teacher_scan(value_t, base_pos, scale_t, z_all, *step_args,
                              tuple(temporal_shapes))         # (B, K, Pq, R)
        hs = hs.transpose(1, 2).reshape(B * Pq, K, -1)
        hs = dropout(hs, self.cfg.drop_prob, gen)
        return torch.log_softmax(self.logit(hs), dim=-1)


def truncate_levels(cfg: CaptionHeadConfig, temporal_shapes, memory,
                    pad_mask, ref_center, offset_scale):
    """Restrict the caption head to its first ``cap_num_feature_levels``."""
    L = cfg.cap_num_feature_levels
    if L >= len(temporal_shapes):
        return (tuple(temporal_shapes), memory, pad_mask, ref_center,
                offset_scale)
    shapes = tuple(temporal_shapes[:L])
    S = sum(shapes)
    return (shapes, memory[:, :S], pad_mask[:, :S], ref_center[..., :L],
            offset_scale[..., :L])
