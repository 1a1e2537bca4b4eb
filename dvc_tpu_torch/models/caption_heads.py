"""LSTM-DSA caption head: greedy decode and teacher forcing (port of
``dvc_tpu/models/caption_heads.py::DSACaptionHead`` for ``num_layers=1,
att_hid_size>0`` and greedy decoding, ``sample_max=1``).

Everything step-invariant (the value projection, the event query's share
of the sampling offsets folded into ``base_pos``, ``scale_t`` and the
query's share of the LSTM preactivation) is computed once with plain tensor
ops (:meth:`DSACaptionHead._hoist`).  The word steps then run, as the JAX
head dispatches them:

* fused, one launch for all K steps: :func:`dvc_tpu_torch.ops.dsa_greedy_scan`
  (decode, ``greedy_fuse``) and :func:`dvc_tpu_torch.ops.dsa_teacher_scan`
  (teacher forcing, ``scan_fuse`` with scheduled sampling off);
* stepwise, one launch per step (``_step``): scheduled sampling, or either
  flag off.  Each step's sampling positions and hvec come from h here; the
  step itself reads the table ``VW = value_t . Wc`` that the head builds
  once per forward pass (:func:`dvc_tpu_torch.ops.dsa_tables.dsa_value_table`;
  its backward then runs once per backward pass, on the sum of the steps'
  gradients): :func:`dvc_tpu_torch.ops.dsa_step.dsa_sample_attend_table_core`
  with the LSTM cell in tensor ops, or with ``lstm_fuse``
  :func:`dvc_tpu_torch.ops.dsa_step.dsa_lstm_step_table_core`, the cell
  included.

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

from ..ops import (dsa_greedy_scan, dsa_teacher_scan, greedy_mask_outputs,
                   greedy_pick, lstm_cell, step_pos_hvec)
from ..ops.dsa_step import (dsa_lstm_step_table_core,
                            dsa_sample_attend_table_core)
from ..ops.dsa_tables import dsa_value_table
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
    # --dsa_scan_fuse, --dsa_greedy_fuse, --dsa_lstm_fuse (the JAX head's
    # attributes): the fused teacher-forcing scan (when scheduled sampling
    # is off), the fused greedy decode, and the LSTM cell inside the
    # stepwise path's word-step kernel
    scan_fuse: bool = True
    greedy_fuse: bool = True
    lstm_fuse: bool = False


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

    # the tokens that scheduled sampling fed in place of the gt token,
    # summed per device without a host sync; read with fed_sample_count()
    # and reset (clear()) like the kernels' launch counts
    fed_samples: dict = {}

    @classmethod
    def fed_sample_count(cls) -> int:
        return sum(int(v) for v in cls.fed_samples.values())

    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__()
        if cfg.num_layers != 1 or cfg.att_hid_size <= 0:
            raise NotImplementedError(
                'the port covers num_layers == 1 and att_hid_size > 0')
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

    def _value_table(self, hoisted):
        """The stepwise path's per-video table VW = value_t . Wc
        (B, H, S, A), built once per forward pass for all its word
        steps."""
        value_t, _, _, _, _, (_, _, _, cw, *_) = hoisted
        return dsa_value_table(value_t, cw)

    def _step(self, hoisted, vw, z0, h, c, temporal_shapes):
        """One word step of the stepwise path (the JAX ``_make_core``'s
        ``run``): vw the table of ``_value_table``, z0 (B, Pq, 4R) the
        token's and query's share of the preactivation, (h, c) (B, Pq, R)
        the state.  Returns (h, c)."""
        value_t, base_pos, scale_t, _, _, (
            off_w_h, h2att_w, h2att_b, _, cb, aw, ab, ctx_w3, w_hh) = hoisted
        pos, hvec = step_pos_hvec(h, base_pos, scale_t, off_w_h, h2att_w,
                                  h2att_b)
        if self.cfg.lstm_fuse:
            return dsa_lstm_step_table_core(value_t, vw, pos, hvec, z0, h, c,
                                            ctx_w3, w_hh, cb, aw, ab,
                                            temporal_shapes)
        ctx = dsa_sample_attend_table_core(value_t, vw, pos, hvec, cb, aw, ab,
                                           temporal_shapes)   # (B, H, Pq, Dh)
        return lstm_cell(z0 + h @ w_hh
                         + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3), c)

    def forward(self, query, ref_center, offset_scale, memory,
                temporal_shapes, pad_mask):
        """Greedy decode.  Arguments as :meth:`_hoist`.  Returns (seq,
        logprobs), each (B*Pq, max_caption_len)."""
        B, Pq, _ = query.shape
        K = self.cfg.max_caption_len
        hoisted = self._hoist(query, ref_center, offset_scale, memory,
                              temporal_shapes, pad_mask)
        value_t, base_pos, scale_t, const_z, token_w, (
            off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh) = hoisted
        temporal_shapes = tuple(temporal_shapes)
        if self.cfg.greedy_fuse:
            tok, lp = dsa_greedy_scan(
                value_t, base_pos, scale_t, const_z, self.embed.weight,
                token_w, self.logit.weight.T, self.logit.bias, off_w_h,
                h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh,
                temporal_shapes, K)                           # (B, K, Pq)
        else:
            tok, lp = self._greedy_stepwise(hoisted, temporal_shapes)
        seq, lps = greedy_mask_outputs(tok, lp)
        return (seq.permute(0, 2, 1).reshape(B * Pq, K),
                lps.permute(0, 2, 1).reshape(B * Pq, K))

    def _greedy_stepwise(self, hoisted, temporal_shapes):
        """The JAX ``_greedy_sample``: BOS feeds step 0, each step feeds its
        first-max argmax to the next, lp = max - logsumexp; the token
        embedding's share of the preactivation is one (V+1, 4R) table.
        Returns the raw (tok, lp) streams, each (B, K, Pq)."""
        value_t, _, _, const_z, token_w, _ = hoisted
        B, Pq, R4 = const_z.shape
        token_z = self.embed.weight @ token_w                 # (V+1, 4R)
        vw = self._value_table(hoisted)
        h = value_t.new_zeros((B, Pq, R4 // 4))
        c = torch.zeros_like(h)
        it = torch.zeros((B, Pq), dtype=torch.long, device=value_t.device)
        toks, lps = [], []
        for _ in range(self.cfg.max_caption_len):
            h, c = self._step(hoisted, vw, token_z[it] + const_z, h, c,
                              temporal_shapes)
            it, lp = greedy_pick(self.logit(h))
            toks.append(it.to(torch.int32))
            lps.append(lp)
        return torch.stack(toks, 1), torch.stack(lps, 1)

    @staticmethod
    def scheduled_tokens(lp, tok, u, gumbel, ss_prob):
        """Scheduled sampling's input tokens at a step i >= 1: where
        u < ss_prob a sample of the previous step's distribution lp,
        argmax(lp + gumbel) (``jax.random.categorical``), else the gt token
        tok.  No gradient flows through the sampled index."""
        return torch.where(u < ss_prob,
                           torch.argmax(lp.detach() + gumbel, dim=-1), tok)

    def teacher_forcing(self, query, ref_center, offset_scale, memory,
                        temporal_shapes, pad_mask, seq, gen=None, ss_prob=0.0,
                        noise=None):
        """Teacher-forced word scan over the gt tokens seq (B*Pq, Lc); other
        arguments as :meth:`_hoist`.  With ``gen`` (a ``torch.Generator`` on
        the device) the hidden states get dropout (drop_prob) before the
        vocab projection.  With ``ss_prob > 0`` (scheduled sampling) step
        i >= 1 is fed, where u_i < ss_prob, a sample of step i-1's
        distribution in place of the gt token: argmax(lp + Gumbel noise), as
        ``jax.random.categorical``.  The uniforms u (K, B*Pq) and the Gumbel
        noise (K, B*Pq, V+1) are drawn from ``gen`` step by step, or taken
        from ``noise = (u, gumbel)``.  Returns log-probabilities
        (B*Pq, Lc - 1, V+1)."""
        cfg = self.cfg
        B, Pq, _ = query.shape
        n, K, R = B * Pq, seq.shape[-1] - 1, cfg.rnn_size
        temporal_shapes = tuple(temporal_shapes)
        hoisted = self._hoist(query, ref_center, offset_scale, memory,
                              temporal_shapes, pad_mask)
        value_t, base_pos, scale_t, const_z, token_w, step_args = hoisted
        if cfg.scan_fuse and ss_prob == 0:
            # z_all directly in the scan's (B, K, Pq, 4R) order
            tokens = seq[:, :-1].reshape(B, Pq, K).transpose(1, 2)
            z_all = self.embed(tokens.long()) @ token_w + const_z[:, None]
            hs = dsa_teacher_scan(value_t, base_pos, scale_t, z_all,
                                  *step_args, temporal_shapes)  # (B, K, Pq, R)
            hs = hs.transpose(1, 2).reshape(n, K, R)
            hs = dropout(hs, cfg.drop_prob, gen)
            return torch.log_softmax(self.logit(hs), dim=-1)

        vw = self._value_table(hoisted)
        h = value_t.new_zeros((B, Pq, R))
        c = torch.zeros_like(h)
        if ss_prob == 0:
            # the gt tokens are known: their share of the preactivation is
            # one product, and dropout and the vocab projection run once
            z_all = (self.embed(seq[:, :-1].long()) @ token_w
                     + const_z.reshape(n, 1, 4 * R)).reshape(B, Pq, K, -1)
            hs = []
            for k in range(K):
                h, c = self._step(hoisted, vw, z_all[:, :, k], h, c,
                                  temporal_shapes)
                hs.append(h)
            hs = dropout(torch.stack(hs, 2).reshape(n, K, R), cfg.drop_prob,
                         gen)
            return torch.log_softmax(self.logit(hs), dim=-1)

        # without gen (no dropout) the draws come from a fixed seed, as the
        # JAX head's PRNGKey(0) when deterministic
        draw = gen if gen is not None else torch.Generator(
            device=value_t.device).manual_seed(0)
        const_n = const_z.reshape(n, 4 * R)
        lps, lp = [], None
        for i in range(K):
            tok = seq[:, i].long()
            if i >= 1:
                if noise is None:
                    u = torch.rand((n,), generator=draw, device=tok.device)
                    gumbel = -torch.log(-torch.log(torch.rand(
                        lp.shape, generator=draw, device=tok.device
                    ).clamp_min(torch.finfo(torch.float32).tiny)))
                else:
                    u, gumbel = noise[0][i], noise[1][i]
                tok = self.scheduled_tokens(lp, tok, u, gumbel, ss_prob)
                fed = DSACaptionHead.fed_samples
                fed[tok.device] = fed.get(tok.device, 0) + (u < ss_prob).sum()
            z0 = (self.embed(tok) @ token_w + const_n).reshape(B, Pq, -1)
            h, c = self._step(hoisted, vw, z0, h, c, temporal_shapes)
            out = dropout(h.reshape(n, R), cfg.drop_prob, gen)
            lp = torch.log_softmax(self.logit(out), dim=-1)
            lps.append(lp)
        return torch.stack(lps, 1)


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
