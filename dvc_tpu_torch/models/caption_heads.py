"""Caption heads: the LSTM-DSA ('standard') head and the 'light' LSTM
head, greedy and temperature-sampling decode and teacher forcing (port of
``dvc_tpu/models/caption_heads.py``; the 'none' type has no head).

Both run a bias-free LSTM of ``num_layers`` layers (:func:`lstm_step_pre`)
whose layer-0 input is [token embedding ; ...]: the light head's
[token ; query feature], the DSA head's [token ; visual context ; query].
What does not change across word steps is hoisted out of the loop.

LSTM-DSA: everything step-invariant (the value projection, the event
query's share of the sampling offsets folded into ``base_pos``,
``scale_t`` and the query's share of the LSTM preactivation) is computed
once with plain tensor ops (:meth:`DSACaptionHead._hoist`).  The word
steps then run, as the JAX head dispatches them:

* fused, one launch for all K steps, for the one-layer core with
  attention (``num_layers == 1``, ``att_hid_size > 0``):
  :func:`dvc_tpu_torch.ops.dsa_greedy_scan` (decode, ``greedy_fuse``) and
  :func:`dvc_tpu_torch.ops.dsa_teacher_scan` (teacher forcing,
  ``scan_fuse`` with scheduled sampling off);
* stepwise, one launch per step (``_step``): scheduled sampling, the
  sampling decode (``--caption_sample_max 0``), either flag off, or a core
  that is not fusable.  Each step's sampling positions and hvec come from
  the top layer's h; the step itself reads the table ``VW = value_t . Wc``
  that the head builds once per forward pass
  (:func:`dvc_tpu_torch.ops.dsa_tables.dsa_value_table`; its backward then
  runs once per backward pass, on the sum of the steps' gradients):
  :func:`dvc_tpu_torch.ops.dsa_step.dsa_sample_attend_table_core` with the
  LSTM in tensor ops, or, with ``lstm_fuse`` and one layer,
  :func:`dvc_tpu_torch.ops.dsa_step.dsa_lstm_step_table_core`, the cell
  included.  With ``att_hid_size`` 0 there is no attention: the context
  is the mean of the border-mode taps
  (:func:`dvc_tpu_torch.ops.ms_deform_attn_sample_values`, a plain gather
  as in JAX).

Under ``--tpu_compute_dtype bfloat16`` (``precision``) each route runs its
kernels' bf16-operand mode, as the JAX head passes ``att_precision`` to
them: K4-K6, and on the stepwise path the table and K7/K8 or K9/K10.  On
the card the stepwise path rounds the kernels' operands value_t (and, for
K9/K10, ctx_w3 and w_hh) once per forward pass
(:meth:`DSACaptionHead._stepper`); the products around the kernels
(hvec, the offsets, ``ctx . ctx_w`` and the LSTM layers outside K9) stay
f32, as in JAX.  On the CPU its plain bf16 word steps take Wc in place of
the table: the TPU kernels' product form, as the fused scan's plain bf16
version does, whose rounding points the tests hold to JAX (the card's
table form lies apart by ROADMAP C's gap).

The light head's word steps are plain tensor ops, as JAX runs them.

Parameter names follow the reference state_dict
(``caption_head.{i}.embed``, ``.logit``, ``.core.rnn.weight_ih_l{l}``,
``.core.deformable_att.{sampling_offsets,value_proj}``,
``.core.{ctx2att,h2att,alpha_net}`` where att_hid_size > 0); the
reference's dead ``core.deformable_att.attention_weights/output_proj`` are
not created.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops import (dsa_greedy_scan, dsa_teacher_scan, greedy_mask_outputs,
                   greedy_pick, lstm_cell, ms_deform_attn_sample_values,
                   step_pos_hvec)
from ..ops.dsa_bf16 import RoundBf16
from ..ops.dsa_step import (dsa_lstm_step_core, dsa_lstm_step_table_core,
                            dsa_sample_attend_core,
                            dsa_sample_attend_table_core)
from ..ops.dsa_tables import dsa_value_table
from .deformable_transformer import dropout


def caption_nll(logprobs, target, mask):
    """Masked NLL per caption (reference ``LSTM.py:51-55``): logprobs
    (..., L, V+1), target/mask (..., L) -> -sum(logprob[target]) / len."""
    picked = torch.gather(logprobs, -1, target.long()[..., None])[..., 0]
    m = mask.to(logprobs.dtype)
    return -(picked * m).sum(-1) / (m.sum(-1) + 1e-6)


def gumbel_noise(shape, gen, device):
    """Standard Gumbel noise drawn from ``gen``: argmax(lp + noise) is a
    sample of the distribution exp(lp), as ``jax.random.categorical``."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def sample_pick(logits, temperature, gen):
    """A sampling step's choice from its raw logits (..., V+1) (the JAX
    ``_stochastic_sample``'s ``pick``): a token drawn from
    exp(logprobs / temperature), and its unscaled log-probability."""
    lp = torch.log_softmax(logits, dim=-1)
    it = torch.argmax(lp / temperature
                      + gumbel_noise(lp.shape, gen, lp.device), dim=-1)
    return it, torch.gather(lp, -1, it[..., None])[..., 0]


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
    # --tpu_compute_dtype: the caption kernels' products on bf16 operands
    # under 'bfloat16' (the JAX head's att_precision), on every route; the
    # hoisted products stay f32, since the head's query and memory arrive
    # in f32
    precision: str = 'float32'


class _LSTMWeights(nn.Module):
    """Weights of the bias-free ``nn.LSTM`` of the reference, one
    ``weight_ih_l{l}`` and ``weight_hh_l{l}`` per layer: layer 0 reads
    in_dim features, the layers above the hidden state of the layer
    below."""

    def __init__(self, in_dim, rnn_size, num_layers=1):
        super().__init__()
        self.num_layers = num_layers
        for l in range(num_layers):
            self.register_parameter(f'weight_ih_l{l}', nn.Parameter(
                torch.empty(4 * rnn_size, in_dim if l == 0 else rnn_size)))
            self.register_parameter(f'weight_hh_l{l}', nn.Parameter(
                torch.empty(4 * rnn_size, rnn_size)))

    def layers(self):
        """[(weight_ih_l{l}, weight_hh_l{l})] in layer order."""
        return [(getattr(self, f'weight_ih_l{l}'),
                 getattr(self, f'weight_hh_l{l}'))
                for l in range(self.num_layers)]


def lstm_step_pre(layers, z0, h, c):
    """One step of the multi-layer bias-free LSTM with layer 0's input
    preactivation z0 (..., 4R) given (the JAX ``_LSTMParams.step_pre``):
    layer l > 0 takes the new h of the layer below.  ``layers`` as
    :meth:`_LSTMWeights.layers`; h, c (num_layers, ..., R).  Returns the
    new (h, c), stacked the same way."""
    hs, cs = [], []
    for l, (w_ih, w_hh) in enumerate(layers):
        z = (z0 if l == 0 else hs[-1] @ w_ih.T) + h[l] @ w_hh.T
        h_l, c_l = lstm_cell(z, c[l])
        hs.append(h_l)
        cs.append(c_l)
    return torch.stack(hs), torch.stack(cs)


class _CaptionHead(nn.Module):
    """What the light and the LSTM-DSA heads share: the token embedding,
    the vocab projection, the stepwise decode loop (greedy or sampling) and
    the stepwise teacher-forcing loop (scheduled sampling included), each
    around the head's own word step ``step(z0, (h, c)) -> (h, c)``."""

    # the tokens that scheduled sampling fed in place of the gt token,
    # summed per device without a host sync; read with fed_sample_count()
    # and reset (clear()) like the kernels' launch counts
    fed_samples: dict = {}

    @classmethod
    def fed_sample_count(cls) -> int:
        return sum(int(v) for v in cls.fed_samples.values())

    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__()
        self.cfg = cfg
        V1 = cfg.vocab_size + 1
        self.embed = nn.Embedding(V1, cfg.input_encoding_size)
        self.logit = nn.Linear(cfg.rnn_size, V1)

    @staticmethod
    def scheduled_tokens(lp, tok, u, gumbel, ss_prob):
        """Scheduled sampling's input tokens at a step i >= 1: where
        u < ss_prob a sample of the previous step's distribution lp,
        argmax(lp + gumbel) (``jax.random.categorical``), else the gt token
        tok.  No gradient flows through the sampled index."""
        return torch.where(u < ss_prob,
                           torch.argmax(lp.detach() + gumbel, dim=-1), tok)

    def _zero_state(self, const_z):
        h = const_z.new_zeros((self.cfg.num_layers, *const_z.shape[:-1],
                               self.cfg.rnn_size))
        return h, torch.zeros_like(h)

    @staticmethod
    def _picker(sample_max, temperature, gen, device):
        """The token choice of a decode step from its raw logits: greedy,
        or (``sample_max`` off) a draw at ``temperature`` from ``gen``
        (without one a fixed seed, so the decode repeats)."""
        if sample_max:
            return greedy_pick
        draw = gen if gen is not None else torch.Generator(
            device=device).manual_seed(0)
        return lambda logits: sample_pick(logits, temperature, draw)

    def _decode_steps(self, step, token_w, const_z, pick):
        """The JAX ``_greedy_sample`` (``pick`` = :func:`greedy_pick`) and
        ``_stochastic_sample`` (:func:`sample_pick`) as K word steps: BOS
        feeds step 0, each step feeds the token that ``pick`` chose from
        its logits to the next; the token embedding's share of the
        preactivation is one (V+1, 4R) table, const_z (..., 4R) the rest.
        Returns the raw (tok, lp) streams, each (lead[0], K, *lead[1:])
        for const_z's leading dims lead."""
        token_z = self.embed.weight @ token_w                 # (V+1, 4R)
        state = self._zero_state(const_z)
        it = torch.zeros(const_z.shape[:-1], dtype=torch.long,
                         device=const_z.device)
        toks, lps = [], []
        for _ in range(self.cfg.max_caption_len):
            state = step(token_z[it] + const_z, state)
            it, lp = pick(self.logit(state[0][-1]))
            toks.append(it.to(torch.int32))
            lps.append(lp)
        return torch.stack(toks, 1), torch.stack(lps, 1)

    def _teacher_steps(self, step, token_w, const_z, seq, gen, ss_prob,
                       noise):
        """Stepwise teacher forcing over the gt tokens seq (n, Lc), n the
        number of rows of const_z (..., 4R); dropout (drop_prob, masks
        from ``gen``) before the vocab projection; scheduled sampling as
        :meth:`DSACaptionHead.teacher_forcing`.  Returns log-probabilities
        (n, Lc - 1, V+1)."""
        cfg = self.cfg
        lead = const_z.shape[:-1]
        n, K, R = seq.shape[0], seq.shape[-1] - 1, cfg.rnn_size
        const_n = const_z.reshape(n, -1)
        state = self._zero_state(const_z)
        if ss_prob == 0:
            # the gt tokens are known: their share of the preactivation is
            # one product, and dropout and the vocab projection run once
            z_all = self.embed(seq[:, :-1].long()) @ token_w + const_n[:, None]
            hs = []
            for k in range(K):
                state = step(z_all[:, k].reshape(*lead, -1), state)
                hs.append(state[0][-1].reshape(n, R))
            hs = dropout(torch.stack(hs, 1), cfg.drop_prob, gen)
            return torch.log_softmax(self.logit(hs), dim=-1)

        # without gen (no dropout) the draws come from a fixed seed, as the
        # JAX head's PRNGKey(0) when deterministic
        draw = gen if gen is not None else torch.Generator(
            device=const_z.device).manual_seed(0)
        lps, lp = [], None
        for i in range(K):
            tok = seq[:, i].long()
            if i >= 1:
                if noise is None:
                    u = torch.rand((n,), generator=draw, device=tok.device)
                    gumbel = gumbel_noise(lp.shape, draw, tok.device)
                else:
                    u, gumbel = noise[0][i], noise[1][i]
                tok = self.scheduled_tokens(lp, tok, u, gumbel, ss_prob)
                fed = _CaptionHead.fed_samples
                fed[tok.device] = fed.get(tok.device, 0) + (u < ss_prob).sum()
            z0 = (self.embed(tok) @ token_w + const_n).reshape(*lead, -1)
            state = step(z0, state)
            out = dropout(state[0][-1].reshape(n, R), cfg.drop_prob, gen)
            lp = torch.log_softmax(self.logit(out), dim=-1)
            lps.append(lp)
        return torch.stack(lps, 1)


class _LightCore(nn.Module):
    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__()
        self.rnn = _LSTMWeights(cfg.input_encoding_size + cfg.hidden_dim,
                                cfg.rnn_size, cfg.num_layers)


class LightCaptionHead(_CaptionHead):
    """'light' head (the JAX ``LightCaptionHead``, reference
    ``LSTM.py:141-174``): a bias-free LSTM over [token embedding ; query
    feature].  The feature's share of layer 0's preactivation is hoisted
    out of the word loop; the word steps are plain tensor ops, as in JAX
    (a ``lax.scan`` of dense ops there, no Pallas kernel).  Parameters:
    ``embed``, ``logit``, ``core.rnn.weight_{ih,hh}_l{l}``."""

    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__(cfg)
        self.core = _LightCore(cfg)

    def _hoist(self, feats):
        """(token_w (E, 4R), const_z (N, 4R)) of the query features feats
        (N, hidden_dim)."""
        E = self.cfg.input_encoding_size
        w_ih = self.core.rnn.weight_ih_l0                     # (4R, E + d)
        return w_ih[:, :E].T, feats @ w_ih[:, E:].T

    def _step(self, z0, state):
        return lstm_step_pre(self.core.rnn.layers(), z0, *state)

    def forward(self, feats, sample_max=True, temperature=1.0, gen=None):
        """Caption decode of the query features feats (N, hidden_dim),
        greedy or (``sample_max=False``) sampled at ``temperature`` from
        ``gen``.  Returns (seq, logprobs), each (N, max_caption_len), as
        :meth:`DSACaptionHead.forward`."""
        token_w, const_z = self._hoist(feats)
        tok, lp = self._decode_steps(
            self._step, token_w, const_z,
            self._picker(sample_max, temperature, gen, feats.device))
        return greedy_mask_outputs(tok, lp)

    def teacher_forcing(self, feats, seq, gen=None, ss_prob=0.0, noise=None):
        """Teacher-forced word loop over the gt tokens seq (N, Lc) of the
        query features feats (N, hidden_dim); ``gen``, ``ss_prob`` and
        ``noise`` as :meth:`DSACaptionHead.teacher_forcing`.  Returns
        log-probabilities (N, Lc - 1, V+1)."""
        token_w, const_z = self._hoist(feats)
        return self._teacher_steps(self._step, token_w, const_z, seq, gen,
                                   ss_prob, noise)


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
        self.rnn = _LSTMWeights(cfg.input_encoding_size + 2 * d, R,
                                cfg.num_layers)
        self.deformable_att = _DeformableSampler(R, d, HLP)
        if A > 0:
            # att_hid_size 0: the taps are averaged, no attention
            self.ctx2att = nn.Linear(d // H, A)
            self.h2att = nn.Linear(R, A)
            self.alpha_net = nn.Linear(A, 1)


class DSACaptionHead(_CaptionHead):
    """'standard' head, LSTM-DSA: greedy decode of every event query, and
    teacher forcing of the matched ones in training."""

    def __init__(self, cfg: CaptionHeadConfig):
        super().__init__(cfg)
        self.core = _DSACore(cfg)

    @property
    def fusable(self) -> bool:
        """Whether the fused kernels may run: the JAX head fuses only the
        one-layer core with attention (``caption_heads.py:461, :633-643``)."""
        return self.cfg.num_layers == 1 and self.cfg.att_hid_size > 0

    def _hoist(self, query, ref_center, offset_scale, memory,
               temporal_shapes, pad_mask):
        """Step-invariant operands of both scans.  query (B, Pq, d);
        ref_center/offset_scale (B, Pq, L): sampling location = center +
        offset * scale per level; memory (B, S, d); pad_mask (B, S) True =
        pad.  The last entry is the geometry of the attention-free core
        (None with attention)."""
        cfg = self.cfg
        B, Pq, d = query.shape
        H, L, P = cfg.cap_nheads, cfg.cap_num_feature_levels, cfg.cap_dec_n_points
        Dh, R, E = d // H, cfg.rnn_size, cfg.input_encoding_size
        core = self.core
        att = core.deformable_att

        value = att.value_proj(memory)
        if pad_mask is not None:
            value = value.masked_fill(pad_mask[..., None], 0.0)
        value = value.reshape(B, -1, H, Dh)
        value_t = value.permute(0, 2, 1, 3)

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
        ctx_w3 = w_ih[:, E:E + d].T.reshape(H, Dh, 4 * R)
        w_hh = core.rnn.weight_hh_l0.T
        if cfg.att_hid_size > 0:
            step_args = (off_w_h, core.h2att.weight.T, core.h2att.bias,
                         core.ctx2att.weight.T, core.ctx2att.bias,
                         core.alpha_net.weight[0], core.alpha_net.bias[0],
                         ctx_w3, w_hh)
            geom = None
        else:
            step_args = (off_w_h,) + (None,) * 6 + (ctx_w3, w_hh)
            geom = (value, ref_center, offset_scale, off_const,
                    off_w[:, :R])
        return (value_t, base_pos, scale_t, const_z, w_ih[:, :E].T,
                step_args, geom)

    def _value_table(self, hoisted):
        """The stepwise path's per-video table VW = value_t . Wc
        (B, H, S, A), built once per forward pass for all its word
        steps (in the bf16 mode under ``precision``); None for the
        attention-free core."""
        value_t, _, _, _, _, (_, _, _, cw, *_), _ = hoisted
        return None if cw is None else dsa_value_table(value_t, cw,
                                                       self.cfg.precision)

    def _mean_taps(self, geom, h_top, temporal_shapes):
        """The attention-free core's context (the JAX ``_make_core`` with
        att_hid_size 0): the border-mode taps at loc = center + (h_top's
        and the query's offsets) * scale, averaged over the levels and
        points.  Returns (B, Pq, H, Dh)."""
        value, ref_center, offset_scale, off_const, off_w_r = geom
        B, Pq, H, L, P = off_const.shape
        offsets = (h_top @ off_w_r.T).reshape(B, Pq, H, L, P) + off_const
        loc = (ref_center[:, :, None, :, None]
               + offsets * offset_scale[:, :, None, :, None])
        taps = ms_deform_attn_sample_values(value, temporal_shapes, loc)
        return taps.reshape(B, Pq, H, L * P, -1).mean(dim=3)

    def _step(self, hoisted, kernel_ops, z0, state, temporal_shapes):
        """One word step of the stepwise path (the JAX ``_make_core``'s
        ``run``): kernel_ops the word-step kernels' own operands of
        ``_stepper`` (value_t, the table VW or None, ctx_w3, w_hh), z0
        (B, Pq, 4R) the token's and query's share of layer 0's
        preactivation, state (h, c), each (num_layers, B, Pq, R).  The
        sampling positions and hvec come from the top layer's h; the context
        joins layer 0's preactivation.  Returns the new state."""
        _, base_pos, scale_t, _, _, (
            off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, _), geom = \
            hoisted
        h, c = state
        precision = self.cfg.precision
        if geom is not None:
            ctx = torch.einsum('bqhd,hdr->bqr',
                               self._mean_taps(geom, h[-1], temporal_shapes),
                               ctx_w3)
            return lstm_step_pre(self.core.rnn.layers(), z0 + ctx, h, c)
        value_k, vw, ctx_w3_k, w_hh_k = kernel_ops
        pos, hvec = step_pos_hvec(h[-1], base_pos, scale_t, off_w_h, h2att_w,
                                  h2att_b)
        if self.cfg.lstm_fuse and self.fusable:
            if vw is None:
                h1, c1 = dsa_lstm_step_core(
                    value_k, pos, hvec, z0, h[0], c[0], ctx_w3_k, w_hh_k, cw,
                    cb, aw, ab, temporal_shapes, precision)
            else:
                h1, c1 = dsa_lstm_step_table_core(
                    value_k, vw, pos, hvec, z0, h[0], c[0], ctx_w3_k, w_hh_k,
                    cb, aw, ab, temporal_shapes, precision)
            return h1[None], c1[None]
        if vw is None:
            ctx = dsa_sample_attend_core(value_k, pos, hvec, cw, cb, aw, ab,
                                         temporal_shapes, precision)
        else:
            ctx = dsa_sample_attend_table_core(value_k, vw, pos, hvec, cb, aw,
                                               ab, temporal_shapes, precision)
        ctx = torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3)
        return lstm_step_pre(self.core.rnn.layers(), z0 + ctx, h, c)

    def _stepper(self, hoisted, temporal_shapes):
        """The word step of the stepwise path as ``step(z0, state)``, with
        what its kernels read built once per forward pass: the table VW and,
        under bf16 ``precision`` on the card, the kernels' operands value_t,
        ctx_w3 and w_hh rounded to bf16 (:class:`~dvc_tpu_torch.ops.
        dsa_bf16.RoundBf16`, the gradient passed through); ctx_w3 and w_hh
        only where K9 multiplies them (``lstm_fuse``), since the unfused
        step's ``ctx . ctx_w`` and LSTM layers are f32 products outside the
        kernel.  On the CPU in bf16 no table and no rounding here: the plain
        steps take Wc (the TPU kernels' product form) and round their
        operands themselves."""
        value_t, _, _, _, _, (*_, ctx_w3, w_hh), geom = hoisted
        kernel_ops = None
        if geom is None:
            vw = None
            if self.cfg.precision == 'float32' or value_t.is_cuda:
                if self.cfg.precision == 'bfloat16':
                    value_t = RoundBf16.apply(value_t)
                    if self.cfg.lstm_fuse and self.fusable:
                        ctx_w3, w_hh = (RoundBf16.apply(ctx_w3),
                                        RoundBf16.apply(w_hh))
                vw = self._value_table((value_t,) + hoisted[1:])
            kernel_ops = (value_t, vw, ctx_w3, w_hh)
        return lambda z0, state: self._step(hoisted, kernel_ops, z0, state,
                                            temporal_shapes)

    def forward(self, query, ref_center, offset_scale, memory,
                temporal_shapes, pad_mask, sample_max=True, temperature=1.0,
                gen=None):
        """Caption decode of every query.  Arguments as :meth:`_hoist`.
        Greedy by default: the fused kernel (``greedy_fuse``, one-layer
        core with attention) or the stepwise word steps.
        ``sample_max=False`` (``--caption_sample_max 0``) samples each
        token from exp(logprobs / ``temperature``) on the stepwise word
        steps, never the fused greedy kernel (the JAX head's routing),
        drawing from ``gen`` (a ``torch.Generator`` on the device; without
        one a fixed seed, so the decode repeats).  Returns (seq, logprobs),
        each (B*Pq, max_caption_len): the tokens, zero after the first
        EOS, and the log-probability of each chosen token."""
        B, Pq, _ = query.shape
        K = self.cfg.max_caption_len
        temporal_shapes = tuple(temporal_shapes)
        hoisted = self._hoist(query, ref_center, offset_scale, memory,
                              temporal_shapes, pad_mask)
        value_t, base_pos, scale_t, const_z, token_w, (
            off_w_h, h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh), _ = \
            hoisted
        if sample_max and self.cfg.greedy_fuse and self.fusable:
            tok, lp = dsa_greedy_scan(
                value_t, base_pos, scale_t, const_z, self.embed.weight,
                token_w, self.logit.weight.T, self.logit.bias, off_w_h,
                h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh,
                temporal_shapes, K,
                precision=self.cfg.precision)                 # (B, K, Pq)
        else:
            tok, lp = self._decode_steps(
                self._stepper(hoisted, temporal_shapes), token_w, const_z,
                self._picker(sample_max, temperature, gen, value_t.device))
        seq, lps = greedy_mask_outputs(tok, lp)
        return (seq.permute(0, 2, 1).reshape(B * Pq, K),
                lps.permute(0, 2, 1).reshape(B * Pq, K))

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
        from ``noise = (u, gumbel)``.  The fused scan runs where scheduled
        sampling is off, ``scan_fuse`` on and the core fusable.  Returns
        log-probabilities (B*Pq, Lc - 1, V+1)."""
        cfg = self.cfg
        B, Pq, _ = query.shape
        n, K, R = B * Pq, seq.shape[-1] - 1, cfg.rnn_size
        temporal_shapes = tuple(temporal_shapes)
        hoisted = self._hoist(query, ref_center, offset_scale, memory,
                              temporal_shapes, pad_mask)
        value_t, base_pos, scale_t, const_z, token_w, step_args, _ = hoisted
        if cfg.scan_fuse and ss_prob == 0 and self.fusable:
            # z_all directly in the scan's (B, K, Pq, 4R) order
            tokens = seq[:, :-1].reshape(B, Pq, K).transpose(1, 2)
            z_all = self.embed(tokens.long()) @ token_w + const_z[:, None]
            hs = dsa_teacher_scan(value_t, base_pos, scale_t, z_all,
                                  *step_args, temporal_shapes,
                                  precision=cfg.precision)    # (B, K, Pq, R)
            hs = hs.transpose(1, 2).reshape(n, K, R)
            hs = dropout(hs, cfg.drop_prob, gen)
            return torch.log_softmax(self.logit(hs), dim=-1)
        return self._teacher_steps(self._stepper(hoisted, temporal_shapes),
                                   token_w, const_z, seq, gen, ss_prob,
                                   noise)


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
