"""PDVC serving, eval and train forwards (port of
``dvc_tpu/models/pdvc.py``).

A conv pyramid feeds the deformable encoder; Nq learned event queries
(``transformer_input_type`` 'queries' or 'learnt_proposals', which JAX runs
alike) are decoded with iterative box refinement, or, two-stage
('gt_proposals'), G queries built from the gt boxes with no refinement;
each query gets class logits, a (center, length) box and a share of the
event-count logits.  Serving
(:meth:`PDVC.forward`) captions the last decoder layer's queries, greedily
or (``--caption_sample_max 0``) by temperature sampling;
eval (:meth:`PDVC.forward_eval`, the JAX ``__call__(eval_mode=True)``) also
matches every layer's predictions to the gt events and runs the criterion;
train (:meth:`PDVC.forward_train`) matches, runs the criterion, and
teacher-forces the captions of the matched queries of every layer.

The caption head is the LSTM-DSA one ('standard'), the light LSTM
('light') or none ('none': localisation only, no caption loss and no
``seq``).  Requests carry no ground truth, so the serving forward runs
neither matcher nor criterion; the served outputs do not depend on them
(a two-stage model needs the gt boxes, so it is not served).

Batch (dict of tensors), as in the JAX package:
  video_tensor (B, T, C) f32, video_mask (B, T) bool (True = valid frame),
  video_length (B, 3) f32 [feature length, duration (s), gt count];
  for training also gt_boxes (B, G, 2) (center, length), gt_boxes_mask
  (B, G) bool, gt_labels (B, G) int, cap_tensor (B, G, Lc) int (BOS/EOS =
  0), cap_mask (B, G, Lc) bool.

``--tpu_compute_dtype bfloat16`` (``PDVCConfig.compute_dtype``) runs the
trunk's linears, the decoder's self-attention and the residual adds in
bf16 on f32 weights, as the flax layers' ``dtype`` does (see
:mod:`.deformable_transformer`); the encoder hands f32 memory on and each
decoder layer's output is cast to f32, so the heads compute in f32; and the
caption kernels take bf16 operands on every route (K4-bf16, K5-bf16,
K6-bf16 fused, K7-bf16 to K10-bf16 and the table's bf16 mode stepwise; the
trunk MSDA kernels K1-K3 stay f32, as in JAX).  :func:`check_dtypes`
refuses any other dtype.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from ..utils.box_ops import inverse_sigmoid
from .base_encoder import BaseEncoder
from .caption_heads import (CaptionHeadConfig, DSACaptionHead,
                            LightCaptionHead, caption_nll, truncate_levels)
from .criterion import CriterionConfig, criterion_forward, match_layers
from .matcher import matched_mask
from .deformable_transformer import (DecoderLayer, EncoderLayer,
                                     LN_EPS, MSDeformAttn,
                                     MultiheadAttention,
                                     encoder_reference_points,
                                     msda_offset_bias)

# the two-stage query embedding: 256 sine frequencies per box coordinate
# (reference deformable_transformer.py get_proposal_pos_embed)
POS_FEATS = 256


@dataclasses.dataclass(frozen=True)
class PDVCConfig:
    num_classes: int = 1
    num_queries: int = 100
    num_feature_levels: int = 4
    hidden_dim: int = 512
    nheads: int = 8
    enc_layers: int = 2
    dec_layers: int = 2
    transformer_ff_dim: int = 2048
    transformer_dropout_prob: float = 0.1
    enc_n_points: int = 4
    dec_n_points: int = 4
    with_box_refine: bool = True
    aux_loss: bool = True
    share_caption_head: bool = True
    caption_decoder_type: str = 'standard'
    max_eseq_length: int = 10
    feature_dim: int = 512
    transformer_input_type: str = 'queries'
    caption: CaptionHeadConfig = None
    criterion: CriterionConfig = None
    # --caption_sample_max 0 samples each token from
    # exp(logprobs / caption_sample_temperature) in place of the greedy
    # decode
    sample_max: bool = True
    sample_temperature: float = 1.0
    # --tpu_compute_dtype: 'float32' or 'bfloat16'
    compute_dtype: str = 'float32'

    @property
    def dtype(self):
        return DTYPES[self.compute_dtype]

    @classmethod
    def from_opt(cls, opt):
        check_dtypes(opt)
        cap = CaptionHeadConfig(
            vocab_size=opt.vocab_size,
            input_encoding_size=opt.input_encoding_size,
            rnn_size=opt.rnn_size, num_layers=opt.num_layers,
            max_caption_len=opt.max_caption_len, hidden_dim=opt.hidden_dim,
            drop_prob=opt.drop_prob, att_hid_size=opt.att_hid_size, cap_nheads=opt.cap_nheads,
            cap_dec_n_points=opt.cap_dec_n_points,
            cap_num_feature_levels=min(opt.cap_num_feature_levels,
                                       opt.num_feature_levels),
            scan_fuse=bool(opt.dsa_scan_fuse),
            greedy_fuse=bool(opt.dsa_greedy_fuse),
            lstm_fuse=bool(opt.dsa_lstm_fuse),
            precision=opt.tpu_compute_dtype)
        return cls(
            num_classes=opt.num_classes, num_queries=opt.num_queries,
            num_feature_levels=opt.num_feature_levels,
            hidden_dim=opt.hidden_dim, nheads=opt.nheads,
            enc_layers=opt.enc_layers, dec_layers=opt.dec_layers,
            transformer_ff_dim=opt.transformer_ff_dim,
            transformer_dropout_prob=opt.transformer_dropout_prob,
            enc_n_points=opt.enc_n_points, dec_n_points=opt.dec_n_points,
            with_box_refine=bool(opt.with_box_refine),
            aux_loss=bool(opt.aux_loss),
            share_caption_head=bool(opt.share_caption_head),
            caption_decoder_type=opt.caption_decoder_type,
            max_eseq_length=opt.max_eseq_length,
            feature_dim=opt.feature_dim,
            transformer_input_type=opt.transformer_input_type,
            caption=cap, criterion=CriterionConfig.from_opt(opt),
            sample_max=bool(opt.caption_sample_max),
            sample_temperature=float(opt.caption_sample_temperature),
            compute_dtype=opt.tpu_compute_dtype)


DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def check_dtypes(opt):
    """Checks ``--tpu_compute_dtype`` and ``--fusion_dtype``: each is
    float32 or bfloat16 (a ``ValueError`` otherwise)."""
    for flag in ('tpu_compute_dtype', 'fusion_dtype'):
        value = getattr(opt, flag, 'float32')
        if value not in DTYPES:
            raise ValueError(f'--{flag} {value!r}: one of {tuple(DTYPES)}')


class BBoxHead(nn.Module):
    """3-layer MLP -> (center delta, length logit)."""

    def __init__(self, d):
        super().__init__()
        self.layers = nn.ModuleList(
            [nn.Linear(d, d), nn.Linear(d, d), nn.Linear(d, 2)])

    def forward(self, x):
        x = torch.relu(self.layers[0](x))
        x = torch.relu(self.layers[1](x))
        return self.layers[2](x)


class _Layers(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class DeformableTransformer(nn.Module):
    def __init__(self, c: PDVCConfig):
        super().__init__()
        d, L = c.hidden_dim, c.num_feature_levels
        self.level_embed = nn.Parameter(torch.empty(L, d))
        # only the branch of the input type exists, as in the flax tree
        if c.transformer_input_type == 'gt_proposals':
            self.pos_trans = nn.Linear(2 * POS_FEATS, 2 * d)
            self.pos_trans_norm = nn.LayerNorm(2 * d, eps=LN_EPS)
        else:
            self.reference_points = nn.Linear(d, 1)
        p, dt = c.transformer_dropout_prob, c.dtype
        self.encoder = _Layers(
            EncoderLayer(d, c.transformer_ff_dim, L, c.nheads, c.enc_n_points,
                         p, dt) for _ in range(c.enc_layers))
        self.decoder = _Layers(
            DecoderLayer(d, c.transformer_ff_dim, L, c.nheads, c.dec_n_points,
                         p, dt) for _ in range(c.dec_layers))


INPUT_TYPES = ('queries', 'learnt_proposals', 'gt_proposals')
CAPTION_HEADS = {'standard': DSACaptionHead, 'light': LightCaptionHead,
                 'none': None}


class PDVC(nn.Module):
    def __init__(self, cfg: PDVCConfig):
        super().__init__()
        if cfg.transformer_input_type not in INPUT_TYPES:
            raise NotImplementedError(
                f'transformer_input_type {cfg.transformer_input_type!r}: the '
                f'port takes {INPUT_TYPES}')
        if cfg.caption_decoder_type not in CAPTION_HEADS:
            raise NotImplementedError(
                f'caption_decoder_type {cfg.caption_decoder_type!r}: the '
                f'port takes {tuple(CAPTION_HEADS)}')
        self.cfg = cfg
        self.two_stage = cfg.transformer_input_type == 'gt_proposals'
        d, D = cfg.hidden_dim, cfg.dec_layers
        self.base_encoder = BaseEncoder(cfg.num_feature_levels,
                                        cfg.feature_dim, d)
        self.transformer = DeformableTransformer(cfg)
        self.query_embed = nn.Embedding(cfg.num_queries, 2 * d)

        def per_layer(make):
            # shared heads alias one module D times, which is how the
            # reference's ModuleList serializes them
            if cfg.with_box_refine:
                return nn.ModuleList(make() for _ in range(D))
            return nn.ModuleList([make()] * D)

        self.class_head = per_layer(lambda: nn.Linear(d, cfg.num_classes))
        self.count_head = per_layer(
            lambda: nn.Linear(d, cfg.max_eseq_length + 1))
        self.bbox_head = per_layer(lambda: BBoxHead(d))
        head = CAPTION_HEADS[cfg.caption_decoder_type]
        if head is None:
            self.caption_head = nn.ModuleList()
        elif cfg.share_caption_head:
            self.caption_head = nn.ModuleList([head(cfg.caption)] * D)
        else:
            self.caption_head = nn.ModuleList(head(cfg.caption)
                                              for _ in range(D))

    # ------------------------------------------------------------------
    def encode(self, batch, gen=None):
        srcs, masks, poses = self.base_encoder(
            batch['video_tensor'], ~batch['video_mask'],
            batch['video_length'][:, 1])
        shapes = tuple(s.shape[1] for s in srcs)
        level_embed = self.transformer.level_embed
        src_flat = torch.cat(srcs, dim=1)
        mask_flat = torch.cat(masks, dim=1)
        pos_flat = torch.cat([p + level_embed[l][None, None, :]
                              for l, p in enumerate(poses)], dim=1)
        valid_ratios = torch.stack(
            [(~m).float().sum(1) / m.shape[1] for m in masks], dim=1)
        memory = src_flat
        ref = encoder_reference_points(shapes, valid_ratios)
        for layer in self.transformer.encoder.layers:
            memory = layer(memory, pos_flat.to(memory.dtype), ref, shapes,
                           mask_flat, gen)
        return memory.float(), shapes, valid_ratios, mask_flat

    def decode(self, memory, shapes, valid_ratios, mask_flat, init_reference,
               tgt, query_pos, gen=None, query_mask=None):
        """Decoder stack with iterative box refinement (off two-stage).
        Returns per-layer lists (outputs, input references, bbox-head
        deltas); the refined reference fed to the next layer is detached,
        as in the reference.  query_mask (B, Nq) True = a query the
        self-attention attends to (two-stage: the real gt boxes)."""
        output, reference_points = tgt, init_reference
        hs, refs, deltas = [], [], []
        last = len(self.transformer.decoder.layers) - 1
        for lid, layer in enumerate(self.transformer.decoder.layers):
            if reference_points.shape[-1] == 2:
                ref_input = (reference_points[:, :, None]
                             * torch.stack([valid_ratios, valid_ratios],
                                           -1)[:, None])
            else:
                ref_input = (reference_points[:, :, None]
                             * valid_ratios[:, None, :, None])
            output = layer(output, query_pos, ref_input, memory, shapes,
                           mask_flat, query_mask, gen=gen).float()
            delta = self.bbox_head[lid](output)
            hs.append(output)
            refs.append(reference_points)
            deltas.append(delta)
            if self.cfg.with_box_refine and not self.two_stage \
                    and lid < last:
                if reference_points.shape[-1] == 2:
                    new_ref = torch.sigmoid(delta
                                            + inverse_sigmoid(reference_points))
                else:
                    new_ref = torch.sigmoid(torch.cat(
                        [delta[..., :1] + inverse_sigmoid(reference_points),
                         delta[..., 1:]], -1))
                reference_points = new_ref.detach()
        return hs, refs, deltas

    def prepare_decoder_queries(self, B):
        query_pos, tgt = self.query_embed.weight.chunk(2, dim=1)
        query_pos = query_pos[None].expand(B, -1, -1)
        tgt = tgt[None].expand(B, -1, -1)
        init_reference = torch.sigmoid(
            self.transformer.reference_points(query_pos))
        return init_reference, tgt, query_pos

    def prepare_decoder_proposals(self, gt_boxes):
        """Two-stage queries from the gt boxes (B, G, 2) (the JAX
        ``prepare_decoder_proposals``, reference pdvc.py:136-142): a sine
        embedding of sigmoid(inverse_sigmoid(box)) * 2 pi at POS_FEATS
        frequencies, ``pos_trans`` and ``pos_trans_norm``, split into
        (query_pos, tgt); the boxes themselves are the references.  The
        clamped ``inverse_sigmoid`` keeps padded zero boxes finite."""
        dim_t = torch.arange(POS_FEATS, dtype=torch.float32,
                             device=gt_boxes.device)
        dim_t = 10000 ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                          / POS_FEATS)
        proposals = torch.sigmoid(inverse_sigmoid(gt_boxes)) * (2 * math.pi)
        pos = proposals[:, :, :, None] / dim_t                # (B, G, 2, F)
        pos = torch.stack((torch.sin(pos[..., 0::2]),
                           torch.cos(pos[..., 1::2])), dim=4).reshape(
            pos.shape[0], pos.shape[1], -1)
        out = self.transformer.pos_trans_norm(self.transformer.pos_trans(pos))
        query_pos, tgt = out.chunk(2, dim=2)
        return gt_boxes, tgt, query_pos

    def head_outputs(self, l_id, hs, reference, delta, train_path=False):
        """Class/count/box predictions of decoder layer ``l_id``.  A 1-d
        reference is added to both box dims on the eval path and to the
        center only on the train path (the reference's two branches,
        ``pdvc.py:202-211`` and ``:257-266``, kept for parity).  Two-stage
        the box is the reference itself (refinement is off)."""
        if self.two_stage:
            return (self.class_head[l_id](hs),
                    self.count_head[l_id](hs.amax(dim=1)), reference)
        ref_inv = inverse_sigmoid(reference)
        if reference.shape[-1] == 1 and train_path:
            coord = torch.sigmoid(torch.cat([delta[..., :1] + ref_inv,
                                             delta[..., 1:]], -1))
        else:
            coord = torch.sigmoid(delta + ref_inv)
        return (self.class_head[l_id](hs),
                self.count_head[l_id](hs.amax(dim=1)), coord)

    def caption_reference(self, reference, valid_ratios, shapes):
        """Caption-head sampling geometry as (center, scale), each
        (B, Nq, L): 1-d references give scale 1/T_l, boxes give
        length * valid ratio * 0.5 / n_points."""
        center = reference[:, :, None, 0] * valid_ratios[:, None, :]
        if reference.shape[-1] == 2:
            scale = (reference[:, :, None, 1] * valid_ratios[:, None, :]
                     * 0.5 / self.cfg.caption.cap_dec_n_points)
        else:
            T = torch.tensor(shapes, dtype=torch.float32,
                             device=reference.device)
            scale = (1.0 / T)[None, None, :].expand_as(center)
        return center, scale

    def trunk(self, batch, gen=None):
        """Encoder and decoder stack: ((memory, shapes, valid_ratios,
        mask_flat), per-layer outputs, input references, bbox deltas).
        Two-stage the queries are the batch's gt boxes, masked by
        ``gt_boxes_mask``."""
        enc = self.encode(batch, gen)
        if self.two_stage:
            queries = self.prepare_decoder_proposals(batch['gt_boxes'])
            query_mask = batch['gt_boxes_mask']
        else:
            queries = self.prepare_decoder_queries(enc[0].shape[0])
            query_mask = None
        hs, refs, deltas = self.decode(*enc, *queries, gen, query_mask)
        return enc, hs, refs, deltas

    def layer_outputs(self, hs, refs, deltas, train_path):
        """Every decoder layer's class/count/box predictions, stacked
        (D, B, ...), as the criterion takes them."""
        heads = [self.head_outputs(l, hs[l], refs[l], deltas[l], train_path)
                 for l in range(self.cfg.dec_layers)]
        return {k: torch.stack([h[i] for h in heads]) for i, k in
                enumerate(('pred_logits', 'pred_count', 'pred_boxes'))}

    def caption_sample(self, hs, reference, memory, shapes, valid_ratios,
                       mask_flat, gen=None):
        """Captions of the last decoder layer's queries, greedy or (with
        ``sample_max`` off) sampled at ``sample_temperature`` from ``gen``:
        seq and cap_prob_eval (B, Nq, max_caption_len); nothing with the
        'none' head.  The light head reads the query features only."""
        c = self.cfg
        B, Nq, d = hs.shape
        if c.caption_decoder_type == 'none':
            return {}
        head = self.caption_head[c.dec_layers - 1]
        sample = dict(sample_max=c.sample_max,
                      temperature=c.sample_temperature, gen=gen)
        if c.caption_decoder_type == 'light':
            seq, lp = head(hs.reshape(B * Nq, d), **sample)
        else:
            center, scale = self.caption_reference(reference, valid_ratios,
                                                   shapes)
            shapes_t, mem_t, mask_t, center_t, scale_t = truncate_levels(
                c.caption, shapes, memory, mask_flat, center, scale)
            seq, lp = head(hs, center_t, scale_t, mem_t, shapes_t, mask_t,
                           **sample)
        return {'seq': seq.reshape(B, Nq, -1),
                'cap_prob_eval': lp.reshape(B, Nq, -1)}

    def forward(self, batch, gen=None):
        """Serving forward.  Returns the last decoder layer's pred_logits
        (B, Nq, C), pred_count (B, Ne+1), pred_boxes (B, Nq, 2), seq and
        cap_prob_eval (B, Nq, max_caption_len) (none of the two with the
        'none' head).  ``gen`` (a ``torch.Generator`` on the model's
        device) feeds a sampling decode's draws."""
        enc, hs, refs, deltas = self.trunk(batch)
        logits, count, boxes = self.head_outputs(self.cfg.dec_layers - 1,
                                                 hs[-1], refs[-1], deltas[-1])
        return {'pred_logits': logits, 'pred_count': count,
                'pred_boxes': boxes,
                **self.caption_sample(hs[-1], refs[-1], *enc, gen=gen)}

    def forward_eval(self, batch, gen=None):
        """Eval forward on a batch with gt events: (outputs, losses).
        outputs are :meth:`forward`'s plus matched_indices (B, G); losses
        the criterion's over every decoder layer (with ``aux_loss``), on
        the eval path's boxes (a 1-d reference added to both box dims);
        no caption losses.  ``gen`` as in :meth:`forward`."""
        c = self.cfg
        enc, hs, refs, deltas = self.trunk(batch)
        outputs = self.layer_outputs(hs, refs, deltas, train_path=False)
        losses, last_idx, _ = criterion_forward(
            c.criterion, outputs, batch['gt_labels'], batch['gt_boxes'],
            batch['gt_boxes_mask'], aux_loss=c.aux_loss)
        out = {k: v[-1] for k, v in outputs.items()}
        out['matched_indices'] = last_idx
        out.update(self.caption_sample(hs[-1], refs[-1], *enc, gen=gen))
        return out, losses

    def forward_train(self, batch, gen=None, ss_prob=0.0, global_sum=None):
        """Train forward: (outputs, losses).  With ``gen`` (a
        ``torch.Generator`` on the model's device) dropout is on and its
        masks come from it; without, the forward is deterministic.  outputs
        holds the last layer's pred_logits, pred_count, pred_boxes and
        matched_indices (B, G); losses every loss of the criterion and the
        caption losses, with the ``_{i}`` suffixes of the aux layers.
        ``ss_prob > 0`` turns scheduled sampling on in the caption head
        (its draws come from ``gen``).  ``global_sum`` (a data-parallel
        rank's ``parallel.global_sum``) sums the losses' counts over the
        ranks, so that the losses are the rank's shares of the global
        batch's (:func:`criterion.match_layers`)."""
        c = self.cfg
        enc, hs, refs, deltas = self.trunk(batch, gen)
        memory, shapes, valid_ratios, mask_flat = enc
        # the 'none' head takes the eval path's boxes, as in JAX
        # (train_path = not eval_mode and a caption head)
        captions = c.caption_decoder_type != 'none'
        outputs = self.layer_outputs(hs, refs, deltas, train_path=captions)
        gt = (batch['gt_labels'], batch['gt_boxes'], batch['gt_boxes_mask'])
        matching = match_layers(c.criterion, outputs, *gt,
                                aux_loss=c.aux_loss, global_sum=global_sum)
        losses, last_idx, aux_idx = criterion_forward(
            c.criterion, outputs, *gt, aux_loss=c.aux_loss, matching=matching)
        if captions:
            losses.update(self.caption_train_losses(
                hs, refs, memory, shapes, valid_ratios, mask_flat, batch,
                last_idx, aux_idx, matching.n_matched, gen, ss_prob))
        out = {k: v[-1] for k, v in outputs.items()}
        out['matched_indices'] = last_idx
        return out, losses

    def caption_train_losses(self, hs, refs, memory, shapes, valid_ratios,
                             mask_flat, batch, last_idx, aux_idx, n_matched,
                             gen, ss_prob=0.0):
        """Per-layer teacher-forced caption losses on the matched pairs
        (reference pdvc.py:294-304), each the sum over the layer's matched
        gt slots (:func:`matched_mask`) over their count ``n_matched``
        {layer: count} (:class:`criterion.Matching`).  A shared caption
        head runs the D layers' pairs as one scan over a (B, D*G) pair
        axis.  The light head reads the matched queries' features only."""
        c = self.cfg
        D = c.dec_layers
        gt_mask = batch['gt_boxes_mask']
        B, G = gt_mask.shape
        cap, cap_mask = batch['cap_tensor'], batch['cap_mask']
        layers = list(range(D)) if c.aux_loss else [D - 1]
        light = c.caption_decoder_type == 'light'

        def index(l_id):
            return last_idx if l_id == D - 1 else aux_idx[l_id]

        def mean(per_cap, l_id):
            m = matched_mask(index(l_id), gt_mask).float()
            return (per_cap * m).sum() / n_matched[l_id]

        def layer_inputs(l_id):
            idx = index(l_id).clamp(min=0)
            feats = torch.gather(hs[l_id], 1,
                                 idx[..., None].expand(-1, -1, hs[l_id].shape[2]))
            if light:
                return feats, None, None
            ref = torch.gather(refs[l_id], 1,
                               idx[..., None].expand(-1, -1, refs[l_id].shape[2]))
            center, scale = self.caption_reference(ref, valid_ratios, shapes)
            return feats, center, scale

        def run(head, feats, center, scale, caps):
            if light:
                return head.teacher_forcing(
                    feats.reshape(-1, feats.shape[-1]),
                    caps.reshape(-1, caps.shape[-1]), gen, ss_prob)
            shapes_t, mem_t, mask_t, center_t, scale_t = truncate_levels(
                c.caption, shapes, memory, mask_flat, center, scale)
            return head.teacher_forcing(feats, center_t, scale_t, mem_t,
                                        shapes_t, mask_t,
                                        caps.reshape(-1, caps.shape[-1]), gen,
                                        ss_prob)

        def loss_key(l_id):
            return 'loss_caption' if l_id == D - 1 else f'loss_caption_{l_id}'

        losses = {}
        if c.share_caption_head and len(layers) > 1:
            parts = [layer_inputs(l) for l in layers]
            nL = len(layers)
            caps_all = cap.repeat(1, nL, 1)
            lp = run(self.caption_head[0],
                     *(None if p0 is None else torch.cat([p[i] for p in parts],
                                                         1)
                       for i, p0 in enumerate(parts[0])), caps_all)
            per_cap = caption_nll(
                lp.reshape(B, nL * G, *lp.shape[1:]), caps_all[..., 1:],
                cap_mask.repeat(1, nL, 1)[..., 1:]).reshape(B, nL, G)
            for i, l_id in enumerate(layers):
                losses[loss_key(l_id)] = mean(per_cap[:, i], l_id)
            return losses
        for l_id in layers:
            lp = run(self.caption_head[l_id], *layer_inputs(l_id), cap)
            per_cap = caption_nll(lp.reshape(B, G, *lp.shape[1:]),
                                  cap[..., 1:], cap_mask[..., 1:])
            losses[loss_key(l_id)] = mean(per_cap, l_id)
        return losses

    # ------------------------------------------------------------------
    @torch.no_grad()
    def init_parameters_(self, gen: torch.Generator):
        """Seeded init with the distributions of the JAX package's flax
        initializers (random weights for smoke runs; served checkpoints
        overwrite them)."""
        c = self.cfg
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Conv1d):
                xavier_uniform_(m.weight, gen)
                nn.init.zeros_(m.bias)
            elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        # then the modules whose init differs from their Linears' default
        for m in self.modules():
            if isinstance(m, MultiheadAttention):
                init_mha_(m, gen)
            elif isinstance(m, MSDeformAttn):
                init_msda_(m, gen, center=False)
        tr = self.transformer
        tr.level_embed.normal_(0.0, 1.0, generator=gen)
        self.query_embed.weight.normal_(0.0, 1.0, generator=gen)
        if not self.two_stage:
            xavier_uniform_(tr.reference_points.weight, gen)
        prior = 0.01
        for i in range(c.dec_layers):
            self.class_head[i].bias.fill_(-math.log((1 - prior) / prior))
            last = self.bbox_head[i].layers[2]
            nn.init.zeros_(last.weight)
            last.bias.copy_(torch.tensor(
                [0.0, -2.0 if i == 0 or not c.with_box_refine else 0.0]))
        for head in dict.fromkeys(self.caption_head):   # shared: once
            init_caption_head_(head, gen)


def make_pdvc_model(opt, device='cuda', seed: int = 0) -> PDVC:
    """The plain PDVC of ``opt`` on ``device`` (the card unless the caller
    asks for the CPU) in eval mode, with seeded random weights drawn on the
    CPU from a ``torch.Generator``, as :func:`make_fusion_model` builds
    FusionPDVC; load a checkpoint over them with
    ``load_state_dict(strict=True)``.  The weights are f32 under either
    ``--tpu_compute_dtype``."""
    with torch.device('meta'):
        model = PDVC(PDVCConfig.from_opt(opt))
    model.to_empty(device='cpu')
    model.init_parameters_(torch.Generator().manual_seed(seed))
    return model.to(device).eval()


# ----------------------------------------------------------------------
# flax initializers with an explicit generator
# ----------------------------------------------------------------------

def lecun_normal_(w, gen, fan_in=None):
    """flax lecun_normal: truncated normal (2 std), variance 1/fan_in."""
    fan_in = fan_in or w.shape[1]
    std = math.sqrt(1.0 / fan_in) / .87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)


def xavier_uniform_(w, gen):
    nn.init.xavier_uniform_(w, generator=gen)


def init_mha_(m: MultiheadAttention, gen):
    for w in m.in_proj_weight.chunk(3):
        lecun_normal_(w, gen)
    nn.init.zeros_(m.in_proj_bias)
    lecun_normal_(m.out_proj.weight, gen)
    nn.init.zeros_(m.out_proj.bias)


def init_msda_(m: MSDeformAttn, gen, center=False):
    """Zero offset/attention kernels, directional offset bias, xavier
    value/output projections."""
    nn.init.zeros_(m.sampling_offsets.weight)
    m.sampling_offsets.bias.copy_(torch.from_numpy(msda_offset_bias(
        m.n_heads, m.n_levels, m.n_points, center)))
    nn.init.zeros_(m.attention_weights.weight)
    nn.init.zeros_(m.attention_weights.bias)
    for lin in (m.value_proj, m.output_proj):
        xavier_uniform_(lin.weight, gen)
        nn.init.zeros_(lin.bias)


def init_caption_head_(head, gen):
    """The JAX heads' distributions: embed and logit U(-0.1, 0.1), logit
    bias 0, every LSTM weight U(-1/sqrt(R), 1/sqrt(R)); the DSA head's
    sampler and attention as ``_dsa_params``."""
    cfg = head.cfg
    core = head.core
    head.embed.weight.uniform_(-0.1, 0.1, generator=gen)
    head.logit.weight.uniform_(-0.1, 0.1, generator=gen)
    nn.init.zeros_(head.logit.bias)
    bound = 1.0 / math.sqrt(cfg.rnn_size)
    for w in core.rnn.parameters():
        w.uniform_(-bound, bound, generator=gen)
    if isinstance(head, LightCaptionHead):
        return
    att = core.deformable_att
    nn.init.zeros_(att.sampling_offsets.weight)
    att.sampling_offsets.bias.copy_(torch.from_numpy(msda_offset_bias(
        cfg.cap_nheads, cfg.cap_num_feature_levels, cfg.cap_dec_n_points,
        center=True)))
    xavier_uniform_(att.value_proj.weight, gen)
    nn.init.zeros_(att.value_proj.bias)
    if cfg.att_hid_size > 0:
        for lin in (core.ctx2att, core.h2att, core.alpha_net):
            lecun_normal_(lin.weight, gen)
            nn.init.zeros_(lin.bias)
