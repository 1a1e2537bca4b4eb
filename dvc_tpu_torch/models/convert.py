"""Weights carried across: flax PDVC and FusionPDVC params -> this
package's ``state_dict``.

Pure numpy (no JAX needed to read a checkpoint's params tree).  The result
has the reference torch layout that ``dvc_tpu/models/pdvc_converter.py``
``export_pdvc`` / ``export_fusion`` emit, which is also this package's
module layout, so ``model.load_state_dict(pdvc_from_jax_params(params),
strict=True)`` (plain PDVC) or ``from_jax_params`` (FusionPDVC) is the
bridge.  Every variant the port builds converts: the light, LSTM-DSA and
no caption head, multi-layer LSTMs, the attention-free DSA core, and the
two-stage ``pos_trans`` in place of ``reference_points``.  Flax ``Dense`` kernels are (in, out) and torch ``Linear`` weights
(out, in); flax ``Conv`` kernels are (k, in, out) and torch ``Conv1d``
weights (out, in, k).  Shared heads are written once per decoder layer, as
the reference's aliased ``ModuleList`` serializes them.
"""

from __future__ import annotations

import numpy as np


def _unwrap(tree, marker):
    if 'params' in tree and marker not in tree:
        return tree['params']
    return tree


def _t(w):
    return np.asarray(w).T


def _mha(mha, dst):
    """Flax MultiHeadDotProductAttention -> packed ``in_proj_weight``."""
    E = np.asarray(mha['query']['kernel']).shape[0]
    names = ('query', 'key', 'value')
    out_k = np.asarray(mha['out']['kernel'])
    return {
        f'{dst}.in_proj_weight': np.concatenate(
            [_t(np.asarray(mha[n]['kernel']).reshape(E, -1)) for n in names]),
        f'{dst}.in_proj_bias': np.concatenate(
            [np.asarray(mha[n]['bias']).reshape(-1) for n in names]),
        f'{dst}.out_proj.weight': _t(out_k.reshape(-1, out_k.shape[-1])),
        f'{dst}.out_proj.bias': np.asarray(mha['out']['bias']),
    }


def pdvc_from_jax_params(flax_params):
    """Flax ``PDVC`` params (numpy leaves, with or without the 'params'
    level) -> state_dict of :class:`dvc_tpu_torch.models.pdvc.PDVC` in the
    reference layout (numpy arrays), for any input type and caption head.
    The flax tree holds only the branches its model runs:
    ``reference_points`` for queries, ``pos_trans(_norm)`` two-stage; the
    DSA head's attention only where att_hid_size > 0; no caption head for
    'none'."""
    p = _unwrap(flax_params, 'decoder_layer_0')
    dec_layers = 0
    while f'decoder_layer_{dec_layers}' in p:
        dec_layers += 1
    sd = {}

    def lin(node, dst):
        sd[f'{dst}.weight'] = _t(node['kernel'])
        sd[f'{dst}.bias'] = np.asarray(node['bias'])

    def norm(node, dst):
        sd[f'{dst}.weight'] = np.asarray(node['scale'])
        sd[f'{dst}.bias'] = np.asarray(node['bias'])

    be = p['base_encoder']
    lin(be['pos_embed']['duration_embed_layer'],
        'base_encoder.pos_embed.duration_embed_layer')
    i = 0
    while f'input_proj_{i}' in be:
        conv = be[f'input_proj_{i}']
        sd[f'base_encoder.input_proj.{i}.0.weight'] = np.transpose(
            np.asarray(conv['kernel']), (2, 1, 0))
        sd[f'base_encoder.input_proj.{i}.0.bias'] = np.asarray(conv['bias'])
        norm(be[f'input_proj_{i}_norm'], f'base_encoder.input_proj.{i}.1')
        i += 1

    sd['transformer.level_embed'] = np.asarray(p['level_embed'])
    if 'reference_points' in p:
        lin(p['reference_points'], 'transformer.reference_points')
    if 'pos_trans' in p:
        lin(p['pos_trans'], 'transformer.pos_trans')
        norm(p['pos_trans_norm'], 'transformer.pos_trans_norm')

    def msda(node, dst):
        for m in ('sampling_offsets', 'attention_weights', 'value_proj',
                  'output_proj'):
            lin(node[m], f'{dst}.{m}')

    def ffn(node, dst, norm_name):
        lin(node['linear1'], f'{dst}.linear1')
        lin(node['linear2'], f'{dst}.linear2')
        norm(node['norm'], f'{dst}.{norm_name}')

    i = 0
    while f'encoder_layer_{i}' in p:
        src, dst = p[f'encoder_layer_{i}'], f'transformer.encoder.layers.{i}'
        msda(src['self_attn'], f'{dst}.self_attn')
        norm(src['norm1'], f'{dst}.norm1')
        ffn(src['ffn'], dst, 'norm2')
        i += 1
    i = 0
    while f'decoder_layer_{i}' in p:
        src, dst = p[f'decoder_layer_{i}'], f'transformer.decoder.layers.{i}'
        msda(src['cross_attn'], f'{dst}.cross_attn')
        norm(src['norm1'], f'{dst}.norm1')
        norm(src['norm2'], f'{dst}.norm2')
        ffn(src['ffn'], dst, 'norm3')
        sd.update(_mha(src['self_attn'], f'{dst}.self_attn'))
        i += 1

    sd['query_embed.weight'] = np.asarray(p['query_embed'])
    shared = 'class_head' in p
    for li in range(dec_layers):
        sfx = '' if shared else f'_{li}'
        lin(p[f'class_head{sfx}'], f'class_head.{li}')
        lin(p[f'count_head{sfx}'], f'count_head.{li}')
        for j in range(3):
            lin(p[f'bbox_head{sfx}'][f'layer{j}'], f'bbox_head.{li}.layers.{j}')

    def caption_head(head, base):
        sd[f'{base}.embed.weight'] = np.asarray(head['embed'])
        sd[f'{base}.logit.weight'] = _t(head['logit_w'])
        sd[f'{base}.logit.bias'] = np.asarray(head['logit_b'])
        for k, v in head.items():
            if k.startswith('rnn_w_'):          # rnn_w_ih_l0 -> weight_ih_l0
                sd[f'{base}.core.rnn.weight_{k[len("rnn_w_"):]}'] = _t(v)
        if 'dsa_sampling_offsets_w' not in head:   # the light head
            return
        dsa = f'{base}.core.deformable_att'
        sd[f'{dsa}.sampling_offsets.weight'] = _t(
            head['dsa_sampling_offsets_w'])
        sd[f'{dsa}.sampling_offsets.bias'] = np.asarray(
            head['dsa_sampling_offsets_b'])
        sd[f'{dsa}.value_proj.weight'] = _t(head['dsa_value_w'])
        sd[f'{dsa}.value_proj.bias'] = np.asarray(head['dsa_value_b'])
        for name in ('ctx2att', 'h2att', 'alpha_net'):
            if f'{name}_w' in head:             # absent at att_hid_size 0
                sd[f'{base}.core.{name}.weight'] = _t(head[f'{name}_w'])
                sd[f'{base}.core.{name}.bias'] = np.asarray(head[f'{name}_b'])

    if 'caption_head' in p:                     # shared: once per layer
        for li in range(dec_layers):
            caption_head(p['caption_head'], f'caption_head.{li}')
    else:
        i = 0
        while f'caption_head_{i}' in p:
            caption_head(p[f'caption_head_{i}'], f'caption_head.{i}')
            i += 1
    return sd


def from_jax_params(flax_params):
    """Flax ``FusionPDVC`` params (numpy leaves) -> state_dict of
    :class:`dvc_tpu_torch.models.fusion.FusionPDVC` (numpy arrays)."""
    p = _unwrap(flax_params, 'visual_sa')
    sd = {f'pdvcModel.{k}': v
          for k, v in pdvc_from_jax_params(p['pdvc']).items()}
    for src, ln, mha, mlp in (('visual_sa', 'ln1', 'mha1', 'mlp_seq1'),
                              ('sound_ca', 'ln2', 'mha2', 'mlp_seq2')):
        blk = p[src]
        sd.update(_mha(blk['mha'], mha))
        sd[f'{ln}.weight'] = np.asarray(blk['ln']['scale'])
        sd[f'{ln}.bias'] = np.asarray(blk['ln']['bias'])
        sd[f'{mlp}.0.weight'] = _t(blk['mlp_fc']['kernel'])
        sd[f'{mlp}.0.bias'] = np.asarray(blk['mlp_fc']['bias'])
        sd[f'{mlp}.1.weight'] = np.asarray(blk['mlp_ln']['scale'])
        sd[f'{mlp}.1.bias'] = np.asarray(blk['mlp_ln']['bias'])
    return sd
