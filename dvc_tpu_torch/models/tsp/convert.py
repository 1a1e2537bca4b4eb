"""TSP backbone weights for the port: the JAX package's flax trees and
torch ``.pth`` checkpoints (counterpart of
``dvc_tpu/models/tsp/converter.py`` and ``extractor.py::_load_checkpoint``).

* :func:`tsp_from_jax_params`: a flax ``{'params', 'batch_stats'}`` tree
  of ``dvc_tpu.models.tsp`` (a ``TSPModel`` or a bare backbone) -> the
  port's ``state_dict``: conv kernels (kt, kh, kw, in, out) -> (out, in,
  kt, kh, kw), Dense (in, out) -> (out, in), the MViT pool kernels (3, 3,
  3, D) -> (D, 1, 3, 3, 3), LayerNorm and BatchNorm scale -> weight and
  the BatchNorm statistics -> running_mean / running_var.
* :func:`tsp_momentum_from_jax`: the SGD momentum of a JAX TSP training
  checkpoint's ``opt_state`` -> ``momentum_buffer``s keyed like the
  port's parameters, through the same names.
* :func:`load_tsp_weights`: a TSP or torchvision ``.pth`` (its backbone
  under ``module.``, ``features.`` or ``backbone.``, the TSP heads ``fc``,
  ``fc1``, ``fc2`` beside it) or a JAX ``.ckpt`` (``pickle
  {'variables': ...}``, read without JAX).  A tensor left over, missing or
  of another shape than the backbone's raises ``ValueError`` naming it;
  a full-size MViTv2-S checkpoint must also match torchvision's layout
  (:mod:`.mvit_manifest`).

The port's module names are torchvision's, so a ``.pth`` needs no
renaming: only the prefix is stripped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .backbones import MViTConfig, midplanes
from .model import make_backbone

HEADS = ('fc', 'fc1', 'fc2')
# checkpoint keys that no backbone reads (torchvision's classifier)
_IGNORABLE = ('head.',)


def _conv(w):
    return np.transpose(np.asarray(w), (4, 3, 0, 1, 2))


def _lin(w):
    return np.asarray(w).T


def _pool(w):
    # depthwise kernel (3, 3, 3, D) -> (D, 1, 3, 3, 3)
    return np.transpose(np.asarray(w), (3, 0, 1, 2))[:, None]


def _mvit_from_jax(P, put):
    def lin(dst, src):
        put(dst + '.weight', _lin(src['kernel']))
        put(dst + '.bias', src['bias'])

    def ln(dst, src):
        put(dst + '.weight', src['scale'])
        put(dst + '.bias', src['bias'])

    put('conv_proj.weight', _conv(P['patch_embed']['kernel']))
    put('conv_proj.bias', P['patch_embed']['bias'])
    put('pos_encoding.class_token', P['cls_token'])
    i = 0
    while f'block_{i}' in P:
        b, dst = P[f'block_{i}'], f'blocks.{i}'
        ln(f'{dst}.norm1', b['norm1'])
        ln(f'{dst}.norm2', b['norm2'])
        a = b['attn']
        lin(f'{dst}.attn.qkv', a['qkv'])
        lin(f'{dst}.attn.project.0', a['proj'])
        for p in ('pool_q', 'pool_k', 'pool_v'):
            put(f'{dst}.attn.{p}.pool.weight', _pool(a[p]['kernel']))
            ln(f'{dst}.attn.{p}.norm_act.0', a[p]['norm'])
        for r in ('rel_pos_h', 'rel_pos_w', 'rel_pos_t'):
            put(f'{dst}.attn.{r}', a[r])
        if 'shortcut_proj' in b:
            lin(f'{dst}.project', b['shortcut_proj'])
        lin(f'{dst}.mlp.0', b['mlp_fc1'])
        lin(f'{dst}.mlp.3', b['mlp_fc2'])
        i += 1
    ln('norm', P['norm'])


def _resnet_from_jax(P, S, put):
    def conv(dst, src):
        put(dst + '.weight', _conv(src['kernel']))

    def bn(dst, p, s):
        put(dst + '.weight', p['scale'])
        put(dst + '.bias', p['bias'])
        if s is not None:
            put(dst + '.running_mean', s['mean'])
            put(dst + '.running_var', s['var'])
            put(dst + '.num_batches_tracked', np.zeros((), np.int64))

    if 'stem_conv_s' in P:                       # R(2+1)D
        conv('stem.0', P['stem_conv_s'])
        bn('stem.1', P['stem_bn_s'], _sub(S, 'stem_bn_s'))
        conv('stem.3', P['stem_conv_t'])
        bn('stem.4', P['stem_bn'], _sub(S, 'stem_bn'))
    else:
        conv('stem.0', P['stem_conv'])
        bn('stem.1', P['stem_bn'], _sub(S, 'stem_bn'))
    for name in sorted(k for k in P if k.startswith('layer')):
        stage, b = name[len('layer'):].split('_')
        dst, p, s = f'layer{stage}.{b}', P[name], _sub(S, name)
        for ci in (1, 2):
            c, cs = p[f'conv{ci}'], _sub(s, f'conv{ci}')
            if 'conv_s' in c:
                conv(f'{dst}.conv{ci}.0.0', c['conv_s'])
                bn(f'{dst}.conv{ci}.0.1', c['bn_mid'], _sub(cs, 'bn_mid'))
                conv(f'{dst}.conv{ci}.0.3', c['conv_t'])
            else:
                conv(f'{dst}.conv{ci}.0', c['conv'])
            bn(f'{dst}.conv{ci}.1', p[f'bn{ci}'], _sub(s, f'bn{ci}'))
        if 'downsample_conv' in p:
            conv(f'{dst}.downsample.0', p['downsample_conv'])
            bn(f'{dst}.downsample.1', p['downsample_bn'],
               _sub(s, 'downsample_bn'))


def _sub(tree, key):
    """``tree[key]``, or None for a missing statistics tree."""
    return None if tree is None else tree.get(key)


def tsp_from_jax_params(variables) -> dict:
    """A flax TSP tree (``{'params': ..., 'batch_stats': ...}`` of a
    ``TSPModel``, whose backbone is under ``features``, or of a bare
    backbone) -> a ``state_dict`` of CPU tensors keyed like the port's
    ``TSPModel`` (``features.`` + the backbone, and the heads) or
    backbone.  The VideoResNets' (2+1)-D middle widths are the JAX
    package's ('conv' layout, :class:`~.backbones.BasicBlock`).  A tree
    without ``batch_stats`` gives the parameters alone."""
    P = variables['params']
    S = variables.get('batch_stats')
    out = {}
    prefix = ''
    if 'features' in P:
        prefix = 'features.'
        for fc in HEADS:
            if fc in P:
                out[f'{fc}.weight'] = _lin(P[fc]['kernel'])
                out[f'{fc}.bias'] = P[fc]['bias']
        P, S = P['features'], _sub(S, 'features')

    def put(key, value):
        out[prefix + key] = value

    if 'patch_embed' in P:
        _mvit_from_jax(P, put)
    else:
        _resnet_from_jax(P, S, put)
    return {k: torch.from_numpy(np.array(v)) for k, v in out.items()}


def tsp_momentum_from_jax(opt_state) -> dict:
    """The SGD momentum of a JAX TSP ``opt_state`` as ``momentum_buffer``
    tensors keyed like the port's parameters.  The state is optax's chain
    of ``add_decayed_weights`` (or ``identity``), ``trace`` and ``scale``;
    its ``TraceState`` carries the momentum as a tree shaped like the
    parameters (``serve.load_checkpoint`` reads it as that tree), which
    goes through :func:`tsp_from_jax_params`'s names and layouts."""
    for s in opt_state:
        tree = getattr(s, 'trace', s)
        if isinstance(tree, dict):
            return tsp_from_jax_params({'params': tree})
    raise ValueError('tsp_momentum_from_jax: no momentum trace in the '
                     f'optimizer state {type(opt_state).__name__}')


class TSPWeights(NamedTuple):
    """A backbone's ``state_dict`` (``features``), the TSP heads found
    beside it ({'fc1': {'weight', 'bias'}, ...}) and the (2+1)-D middle
    widths' layout it was saved in (``mid_layout``)."""
    features: dict
    heads: dict
    mid_layout: str


_ANCHOR = {'mvit_v2_s': ('conv_proj.weight', 'MViT patch-embed (conv_proj.*)')}
_RESNET_ANCHOR = ('stem.0.weight', 'VideoResNet stem (stem.0.*)')


def tsp_weights(state_dict, backbone: str, config: MViTConfig | None = None
                ) -> TSPWeights:
    """Split and check a TSP ``state_dict`` (a ``.pth``'s, or
    :func:`tsp_from_jax_params`'s) for the port's ``backbone``."""
    sd = {}
    for k, v in state_dict.items():
        if k.startswith('module.'):
            k = k[len('module.'):]
        sd[k] = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) \
            else v
    anchor, what = _ANCHOR.get(backbone, _RESNET_ANCHOR)
    prefix = next((p for p in ('features.', 'backbone.', '')
                   if p + anchor in sd), None)
    if prefix is None:
        raise ValueError(
            f'load_tsp_weights: no {what} found in the state dict: is this '
            f'really a {backbone} / TSP checkpoint?  First keys: '
            f'{sorted(sd)[:5]}')
    heads, features, leftovers = {}, {}, []
    for k, v in sd.items():
        top = k.split('.')[0]
        if top in HEADS and k.count('.') == 1:
            heads.setdefault(top, {})[k.split('.')[1]] = v
        elif k.startswith(prefix):
            features[k[len(prefix):]] = v
        elif not k.startswith(_IGNORABLE):
            leftovers.append(k)
    features = {k: v for k, v in features.items()
                if not k.startswith(_IGNORABLE)}
    if backbone == 'mvit_v2_s':
        _check_manifest(features, prefix)
    mid_layout = 'block'
    w = features.get('layer2.0.conv2.0.0.weight')
    if w is not None and w.shape[0] == midplanes(128, 128):
        mid_layout = 'conv'
    with torch.device('meta'):
        want = make_backbone(backbone, config, mid_layout).state_dict()
    leftovers += [prefix + k for k in features if k not in want]
    for k in want:      # older torchvision files predate BN's counter
        if k.endswith('num_batches_tracked') and k not in features:
            features[k] = torch.zeros((), dtype=torch.int64)
    if leftovers:
        raise ValueError(
            'load_tsp_weights: unconsumed checkpoint tensors (layout '
            f'mismatch with the {backbone} backbone): '
            f'{sorted(leftovers)[:10]}')
    mismatches = [f'{k}: missing from checkpoint' for k in want
                  if k not in features]
    mismatches += [f'{k}: model {tuple(want[k].shape)} vs checkpoint '
                   f'{tuple(features[k].shape)}' for k in want
                   if k in features and want[k].shape != features[k].shape]
    if mismatches:
        raise ValueError(
            'load_tsp_weights: checkpoint shapes do not match the '
            f'{backbone} backbone (wrong input size or config?):\n  '
            + '\n  '.join(sorted(mismatches)[:12]))
    return TSPWeights(features, heads, mid_layout)


def _check_manifest(features, prefix):
    """A 16-block checkpoint at the canonical 16x224x224 input (rel_pos_t
    of 2*8-1 rows) must carry torchvision's exact mvit_v2_s layout."""
    t = features.get('blocks.0.attn.rel_pos_t')
    if 'blocks.15.norm1.weight' not in features or t is None \
            or t.shape[0] != 15 or 'blocks.16.norm1.weight' in features:
        return
    from .mvit_manifest import validate_against_manifest
    deviations = validate_against_manifest(
        {prefix + k: v for k, v in features.items()}, prefix)
    if deviations:
        raise ValueError(
            'load_tsp_weights: checkpoint deviates from the torchvision '
            'mvit_v2_s golden manifest:\n  ' + '\n  '.join(deviations[:12]))


def read_state_dict(path: str) -> dict:
    """The tensors of a ``.pth`` (a bare state dict, or one under
    ``model`` or ``state_dict``, as TSP and torchvision save them), or of
    a JAX ``.ckpt`` converted by :func:`tsp_from_jax_params`."""
    if not path.endswith('.pth'):
        from ...serve import load_checkpoint
        return tsp_from_jax_params(load_checkpoint(path)['variables'])
    # TSP's training checkpoints pickle their argparse options beside the
    # weights, which weights_only refuses
    obj = torch.load(path, map_location='cpu', weights_only=False)
    for key in ('model', 'state_dict'):
        if isinstance(obj, dict) and key in obj:
            obj = obj[key]
    return obj


def load_tsp_weights(path: str, backbone: str,
                     config: MViTConfig | None = None) -> TSPWeights:
    """The checked weights of a TSP checkpoint file for ``backbone``."""
    return tsp_weights(read_state_dict(path), backbone, config)
