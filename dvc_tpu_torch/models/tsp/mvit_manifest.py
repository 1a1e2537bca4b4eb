"""Golden parameter manifest of torchvision's real ``mvit_v2_s`` (the
port's own copy of ``dvc_tpu/models/tsp/mvit_manifest.py``).

Layout insurance for the weight loader (``convert.load_tsp_weights``)
that does not need torchvision (the port does not depend on it): the exact
state-dict *names and shapes* of ``torchvision.models.video.mvit_v2_s()``
are reconstructed here from torchvision's construction rules, transcribed
independently of the ``tests/torch_mvit_ref.py`` re-creation so the two
cross-check each other (``tests/test_mvit_converter.py``).

Sources of the rules (torchvision ``models/video/mvit.py``):

* ``conv_proj``: Conv3d(3, 96, kernel (3,7,7), stride (2,4,4)) with bias.
* ``pos_encoding.class_token`` only — ``rel_pos_embed=True`` creates no
  absolute position tables.
* per block: ``norm1``/``norm2`` LayerNorms; ``attn.qkv`` Linear
  (in, 3*out); ``attn.project`` = Sequential[Linear] -> ``project.0``;
  ``attn.pool_{q,k,v}`` = Pool(depthwise bias-free Conv3d(head_dim) +
  ``norm_act`` Sequential[LayerNorm] -> ``norm_act.0``); decomposed
  ``rel_pos_{h,w,t}`` tables sized ``2*max(q_size, kv_size)-1`` /
  ``2*T-1`` by ``head_dim``; ``mlp`` = torchvision MLP Sequential
  [Linear, GELU, Dropout, Linear, Dropout] -> ``mlp.0``/``mlp.3``;
  ``project`` Linear only when in != out; ``pool_skip`` is a MaxPool3d
  (no parameters).
* mvit_v2_s block table: 16 blocks, depths (1,2,11,2); channels AND heads
  double inside the Q-pooling blocks 1, 3, 14 (the official MViTv2-S
  DIM_MUL/HEAD_MUL with DIM_MUL_IN_ATT=True); adaptive kv stride starts
  at (1,8,8) and halves at every Q-pooling block; head_dim stays 96.
* top: ``norm`` LayerNorm(768); ``head`` = Sequential[Dropout, Linear]
  -> ``head.1`` (Kinetics-400: 400 classes).

Reference consumer: the reference's
``video_backbone/TSP/models/backbone.py:46-50``
builds exactly this model; ``TSPmodel.py:70-85`` wraps it with the head
stripped.
"""

from __future__ import annotations

# (in_ch, out_ch, heads, q_stride_hw, spatial_in) per block for
# mvit_v2_s at 16x224x224 input (patch grid 8x56x56)
_BLOCKS = []
_dim, _heads, _kv, _s = 96, 1, 8, 56
for _i, (_depth, _stage) in enumerate([(1, 0), (2, 1), (11, 2), (2, 3)]):
    for _b in range(_depth):
        pool = (_b == 0 and _stage > 0)
        if pool:
            _kv = max(_kv // 2, 1)
        out = _dim * 2 if pool else _dim
        heads = _heads * 2 if pool else _heads
        _BLOCKS.append((_dim, out, heads, 2 if pool else 1, _s, _kv))
        if pool:
            _s //= 2
        _dim, _heads = out, heads

_HEAD_DIM = 96
_T = 8                      # 16 frames / temporal patch stride 2


def mvit_v2_s_manifest(num_classes: int = 400, with_head: bool = True):
    """``{torch key: shape tuple}`` for torchvision ``mvit_v2_s()`` at the
    canonical 16x224x224 input."""
    m = {
        'conv_proj.weight': (96, 3, 3, 7, 7),
        'conv_proj.bias': (96,),
        'pos_encoding.class_token': (96,),
    }
    for i, (cin, cout, heads, q_s, s_in, kv) in enumerate(_BLOCKS):
        p = f'blocks.{i}'
        D = _HEAD_DIM
        q_size = s_in // q_s
        kv_size = s_in // kv
        sp = 2 * max(q_size, kv_size) - 1
        m[f'{p}.norm1.weight'] = (cin,)
        m[f'{p}.norm1.bias'] = (cin,)
        m[f'{p}.norm2.weight'] = (cout,)
        m[f'{p}.norm2.bias'] = (cout,)
        m[f'{p}.attn.qkv.weight'] = (3 * cout, cin)
        m[f'{p}.attn.qkv.bias'] = (3 * cout,)
        m[f'{p}.attn.project.0.weight'] = (cout, cout)
        m[f'{p}.attn.project.0.bias'] = (cout,)
        for pool in ('pool_q', 'pool_k', 'pool_v'):
            m[f'{p}.attn.{pool}.pool.weight'] = (D, 1, 3, 3, 3)
            m[f'{p}.attn.{pool}.norm_act.0.weight'] = (D,)
            m[f'{p}.attn.{pool}.norm_act.0.bias'] = (D,)
        m[f'{p}.attn.rel_pos_h'] = (sp, D)
        m[f'{p}.attn.rel_pos_w'] = (sp, D)
        m[f'{p}.attn.rel_pos_t'] = (2 * _T - 1, D)
        m[f'{p}.mlp.0.weight'] = (4 * cout, cout)
        m[f'{p}.mlp.0.bias'] = (4 * cout,)
        m[f'{p}.mlp.3.weight'] = (cout, 4 * cout)
        m[f'{p}.mlp.3.bias'] = (cout,)
        if cin != cout:
            m[f'{p}.project.weight'] = (cout, cin)
            m[f'{p}.project.bias'] = (cout,)
    m['norm.weight'] = (768,)
    m['norm.bias'] = (768,)
    if with_head:
        m['head.1.weight'] = (num_classes, 768)
        m['head.1.bias'] = (num_classes,)
    return m


def validate_against_manifest(sd: dict, prefix: str = ''):
    """Diff a (numpy-valued) torch state dict's backbone keys against the
    golden manifest.  Returns a list of human-readable deviations; empty
    means the checkpoint carries torchvision's exact mvit_v2_s layout.

    ``head.*`` keys are not checked (TSP fine-tunes replace the head —
    reference TSPmodel.py:82-85) and keys outside ``prefix`` are ignored.
    """
    import numpy as np
    manifest = mvit_v2_s_manifest(with_head=False)
    got = {}
    for k, v in sd.items():
        if not k.startswith(prefix):
            continue
        tail = k[len(prefix):]
        if (tail.startswith('head.') or 'num_batches_tracked' in tail
                or tail.split('.')[0] in ('fc', 'fc1', 'fc2')):
            # replaced classifier / TSP heads (reference TSPmodel.py:82-85)
            continue
        got[tail] = tuple(np.shape(v))
    out = []
    for k in sorted(set(manifest) - set(got)):
        out.append(f'missing from checkpoint: {prefix}{k} {manifest[k]}')
    for k in sorted(set(got) - set(manifest)):
        out.append(f'not in torchvision mvit_v2_s: {prefix}{k} {got[k]}')
    for k in sorted(set(got) & set(manifest)):
        if got[k] != manifest[k]:
            out.append(f'shape drift: {prefix}{k} checkpoint {got[k]} '
                       f'vs torchvision {manifest[k]}')
    return out
