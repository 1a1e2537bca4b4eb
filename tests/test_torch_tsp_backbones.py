"""The port's TSP backbones (``dvc_tpu_torch.models.tsp``) against
``dvc_tpu.models.tsp`` on the same numpy inputs: R3D-18, R(2+1)D-18,
R(2+1)D-34 and two tiny MViTv2s (tests/test_mvit_converter.py's TINY,
and three stages with ``kv_stride0`` 4), every parameter and BatchNorm
statistic drawn from seeded noise (tests/torch_tsp_env.py) and carried
over by ``tsp_from_jax_params``; the TSP heads; and the torchvision
layout of the (2+1)-D middle widths.

Tolerances: float32 rtol 1e-4, atol 2e-5 (tests/test_mvit_converter.py's).
bfloat16 (weights and input cast, both packages): the port's features
within 3e-2 of the JAX bf16 features' norm, in L2, and no farther from
the float32 features than the JAX bf16 ones are (x 1.25, + 5e-3).  The
two packages round at different points (XLA fuses the elementwise chains
and rounds once; eager torch rounds after each op), and on these tiny
noisy nets either bf16 forward lies up to 6% from float32 and the two up
to about 2% from each other.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_tsp_env import jax_variables, noisy_tree  # noqa: I100

from dvc_tpu.models import tsp as jtsp
from dvc_tpu_torch.models.tsp import (MViTConfig, TSPModel, load_tsp_weights,
                                      make_backbone, make_tsp_model,
                                      tsp_from_jax_params, tsp_weights)
from dvc_tpu_torch.models.tsp.backbones import midplanes

pytestmark = pytest.mark.heavy

F32 = dict(rtol=1e-4, atol=2e-5)
BF16_REL = 3e-2

MVIT = {
    'mvit_tiny': dict(embed_dim=8, depths=(1, 2), heads=(1, 2),
                      temporal_size=4, spatial_size=16, kv_stride0=2,
                      feature_dim=16),
    'mvit_kv4': dict(embed_dim=8, depths=(1, 1, 2), heads=(1, 2, 4),
                     temporal_size=4, spatial_size=32, kv_stride0=4,
                     feature_dim=32),
}
RESNETS = ('r3d_18', 'r2plus1d_18', 'r2plus1d_34')


def _jax_backbone(name):
    if name in MVIT:
        return jtsp.MViTV2(jtsp.MViTConfig(**MVIT[name]))
    return getattr(jtsp, name)()


def _port_backbone(name, state_dict):
    if name in MVIT:
        model = make_backbone('mvit_v2_s', MViTConfig(**MVIT[name]))
    else:
        model = make_backbone(name, mid_layout='conv')
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _clips(name, seed=1, B=2):
    cfg = MVIT.get(name, dict(temporal_size=4, spatial_size=32))
    return np.random.default_rng(seed).standard_normal(
        (B, cfg['temporal_size'], cfg['spatial_size'], cfg['spatial_size'],
         3)).astype(np.float32)


def _port(model, x, dtype=torch.float32):
    with torch.inference_mode():
        return model.to(dtype)(torch.from_numpy(x).to(dtype)
                               .permute(0, 4, 1, 2, 3)).float().numpy()


def _bf16(tree):
    return jax.tree_util.tree_map(lambda v: jnp.asarray(v, jnp.bfloat16),
                                  tree)


@pytest.mark.parametrize('name', RESNETS + tuple(MVIT))
def test_backbone_matches_jax(name):
    """float32 within F32 and bfloat16 within BF16_REL of the JAX
    backbone, on weights with no zero left in them."""
    jm = _jax_backbone(name)
    x = _clips(name)
    variables = jax_variables(jm, x)
    ref = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = _port_backbone(name, tsp_from_jax_params(variables))
    out = _port(model, x)
    assert out.shape == ref.shape == (2, model.feature_size)
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, **F32)

    ref16 = np.asarray(jax.jit(jm.apply)(
        _bf16(variables), jnp.asarray(x, jnp.bfloat16))).astype(np.float32)
    out16 = _port(model, x, torch.bfloat16)
    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)
    assert rel(out16, ref16) < BF16_REL, rel(out16, ref16)
    assert rel(out16, ref) <= 1.25 * rel(ref16, ref) + 5e-3


@pytest.mark.parametrize('heads', [((5,), 1, False), ((5, 2), 2, False),
                                   ((5, 2), 2, True)])
def test_tsp_model_heads_match_jax(heads):
    """TSPModel's one- and two-head forward with return_features (the
    second head over the features and a global video feature under
    concat_gvf) against the JAX TSPModel, on R3D-18."""
    num_classes, num_heads, gvf = heads
    jm = jtsp.TSPModel(backbone='r3d_18', num_classes=num_classes,
                       num_heads=num_heads, concat_gvf=gvf)
    x = _clips('r3d_18', seed=3)
    g = np.random.default_rng(4).standard_normal((2, 512)).astype(np.float32)
    variables = noisy_tree(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0), jnp.zeros(x.shape),
        jnp.zeros(g.shape)))
    logits, feats = jax.jit(functools.partial(
        jm.apply, return_features=True))(variables, jnp.asarray(x),
                                         jnp.asarray(g))
    model = TSPModel('r3d_18', num_classes, num_heads, concat_gvf=gvf)
    model.load_state_dict(tsp_from_jax_params(variables), strict=True)
    with torch.inference_mode():
        got, got_feats = model.eval()(
            torch.from_numpy(x).permute(0, 4, 1, 2, 3), torch.from_numpy(g),
            return_features=True)
    np.testing.assert_allclose(got_feats.numpy(), np.asarray(feats), **F32)
    assert len(got) == len(logits) == num_heads
    for a, b in zip(got, logits):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **F32)


def test_r2plus1d_layouts():
    """torchvision's R(2+1)D-18 has 31,505,325 parameters with its
    400-way classifier (512 * 400 + 400 of them): the port's 'block'
    layout has the rest; the 'conv' layout has the JAX tree's count, and
    a state dict of either layout loads as the layout it was saved in."""
    block = make_backbone('r2plus1d_18')
    assert sum(p.numel() for p in block.parameters()) == \
        31_505_325 - (512 * 400 + 400)
    conv = make_backbone('r2plus1d_18', mid_layout='conv')
    shapes = jax.eval_shape(jtsp.r2plus1d_18().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 4, 32, 32, 3)))
    assert sum(p.numel() for p in conv.parameters()) == sum(
        int(np.prod(s.shape)) for s in
        jax.tree_util.tree_leaves(shapes['params']))
    w = block.layer2[0].conv2[0][0].weight
    assert w.shape[0] == midplanes(64, 128) != midplanes(128, 128)
    for model, layout in ((block, 'block'), (conv, 'conv')):
        assert tsp_weights(model.state_dict(), 'r2plus1d_18').mid_layout \
            == layout


def test_mvit_v2_s_has_torchvision_layout():
    """The port's MViTv2-S state dict carries torchvision's exact
    mvit_v2_s names and shapes (the golden manifest), so a torchvision or
    TSP .pth loads with strict=True."""
    from dvc_tpu_torch.models.tsp.mvit_manifest import (
        validate_against_manifest)
    with torch.device('meta'):
        model = TSPModel('mvit_v2_s', (400,), 1)
    sd = model.state_dict()
    assert validate_against_manifest(sd, 'features.') == []
    assert len([k for k in sd if k.startswith('features.')]) == 395


def test_make_tsp_model_is_seeded(tmp_path):
    """Seeded random weights (the same for one seed, others for another),
    zero rel-pos tables and class token as the flax init; a saved
    ``.pth`` of it loads back through load_tsp_weights."""
    cfg = MViTConfig(**MVIT['mvit_tiny'])
    a, b, c = (make_tsp_model('mvit_v2_s', 'cpu', seed, config=cfg)
               for seed in (0, 0, 1))
    sa, sb, sc = (m.state_dict() for m in (a, b, c))
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa['features.blocks.0.attn.qkv.weight'],
                           sc['features.blocks.0.attn.qkv.weight'])
    assert not sa['features.blocks.1.attn.rel_pos_h'].any()
    path = str(tmp_path / 'tsp.pth')
    torch.save({'model': sa}, path)
    w = load_tsp_weights(path, 'mvit_v2_s', cfg)
    assert set(w.heads) == {'fc'}
    assert all(torch.equal(w.features[k], sa['features.' + k])
               for k in w.features)
