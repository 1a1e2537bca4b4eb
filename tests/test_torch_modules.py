"""Port parity, module by module: each ``dvc_tpu_torch`` module against its
flax counterpart with the same weights.

One flax FusionPDVC (tiny_opt scale, LSTM-DSA caption head) is initialised;
its params are converted with the port's ``from_jax_params`` and loaded
into the port's model; then each flax submodule is applied to its own
params subtree and compared with the matching torch submodule on the same
numpy inputs.  Tolerance rtol/atol 1e-5 for single layers (f32, same
operations in a different summation order), 1e-4 for the base encoder,
whose GroupNorm statistics flax computes as E[x^2] - E[x]^2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import (fusion_batch, jax_fusion_params, tiny_opt,  # noqa: I100
                        to_numpy, to_torch)

from dvc_tpu.models.base_encoder import BaseEncoder as JaxBaseEncoder
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxCaptionHead
from dvc_tpu.models.deformable_transformer import (
    DecoderLayer as JaxDecoderLayer, EncoderLayer as JaxEncoderLayer,
    encoder_reference_points as jax_enc_ref)
from dvc_tpu.models.fusion import AttentionBlock as JaxAttentionBlock
from dvc_tpu.models.position_encoding import (
    PositionEmbeddingSine as JaxPositionEmbeddingSine)
from dvc_tpu_torch.models import from_jax_params, make_fusion_model
from dvc_tpu_torch.models.deformable_transformer import encoder_reference_points

pytestmark = pytest.mark.heavy

SHAPES = (24, 12, 6, 3)          # pyramid of T = 24


@pytest.fixture(scope='module')
def models():
    opt = tiny_opt()
    params = jax_fusion_params(opt, fusion_batch(0))
    model = make_fusion_model(opt, device='cpu')
    model.load_state_dict({k: to_torch(v) for k, v in
                           from_jax_params(params).items()}, strict=True)
    return opt, params['params'], model


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=tol,
                               atol=tol)


def test_position_encoding(models):
    opt, p, model = models
    rng = np.random.default_rng(1)
    mask = rng.uniform(size=(3, 24)) < 0.2
    dur = np.array([0.5, 37.2, 400.0], np.float32)   # 400 s saturates 256
    want = JaxPositionEmbeddingSine(opt.hidden_dim // 2).apply(
        {'params': p['pdvc']['base_encoder']['pos_embed']},
        jnp.asarray(mask), jnp.asarray(dur))
    with torch.no_grad():
        got = model.pdvcModel.base_encoder.pos_embed(to_torch(mask),
                                                     to_torch(dur))
    close(got, want)


def test_base_encoder(models):
    opt, p, model = models
    b = fusion_batch(2)
    pad = ~b['video_mask']
    dur = b['video_length'][:, 1]
    want = JaxBaseEncoder(4, opt.feature_dim, opt.hidden_dim).apply(
        {'params': p['pdvc']['base_encoder']}, jnp.asarray(b['video_tensor']),
        jnp.asarray(pad), jnp.asarray(dur))
    with torch.no_grad():
        got = model.pdvcModel.base_encoder(to_torch(b['video_tensor']),
                                           to_torch(pad), to_torch(dur))
    for g_list, w_list in zip(got, want):
        assert [tuple(g.shape) for g in g_list] == [w.shape for w in w_list]
        for g, w in zip(g_list, w_list):
            close(g, w, 1e-4)


def _enc_inputs(seed, d=64, B=2):
    rng = np.random.default_rng(seed)
    S = sum(SHAPES)
    src = rng.standard_normal((B, S, d)).astype(np.float32)
    pos = rng.standard_normal((B, S, d)).astype(np.float32)
    vr = rng.uniform(0.6, 1.0, (B, 4)).astype(np.float32)
    pad = rng.uniform(size=(B, S)) < 0.1
    return src, pos, vr, pad


def test_encoder_reference_points():
    _, _, vr, _ = _enc_inputs(3)
    close(encoder_reference_points(SHAPES, to_torch(vr)),
          jax_enc_ref(SHAPES, jnp.asarray(vr)))


def test_encoder_layer(models):
    opt, p, model = models
    src, pos, vr, pad = _enc_inputs(4)
    ref = jax_enc_ref(SHAPES, jnp.asarray(vr))
    want = JaxEncoderLayer(opt.hidden_dim, opt.transformer_ff_dim, 0.0, 4,
                           opt.nheads, 4, msda_impl='ref').apply(
        {'params': p['pdvc']['encoder_layer_1']}, jnp.asarray(src),
        jnp.asarray(pos), ref, SHAPES, jnp.asarray(pad), True)
    with torch.no_grad():
        got = model.pdvcModel.transformer.encoder.layers[1](
            to_torch(src), to_torch(pos), to_torch(ref), SHAPES,
            to_torch(pad))
    close(got, want)


@pytest.mark.parametrize('ref_dim', [1, 2])
def test_decoder_layer(models, ref_dim):
    """1-d (first layer) and 2-d (refined box) reference points."""
    opt, p, model = models
    memory, _, _, pad = _enc_inputs(5)
    rng = np.random.default_rng(6)
    B, Nq, d = 2, 10, opt.hidden_dim
    tgt = rng.standard_normal((B, Nq, d)).astype(np.float32)
    qpos = rng.standard_normal((B, Nq, d)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (B, Nq, 4, ref_dim)).astype(np.float32)
    # make the cross-attention offsets and weights non-trivial (the flax
    # init zeroes both kernels)
    lp = jax.tree_util.tree_map(np.array, p['pdvc']['decoder_layer_0'])
    for m in ('sampling_offsets', 'attention_weights'):
        k = lp['cross_attn'][m]['kernel']
        lp['cross_attn'][m]['kernel'] = (
            rng.standard_normal(k.shape) * 0.1).astype(np.float32)
    want = JaxDecoderLayer(d, opt.transformer_ff_dim, 0.0, 4, opt.nheads, 4,
                           msda_impl='ref').apply(
        {'params': lp}, jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref),
        jnp.asarray(memory), SHAPES, jnp.asarray(pad),
        jnp.ones((B, Nq), bool), True)
    layer = model.pdvcModel.transformer.decoder.layers[0]
    with torch.no_grad():
        for m in ('sampling_offsets', 'attention_weights'):
            getattr(layer.cross_attn, m).weight.copy_(
                to_torch(lp['cross_attn'][m]['kernel'].T))
        got = layer(to_torch(tgt), to_torch(qpos), to_torch(ref),
                    to_torch(memory), SHAPES, to_torch(pad))
    close(got, want)


def test_fusion_attention_block(models):
    opt, p, model = models
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 24, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 24, 16)).astype(np.float32)
    want = JaxAttentionBlock(16, 4).apply({'params': p['sound_ca']},
                                          jnp.asarray(q), jnp.asarray(kv))
    with torch.no_grad():
        got = model._block(2, to_torch(q), to_torch(kv))
    close(got, want)


def test_caption_head_greedy(models):
    """The LSTM-DSA head's fused greedy decode (hoists plus the K-step
    loop) against the flax head's greedy_fuse path, same weights."""
    opt, p, model = models
    from dvc_tpu.models.pdvc import PDVCConfig
    cfg = PDVCConfig.from_opt(opt).caption
    rng = np.random.default_rng(8)
    B, Pq, d = 2, 10, opt.hidden_dim
    query = rng.standard_normal((B, Pq, d)).astype(np.float32)
    ref_c = rng.uniform(0.1, 0.9, (B, Pq, 4)).astype(np.float32)
    scale = rng.uniform(0.01, 0.1, (B, Pq, 4)).astype(np.float32)
    memory = rng.standard_normal((B, sum(SHAPES), d)).astype(np.float32)
    pad = rng.uniform(size=(B, sum(SHAPES))) < 0.1
    want_seq, want_lp = JaxCaptionHead(cfg, att_impl='ref').apply(
        {'params': p['pdvc']['caption_head']}, jnp.asarray(query),
        jnp.asarray(ref_c), jnp.asarray(scale), jnp.asarray(memory), SHAPES,
        jnp.asarray(pad), mode='sample')
    with torch.no_grad():
        seq, lp = model.pdvcModel.caption_head[1](
            to_torch(query), to_torch(ref_c), to_torch(scale),
            to_torch(memory), SHAPES, to_torch(pad))
    np.testing.assert_array_equal(to_numpy(seq), np.asarray(want_seq))
    close(lp, want_lp)
