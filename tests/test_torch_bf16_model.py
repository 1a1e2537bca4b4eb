"""Port parity of the bf16 FusionPDVC (``--tpu_compute_dtype bfloat16
--fusion_dtype bfloat16``) against the JAX package's, on the same weights:
the trunk layers, the decoder's self-attention and the fusion block against
their flax modules at ``dtype=bfloat16``; the whole model's serving
forward, its encoder memory and its train forward (losses and gradients);
the caption head's teacher forcing and greedy decode with its fused
kernels' bf16 products (JAX ``att_impl='pallas_interpret'``,
``att_precision='bfloat16'``; the port's plain versions of K4-K6-bf16).

The JAX side runs eagerly (op by op).  Under ``jax.jit`` XLA on the CPU may
keep f32 between fused bf16 operations (excess precision), which moves the
JAX model as far from flax's rounding points as bf16 lies from f32; eagerly
it rounds where flax's ``dtype`` says, as the port does.  Measured: the
layers agree bitwise, the model's outputs within 1.3e-7 relative L2.

Tolerances, each a relative L2 error: single layers 1e-5; the model's
outputs (class logits, count logits, boxes, memory, caption log-probs on
the steps before a near-tie) 1e-3; the caption head's log-probs 1e-4 and
its weight gradients 1e-3 (+1e-6 absolute for alpha_net's bias, zero in
exact arithmetic); the train forward's losses 1e-3 each and every
gradient 3e-2 (+1e-6; alpha_net's bias 1e-6 absolute).  The gradients
differ more than the forward: each package's backward rules round their
bf16 cotangents at other points (torch's LayerNorm, softmax and matmul
backwards compute in f32 and round once); measured 0.5% median, 2% at
most, against 3-11% between bf16 and f32.  And (the acceptance's ratio)
the port's bf16 outputs lie from its f32 ones within 1.5x the distance of
JAX's bf16 from JAX's f32.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import (caption_head_state_dict, fusion_batch,  # noqa: I100
                        jax_fusion_params, tiny_opt, to_numpy, to_torch,
                        train_batch)

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxHead
from dvc_tpu.models.criterion import build_weight_dict as jax_weight_dict
from dvc_tpu.models.deformable_transformer import (
    DecoderLayer as JaxDecoderLayer, EncoderLayer as JaxEncoderLayer,
    encoder_reference_points as jax_enc_ref)
from dvc_tpu.models.fusion import AttentionBlock as JaxAttentionBlock
from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu_torch.models import from_jax_params, make_fusion_model
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.models.criterion import build_weight_dict
from dvc_tpu_torch.models.deformable_transformer import MultiheadAttention
from dvc_tpu_torch.ops import dsa_greedy_scan_ref, dsa_teacher_scan_ref
from test_torch_modules import SHAPES, _enc_inputs
from test_torch_train import off_boundary

pytestmark = pytest.mark.heavy

BF16 = dict(tpu_compute_dtype='bfloat16', fusion_dtype='bfloat16')
DTYPES = {'float32': jnp.float32, 'bfloat16': jnp.bfloat16}


def rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def perturbed(params, seed=0):
    """``off_boundary`` params with the bbox heads' zero-initialised last
    layers set to small random values, so that the boxes move with the
    decoder's outputs."""
    rng = np.random.default_rng(seed + 1)

    def move(path, x):
        names = [getattr(k, 'key', '') for k in path]
        if any(n.startswith('bbox_head') for n in names) \
                and 'layer2' in names and 'kernel' in names:
            return (rng.standard_normal(np.shape(x)) * 0.05).astype(
                np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(move, off_boundary(params, seed))


def port_model(opt, params):
    model = make_fusion_model(opt, device='cpu')
    model.load_state_dict({k: to_torch(v) for k, v in
                           from_jax_params(params).items()}, strict=True)
    return model


@pytest.fixture(scope='module')
def layer_models():
    """The port's tiny FusionPDVC in f32 and bf16 on one flax init."""
    params = jax_fusion_params(tiny_opt(), fusion_batch(0))
    models = {dt: port_model(tiny_opt(tpu_compute_dtype=dt, fusion_dtype=dt),
                             params) for dt in DTYPES}
    return params['params'], models


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_encoder_layer(layer_models, dtype):
    p, models = layer_models
    opt = tiny_opt()
    src, pos, vr, pad = _enc_inputs(4)
    ref = jax_enc_ref(SHAPES, jnp.asarray(vr))
    want = JaxEncoderLayer(opt.hidden_dim, opt.transformer_ff_dim, 0.0, 4,
                           opt.nheads, 4, msda_impl='ref',
                           dtype=DTYPES[dtype]).apply(
        {'params': p['pdvc']['encoder_layer_1']}, jnp.asarray(src),
        jnp.asarray(pos), ref, SHAPES, jnp.asarray(pad), True)
    with torch.no_grad():
        got = models[dtype].pdvcModel.transformer.encoder.layers[1](
            to_torch(src), to_torch(pos), to_torch(ref), SHAPES,
            to_torch(pad))
    assert str(got.dtype).endswith(dtype) and want.dtype == DTYPES[dtype]
    assert rel_l2(to_numpy(got.float()), want.astype(jnp.float32)) <= 1e-5


@pytest.mark.parametrize('ref_dim', [1, 2])
def test_decoder_layer(layer_models, ref_dim):
    """bf16 decoder layer, its self-attention over a query mask with a
    padded query, 1-d and 2-d reference points."""
    p, models = layer_models
    opt = tiny_opt()
    memory, _, _, pad = _enc_inputs(5)
    rng = np.random.default_rng(6)
    B, Nq, d = 2, 10, opt.hidden_dim
    tgt = rng.standard_normal((B, Nq, d)).astype(np.float32)
    qpos = rng.standard_normal((B, Nq, d)).astype(np.float32)
    ref = rng.uniform(0.05, 0.95, (B, Nq, 4, ref_dim)).astype(np.float32)
    qmask = np.ones((B, Nq), bool)
    qmask[1, 7:] = False
    lp = jax.tree_util.tree_map(np.array, p['pdvc']['decoder_layer_0'])
    for m in ('sampling_offsets', 'attention_weights'):
        k = lp['cross_attn'][m]['kernel']
        lp['cross_attn'][m]['kernel'] = (
            rng.standard_normal(k.shape) * 0.1).astype(np.float32)
    want = JaxDecoderLayer(d, opt.transformer_ff_dim, 0.0, 4, opt.nheads, 4,
                           msda_impl='ref', dtype=jnp.bfloat16).apply(
        {'params': lp}, jnp.asarray(tgt), jnp.asarray(qpos), jnp.asarray(ref),
        jnp.asarray(memory), SHAPES, jnp.asarray(pad), jnp.asarray(qmask),
        True)
    layer = models['bfloat16'].pdvcModel.transformer.decoder.layers[0]
    with torch.no_grad():
        for m in ('sampling_offsets', 'attention_weights'):
            getattr(layer.cross_attn, m).weight.copy_(
                to_torch(lp['cross_attn'][m]['kernel'].T))
        got = layer(to_torch(tgt), to_torch(qpos), to_torch(ref),
                    to_torch(memory), SHAPES, to_torch(pad), to_torch(qmask))
    assert got.dtype == torch.bfloat16
    assert rel_l2(to_numpy(got.float()), want.astype(jnp.float32)) <= 1e-5


def test_multihead_attention():
    """The port's bf16 MultiheadAttention against flax 0.12's
    MultiHeadDotProductAttention(dtype=bfloat16) with a key mask."""
    rng = np.random.default_rng(9)
    B, T, C, nh = 2, 7, 24, 4
    q, k, v = (rng.standard_normal((B, T, C)).astype(np.float32)
               for _ in range(3))
    mask = np.ones((B, T), bool)
    mask[0, 5:] = False
    jmha = fnn.MultiHeadDotProductAttention(num_heads=nh, dtype=jnp.bfloat16)
    params = jmha.init(jax.random.PRNGKey(1), jnp.asarray(q), jnp.asarray(k),
                       jnp.asarray(v))['params']
    params = jax.tree_util.tree_map(
        lambda x: (rng.standard_normal(x.shape) * 0.3).astype(np.float32),
        params)
    want = jmha.apply({'params': params}, jnp.asarray(q), jnp.asarray(k),
                      jnp.asarray(v), mask=jnp.asarray(mask)[:, None, None, :],
                      deterministic=True)
    mha = MultiheadAttention(C, nh, dtype=torch.bfloat16)
    with torch.no_grad():
        mha.in_proj_weight.copy_(torch.cat([
            to_torch(params[n]['kernel']).reshape(C, C).T
            for n in ('query', 'key', 'value')]))
        mha.in_proj_bias.copy_(torch.cat([
            to_torch(params[n]['bias']).reshape(C)
            for n in ('query', 'key', 'value')]))
        mha.out_proj.weight.copy_(to_torch(params['out']['kernel']).reshape(
            C, C).T)
        mha.out_proj.bias.copy_(to_torch(params['out']['bias']))
        got = mha(to_torch(q), to_torch(k), to_torch(v), to_torch(mask))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert rel_l2(to_numpy(got.float()), want.astype(jnp.float32)) <= 1e-5


def test_fusion_attention_block(layer_models):
    """--fusion_dtype bfloat16: the MHA and mlp_fc in bf16, the LayerNorms
    and residual adds in f32, the block's output f32."""
    p, models = layer_models
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 24, 16)).astype(np.float32)
    kv = rng.standard_normal((2, 24, 16)).astype(np.float32)
    want = JaxAttentionBlock(16, 4, dtype='bfloat16').apply(
        {'params': p['sound_ca']}, jnp.asarray(q), jnp.asarray(kv))
    f32 = JaxAttentionBlock(16, 4).apply(
        {'params': p['sound_ca']}, jnp.asarray(q), jnp.asarray(kv))
    with torch.no_grad():
        got = models['bfloat16']._block(2, to_torch(q), to_torch(kv))
    assert got.dtype == torch.float32
    assert rel_l2(to_numpy(got), want) <= 1e-5
    assert rel_l2(want, f32) > 1e-4           # bf16 did round


def _jax_memory(jmodel, params, batch):
    """The JAX FusionPDVC's encoder memory (B, S, d), eagerly."""
    def encode(m, b):
        clips = b['video_tensor']
        fused = m.sound_block(b['sound_tensor'], m.visual_block(clips, clips))
        inner = {k: v for k, v in b.items() if k != 'sound_tensor'}
        inner['video_tensor'] = fused
        return m.pdvc.encode(inner, True)[0]
    return jmodel.apply(params, batch, method=encode)


@pytest.fixture(scope='module')
def model_runs():
    """Serving outputs and memory of the JAX and the port's FusionPDVC, in
    f32 and in bf16, on one batch and one set of (perturbed) weights."""
    base = dict(transformer_dropout_prob=0.0, drop_prob=0.0,
                msda_impl='pallas_interpret')
    batch = train_batch(1)
    opt32 = tiny_opt(**base)
    params = perturbed(jax.jit(lambda r, b: jax_make_fusion(opt32).init(
        {'params': r}, b, eval_mode=False, deterministic=True,
        ss_enabled=False))(jax.random.PRNGKey(0), _jnp(batch)))
    runs = {}
    for dt, opt in (('float32', opt32), ('bfloat16', tiny_opt(**base,
                                                               **BF16))):
        jmodel = jax_make_fusion(opt)
        jout, _ = jmodel.apply(params, _jnp(batch), eval_mode=True)
        jmem = _jax_memory(jmodel, params, _jnp(batch))
        model = port_model(opt, params)
        calls = dsa_greedy_scan_ref.calls
        with torch.no_grad():
            out = model(_torch(batch))
            mem = model.pdvcModel.encode(model._fuse(_torch(batch)))[0]
        assert dsa_greedy_scan_ref.calls == calls + 1
        runs[dt] = ({k: np.asarray(v) for k, v in jout.items()},
                    {k: to_numpy(v) for k, v in out.items()},
                    np.asarray(jmem), to_numpy(mem))
    return runs


OUTPUTS = ('pred_logits', 'pred_count', 'pred_boxes', 'memory',
           'cap_prob_eval')


def _output(run, name, side):
    jout, out, jmem, mem = run
    if name == 'memory':
        return (jmem, mem)[side]
    return (jout, out)[side][name]


def _comparable(run):
    """Caption log-prob mask of the (video*query, step) entries whose
    tokens agree in both packages up to and including that step."""
    jout, out = run[0], run[1]
    same = (jout['seq'] == out['seq']).reshape(-1, out['seq'].shape[-1])
    return np.cumprod(same, axis=1).astype(bool)


@pytest.mark.parametrize('name', OUTPUTS)
def test_bf16_model_matches_jax(model_runs, name):
    """(c) The bf16 FusionPDVC's serving outputs and memory against the
    JAX model's on the same weights (relative L2 1e-3; measured ~1e-7),
    in f32 out of the model (memory and the heads' inputs are f32)."""
    run = model_runs['bfloat16']
    got, want = _output(run, name, 1), _output(run, name, 0)
    assert got.dtype == np.float32
    if name == 'cap_prob_eval':
        ok = _comparable(run)
        assert ok.mean() > 0.9
        got, want = got.reshape(ok.shape)[ok], want.reshape(ok.shape)[ok]
    assert rel_l2(got, want) <= 1e-3, name


@pytest.mark.parametrize('name', OUTPUTS)
def test_bf16_lies_as_far_from_f32_as_in_jax(model_runs, name):
    """(e) The port's bf16-to-f32 distance within 1.5x JAX's, output by
    output, on the same batch; and bf16 did move each output."""
    dist = {}
    for side in (0, 1):
        a = _output(model_runs['bfloat16'], name, side)
        b = _output(model_runs['float32'], name, side)
        if name == 'cap_prob_eval':
            ok = _comparable(model_runs['bfloat16']) & _comparable(
                model_runs['float32'])
            ok &= np.cumprod(model_runs['bfloat16'][side]['seq'].reshape(
                ok.shape) == model_runs['float32'][side]['seq'].reshape(
                ok.shape), axis=1).astype(bool)
            a, b = a.reshape(ok.shape)[ok], b.reshape(ok.shape)[ok]
        dist[side] = rel_l2(a, b)
    assert dist[0] > 1e-5, (name, dist)
    assert dist[1] <= 1.5 * dist[0], (name, dist)


def _head_setup(precision):
    """A one-layer LSTM-DSA head with attention (the fused kernels' case)
    in both packages, the offset kernel off the tap boundary."""
    from test_torch_caption_core import BASE, head_inputs, seq_of
    cfg = dict(BASE, num_layers=1, att_hid_size=20)
    inputs = head_inputs(3)
    params = JaxHead(JaxHeadConfig(**cfg), att_impl='ref').init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]), (12, 6),
        jnp.asarray(inputs[4]), jnp.asarray(seq_of(1)))['params']
    params = jax.tree_util.tree_map(np.array, params)
    w = params['dsa_sampling_offsets_w']
    params['dsa_sampling_offsets_w'] = (np.random.default_rng(2).standard_normal(
        w.shape) * 0.05).astype(np.float32)
    jhead = JaxHead(JaxHeadConfig(**cfg), att_impl='pallas_interpret',
                    att_precision=precision)
    head = DSACaptionHead(CaptionHeadConfig(**cfg, precision=precision))
    head.load_state_dict({k: to_torch(v) for k, v in
                          caption_head_state_dict(params).items()},
                         strict=True)
    return jhead, head, params, inputs, seq_of(4)


def test_bf16_head_teacher_forcing_matches_jax():
    """The head's teacher forcing through the bf16 scan (the port's plain
    K4-bf16 and K5-bf16, one scan call; JAX's kernels in interpret mode):
    log-probs and every weight gradient."""
    jhead, head, params, inputs, seq = _head_setup('bfloat16')
    jin = [jnp.asarray(a) for a in inputs]
    K, V1 = seq.shape[1] - 1, head.cfg.vocab_size + 1
    n = seq.shape[0]
    wts = np.cos(np.arange(n * K * V1, dtype=np.float32)).reshape(n, K, V1)

    def loss(p):
        lp = jhead.apply({'params': p}, *jin[:4], (12, 6), jin[4],
                         jnp.asarray(seq), deterministic=True)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    tin = [to_torch(a) for a in inputs]
    calls = dsa_teacher_scan_ref.calls
    lp = head.teacher_forcing(*tin[:4], (12, 6), tin[4], to_torch(seq))
    (lp * to_torch(wts)).sum().backward()
    assert dsa_teacher_scan_ref.calls == calls + 1
    assert rel_l2(to_numpy(lp), want) <= 1e-4
    want_g = caption_head_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    for name, p in head.named_parameters():
        err = np.linalg.norm(to_numpy(p.grad) - want_g[name])
        assert err <= 1e-3 * np.linalg.norm(want_g[name]) + 1e-6, name


def test_bf16_head_greedy_matches_jax():
    """The head's fused greedy decode in bf16 (the port's plain K6-bf16):
    tokens and log-probs on the steps before the first difference."""
    jhead, head, params, inputs, _ = _head_setup('bfloat16')
    want_seq, want_lp = jhead.apply(
        {'params': params}, *map(jnp.asarray, inputs[:4]), (12, 6),
        jnp.asarray(inputs[4]), mode='sample')
    with torch.no_grad():
        seq, lp = head(*[to_torch(a) for a in inputs[:4]], (12, 6),
                       to_torch(inputs[4]))
    same = np.cumprod(to_numpy(seq) == np.asarray(want_seq), 1).astype(bool)
    assert same.mean() > 0.9
    assert rel_l2(to_numpy(lp)[same], np.asarray(want_lp)[same]) <= 1e-4


def test_bf16_train_forward_and_gradients_match_jax():
    """(c) The bf16 train forward's losses and every parameter's gradient
    against jax.value_and_grad of the JAX model (eager), same weights and
    batch, dropout off."""
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   msda_impl='pallas_interpret', **BF16)
    batch = train_batch(1)
    jmodel = jax_make_fusion(opt)
    params = perturbed(jax.jit(lambda r, b: jax_make_fusion(tiny_opt()).init(
        {'params': r}, b, eval_mode=False, deterministic=True,
        ss_enabled=False))(jax.random.PRNGKey(0), _jnp(batch)))
    wd = jax_weight_dict(opt)

    def loss_fn(p):
        out, losses = jmodel.apply(p, _jnp(batch), eval_mode=False,
                                   deterministic=True, ss_enabled=False)
        return sum(losses[k] * w for k, w in wd.items()
                   if k in losses and w), (out, losses)

    (_, (jout, jlosses)), jgrads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    model = port_model(opt, params)
    out, losses = model.forward_train(_torch(batch))
    sum(losses[k] * w for k, w in build_weight_dict(opt).items()
        if k in losses and w).backward()
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-3, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(to_numpy(out['matched_indices']),
                                  np.asarray(jout['matched_indices']))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in model.named_parameters(remove_duplicate=False):
        g = to_numpy(p.grad) if p.grad is not None else np.zeros(p.shape)
        err = np.linalg.norm(g - want[name])
        if name.endswith('alpha_net.bias'):     # zero in exact arithmetic
            assert err <= 1e-6, name
        else:
            assert err <= 3e-2 * np.linalg.norm(want[name]) + 1e-6, name


def test_count_head_splits_ties_as_jax():
    """The count head pools the decoder's output over the queries with
    ``jnp.max``, whose gradient splits evenly among tied maxima.  In bf16
    the layer outputs are bf16 values, so ties are common; torch's
    ``max(dim).values`` would route each channel's gradient to one query
    (on the CPU the first, on the card any).  The port's count logits'
    gradient at ties equals JAX's to f32 rounding (1e-6)."""
    model = make_fusion_model(tiny_opt(**BF16), device='cpu', seed=0)
    pdvc = model.pdvcModel
    rng = np.random.default_rng(3)
    B, Nq, C = 2, 10, pdvc.cfg.hidden_dim
    hs = rng.standard_normal((B, Nq, C)).astype(np.float32)
    hs[:, 4] = hs[:, 7] = hs.max(axis=1) + 0.5   # every channel tied twice
    hs[1, 2, ::3] = hs[1, 4, ::3]                 # and some three times
    ref = rng.uniform(0.2, 0.8, (B, Nq, 1)).astype(np.float32)
    delta = rng.standard_normal((B, Nq, 2)).astype(np.float32) * 0.1
    g = rng.standard_normal((B, pdvc.cfg.max_eseq_length + 1)).astype(
        np.float32)
    head = pdvc.count_head[0]
    w = to_numpy(head.weight.detach())
    b = to_numpy(head.bias.detach())
    x = torch.tensor(hs, requires_grad=True)
    _, count, _ = pdvc.head_outputs(0, x, torch.tensor(ref),
                                    torch.tensor(delta), train_path=True)
    (count * torch.tensor(g)).sum().backward()
    want = jax.grad(lambda h: ((jnp.max(h, axis=1) @ w.T + b) * g).sum())(
        jnp.asarray(hs))
    np.testing.assert_allclose(to_numpy(x.grad), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    assert float(np.abs(np.asarray(want)[:, 4] - np.asarray(want)[:, 7])
                 .max()) == 0.0
