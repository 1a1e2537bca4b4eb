"""Port parity of the stepwise caption path (scheduled sampling,
``--dsa_scan_fuse 0``, ``--dsa_greedy_fuse 0``, ``--dsa_lstm_fuse 1``):
the LSTM-DSA head's stepwise teacher forcing and greedy decode against the
JAX head with the same weights, the port's stepwise paths against its fused
ones, the scheduled-sampling token choice against the JAX formula, and the
train forward and ``new_train`` with scheduled sampling on.

On the CPU the head's word steps run the plain table-form versions of the
kernels K7/K8 (``lstm_fuse`` off) and K9/K10 (on), with the table
``VW = value . Wc`` built once per forward pass by the plain table GEMM;
the JAX head runs its jnp oracle (``att_impl='ref'``).  Tolerances:
log-probabilities rtol/atol 1e-5 and each weight gradient within a
relative L2 error of 1e-4 plus 1e-6 absolute (f32; K recurrent steps
summed in another order; the floor is for alpha_net's bias, whose
gradient is zero in exact arithmetic); greedy tokens equal (the seeds'
top-2 logit margins are far from ties) and their log-probabilities within
1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import (caption_head_state_dict, tiny_opt,  # noqa: I100
                        to_numpy, to_torch, train_batch)

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxHead
from dvc_tpu_torch.models import make_fusion_model
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.ops import dsa_greedy_scan_ref, dsa_teacher_scan_ref
from dvc_tpu_torch.ops.dsa_step import (lstm_step_table_ref,
                                        sample_attend_table_ref)
from dvc_tpu_torch.ops.dsa_tables import table_gemm_ref

CFG = dict(vocab_size=23, input_encoding_size=12, rnn_size=16, num_layers=1,
           drop_prob=0.0, max_caption_len=7, hidden_dim=16, att_hid_size=20,
           cap_nheads=2, cap_dec_n_points=3, cap_num_feature_levels=2)
SHAPES = (12, 6)
B, PQ = 2, 3


def head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    L, d = len(SHAPES), CFG['hidden_dim']
    return (rng.standard_normal((B, PQ, d)).astype(np.float32),
            rng.uniform(0.2, 0.8, (B, PQ, L)).astype(np.float32),
            rng.uniform(0.05, 0.2, (B, PQ, L)).astype(np.float32),
            rng.standard_normal((B, sum(SHAPES), d)).astype(np.float32),
            rng.uniform(size=(B, sum(SHAPES))) < 0.1)


def seq_of(seed, L=7):
    return np.random.default_rng(seed).integers(
        0, CFG['vocab_size'] + 1, (B * PQ, L)).astype(np.int32)


@pytest.fixture(scope='module')
def weights():
    """Flax head params with the sampling-offset kernel moved off zero (the
    init puts every point on a tap boundary)."""
    inputs = head_inputs()
    params = JaxHead(JaxHeadConfig(**CFG), att_impl='ref').init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]), SHAPES,
        jnp.asarray(inputs[4]), jnp.asarray(seq_of(1)))['params']
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(2)
    w = params['dsa_sampling_offsets_w']
    params['dsa_sampling_offsets_w'] = (
        rng.standard_normal(w.shape) * 0.05).astype(np.float32)
    return params


def port_head(params, **flags):
    head = DSACaptionHead(CaptionHeadConfig(**CFG, **flags))
    head.load_state_dict({k: to_torch(v) for k, v in
                          caption_head_state_dict(params).items()},
                         strict=True)
    return head


def _loss_weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_stepwise_teacher_forcing_matches_jax(weights, lstm_fuse):
    """scan_fuse off, ss_prob 0 against the JAX head's stepwise branch with
    ss_enabled=True, ss_prob=0: log-probabilities and weight gradients."""
    inputs, seq = head_inputs(3), seq_of(4)
    jhead = JaxHead(JaxHeadConfig(**CFG), att_impl='ref', scan_fuse=False,
                    lstm_fuse=lstm_fuse)
    jin = [jnp.asarray(a) for a in inputs]
    wts = _loss_weights((B * PQ, seq.shape[1] - 1, CFG['vocab_size'] + 1))

    def loss(p):
        lp = jhead.apply({'params': p}, *jin[:4], SHAPES, jin[4],
                         jnp.asarray(seq), ss_prob=0.0, deterministic=True,
                         ss_enabled=True)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(weights)
    head = port_head(weights, scan_fuse=False, lstm_fuse=lstm_fuse)
    calls = (sample_attend_table_ref.calls, lstm_step_table_ref.calls,
             table_gemm_ref.calls, dsa_teacher_scan_ref.calls)
    tin = [to_torch(a) for a in inputs]
    lp = head.teacher_forcing(*tin[:4], SHAPES, tin[4], to_torch(seq))
    (lp * to_torch(wts)).sum().backward()
    K = seq.shape[1] - 1
    # K plain steps on one table for the K steps, under either flag
    assert (sample_attend_table_ref.calls, lstm_step_table_ref.calls,
            table_gemm_ref.calls, dsa_teacher_scan_ref.calls) == (
        calls[0] + (0 if lstm_fuse else K), calls[1] + (K if lstm_fuse else 0),
        calls[2] + 1, calls[3])
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_g = caption_head_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    for name, p in head.named_parameters():
        err = np.linalg.norm(to_numpy(p.grad) - want_g[name])
        assert err <= 1e-4 * np.linalg.norm(want_g[name]) + 1e-6, name


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_stepwise_greedy_matches_jax(weights, lstm_fuse):
    """greedy_fuse off against the JAX head's ``_greedy_sample``."""
    inputs = head_inputs(5)
    jhead = JaxHead(JaxHeadConfig(**CFG), att_impl='ref', greedy_fuse=False,
                    lstm_fuse=lstm_fuse)
    want_seq, want_lp = jhead.apply(
        {'params': weights}, *map(jnp.asarray, inputs[:4]), SHAPES,
        jnp.asarray(inputs[4]), mode='sample')
    head = port_head(weights, greedy_fuse=False, lstm_fuse=lstm_fuse)
    calls = (dsa_greedy_scan_ref.calls, sample_attend_table_ref.calls,
             lstm_step_table_ref.calls, table_gemm_ref.calls)
    with torch.no_grad():
        seq, lp = head(*map(to_torch, inputs[:4]), SHAPES,
                       to_torch(inputs[4]))
    K = CFG['max_caption_len']
    assert (dsa_greedy_scan_ref.calls, sample_attend_table_ref.calls,
            lstm_step_table_ref.calls, table_gemm_ref.calls) == (
        calls[0], calls[1] + (0 if lstm_fuse else K),
        calls[2] + (K if lstm_fuse else 0), calls[3] + 1)
    np.testing.assert_array_equal(to_numpy(seq), np.asarray(want_seq))
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want_lp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_stepwise_matches_fused_on_the_same_weights(weights, lstm_fuse):
    """The port's stepwise teacher forcing and greedy decode against its
    fused scan and fused greedy decode."""
    inputs, seq = [to_torch(a) for a in head_inputs(6)], to_torch(seq_of(7))
    fused = port_head(weights)
    step = port_head(weights, scan_fuse=False, greedy_fuse=False,
                     lstm_fuse=lstm_fuse)
    outs = {}
    for name, head in (('fused', fused), ('step', step)):
        lp = head.teacher_forcing(*inputs[:4], SHAPES, inputs[4], seq)
        lp.sum().backward()
        with torch.no_grad():
            tok, tlp = head(*inputs[:4], SHAPES, inputs[4])
        outs[name] = (lp.detach(), {n: p.grad for n, p in
                                    head.named_parameters()}, tok, tlp)
    (lp_f, g_f, tok_f, tlp_f), (lp_s, g_s, tok_s, tlp_s) = \
        outs['fused'], outs['step']
    torch.testing.assert_close(lp_s, lp_f, rtol=1e-5, atol=1e-6)
    for n in g_f:
        torch.testing.assert_close(g_s[n], g_f[n], rtol=1e-4, atol=1e-6,
                                   msg=n)
    assert torch.equal(tok_s, tok_f)
    torch.testing.assert_close(tlp_s, tlp_f, rtol=1e-5, atol=1e-6)


def test_scheduled_sampling_token_choice_matches_jax_formula():
    """The JAX head's choice at step i (``_teacher_forcing``'s body):
    use_sample = (u < ss_prob) & (i >= 1), sampled = categorical(r_c,
    prev_lp).  ``jax.random.categorical`` is the argmax of logits plus
    Gumbel noise drawn from the same key, so the port, fed the same u and
    noise, picks the same tokens."""
    head = DSACaptionHead(CaptionHeadConfig(**CFG))
    n, V1, ss_prob = 64, CFG['vocab_size'] + 1, 0.4
    rng = np.random.default_rng(8)
    prev_lp = jax.nn.log_softmax(jnp.asarray(
        rng.standard_normal((n, V1)) * 3, jnp.float32))
    tok = jnp.asarray(rng.integers(0, V1, n), jnp.int32)
    base = jax.random.PRNGKey(9)
    for i in (1, 2, 5):
        r_b, r_c = jax.random.split(jax.random.fold_in(base, i))
        u = jax.random.uniform(r_b, (n,))
        want = jnp.where((u < ss_prob) & (i >= 1),
                         jax.random.categorical(r_c, prev_lp, axis=-1), tok)
        gumbel = jax.random.gumbel(r_c, prev_lp.shape)
        got = head.scheduled_tokens(to_torch(prev_lp), to_torch(tok),
                                    to_torch(u), to_torch(gumbel), ss_prob)
        np.testing.assert_array_equal(to_numpy(got), np.asarray(want))
        assert 0 < int((to_numpy(got) != np.asarray(tok)).sum()) < n


def test_scheduled_sampling_branch(weights):
    """ss_prob > 0 with uniforms that never sample equals the ss_prob = 0
    stepwise path (step-by-step log-softmax against the batched one); with
    uniforms that always sample, step i >= 1 is fed argmax(lp + noise) of
    the previous step, and ``fed_samples`` counts those tokens."""
    inputs, seq = [to_torch(a) for a in head_inputs(10)], seq_of(11)
    K, n, V1 = seq.shape[1] - 1, B * PQ, CFG['vocab_size'] + 1
    head = port_head(weights, scan_fuse=False)
    args = (*inputs[:4], SHAPES, inputs[4])
    rng = np.random.default_rng(12)
    gumbel = to_torch(rng.gumbel(size=(K, n, V1)).astype(np.float32))
    DSACaptionHead.fed_samples.clear()
    with torch.no_grad():
        plain = head.teacher_forcing(*args, to_torch(seq))
        never = head.teacher_forcing(*args, to_torch(seq), ss_prob=0.5,
                                     noise=(torch.ones(K, n), gumbel))
        assert DSACaptionHead.fed_sample_count() == 0
        always = head.teacher_forcing(*args, to_torch(seq), ss_prob=0.5,
                                      noise=(torch.zeros(K, n), gumbel))
    torch.testing.assert_close(never, plain, rtol=1e-6, atol=1e-6)
    assert DSACaptionHead.fed_sample_count() == (K - 1) * n
    # replay: feed the tokens the sampled stream chose as gt tokens
    fed = seq.copy()
    fed[:, 1:K] = to_numpy(torch.argmax(always[:, :-1] + gumbel[1:].transpose(
        0, 1), -1))
    with torch.no_grad():
        replay = head.teacher_forcing(*args, to_torch(fed))
    torch.testing.assert_close(always, replay, rtol=1e-6, atol=1e-6)


def test_scheduled_sampling_without_a_generator(weights):
    """No generator means no dropout (drop_prob 0.5 here) and draws from a
    fixed seed: two calls agree, and at an ss_prob that samples no token the
    result is the deterministic ss_prob = 0 path's."""
    inputs, seq = [to_torch(a) for a in head_inputs(14)], to_torch(seq_of(15))
    head = DSACaptionHead(CaptionHeadConfig(**{**CFG, 'drop_prob': 0.5},
                                            scan_fuse=False))
    head.load_state_dict(port_head(weights).state_dict())
    args = (*inputs[:4], SHAPES, inputs[4], seq)
    DSACaptionHead.fed_samples.clear()
    with torch.no_grad():
        a = head.teacher_forcing(*args, ss_prob=0.5)
        b = head.teacher_forcing(*args, ss_prob=0.5)
        fed = DSACaptionHead.fed_sample_count()
        rare = head.teacher_forcing(*args, ss_prob=1e-9)
        plain = head.teacher_forcing(*args)
    assert torch.equal(a, b) and fed > 0
    assert DSACaptionHead.fed_sample_count() == fed
    torch.testing.assert_close(rare, plain, rtol=1e-6, atol=1e-6)


def test_train_forward_with_scheduled_sampling():
    """forward_train at ss_prob > 0 on a tiny model: finite losses and
    gradients, sampled tokens fed, and the draws reproduced by the seed."""
    opt = tiny_opt(drop_prob=0.0, transformer_dropout_prob=0.0)
    model = make_fusion_model(opt, device='cpu').train()
    batch = {k: to_torch(v) for k, v in train_batch(13).items()}

    def run(seed):
        model.zero_grad()
        DSACaptionHead.fed_samples.clear()
        _, losses = model.forward_train(
            batch, torch.Generator().manual_seed(seed), ss_prob=0.5)
        losses['loss_caption'].backward()
        return losses, DSACaptionHead.fed_sample_count()

    losses, fed = run(0)
    assert all(torch.isfinite(v).all() for v in losses.values())
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    assert grads and all(torch.isfinite(g).all() for g in grads)
    assert fed > 0
    again, fed2 = run(0)
    assert fed2 == fed
    assert float(again['loss_caption'].detach()) == \
        float(losses['loss_caption'].detach())


@pytest.mark.heavy
def test_new_train_with_scheduled_sampling(tmp_path):
    """``new_train --scheduled_sampling_start 0 --epoch 2 --debug`` on the
    CPU: epoch 0 at ss_prob 0 (the fused scan), epoch 1 at basic_ss_prob
    (the stepwise path), finite losses."""
    from test_torch_train import REPO, _synthetic_recipe

    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.train import ss_prob_for_epoch
    from dvc_tpu_torch.utils.config import parse_opts
    recipe = _synthetic_recipe(tmp_path, n_videos=4)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu',
                      '--epoch', '2', '--scheduled_sampling_start', '0',
                      '--basic_ss_prob', '0.25'], root=REPO)
    opt.epoch = 2               # the recipe file's epoch: 1 overlays the flag
    assert [ss_prob_for_epoch(opt, e) for e in (0, 1)] == [0.0, 0.25]
    calls = (dsa_teacher_scan_ref.calls, sample_attend_table_ref.calls)
    DSACaptionHead.fed_samples.clear()
    _, losses = train_main(opt)
    assert all(np.isfinite(v) for v in losses.values())
    assert dsa_teacher_scan_ref.calls > calls[0]      # epoch 0: fused scan
    assert sample_attend_table_ref.calls > calls[1]   # epoch 1: stepwise
    assert DSACaptionHead.fed_sample_count() > 0


def test_flags_reach_the_head():
    """--dsa_scan_fuse, --dsa_greedy_fuse and --dsa_lstm_fuse fill the
    head's config, as the JAX PDVCConfig passes them to its head."""
    from dvc_tpu_torch.models.pdvc import PDVCConfig
    cfg = PDVCConfig.from_opt(tiny_opt()).caption
    assert (cfg.scan_fuse, cfg.greedy_fuse, cfg.lstm_fuse) == \
        (True, True, False)
    cfg = PDVCConfig.from_opt(tiny_opt(dsa_scan_fuse=0, dsa_greedy_fuse=0,
                                       dsa_lstm_fuse=1)).caption
    assert (cfg.scan_fuse, cfg.greedy_fuse, cfg.lstm_fuse) == \
        (False, False, True)
    assert dataclasses.replace(cfg, lstm_fuse=False) != cfg
