"""Temperature sampling (``--caption_sample_max 0``, the JAX head's
``_stochastic_sample``) in the port's LSTM-DSA head, and the bf16 flags,
which run on the fused caption routes and on every stepwise one (the
bf16 word steps; their parity with JAX: ``tests/test_torch_bf16_step.py``).

The sampling decode runs the stepwise word steps (on the CPU the plain
table-form versions of K7, or K9 under ``lstm_fuse``), never the fused
greedy decode.  Its draws differ from JAX's (another generator), so it is
held to the JAX head on what does not depend on the draws: the
log-probability it emits for each token it sampled equals, within 2e-4
relative, the JAX head's teacher-forced log-probability of that token
(stepwise core, ``att_impl='ref'``), up to and including the first EOS
(after it the emitted tokens are masked to 0); the first token's
frequencies over many draws fit softmax(lp / T) (chi-square, fixed seed);
a temperature near 0 gives the greedy decode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from test_torch_stepwise import (B, CFG, PQ, SHAPES, head_inputs,  # noqa: I100
                                 port_head)
from torch_port import fusion_batch, tiny_opt, to_numpy, to_torch, train_batch

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxHead
from dvc_tpu_torch.models import PDVCConfig, make_fusion_model
from dvc_tpu_torch.ops import dsa_greedy_scan_ref
from dvc_tpu_torch.ops.dsa_step import (lstm_step_ref, lstm_step_table_ref,
                                        sample_attend_ref,
                                        sample_attend_table_ref)

K = CFG['max_caption_len']


@pytest.fixture(scope='module')
def weights():
    """Flax head params with the sampling-offset kernel moved off zero and
    a logit projection wide enough that the distributions are not flat."""
    inputs = head_inputs()
    seq = np.zeros((B * PQ, K), np.int32)
    params = JaxHead(JaxHeadConfig(**CFG), att_impl='ref').init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]), SHAPES,
        jnp.asarray(inputs[4]), jnp.asarray(seq))['params']
    params = jax.tree_util.tree_map(np.array, params)
    rng = np.random.default_rng(2)
    w = params['dsa_sampling_offsets_w']
    params['dsa_sampling_offsets_w'] = (
        rng.standard_normal(w.shape) * 0.05).astype(np.float32)
    params['logit_w'] = (params['logit_w'] * 20).astype(np.float32)
    return params


def _valid(seq):
    """(n, K) True up to and including each row's first EOS: where the
    emitted token is the sampled one."""
    before = np.cumprod(seq > 0, axis=1)
    return np.concatenate([np.ones((len(seq), 1), bool), before[:, :-1] > 0],
                          axis=1)


def _sample(head, inputs, temperature, seed=0):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        return head(*map(to_torch, inputs[:4]), SHAPES, to_torch(inputs[4]),
                    sample_max=False, temperature=temperature, gen=gen)


@pytest.mark.parametrize('lstm_fuse', [False, True])
@pytest.mark.parametrize('temperature', [1.0, 0.5])
def test_sampled_logprobs_match_jax_teacher_forcing(weights, lstm_fuse,
                                                    temperature):
    inputs = head_inputs(3)
    head = port_head(weights, lstm_fuse=lstm_fuse)
    calls = (dsa_greedy_scan_ref.calls, sample_attend_table_ref.calls,
             lstm_step_table_ref.calls)
    seq, lp = _sample(head, inputs, temperature)
    # the stepwise word steps, K of them; never the fused greedy decode
    assert (dsa_greedy_scan_ref.calls, sample_attend_table_ref.calls,
            lstm_step_table_ref.calls) == (
        calls[0], calls[1] + (0 if lstm_fuse else K),
        calls[2] + (K if lstm_fuse else 0))
    seq, lp = to_numpy(seq), to_numpy(lp)
    assert seq.shape == lp.shape == (B * PQ, K)
    assert seq.min() >= 0 and seq.max() <= CFG['vocab_size']
    assert np.all(np.isfinite(lp)) and np.all(lp <= 0)
    valid = _valid(seq)
    tf = np.concatenate([np.zeros((len(seq), 1), np.int32), seq], 1)
    jhead = JaxHead(JaxHeadConfig(**CFG), att_impl='ref', scan_fuse=False,
                    lstm_fuse=lstm_fuse)
    want = jhead.apply({'params': weights}, *map(jnp.asarray, inputs[:4]),
                       SHAPES, jnp.asarray(inputs[4]), jnp.asarray(tf),
                       ss_prob=0.0, deterministic=True, ss_enabled=True)
    want = np.take_along_axis(np.asarray(want), seq[..., None], -1)[..., 0]
    np.testing.assert_allclose(lp[valid], want[valid], rtol=2e-4, atol=1e-6)
    # and the port's own teacher forcing (its CPU plain path) of the same
    # tokens, which chip_smoke.py holds the card's draws to
    with torch.no_grad():
        own = port_head(weights).teacher_forcing(
            *map(to_torch, inputs[:4]), SHAPES, to_torch(inputs[4]),
            to_torch(tf))
    own = np.take_along_axis(to_numpy(own), seq[..., None], -1)[..., 0]
    np.testing.assert_allclose(lp[valid], own[valid], rtol=2e-4, atol=1e-6)
    # the same generator seed gives the same decode
    again, _ = _sample(head, inputs, temperature)
    assert np.array_equal(to_numpy(again), seq)


@pytest.mark.parametrize('temperature', [1.0, 0.6])
def test_first_token_frequencies_fit_the_tempered_softmax(weights,
                                                          temperature):
    """One query repeated 1,500 times (identical first distributions),
    sampled in 3 calls from one generator: a chi-square test of the first
    tokens against softmax(lp / T)."""
    q, center, scale, memory, mask = head_inputs(4)
    n = 1500
    rep = (q[:1, :1].repeat(n, 1), center[:1, :1].repeat(n, 1),
           scale[:1, :1].repeat(n, 1), memory[:1], mask[:1])
    head = port_head(weights)
    gen = torch.Generator().manual_seed(11)
    firsts = []
    for _ in range(3):
        with torch.no_grad():
            seq, _ = head(*map(to_torch, rep[:4]), SHAPES, to_torch(rep[4]),
                          sample_max=False, temperature=temperature, gen=gen)
        firsts.append(to_numpy(seq)[:, 0])
    firsts = np.concatenate(firsts)
    with torch.no_grad():
        lp0 = head.teacher_forcing(
            *map(to_torch, rep[:4]), SHAPES, to_torch(rep[4]),
            torch.zeros((n, 2), dtype=torch.int64))[0, 0].double()
    p = torch.softmax(lp0 / temperature, -1).numpy()
    counts = np.bincount(firsts, minlength=len(p))
    # bins expected below 5 draws go into one
    big = p * len(firsts) >= 5
    obs = np.append(counts[big], counts[~big].sum())
    exp = np.append(p[big], p[~big].sum()) * len(firsts)
    keep = exp > 0
    _, pvalue = scipy.stats.chisquare(obs[keep], exp[keep])
    assert big.sum() >= 3 and pvalue > 1e-3, (obs, exp, pvalue)


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_a_small_temperature_is_the_greedy_decode(weights, lstm_fuse):
    inputs = head_inputs(5)
    head = port_head(weights, greedy_fuse=False, lstm_fuse=lstm_fuse)
    with torch.no_grad():
        want_seq, want_lp = head(*map(to_torch, inputs[:4]), SHAPES,
                                 to_torch(inputs[4]))
    seq, lp = _sample(head, inputs, 1e-6)
    assert torch.equal(seq, want_seq)
    np.testing.assert_allclose(to_numpy(lp), to_numpy(want_lp), rtol=1e-5,
                               atol=1e-6)


def test_the_model_samples_under_the_flags():
    """caption_sample_max 0 reaches PDVCConfig and the serving forward:
    sampled (not the fused greedy decode) and repeatable from a seed."""
    opt = tiny_opt(caption_sample_max=0, caption_sample_temperature=0.7)
    cfg = PDVCConfig.from_opt(opt)
    assert (cfg.sample_max, cfg.sample_temperature) == (False, 0.7)
    model = make_fusion_model(opt, 'cpu', seed=0)
    greedy = make_fusion_model(tiny_opt(), 'cpu', seed=0)
    batch = {k: to_torch(v) for k, v in fusion_batch(0).items()
             if k.startswith(('video', 'sound'))}
    calls = dsa_greedy_scan_ref.calls
    with torch.no_grad():
        a = model(batch, torch.Generator().manual_seed(3))
        b = model(batch, torch.Generator().manual_seed(3))
        g = greedy(batch)
    assert dsa_greedy_scan_ref.calls == calls + 1          # the greedy only
    assert torch.equal(a['seq'], b['seq'])
    assert torch.equal(a['pred_boxes'], g['pred_boxes'])
    assert not torch.equal(a['seq'], g['seq'])


@pytest.mark.parametrize('flag', ['tpu_compute_dtype', 'fusion_dtype'])
def test_bf16_flags_raise(flag):
    """Each bf16 flag builds a model on the fused routes (the defaults),
    with bf16 where it says; with bf16 compute and a stepwise route
    (--dsa_greedy_fuse 0) the serving forward decodes through the bf16 word
    steps (their plain versions on the CPU), never the fused decode."""
    model = make_fusion_model(tiny_opt(**{flag: 'bfloat16'}), 'cpu')
    assert (model.pdvcModel.cfg.compute_dtype == 'bfloat16') \
        == (flag == 'tpu_compute_dtype')
    assert (model.fusion_dtype == torch.bfloat16) == (flag == 'fusion_dtype')
    assert model.pdvcModel.caption_head[0].cfg.precision \
        == model.pdvcModel.cfg.compute_dtype
    opt = tiny_opt(**{flag: 'bfloat16', 'tpu_compute_dtype': 'bfloat16'},
                   dsa_greedy_fuse=0)
    assert PDVCConfig.from_opt(opt).caption.precision == 'bfloat16'
    out, calls = _bf16_forward('greedy_fuse_0', opt)
    assert calls == (0, opt.max_caption_len, 0)
    assert torch.isfinite(out['cap_prob_eval']).all()


STEPWISE_ROUTES = {'scheduled_sampling': dict(scheduled_sampling_start=0),
                   'scan_fuse_0': dict(dsa_scan_fuse=0),
                   'greedy_fuse_0': dict(dsa_greedy_fuse=0),
                   'lstm_fuse_1': dict(dsa_lstm_fuse=1),
                   'sample_max_0': dict(caption_sample_max=0),
                   'two_layers': dict(num_layers=2)}
# the routes that train stepwise (at ss_prob 0.25 where scheduled sampling
# or the fused LSTM step asks for it); the others decode stepwise
TRAIN_SS = {'scheduled_sampling': 0.25, 'scan_fuse_0': 0.0,
            'lstm_fuse_1': 0.25, 'two_layers': 0.0}


def _bf16_forward(route, opt):
    """One bf16 forward of ``opt``'s tiny FusionPDVC on the CPU: a train
    forward and its backward for the routes of TRAIN_SS, else a serving
    forward.  Returns (outputs, the plain calls of the fused decode, of
    the word step and of the fused word step)."""
    model = make_fusion_model(opt, 'cpu', seed=0)
    counters = (dsa_greedy_scan_ref, sample_attend_ref, lstm_step_ref)
    calls = [c.calls for c in counters]
    gen = torch.Generator().manual_seed(1)
    if route in TRAIN_SS:
        batch = {k: to_torch(v) for k, v in train_batch(13).items()}
        out, losses = model.train().forward_train(batch, gen,
                                                  ss_prob=TRAIN_SS[route])
        losses['loss_caption'].backward()
        grads = [p.grad for p in model.parameters() if p.grad is not None]
        assert grads and all(torch.isfinite(g).all() for g in grads)
        assert all(torch.isfinite(v).all() for v in losses.values())
    else:
        batch = {k: to_torch(v) for k, v in fusion_batch(0).items()
                 if k.startswith(('video', 'sound'))}
        with torch.no_grad():
            out = model(batch, gen)
    return out, tuple(c.calls - n for c, n in zip(counters, calls))


@pytest.mark.parametrize('route', sorted(STEPWISE_ROUTES))
def test_bf16_raises_on_each_stepwise_route(route):
    """Under --tpu_compute_dtype bfloat16 every option that runs the
    stepwise word steps builds and runs one bf16 forward on the CPU (and
    for the train routes its backward): finite losses and gradients, or
    finite caption log-probs, through the plain bf16 word steps (K9-bf16's
    under --dsa_lstm_fuse 1), K of them a pass."""
    over = STEPWISE_ROUTES[route]
    opt = tiny_opt(tpu_compute_dtype='bfloat16', **over)
    assert PDVCConfig.from_opt(opt).caption.precision == 'bfloat16'
    out, (greedy, step, fused) = _bf16_forward(route, opt)
    assert greedy == 0
    if route in TRAIN_SS:
        # teacher forcing runs K - 1 steps (a bucketed length) per layer
        assert (fused if route == 'lstm_fuse_1' else step) > 0
    else:
        assert (step, fused) == (opt.max_caption_len, 0)
        assert torch.isfinite(out['cap_prob_eval']).all()


def test_bf16_head_refuses_the_stepwise_path(weights):
    """A bf16 head asked for a sampled decode directly (not through the
    flags) runs the bf16 word steps: the log-probabilities it emits for its
    tokens equal its own stepwise bf16 teacher forcing of them (the same
    plain bf16 steps) up to each caption's first EOS, and differ from the
    f32 head's."""
    head = port_head(weights, precision='bfloat16')
    inputs = head_inputs(0)
    calls = sample_attend_ref.calls
    seq, lp = _sample(head, inputs, 1.0)
    assert sample_attend_ref.calls == calls + K
    seq, lp = to_numpy(seq), to_numpy(lp)
    valid = _valid(seq)
    tf = np.concatenate([np.zeros((len(seq), 1), np.int32), seq], 1)

    def forced(h):
        with torch.no_grad():
            out = h.teacher_forcing(*map(to_torch, inputs[:4]), SHAPES,
                                    to_torch(inputs[4]), to_torch(tf))
        return np.take_along_axis(to_numpy(out), seq[..., None], -1)[..., 0]

    bf16 = forced(port_head(weights, precision='bfloat16', scan_fuse=False))
    np.testing.assert_allclose(lp[valid], bf16[valid], rtol=1e-6, atol=1e-6)
    f32 = forced(port_head(weights, scan_fuse=False))
    assert not np.allclose(lp[valid], f32[valid], rtol=1e-7, atol=0)


def test_unknown_dtypes_raise():
    for flag in ('tpu_compute_dtype', 'fusion_dtype'):
        with pytest.raises(ValueError, match=flag):
            PDVCConfig.from_opt(tiny_opt(**{flag: 'float16'}))
