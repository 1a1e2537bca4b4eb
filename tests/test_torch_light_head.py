"""Port parity of the 'light' caption head (``LightCaptionHead``, an LSTM
over [token embedding ; query feature]) against the JAX head on the same
weights, at num_layers 1 and 2: teacher-forced log-probabilities and their
weight gradients, with and without scheduled sampling (the port fed the
JAX head's uniforms and Gumbel noise), the greedy decode, and tokens
sampled at a temperature teacher-forced back through the JAX head.

Both heads run plain dense ops (JAX a ``lax.scan``, no Pallas kernel).
Tolerances: log-probabilities rtol/atol 1e-5 and each weight gradient
within a relative L2 error of 1e-4 plus 1e-6 absolute (f32, K recurrent
steps summed in another order); greedy tokens equal (the seeds' top-2
logit margins are far from ties) and their log-probabilities within 1e-5;
sampled tokens' log-probabilities within 1e-5 of JAX teacher forcing up to
each caption's first EOS.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import caption_head_state_dict, to_numpy, to_torch  # noqa: I100

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import LightCaptionHead as JaxLightHead
from dvc_tpu_torch.models import LightCaptionHead
from dvc_tpu_torch.models.caption_heads import CaptionHeadConfig

CFG = dict(vocab_size=23, input_encoding_size=12, rnn_size=16,
           drop_prob=0.0, max_caption_len=7, hidden_dim=20, att_hid_size=0)
N = 6


def feats_of(seed):
    return np.random.default_rng(seed).standard_normal(
        (N, CFG['hidden_dim'])).astype(np.float32)


def seq_of(seed, L=7):
    return np.random.default_rng(seed).integers(
        0, CFG['vocab_size'] + 1, (N, L)).astype(np.int32)


@pytest.fixture(scope='module', params=[1, 2])
def heads(request):
    """(flax head, its params, the port's head on them) at num_layers 1
    and 2."""
    layers = request.param
    jhead = JaxLightHead(JaxHeadConfig(**CFG, num_layers=layers))
    params = jax.tree_util.tree_map(np.array, jhead.init(
        jax.random.PRNGKey(layers), jnp.asarray(feats_of(0)),
        jnp.asarray(seq_of(1)))['params'])
    head = LightCaptionHead(CaptionHeadConfig(**CFG, num_layers=layers))
    head.load_state_dict({k: to_torch(v) for k, v in
                          caption_head_state_dict(params).items()},
                         strict=True)
    assert len(head.core.rnn.layers()) == layers
    return jhead, params, head


def _loss_weights(shape):
    return np.cos(np.arange(np.prod(shape), dtype=np.float32)).reshape(shape)


def jax_ss_noise(n, K, V1):
    """The uniforms and Gumbel noise of the JAX head's scheduled-sampling
    body when deterministic (base key PRNGKey(0)), step by step."""
    us, gs = [], []
    for i in range(K):
        r_b, r_c = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(0), i))
        us.append(np.asarray(jax.random.uniform(r_b, (n,))))
        gs.append(np.asarray(jax.random.gumbel(r_c, (n, V1))))
    return to_torch(np.stack(us)), to_torch(np.stack(gs))


@pytest.mark.parametrize('ss_prob', [0.0, 0.5])
def test_teacher_forcing_and_gradients_match_jax(heads, ss_prob):
    jhead, params, head = heads
    feats, seq = feats_of(2), seq_of(3)
    K, V1 = seq.shape[1] - 1, CFG['vocab_size'] + 1
    wts = _loss_weights((N, K, V1))

    def loss(p):
        lp = jhead.apply({'params': p}, jnp.asarray(feats), jnp.asarray(seq),
                         ss_prob=ss_prob, deterministic=True,
                         ss_enabled=ss_prob > 0)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    noise = jax_ss_noise(N, K, V1) if ss_prob else None
    head.zero_grad()
    lp = head.teacher_forcing(to_torch(feats), to_torch(seq),
                              ss_prob=ss_prob, noise=noise)
    (lp * to_torch(wts)).sum().backward()
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_g = caption_head_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    assert sorted(want_g) == sorted(n for n, _ in head.named_parameters())
    for name, p in head.named_parameters():
        err = np.linalg.norm(to_numpy(p.grad) - want_g[name])
        assert err <= 1e-4 * np.linalg.norm(want_g[name]) + 1e-6, name


def test_greedy_decode_matches_jax(heads):
    jhead, params, head = heads
    feats = feats_of(4)
    want_seq, want_lp = jhead.apply({'params': params}, jnp.asarray(feats),
                                    None, mode='sample')
    with torch.no_grad():
        seq, lp = head(to_torch(feats))
    assert seq.shape == (N, CFG['max_caption_len'])
    np.testing.assert_array_equal(to_numpy(seq), np.asarray(want_seq))
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want_lp), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('temperature', [1.0, 0.5])
def test_sampled_tokens_teacher_forced_back_through_jax(heads, temperature):
    """--caption_sample_max 0: the port's draws (its generator) fed back
    through the JAX head's teacher forcing give the log-probabilities the
    port reported, up to each caption's first EOS; a second generator of
    the same seed repeats the draws."""
    jhead, params, head = heads
    feats = feats_of(5)
    with torch.no_grad():
        seq, lp = head(to_torch(feats), sample_max=False,
                       temperature=temperature,
                       gen=torch.Generator().manual_seed(7))
        again, _ = head(to_torch(feats), sample_max=False,
                        temperature=temperature,
                        gen=torch.Generator().manual_seed(7))
    assert torch.equal(seq, again)
    seq = to_numpy(seq)
    tokens = np.concatenate([np.zeros((N, 1), np.int32), seq], 1)
    want = np.asarray(jhead.apply({'params': params}, jnp.asarray(feats),
                                  jnp.asarray(tokens), deterministic=True))
    picked = np.take_along_axis(want, seq[..., None], -1)[..., 0]
    # a step counts up to and including the first EOS (token 0)
    live = np.cumprod(np.concatenate([np.ones((N, 1)), seq[:, :-1] > 0], 1),
                      1).astype(bool)
    np.testing.assert_allclose(to_numpy(lp)[live], picked[live], rtol=1e-5,
                               atol=1e-5)
    assert (seq > 0).sum() > 0
