"""Port parity of the LSTM-DSA head beyond the fused kernels' case: two
LSTM layers (the sampling positions and hvec from the top layer's h, the
context into layer 0) and no attention (att_hid_size 0: the mean of the
border-mode taps), against the JAX head's stepwise path on the same
weights: teacher forcing (log-probabilities and weight gradients), the
greedy decode, and the routing, which must reach neither the fused scan
and greedy decode (K4-K6) nor the fused LSTM word step (K9/K10), under
either ``lstm_fuse``.  Also the border-mode tap gather against JAX's
``ms_deform_attn_sample_values`` with its gradients.

The JAX head runs its word-step kernel ``dsa_sample_attend`` in interpret
mode (``att_impl='pallas_interpret'``), as tests/test_torch_dsa_step.py
runs it; the port's word steps run the plain table-form versions of K7/K8
on the CPU.  The offset kernel is moved off the tap boundary first.
Tolerances: log-probabilities rtol/atol 1e-5 and each weight gradient
within a relative L2 error of 1e-4 plus 1e-6 absolute (f32; the floor is
for alpha_net's bias, whose gradient is zero in exact arithmetic); greedy
tokens equal and their log-probabilities within 1e-5; the taps and their
gradients 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import caption_head_state_dict, to_numpy, to_torch  # noqa: I100

from dvc_tpu.models.caption_heads import CaptionHeadConfig as JaxHeadConfig
from dvc_tpu.models.caption_heads import DSACaptionHead as JaxHead
from dvc_tpu.ops import ms_deform_attn_sample_values as jax_sample_values
from dvc_tpu_torch.models.caption_heads import (CaptionHeadConfig,
                                                DSACaptionHead)
from dvc_tpu_torch.ops import (dsa_greedy_scan_ref, dsa_teacher_scan_ref,
                               ms_deform_attn_sample_values)
from dvc_tpu_torch.ops.dsa_step import (lstm_step_table_ref,
                                        sample_attend_table_ref)
from dvc_tpu_torch.ops.dsa_tables import table_gemm_ref

BASE = dict(vocab_size=23, input_encoding_size=12, rnn_size=16,
            drop_prob=0.0, max_caption_len=7, hidden_dim=16, cap_nheads=2,
            cap_dec_n_points=3, cap_num_feature_levels=2)
CORES = {'two_layers': dict(num_layers=2, att_hid_size=20),
         'three_layers': dict(num_layers=3, att_hid_size=20),
         'no_attention': dict(num_layers=1, att_hid_size=0),
         'no_attention_two_layers': dict(num_layers=2, att_hid_size=0)}
SHAPES = (12, 6)
B, PQ = 2, 3


def head_inputs(seed=0):
    rng = np.random.default_rng(seed)
    L, d = len(SHAPES), BASE['hidden_dim']
    return (rng.standard_normal((B, PQ, d)).astype(np.float32),
            rng.uniform(0.2, 0.8, (B, PQ, L)).astype(np.float32),
            rng.uniform(0.05, 0.2, (B, PQ, L)).astype(np.float32),
            rng.standard_normal((B, sum(SHAPES), d)).astype(np.float32),
            rng.uniform(size=(B, sum(SHAPES))) < 0.1)


def seq_of(seed, L=7):
    return np.random.default_rng(seed).integers(
        0, BASE['vocab_size'] + 1, (B * PQ, L)).astype(np.int32)


def calls():
    return (sample_attend_table_ref.calls, lstm_step_table_ref.calls,
            table_gemm_ref.calls, dsa_teacher_scan_ref.calls,
            dsa_greedy_scan_ref.calls)


@pytest.fixture(scope='module', params=sorted(CORES))
def core(request):
    """(name, JAX config, flax params with the offset kernel off the tap
    boundary)."""
    cfg = dict(BASE, **CORES[request.param])
    inputs = head_inputs()
    params = JaxHead(JaxHeadConfig(**cfg), att_impl='ref').init(
        jax.random.PRNGKey(0), *map(jnp.asarray, inputs[:4]), SHAPES,
        jnp.asarray(inputs[4]), jnp.asarray(seq_of(1)))['params']
    params = jax.tree_util.tree_map(np.array, params)
    assert ('h2att_w' in params) == (cfg['att_hid_size'] > 0)
    w = params['dsa_sampling_offsets_w']
    params['dsa_sampling_offsets_w'] = (np.random.default_rng(2).standard_normal(
        w.shape) * 0.05).astype(np.float32)
    return request.param, cfg, params


def port_head(cfg, params, **flags):
    head = DSACaptionHead(CaptionHeadConfig(**cfg, **flags))
    head.load_state_dict({k: to_torch(v) for k, v in
                          caption_head_state_dict(params).items()},
                         strict=True)
    return head


def expected_calls(cfg, before, K):
    """The plain versions the port must run for K word steps: K7's (the
    word step alone) and one table where there is attention; never K4-K6
    and never K9/K10 (the fused LSTM step) at these configurations."""
    att = cfg['att_hid_size'] > 0
    return (before[0] + (K if att else 0), before[1],
            before[2] + (1 if att else 0), before[3], before[4])


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_teacher_forcing_matches_jax_stepwise(core, lstm_fuse):
    """The fused-scan flag on (the default): these cores still go
    stepwise, as the JAX head routes them."""
    name, cfg, params = core
    inputs, seq = head_inputs(3), seq_of(4)
    jhead = JaxHead(JaxHeadConfig(**cfg), att_impl='pallas_interpret',
                    lstm_fuse=lstm_fuse)
    jin = [jnp.asarray(a) for a in inputs]
    K, V1 = seq.shape[1] - 1, cfg['vocab_size'] + 1
    wts = np.cos(np.arange(B * PQ * K * V1, dtype=np.float32)).reshape(
        B * PQ, K, V1)

    def loss(p):
        lp = jhead.apply({'params': p}, *jin[:4], SHAPES, jin[4],
                         jnp.asarray(seq), deterministic=True)
        return jnp.sum(lp * wts), lp

    (_, want), jgrads = jax.value_and_grad(loss, has_aux=True)(params)
    head = port_head(cfg, params, lstm_fuse=lstm_fuse)
    before = calls()
    tin = [to_torch(a) for a in inputs]
    lp = head.teacher_forcing(*tin[:4], SHAPES, tin[4], to_torch(seq))
    (lp * to_torch(wts)).sum().backward()
    assert calls() == expected_calls(cfg, before, K), name
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    want_g = caption_head_state_dict(jax.tree_util.tree_map(np.asarray,
                                                            jgrads))
    assert sorted(want_g) == sorted(n for n, _ in head.named_parameters())
    for n, p in head.named_parameters():
        err = np.linalg.norm(to_numpy(p.grad) - want_g[n])
        assert err <= 1e-4 * np.linalg.norm(want_g[n]) + 1e-6, n


@pytest.mark.parametrize('lstm_fuse', [False, True])
def test_greedy_decode_matches_jax_stepwise(core, lstm_fuse):
    """The fused greedy flag on (the default): these cores decode
    stepwise."""
    name, cfg, params = core
    inputs = head_inputs(5)
    jhead = JaxHead(JaxHeadConfig(**cfg), att_impl='pallas_interpret',
                    lstm_fuse=lstm_fuse)
    want_seq, want_lp = jhead.apply(
        {'params': params}, *map(jnp.asarray, inputs[:4]), SHAPES,
        jnp.asarray(inputs[4]), mode='sample')
    head = port_head(cfg, params, lstm_fuse=lstm_fuse)
    before = calls()
    with torch.no_grad():
        seq, lp = head(*map(to_torch, inputs[:4]), SHAPES,
                       to_torch(inputs[4]))
    assert calls() == expected_calls(cfg, before, cfg['max_caption_len']), \
        name
    np.testing.assert_array_equal(to_numpy(seq), np.asarray(want_seq))
    np.testing.assert_allclose(to_numpy(lp), np.asarray(want_lp), rtol=1e-5,
                               atol=1e-5)


def test_border_taps_match_jax():
    """The attention-free core's tap gather: border mode (locations
    outside [0, 1] clamp to the edge rows), values and gradients."""
    rng = np.random.default_rng(9)
    value = rng.standard_normal((2, sum(SHAPES), 2, 4)).astype(np.float32)
    loc = rng.uniform(-0.3, 1.3, (2, 5, 2, 2, 3)).astype(np.float32)
    cot = rng.standard_normal((2, 5, 2, 2, 3, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda v, s: jax_sample_values(v, SHAPES, s,
                                                       'border'),
                        jnp.asarray(value), jnp.asarray(loc))
    want_dv, want_dl = vjp(jnp.asarray(cot))
    v, s = to_torch(value).requires_grad_(), to_torch(loc).requires_grad_()
    got = ms_deform_attn_sample_values(v, SHAPES, s)
    (got * to_torch(cot)).sum().backward()
    for a, b in ((got, want), (v.grad, want_dv), (s.grad, want_dl)):
        np.testing.assert_allclose(to_numpy(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
