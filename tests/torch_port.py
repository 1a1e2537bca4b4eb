"""Shared helpers of the ``dvc_tpu_torch`` parity tests (tests/test_torch_*).

Importing this module caps PyTorch's intra-op threads: the suite runs under
several xdist workers, and each torch process would otherwise start one
thread per core.
"""
import numpy as np
import torch

torch.set_num_threads(2)


def to_torch(x):
    """numpy / JAX array -> CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def to_numpy(x):
    return x.detach().cpu().numpy()


def tiny_opt(**kw):
    """tests/test_model.py::tiny_opt with the LSTM-DSA caption head and a
    4-head fusion block."""
    from dvc_tpu.utils.config import load_config
    d = dict(hidden_dim=64, nheads=4, enc_layers=2, dec_layers=2,
             transformer_ff_dim=64, num_queries=10, vocab_size=20,
             input_encoding_size=32, rnn_size=64, att_hid_size=32,
             max_caption_len=8, feature_dim=16, frame_embedding_num=24,
             num_feature_levels=4, with_box_refine=True,
             caption_decoder_type='standard', max_eseq_length=10,
             cap_num_feature_levels=4, cap_nheads=2, msda_impl='ref',
             fusion_heads=4)
    d.update(kw)
    return load_config(**d)


def fusion_batch(seed, B=2, T=24, C=16, G=3, Lc=8):
    """Eval batch of the JAX FusionPDVC (numpy); video 1 has 19 valid
    frames of 24."""
    rng = np.random.default_rng(seed)
    mask = np.ones((B, T), bool)
    mask[1, 19:] = False
    return {
        'video_tensor': rng.standard_normal((B, T, C)).astype(np.float32),
        'sound_tensor': rng.standard_normal((B, T, C)).astype(np.float32),
        'video_mask': mask,
        'video_length': np.array([[T, 30.0, G], [19, 47.5, G]],
                                 np.float32)[:B],
        'gt_boxes': np.zeros((B, G, 2), np.float32),
        'gt_boxes_mask': np.zeros((B, G), bool),
        'gt_labels': np.zeros((B, G), np.int32),
        'cap_tensor': np.zeros((B, G, Lc), np.int32),
        'cap_mask': np.zeros((B, G, Lc), bool),
    }


def jax_fusion_params(opt, batch, seed=0):
    """Flax FusionPDVC params (numpy leaves) of ``opt``, initialised on
    ``batch`` under jit (an eager init of the whole eval forward is ~5x
    slower on the CPU)."""
    import jax
    import jax.numpy as jnp
    from dvc_tpu.models.fusion import make_fusion_model
    model = make_fusion_model(opt)
    params = jax.jit(lambda r, b: model.init(r, b, eval_mode=True))(
        jax.random.PRNGKey(seed), {k: jnp.asarray(v) for k, v in batch.items()})
    return jax.tree_util.tree_map(np.asarray, params)


def train_batch(seed, B=2, T=24, C=16, G=3, Lc=8, vocab=20):
    """fusion_batch with gt events: video 0 has 3 captioned events, video 1
    has 2 (its third gt slot is padding); captions of 1-6 words."""
    b = fusion_batch(seed, B, T, C, G, Lc)
    rng = np.random.default_rng(seed + 100)
    counts = [min(3, G), min(2, G)][:B]
    for i, n in enumerate(counts):
        centers = np.sort(rng.uniform(0.15, 0.85, n))
        b['gt_boxes'][i, :n] = np.stack(
            [centers, rng.uniform(0.05, 0.3, n)], -1)
        b['gt_boxes_mask'][i, :n] = True
        for j in range(n):
            L = int(rng.integers(3, Lc + 1))
            b['cap_tensor'][i, j, 1:L - 1] = rng.integers(1, vocab + 1, L - 2)
            b['cap_mask'][i, j, :L] = True
    b['video_length'][:, 2] = counts
    return b


def caption_head_state_dict(head):
    """Flax DSACaptionHead params (one head's subtree) -> the state_dict of
    the port's ``DSACaptionHead`` (numpy), as ``from_jax_params`` maps a
    whole model's heads."""
    sd = {'embed.weight': np.asarray(head['embed']),
          'logit.weight': np.asarray(head['logit_w']).T,
          'logit.bias': np.asarray(head['logit_b'])}
    for k, v in head.items():
        if k.startswith('rnn_w_'):          # rnn_w_ih_l0 -> weight_ih_l0
            sd[f'core.rnn.weight_{k[len("rnn_w_"):]}'] = np.asarray(v).T
    dsa = 'core.deformable_att'
    sd[f'{dsa}.sampling_offsets.weight'] = np.asarray(
        head['dsa_sampling_offsets_w']).T
    sd[f'{dsa}.sampling_offsets.bias'] = np.asarray(
        head['dsa_sampling_offsets_b'])
    sd[f'{dsa}.value_proj.weight'] = np.asarray(head['dsa_value_w']).T
    sd[f'{dsa}.value_proj.bias'] = np.asarray(head['dsa_value_b'])
    for name in ('ctx2att', 'h2att', 'alpha_net'):
        sd[f'core.{name}.weight'] = np.asarray(head[f'{name}_w']).T
        sd[f'core.{name}.bias'] = np.asarray(head[f'{name}_b'])
    return sd
