"""Port parity of the whole serving slice: FusionPDVC eval forward,
``postprocess`` and ``DenseCaptioner`` of ``dvc_tpu_torch`` against the JAX
package, on the same weights (tiny_opt scale, LSTM-DSA caption head).

Tolerances: boxes, scores and logits rtol/atol 2e-4 (the repo's earlier
torch-parity tolerance: f32 through 2+2 transformer layers and the fusion
blocks), captions token for token, caption log-probs 1e-4.

The serving comparison uses one run folder written the way the JAX
trainer writes it (``save_checkpoint`` with a real optax ``opt_state`` and a
JAX-array step, plus ``info.json``); a subprocess shows that the port
serves that folder without importing jax, flax, optax or the ``dvc_tpu``
package.
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_port import (fusion_batch, jax_fusion_params, tiny_opt,  # noqa: I100
                        to_numpy, to_torch)

from dvc_tpu.models import postprocess as jax_postprocess
from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.serve import DenseCaptioner as JaxDenseCaptioner
from dvc_tpu.train.trainer import save_checkpoint, save_info_json
from dvc_tpu_torch.models import (from_jax_params, make_fusion_model,
                                  postprocess)
from dvc_tpu_torch.serve import DenseCaptioner

pytestmark = pytest.mark.heavy

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    """(opt, params, run folder) of a tiny FusionPDVC."""
    root = tmp_path_factory.mktemp('run')
    vocab = root / 'vocab.json'
    words = [f'w{i}' for i in range(1, 21)]
    vocab.write_text(json.dumps({
        'word_to_ix': {w: i for i, w in enumerate(words, 1)},
        'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}}))
    opt = tiny_opt(dict_file=str(vocab))
    params = jax_fusion_params(opt, fusion_batch(0))
    state = {'params': params,
             'opt_state': optax.adamw(1e-4).init(params),
             'step': jnp.asarray(3, jnp.int32)}
    save_checkpoint(str(root), 'best', state, epoch=1)
    save_info_json(str(root), {'best': {'opt': opt.to_dict()}})
    return opt, params, str(root)


def test_eval_forward_and_postprocess(run):
    opt, params, _ = run
    batch = fusion_batch(1)
    durations = batch['video_length'][:, 1]
    jmodel = jax_make_fusion(opt)
    out, _ = jax.jit(lambda p, b: jmodel.apply(p, b, eval_mode=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    want_post = jax_postprocess(out, jnp.asarray(durations))

    model = make_fusion_model(opt, device='cpu')
    model.load_state_dict({k: to_torch(v) for k, v in
                           from_jax_params(params).items()}, strict=True)
    tbatch = {k: to_torch(batch[k]) for k in
              ('video_tensor', 'sound_tensor', 'video_mask', 'video_length')}
    with torch.inference_mode():
        got = model(tbatch)
        post = postprocess(got, to_torch(durations))

    for k in ('pred_logits', 'pred_count', 'pred_boxes'):
        np.testing.assert_allclose(to_numpy(got[k]), np.asarray(out[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(to_numpy(got['seq']), np.asarray(out['seq']))
    np.testing.assert_allclose(to_numpy(got['cap_prob_eval']),
                               np.asarray(out['cap_prob_eval']),
                               rtol=1e-4, atol=1e-4)
    assert (to_numpy(got['seq']) > 0).any()     # captions are not all empty
    for k in ('query_id', 'labels', 'pred_count', 'seq'):
        np.testing.assert_array_equal(to_numpy(post[k]),
                                      np.asarray(want_post[k]), err_msg=k)
    for k in ('scores', 'boxes', 'caption_scores'):
        np.testing.assert_allclose(to_numpy(post[k]),
                                   np.asarray(want_post[k]), err_msg=k, **TOL)


def _requests():
    rng = np.random.default_rng(5)
    # 30 and 17 frames: both resized to the model's 24
    return ([rng.standard_normal((30, 16)).astype(np.float32),
             rng.standard_normal((17, 16)).astype(np.float32)],
            [61.0, 12.5],
            [rng.standard_normal((30, 16)).astype(np.float32), None])


def _assert_same_events(got, want):
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        assert g['sentence'] == w['sentence']
        assert g['query_id'] == w['query_id']
        assert g['pred_event_count'] == w['pred_event_count']
        np.testing.assert_allclose(g['timestamp'], w['timestamp'], **TOL)
        np.testing.assert_allclose(
            [g['proposal_score'], g['sentence_score']],
            [w['proposal_score'], w['sentence_score']], **TOL)


def test_dense_captioner_matches_jax(run):
    _, _, folder = run
    feats, durs, sounds = _requests()
    jdc, dc = JaxDenseCaptioner(folder), DenseCaptioner(folder, device='cpu')
    for f, d, s in zip(feats, durs, sounds):
        _assert_same_events(dc.caption_features(f, d, sound=s),
                            jdc.caption_features(f, d, sound=s))
    for g, w in zip(dc.caption_batch(feats, durs, top_k=4, sound_list=sounds),
                    jdc.caption_batch(feats, durs, top_k=4,
                                      sound_list=sounds)):
        _assert_same_events(g, w)


_NO_JAX = """
import json, sys
import dvc_tpu_torch, dvc_tpu_torch.models, dvc_tpu_torch.ops
from dvc_tpu_torch.serve import DenseCaptioner, load_checkpoint
folder = sys.argv[1]
ck = load_checkpoint(folder + '/model-best.ckpt')
assert 'visual_sa' in ck['params']['params'], sorted(ck['params'])
events = DenseCaptioner(folder, device='cpu').caption_features(
    [[0.1 * ((i * 7 + j) % 5) for j in range(16)] for i in range(20)], 33.0)
loaded = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'dvc_tpu')
          or m.startswith('dvc_tpu.')]
print(json.dumps({'loaded': loaded, 'n_events': len(events)}))
"""


def test_port_serves_run_folder_without_jax(run):
    _, _, folder = run
    proc = subprocess.run([sys.executable, '-c', _NO_JAX, folder],
                          capture_output=True, text=True, timeout=300,
                          cwd=_REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result['loaded'] == []
    assert result['n_events'] >= 1
