"""bf16 training in the port (``--tpu_compute_dtype bfloat16 --fusion_dtype
bfloat16``): the ``Trainer`` against the JAX package's on the same weights
and batches, and a bf16 run through ``new_train``, ``DenseCaptioner`` and
``run_eval`` on the CPU.

The weights stay f32 (AdamW and the clipping as in f32): the bf16 casts
live inside the modules, so the gradients reach the f32 parameters.  The
JAX Trainer jits its step, and under jit XLA on the CPU may keep f32
between fused bf16 operations (excess precision; see
tests/test_torch_bf16_model.py, which compares eagerly), so the two steps
differ by more than their f32 counterparts.  Tolerances: each step's
losses 3e-3 relative (measured 1.6e-4 at step 1 and 1.1e-3 at step 2);
after two AdamW steps the parameters' updates, concatenated, at a cosine
of at least 0.97 with JAX's (measured 0.990), and at least 90% of their
entries within 0.1 lr of JAX's (measured 94.8%): Adam moves each entry by
about lr whatever its gradient's size, so an entry whose gradient is
rounding noise may step the other way.  The JAX caption kernels run in
interpret mode (``msda_impl='pallas_interpret'``), as on any non-TPU
backend they otherwise ignore the bf16 precision.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port import tiny_opt, to_torch, train_batch  # noqa: I100

from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu_torch import run_eval
from dvc_tpu_torch.models import from_jax_params
from dvc_tpu_torch.new_train import main as train_main
from dvc_tpu_torch.serve import DenseCaptioner
from dvc_tpu_torch.train import Trainer
from dvc_tpu_torch.utils.config import parse_opts
from test_torch_train import REPO, _jnp, _synthetic_recipe, off_boundary

pytestmark = pytest.mark.heavy

BF16 = dict(tpu_compute_dtype='bfloat16', fusion_dtype='bfloat16')
LR = 1e-3


def test_bf16_trainer_matches_jax_trainer():
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0, lr=LR,
                   weight_decay=1e-2, optimizer_type='adamw', grad_clip=1.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   msda_impl='pallas_interpret', msda_trunk_impl='dense',
                   **BF16)
    batches = [train_batch(10 + i) for i in range(2)]
    jtrainer = JaxTrainer(opt, model=jax_make_fusion(opt))
    state = jtrainer.init_state(_jnp(batches[0]), seed=0)
    state['params'] = jax.tree_util.tree_map(
        jnp.asarray, off_boundary(state['params']))
    p0 = from_jax_params(jax.tree_util.tree_map(np.asarray, state['params']))
    trainer = Trainer(opt, device='cpu')
    assert trainer.model.pdvcModel.cfg.compute_dtype == 'bfloat16'
    trainer.model.load_state_dict({k: to_torch(v) for k, v in p0.items()},
                                  strict=True)
    rng = jax.random.PRNGKey(0)
    for step, batch in enumerate(batches):
        state, jlosses = jtrainer.train_step(state, batch, LR, 0.0, rng)
        losses = trainer.train_step(batch, LR)
        for k in ('total_loss', 'loss_caption', 'loss_ce', 'loss_giou'):
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                       rtol=3e-3, err_msg=f'step {step} {k}')
    p2 = from_jax_params(jax.tree_util.tree_map(np.asarray, state['params']))
    sd = trainer.model.state_dict()
    assert all(p.dtype == np.float32 or str(p.dtype) == 'torch.float32'
               for p in sd.values())
    got = np.concatenate([(sd[n].numpy() - p0[n]).ravel() for n in sorted(sd)])
    want = np.concatenate([(p2[n] - p0[n]).ravel() for n in sorted(sd)])
    cos = float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))
    assert cos >= 0.97, cos
    assert float((np.abs(got - want) < 0.1 * LR).mean()) >= 0.9


def test_bf16_run_trains_serves_and_evaluates(tmp_path, monkeypatch):
    """``new_train`` with the bf16 flags in the recipe: finite losses, a run
    whose saved options carry the flags into ``DenseCaptioner`` and
    ``run_eval`` (bf16 models, captions, records)."""
    recipe = _synthetic_recipe(tmp_path, **BF16)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu'],
                     root=REPO)
    folder, losses = train_main(opt)
    assert all(np.isfinite(v) for v in losses.values())
    with open(os.path.join(folder, 'info.json')) as f:
        saved = json.load(f)['last']['opt']
    assert (saved['tpu_compute_dtype'], saved['fusion_dtype']) == (
        'bfloat16', 'bfloat16')
    dc = DenseCaptioner(folder, which='last', device='cpu')
    assert dc.model.pdvcModel.cfg.compute_dtype == 'bfloat16'
    assert str(dc.model.fusion_dtype) == 'torch.bfloat16'
    rng = np.random.default_rng(1)
    events = dc.caption_features(
        rng.standard_normal((30, 16)).astype(np.float32), 45.0,
        sound=rng.standard_normal((30, 16)).astype(np.float32))
    assert events and all(isinstance(e['sentence'], str) for e in events)
    built, real = [], run_eval.make_model

    def make_model(opt, *args, **kw):
        built.append((opt.tpu_compute_dtype, opt.fusion_dtype))
        return real(opt, *args, **kw)

    monkeypatch.setattr(run_eval, 'make_model', make_model)
    path, _ = run_eval.main(['--eval_save_dir', folder, '--eval_model',
                             'last', '--eval_device', 'cpu',
                             '--skip_lang_eval'])
    assert built == [('bfloat16', 'bfloat16')]
    with open(path) as f:
        assert json.load(f)['results']
