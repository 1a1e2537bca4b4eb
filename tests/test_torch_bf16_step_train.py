"""bf16 training on the stepwise caption path: the port's ``Trainer`` with
``--tpu_compute_dtype bfloat16 --fusion_dtype bfloat16 --dsa_scan_fuse 0``
(the stepwise teacher forcing, K7-bf16/K8-bf16 a word step; their plain
bf16 versions on the CPU) against the JAX package's Trainer at bf16 on the
same weights and batches, as ``tests/test_torch_bf16_train.py`` holds the
fused routes, with its tolerances: each step's losses within 3e-3
relative; after two AdamW steps the parameters' updates at a cosine of at
least 0.97 with JAX's and 90% of their entries within 0.1 lr (Adam moves
each entry by about lr whatever its gradient's size).  One encoder and
one decoder layer, and the JAX init under jit: the JAX compiles are most
of the test's time.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from torch_port import tiny_opt, to_torch, train_batch  # noqa: I100

from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu_torch.models import from_jax_params
from dvc_tpu_torch.ops.dsa_step import sample_attend_ref
from dvc_tpu_torch.train import Trainer
from test_torch_train import _jnp, off_boundary

BF16 = 'bfloat16'


@pytest.mark.heavy
def test_bf16_stepwise_trainer_matches_jax_trainer():
    """Two AdamW steps of the bf16 Trainer with --dsa_scan_fuse 0 (the
    stepwise teacher forcing: the plain K7-bf16/K8-bf16 on the CPU) against
    the JAX Trainer at bf16, as
    ``tests/test_torch_bf16_train.py`` holds the fused routes: each step's
    losses within 3e-3 relative, the parameters' updates at a cosine of
    at least 0.97 with JAX's and 90% of their entries within 0.1 lr."""
    lr = 1e-3
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0, lr=lr,
                   weight_decay=1e-2, optimizer_type='adamw', grad_clip=1.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   msda_impl='pallas_interpret', msda_trunk_impl='dense',
                   enc_layers=1, dec_layers=1, dsa_scan_fuse=0,
                   tpu_compute_dtype=BF16,
                   fusion_dtype=BF16)
    batches = [train_batch(10 + i) for i in range(2)]
    jtrainer = JaxTrainer(opt, model=jax_make_fusion(opt))
    # init_state's rngs, but the eval forward's init under jit (the same
    # parameters): an eager train-mode init traces the stepwise teacher
    # forcing in interpret mode word by word (~45 s)
    rngs = {k: jax.random.PRNGKey(i)
            for i, k in enumerate(('params', 'dropout', 'sample'))}
    params = jax.jit(lambda r, b: jtrainer.model.init(r, b, eval_mode=True))(
        rngs, _jnp(batches[0]))
    params = jax.tree_util.tree_map(jnp.asarray, off_boundary(params))
    state = {'params': params, 'opt_state': jtrainer.tx.init(params),
             'step': 0}
    p0 = from_jax_params(jax.tree_util.tree_map(np.asarray, state['params']))
    trainer = Trainer(opt, device='cpu')
    trainer.model.load_state_dict({k: to_torch(v) for k, v in p0.items()},
                                  strict=True)
    calls = sample_attend_ref.calls
    rng = jax.random.PRNGKey(0)
    for step, batch in enumerate(batches):
        state, jlosses = jtrainer.train_step(state, batch, lr, 0.0, rng)
        losses = trainer.train_step(batch, lr)
        for k in ('total_loss', 'loss_caption', 'loss_ce', 'loss_giou'):
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                       rtol=3e-3, err_msg=f'step {step} {k}')
    assert sample_attend_ref.calls > calls
    p2 = from_jax_params(jax.tree_util.tree_map(np.asarray, state['params']))
    sd = trainer.model.state_dict()
    got = np.concatenate([(sd[n].numpy() - p0[n]).ravel() for n in sorted(sd)])
    want = np.concatenate([(p2[n] - p0[n]).ravel() for n in sorted(sd)])
    cos = float(got @ want / np.linalg.norm(got) / np.linalg.norm(want))
    assert cos >= 0.97, cos
    assert float((np.abs(got - want) < 0.1 * lr).mean()) >= 0.9
