"""Port parity of the training slice: box ops, matcher, criterion, the
FusionPDVC train forward and its gradients, the ``Trainer`` over several
optimizer steps, and the ``dvc_tpu_torch.new_train`` driver, each against
the JAX package on the same weights and batches (tiny_opt scale, dropout
off; the JAX scan runs its plain reference, as on any non-TPU backend).

Tolerances: box ops and single losses 1e-5 (f32, same formulas); the
matcher's total cost 1e-5 (the port's solver is JAX's bit for bit on the
same f32 costs, tests/test_torch_assignment.py, but the two packages' cost
matrices differ in ulps, which can flip a near-tie); the train forward's losses rtol 1e-5 and each
parameter's gradient within a relative L2 error of 1e-4 plus 1e-6 absolute
(the floor is for alpha_net's bias, whose gradient is zero in exact
arithmetic since softmax gradients sum to zero); the Trainer's per-step
losses rtol 1e-4 and its final parameters atol 2e-5 + rtol 1e-3 (Adam
divides each step by sqrt(v), which amplifies rounding in the smallest
gradients), except where the gradient is zero in exact arithmetic and Adam
turns its pure rounding noise into steps of ±lr: alpha_net's bias and the
key third of each attention's in_proj_bias (softmax ignores a shift common
to all keys).

The flax init puts every sampling point exactly on a tap boundary (zero
offset kernels, integer offset biases), where the gradient with respect to
the location jumps and one ulp of rounding picks the side; the gradient
tests first move the offset kernels off it (``off_boundary``).
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from synth import make_synth_dataset  # noqa: I100
from torch_port import tiny_opt, to_numpy, to_torch, train_batch

from dvc_tpu.models.criterion import CriterionConfig as JaxCriterionConfig
from dvc_tpu.models.criterion import build_weight_dict as jax_weight_dict
from dvc_tpu.models.criterion import criterion_forward as jax_criterion
from dvc_tpu.models.fusion import make_fusion_model as jax_make_fusion
from dvc_tpu.models.matcher import hungarian_match as jax_match
from dvc_tpu.models.matcher import match_cost_matrix as jax_cost
from dvc_tpu.train.trainer import Trainer as JaxTrainer
from dvc_tpu.train.trainer import multistep_lr as jax_multistep_lr
from dvc_tpu.utils import box_ops as jax_box_ops
from dvc_tpu_torch.data import FusionBatchLoader, FusionDataset
from dvc_tpu_torch.models import from_jax_params, make_fusion_model
from dvc_tpu_torch.models.criterion import (CriterionConfig,
                                            build_weight_dict,
                                            criterion_forward)
from dvc_tpu_torch.models.matcher import hungarian_match, match_cost_matrix
from dvc_tpu_torch.new_train import main as train_main
from dvc_tpu_torch.serve import DenseCaptioner
from dvc_tpu_torch.train import Trainer, load_checkpoint, multistep_lr
from dvc_tpu_torch.utils import box_ops
from dvc_tpu_torch.utils.config import parse_opts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(to_numpy(got), np.asarray(want), rtol=tol,
                               atol=tol)


def _boxes(rng, *shape):
    return np.stack([rng.uniform(0.1, 0.9, shape),
                     rng.uniform(0.02, 0.4, shape)], -1).astype(np.float32)


def test_box_iou_and_giou():
    rng = np.random.default_rng(0)
    a = jax_box_ops.box_cl_to_xy(jnp.asarray(_boxes(rng, 3, 7)))
    b = jax_box_ops.box_cl_to_xy(jnp.asarray(_boxes(rng, 3, 5)))
    a = a.at[0, 0].set(b[0, 0])             # an exact overlap
    ta, tb = to_torch(a), to_torch(b)
    for got, want in zip(box_ops.box_iou(ta, tb), jax_box_ops.box_iou(a, b)):
        _close(got, want)
    _close(box_ops.generalized_box_iou(ta, tb),
           jax_box_ops.generalized_box_iou(a, b))


def _predictions(seed, B=2, Nq=10, G=4):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((B, Nq, 1)).astype(np.float32)
    mask = np.ones((B, G), bool)
    mask[1, 2:] = False
    return (logits, _boxes(rng, B, Nq), np.zeros((B, G), np.int32),
            _boxes(rng, B, G) * mask[..., None], mask)


@pytest.mark.parametrize('seed', [0, 1, 2])
def test_matcher_total_cost_matches_jax(seed):
    opt = tiny_opt()
    cfg_t = CriterionConfig.from_opt(opt).matcher
    cfg_j = JaxCriterionConfig.from_opt(opt).matcher
    arrays = _predictions(seed)
    C = jax_cost(cfg_j, *(jnp.asarray(a) for a in arrays[:4]))
    _close(match_cost_matrix(cfg_t, *(to_torch(a) for a in arrays[:4])), C)
    # one decoder layer, stacked as the matcher takes the layers
    got = to_numpy(hungarian_match(
        cfg_t, to_torch(arrays[0])[None], to_torch(arrays[1])[None],
        *(to_torch(a) for a in arrays[2:])))[0]
    want = np.asarray(jax_match(cfg_j, *(jnp.asarray(a) for a in arrays)))
    mask = arrays[4]
    C = np.asarray(C)
    for b in range(len(mask)):
        assert len(set(got[b])) == len(got[b])       # distinct queries
        g = np.flatnonzero(mask[b])
        np.testing.assert_allclose(C[b, got[b, g], g].sum(),
                                   C[b, want[b, g], g].sum(), rtol=1e-5)


@pytest.mark.parametrize('gau_mask', [1, 0])
def test_criterion_matches_jax_every_key(gau_mask):
    opt = tiny_opt(lloss_gau_mask=gau_mask, max_eseq_length=6)
    D, B, Nq, G = 3, 2, 10, 4
    rng = np.random.default_rng(7)
    outputs = {'pred_logits': rng.standard_normal((D, B, Nq, 1)),
               'pred_count': rng.standard_normal((D, B, 7)),
               'pred_boxes': np.stack([_boxes(rng, B, Nq)
                                       for _ in range(D)])}
    outputs = {k: v.astype(np.float32) for k, v in outputs.items()}
    _, _, labels, gt_boxes, mask = _predictions(8, B, Nq, G)
    want, want_last, _ = jax_criterion(
        JaxCriterionConfig.from_opt(opt),
        {k: jnp.asarray(v) for k, v in outputs.items()}, jnp.asarray(labels),
        jnp.asarray(gt_boxes), jnp.asarray(mask))
    got, got_last, aux = criterion_forward(
        CriterionConfig.from_opt(opt),
        {k: to_torch(v) for k, v in outputs.items()}, to_torch(labels),
        to_torch(gt_boxes), to_torch(mask))
    assert sorted(got) == sorted(want) and len(aux) == D - 1
    for k in want:
        _close(got[k], want[k])
    assert build_weight_dict(opt) == jax_weight_dict(opt)


def off_boundary(params, seed=0, scale=1e-2):
    """params with every sampling-offset kernel set to small random
    values, so that no sampling point sits on a tap boundary."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [getattr(k, 'key', '') for k in path]
        if 'kernel' in names and 'sampling_offsets' in names \
                or 'dsa_sampling_offsets_w' in names:
            return (rng.standard_normal(np.shape(x)) * scale).astype(
                np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(move, params)


def _train_forward(opt, params, batch):
    """(losses, {state_dict name: grad}) of the port's train forward."""
    model = make_fusion_model(opt, device='cpu')
    model.load_state_dict({k: to_torch(v) for k, v in
                           from_jax_params(params).items()}, strict=True)
    out, losses = model.forward_train(_torch(batch))
    wd = build_weight_dict(opt)
    sum(losses[k] * w for k, w in wd.items() if k in losses and w).backward()
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters(remove_duplicate=False)}
    return out, losses, grads


@pytest.mark.heavy
@pytest.mark.parametrize('shared', [1, 0])
def test_train_forward_and_gradients_match_jax(shared):
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   share_caption_head=shared)
    batch = train_batch(1)
    jmodel = jax_make_fusion(opt)
    # initialised on the train path, which creates every layer's caption
    # head when they are not shared (the eval path only the last one's)
    params = off_boundary(jax.jit(lambda r, b: jmodel.init(
        {'params': r}, b, eval_mode=False, deterministic=True,
        ss_enabled=False))(jax.random.PRNGKey(0), _jnp(batch)))
    wd = jax_weight_dict(opt)

    def loss_fn(p):
        out, losses = jmodel.apply(p, _jnp(batch), eval_mode=False,
                                   deterministic=True, ss_enabled=False)
        return sum(losses[k] * w for k, w in wd.items()
                   if k in losses and w), (out, losses)

    (_, (jout, jlosses)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    out, losses, grads = _train_forward(opt, params, batch)
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_array_equal(to_numpy(out['matched_indices']),
                                  np.asarray(jout['matched_indices']))
    want = from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert sorted(grads) == sorted(want)
    for name, g in grads.items():
        err = np.linalg.norm(to_numpy(g) - want[name])
        assert err <= 1e-4 * np.linalg.norm(want[name]) + 1e-6, name


def test_train_forward_dropout_draws_from_the_generator():
    """With a generator the forward differs from the deterministic one and
    is reproduced by the same seed."""
    opt = tiny_opt(drop_prob=0.5, transformer_dropout_prob=0.1)
    model = make_fusion_model(opt, device='cpu').train()
    batch = _torch(train_batch(2))

    def total(gen):
        with torch.no_grad():
            return float(model.forward_train(batch, gen)[1]['loss_caption'])

    a = total(torch.Generator().manual_seed(5))
    assert a == total(torch.Generator().manual_seed(5))
    assert a != total(None)


def test_multistep_lr_matches_jax():
    opt = tiny_opt(lr=1e-3, learning_rate_decay_start=2,
                   learning_rate_decay_every=2, learning_rate_decay_rate=0.5,
                   epoch=9)
    for epoch in range(10):
        assert multistep_lr(opt, epoch) == jax_multistep_lr(opt, epoch)


@pytest.mark.heavy
def test_trainer_matches_jax_trainer_across_lr_decay():
    """6 AdamW steps on the same batches, epochs of 2 steps with the LR
    halved at epochs 1 and 2; per-step losses and the final parameters."""
    opt = tiny_opt(transformer_dropout_prob=0.0, drop_prob=0.0, lr=1e-3,
                   weight_decay=1e-2, optimizer_type='adamw', grad_clip=1.0,
                   caption_loss_coef=2.0, count_loss_coef=0.5,
                   learning_rate_decay_start=1, learning_rate_decay_every=1,
                   learning_rate_decay_rate=0.5, epoch=3)
    batches = [train_batch(10 + i) for i in range(3)]
    jtrainer = JaxTrainer(opt, model=jax_make_fusion(opt))
    state = jtrainer.init_state(_jnp(batches[0]), seed=0)
    state['params'] = jax.tree_util.tree_map(
        jnp.asarray, off_boundary(state['params']))
    trainer = Trainer(opt, device='cpu')
    trainer.model.load_state_dict(
        {k: to_torch(v) for k, v in from_jax_params(
            jax.tree_util.tree_map(np.asarray, state['params'])).items()},
        strict=True)
    rng = jax.random.PRNGKey(0)
    lrs = []
    for step in range(6):
        lr = multistep_lr(opt, step // 2)
        lrs.append(lr)
        batch = batches[step % 3]
        state, jlosses = jtrainer.train_step(state, batch, lr, 0.0, rng)
        losses = trainer.train_step(batch, lr)
        for k in ('total_loss', 'loss_caption', 'loss_ce', 'loss_giou'):
            np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                       rtol=1e-4, err_msg=f'step {step} {k}')
    assert lrs == [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4, 2.5e-4]
    want = from_jax_params(jax.tree_util.tree_map(np.asarray,
                                                  state['params']))
    for name, p in trainer.model.state_dict().items():
        got, ref = to_numpy(p), want[name]
        if name.endswith('alpha_net.bias'):
            continue
        if name.endswith('in_proj_bias'):       # drop the key bias
            E = len(ref) // 3
            got, ref = np.delete(got, np.s_[E:2 * E]), \
                np.delete(ref, np.s_[E:2 * E])
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=2e-5,
                                   err_msg=name)


def _synthetic_recipe(root, n_videos=7, **over):
    anno, feats, vocab, vsize = make_synth_dataset(str(root),
                                                   n_videos=n_videos)
    sound = root / 'sound'
    sound.mkdir()
    rng = np.random.default_rng(0)
    for key in list(json.load(open(anno)))[:3]:
        np.save(sound / f'{key[:13]}.npy',
                rng.standard_normal((24, 16)).astype(np.float32))
    cfg = dict(base_cfg_path='cfgs/yc2_newModel_sound.yml', id='tiny',
               save_dir=str(root / 'save'), train_caption_file=anno,
               val_caption_file=anno, dict_file=vocab, vocab_size=vsize,
               visual_feature_type='tsp', visual_feature_folder=feats,
               invalid_video_json=[], feature_dim=16, frame_embedding_num=24,
               gt_proposal_sample_num=3, max_caption_len=8, hidden_dim=64,
               nheads=4, enc_layers=1, dec_layers=2, transformer_ff_dim=64,
               num_queries=8, input_encoding_size=32, rnn_size=64,
               att_hid_size=32, cap_nheads=2, batch_size=2, epoch=1,
               sound_feature_folder=str(sound), ckpt_every_batches=2,
               max_eseq_length=8, fusion_heads=4, **over)
    path = root / 'tiny.yml'
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.heavy
def test_new_train_driver_writes_a_run_that_serves(tmp_path):
    recipe = _synthetic_recipe(tmp_path)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', 'cpu'],
                     root=REPO)
    folder, losses = train_main(opt)
    # the recipe's gt files for the metrics are absent: validation writes
    # the records (and their reranked copy), skips the scores and so keeps
    # no best checkpoint, as newTrain.py does
    assert sorted(os.listdir(folder)) == [
        'epoch1.json', 'epoch1.json_rerank_alpha1.0_temp2.0.json',
        'info.json', 'model-last.pth', 'train.log']
    assert all(np.isfinite(v) for v in losses.values())
    assert 'loss_caption' in losses and 'loss_caption_0' in losses
    ck = load_checkpoint(os.path.join(folder, 'model-last.pth'))
    assert ck['epoch'] == 1 and ck['step'] == 3       # 7 videos, B=2
    dc = DenseCaptioner(folder, which='last', device='cpu')
    rng = np.random.default_rng(1)
    events = dc.caption_features(
        rng.standard_normal((30, 16)).astype(np.float32), 45.0,
        sound=rng.standard_normal((30, 16)).astype(np.float32))
    assert events
    for e in events:
        assert 0 <= e['timestamp'][0] <= e['timestamp'][1] <= 45.0 + 1e-3
        assert isinstance(e['sentence'], str)

    # a restart resumes from model-last: epoch, optimizer state and weights
    opt2 = parse_opts(['--cfg_path', recipe, '--device', 'cpu', '--debug',
                       '--start_from', opt.id], root=REPO)
    opt2.epoch = 2
    train_main(opt2)
    ck2 = load_checkpoint(os.path.join(folder, 'model-last.pth'))
    assert ck2['epoch'] == 2 and ck2['step'] == 6
    with open(os.path.join(folder, 'info.json')) as f:
        assert json.load(f)['last']['epoch'] == 2


def test_loader_skips_visited_videos(tmp_path):
    recipe = _synthetic_recipe(tmp_path)
    opt = parse_opts(['--cfg_path', recipe], root=REPO)
    ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt)
    visited = set(ds.keys[:3])
    seen = [k for _, meta in FusionBatchLoader(ds, 2, False, opt,
                                               skip_keys=visited)
            for k in meta['keys']]
    assert not visited & set(seen) and set(seen) == set(ds.keys[3:])
    batch, _ = next(iter(FusionBatchLoader(ds, 2, False, opt)))
    assert batch['sound_tensor'].shape == (2, 24, 16)
    # videos 0-2 have cached sound features, the others zeros
    assert np.abs(batch['sound_tensor']).sum() > 0
