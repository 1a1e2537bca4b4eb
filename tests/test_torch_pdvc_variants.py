"""Port parity of plain PDVC's variants: the 'light' and 'none' caption
heads, the two-stage 'gt_proposals' input, 'learnt_proposals', and the
LSTM-DSA head at two layers and without attention, each through
``pdvc_from_jax_params`` against the JAX ``PDVC`` on the same weights
(tiny_opt scale, dropout off); ``build_weight_dict`` against JAX's for
every recipe in ``cfgs/``; ``strict=True`` loads of ``export_pdvc``'s
output; every recipe building in the port; and the matching of videos
with more gt events than queries, which the JAX solver refuses.

Tolerances: eval outputs (logits, boxes, count logits) rtol/atol 2e-4 (the
earlier torch-parity tolerance), captions token for token and their
log-probs 1e-4; two-stage boxes equal to the gt boxes within 1e-6 (they
are the references themselves, as JAX's tests/test_two_stage.py holds
them); the train forward's losses rtol 1e-5 + 1e-6 and each parameter's
gradient within a relative L2 error of 1e-4 plus 1e-6 absolute (the floor
is for alpha_net's bias, whose gradient is zero in exact arithmetic).  The
offset kernels are moved off the tap boundary first, as in
tests/test_torch_train.py.
"""
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port import tiny_opt, to_numpy, to_torch, train_batch  # noqa: I100

from dvc_tpu.models import PDVC as JaxPDVC
from dvc_tpu.models import PDVCConfig as JaxPDVCConfig
from dvc_tpu.models.criterion import build_weight_dict as jax_weight_dict
from dvc_tpu.models.pdvc_converter import export_pdvc
from dvc_tpu.utils.config import load_config as jax_load_config
from dvc_tpu_torch.models import make_pdvc_model, pdvc_from_jax_params
from dvc_tpu_torch.models.criterion import build_weight_dict
from dvc_tpu_torch.models.pdvc import PDVC, PDVCConfig
from dvc_tpu_torch.utils.config import load_config

pytestmark = pytest.mark.heavy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECIPES = sorted(os.path.relpath(p, REPO)
                 for p in glob.glob(os.path.join(REPO, 'cfgs', '*.yml')))
TOL = dict(rtol=2e-4, atol=2e-4)

VARIANTS = {
    'light': dict(caption_decoder_type='light', att_hid_size=0),
    'none': dict(caption_decoder_type='none', caption_loss_coef=0),
    'gt_proposals': dict(caption_decoder_type='light', att_hid_size=0,
                         transformer_input_type='gt_proposals'),
    'gt_proposals_dsa': dict(transformer_input_type='gt_proposals'),
    'learnt_proposals': dict(transformer_input_type='learnt_proposals'),
    'dsa_two_layers': dict(num_layers=2),
    'dsa_no_attention': dict(att_hid_size=0, cap_nheads=2),
}


def variant_opt(name):
    kw = dict(transformer_dropout_prob=0.0, drop_prob=0.0, enc_layers=1,
              caption_loss_coef=2.0, count_loss_coef=0.5)
    kw.update(VARIANTS[name])
    return tiny_opt(**kw)


def pdvc_batch(seed):
    b = train_batch(seed)
    b.pop('sound_tensor')
    return b


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: to_torch(v) for k, v in batch.items()}


def off_boundary(params, seed=0, scale=1e-2):
    """Every sampling-offset kernel set to small random values, so that no
    sampling point sits on a tap boundary."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        names = [getattr(k, 'key', '') for k in path]
        if 'kernel' in names and 'sampling_offsets' in names \
                or 'dsa_sampling_offsets_w' in names:
            return (rng.standard_normal(np.shape(x)) * scale).astype(
                np.float32)
        return np.asarray(x)
    return jax.tree_util.tree_map_with_path(move, params)


def jax_pdvc(opt, batch):
    """(flax model, params initialised on the train path, so that every
    layer's caption head exists)."""
    model = JaxPDVC(JaxPDVCConfig.from_opt(opt))
    params = jax.jit(lambda r, b: model.init(
        {'params': r}, b, eval_mode=False, deterministic=True,
        ss_enabled=False))(jax.random.PRNGKey(0), _jnp(batch))
    return model, off_boundary(params)


def port_pdvc(opt, params):
    model = make_pdvc_model(opt, device='cpu')
    model.load_state_dict({k: to_torch(v) for k, v in
                           pdvc_from_jax_params(params).items()}, strict=True)
    return model


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_eval_forward_matches_jax(name):
    """The eval forward (matching, criterion, greedy captions) of the
    port's PDVC against the JAX PDVC, and two-stage boxes equal to the gt
    boxes at every layer."""
    opt = variant_opt(name)
    batch = pdvc_batch(1)
    jmodel, params = jax_pdvc(opt, batch)
    jout, jlosses = jax.jit(lambda p, b: jmodel.apply(p, b, eval_mode=True))(
        params, _jnp(batch))
    model = port_pdvc(opt, params)
    with torch.no_grad():
        out, losses = model.forward_eval(_torch(batch))
        enc, hs, refs, deltas = model.trunk(_torch(batch))
        layers = model.layer_outputs(hs, refs, deltas, train_path=False)
    assert sorted(out) == sorted(jout)
    for k in ('pred_logits', 'pred_boxes', 'pred_count'):
        np.testing.assert_allclose(to_numpy(out[k]), np.asarray(jout[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_array_equal(to_numpy(out['matched_indices']),
                                  np.asarray(jout['matched_indices']))
    if 'seq' in jout:
        np.testing.assert_array_equal(to_numpy(out['seq']),
                                      np.asarray(jout['seq']))
        np.testing.assert_allclose(to_numpy(out['cap_prob_eval']),
                                   np.asarray(jout['cap_prob_eval']),
                                   rtol=1e-4, atol=1e-4)
    else:
        assert opt.caption_decoder_type == 'none'
    assert sorted(losses) == sorted(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k]), float(jlosses[k]),
                                   err_msg=k, **TOL)
    if opt.transformer_input_type == 'gt_proposals':
        G = batch['gt_boxes'].shape[1]
        boxes = to_numpy(layers['pred_boxes'])            # (D, B, G, 2)
        assert boxes.shape[2] == G and out['pred_logits'].shape[1] == G
        m = batch['gt_boxes_mask']
        for layer in boxes:
            np.testing.assert_allclose(layer[m], batch['gt_boxes'][m],
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_train_losses_and_gradients_match_jax(name):
    opt = variant_opt(name)
    batch = pdvc_batch(2)
    jmodel, params = jax_pdvc(opt, batch)
    wd = jax_weight_dict(opt)

    def loss_fn(p):
        out, losses = jmodel.apply(p, _jnp(batch), eval_mode=False,
                                   deterministic=True, ss_enabled=False)
        return sum(losses[k] * w for k, w in wd.items()
                   if k in losses and w), (out, losses)

    (_, (jout, jlosses)), jgrads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(params)
    model = port_pdvc(opt, params)
    out, losses = model.forward_train(_torch(batch))
    assert build_weight_dict(opt) == wd
    sum(losses[k] * w for k, w in wd.items()
        if k in losses and w).backward()
    assert sorted(losses) == sorted(jlosses)
    assert ('loss_caption' in losses) == (opt.caption_decoder_type != 'none')
    np.testing.assert_array_equal(to_numpy(out['matched_indices']),
                                  np.asarray(jout['matched_indices']))
    for k in jlosses:
        np.testing.assert_allclose(float(losses[k].detach()),
                                   float(jlosses[k]), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    want = pdvc_from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p))
             for n, p in model.named_parameters(remove_duplicate=False)}
    assert sorted(grads) == sorted(want)
    for n, g in grads.items():
        err = np.linalg.norm(to_numpy(g) - want[n])
        assert err <= 1e-4 * np.linalg.norm(want[n]) + 1e-6, n


@pytest.mark.parametrize('name', sorted(VARIANTS))
def test_strict_load_of_export_pdvc(name):
    """``export_pdvc`` (the JAX package's reference-layout export) loads
    into the port's PDVC with strict=True and equals the bridge."""
    opt = variant_opt(name)
    _, params = jax_pdvc(opt, pdvc_batch(0))
    want = export_pdvc(params)
    got = pdvc_from_jax_params(params)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    model = PDVC(PDVCConfig.from_opt(opt))
    model.load_state_dict({k: to_torch(v) for k, v in want.items()},
                          strict=True)
    two_stage = opt.transformer_input_type == 'gt_proposals'
    assert ('transformer.pos_trans.weight' in want) == two_stage
    assert ('transformer.reference_points.weight' in want) != two_stage


@pytest.mark.parametrize('recipe', RECIPES)
def test_weight_dict_and_build_of_every_recipe(recipe):
    """build_weight_dict as JAX's (two-stage zeroing included), and the
    recipe's PDVC builds in the port (on the meta device) unless it needs
    an unported path, which raises NotImplementedError."""
    opt = load_config(recipe, root=REPO)
    assert build_weight_dict(opt) == jax_weight_dict(
        jax_load_config(recipe, root=REPO))
    if opt.transformer_input_type == 'gt_proposals':
        assert all(w == 0 for k, w in build_weight_dict(opt).items()
                   if k.split('_')[1] in ('ce', 'bbox', 'giou'))
    with torch.device('meta'):
        model = PDVC(PDVCConfig.from_opt(opt))
    assert len(model.caption_head) == (
        0 if opt.caption_decoder_type == 'none' else opt.dec_layers)


def test_more_gt_events_than_queries():
    """Where a video has more gt events than queries (every anet recipe
    pads G = 30 against 10 queries; the JAX solver refuses any G > Nq),
    the port matches Nq of them as scipy does on the rectangular matrix,
    leaves the rest at -1 and out of the pair losses, and keeps them in
    num_boxes and the event count; padded slots take the free queries
    while there are any."""
    from scipy.optimize import linear_sum_assignment
    from dvc_tpu_torch.models.matcher import masked_assignment
    cost = np.random.default_rng(0).standard_normal((5, 3))
    got = masked_assignment(cost, np.array([1, 1, 0, 0, 0], bool))
    _, c = linear_sum_assignment(cost[:2])
    np.testing.assert_array_equal(got[:2], c)
    assert sorted(got[:3]) == [0, 1, 2] and list(got[3:]) == [-1, -1]
    got = masked_assignment(cost, np.array([1, 1, 1, 1, 0], bool))
    r, c = linear_sum_assignment(cost[:4])
    want = np.full(5, -1)
    want[r] = c
    np.testing.assert_array_equal(got, want)

    opt = tiny_opt(num_queries=2, caption_decoder_type='light',
                   att_hid_size=0, caption_loss_coef=2.0)
    batch = _torch(pdvc_batch(3))             # 3 events and 2 in G = 3
    model = make_pdvc_model(opt, device='cpu')
    out, losses = model.forward_train(batch)
    idx = out['matched_indices']
    assert (idx[0] < 0).sum() == 1 and (idx[1, :2] >= 0).all()
    assert all(torch.isfinite(v) for v in losses.values())
    m = (idx >= 0) & batch['gt_boxes_mask']
    src = torch.gather(out['pred_boxes'], 1,
                       idx.clamp(min=0)[..., None].expand(-1, -1, 2))
    want = ((src - batch['gt_boxes']).abs().sum(-1) * m).sum() / 5
    torch.testing.assert_close(losses['loss_bbox'], want)
