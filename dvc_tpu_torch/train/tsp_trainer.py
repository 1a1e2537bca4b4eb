"""TSP backbone training (port of ``dvc_tpu/train/tsp_trainer.py``;
reference ``video_backbone/TSP/train/train.py``: SGD with per-group
learning rates, the per-iteration WarmupMultiStepLR, and the heads' cross
entropy with ignore_index=-1 weighted by the per-head alphas).

The JAX package chains optax's ``add_decayed_weights(wd)``,
``trace(momentum)`` and ``scale(-1)`` and multiplies the update by a
per-leaf learning rate times the schedule: that is
``torch.optim.SGD(momentum, dampening=0, nesterov=False,
weight_decay=wd)`` over three parameter groups (:func:`lr_param_groups`),
each group's lr set to its base times the schedule every iteration.
Weight decay applies to every parameter, BatchNorm's and biases included.

Under ``--train-bn 1`` the VideoResNets' BatchNorm runs on batch
statistics and updates its running statistics with flax's semantics
(``models/tsp/backbones.py::BatchNorm3d``); otherwise the backbone keeps
its running statistics.  ``--dtype float32`` is true float32 on the card
(``full_float32``: no TF32).  ``--dtype bfloat16`` is the JAX package's
mixed precision: the forward runs on every floating variable cast to
bfloat16 (``torch.func.functional_call`` on cast parameters; BatchNorm
casts its statistics to the input's dtype), the gradients reach the
float32 master weights through the cast, and the logits and losses are
float32.  ``torch.autocast`` would keep LayerNorm and softmax in float32
and round elsewhere than JAX does.

On a data-parallel rank (``parallel``: a process group, one rank a card)
the step is the JAX data mesh's global-batch step: each rank's batch holds
its rows, the heads' cross entropy counts the global batch's labels,
BatchNorm under ``--train-bn 1`` normalises with the global batch's
statistics (``BatchNorm3d.global_sum``: SyncBatchNorm, as flax computes
them over a sharded batch), the gradients are summed before SGD, and the
metrics returned are the global batch's.  Without a group no collective
is issued.
"""

from __future__ import annotations

import contextlib
from bisect import bisect_right

import torch
from torch.func import functional_call

from .. import parallel
from ..models.tsp import (TSPModel, make_tsp_model, tsp_cross_entropy,
                          tsp_weights)
from ..models.tsp.backbones import BatchNorm3d
from ..models.tsp.extractor import full_float32
from ..models.tsp.model import GVF_DIM


def warmup_multistep_lr(base_lr: float, iteration: int, milestones,
                        gamma: float = 0.1, warmup_factor: float = 1 / 3,
                        warmup_iters: int = 5,
                        warmup_method: str = 'linear') -> float:
    """Per-iteration schedule (reference common/scheduler.py:5-47)."""
    warmup = 1.0
    if iteration < warmup_iters:
        if warmup_method == 'constant':
            warmup = warmup_factor
        else:
            alpha = float(iteration) / warmup_iters
            warmup = warmup_factor * (1 - alpha) + alpha
    return base_lr * warmup * gamma ** bisect_right(list(milestones),
                                                    iteration)


def lr_group(name: str) -> str:
    """The group of a ``TSPModel`` parameter, by the rule of the JAX
    package's ``lr_multiplier_tree`` (reference train.py:245-260): the
    backbone (``features.``) at the backbone lr, its stem (torchvision's
    ``features.stem.*``; an MViT has none) frozen, the rest (the heads)
    at the fc lr."""
    if not name.startswith('features.'):
        return 'heads'
    return 'stem' if name.startswith('features.stem.') else 'backbone'


def lr_param_groups(model: torch.nn.Module, backbone_lr: float,
                    fc_lr: float):
    """SGD parameter groups ``stem`` (lr 0), ``backbone`` and ``heads``,
    each with its ``base_lr`` and ``name``."""
    base = {'stem': 0.0, 'backbone': backbone_lr, 'heads': fc_lr}
    params = {g: [] for g in base}
    for name, p in model.named_parameters():
        params[lr_group(name)].append(p)
    return [{'params': params[g], 'lr': lr, 'base_lr': lr, 'name': g}
            for g, lr in base.items()]


class TSPTrainer:
    """One TSP model and its optimizer on ``device`` (the card unless the
    caller asks for the CPU).  ``opt``: the JAX trainer's options
    (``backbone_tsp``, ``tsp_num_classes``, ``tsp_num_heads``,
    ``loss_alphas``, ``backbone_lr``, ``fc_lr``, ``momentum``,
    ``tsp_weight_decay``, ``tsp_train_bn``, ``tsp_dtype``,
    ``global_video_features``, ``lr_milestones``, ``lr_gamma``,
    ``lr_warmup_iters``, ``tpu_mesh_data``); ``config`` sizes an MViT
    other than MViTv2-S; ``gvf_dim`` is the global video features' width.

    A state is ``{'model', 'optimizer', 'step'}``; batches are dicts of
    host tensors (``clip`` (B, T, H, W, 3) float32, ``gvf``, ``label{i}``),
    pinned where the device is the card.  Made in a process group, it
    trains as a data-parallel rank (the module's docstring), and
    :meth:`init_state` gives every rank rank 0's weights."""

    def __init__(self, opt, device='cuda', config=None,
                 gvf_dim: int = GVF_DIM):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError("TSPTrainer: no CUDA device (pass "
                               "device='cpu' for the CPU)")
        self.data_parallel = parallel.active()
        self.opt = opt
        self.backbone = getattr(opt, 'backbone_tsp', 'mvit_v2_s')
        self.num_classes = tuple(getattr(opt, 'tsp_num_classes', (1, 2)))
        self.num_heads = getattr(opt, 'tsp_num_heads', 2)
        self.concat_gvf = bool(getattr(opt, 'global_video_features', None))
        self.alphas = tuple(getattr(opt, 'loss_alphas', (1.0, 1.0)))
        self.train_bn = bool(getattr(opt, 'tsp_train_bn', 0))
        dt = str(getattr(opt, 'tsp_dtype', 'float32'))
        self.dtype = torch.bfloat16 if dt in ('bf16', 'bfloat16') \
            else torch.float32
        self.config = config
        self.gvf_dim = gvf_dim

    def init_state(self, seed: int = 0, state_dict=None):
        """A state with seeded random weights (torchvision's (2+1)-D
        middle widths), or ``state_dict``'s (their layout inferred, a JAX
        tree's through ``tsp_from_jax_params``), and a fresh optimizer; on
        a data-parallel rank rank 0's weights, and BatchNorm's statistics
        summed over the ranks."""
        spec = dict(num_classes=self.num_classes, num_heads=self.num_heads,
                    concat_gvf=self.concat_gvf, config=self.config,
                    gvf_dim=self.gvf_dim)
        if state_dict is None:
            model = make_tsp_model(self.backbone, 'cpu', seed, **spec)
        else:
            layout = tsp_weights(state_dict, self.backbone,
                                 self.config).mid_layout
            with torch.device('meta'):
                model = TSPModel(self.backbone, mid_layout=layout, **spec)
            model.to_empty(device='cpu')
            model.load_state_dict(state_dict, strict=True)
        model = model.to(self.device)
        if self.data_parallel:
            parallel.broadcast_module(model)
            for m in model.modules():
                if isinstance(m, BatchNorm3d):
                    m.global_sum = parallel.all_reduce_sum
        opt = self.opt
        optimizer = torch.optim.SGD(
            lr_param_groups(model, getattr(opt, 'backbone_lr', 1e-5),
                            getattr(opt, 'fc_lr', 5e-5)),
            lr=0.0, momentum=getattr(opt, 'momentum', 0.9),
            weight_decay=float(getattr(opt, 'tsp_weight_decay', 0.005)))
        return {'model': model, 'optimizer': optimizer, 'step': 0}

    @staticmethod
    def set_momentum(state, buffers):
        """Load SGD momentum buffers keyed like the model's parameters
        (``tsp_momentum_from_jax`` of a JAX checkpoint's ``opt_state``)."""
        params = dict(state['model'].named_parameters())
        if set(buffers) != set(params):
            raise ValueError('set_momentum: the buffers name other '
                             'parameters than the model has: '
                             f'{sorted(set(buffers) ^ set(params))[:6]}')
        for name, p in params.items():
            state['optimizer'].state[p]['momentum_buffer'] = \
                buffers[name].to(p.device, torch.float32).clone()

    @staticmethod
    def momentum_buffers(state):
        """The optimizer's momentum buffers by parameter name (none before
        the first step)."""
        opt_state = state['optimizer'].state
        return {name: opt_state[p]['momentum_buffer']
                for name, p in state['model'].named_parameters()
                if 'momentum_buffer' in opt_state.get(p, {})}

    def precision(self):
        """True float32 on the card under ``--dtype float32``."""
        if self.dtype == torch.float32 and self.device.type == 'cuda':
            return full_float32()
        return contextlib.nullcontext()

    def device_batch(self, batch):
        """The batch on the device: the clips cast to the compute dtype
        and permuted to (B, 3, T, H, W), ``gvf`` cast, labels int64."""
        out = {}
        for k, v in batch.items():
            v = torch.as_tensor(v).to(self.device, non_blocking=True)
            if k == 'clip':
                v = v.to(self.dtype).permute(0, 4, 1, 2, 3)
            elif k == 'gvf':
                v = v.to(self.dtype)
            else:
                v = v.long()
            out[k] = v
        return out

    def _logits(self, model, batch):
        """The heads' float32 logits of the forward in the compute dtype
        (every parameter cast under bfloat16; the f32 masters receive the
        gradients through the cast)."""
        args = (batch['clip'], batch.get('gvf'))
        if self.dtype == torch.float32:
            logits = model(*args)
        else:
            params = {n: p.to(self.dtype)
                      for n, p in model.named_parameters()}
            logits = functional_call(model, params, args)
        return [lg.float() for lg in logits]

    def _losses(self, logits, batch, global_sum=None):
        losses = [tsp_cross_entropy(lg, batch[f'label{i}'], global_sum)
                  for i, lg in enumerate(logits)]
        return losses, sum(a * l for a, l in zip(self.alphas, losses))

    def train_step(self, state, batch, iteration: int):
        """One SGD step at the lr of ``iteration`` (WarmupMultiStepLR with
        warmup_factor 1e-5, reference train.py:286).  Returns the state and
        ``{'total', 'head0', ...}`` (the global batch's) as device
        scalars."""
        opt = self.opt
        sched = warmup_multistep_lr(
            1.0, iteration, getattr(opt, 'lr_milestones', (4, 6)),
            gamma=getattr(opt, 'lr_gamma', 0.1),
            warmup_factor=getattr(opt, 'lr_warmup_factor', 1e-5),
            warmup_iters=getattr(opt, 'lr_warmup_iters', 5))
        model, optimizer = state['model'], state['optimizer']
        for g in optimizer.param_groups:
            g['lr'] = g['base_lr'] * sched
        model.train(self.train_bn)
        b = self.device_batch(batch)
        global_sum = parallel.global_sum if self.data_parallel else None
        with self.precision():
            losses, total = self._losses(self._logits(model, b), b,
                                         global_sum)
            optimizer.zero_grad(set_to_none=True)
            total.backward()
            if self.data_parallel:
                # the parameters with a gradient: the same on every rank
                parallel.sum_gradients([p.grad for p in model.parameters()
                                        if p.grad is not None])
            optimizer.step()
        metrics = {'total': total.detach()}
        for i, l in enumerate(losses):
            metrics[f'head{i}'] = l.detach()
        if global_sum is not None:
            # the ranks' shares summed: the global batch's losses
            summed = global_sum(torch.stack(list(metrics.values())))
            metrics = dict(zip(metrics, summed.unbind()))
        return dict(state, step=state['step'] + 1), metrics

    def eval_step(self, state, batch):
        """The forward on the running statistics: the heads' float32
        logits, their losses and the weighted total (device tensors)."""
        model = state['model'].eval()
        b = self.device_batch(batch)
        with torch.no_grad(), self.precision():
            logits = self._logits(model, b)
            losses, total = self._losses(logits, b)
        return logits, losses, total
