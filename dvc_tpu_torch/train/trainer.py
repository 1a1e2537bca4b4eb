"""Training step, optimizer, LR schedule and checkpoints (port of
``dvc_tpu/train/trainer.py``; reference ``train.py:32-317``).

Adam/AdamW with global-norm gradient clipping and the epoch-level
MultiStepLR.  The JAX package runs optax's AdamW at lr 1 and scales the
update by lr; ``torch.optim.AdamW(lr=lr)`` gives the same update (decoupled
decay lr * wd * p, then lr * m_hat / (sqrt(v_hat) + 1e-8)), and the 'adam'
branch's ``add_decayed_weights`` before Adam is ``torch.optim.Adam``'s
``weight_decay``.  Clipping follows ``optax.clip_by_global_norm`` exactly
(gradients scaled by max_norm / norm when norm >= max_norm; torch's
``clip_grad_norm_`` would add 1e-6 to the norm).

The model is a FusionPDVC by default (``new_train``) or the one passed in
(``run_train``: a plain PDVC).  Batches reach the device through
:meth:`Trainer.prepare_batch` (on a CUDA device: pinned host tensors copied
on the trainer's copy stream, an event the step waits on), which
``data.DevicePrefetchLoader`` calls one batch ahead.
:meth:`Trainer.train_steps` runs K optimizer steps in a row with no host
synchronisation between them (``--steps_per_dispatch K``).

Under ``--tpu_compute_dtype bfloat16`` / ``--fusion_dtype bfloat16`` the
step is the same: the parameters, their gradients and the optimizer state
stay f32, and the modules cast to bf16 where the flax layers' ``dtype``
does, so autograd carries the gradients back to the f32 parameters (no
``torch.autocast``, whose per-op rules round at other points).

Checkpoints are ``model-{tag}.pth``: the model's ``state_dict`` in the
reference layout (``load_state_dict(strict=True)`` reads it; the serving
``DenseCaptioner`` too), the optimizer state, the epoch and step, and any
extra entries (the visited videos of a mid-epoch save).
:func:`filtered_restore` warm-starts the (plain or fused) PDVC from a
plain-PDVC ``state_dict`` (``--pretrain``).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..models import make_fusion_model
from ..models.criterion import build_weight_dict


def multistep_lr(opt, epoch: int) -> float:
    """MultiStepLR(milestones=start + every*k, gamma) (reference train.py:128)."""
    start = opt.learning_rate_decay_start
    every = opt.learning_rate_decay_every
    gamma = opt.learning_rate_decay_rate
    n_milestones = int((opt.epoch - start) / every) if every > 0 else 0
    milestones = [start + every * k for k in range(max(n_milestones, 0))]
    passed = sum(1 for m in milestones if epoch >= m)
    return opt.lr * (gamma ** passed)


def ss_prob_for_epoch(opt, epoch: int) -> float:
    """Scheduled-sampling ramp (reference train.py:152-156)."""
    if opt.scheduled_sampling_start >= 0 and epoch > opt.scheduled_sampling_start:
        frac = ((epoch - opt.scheduled_sampling_start)
                // opt.scheduled_sampling_increase_every)
        return min(opt.basic_ss_prob
                   + opt.scheduled_sampling_increase_prob * frac,
                   opt.scheduled_sampling_max_prob)
    return 0.0


def make_optimizer(opt, params):
    if opt.optimizer_type == 'adamw':
        return torch.optim.AdamW(params, lr=opt.lr, eps=1e-8,
                                 weight_decay=opt.weight_decay)
    return torch.optim.Adam(params, lr=opt.lr, eps=1e-8,
                            weight_decay=opt.weight_decay)


@torch.no_grad()
def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place, without a host sync."""
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    torch._foreach_mul_(grads, torch.where(norm < max_norm, 1.0,
                                           max_norm / norm))


def bucket_caption_length(batch, multiple: int = 8, floor: int = 0):
    """Slice the caption tensors to the batch's longest caption (at least
    ``floor``) rounded up to ``multiple``: the teacher-forcing scan then
    runs only as many word steps as needed, and a few lengths recur.
    Exactly equivalent: the dropped steps are fully masked."""
    cap_mask = np.asarray(batch['cap_mask'])
    Lc = cap_mask.shape[-1]
    longest = int(cap_mask.sum(-1).max()) if cap_mask.size else Lc
    longest = max(longest, floor)
    bucket = min(max(-(-max(longest, 2) // multiple) * multiple, 2), Lc)
    if bucket == Lc:
        return batch
    out = dict(batch)
    out['cap_tensor'] = np.asarray(batch['cap_tensor'])[..., :bucket]
    out['cap_mask'] = cap_mask[..., :bucket]
    return out


class Trainer:
    """One model, its optimizer and the dropout generator, on ``device``
    (the card unless the caller asks for the CPU): ``model`` (moved to the
    device, as the JAX ``Trainer(opt, model=...)`` takes one), else the
    FusionPDVC of ``opt`` with seeded weights."""

    def __init__(self, opt, device='cuda', model=None):
        self.opt = opt
        self.device = torch.device(device)
        if model is None:
            model = make_fusion_model(opt, self.device, seed=opt.seed)
        self.model = model.to(self.device).train()
        self.params = list(self.model.parameters())   # aliases once
        self.weight_dict = build_weight_dict(opt)
        self.optimizer = make_optimizer(opt, self.params)
        # dropout masks come from the trainer's own generator, the eval
        # decode's draws (--caption_sample_max 0) from another
        self.gen = torch.Generator(device=self.device).manual_seed(
            opt.seed + 1)
        self.sample_gen = torch.Generator(device=self.device).manual_seed(
            opt.seed)
        # uploads run on a stream of their own, so that the next batch's
        # copy overlaps the current step
        self.copy_stream = (torch.cuda.Stream(self.device)
                            if self.device.type == 'cuda' else None)
        self.step = 0

    def prepare_batch(self, batch):
        """Caption-length bucketing, then :meth:`prepare_eval_batch`."""
        if getattr(self.opt, 'caption_len_bucketing', 1):
            batch = bucket_caption_length(batch)
        return self.prepare_eval_batch(batch)

    def prepare_eval_batch(self, batch):
        """The arrays of a collated numpy batch as tensors on the device,
        with no caption-length bucketing (eval decodes a fixed length),
        marked ``_prepared``.  On a CUDA device they are copied from pinned
        host tensors without blocking, on the trainer's copy stream, and
        ``_ready`` holds the event that the step waits on before it reads
        them; each device tensor is recorded on the compute stream, so the
        caching allocator keeps its memory until the step is done.  On the
        CPU the arrays are wrapped as they are."""
        if self.copy_stream is None:
            out = {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()}
        else:
            host = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                    for k, v in batch.items()}
            compute = torch.cuda.current_stream(self.device)
            with torch.cuda.stream(self.copy_stream):
                out = {k: v.to(self.device, non_blocking=True)
                       for k, v in host.items()}
                ready = torch.cuda.Event()
                ready.record(self.copy_stream)
            for v in out.values():
                v.record_stream(compute)
            out['_ready'] = ready
        out['_prepared'] = True
        return out

    def _device_batch(self, batch, prepare):
        """A batch of ``prepare`` (given one that is not prepared yet)
        without its marks, with the compute stream waiting for its
        upload."""
        batch = dict(batch)
        if not batch.pop('_prepared', False):
            batch = prepare(batch)
            batch.pop('_prepared')
        ready = batch.pop('_ready', None)
        if ready is not None:
            torch.cuda.current_stream(self.device).wait_event(ready)
        return batch

    def eval_step(self, batch):
        """The eval forward (no dropout) on a collated numpy batch or one
        of :meth:`prepare_eval_batch`: (outputs, losses) as device tensors
        (:meth:`PDVC.forward_eval`; a sampling decode draws from the
        trainer's ``sample_gen``)."""
        batch = self._device_batch(batch, self.prepare_eval_batch)
        with torch.inference_mode():
            return self.model.forward_eval(batch, self.sample_gen)

    def total_loss(self, losses):
        return sum(losses[k] * w for k, w in self.weight_dict.items()
                   if k in losses and w)

    def train_step(self, batch, lr: float, ss_prob: float = 0.0):
        """One optimizer step on a collated numpy batch or one of
        :meth:`prepare_batch`.  Returns the losses (detached device
        tensors) with 'total_loss'."""
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        batch = self._device_batch(batch, self.prepare_batch)
        _, losses = self.model.forward_train(batch, self.gen, ss_prob)
        total = self.total_loss(losses)
        self.optimizer.zero_grad(set_to_none=False)
        total.backward()
        for p in self.params:
            # an unused parameter still decays, as under optax
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in self.params], self.opt.grad_clip)
        self.optimizer.step()
        self.step += 1
        losses = {k: v.detach() for k, v in losses.items()}
        losses['total_loss'] = total.detach()
        return losses

    def train_steps(self, batches, lr: float, ss_prob: float = 0.0):
        """K optimizer steps in a row on K collated numpy batches (the JAX
        ``train_steps``, ``--steps_per_dispatch K``): one caption bucket
        for the whole stack, the longest caption of the K batches, and no
        host synchronisation between the steps.  Returns the losses of
        :meth:`train_step`, each stacked (K,) on the device."""
        if getattr(self.opt, 'caption_len_bucketing', 1):
            floor = max(int(np.asarray(b['cap_mask']).sum(-1).max())
                        for b in batches)
            batches = [bucket_caption_length(b, floor=floor)
                       for b in batches]
        steps = [self.train_step(self.prepare_eval_batch(b), lr, ss_prob)
                 for b in batches]
        return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}

    def state(self):
        return {'model': self.model.state_dict(),
                'optimizer': self.optimizer.state_dict(), 'step': self.step}

    def load_state(self, ck):
        self.model.load_state_dict(ck['model'], strict=True)
        self.optimizer.load_state_dict(ck['optimizer'])
        self.step = int(ck.get('step', 0))


def save_checkpoint(save_dir: str, tag: str, trainer: Trainer, epoch: int,
                    extra: dict | None = None) -> str:
    """``model-{tag}.pth`` in save_dir, written atomically."""
    os.makedirs(save_dir, exist_ok=True)
    payload = {**trainer.state(), 'epoch': epoch, **(extra or {})}
    path = os.path.join(save_dir, f'model-{tag}.pth')
    torch.save(payload, path + '.tmp')
    os.replace(path + '.tmp', path)
    return path


def load_checkpoint(path: str, device='cpu') -> dict:
    """A checkpoint written by :func:`save_checkpoint` (tensors, numbers and
    strings only, so it loads with ``weights_only``)."""
    return torch.load(path, map_location=device, weights_only=True)


# The parameters of a partial restore (reference pdvc.py:103-108): the JAX
# package's ENCODER_KEYS ('base_encoder', 'encoder_layer_', 'level_embed',
# 'input_proj'; the last lies inside the base encoder) in this package's
# module names.
ENCODER_KEYS = ('base_encoder.', 'transformer.encoder.',
                'transformer.level_embed')


def is_encoder_param(name: str) -> bool:
    """Whether a PDVC state_dict key is an encoder parameter."""
    return name.startswith(ENCODER_KEYS)


@torch.no_grad()
def filtered_restore(model, pdvc_state: dict, which: str):
    """Warm-start ``model``'s PDVC (a plain PDVC, or a FusionPDVC's
    ``pdvcModel.*``) from a plain PDVC state_dict (reference
    train.py:101-118): ``which`` 'full' takes every PDVC parameter (each
    must be in the source), 'encoder' the encoder's
    (:func:`is_encoder_param`) and 'decoder' the rest, each where the
    source has it.  Returns the restored keys."""
    if which not in ('full', 'encoder', 'decoder'):
        raise ValueError(f'--pretrain {which!r}: full, encoder or decoder')
    state = model.state_dict()
    prefix = ('pdvcModel.' if any(k.startswith('pdvcModel.') for k in state)
              else '')
    taken = []
    for key in state:
        if not key.startswith(prefix):
            continue
        name = key[len(prefix):]
        if which != 'full' and is_encoder_param(name) != (which == 'encoder'):
            continue
        if name not in pdvc_state:
            if which == 'full':
                raise KeyError(f'--pretrain full: {name} is not in the '
                               'source checkpoint')
            continue
        value = torch.as_tensor(np.asarray(pdvc_state[name]))
        if value.shape != state[key].shape:
            raise ValueError(f'--pretrain: {name} is {tuple(value.shape)} in '
                             f'the source, {tuple(state[key].shape)} here')
        state[key] = value
        taken.append(key)
    model.load_state_dict(state, strict=True)
    return taken
