"""Audio-visual fusion training driver of the port (counterpart of
``newTrain.py``; reference ``newTrain.py:74-544``).

    python -m dvc_tpu_torch.new_train --cfg_path cfgs/yc2_newModel_sound.yml

The same flags as ``newTrain.py`` (the port's own ``parse_opts``).  It
trains on the card unless ``--device cpu`` is given, and keeps the
reference's restarts: visited video keys are checkpointed every
``--ckpt_every_batches`` batches and skipped after ``--start_from``.
``--debug`` caps an epoch at 5 batches (and a validation at 6 videos).
Under ``--device_prefetch 1`` (the default) batches are collated in a
worker thread and uploaded one step ahead (``data.DevicePrefetchLoader``).
``--pretrain full|encoder|decoder`` warm-starts the PDVC from the
plain-PDVC checkpoint ``--pretrain_path`` when not resuming.  With
``--sound_feature_folder`` it builds a ``HubertExtractor`` that caches
there, as ``newTrain.py`` does; given no audio folder, as there, the
sound stream reads the cache or zeros.
Every ``save_checkpoint_every`` epochs it validates as ``newTrain.py``
does: the greedy captions of ``val_caption_file`` into ``epoch{N}.json``,
scored against ``gt_file_for_eval`` and ``gt_file_for_para_eval``
(``dvc_tpu_torch.eval``); ``model-best.pth`` when METEOR + soda_c beats
the best so far, then ``model-last.pth`` and ``info.json`` (with
``val_history`` and ``best_val_score``).  ``DenseCaptioner(run_folder)``
serves the best.

``--tpu_mesh_data N`` trains on N data-parallel ranks, one process a card
(``dvc_tpu_torch.parallel``; NCCL, or gloo under ``--device cpu``): the
JAX data mesh's global-batch step, each rank collating its rows of every
global batch of ``batch_size``.  Without ``torchrun`` the driver spawns the
ranks itself; ``torchrun --nproc_per_node N -m dvc_tpu_torch.new_train
... --tpu_mesh_data N`` runs one.  Rank 0 alone logs, validates and writes
the run folder.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from . import parallel
from .data import DevicePrefetchLoader, FusionBatchLoader, FusionDataset
from .data.audio import HubertExtractor
from .eval import evaluate
from .parallel import sync_metrics
from .serve import load_info_json, load_pdvc_weights
from .train import (Trainer, filtered_restore, load_checkpoint, multistep_lr,
                    save_checkpoint, ss_prob_for_epoch)
from .utils.config import parse_opts
from .utils.logging import build_folder, create_logger, quiet_logger


def save_info_json(save_dir: str, info: dict):
    with open(os.path.join(save_dir, 'info.json'), 'w') as f:
        json.dump(info, f, indent=1, default=str)


def pretrain(trainer, opt, logger=None):
    """``--pretrain full|encoder|decoder``: warm-start the trainer's PDVC
    (a FusionPDVC's, or a plain one's in ``run_train``) from the
    plain-PDVC checkpoint ``--pretrain_path`` (newTrain.py:65-77;
    :func:`dvc_tpu_torch.serve.load_pdvc_weights`,
    :func:`dvc_tpu_torch.train.filtered_restore`).  Returns the restored
    keys."""
    if logger:
        logger.info(f'loading pretrained PDVC ({opt.pretrain}) from '
                    f'{opt.pretrain_path}')
    return filtered_restore(trainer.model, load_pdvc_weights(
        opt.pretrain_path), opt.pretrain)


def main(opt, device=None):
    """Train ``opt``'s FusionPDVC on ``--tpu_mesh_data`` ranks
    (``parallel.run``: one process a card, spawned here or by
    ``torchrun``; at 1 this process, with no group).  Returns (run folder,
    the last epoch's mean losses) of rank 0.  ``device`` defaults to
    ``opt.device`` (the card unless it says 'cpu')."""
    device = device or ('cpu' if opt.device == 'cpu' else 'cuda')
    return parallel.run(train, opt.tpu_mesh_data, opt.batch_size, device,
                        opt)


def train(device, opt):
    """The training of one rank on ``device`` (:func:`main`): its rows of
    every global batch; rank 0 alone logs, validates and writes the run
    folder while the other ranks wait."""
    is_main = parallel.is_main()
    save_folder = parallel.from_main(build_folder, opt)
    logger = create_logger(save_folder) if is_main else quiet_logger()
    # the extractor of newTrain.py:43-47: given no audio_folder, as there,
    # it extracts nothing and the cache or zeros feed the sound stream
    extractor = (HubertExtractor(cache_dir=opt.sound_feature_folder,
                                 device=device)
                 if opt.sound_feature_folder else None)
    train_ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                             opt.dict_file, opt, seed=opt.seed,
                             extractor=extractor, is_training=True)
    val_ds = FusionDataset(opt.val_caption_file, opt.visual_feature_folder,
                           opt.dict_file, opt)
    val_loader = FusionBatchLoader(val_ds, opt.batch_size_for_eval, False, opt)
    trainer = Trainer(opt, device=device)
    visited, epoch = set(), 0
    best_val_score, val_history = -1e9, {}
    if opt.pretrain and not opt.start_from:
        pretrain(trainer, opt, logger)

    info = load_info_json(save_folder) if opt.start_from else None
    if opt.start_from and info is not None:
        ck = load_checkpoint(
            os.path.join(save_folder, f'model-{opt.start_from_mode}.pth'),
            device)
        trainer.load_state(ck)
        epoch = int(ck['epoch'])
        visited = set(ck.get('visited_videos', []))
        best_val_score = info.get('best_val_score', -1e9)
        val_history = info.get('val_history', {})
        logger.info(f'resumed epoch {epoch}, {len(visited)} videos visited')
    parallel.broadcast_module(trainer.model)

    ckpt_every = getattr(opt, 'ckpt_every_batches', 100)
    loss_avg = {}
    while epoch < opt.epoch:
        lr = multistep_lr(opt, epoch)
        ss_prob = ss_prob_for_epoch(opt, epoch)
        loader = FusionBatchLoader(train_ds, opt.batch_size, True, opt,
                                   seed=opt.seed + epoch, skip_keys=visited,
                                   part=(parallel.rank(), parallel.world()))
        if opt.device_prefetch:
            # collation in a worker thread, the next batch's upload during
            # this step (newTrain.py:97-99)
            loader = DevicePrefetchLoader(loader, trainer.prepare_batch)
        n, loss_sum, t0 = 0, {}, time.time()
        for batch, meta in loader:
            if opt.debug and n >= 5:
                break
            losses = trainer.train_step(batch, lr, ss_prob)
            visited.update(meta['keys'])        # the global batch's
            # one copy to the host for all the losses
            for k, v in zip(losses, torch.stack(
                    [v.float() for v in losses.values()]).tolist()):
                loss_sum[k] = loss_sum.get(k, 0.0) + v
            n += 1
            if n % ckpt_every == 0 and is_main:
                save_checkpoint(save_folder, 'last', trainer, epoch,
                                extra={'visited_videos': sorted(visited)})
        visited.clear()  # full epoch done
        loss_avg = sync_metrics({k: v / max(n, 1)
                                 for k, v in loss_sum.items()})
        logger.info(f'epoch {epoch}: {n} steps, '
                    f'{ {k: round(v, 3) for k, v in loss_avg.items()} } '
                    f'({time.time() - t0:.1f}s)')
        epoch += 1
        if epoch % opt.save_checkpoint_every == 0:
            if is_main:     # rank 0 validates while the other ranks wait
                dvc_json_path = os.path.join(save_folder,
                                             f'epoch{epoch}.json')
                try:
                    scores, _ = evaluate(
                        trainer, val_loader, dvc_json_path, logger=logger,
                        alpha=opt.ec_alpha,
                        dvc_eval_version=opt.eval_tool_version,
                        debug=opt.debug)
                except FileNotFoundError as e:
                    logger.warning(f'skipping metric eval: {e}')
                    scores = None
                if scores is not None:
                    current = (scores.get('METEOR', 0)
                               + scores.get('soda_c', 0))
                    val_history[epoch] = {k: float(v) for k, v in
                                          scores.items() if np.isscalar(v)}
                    logger.info(f'epoch {epoch} validation: METEOR + soda_c '
                                f'{current:.4f} (best {best_val_score:.4f})')
                    if current > best_val_score:
                        best_val_score = current
                        save_checkpoint(save_folder, 'best', trainer, epoch)
                save_checkpoint(save_folder, 'last', trainer, epoch)
                # 'best' names the current epoch at every save, as
                # newTrain.py writes it
                save_info_json(save_folder, {
                    'best_val_score': best_val_score,
                    'val_history': val_history,
                    'last': {'epoch': epoch, 'opt': opt.to_dict()},
                    'best': {'epoch': epoch, 'opt': opt.to_dict()}})
            parallel.barrier()
    logger.info('Training done.')
    return save_folder, loss_avg


if __name__ == '__main__':
    opt = parse_opts()
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    main(opt)
