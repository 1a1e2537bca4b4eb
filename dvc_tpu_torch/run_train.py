"""Plain-PDVC training driver of the port (counterpart of the root
``train.py``; reference ``train.py:32-317``).

    python -m dvc_tpu_torch.run_train --cfg_path cfgs/yc2_tsp_pdvc.yml

(named ``run_train`` because ``train`` is the package of the ``Trainer``).
The same flags as ``train.py``; it trains on the card unless ``--device
cpu`` is given.  Any recipe of ``cfgs/`` whose model is plain PDVC: the
standard (LSTM-DSA), light or no caption head, 'queries',
'learnt_proposals' or two-stage 'gt_proposals' input.  Per epoch: the
batches of :class:`dvc_tpu_torch.data.BatchLoader` (``set_epoch`` reseeds
the shuffle), ``--steps_per_dispatch K`` optimizer steps at a time
(:meth:`Trainer.train_steps`, the trailing batches flushed one by one),
else one step a batch prefetched one step ahead under ``--device_prefetch
1``; the losses of a dispatch reach the host in one copy.  Every
``save_checkpoint_every`` epochs (from ``min_epoch_when_save``) it
validates: the captions of ``val_caption_file`` into ``epoch{N}.json``,
scored by ``dvc_tpu_torch.eval``; ``model-best.pth`` when the score
(``--criteria_for_best_ckpt dvc``: METEOR + soda_c; ``pc``: the paragraph
METEOR + CIDEr + Bleu_4) beats the best so far, then ``model-last.pth``,
``model-epoch{N}.pth`` under ``--save_all_checkpoint``, and ``info.json``
with ``val_history`` and ``loss_history``.  As ``train.py`` does, it backs
up ``cfgs/``, the package and the top-level ``.py`` files into
``<run>/backup`` at start, logs the option table into ``train.log``, and
writes ``metrics.jsonl`` (``utils/logging.py::MetricsWriter``): ``lr``,
``videos_per_sec`` and ``train/<loss>`` each epoch and ``val/<score>``
each validation, at the count of optimizer steps so far.  ``--start_from <id>
[--start_from_mode best|last]`` resumes a run; ``--pretrain
full|encoder|decoder --pretrain_path`` warm-starts a new one.
``--streaming_features 1 --video_folder <videos>`` featurizes the raw
videos in process (``data/streaming.py``: decode, then the TSP backbone
``--backbone_tsp`` with ``--tsp_checkpoint`` at ``--extraction_dtype`` on
the trainer's device) in place of reading ``.npy`` files; the train and
val sets share one extractor and its cache (``--streaming_cache``).
``DenseCaptioner(run_folder)`` serves the best checkpoint and
``dvc_tpu_torch.run_eval`` evaluates it.  ``--tpu_mesh_data N`` trains on
N data-parallel ranks, as ``new_train`` does (``dvc_tpu_torch.parallel``).
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from . import parallel
from .data import (BatchLoader, DenseCaptionDataset, DevicePrefetchLoader,
                   PrefetchLoader)
from .data.streaming import StreamingFeatureDataset
from .eval import evaluate
from .models import make_pdvc_model
from .new_train import pretrain, save_info_json
from .parallel import sync_metrics
from .serve import load_info_json
from .train import (Trainer, load_checkpoint, multistep_lr, save_checkpoint,
                    ss_prob_for_epoch)
from .utils.config import parse_opts
from .utils.logging import (MetricsWriter, backup_environment,
                            build_folder, create_logger, print_opt,
                            quiet_logger)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def host_losses(losses) -> dict:
    """The device losses of a step ({name: scalar}) or of a dispatch
    ({name: (K,)}) as host floats summed over the steps, in one
    device-to-host copy (counted in ``host_losses.copies``)."""
    host_losses.copies += 1
    stacked = torch.stack([v.float().reshape(-1) for v in losses.values()])
    return dict(zip(losses, stacked.sum(1).tolist()))


host_losses.copies = 0


def val_score(opt, scores) -> float:
    """The validation score that picks model-best
    (``--criteria_for_best_ckpt``, train.py:217-223)."""
    if opt.criteria_for_best_ckpt == 'dvc':
        return scores.get('METEOR', 0) + scores.get('soda_c', 0)
    return (scores.get('para_METEOR', 0) + scores.get('para_CIDEr', 0)
            + scores.get('para_Bleu_4', 0))


def main(opt, device=None):
    """Train ``opt``'s plain PDVC on ``--tpu_mesh_data`` ranks
    (``parallel.run``, as ``new_train.main``).  Returns (run folder, the
    last epoch's mean losses) of rank 0.  ``device`` defaults to
    ``opt.device`` (the card unless it says 'cpu')."""
    device = device or ('cpu' if opt.device == 'cpu' else 'cuda')
    if opt.streaming_features and not opt.video_folder:
        raise ValueError('--streaming_features requires --video_folder')
    return parallel.run(train, opt.tpu_mesh_data, opt.batch_size, device,
                        opt)


def train(device, opt):
    """The training of one rank on ``device`` (:func:`main`): its rows of
    every global batch; rank 0 alone logs, validates and writes the run
    folder while the other ranks wait."""
    is_main = parallel.is_main()
    save_folder = parallel.from_main(build_folder, opt)
    if is_main:
        logger = create_logger(save_folder)
        metrics = MetricsWriter(save_folder)
        backup_environment(save_folder, REPO)
    else:
        logger, metrics = quiet_logger(), None
    logger.info(f'save folder: {save_folder}')
    epoch, best_val_score, best_epoch = 0, -1e9, 0
    val_history, loss_history = {}, {}
    if opt.start_from:
        info = load_info_json(save_folder)
        if info is not None:
            epoch = info.get(opt.start_from_mode, {}).get('epoch', 0)
            best_val_score = info.get('best_val_score', -1e9)
            best_epoch = info.get('best', {}).get('epoch', epoch)
            val_history = info.get('val_history', {})
            loss_history = info.get('loss_history', {})

    if opt.streaming_features:
        # decode -> TSP features -> PDVC in one process (train.py:54-71);
        # validation shares the extractor and its cache
        train_ds = StreamingFeatureDataset(
            opt.train_caption_file, opt.video_folder, opt.dict_file, opt,
            seed=opt.seed, cache_size=opt.streaming_cache, device=device)
        val_ds = StreamingFeatureDataset(
            opt.val_caption_file, opt.video_folder, opt.dict_file, opt,
            seed=opt.seed, extractor=train_ds.extractor,
            cache_size=opt.streaming_cache)
    else:
        train_ds = DenseCaptionDataset(opt.train_caption_file,
                                       opt.visual_feature_folder,
                                       opt.dict_file, opt, seed=opt.seed)
        val_ds = DenseCaptionDataset(opt.val_caption_file,
                                     opt.visual_feature_folder, opt.dict_file,
                                     opt, seed=opt.seed)
    train_loader = BatchLoader(train_ds, opt.batch_size, True, opt,
                               seed=opt.seed,
                               part=(parallel.rank(), parallel.world()))
    val_loader = BatchLoader(val_ds, opt.batch_size_for_eval, False, opt)
    trainer = Trainer(opt, device=device,
                      model=make_pdvc_model(opt, device, seed=opt.seed))
    if opt.pretrain and not opt.start_from:
        pretrain(trainer, opt, logger)
    if opt.start_from:
        ck = load_checkpoint(os.path.join(
            save_folder, f'model-{opt.start_from_mode}.pth'), device)
        trainer.load_state(ck)
        epoch = int(ck['epoch'])
        logger.info(f'resuming from epoch {epoch}')
    parallel.broadcast_module(trainer.model)
    if is_main:
        print_opt(opt, logger)
    logger.info('Start training!')

    K = max(int(getattr(opt, 'steps_per_dispatch', 1)), 1)
    loss_avg, iteration = {}, 0
    while epoch < opt.epoch:
        train_loader.set_epoch(epoch)
        ss_prob = ss_prob_for_epoch(opt, epoch)
        lr = multistep_lr(opt, epoch)
        logger.info(f'epoch {epoch} lr {lr:.2e} ss_prob {ss_prob:.3f}')
        if K == 1 and opt.device_prefetch:
            # the next batch's upload during this step
            loader = DevicePrefetchLoader(train_loader, trainer.prepare_batch)
        else:
            # K batches are stacked per dispatch: collation ahead only
            loader = PrefetchLoader(train_loader)
        loss_sum, n, pending, t0 = {}, 0, [], time.time()

        def add(losses):
            for k, v in host_losses(losses).items():
                loss_sum[k] = loss_sum.get(k, 0.0) + v

        for batch, _ in loader:
            if opt.debug and n >= 5:
                break
            if K > 1:
                pending.append(batch)
                if len(pending) < K:
                    continue
                add(trainer.train_steps(pending, lr, ss_prob))
                pending = []
                n += K
            else:
                add(trainer.train_step(batch, lr, ss_prob))
                n += 1
        # the trailing batches of an epoch whose length is not a multiple
        # of K, one step each (train.py:174-182)
        for batch in pending:
            add(trainer.train_step(batch, lr, ss_prob))
            n += 1
        dt = time.time() - t0
        loss_avg = {k: round(v, 3) for k, v in sync_metrics(
            {k: v / max(n, 1) for k, v in loss_sum.items()}).items()}
        vps = n * opt.batch_size / max(dt, 1e-9)
        logger.info(f'epoch {epoch}: {loss_avg}, {dt:.1f}s '
                    f'({vps:.2f} videos/s)')
        # the optimizer steps so far (train.py:121-227): one a step, K a
        # dispatch
        iteration += n
        if is_main:
            metrics.add_scalar('lr', lr, iteration)
            metrics.add_scalar('videos_per_sec', vps, iteration)
            for k, v in sorted(loss_avg.items()):   # JAX's (a pytree's) order
                metrics.add_scalar(f'train/{k}', v, iteration)
        if opt.streaming_features:
            ex = train_ds.extractor
            logger.info(f'streaming so far: {ex.videos} videos, {ex.clips} '
                        f'clips; decode {ex.decode_seconds:.1f} s, backbone '
                        f'{ex.backbone_seconds:.1f} s (host clock, '
                        f'overlapping the steps)')
        loss_history[epoch] = loss_avg

        epoch += 1
        if epoch % opt.save_checkpoint_every or \
                epoch < opt.min_epoch_when_save:
            continue
        if is_main:     # rank 0 validates while the other ranks wait
            dvc_json_path = os.path.join(save_folder, f'epoch{epoch}.json')
            try:
                scores, _ = evaluate(trainer, val_loader, dvc_json_path,
                                     logger=logger, alpha=opt.ec_alpha,
                                     dvc_eval_version=opt.eval_tool_version,
                                     debug=opt.debug)
            except FileNotFoundError as e:
                logger.warning(f'skipping metric eval (missing gt): {e}')
                scores = None
            if scores is not None:
                current = val_score(opt, scores)
                val_history[epoch] = {k: float(v) for k, v in scores.items()
                                      if np.isscalar(v)}
                for k, v in val_history[epoch].items():
                    metrics.add_scalar(f'val/{k}', v, iteration)
                logger.info(f'epoch {epoch} val score {current:.4f} '
                            f'(best {best_val_score:.4f})')
                if current > best_val_score:
                    best_val_score, best_epoch = current, epoch
                    save_checkpoint(save_folder, 'best', trainer, epoch)
                    logger.info('new best checkpoint saved')
            save_checkpoint(save_folder, 'last', trainer, epoch)
            if opt.save_all_checkpoint:
                save_checkpoint(save_folder, f'epoch{epoch}', trainer, epoch)
            save_info_json(save_folder, {
                'best_val_score': best_val_score,
                'last': {'epoch': epoch, 'opt': opt.to_dict()},
                'best': {'epoch': best_epoch, 'opt': opt.to_dict()},
                'val_history': val_history, 'loss_history': loss_history})
        parallel.barrier()
    if is_main:
        metrics.close()
    logger.info('Training done.')
    return save_folder, loss_avg


if __name__ == '__main__':
    opt = parse_opts()
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    main(opt)
