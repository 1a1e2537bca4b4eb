"""TSP backbone training driver of the port (counterpart of the root
``train_tsp.py``; reference ``video_backbone/TSP/train/train.py`` and the
``train_tsp_on_{activitynet,thumos14,yc2}.sh`` launchers).

    python -m dvc_tpu_torch.train_tsp \\
        --train-csv yc2_train_tsp_groundtruth.csv \\
        --valid-csv yc2_valid_tsp_groundtruth.csv --backbone r2plus1d_34 \\
        --batch-size 32 --backbone-lr 1e-4 --fc-lr 2e-3 [--device cpu]

The same flags and defaults as ``train_tsp.py``, and the same batches from
the same ``--seed``: each epoch samples ``--clips-per-segment`` clips per
groundtruth segment (jittered by the sampler's own RandomState, whose
first draws the probe batch takes before epoch 0), shuffles them with one
``np.random.default_rng(seed)`` that also draws the crop offsets and
flips, drops the remainder and collates in a worker thread
(``data/prefetch.py::PrefetchLoader``; pinned clips on the card).  Every
epoch ends with a validation on the uniform clip grid (padded with label
-1) whose per-head accuracy meters pick ``tsp-best.pth``.  Checkpoints are
``torch.save({'model', 'optimizer', 'epoch', 'iteration', 'best_acc',
'args'})``, which ``extract_features --local-checkpoint`` and a streaming
recipe's ``tsp_checkpoint`` read; ``--resume`` takes one, or a JAX
``tsp-last.ckpt`` (weights and SGD momentum converted).  ``metrics.jsonl``
and ``results.txt`` have the JAX driver's lines.

The card by default (``--device cpu`` for the CPU).  ``--mesh-data N``
trains on N data-parallel ranks, one process a card (``dvc_tpu_torch.
parallel``; spawned here, or one each under ``torchrun --nproc_per_node
N``): the JAX data mesh's global-batch step, each rank decoding its rows
of every global batch (the crop and flip draws of all rows made on every
rank), BatchNorm under ``--train-bn 1`` on the global batch's statistics.
Rank 0 alone prints, validates and writes ``--output-dir``.
"""

from __future__ import annotations

import argparse
import builtins
import json
import os
import time

import numpy as np
import torch

from . import parallel
from .data.prefetch import PrefetchLoader
from .data.video_clips import (BACKBONE_INPUT, SegmentClipSampler,
                               decode_clip, load_segment_table)
from .models.tsp import tsp_from_jax_params, tsp_momentum_from_jax
from .models.tsp.model import GVF_DIM
from .parallel import sync_metrics
from .train.tsp_trainer import TSPTrainer
from .utils.config import load_config


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--train-csv', type=str, required=True)
    p.add_argument('--valid-csv', type=str, default=None,
                   help='validation groundtruth CSV; enables the per-epoch '
                        'accuracy evaluation + best checkpoint '
                        '(reference train.py:89-117)')
    p.add_argument('--root-dir', type=str, default='',
                   help='prefix for CSV filenames (reference --root-dir)')
    p.add_argument('--backbone', type=str, default='mvit_v2_s')
    p.add_argument('--clip-len', type=int, default=16)
    p.add_argument('--frame-rate', type=float, default=15)
    p.add_argument('--clips-per-segment', type=int, default=5,
                   help='clips sampled per CSV segment per epoch '
                        '(reference opts.py default 5)')
    p.add_argument('--no-temporal-jitter', action='store_true',
                   help='disable the train-time uniform-random in-segment '
                        'clip position (reference temporal_jittering=True '
                        'for training)')
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--epochs', type=int, default=8)
    p.add_argument('--backbone-lr', type=float, default=1e-5)
    p.add_argument('--fc-lr', type=float, default=5e-5)
    p.add_argument('--lr-milestones', type=int, nargs='+', default=[4, 6])
    p.add_argument('--lr-gamma', type=float, default=0.01,
                   help='reference TSP opts.py default 0.01')
    p.add_argument('--lr-warmup-epochs', type=int, default=2)
    p.add_argument('--momentum', type=float, default=0.9)
    p.add_argument('--weight-decay', type=float, default=0.005)
    p.add_argument('--dtype', type=str, default='float32',
                   choices=['float32', 'bfloat16'],
                   help='bfloat16 = bf16 compute with f32 master weights')
    p.add_argument('--train-bn', type=int, default=0,
                   help='train BatchNorm on batch statistics and update '
                        'its running stats (flax semantics)')
    p.add_argument('--label-columns', type=str, nargs='+',
                   default=['action-label', 'temporal-region-label'])
    p.add_argument('--label-mapping-jsons', type=str, nargs='*', default=[],
                   help='per label column, a JSON list mapping category '
                        'strings to ids by position (reference '
                        'train.py:134-138); omit for numeric labels')
    p.add_argument('--loss-alphas', type=float, nargs='+', default=[1.0, 1.0])
    p.add_argument('--global-video-features', type=str, default=None,
                   help='h5 of per-video global features for the second '
                        'head (reference TSP GVF, model.py:39-40)')
    p.add_argument('--output-dir', type=str, default='save/tsp')
    p.add_argument('--resume', type=str, default='',
                   help='checkpoint to resume from: a tsp-*.pth of the '
                        'port or a JAX tsp-*.ckpt (reference '
                        'train.py:329-335)')
    p.add_argument('--start-epoch', type=int, default=0)
    p.add_argument('--valid-only', action='store_true')
    p.add_argument('--train-only-one-epoch', action='store_true')
    p.add_argument('--print-freq', type=int, default=100)
    p.add_argument('--mesh-data', type=int, default=1,
                   help='data-parallel ranks, one process a card; the '
                        'batch size is the global batch\'s')
    p.add_argument('--seed', type=int, default=777)
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='the card (default) or the CPU')
    return p.parse_args(argv)


def load_clip_rows(path, label_columns):
    """Legacy clip-window tables (one fixed clip per row, t-start only).
    The segment regime (``load_segment_table``) supersedes this; kept for
    CSVs produced by older ``make_tsp_groundtruth.py --mode clips`` runs."""
    import csv
    with open(path) as f:
        rows = list(csv.DictReader(f))
    clips = []
    for r in rows:
        labels = [int(float(r.get(c, -1) or -1)) for c in label_columns]
        clips.append(dict(filename=r['filename'],
                          t_start=float(r.get('t-start',
                                              r.get('clip-t-start', 0))),
                          labels=labels))
    return clips


def load_label_mappings(paths):
    mappings = []
    for p in paths:
        with open(p) as f:
            names = json.load(f)
        mappings.append(dict(zip(names, range(len(names)))))
    return mappings


class HeadMeters:
    """Per-head accuracy/loss meters (reference common/utils.py:162-178 +
    train.py:21-48): accuracy in percent, sample-count weighted over the
    labeled (!= -1) examples; losses averaged per batch."""

    def __init__(self, label_columns):
        self.cols = list(label_columns)
        self.correct = np.zeros(len(self.cols))
        self.counts = np.zeros(len(self.cols))
        self.loss_sums = np.zeros(len(self.cols) + 1)
        self.loss_n = 0

    def update(self, logits, labels, head_losses, total_loss):
        for i, (lg, lab) in enumerate(zip(logits, labels)):
            mask = lab >= 0
            if mask.any():
                pred = np.argmax(lg[mask], axis=-1)
                self.correct[i] += (pred == lab[mask]).sum()
                self.counts[i] += mask.sum()
            self.loss_sums[i] += float(head_losses[i])
        self.loss_sums[-1] += float(total_loss)
        self.loss_n += 1

    def sync(self):
        """The meters across processes (the reference's
        ``metric_logger.synchronize_between_processes``): the identity,
        since rank 0 validates the whole validation set alone."""

    def accuracy(self, i):
        return 100.0 * self.correct[i] / max(self.counts[i], 1)

    def avg_accuracy(self):
        return float(np.mean([self.accuracy(i)
                              for i in range(len(self.cols))]))

    def results_line(self, epoch):
        s = f'** Valid Epoch {epoch}: '
        for i, col in enumerate(self.cols):
            s += (f' <{col}> Accuracy {self.accuracy(i):.3f}'
                  f' Loss {self.loss_sums[i] / max(self.loss_n, 1):.3f};')
        s += f' Total Loss {self.loss_sums[-1] / max(self.loss_n, 1):.3f}'
        s += f' Avg Accuracy {self.avg_accuracy():.3f}'
        return s


def vid_key(filename):
    return os.path.splitext(os.path.basename(filename))[0][:13]


def read_resume(path):
    """(weights, SGD state, momentum buffers, the checkpoint) of a port
    ``.pth`` (its optimizer's state dict) or a JAX ``.ckpt`` (its momentum
    converted; read without JAX)."""
    if path.endswith('.pth'):
        ck = torch.load(path, map_location='cpu', weights_only=True)
        return ck['model'], ck['optimizer'], None, ck
    from .serve import load_checkpoint
    ck = load_checkpoint(path)
    return (tsp_from_jax_params(ck['variables']), None,
            tsp_momentum_from_jax(ck['opt_state']), ck)


def main(argv=None):
    """Runs the driver on ``--mesh-data`` ranks (``parallel.run``);
    returns rank 0's final trainer state (each rank's own under
    ``torchrun``)."""
    args = parse_args(argv)
    return parallel.run(train, args.mesh_data, args.batch_size, args.device,
                        args)


def train(device, args):
    """The driver on one rank's ``device``: its rows of every global
    batch; rank 0 alone prints, validates and writes the output folder
    while the other ranks wait.  Returns the rank's final state."""
    is_main = parallel.is_main()
    # only rank 0 speaks
    print = builtins.print if is_main else (lambda *a, **k: None)
    if is_main:
        os.makedirs(args.output_dir, exist_ok=True)
    mappings = (load_label_mappings(args.label_mapping_jsons)
                if args.label_mapping_jsons else None)
    segments = load_segment_table(
        args.train_csv, args.label_columns, args.clip_len, args.frame_rate,
        root_dir=args.root_dir, label_mappings=mappings)
    n_heads = len(args.label_columns)
    if mappings:
        n_classes = tuple(max(len(m), 2) for m in mappings)
    else:
        n_classes = tuple(
            max(max((s.labels[i] for s in segments), default=0) + 1, 2)
            for i in range(n_heads))
    print(f'{len(segments)} train segments x {args.clips_per_segment} '
          f'clips, heads {n_heads}, classes {n_classes}')
    valid_segments = None
    if args.valid_csv:
        valid_segments = load_segment_table(
            args.valid_csv, args.label_columns, args.clip_len,
            args.frame_rate, root_dir=args.root_dir, label_mappings=mappings)
        print(f'{len(valid_segments)} valid segments')

    gvf_table = {}
    if args.global_video_features:
        import h5py
        with h5py.File(args.global_video_features, 'r') as f:
            gvf_table = {k: np.asarray(f[k]) for k in f.keys()}
        print(f'loaded {len(gvf_table)} global video features')
    gvf_dim = (next(iter(gvf_table.values())).shape[-1] if gvf_table
               else GVF_DIM)

    opt = load_config(backbone_tsp=args.backbone,
                      tsp_num_classes=n_classes, tsp_num_heads=n_heads,
                      loss_alphas=args.loss_alphas,
                      backbone_lr=args.backbone_lr, fc_lr=args.fc_lr,
                      momentum=args.momentum,
                      global_video_features=args.global_video_features,
                      tsp_weight_decay=args.weight_decay,
                      tsp_train_bn=args.train_bn, tsp_dtype=args.dtype,
                      tpu_mesh_data=args.mesh_data)
    steps_per_epoch = max(
        len(segments) * args.clips_per_segment // args.batch_size, 1)
    opt.lr_milestones = tuple(m * steps_per_epoch
                              for m in args.lr_milestones)
    opt.lr_gamma = args.lr_gamma
    opt.lr_warmup_iters = args.lr_warmup_epochs * steps_per_epoch

    trainer = TSPTrainer(opt, device, gvf_dim=gvf_dim)
    pin = trainer.device.type == 'cuda'
    spec = BACKBONE_INPUT[args.backbone]
    rng = np.random.default_rng(args.seed)
    rh, rw = spec['resize']
    ch, cw = spec['crop']

    def make_batch(items, train, part=slice(0, args.batch_size)):
        """items: list of (segment, clip_t_start). Train applies
        RandomHorizontalFlip + RandomCrop (reference train.py:155-177);
        eval center-crops. Remainder padding carries label -1 everywhere so
        padded rows drop out of both the CE (ignore_index) and the
        accuracy meters.  Only the rows ``part`` (a data-parallel rank's)
        are decoded; every row's draws are made, as in one process."""
        xs = []
        for j, (seg, t) in enumerate(items):
            if train:
                off = (int(rng.integers(0, rh - ch + 1)),
                       int(rng.integers(0, rw - cw + 1)))
                flip = bool(rng.integers(2))
            else:
                off, flip = None, False
            if part.start <= j < part.stop:
                xs.append(decode_clip(seg.filename, t, args.clip_len,
                                      args.frame_rate, spec['resize'],
                                      spec['crop'], flip=flip,
                                      crop_offset=off))
        items, size = items[part], part.stop - part.start
        while len(xs) < size:
            xs.append(np.zeros_like(xs[0]))
        clip = torch.from_numpy(np.stack(xs))
        batch = {'clip': clip.pin_memory() if pin else clip}
        if gvf_table:
            gvf = [gvf_table.get(vid_key(seg.filename),
                                 np.zeros(gvf_dim, np.float32))
                   for seg, _ in items]
            gvf += [np.zeros(gvf_dim, np.float32)] * (size - len(items))
            batch['gvf'] = torch.from_numpy(
                np.stack(gvf).astype(np.float32))
        for i in range(n_heads):
            labels = [seg.labels[i] for seg, _ in items]
            labels += [-1] * (size - len(items))
            batch[f'label{i}'] = torch.tensor(labels, dtype=torch.int64)
        return batch

    def evaluate(state, epoch):
        """Per-epoch validation with the per-head accuracy meters
        (reference train.py:89-117); clips on the uniform grid
        (temporal_jittering=False).  Rank 0's alone."""
        sampler = SegmentClipSampler(
            valid_segments, args.clip_len, args.frame_rate,
            args.clips_per_segment, temporal_jittering=False)
        meters = HeadMeters(args.label_columns)
        idxs = np.arange(len(sampler))

        def batches():
            for i in range(0, len(idxs), args.batch_size):
                yield make_batch([sampler.clip_at(j) for j in
                                  idxs[i:i + args.batch_size]], train=False)

        for batch in PrefetchLoader(batches()):
            logits, losses, total = trainer.eval_step(state, batch)
            meters.update([lg.cpu().numpy() for lg in logits],
                          [batch[f'label{k}'].numpy()
                           for k in range(n_heads)],
                          [float(l) for l in losses], float(total))
        meters.sync()
        line = meters.results_line(epoch)
        print(line)
        with open(os.path.join(args.output_dir, 'results.txt'), 'a') as f:
            f.write(line + '\n')
        return meters.avg_accuracy()

    def save_ckpt(state, name, epoch, it, best_acc):
        payload = {'model': state['model'].state_dict(),
                   'optimizer': state['optimizer'].state_dict(),
                   'epoch': epoch, 'iteration': it, 'best_acc': best_acc,
                   'args': vars(args)}
        tmp = os.path.join(args.output_dir, name + '.tmp')
        torch.save(payload, tmp)
        os.replace(tmp, os.path.join(args.output_dir, name))

    sampler = SegmentClipSampler(
        segments, args.clip_len, args.frame_rate, args.clips_per_segment,
        temporal_jittering=not args.no_temporal_jitter, seed=args.seed)
    # the JAX driver's probe batch (it sizes the flax init): its jittered
    # draws come before epoch 0's
    for j in range(min(args.batch_size, len(sampler))):
        sampler.clip_at(j)
    it, start_epoch, best_acc = 0, args.start_epoch, -1.0
    weights = sgd = momentum = None
    if args.resume:
        print(f'Resuming from checkpoint {args.resume}')
        weights, sgd, momentum, ck = read_resume(args.resume)
        it = int(ck.get('iteration', 0))
        start_epoch = int(ck.get('epoch', -1)) + 1
        best_acc = float(ck.get('best_acc', -1.0))
    state = trainer.init_state(seed=args.seed, state_dict=weights)
    if sgd is not None:
        state['optimizer'].load_state_dict(sgd)
    if momentum is not None:
        trainer.set_momentum(state, momentum)

    if args.valid_only:
        if valid_segments is None:
            raise SystemExit('--valid-only needs --valid-csv')
        if is_main:
            evaluate(state, max(start_epoch - 1, 0))
        parallel.barrier()
        return state

    metrics_path = os.path.join(args.output_dir, 'metrics.jsonl')
    part = parallel.rows(args.batch_size)
    for epoch in range(start_epoch, args.epochs):
        order = rng.permutation(len(sampler))
        t0 = time.time()
        sums = {}
        nb = 0

        def batches(order=order):
            for i in range(0, len(order) - args.batch_size + 1,
                           args.batch_size):
                items = [sampler.clip_at(j)
                         for j in order[i:i + args.batch_size]]
                yield make_batch(items, train=True, part=part)

        for batch in PrefetchLoader(batches()):
            state, metrics = trainer.train_step(state, batch, it)
            for k, v in metrics.items():
                sums[k] = sums.get(k, 0.0) + float(v)
            it += 1
            nb += 1
            if args.print_freq and nb % args.print_freq == 0:
                print(f'  epoch {epoch} it {nb}/{len(order)//args.batch_size}'
                      f' total {sums["total"]/nb:.4f}')
        dt = time.time() - t0
        avg = {k: round(v, 4) for k, v in sync_metrics(
            {k: v / max(nb, 1) for k, v in sums.items()}).items()}
        cps = nb * args.batch_size / max(dt, 1e-9)
        print(f'epoch {epoch}: {avg} ({cps:.1f} clips/s)')
        if is_main:     # the other ranks wait at the barrier
            save_ckpt(state, 'tsp-last.pth', epoch, it, best_acc)
            rec = {'epoch': epoch, 'train': avg,
                   'clips_per_sec': round(cps, 2)}
            if valid_segments is not None and not args.train_only_one_epoch:
                acc = evaluate(state, epoch)
                rec['valid_avg_accuracy'] = round(acc, 3)
                if acc > best_acc:
                    best_acc = acc
                    save_ckpt(state, 'tsp-best.pth', epoch, it, best_acc)
                    print(f'new best avg accuracy {best_acc:.3f} -> '
                          'tsp-best.pth')
                # refresh last so a resume carries this epoch's best_acc
                save_ckpt(state, 'tsp-last.pth', epoch, it, best_acc)
            with open(metrics_path, 'a') as f:
                f.write(json.dumps(rec) + '\n')
        parallel.barrier()
        if args.train_only_one_epoch:
            break
    print('done')
    return state


if __name__ == '__main__':
    main()
