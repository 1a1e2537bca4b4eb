"""Sustained end-to-end epoch throughput of the port's plain-PDVC
training, ``run_train`` (the port's counterpart of the JAX repo's
``tools/bench_epoch.py``).

A step timed alone on a prepared batch says little of what a user gets
from a run.  This tool measures whole epochs of
``python -m dvc_tpu_torch.run_train`` (``run_train.main``, in process):
``.npy`` feature files read by the native library, collation, the upload
one batch ahead, the train step, each epoch's validation and checkpoint,
at the flagship's widths (768-d features, T=200, vocab 1607, the LSTM-DSA
caption head) on a synthetic dataset made from a seed
(``tools/synth.py``).  The recipe is the JAX tool's but for
``caption_loss_coef``: the JAX tool leaves it at its default 0, so its
epochs never train the caption head (the scan's backward is dead code);
here it is the flagship's 2, so an epoch trains what a captioning run
trains.

    python -m dvc_tpu_torch.tools.bench_epoch                # flagship, B=16
    python -m dvc_tpu_torch.tools.bench_epoch --n-videos 128 --epochs 3
    python -m dvc_tpu_torch.tools.bench_epoch --loader-only  # the host alone
    python -m dvc_tpu_torch.tools.bench_epoch --tiny --device cpu

It prints one JSON line.  A training run: the train loop's videos/s of
each epoch (``run_train``'s ``videos_per_sec`` in ``metrics.jsonl``, a
window that starts before the epoch's first batch is read and ends after
the last step's losses reach the host, which waits for the card to finish
the step), the steady-state train videos/s, and with validation the
steady epoch's wall time (train, validation and checkpoint: the interval
between the last two ``epoch{N}.json`` files), the validation and
checkpoint overhead and the sustained videos/s including it; the ratio to
``--step-rate`` (a step-alone videos/s) where one is given.  The first
epoch pays the first build of the kernels and cuDNN's algorithm search
(the JAX tool's first epoch pays compilation), so the steady state is read
from epochs 1 on, as the JAX tool reads it.  ``--loader-only``: the host
input pipeline alone (the dataset and ``BatchLoader``, no device), its
videos/s an epoch and its headroom over ``--step-rate``.  Every record
names the card it ran on (``nvidia-smi``'s name and power limit) or
'cpu'.  The tool runs on the card; ``--device cpu`` is the only way onto
the CPU.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--n-videos', type=int, default=256)
    p.add_argument('--val-videos', type=int, default=32)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--epochs', type=int, default=3)
    p.add_argument('--feat-dim', type=int, default=768)
    p.add_argument('--frames', type=int, default=230,
                   help='raw feature frames per video (resampled to '
                        'frame_embedding_num=200 by the loader)')
    p.add_argument('--vocab', type=int, default=1607)
    p.add_argument('--workdir', type=str, default=None)
    p.add_argument('--step-rate', type=float, default=None,
                   help='a step-alone videos/s to compare against')
    p.add_argument('--steps-per-dispatch', type=int, default=1,
                   help="run_train's --steps_per_dispatch: K optimizer "
                        'steps a dispatch, one copy of their losses to the '
                        'host')
    p.add_argument('--skip-eval', action='store_true',
                   help='the epoch loop only (no validation, no checkpoint)')
    p.add_argument('--tiny', action='store_true',
                   help='a narrow model (a check of the tool on the CPU, '
                        'not a measurement)')
    p.add_argument('--streaming', action='store_true',
                   help='write raw videos and train on them through '
                        '--streaming_features (clip decode and the TSP '
                        'backbone at load time) in place of .npy features')
    p.add_argument('--video-frames', type=int, default=96,
                   help='--streaming: raw frames a synthetic video')
    p.add_argument('--loader-only', action='store_true',
                   help='time the host input pipeline alone (feature read, '
                        'collation; no device)')
    p.add_argument('--out', type=str, default=None,
                   help='also write the record here')
    p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    return p.parse_args(argv)


def write_videos(anno_path, workdir, n_frames):
    """Raw mp4v videos (160x120, 30 fps, a grey level that moves) for the
    annotation's keys, the input of ``--streaming`` (the ``.npy`` features
    stay on disk unread)."""
    import cv2
    import numpy as np
    vid_dir = os.path.join(workdir, 'videos')
    os.makedirs(vid_dir, exist_ok=True)
    with open(anno_path) as f:
        anno = json.load(f)
    rng = np.random.default_rng(0)
    for key in anno:
        w = cv2.VideoWriter(os.path.join(vid_dir, key[:13] + '.mp4'),
                            cv2.VideoWriter_fourcc(*'mp4v'), 30.0,
                            (160, 120))
        base = int(rng.integers(0, 200))
        for i in range(n_frames):
            w.write(np.full((120, 160, 3), (base + 5 * i) % 255, np.uint8))
        w.release()
    return vid_dir


def recipe(args, workdir):
    """Writes the dataset (the last ``--val-videos`` of one pool are the
    validation split) and returns (the run's options as a dict, the
    seconds the dataset took)."""
    from .synth import make_synth_dataset
    t0 = time.time()
    anno, feat_dir, vocab_path, vocab_size = make_synth_dataset(
        workdir, n_videos=args.n_videos + args.val_videos,
        feat_dim=args.feat_dim, n_frames=args.frames, n_words=args.vocab)
    with open(anno) as f:
        all_anno = json.load(f)
    keys = sorted(all_anno)
    train_keys, val_keys = keys[:args.n_videos], keys[args.n_videos:]
    with open(anno, 'w') as f:
        json.dump({k: all_anno[k] for k in train_keys}, f)
    val_anno = os.path.join(workdir, 'val.json')
    with open(val_anno, 'w') as f:
        json.dump({k: all_anno[k] for k in val_keys}, f)
    para_path = os.path.join(workdir, 'para.json')
    with open(para_path, 'w') as f:
        json.dump({k: '. '.join(all_anno[k]['sentences'])
                   for k in val_keys}, f)
    gen_s = time.time() - t0
    cfg = {
        'id': 'epoch_bench', 'seed': 0,
        'train_caption_file': anno, 'val_caption_file': val_anno,
        'visual_feature_folder': [feat_dir],
        'gt_file_for_eval': [val_anno],
        'gt_file_for_para_eval': [para_path],
        'dict_file': vocab_path, 'vocab_size': vocab_size,
        'visual_feature_type': ['tsp_mvit'],
        'feature_dim': args.feat_dim, 'frame_embedding_num': 200,
        'num_queries': 100, 'max_eseq_length': 20, 'max_caption_len': 20,
        'caption_decoder_type': 'standard', 'caption_loss_coef': 2.0,
        'enc_layers': 3, 'dec_layers': 3, 'hidden_dim': 512,
        'batch_size': args.batch, 'batch_size_for_eval': args.batch,
        'epoch': args.epochs, 'lr': 5e-5, 'optimizer_type': 'adamw',
        'save_dir': os.path.join(workdir, 'save'), 'invalid_video_json': [],
        'save_checkpoint_every': 1000 if args.skip_eval else 1,
        'min_epoch_when_save': -1,
        'eval_tool_version': '2018',
        'steps_per_dispatch': args.steps_per_dispatch,
    }
    if args.tiny:
        cfg.update(frame_embedding_num=24, hidden_dim=64, nheads=4,
                   transformer_ff_dim=64, num_queries=10, enc_layers=1,
                   dec_layers=2, input_encoding_size=32, rnn_size=64,
                   att_hid_size=32, max_caption_len=8)
    if args.streaming:
        vid_dir = write_videos(anno, workdir, args.video_frames)
        # the flagship's backbone on the card; --tiny takes the small
        # VideoResNet, so that the tool's check stays short on the CPU
        backbone, fdim = (('r3d_18', 512) if args.tiny
                          else ('mvit_v2_s', 768))
        cfg.update(streaming_features=1, video_folder=vid_dir,
                   backbone_tsp=backbone, feature_dim=fdim,
                   visual_feature_type=['tsp_mvit'])
    return cfg, gen_s


def loader_epochs(cfg, args):
    """``--loader-only``: (seconds, batches) of each epoch of the dataset
    and ``BatchLoader`` over the train split, on the host."""
    from ..data import BatchLoader, DenseCaptionDataset
    from ..utils.config import load_config
    opt = load_config(**{k: v for k, v in cfg.items()
                         if k not in ('id', 'save_dir')})
    ds = DenseCaptionDataset(cfg['train_caption_file'],
                             cfg['visual_feature_folder'], cfg['dict_file'],
                             opt, seed=0)
    loader = BatchLoader(ds, args.batch, True, opt, seed=0)
    timings = []
    for ep in range(args.epochs):
        loader.set_epoch(ep)
        t0 = time.time()
        nb = 0
        for _ in loader:
            nb += 1
        timings.append((time.time() - t0, nb))
    return timings


def train_run(cfg_path, device):
    """``python -m dvc_tpu_torch.run_train --cfg_path cfg_path --device
    device`` in process; returns the run folder."""
    import numpy as np
    import torch

    from .. import run_train
    from ..utils.config import parse_opts
    opt = parse_opts(['--cfg_path', cfg_path, '--device', device])
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    folder, _ = run_train.main(opt, device)
    return folder


def main(argv=None):
    args = parse_args(argv)
    import torch

    from ..utils.profiling import card_label
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu')
    card = card_label(args.device)
    workdir = args.workdir or tempfile.mkdtemp(prefix='dvc_epoch_bench_')
    os.makedirs(workdir, exist_ok=True)
    cfg, gen_s = recipe(args, workdir)

    if args.loader_only:
        timings = loader_epochs(cfg, args)
        rec = {'metric': 'host_input_pipeline_throughput',
               'n_videos': args.n_videos, 'batch': args.batch,
               'ms_per_batch_by_epoch':
                   [round(t / max(n, 1) * 1e3, 2) for t, n in timings],
               'videos_per_sec_by_epoch':
                   [round(n * args.batch / max(t, 1e-9), 2)
                    for t, n in timings]}
        best = max(rec['videos_per_sec_by_epoch'])
        rec['host_videos_per_sec'] = best
        if args.step_rate:
            rec['compiled_step_videos_per_sec'] = args.step_rate
            rec['host_headroom_over_step'] = round(best / args.step_rate, 3)
        return emit({**rec, 'device': card}, args.out)

    import yaml
    cfg_path = os.path.join(workdir, 'epoch_bench.yml')
    with open(cfg_path, 'w') as f:
        yaml.safe_dump(cfg, f)
    t1 = time.time()
    run_dir = train_run(cfg_path, args.device)
    wall_s = time.time() - t1

    with open(os.path.join(run_dir, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    vps = [r['value'] for r in recs if r['tag'] == 'videos_per_sec']
    n_steps = args.n_videos // args.batch
    epoch_train_s = [n_steps * args.batch / v for v in vps]
    # each validation ends by writing its epoch{N}.json, so the interval
    # between the last two is a whole steady epoch: train loop,
    # validation and checkpoint
    ep_files = sorted(glob.glob(os.path.join(run_dir, 'epoch*.json')),
                      key=lambda p: int(re.fullmatch(
                          r'epoch(\d+)\.json', os.path.basename(p))[1]))
    ep_mtimes = [os.path.getmtime(p) for p in ep_files]
    rec = {
        'metric': 'end_to_end_epoch_throughput',
        'n_videos': args.n_videos, 'batch': args.batch,
        'epochs': args.epochs,
        'steps_per_dispatch': args.steps_per_dispatch,
        'streaming': bool(args.streaming),
        'dataset_gen_s': round(gen_s, 1),
        'total_wall_s': round(wall_s, 1),
        'train_videos_per_sec_by_epoch': [round(v, 2) for v in vps],
        'train_loop_s_by_epoch': [round(s, 2) for s in epoch_train_s],
        'steady_state_train_videos_per_sec':
            round(max(vps[1:] or vps), 2),
    }
    if not args.skip_eval and len(vps) >= 2 and len(ep_mtimes) >= 2:
        cycle_s = ep_mtimes[-1] - ep_mtimes[-2]
        rec['steady_epoch_wall_s'] = round(cycle_s, 2)
        rec['eval_ckpt_overhead_s'] = round(
            max(cycle_s - epoch_train_s[-1], 0.0), 2)
        rec['sustained_videos_per_sec_incl_eval'] = round(
            args.n_videos / max(cycle_s, 1e-9), 2)
    if args.step_rate:
        rec['compiled_step_videos_per_sec'] = args.step_rate
        rec['pipeline_efficiency'] = round(
            rec['steady_state_train_videos_per_sec'] / args.step_rate, 4)
    return emit({**rec, 'device': card}, args.out)


def emit(rec, out):
    """Prints ``rec`` as one JSON line (and writes it to ``out``)."""
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, 'w') as f:
            json.dump(rec, f, indent=1)
    return rec


if __name__ == '__main__':
    main(sys.argv[1:])
