"""TSP feature extraction driver of the port (counterpart of the root
``extract_features.py``; reference
``video_backbone/TSP/extract_features/extract_features.py:54-231``).

    python -m dvc_tpu_torch.extract_features --video-dir my_videos/ \\
        --backbone mvit_v2_s --local-checkpoint mvit_tsp.pth \\
        --stride 16 --output-dir features/ [--device cpu]

Decodes the stride-``stride`` clips of every video, runs the TSP backbone
on the card (``--device cpu`` for the CPU) and writes one
``<video_id[:13]>.npy`` of float32 clip features per video.  Work divides
across processes with ``--shard-id/--num-shards``; a video whose ``.npy``
exists is skipped.  ``--released-checkpoint`` names a released TSP
checkpoint: the port fetches nothing, so it needs the file as
``--local-checkpoint``.
"""

from __future__ import annotations

import argparse
import csv
import glob
import os
import sys

import numpy as np

from .data.streaming import VIDEO_EXTS
from .models.tsp import FeatureExtractor
from .models.tsp.model import BACKBONES


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    # --data-path is the reference flag name (TSP extract_features/opts.py:31)
    p.add_argument('--video-dir', '--data-path', dest='video_dir',
                   type=str, default=None)
    p.add_argument('--metadata-csv-filename', type=str, default=None)
    p.add_argument('--backbone', type=str, default='mvit_v2_s',
                   choices=sorted(BACKBONES))
    p.add_argument('--local-checkpoint', type=str, default=None,
                   help='.pth (torch) or .ckpt (JAX pickle) TSP weights')
    p.add_argument('--released-checkpoint', type=str, default=None,
                   help='name of a released TSP checkpoint (reference '
                        'opts.py:43); the port fetches nothing: download '
                        'it and pass it as --local-checkpoint')
    p.add_argument('--clip-len', type=int, default=16)
    p.add_argument('--frame-rate', type=float, default=15)
    p.add_argument('--stride', type=int, default=16)
    p.add_argument('--batch-size', type=int, default=32)
    p.add_argument('--shard-id', type=int, default=0)
    p.add_argument('--num-shards', type=int, default=1)
    p.add_argument('--output-dir', type=str, required=True)
    p.add_argument('--dtype', type=str, default='bfloat16',
                   choices=['float32', 'bfloat16'],
                   help='compute dtype for extraction (features are '
                        'written as float32 either way)')
    p.add_argument('--device', type=str, default='cuda',
                   choices=['cuda', 'cpu'],
                   help='the card (default) or the CPU')
    # a reference flag: decode threading is internal here
    p.add_argument('--workers', type=int, default=None)
    return p


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    if args.released_checkpoint and not args.local_checkpoint:
        raise SystemExit(
            f'--released-checkpoint {args.released_checkpoint}: the port '
            'fetches no file; download the checkpoint and pass it with '
            '--local-checkpoint (and its --backbone)')
    if args.video_dir is None and args.metadata_csv_filename is None:
        raise SystemExit('need --video-dir or --metadata-csv-filename')
    return args


def load_videos(args):
    """[{filename, fps, frames}] of the metadata CSV, else of every
    readable video in ``--video-dir``, in name order."""
    if args.metadata_csv_filename:
        with open(args.metadata_csv_filename) as f:
            return [dict(filename=r['filename'], fps=float(r['fps']),
                         frames=int(float(r['video-frames'])))
                    for r in csv.DictReader(f)]
    from .data.video_clips import video_metadata
    vids = []
    for p in sorted(glob.glob(os.path.join(args.video_dir, '*'))):
        if not p.lower().endswith(VIDEO_EXTS):
            continue
        try:
            fps, n, _ = video_metadata(p)
        except IOError:
            print(f'unreadable video skipped: {p}')
            continue
        vids.append(dict(filename=p, fps=fps, frames=n))
    return vids


def main(argv=None):
    """Extract this shard's videos.  Returns the paths written (videos
    already extracted are skipped and not listed)."""
    args = parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    videos = [v for i, v in enumerate(load_videos(args))
              if i % args.num_shards == args.shard_id]
    print(f'shard {args.shard_id}/{args.num_shards}: {len(videos)} videos')
    extractor = FeatureExtractor(args.backbone, args.local_checkpoint,
                                 clip_len=args.clip_len, dtype=args.dtype,
                                 device=args.device)
    written = []
    for v in videos:
        vid = os.path.splitext(os.path.basename(v['filename']))[0]
        out_path = os.path.join(args.output_dir, vid[:13] + '.npy')
        if os.path.exists(out_path):
            print(f'already computed: {vid}')
            continue
        feats = extractor.extract_video(
            v['filename'], v['fps'], v['frames'],
            frame_rate=args.frame_rate, stride=args.stride,
            batch_size=args.batch_size)
        if not len(feats):
            print(f'no clips for {vid}')
            continue
        np.save(out_path, feats.astype(np.float32))
        written.append(out_path)
        print(f'{vid}: {feats.shape} -> {out_path}')
    return written


if __name__ == '__main__':
    main(sys.argv[1:])
