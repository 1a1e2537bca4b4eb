"""End-to-end evaluation of the port (counterpart of the root
``eval_ete.py``; reference ``ete/eval.py:60-201``): extract features with
a TSP checkpoint, then evaluate a PDVC run on them, so backbone updates
show in the scores.

    python -m dvc_tpu_torch.eval_ete --eval_save_dir save/yc2_run \\
        --video-dir videos/ --tsp-checkpoint tsp.pth [--device cpu]

It runs :mod:`dvc_tpu_torch.extract_features` (into ``--feature-dir``,
by default ``<eval_save_dir>/ete_features_stride_<stride>``), then
:mod:`dvc_tpu_torch.run_eval` with ``--eval_feature_folder`` on them,
both on the card unless ``--device cpu`` is given.  The flags are those
of the root ``eval_ete.py``; the extraction settings that they do not
give are the run's own: ``backbone_tsp``, ``tsp_checkpoint``,
``stride``, ``clip_len``, ``frame_rate``, ``extraction_dtype`` and
``in_batch_size`` of its ``info.json``.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import extract_features, run_eval
from .serve import run_options


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--eval_save_dir', required=True)
    p.add_argument('--video-dir', required=True)
    p.add_argument('--tsp-checkpoint', default=None)
    p.add_argument('--backbone', default=None)
    p.add_argument('--stride', type=int, default=None)
    p.add_argument('--feature-dir', default=None)
    p.add_argument('--eval_caption_file', default=None)
    p.add_argument('--device', default='cuda', choices=['cuda', 'cpu'])
    return p


def main(argv=None):
    """Returns run_eval's (path of the written json, scores or None)."""
    args = build_parser().parse_args(argv)
    opt = run_options(args.eval_save_dir)
    stride = args.stride or opt.stride
    feature_dir = args.feature_dir or os.path.join(
        args.eval_save_dir, f'ete_features_stride_{stride}')
    extract = ['--video-dir', args.video_dir,
               '--backbone', args.backbone or opt.backbone_tsp,
               '--stride', str(stride), '--output-dir', feature_dir,
               '--clip-len', str(opt.clip_len),
               '--frame-rate', str(opt.frame_rate),
               '--dtype', opt.extraction_dtype,
               '--batch-size', str(opt.in_batch_size),
               '--device', args.device]
    checkpoint = args.tsp_checkpoint or opt.tsp_checkpoint
    if checkpoint:
        extract += ['--local-checkpoint', checkpoint]
    extract_features.main(extract)
    evaluate = ['--eval_save_dir', args.eval_save_dir,
                '--eval_feature_folder', feature_dir,
                '--eval_device', args.device]
    if args.eval_caption_file:
        evaluate += ['--eval_caption_file', args.eval_caption_file]
    return run_eval.main(evaluate)


if __name__ == '__main__':
    main(sys.argv[1:])
