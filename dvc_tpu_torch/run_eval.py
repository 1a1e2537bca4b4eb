"""Evaluation / inference entry point of the port (counterpart of the root
``eval.py``; reference ``eval.py:38-176``).

    python -m dvc_tpu_torch.run_eval --eval_save_dir save/yc2_run \\
        --eval_mode eval [--eval_device cpu]

The same flags as ``eval.py``.  The options come from the run folder's
``info.json`` (or the one beside ``--eval_checkpoint_path``, else
``--cfg_path``); the weights from ``model-{best,last}.pth`` of a port run
or ``.ckpt`` of a JAX run (``serve.load_run``).  ``--eval_mode eval``
writes ``eval_results.json`` with the scores; ``test`` writes
``dvc_results.json`` and skips the language metrics, with a fake caption
file built from ``--test_video_meta_data_csv_path`` where given.  It runs
on the card unless ``--eval_device cpu`` is given.  It takes FusionPDVC
runs (``newTrain.py``, ``dvc_tpu_torch.new_train``) and plain PDVC runs
(``train.py``, ``dvc_tpu_torch.run_train``), told apart by the weights'
keys as the JAX ``load_checkpoint`` does (a FusionPDVC's carry
``pdvcModel.``), not by the recipe; a two-stage run (``gt_proposals``,
also as ``--eval_transformer_input_type``) takes its queries from the val
set's gt boxes.  A streaming run (``--streaming_features 1``) featurizes
the videos of its ``video_folder`` in process on the same device
(``data/streaming.py``) unless ``--eval_feature_folder`` points at
extracted features (``dvc_tpu_torch.eval_ete`` writes them).  The captions
are the run's (``caption_sample_max``, ``caption_sample_temperature``),
or sampled at a temperature with ``--caption_sample_max 0
[--caption_sample_temperature T]``; the draws come from a generator
seeded with the run's ``seed``.  A run trained under
``--tpu_compute_dtype bfloat16`` or ``--fusion_dtype bfloat16``
evaluates so, from its saved options.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .data import (BatchLoader, DenseCaptionDataset, FusionBatchLoader,
                   FusionDataset)
from .data.streaming import StreamingFeatureDataset
from .eval import evaluate
from .new_train import create_logger
from .serve import (is_fusion_state, load_info_json, load_run, make_model,
                    run_options)
from .train import Trainer
from .utils.config import load_config


def create_fake_test_caption_file(metadata_keys, out_path, duration=60.0):
    """Fake annotation so the full pipeline runs on unlabeled videos
    (reference eval.py:29-36).  ``metadata_keys`` is a list of video keys
    or the path of a metadata CSV (the reference surface): then keys and
    durations come from its filename / video-duration columns."""
    if isinstance(metadata_keys, str):
        import csv
        with open(metadata_keys) as f:
            rows = list(csv.DictReader(f))
        fake = {os.path.basename(r['filename']).split('.')[0]:
                {'duration': float(r.get('video-duration', duration)),
                 'timestamps': [[0, 0.5]], 'sentences': ['None']}
                for r in rows}
    else:
        fake = {k: {'duration': duration, 'timestamps': [[0, 0.5]],
                    'sentences': ['None']} for k in metadata_keys}
    with open(out_path, 'w') as f:
        json.dump(fake, f)
    return out_path


def build_parser():
    parser = argparse.ArgumentParser()
    parser.add_argument('--cfg_path', type=str, default=None)
    parser.add_argument('--eval_save_dir', type=str, default='save',
                        help='run folder (or its parent when --eval_folder '
                             'is given, the reference layout)')
    parser.add_argument('--eval_folder', type=str, default=None,
                        help='run folder name under --eval_save_dir '
                             '(reference eval.py:161)')
    parser.add_argument('--eval_mode', type=str, default='eval',
                        choices=['eval', 'test'])
    parser.add_argument('--eval_model', type=str, default='best',
                        choices=['best', 'last'])
    parser.add_argument('--eval_caption_file', type=str, default=None)
    parser.add_argument('--eval_feature_folder',
                        '--test_video_feature_folder',
                        dest='eval_feature_folder', type=str, nargs='+',
                        default=None)
    parser.add_argument('--test_video_meta_data_csv_path', type=str,
                        default=None,
                        help='test mode: build the fake caption file from '
                             'this metadata CSV (reference surface)')
    parser.add_argument('--eval_batch_size', type=int, default=None)
    parser.add_argument('--eval_checkpoint_path', '--eval_model_path',
                        dest='eval_checkpoint_path', type=str, default=None,
                        help='explicit checkpoint path: a port .pth or a '
                             'JAX .ckpt')
    parser.add_argument('--eval_transformer_input_type', type=str,
                        default=None, choices=['queries', 'gt_proposals'],
                        help='override the restored transformer_input_type '
                             '(reference eval.py:61)')
    parser.add_argument('--eval_tool_version', type=str, default=None,
                        choices=['2018', '2021'])
    parser.add_argument('--skip_lang_eval', action='store_true')
    parser.add_argument('--caption_sample_max', type=int, default=None,
                        help='override the run\'s: 1 greedy captions, 0 '
                             'sampled from exp(logprobs / '
                             'caption_sample_temperature)')
    parser.add_argument('--caption_sample_temperature', type=float,
                        default=None, help='override the run\'s')
    parser.add_argument('--eval_device', type=str, default='cuda',
                        choices=['cuda', 'cpu'],
                        help='the card (default) or the CPU')
    # reference flags that select nothing here, accepted so reference
    # command lines run unchanged
    parser.add_argument('--gpu_id', type=str, nargs='+', default=None)
    parser.add_argument('--eval_proposal_type', type=str, default=None)
    parser.add_argument('--visualization', type=str, default=None)
    return parser


def main(argv=None):
    """Evaluate one run.  Returns (path of the written json, scores or
    None)."""
    args = build_parser().parse_args(argv)
    for flag in ('gpu_id', 'eval_proposal_type', 'visualization'):
        if getattr(args, flag) is not None:
            print(f'--{flag} accepted for reference compatibility; no effect '
                  'in the port (--eval_device picks the device)')
    if args.eval_folder:
        args.eval_save_dir = os.path.join(args.eval_save_dir,
                                          args.eval_folder)
        if args.eval_mode == 'test':
            os.makedirs(args.eval_save_dir, exist_ok=True)
    logger = create_logger(args.eval_save_dir, 'eval.log')

    # the options of the run's info.json (reference eval.py:53-59); with
    # --eval_model_path outside the run folder, the info.json beside the
    # checkpoint (eval.py:44-49); else the recipe
    run_dir, ckpt = args.eval_save_dir, args.eval_checkpoint_path
    if load_info_json(run_dir) is None and ckpt \
            and load_info_json(os.path.dirname(ckpt)) is not None:
        run_dir = os.path.dirname(ckpt)
    if load_info_json(run_dir) is not None:
        opt = run_options(run_dir, args.eval_model)
    elif args.cfg_path:
        opt = load_config(args.cfg_path)
    else:
        raise SystemExit('need info.json in the run folder (or next to '
                         '--eval_model_path) or --cfg_path')
    if args.eval_transformer_input_type:
        opt.transformer_input_type = args.eval_transformer_input_type
    if args.eval_tool_version:
        opt.eval_tool_version = args.eval_tool_version
    for flag in ('caption_sample_max', 'caption_sample_temperature'):
        if getattr(args, flag) is not None:
            setattr(opt, flag, getattr(args, flag))
    _, state_dict = load_run(run_dir, args.eval_model, checkpoint=ckpt,
                             opt=opt)
    fusion = is_fusion_state(state_dict)

    caption_file = args.eval_caption_file or opt.val_caption_file
    if args.eval_mode == 'test' and args.test_video_meta_data_csv_path:
        caption_file = create_fake_test_caption_file(
            args.test_video_meta_data_csv_path,
            os.path.join(args.eval_save_dir, 'fake_caption.json'))
    feature_folder = opt.visual_feature_folder
    if args.eval_feature_folder:
        ff = args.eval_feature_folder                     # nargs='+': a list
        if isinstance(opt.visual_feature_type, (list, tuple)):
            feature_folder = (ff if len(ff) == len(opt.visual_feature_type)
                              else [ff[0]] * len(opt.visual_feature_type))
        else:
            feature_folder = ff[0]
    skip_lang = args.skip_lang_eval or args.eval_mode == 'test'

    batch_size = args.eval_batch_size or opt.batch_size_for_eval
    if fusion:
        loader = FusionBatchLoader(FusionDataset(
            caption_file, feature_folder, opt.dict_file, opt), batch_size,
            False, opt)
    elif opt.streaming_features and not args.eval_feature_folder:
        # decode + TSP in process, as the run trained (eval.py:149-160)
        loader = BatchLoader(StreamingFeatureDataset(
            caption_file, opt.video_folder, opt.dict_file, opt,
            cache_size=opt.streaming_cache, device=args.eval_device),
            batch_size, False, opt)
    else:
        loader = BatchLoader(DenseCaptionDataset(
            caption_file, feature_folder, opt.dict_file, opt), batch_size,
            False, opt)
    trainer = Trainer(opt, device=args.eval_device,
                      model=make_model(opt, state_dict, args.eval_device))
    logger.info(f'loaded the {args.eval_model} weights of {ckpt or run_dir}')

    # reference naming: test mode writes dvc_results.json (eval.py:135,
    # the file test_and_visualize.sh feeds to the visualizer)
    name = ('dvc_results.json' if args.eval_mode == 'test'
            else 'eval_results.json')
    dvc_json_path = os.path.join(args.eval_save_dir, name)
    scores, _ = evaluate(trainer, loader, dvc_json_path, logger=logger,
                         alpha=opt.ec_alpha,
                         dvc_eval_version=opt.eval_tool_version,
                         skip_lang_eval=skip_lang)
    if scores is not None:
        logger.info('scores:')
        for k, v in scores.items():
            logger.info(f'  {k}: {v}')
    logger.info(f'results written to {dvc_json_path}')
    return dvc_json_path, scores


if __name__ == '__main__':
    main(sys.argv[1:])
