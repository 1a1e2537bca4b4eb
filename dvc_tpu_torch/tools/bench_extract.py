"""TSP feature extraction timed on the card: the backbone forward on
(B, clip_len, H, W, 3) clips (the port's counterpart of the JAX repo's
``tools/bench_extract.py``).

The forward is :class:`~dvc_tpu_torch.models.tsp.FeatureExtractor`'s:
float32 clips drawn from ``numpy.random.default_rng(0)`` on the device,
cast to ``--dtype`` there, permuted, the backbone, the features back in
float32; float32 runs with TF32 off (``utils/precision.py``).  Each step
feeds the clips ``x + sin(acc) * 1e-12``, acc the last step's feature sum,
so the steps are dependent, and the JAX tool's two-point protocol times
them: ``--n1`` then ``--n2`` steps, each once to warm up and once timed by
CUDA events, differenced (``utils/profiling.py::two_point_ms``).  It
prints one JSON line: ms a step and a clip, clips/s, GFLOPs a clip (the
products and convolutions of one forward, ``utils/roofline.py::
forward_flops``) and ``mfu``, the FLOP rate over the card's data-sheet
peak for the dtype (bf16 on the tensor cores; float32 on the CUDA cores,
since TF32 is off).  ``--profile DIR`` also traces 6 forwards with
``torch.profiler`` into ``DIR/trace.json`` and prints the top operations
by device time, as ``profile_step`` does.  The tool runs on the card;
``--device cpu`` is the only way onto the CPU, where no peak is known and
``mfu`` is None.

    python -m dvc_tpu_torch.tools.bench_extract [--backbone mvit_v2_s] \\
        [--batch 8] [--dtype bfloat16] [--n1 8] [--n2 24] [--profile DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--backbone', default='mvit_v2_s')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--clip-len', type=int, default=16)
    p.add_argument('--dtype', default='bfloat16',
                   choices=['float32', 'bfloat16'])
    p.add_argument('--n1', type=int, default=8)
    p.add_argument('--n2', type=int, default=24)
    p.add_argument('--profile', default=None,
                   help='also trace 6 forwards with torch.profiler into '
                        'this directory')
    p.add_argument('--top', type=int, default=30)
    p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    return p.parse_args(argv)


def main(argv=None, config=None):
    """The command line; ``config`` (an ``MViTConfig``, e.g. a narrow MViT
    for a test) is for callers in Python."""
    args = parse_args(argv)
    import numpy as np
    import torch

    from ..data.video_clips import BACKBONE_INPUT
    from ..models.tsp import FeatureExtractor
    from ..models.tsp.extractor import DTYPES
    from ..utils.profiling import card_label, traced, two_point_ms
    from ..utils.roofline import device_peaks, forward_flops
    from .profile_step import report
    dev = torch.device(args.device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu')
    ex = FeatureExtractor(args.backbone, clip_len=args.clip_len,
                          dtype=args.dtype, device=dev, config=config)
    hw = (config.spatial_size if config is not None
          else BACKBONE_INPUT[args.backbone]['crop'][0])
    rng = np.random.default_rng(0)
    # float32 clips on the device, cast there as extract_features does
    x = torch.from_numpy(rng.standard_normal(
        (args.batch, args.clip_len, hw, hw, 3)).astype(np.float32)).to(dev)

    def step(acc):
        return ex.features(x + torch.sin(acc) * 1e-12).sum() * 1e-6

    with torch.inference_mode():
        ms, acc = two_point_ms(step, args.n1, args.n2, dev,
                               torch.zeros((), device=dev))
        flops = forward_flops(ex.model, x.to(DTYPES[args.dtype])
                              .permute(0, 4, 1, 2, 3))
    if not np.isfinite(acc.item()):
        raise RuntimeError('bench_extract: non-finite features')
    peaks = device_peaks(dev)
    peak = None if peaks is None else (
        peaks.bf16 if args.dtype == 'bfloat16' else peaks.f32)
    row = {'platform': 'gpu' if dev.type == 'cuda' else 'cpu',
           'device': card_label(dev), 'backbone': args.backbone,
           'batch': args.batch, 'dtype': args.dtype,
           'protocol': f'dependent steps, two-point diff N{args.n1}/'
                       f'N{args.n2}' + (', CUDA events' if dev.type == 'cuda'
                                         else ', host clock'),
           'step_ms': round(ms, 4),
           'ms_per_clip': round(ms / args.batch, 4),
           'clips_per_sec': round(args.batch / ms * 1e3, 2),
           'gflops_per_clip': round(flops / args.batch / 1e9, 3),
           'mfu': None if peak is None else round(
               flops / (ms / 1e3) / peak, 4)}
    print(json.dumps(row), flush=True)

    if args.profile:
        os.makedirs(args.profile, exist_ok=True)
        label = f'bench_extract {args.backbone} {args.dtype} x6'
        with torch.inference_mode(), traced(
                label, os.path.join(args.profile, 'trace.json')) as window:
            acc = torch.zeros((), device=dev)
            for _ in range(6):
                acc = step(acc)
        print(json.dumps(report({}, window, args.top), indent=1))
    return row


if __name__ == '__main__':
    main(sys.argv[1:])
