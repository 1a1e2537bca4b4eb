"""A ``torch.profiler`` trace of the flagship train or eval step (the
port's counterpart of ``tools/profile_step.py``).

Builds the FusionPDVC of the JAX flagship benchmark at full width
(``FLAGSHIP``: ``__graft_entry__._flagship_opt`` at ``bench.py``'s shapes,
B=16, T=200, 20 words, cap_nheads 8, 100 queries) with seeded weights on
synthetic data made from ``--seed``, warms it up outside the trace, then
takes ``--steps`` steps of ``Trainer.train_step`` or ``Trainer.eval_step``
under ``torch.profiler`` (``utils/profiling.py``).  It writes the Chrome
trace to ``<out>/trace.json`` and prints, as JSON, the top operations by
device time with the window's idle share.  Where the profiler recorded no
device activity (the CPU), the JSON says so and lists no operations: host
times do not stand in for device times.

    python -m dvc_tpu_torch.tools.profile_step --what train|eval \\
        --out DIR [--steps 8] [--batch 16] [--top 40] [--seed 0] \\
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..utils.config import load_config
from ..utils.profiling import traced

# __graft_entry__.py's _flagship_opt at bench.py's shapes (frame_embedding_num
# 200, max_caption_len 20, tpu_mesh_data 1); bench.py builds the FusionPDVC
# of it and feeds it sound
FLAGSHIP = dict(vocab_size=1607, visual_feature_type='tsp_mvit',
                feature_dim=768, frame_embedding_num=200,
                gt_proposal_sample_num=8, max_caption_len=20, hidden_dim=512,
                nheads=8, enc_layers=3, dec_layers=3, transformer_ff_dim=512,
                num_queries=100, input_encoding_size=512, rnn_size=512,
                att_hid_size=512, cap_nheads=8, with_box_refine=True,
                caption_decoder_type='standard', caption_loss_coef=2.0,
                count_loss_coef=0.5, max_eseq_length=20,
                invalid_video_json=[], tpu_mesh_data=1)


def flagship_opt(**overrides):
    """The options of the flagship (``FLAGSHIP``), with ``overrides``."""
    return load_config(**{**FLAGSHIP, **overrides})


def synthetic_batch(opt, B, seed=0):
    """A collated numpy batch of B videos (the JAX ``_synthetic_batch``
    with sound): T frames of features, G gt events of Lc-token captions,
    drawn from ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    T, C, G, Lc = (opt.frame_embedding_num, opt.feature_dim,
                   opt.gt_proposal_sample_num, opt.max_caption_len)
    centers = rng.uniform(0.2, 0.8, (B, G))
    lens = rng.uniform(0.05, 0.3, (B, G))
    caps = rng.integers(1, opt.vocab_size, (B, G, Lc)).astype(np.int32)
    caps[:, :, 0] = 0
    caps[:, :, -1] = 0
    return {
        'sound_tensor': rng.standard_normal((B, T, C)).astype(np.float32),
        'video_tensor': rng.standard_normal((B, T, C)).astype(np.float32),
        'video_mask': np.ones((B, T), bool),
        'video_length': np.stack([np.full(B, T), np.full(B, 120.0),
                                  np.full(B, G)], 1).astype(np.float32),
        'gt_boxes': np.stack([centers, lens], -1).astype(np.float32),
        'gt_boxes_mask': np.ones((B, G), bool),
        'gt_labels': np.zeros((B, G), np.int32),
        'cap_tensor': caps,
        'cap_mask': caps >= 0,
    }


def capture(out_dir, what, steps, batch, device='cuda', seed=0, top=40,
            **overrides):
    """Trace ``steps`` steps of ``what`` ('train' or 'eval') at batch size
    ``batch`` and return the summary (see the module's docstring)."""
    from ..train import Trainer
    if what not in ('train', 'eval'):
        raise ValueError(f'--what must be train or eval, not {what!r}')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu')
    opt = flagship_opt(seed=seed, **overrides)
    trainer = Trainer(opt, device=dev)
    data = synthetic_batch(opt, batch, seed)
    if what == 'train':
        prepared = trainer.prepare_batch(data)

        def step():
            trainer.train_step(prepared, opt.lr)
    else:
        prepared = trainer.prepare_eval_batch(data)

        def step():
            trainer.eval_step(prepared)
    step()                                  # warm-up, outside the trace
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    os.makedirs(out_dir, exist_ok=True)
    trace_file = os.path.join(out_dir, 'trace.json')
    label = f'profile_step {what} x{steps}'
    with traced(label, trace_file) as window:
        for _ in range(steps):
            step()
    summary = {'what': what, 'steps': steps, 'batch': batch,
               'device': str(dev),
               'device_name': (torch.cuda.get_device_name(dev)
                               if dev.type == 'cuda' else 'cpu'),
               'trace_file': trace_file,
               'device_activity': bool(window)}
    if not window:
        summary['note'] = ('the profiler recorded no device activity: '
                           'device times, operations and idle share not '
                           'measured')
        return summary
    ranked = sorted(window['per_name'].items(), key=lambda kv: -kv[1][0])
    summary.update(
        window_ms=window['window_ms'], device_busy_ms=window['busy_ms'],
        idle=window['idle'], activities=window['activities'],
        top_ops_ms=[{'name': name[:120], 'total_ms': ms, 'count': n}
                    for name, (ms, n) in ranked[:top]])
    return summary


def main(argv=None, **overrides):
    """The command line; ``overrides`` (options of the flagship, e.g. a
    narrow width for a test) are for callers in Python."""
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--what', choices=['train', 'eval'], default='train')
    p.add_argument('--out', required=True,
                   help='directory for the Chrome trace (trace.json)')
    p.add_argument('--steps', type=int, default=8)
    p.add_argument('--batch', type=int, default=16)
    p.add_argument('--top', type=int, default=40)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    args = p.parse_args(argv)
    summary = capture(args.out, args.what, args.steps, args.batch,
                      args.device, args.seed, args.top, **overrides)
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == '__main__':
    main(sys.argv[1:])
