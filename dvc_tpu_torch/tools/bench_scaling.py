"""Data-parallel scaling of the flagship train step over cards (the port's
counterpart of the JAX repo's ``tools/bench_scaling.py``).

    python -m dvc_tpu_torch.tools.bench_scaling         # 1, 2, 4, ... cards
    python -m dvc_tpu_torch.tools.bench_scaling --chips 2 4 --out sweep.json
    python -m dvc_tpu_torch.tools.bench_scaling --virtual 4 --device cpu

Each sweep point n trains the flagship of ``bench.py`` (FusionPDVC with
sound by default, ``--model pdvc`` for the plain model; the options of
``tools/profile_step.py``'s ``FLAGSHIP`` with ``tpu_mesh_data`` n) on n
data-parallel ranks, one process a card (``parallel.run``: NCCL on the
cards, gloo on the CPU), each rank stepping its ``--batch-per-chip`` rows
of a synthetic global batch.  So perfect scaling is a flat step time, and
the gradients' all-reduce is the only work added.  Rank 0 times ``--n1``
and ``--n2`` dependent train steps, each once to warm up and once timed,
and differences them (``utils/profiling.py::two_point_ms``: CUDA events on
a card, the host clock on the CPU).  Per point: ms a step, videos/s
(global and per card), the scaling efficiency against the 1-card point
(or the smallest point of the sweep, named as the baseline) and the
all-reduce's overhead in ms.

The default sweep is 1, 2, 4, ... up to the visible cards; asking for more
exits.  NCCL refuses two ranks on one card, so on a one-card machine the
sweep is the 1-card point alone, and N > 1 over NCCL waits for a machine
with N cards.  ``--virtual N`` (with ``--device cpu``) makes N gloo ranks
on the CPU visible and runs the same plumbing (the group, each rank's
rows, the all-reduce, the timing) at the JAX tool's narrow shapes, unless
``--full-shapes``: its times say nothing of a card.  The tool runs on the
card; ``--device cpu`` is the only way onto the CPU.
"""

from __future__ import annotations

import argparse
import json
import math
import sys


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--chips', type=int, nargs='+', default=None,
                   help='card counts to sweep (default: 1, 2, 4, ... up to '
                        'the visible cards)')
    p.add_argument('--batch-per-chip', type=int, default=16)
    p.add_argument('--model', choices=['fusion', 'pdvc'], default='fusion')
    p.add_argument('--virtual', type=int, default=0,
                   help='N > 0: N gloo ranks on the CPU (with --device cpu; '
                        'narrow shapes unless --full-shapes)')
    p.add_argument('--full-shapes', action='store_true',
                   help="with --virtual: keep the flagship's shapes")
    p.add_argument('--n1', type=int, default=4)
    p.add_argument('--n2', type=int, default=12)
    p.add_argument('--out', type=str, default=None,
                   help='also write the sweep JSON here')
    p.add_argument('--device', choices=['cuda', 'cpu'], default='cuda')
    return p.parse_args(argv)


# the JAX tool's narrow shapes of --virtual
VIRTUAL_SHAPES = dict(frame_embedding_num=32, hidden_dim=128, nheads=8,
                      transformer_ff_dim=128, num_queries=16,
                      input_encoding_size=64, rnn_size=128, att_hid_size=64,
                      gt_proposal_sample_num=4, max_caption_len=8,
                      feature_dim=64, cap_nheads=8)


def point(device, opt, model, B, n1, n2):
    """One rank of a sweep point: the trainer (rank 0's weights on every
    rank), its rows of a synthetic global batch of B, and the two-point
    ms of its train step (a module-level function: spawned ranks import
    it)."""
    import torch

    from .. import parallel
    from ..models import make_pdvc_model
    from ..train import Trainer
    from ..utils.profiling import two_point_ms
    from .profile_step import synthetic_batch
    trainer = Trainer(opt, device=device, model=(
        make_pdvc_model(opt, device, seed=opt.seed) if model == 'pdvc'
        else None))
    parallel.broadcast_module(trainer.model)
    batch = synthetic_batch(opt, B, opt.seed)
    if model == 'pdvc':
        del batch['sound_tensor']
    rows = parallel.rows(B)
    prepared = trainer.prepare_batch({k: v[rows] for k, v in batch.items()})

    def step(_):
        return trainer.train_step(prepared, opt.lr)['total_loss']

    ms, loss = two_point_ms(step, n1, n2, device,
                            torch.zeros((), device=device))
    if not math.isfinite(loss.item()):
        raise RuntimeError('bench_scaling: non-finite loss')
    return ms


def main(argv=None, **overrides):
    """The command line; ``overrides`` (options of the flagship, e.g. a
    narrower model for a test) are for callers in Python."""
    args = parse_args(argv)
    import torch

    from .. import parallel
    from ..utils.profiling import card_label
    from .profile_step import flagship_opt
    if args.virtual and args.device != 'cpu':
        raise SystemExit('--virtual runs gloo ranks on the CPU: pass '
                         '--device cpu')
    if args.device == 'cuda' and not torch.cuda.is_available():
        raise SystemExit('no CUDA device: pass --device cpu')
    if args.device == 'cpu':
        visible = args.virtual or 1
    else:
        visible = torch.cuda.device_count()
    if args.chips is None:
        chips, n = [], 1
        while n <= visible:
            chips.append(n)
            n *= 2
    else:
        chips = args.chips
    if max(chips) > visible:
        raise SystemExit(f'asked for {max(chips)} devices, '
                         f'only {visible} visible')

    shape_kw = dict(frame_embedding_num=200, max_caption_len=20)
    if args.virtual and not args.full_shapes:
        shape_kw = dict(VIRTUAL_SHAPES)
    rows = []
    for n in chips:
        opt = flagship_opt(tpu_mesh_data=n, **{**shape_kw, **overrides})
        B = args.batch_per_chip * n
        step_ms = parallel.run(point, n, B, args.device, opt, args.model, B,
                               args.n1, args.n2)
        rows.append({'chips': n, 'batch_global': B,
                     'step_ms': round(step_ms, 3),
                     'videos_per_sec': round(B / step_ms * 1e3, 2),
                     'videos_per_sec_per_chip':
                         round(B / step_ms * 1e3 / n, 2)})
        print(json.dumps(rows[-1]), flush=True)

    # the baseline is the 1-card point where the sweep has one, else its
    # smallest point, named, so that efficiencies against 2 cards are not
    # read as absolute
    base = next((r for r in rows if r['chips'] == 1), rows[0])
    for r in rows:
        r['scaling_efficiency'] = round(
            r['videos_per_sec_per_chip'] /
            base['videos_per_sec_per_chip'], 4)
        r['psum_overhead_ms'] = round(r['step_ms'] - base['step_ms'], 3)
    summary = {'metric': 'dp_scaling_sweep', 'model': args.model,
               'virtual': bool(args.virtual),
               'baseline_chips': base['chips'],
               'platform': 'gpu' if args.device == 'cuda' else 'cpu',
               'device': card_label(args.device), 'rows': rows}
    print(json.dumps(summary), flush=True)
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(summary, f, indent=1)
    return summary


if __name__ == '__main__':
    main(sys.argv[1:])
