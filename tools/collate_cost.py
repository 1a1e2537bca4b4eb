#!/usr/bin/env python3
"""Host time of collating one training batch of the flagship recipe
(``cfgs/yc2_newModel_sound.yml``: 200 frames of 768 features, sound
features for every other video) from ``chip_smoke.py``'s synthetic
training set, through the port's ``FusionBatchLoader``; and the bytes of
the batch after caption-length bucketing.

    python tools/collate_cost.py [--batch_size 16] [--videos 48] [--reps 3]

Runs on the host CPU and builds no model; its times say nothing about
the card.  ``chip_smoke.py`` (phase 10, ``input_costs``) measures the
same collation on the chip's host.
"""

import argparse
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from dvc_tpu_torch.data import FusionBatchLoader, FusionDataset  # noqa: E402
from dvc_tpu_torch.train import bucket_caption_length  # noqa: E402
from dvc_tpu_torch.utils.config import load_config, parse_opts  # noqa: E402


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch_size', type=int, default=16)
    parser.add_argument('--videos', type=int, default=48)
    parser.add_argument('--reps', type=int, default=3)
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        recipe = chip_smoke.write_synthetic_run(
            tmp, load_config(chip_smoke.CFG, root=ROOT),
            n_videos=args.videos, seed=5)
        opt = parse_opts(['--cfg_path', recipe, '--device', 'cpu'],
                         root=ROOT)
        ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                           opt.dict_file, opt, seed=opt.seed)
        batches = iter(FusionBatchLoader(ds, args.batch_size, True, opt,
                                         seed=1))
        times = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            batch, _ = next(batches)
            times.append(time.perf_counter() - t0)
        mb = sum(np.asarray(v).nbytes
                 for v in bucket_caption_length(batch).values()) / 2**20
    print(f'collation of a B={args.batch_size} batch, host CPU: '
          f'{", ".join(f"{t * 1e3:.1f}" for t in times)} ms; '
          f'{mb:.1f} MiB after bucketing')


if __name__ == '__main__':
    main()
