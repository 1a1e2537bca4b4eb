#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (one or more lines each; the last line is the JSON verdict):

1. device — the card's name, count and ``nvidia-smi`` name and power limit;
   no CUDA device is an error (there is no CPU carry-on).
2. build  — compile the hand-written kernels of ``dvc_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build time and ptxas resource lines.
3. kernels vs plain — each kernel against its plain PyTorch
   version on the card at the serving and training paths' shapes (TF32
   off), with errors, CUDA-event times and each kernel's bound (bytes over
   the HBM rate or f32 operations over the CUDA cores' peak); the tables'
   GEMM and its backward (the table VW = value . Wc of K7-K10, and
   embed . token_w) and the weight gradients' outer sums that K5 and K10
   run inside their launches (``[kernels] outer_sum``, through the
   library's ``dvc_dsa_gemm``) against torch.einsum, each beside
   torch.matmul and bounded at 3xTF32 on the tensor cores (the GEMM's
   design; the f32 bound printed beside it), the outer sums also in units
   of their products' size against one-pass TF32; the MSDA backward (K3:
   a block per (query tile, head, video) adds into the head's dvalue slice
   in shared memory, its value slice staged beside it where it fits, and
   stores the slice once, or adds it into dvalue where the queries of a
   (video, head) pair take several tiles) at B=1 and at the B=16 train
   step's shapes and on the encoder's locations, each also in the
   profiler's device time; the scan also at cap_nheads 8,
   the word-step kernels (K7-K10, each with VW given; K8's and K10's
   gradients composed with the table's backward) at the stepwise path's
   train (B=1, Q=90) and serve (B=16, Q=100, H=1 and 8) shapes, to the
   scan's tolerances (``check_step``); then the phase split of the
   kernels the latest slices redesigned (``FULL_RUN_SPLITS``, K4-K6-bf16;
   one ``[split]`` line per kernel and shape; ``--split current`` splits
   every kernel of ``SPLITS['current']``, K1-K10 and their bf16 modes,
   K3's also with its value rows read through L2 in place of the staged
   slice).
   Tolerances:
   MSDA forward max abs error <= 1e-4 * max|out|, and each of its
   gradients <= 1e-4 * its max |ref|; greedy tokens equal and log-probs
   within 1e-3 on every (video, step, query) whose plain-version top-2
   logit margin exceeded 1e-3 at that step and all earlier ones (after a
   near-tie the fed-back tokens may differ, so the rest of that query's
   decode is not comparable); scan hs and cs <= 1e-4 * max|ref|, each of
   its 13 gradients <= 1e-3 * its max |ref| + 1e-5, with a wider floor for
   the one that is zero in exact arithmetic (``check_scan``).
   3b. The assignment solver (``[assignment]``; ``--assignment`` runs the
   build and this alone): the kernel against its plain version on the
   card at the flagship matcher's (layers, videos, G, Nq) = (3, 16, 30,
   100) with real counts drawn from 0 to 30, on tied integer costs, with
   nan / +-inf entries, and at anet's (3, 16, 30, 10), where both G > Nq
   rules occur (``ASSIGNMENT_CASES``): col4row and the Dijkstra steps
   exactly equal, every total within 1e-6 relative of scipy's optimum;
   the kernel's CUDA-event ms, the plain version's, and the host-clock ms
   of the scipy round trip it replaces (copy, 48 solves, upload).
   ``--ab-matcher <parent checkout>`` times a B=16 train step and traces
   one (idle share) in this tree and the parent's in turns, four runs a
   side (not gated).
4. serve  — the FusionPDVC of ``cfgs/yc2_newModel_sound.yml`` at full width
   with seeded random weights behind the port's ``DenseCaptioner``: four
   requests of different lengths and durations, with and without sound,
   checked for well-formed events; one B=16 batch timed (videos/s) and one
   traced with ``torch.profiler`` (each kernel's share of the batch, the
   card's idle share).  Both kernels' launch counters must rise, no
   word-step kernel may launch and no plain version may run.
5. agreement — the same model's raw outputs on the card against the CPU
   run of the plain versions on one video.
6. train — ``dvc_tpu_torch.new_train.main`` for one ``--debug`` epoch (5
   steps at B=1) of the same recipe on a synthetic run written to a temp
   dir (16 training videos, a held-out val set of 16 and its paragraph
   ground truth), which validates after the epoch (6 val videos): finite
   losses, the launch counters of the MSDA forward and backward, of the
   scan forward and backward and of the greedy decode must rise, no
   word-step kernel may launch and no plain version may run;
   one assignment launch a train step and a val batch, no device-to-host
   copy in the matcher; ``epoch1.json`` with finite METEOR and soda_c,
   ``val_history`` in
   ``info.json`` and ``model-best.pth``, which ``DenseCaptioner(folder)``
   (``which='best'``) serves for one request on the card; the total loss
   falls on a repeated batch; the train step timed at B=1 and B=16 and one
   B=16 step traced.
7. train agreement — one train step's losses and gradients on the card
   against the CPU plain path (same weights and batch, dropout off), the
   card taking the CPU's matching of every layer; the card's own matching
   equal to it or a near-tie (the CPU's within MATCH_TIE_TOL relative of
   the card's own cost; Hungarian near-ties flip on ulps).
8. stepwise — the stepwise caption path: ``new_train.main`` for two
   --debug epochs with scheduled sampling from epoch 1 (ss_prob 0.25),
   once through K7/K8 and once with --dsa_lstm_fuse 1 through K9/K10 (the
   fused scan K4/K5 in epoch 0; one launch per word step, and under either
   flag one table VW and one table backward per train step; no plain
   version; tokens fed by scheduled sampling; each epoch validated, with
   ``model-best.pth`` written), the step timed at B=1 and B=16; the second
   run's checkpoint served with --dsa_greedy_fuse
   0 through K7 and K9 against the fused greedy kernel (>= 90% of the
   captions identical); the train agreement of phase 7 with
   --dsa_scan_fuse 0 for both pairs.
9. eval — ``dvc_tpu_torch.run_eval`` on phase 6's run folder over the 16
   val videos at --eval_batch_size 16 and 1, counters set to 0 before each
   run and read after: at least 6 K1/K2 launches and exactly one K6 launch
   per batch, no word-step kernel, no plain version; ``eval_results.json``
   well formed (timestamps in [0, duration], string sentences, 16 videos)
   with finite METEOR, soda_c, para_METEOR, Recall and Precision;
   ``--eval_mode test`` writes ``dvc_results.json`` without scores; the
   B=16 run's time split by part (the eval step with a synchronize around
   it, the matcher's calls in it, postprocess, records, and the
   metric stack's dvc, SODA and paragraph parts), with the card's name and
   power limit; one B=16 eval step traced; two val videos evaluated on the
   CPU (plain versions) and on the card, held to phase 5's gates (>= 90%
   of captions identical, timestamps and proposal scores within 1e-3
   relative where they agree), with both runs' METEOR and soda_c printed
   (not gated).  Each run's matcher makes one assignment launch a batch
   and no device-to-host copy (the matcher's ``copies`` count, gated at
   0; phase 6's run one launch a step and a val batch).
10. pipeline — the input layer's costs at B=16 (collation, pageable and
   pinned uploads, host clock); then ``new_train.main`` for one epoch at
   B=16 over 320 synthetic training videos (20 steps, no validation), five
   times with the same seed: --device_prefetch 1 (batches collated in a
   worker thread, uploaded from pinned memory on the trainer's copy stream
   one step ahead), 0, 0, 1, and 1 with the epoch collated before its
   first step (the loop without collation): the same videos at every
   step, the first step's losses within 1e-6 relative, every loss finite,
   the same launch counts, no plain version, one assignment launch a step
   and no matcher copy;
   each run's ms per step of the loop (host clock, steps 2-11, collation
   and upload included) and the idle share of a profiler trace over
   steps 12-14, with the card's name and power limit.  The collation reads
   and resamples through the native feature-IO library: its call count
   (``native_io.calls``) must rise in every run, and the B=16 collation ms
   is printed beside PR 20's (numpy only; not gated).
11. sampling — phase 6's ``model-best.pth`` served with
   --caption_sample_max 0 on a B=16 batch at temperatures 1.0 and 0.5
   through K7, and 1.0 through K9 (--dsa_lstm_fuse 1): one word-step
   launch a decode step and one table, no K6 launch, no plain version;
   tokens in the vocabulary, log-probs finite and <= 0; two videos'
   sampled tokens teacher-forced on the CPU plain path (dropout off),
   log-probs within 1e-3 of the card's up to each caption's first EOS;
   each sampled ``caption_batch`` timed beside the greedy one.
12. pretrain — --pretrain encoder from phase 6's ``model-best.pth`` into a
   fresh Trainer on the card (``new_train.pretrain``, what
   ``new_train.main`` calls): the encoder's parameters equal the source's,
   the rest the fresh initialisation.
13. plain PDVC — ``dvc_tpu_torch.run_train`` at four recipes' full widths
   on synthetic features of their own types (16 train and 16 val videos
   each), counters set to 0 before each run and read after: (a)
   ``cfgs/yc2_tsp_pdvc.yml`` (LSTM-DSA) one --debug epoch with validation
   (K1-K6 launched, no K7-K10, no plain version; ``epoch1.json`` scored,
   ``model-best.pth``; ``metrics.jsonl`` with ``lr``, ``videos_per_sec``,
   each ``train/<loss>`` and each ``val/<score>`` at the step count, all
   finite, ``backup/`` with ``cfgs/`` and ``dvc_tpu_torch/`` but no
   ``_build/``, the option table in ``train.log``), ``run_eval`` at B=16
   (one K6 launch) and
   ``DenseCaptioner(folder)``; (b) ``yc2_tsn_pdvcl.yml`` (light head,
   3072-d, 100 queries) the same with K1-K3 only, the light head's word
   loop timed at B=1 and 16, and two val videos' records on the card
   against the CPU (phase 9's gates); (c) ``yc2_tsn_pdvcl_gt.yml``
   (two-stage): every layer's boxes equal to the gt boxes within 1e-6,
   the ce, bbox and giou weights 0, finite losses of a train step, and
   ``run_eval`` writing one record a gt slot; (d) ``anet_c3d_props.yml``
   (no caption head): no caption kernel, empty sentences, finite Recall
   and Precision; (e) the standard recipe at --num_layers 2 (one K7 a
   decode step, one K7 and one K8 a training word step, one table and its
   backward, no K4-K6 or K9/K10, also under --dsa_lstm_fuse 1) and at
   --att_hid_size 0 (no word-step kernel); (f) phase 7's agreement for
   (a), (b) and --num_layers 2; (g) ``Trainer.train_steps`` of two
   batches against two single steps (phase 7's tolerance on the
   parameters, one loss copy) and ``run_train --steps_per_dispatch 2``
   (one device-to-host loss copy per two steps), both with one assignment
   launch a step and no matcher copy.
14. TSP — feature extraction and streaming (``--tsp`` runs it alone):
   MViTv2-S (16x224x224) and R(2+1)D-34 (16x112x112) at full width with
   seeded weights (no parameter left at 0 or 1), a batch of 32 clips in
   float32 (TF32 off) and bfloat16: ms a clip (CUDA events), peak memory
   and the bound (2 x the MACs of MViTv2-S's block table, or the flop
   counter's count, at 67 TFLOP/s f32 and 989 bf16), one bf16 MViTv2-S
   batch traced by kernel class; card f32 against CPU f32 on two clips
   (relative L2 <= 1e-3) and card bf16 against card f32 (<= 5e-2);
   ``python -m dvc_tpu_torch.extract_features`` on the card over three
   synthetic 30 s videos (cv2-written mp4v), then on a 3 s video in
   float32 on the card and on the CPU (<= 1e-3); a streaming
   ``run_train --debug`` of ``cfgs/yc2_tsp_mvit_ete.yml`` at full width
   (MViTv2-S bf16 features from a saved .pth, 3+3 layers, 100 queries,
   LSTM-DSA) over 8 train and 16 val videos (K1-K6 launched, no word-step
   kernel, no plain version, epoch 1 validated), then ``run_eval`` of its
   run folder at B=16 (K1/K2 launched, one K6); each run's time split
   into decode, backbone and PDVC steps.
15. TSP training (``--tsp-train`` runs it alone): ``TSPTrainer`` and
   ``python -m dvc_tpu_torch.train_tsp`` at full width with seeded weights
   in the three configurations of the launchers and the driver's default:
   R(2+1)D-34 (16x112x112) in float32 at the YC2 launcher's B=32 and lrs,
   MViTv2-S (16x224x224) in float32 and bfloat16, and R(2+1)D-34 under
   --train-bn 1.  For each: ms a train step (CUDA events; upload, forward,
   backward, SGD) on random clips, clips/s, peak memory and the bound (3 x
   the forward's operations at 67 TFLOP/s f32 or 989 bf16), at B=32 or the
   largest power of two that fits (stated); one step on 2 clips on the
   card against the CPU in float32 (TF32 off: losses 1e-4 relative, each
   updated tensor 1e-3 relative L2), bfloat16 against float32 on the card
   (losses within 5e-2); then the driver over synthetic 12 s videos and a
   groundtruth CSV (32 train segments x 2 clips, two steps an epoch at
   B=32; 16 valid segments): epoch 0 validated, then ``--resume`` from
   its ``tsp-last.pth`` for epoch 1, finite losses, no kernel of K1-K10
   launched (none lies on this path); the R(2+1)D-34 run's
   ``tsp-best.pth`` read by ``extract_features`` on the card.
16. bf16 (``--bf16`` runs it alone; after phase 12 in the full run) —
   ``--tpu_compute_dtype bfloat16 --fusion_dtype bfloat16`` on the main
   path: ``dsa::gemm``'s bf16 mode on two outer-sum shapes against the
   float64 product of the bf16-rounded operands (``GEMM_PRODUCT_TOL``);
   K6-bf16 at B=16 and B=1, cap_nheads 1 and 8, and K4-bf16 / K5-bf16 at
   the scan's shapes, each against its plain bf16 version (the TPU
   kernels' bf16 products), its distance held to BF16_FWD_SHARE (outputs)
   or BF16_BWD_SHARE (each gradient) of the plain f32 version's (greedy:
   the diverged share and the log-probs' relative L2 before a near-tie;
   scan: hs/cs and each gradient's relative L2, zero cotangent on queries
   near a tap boundary), and its output at least BF16_ROUNDS of the plain
   bf16 version's distance from the plain f32 version (the kernel
   rounds); the table form's plain mirror printed beside, bf16 and f32
   kernel times side by side; a B=16 ``caption_batch`` in bf16 and f32 in
   turns (K1/K2 and K6-bf16 launched, no f32 K6); ``new_train.main
   --debug`` with the bf16 flags (five steps and a validation; K1-K3 f32,
   K4-, K5- and K6-bf16 launched, no f32 K4-K6), the B=1 and B=16 step in
   bf16 and f32 in turns and one B=16 step of each traced; the card
   against the CPU on one bf16 step under the CPU's matching
   (``bf16_train_agreement``: losses 1e-2 relative; each parameter's
   gradient within BF16_GRAD_SHARE x the larger of its f32 and its
   f32-ulp-noise distances + BF16_GRAD_FLOOR, the median of card over
   f32 at most 1.5, and the card's gradients as far from f32 as the
   CPU's, at least BF16_ROUNDS); ``run_eval`` of that run at B=16 (one
   K6-bf16 a batch).  Then the stepwise caption routes in bf16: the table
   GEMM's bf16 mode and K7-bf16 to K10-bf16 at B=1 (Q=90) and B=16
   (Q=100), cap_nheads 1 and 8, each against its plain bf16 table form
   (within BF16_MIRROR_FWD / BF16_MIRROR_BWD of plain f32's distance; K7's
   ctx and K8's and K10's dpos and dhvec not rounded to bf16,
   BF16_EXACT_MAX) and its plain product form (the forward within
   BF16_FWD_SHARE, each gradient within BF16_STEP_GAP of plain f32's
   distance), rounding (BF16_ROUNDS),
   zero cotangent on queries near a tap boundary, bf16 and f32 kernel times
   side by side; ``new_train.main --debug`` with the bf16 flags and
   --dsa_scan_fuse 0 --dsa_greedy_fuse 0 (K7-bf16/K8-bf16), the same with
   --dsa_lstm_fuse 1 (K9-bf16/K10-bf16) and with scheduled sampling from
   epoch 1 (--scheduled_sampling_start 0 --basic_ss_prob 0.25, two epochs:
   K4/K5-bf16, then K7/K8-bf16), each with the table's bf16 mode and no
   f32 word step or table; the B=16 stepwise step in f32 and bf16 in turns
   and traced (device activities); the card against the CPU on one bf16
   stepwise step (``bf16_train_agreement``); ``run_eval`` of the
   --dsa_greedy_fuse 0 run greedy and with --caption_sample_max 0 (K7-bf16
   a decode step, one table a batch).
17. inputs (``--inputs`` runs it alone) — the reference's own
   checkpoints: the flagship FusionPDVC and ``cfgs/yc2_tsp_pdvc.yml``'s
   plain PDVC with seeded weights at full width, saved as the reference
   saves them (``{'model', 'epoch', 'optimizer'}``, keys under
   ``module.``, with the dead sampler keys, the ``bbox_head`` aliases, the
   dormant branch, ``enc_output`` and, for the NewModel, a ``sound_model.*``
   tensor) and as the port saves them; each served for one B=16 batch
   through ``DenseCaptioner`` (K1/K2 and one K6, no word-step kernel, no
   plain version), the reference file's tokens and log-probs bitwise
   those of the port's; ``run_eval --eval_checkpoint_path`` on the
   reference's file at B=16 (one K6); a file with one unknown key raises.
   The native feature-IO library's build time, and ``load_npy``,
   ``resize_feature`` (nearest and linear, 3 -> 5 rows too) and
   ``load_batch`` equal to their numpy versions on 16 files.  HuBERT-base
   at full width with seeded weights (no parameter left at 0 or 1), f32
   with TF32 off: the card against the port's CPU run on 1 s and 3 s
   segments (relative L2 <= 1e-4), ms a TSP-clip segment at B=1 and 16
   (CUDA events) and peak memory; ``FusionDataset``'s live-audio route
   over 16 synthetic stereo 44.1 kHz ``.wav`` files with the card's
   ``HubertExtractor`` (one corrupt: zeros; the cache written, then read
   back on a second pass with no model call); a B=16 ``caption_batch``
   from those sound features (K1/K2 and one K6, no plain version).
18. data parallel (``--ddp`` runs it alone) — ``dvc_tpu_torch.parallel`` on
   the one card: (a) ``torchrun --standalone --nproc_per_node 1`` running
   ``new_train``'s entry point with ``--tpu_mesh_data 1`` on a full-width
   synthetic run of DDP_VIDEOS videos at B=16 (one --debug epoch of 5 steps
   and its validation): a one-rank NCCL group whose all-reduces (the
   losses' counts, the gradients' flat buckets, the losses) run on the
   card; the worker's launch counts of K1-K6 (> 0, no plain version) and
   its ms a step (host clock, synchronised, steps 2-5) beside the same run
   without a group, and, in the worker after its run, B=16 steps with the
   collectives on and off in turns and the gradient sum alone
   (``world_one_costs``); (b) two gloo ranks, both on cuda:0 (gloo on CUDA
   tensors, checked), at a global B=16 (8 a rank) for two steps against one
   process at B=16 on the card, from seeded weights with the sampling
   offsets moved off the tap boundaries (``off_boundary_``), taking the one
   process's matching (their own may differ only where its cost is within
   DDP_TIE_TOL of theirs): the losses within 1e-4 relative; the first
   step's summed gradients (1e-3 relative L2, phase 7's floors) and the
   parameters after the second step (atol 2e-5 + rtol 1e-3,
   tests/test_torch_train.py's exceptions) each within the larger of its
   tolerance and twice the one process's own rounding floor (its step
   repeated, where atomics differ, and its split arithmetic, each rank's
   rows in turn with no collective, ``split_steps``, against its
   whole-batch step, whose losses must first be within 1e-4 of it), and
   against that split arithmetic within the larger of the tolerance and
   twice the repeat's; equal on both ranks; K3-K5
   launched on each rank; (c) ``r2plus1d_34`` under ``--train-bn 1``
   (BatchNorm on the global batch's statistics) on two gloo ranks on the
   card at a global batch of DDP_TSP_BATCH clips against one process, in
   float64: losses and parameters within (b)'s tolerances, every tensor
   within DDP_F64_TOL of its largest entry; the float32 comparison beside
   the one process against itself, not gated (at random weights the float32
   step is chaotic); (d) ``new_train`` with one rank more than the visible
   cards raises before it makes a run folder.
Then a check that neither JAX nor any module of the JAX package
``dvc_tpu`` (by name or by file) was imported.

Nothing catches a phase's failure: any failure exits non-zero and the last
line ``{"ok": true, ...}`` is printed only when every phase passed.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

MSDA_LEVELS = (200, 100, 50, 25)      # T = 200 frames, 4 levels, S = 375
# the word-step kernels of the stepwise caption path and their table VW
# (built by the caption head), which the default flags (fused scan and
# greedy decode) never launch
STEP_KERNELS = ('dsa_step_fwd', 'dsa_step_bwd', 'dsa_lstm_fwd',
                'dsa_lstm_bwd', 'table_gemm', 'table_gemm_bwd')
# the same in their bf16-operand mode (K7-bf16 to K10-bf16, the table's)
STEP_KERNELS_BF16 = tuple(f'{k}_bf16' for k in STEP_KERNELS)
CFG = 'cfgs/yc2_newModel_sound.yml'
DEVICE = 'cuda'                       # of the train phases (a CPU rehearsal
                                      # at a tiny size sets 'cpu')
ROOT = os.path.dirname(os.path.abspath(__file__))


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events, 1 warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps):
    """Mean milliseconds of device time of ``fn()``: its kernels' durations
    under ``torch.profiler`` (1 warm-up), apart from the host's time to
    launch them, which ``cuda_ms`` includes where the host is the slower."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.key_averages()) / reps / 1e3


# --------------------------------------------------------------------------
# 1. device
# --------------------------------------------------------------------------

def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: the port smoke run needs a GPU')
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(f'[device] torch {torch.__version__} cuda {torch.version.cuda} '
          f'device {name} count {count}')
    print(card)
    return {'platform': 'gpu', 'kind': name, 'count': count, 'smi': card}


# --------------------------------------------------------------------------
# 2. build
# --------------------------------------------------------------------------

def phase_build():
    from dvc_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    lib = _cuda.lib()
    seconds = time.perf_counter() - t0
    print(f'[build] {lib.path}: nvcc {lib.build_seconds:.1f} s, '
          f'load {seconds:.1f} s')
    for line in lib.build_log.splitlines():
        if 'registers' in line or 'spill' in line or 'error' in line:
            print(f'[build] {line.strip()}')


# --------------------------------------------------------------------------
# 3. kernels vs plain
# --------------------------------------------------------------------------

def msda_inputs(gen, B, Q, H=8, D=64, P=4):
    import torch
    L, S = len(MSDA_LEVELS), sum(MSDA_LEVELS)
    dev = 'cuda'
    value = torch.randn((B, S, H, D), generator=gen, device=dev)
    loc = torch.rand((B, Q, H, L, P), generator=gen, device=dev) * 1.2 - 0.1
    attn = torch.softmax(torch.randn((B, Q, H, L * P), generator=gen,
                                     device=dev), -1).reshape(B, Q, H, L, P)
    return value, loc, attn


def msda_encoder_inputs(gen, B, H=8, D=64, P=4, frames=3.0):
    """The encoder's self-attention operands (Q = S = 375): each query
    samples near its reference point (``encoder_reference_points``, valid
    ratios 1) at offsets of up to ``frames`` frames of each level, so the
    taps of neighbouring queries land on the same value rows."""
    import torch
    from dvc_tpu_torch.models.deformable_transformer import \
        encoder_reference_points
    L, S = len(MSDA_LEVELS), sum(MSDA_LEVELS)
    dev = 'cuda'
    ref = encoder_reference_points(MSDA_LEVELS,
                                   torch.ones((B, L), device=dev))
    T = torch.tensor(MSDA_LEVELS, dtype=torch.float32, device=dev)
    off = (torch.rand((B, S, H, L, P), generator=gen, device=dev) * 2 - 1
           ) * frames
    loc = ref[:, :, None, :, None, 0] + off / T[:, None]
    value = torch.randn((B, S, H, D), generator=gen, device=dev)
    attn = torch.softmax(torch.randn((B, S, H, L * P), generator=gen,
                                     device=dev), -1).reshape(B, S, H, L, P)
    return value, loc, attn


def greedy_inputs(gen, B, Q, H, d=512, R=512, A=512, E=512, V1=1608, P=4):
    """Random operands at the caption head's serving shapes, scaled like
    fan-in-normalised weights so activations and logits are O(1)."""
    import torch
    dev = 'cuda'
    Dh = d // H
    L, S = len(MSDA_LEVELS), sum(MSDA_LEVELS)
    LP = L * P

    def w(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5

    T = torch.tensor(MSDA_LEVELS, dtype=torch.float32, device=dev)
    base_pos = (torch.rand((B, H, Q, L, P), generator=gen, device=dev)
                * T[:, None] - 0.5).reshape(B, H, Q, LP)
    scale_t = torch.rand((B, Q, LP), generator=gen, device=dev) * 2.0 + 0.2
    return (torch.randn((B, H, S, Dh), generator=gen, device=dev), base_pos,
            scale_t, w(B, Q, 4 * R, fan_in=4), w(V1, E, fan_in=4),
            w(E, 4 * R, fan_in=E), w(R, V1, fan_in=R / 4),
            w(V1, fan_in=100), w(H, R, LP, fan_in=R), w(R, A, fan_in=R),
            w(A, fan_in=100), w(Dh, A, fan_in=Dh), w(A, fan_in=100),
            w(A, fan_in=A), torch.tensor(0.05, device=dev),
            w(H, Dh, 4 * R, fan_in=d),
            w(R, 4 * R, fan_in=R))


def greedy_agreement(tok, lp, ref_tok, ref_lp, margin, thr=1e-3):
    """(comparable mask, token mismatches, max |lp diff|) under the rule of
    the module doc: compare a (b, k, q) only while every step so far had a
    plain-version top-2 margin above ``thr``."""
    import torch
    ok = torch.cumprod((margin > thr).to(torch.int32), dim=1).bool()
    mismatches = int(((tok != ref_tok) & ok).sum())
    lp_err = float(((lp - ref_lp).abs() * ok).max())
    return ok, mismatches, lp_err


# the card's peaks for bound_ms (NVIDIA's H100 SXM data sheet, dense, at the
# full 700 W): HBM bytes/s and float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12     # dense, on the tensor cores


def bound(n_bytes, flops):
    """(least ms, what bounds it): the larger of the bytes the function must
    move (each input read once, each output written once) over the HBM rate
    and its operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def tc_bound(n_bytes, flops):
    """(least ms, what bounds it) of a GEMM on the tensor cores at f32
    accuracy (3xTF32: three TF32 products for each f32 one): the larger of
    the bytes over the HBM rate and 3 x its operations over the TF32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 3 * flops / TF32_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def msda_bound(value, loc, attn, out):
    """Forward: per (b, q, h, l, p, d) two lerp products and a sum (3) plus
    the attention product and sum (2)."""
    B, S, H, D = value.shape
    return bound(nbytes(value, loc, attn, out), 5.0 * loc.numel() * D)


def msda_bwd_bound(value, loc, attn, g, grads):
    """Backward: per (b, q, h, l, p, d) the sample and the tap difference
    (4), their two products with g and sums (4), and the two dvalue
    products (4)."""
    D = value.shape[3]
    return bound(nbytes(value, loc, attn, g, *grads), 12.0 * loc.numel() * D)


def check_msda(gen, B, Q):
    from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                  ms_deform_attn_ref)
    value, loc, attn = msda_inputs(gen, B, Q)
    out = ms_deform_attn(value, MSDA_LEVELS, loc, attn)
    ref = ms_deform_attn_ref(value, MSDA_LEVELS, loc, attn)
    err = float((out - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    ms = cuda_ms(lambda: ms_deform_attn(value, MSDA_LEVELS, loc, attn), 50)
    dev_ms = device_ms(lambda: ms_deform_attn(value, MSDA_LEVELS, loc, attn),
                       50)
    plain_ms = cuda_ms(
        lambda: ms_deform_attn_ref(value, MSDA_LEVELS, loc, attn), 10)
    bound_ms, bound_by = msda_bound(value, loc, attn, out)
    print(f'[kernels] msda_fwd B={B} Q={Q} S={value.shape[1]} H=8 D=64 '
          f'L=4 P=4: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} '
          f'ms (device {dev_ms:.4f}) plain {plain_ms:.4f} ms bound '
          f'{bound_ms:.4f} ms ({bound_by})')
    if not err <= tol:
        raise AssertionError(f'msda_fwd Q={Q}: error {err} > {tol}')
    return {'B': B, 'Q': Q, 'max_abs_err': err, 'ms': ms,
            'device_ms': dev_ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by}


def check_msda_bwd(gen, B, Q, encoder=False):
    """K3 against autograd through the plain version, on uniform locations
    (``msda_inputs``) or, with ``encoder``, on the encoder's (Q = S,
    ``msda_encoder_inputs``); tolerance per gradient 1e-4 * its max |value|
    (dvalue is summed with atomics in no fixed order, the reductions over D
    in another order)."""
    import torch
    from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn_bwd,
                                                  ms_deform_attn_bwd_ref)
    value, loc, attn = (msda_encoder_inputs(gen, B) if encoder
                        else msda_inputs(gen, B, Q))
    Q = loc.shape[1]
    g = torch.randn((B, Q, value.shape[2] * value.shape[3]), generator=gen,
                    device='cuda')
    got = ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn, g)
    want = ms_deform_attn_bwd_ref(value, MSDA_LEVELS, loc, attn, g)
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ms = cuda_ms(lambda: ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn, g),
                 50)
    dev_ms = device_ms(
        lambda: ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn, g), 50)
    plain_ms = cuda_ms(
        lambda: ms_deform_attn_bwd_ref(value, MSDA_LEVELS, loc, attn, g), 10)
    bound_ms, bound_by = msda_bwd_bound(value, loc, attn, g, got)
    where = ' encoder locations' if encoder else ''
    print(f'[kernels] msda_bwd B={B} Q={Q}{where} S={value.shape[1]} H=8 '
          f'D=64 L=4 P=4: max_abs_err {err:.3e}, relative (dvalue, dloc, '
          f'dattn) {[f"{e:.2e}" for e in errs]} (tol 1e-4) kernel {ms:.4f} '
          f'ms (device {dev_ms:.4f}) plain {plain_ms:.4f} ms bound '
          f'{bound_ms:.4f} ms ({bound_by})')
    if not max(errs) <= 1e-4:
        raise AssertionError(f'msda_bwd Q={Q}{where}: relative errors {errs}')
    return {'B': B, 'Q': Q, 'encoder': encoder, 'max_abs_err': err,
            'ms': ms, 'device_ms': dev_ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


def lerp_rows_macs(n, B, H, S, LP, Dh, W, per_tap):
    """Least MACs of one product of a (Dh, W) weight per head with rows that
    are lerps of two value rows, over n (video, query, step) triples.  Either
    each triple multiplies its own rows (its H*LP taps when the product is
    taken per tap, as in the scores' taps . Wc; its H attended rows
    otherwise, as in ctx . ctx_w3, which first cost 2*Dh per tap to form),
    or each video multiplies its S value rows once (B*H*S*Dh*W) and each
    triple then lerps two W-wide rows of that table per tap (2*W)."""
    direct = n * H * Dh * W * (LP if per_tap else 1)
    if not per_tap:
        direct += n * H * LP * 2 * Dh
    table = B * H * S * Dh * W + n * H * LP * 2 * W
    return min(direct, table)


def step_macs(n, B, H, S, LP, Dh, R, A):
    """Least MACs of n LSTM-DSA word steps without the token's input share:
    hvec R*A, offsets R*H*LP, the scores' taps . Wc (``lerp_rows_macs``)
    and their . aw (A per tap), ctx . ctx_w3 (``lerp_rows_macs``) and
    h . W_hh R*4R.  Elementwise work (tanh, softmax, the LSTM cell) is left
    out."""
    return (n * (R * A + R * H * LP + H * LP * A + R * 4 * R)
            + lerp_rows_macs(n, B, H, S, LP, Dh, A, True)
            + lerp_rows_macs(n, B, H, S, LP, Dh, 4 * R, False))


def greedy_bound(args, K):
    """The greedy decode's B*Q*K steps (``step_macs``), plus the token's
    input share embed[it] . W_ih (E*4R per step, or once per vocabulary
    row, (V+1)*E*4R, whichever is less) and the logits R*(V+1) per step."""
    macs, n = greedy_macs(args, K)
    import torch
    inputs = [t for t in args if torch.is_tensor(t)]
    return bound(nbytes(*inputs) + 8 * n, 2.0 * macs)


def greedy_macs(args, K):
    """(MACs, B*Q*K steps) of ``greedy_bound``."""
    value_t, base_pos, _, const_z, embed = args[:5]
    B, H, S, Dh = value_t.shape
    Q, LP = base_pos.shape[2], base_pos.shape[3]
    V1, E = embed.shape
    R = const_z.shape[2] // 4
    A = args[9].shape[1]
    n = B * Q * K
    return (step_macs(n, B, H, S, LP, Dh, R, A)
            + min(n, V1) * E * 4 * R + n * R * V1), n


def check_greedy(gen, B, Q, H, K=30):
    from dvc_tpu_torch.ops.dsa_greedy import (dsa_greedy_scan,
                                              dsa_greedy_scan_ref)
    args = greedy_inputs(gen, B, Q, H)
    tok, lp = dsa_greedy_scan(*args, MSDA_LEVELS, K)
    ref_tok, ref_lp, margin = dsa_greedy_scan_ref(*args, MSDA_LEVELS, K,
                                                  with_margin=True)
    ok, mismatches, lp_err = greedy_agreement(tok, lp, ref_tok, ref_lp,
                                              margin)
    frac = float(ok.float().mean())
    ms = cuda_ms(lambda: dsa_greedy_scan(*args, MSDA_LEVELS, K), 3)
    plain_ms = cuda_ms(lambda: dsa_greedy_scan_ref(*args, MSDA_LEVELS, K), 3)
    bound_ms, bound_by = greedy_bound(args, K)
    print(f'[kernels] dsa_greedy B={B} Q={Q} H={H} Dh={512 // H} S=375 LP=16 '
          f'A=R=E=512 V+1=1608 K={K}: compared {frac:.3f} of (b,k,q), '
          f'token mismatches {mismatches}, max |lp diff| {lp_err:.3e}, '
          f'all tokens equal {bool((tok == ref_tok).all())}; kernel '
          f'{ms:.3f} ms plain {plain_ms:.3f} ms bound {bound_ms:.3f} ms '
          f'({bound_by})')
    if mismatches or not lp_err <= 1e-3 or frac < 0.5:
        raise AssertionError(f'dsa_greedy H={H}: {mismatches} token '
                             f'mismatches, lp err {lp_err}, compared {frac}')
    return {'B': B, 'Q': Q, 'H': H, 'max_abs_err': lp_err,
            'compared': frac, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


def scan_inputs(gen, B, Q, K, H, R=512, A=512, d=512, P=4):
    """Random operands of the teacher-forcing scan at the caption head's
    training shapes, scaled like fan-in-normalised weights."""
    import torch
    dev = 'cuda'
    Dh = d // H
    L, S = len(MSDA_LEVELS), sum(MSDA_LEVELS)
    LP = L * P

    def w(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5

    T = torch.tensor(MSDA_LEVELS, dtype=torch.float32, device=dev)
    base_pos = (torch.rand((B, H, Q, L, P), generator=gen, device=dev)
                * T[:, None] - 0.5).reshape(B, H, Q, LP)
    scale_t = torch.rand((B, Q, LP), generator=gen, device=dev) * 2.0 + 0.2
    return (torch.randn((B, H, S, Dh), generator=gen, device=dev), base_pos,
            scale_t, w(B, K, Q, 4 * R, fan_in=4), w(H, R, LP, fan_in=R),
            w(R, A, fan_in=R), w(A, fan_in=100), w(Dh, A, fan_in=Dh),
            w(A, fan_in=100), w(A, fan_in=A), torch.tensor(0.05, device=dev),
            w(H, Dh, 4 * R, fan_in=d), w(R, 4 * R, fan_in=R))


def scan_macs(args):
    """(forward, backward) MACs of the whole scan.  Forward: its B*Q*K
    steps (``step_macs``; z_all already holds the token's share).
    Backward: three times that, since each product x . W of the step comes
    back as the recompute (hs and cs are the only stored activations), the
    input's gradient dy . W^T and the weight's gradient x^T . dy, each of
    the same size (the tables' forms: value^T G and G . W^T per video, with
    G the lerp-weighted scatter of the cotangent rows onto the value rows)."""
    value_t, base_pos, _, z_all = args[:4]
    B, H, S, Dh = value_t.shape
    K, Q, LP = z_all.shape[1], z_all.shape[2], base_pos.shape[3]
    R, A = args[5].shape
    fwd = step_macs(B * Q * K, B, H, S, LP, Dh, R, A)
    return fwd, 3 * fwd


def scan_positions(args, hs):
    """The tap positions (B, K, H, Q, LP) of the scan on the trajectory hs,
    in float64: base_pos + (h_{k-1} . off_w) * scale_t, h_{-1} = 0."""
    import torch
    base_pos, scale_t, off_w_h = args[1], args[2], args[4]
    h_prev = torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1).double()
    off = torch.einsum('bkqr,hrp->bkhqp', h_prev, off_w_h.double())
    return base_pos.double()[:, None] + off * scale_t.double()[:, None, None]


def on_integer(pos):
    """Mask of the tap positions pos (float64) within 2e-6 + 2^-23 |pos|
    of a level-relative integer."""
    return (pos - pos.round()).abs() <= 2e-6 + pos.abs() * 2.0 ** -23


def near_integer(pos):
    """(B, Q) mask of the queries with a tap position, at any step, within
    an ulp of a level-relative integer (``on_integer``); pos
    (B, [K,] H, Q, LP) in float64."""
    near = on_integer(pos).any(dim=-1)
    while near.dim() > 2:
        near = near.any(dim=1)
    return near


def plain_scan_bwd_on(*args):
    """The plain backward on a given trajectory: ``args`` = the 13
    operands, temporal_shapes, hs, cs, g, as for
    ``dsa_teacher_scan_bwd_ref``, which recomputes hs and cs.  Here each
    plain step's output h becomes hs[:, k] + (h - h.detach()), which has
    hs's value and h's gradient (c likewise).  So the scan backward is held
    to its own function on the kernel forward's trajectory; ``check_scan``
    holds that trajectory to the plain forward's separately."""
    import torch
    from dvc_tpu_torch.ops.dsa_greedy import (_level_bounds, attend_step,
                                              lstm_cell)
    *ops, temporal_shapes, hs, cs, g = args
    with torch.enable_grad():
        ops = [t.detach().requires_grad_() for t in ops]
        (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b, cw,
         cb, aw, ab, ctx_w3, w_hh) = ops
        B, K, Q = z_all.shape[:3]
        P = scale_t.shape[-1] // len(temporal_shapes)
        hib, s0 = _level_bounds(temporal_shapes, P, value_t.device)
        h = c = value_t.new_zeros((B, Q, w_hh.shape[0]))
        out = []
        for k in range(K):
            ctx = attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w,
                              h2att_b, cw, cb, aw, ab, hib, s0)
            z = (z_all[:, k] + h @ w_hh
                 + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3))
            h, c = lstm_cell(z, c)
            h = hs[:, k] + (h - h.detach())
            c = cs[:, k] + (c - c.detach())
            out.append(h)
        return torch.autograd.grad(torch.stack(out, 1), ops, g)


def boundary_report(args, hs, ref_hs, g, got, want):
    """What taps near a level-relative integer do to the scan backward's
    comparison with the plain one, under the cotangent g: the taps within
    an ulp of an integer (``near_integer``) on K4's trajectory hs, the taps
    on another side of one on the plain forward's trajectory ref_hs, and
    the worst relative error of the per-query gradients (base_pos, scale_t,
    z_all) of ``got`` (K5's) on the queries those taps touch and on the
    rest, against ``want`` (the plain backward on hs) and against the plain
    backward on its own trajectory.  There the tap pair, and so the
    gradient with respect to the position, jumps, and two sums of
    h . off_w that round differently may land on two sides (ROADMAP C)."""
    from dvc_tpu_torch.ops.dsa_scan import dsa_teacher_scan_bwd_ref
    pos, ref_pos = scan_positions(args, hs), scan_positions(args, ref_hs)
    on = on_integer(pos)
    across = pos.floor() != ref_pos.floor()
    near, crossed = near_integer(pos), across.any(4).any(2).any(1)

    def split(want, odd):
        errs = []
        for i, qdim in ((1, 2), (2, 1), (3, 2)):   # base_pos, scale_t, z_all
            shape = [1] * got[i].dim()
            shape[0], shape[qdim] = odd.shape
            m = odd.view(shape)
            err = (got[i] - want[i]).abs() / (float(want[i].abs().max())
                                             + 1e-2)
            errs.append((float((err * m).max()), float((err * ~m).max())))
        return max(e[0] for e in errs), max(e[1] for e in errs)

    mine = split(want, near)
    own = split(dsa_teacher_scan_bwd_ref(*args, MSDA_LEVELS, ref_hs, None, g),
                near | crossed)
    return (f'{int(on.sum())} taps within an ulp of an integer '
            f'({int(near.sum())} queries), {int(across.sum())} on another '
            f'side of one than in the plain forward\'s trajectory '
            f'({int(crossed.sum())} queries); worst relative error of '
            f'base_pos, scale_t, z_all against the plain backward on the '
            f'kernel\'s trajectory: {mine[0]:.2e} on the queries near an '
            f'integer, {mine[1]:.2e} on the rest; on its own trajectory: '
            f'{own[0]:.2e} on the queries near or across one, {own[1]:.2e} '
            f'on the rest')


def check_scan(gen, B, Q, K, H):
    """K4 and K5 against the plain scan and autograd through it.
    Tolerances: hs and cs max abs error <= 1e-4 * max|ref|; each of the 13
    gradients <= 1e-3 * its max |ref| + 1e-5 (K recurrent f32 steps summed
    in another order, atomics in dvalue, dWc and the bias sums), as in
    ``tests/test_torch_cuda_kernels.py``.  d alpha_b alone has the floor
    max(5e-5, 2.5e-10 * B*K*Q*H*LP) in place of 1e-5: it is zero in exact
    arithmetic because the softmax's gradients sum to zero, so both sides
    hold only the rounding of a sum of B*K*Q*H*LP terms in no fixed order
    (up to about 1e-5 at B=1 and 3e-5 at B=16 in the runs so far).  K5
    is held to the plain backward on K4's trajectory (``plain_scan_bwd_on``;
    the forward is held to the plain one above, and K5 recomputes its tap
    positions from K4's); ``boundary_report`` prints what the taps near a
    level-relative integer do to that comparison and to one with the plain
    backward on its own trajectory."""
    import torch
    from dvc_tpu_torch.ops.dsa_scan import (NAMES, dsa_teacher_scan_bwd,
                                            dsa_teacher_scan_bwd_ref,
                                            dsa_teacher_scan_fwd,
                                            dsa_teacher_scan_ref)
    args = scan_inputs(gen, B, Q, K, H)
    hs, cs = dsa_teacher_scan_fwd(*args, MSDA_LEVELS)
    ref_hs, ref_cs = dsa_teacher_scan_ref(*args, MSDA_LEVELS)
    fwd_err = max(float((hs - ref_hs).abs().max()),
                  float((cs - ref_cs).abs().max()))
    fwd_tol = 1e-4 * max(float(ref_hs.abs().max()), float(ref_cs.abs().max()))
    g = torch.randn(hs.shape, generator=gen, device='cuda')
    grads = dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g)
    want = plain_scan_bwd_on(*args, MSDA_LEVELS, hs, cs, g)
    boundary = boundary_report(args, hs, ref_hs, g, grads, want)
    H, LP = args[1].shape[1], args[1].shape[3]
    atol = {n: 1e-5 for n in NAMES}
    atol['ab'] = max(5e-5, 2.5e-10 * B * K * Q * H * LP)
    rel = {n: float((a - b).abs().max())
           / (float(b.abs().max()) + atol[n] / 1e-3)
           for n, a, b in zip(NAMES, grads, want)}
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, want))
    fwd_ms = cuda_ms(lambda: dsa_teacher_scan_fwd(*args, MSDA_LEVELS), 3)
    fwd_plain = cuda_ms(lambda: dsa_teacher_scan_ref(*args, MSDA_LEVELS), 3)
    bwd_ms = cuda_ms(
        lambda: dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g), 3)
    bwd_plain = cuda_ms(lambda: dsa_teacher_scan_bwd_ref(
        *args, MSDA_LEVELS, hs, cs, g), 3)
    fwd_macs, bwd_macs = scan_macs(args)
    inputs = [t for t in args if torch.is_tensor(t)]
    fwd_bound = bound(nbytes(*inputs, hs, cs), 2.0 * fwd_macs)
    bwd_bound = bound(nbytes(*inputs, hs, cs, g, *grads), 2.0 * bwd_macs)
    print(f'[kernels] dsa_scan_fwd B={B} Q={Q} K={K} H={H} Dh={512 // H} '
          f'S=375 LP=16 A=R=512: max_abs_err {fwd_err:.3e} (tol '
          f'{fwd_tol:.3e}) kernel {fwd_ms:.3f} ms plain {fwd_plain:.3f} ms '
          f'bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})')
    print(f'[kernels] dsa_scan_bwd B={B} Q={Q} K={K} H={H}: max_abs_err '
          f'{bwd_err:.3e}, worst relative {max(rel, key=rel.get)} '
          f'{max(rel.values()):.2e} (tol 1e-3, floor 1e-5, d alpha_b '
          f'{atol["ab"]:.2e}) kernel '
          f'{bwd_ms:.3f} ms plain '
          f'{bwd_plain:.3f} ms bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})')
    print(f'[kernels] dsa_scan_bwd B={B} Q={Q} K={K} H={H} boundary: '
          f'{boundary}')
    if not fwd_err <= fwd_tol or not max(rel.values()) <= 1e-3:
        raise AssertionError(f'dsa_scan B={B}: forward error {fwd_err}, '
                             f'gradient relative errors {rel}')
    return ({'B': B, 'Q': Q, 'K': K, 'max_abs_err': fwd_err, 'ms': fwd_ms,
             'plain_ms': fwd_plain, 'bound_ms': fwd_bound[0],
             'bound_by': fwd_bound[1]},
            {'B': B, 'Q': Q, 'K': K, 'max_abs_err': bwd_err, 'ms': bwd_ms,
             'plain_ms': bwd_plain, 'bound_ms': bwd_bound[0],
             'bound_by': bwd_bound[1]})


def check_table_gemm(gen, N, k, n, label):
    """The tables' GEMM (``table_gemm``: the kernel that K4-K6 run first in
    every launch, and that builds the word-step kernels' VW once per
    forward pass) against torch.einsum on the same inputs: max abs error
    <= 1e-5 * sqrt(k) * max|ref| (f32 sums of k terms in another order,
    TF32 off); torch.matmul timed beside it as a yardstick (library_ms),
    used nowhere in the port."""
    import torch
    from dvc_tpu_torch.ops.dsa_tables import table_gemm
    x = torch.randn((N, k), generator=gen, device='cuda')
    w = torch.randn((k, n), generator=gen, device='cuda') / k ** 0.5
    got = table_gemm(x, w)
    want = torch.einsum('nk,km->nm', x, w)
    err = float((got - want).abs().max())
    tol = 1e-5 * k ** 0.5 * float(want.abs().max())
    ms = cuda_ms(lambda: table_gemm(x, w), 20)
    dev_ms = device_ms(lambda: table_gemm(x, w), 20)
    plain_ms = cuda_ms(lambda: torch.einsum('nk,km->nm', x, w), 20)
    library_ms = cuda_ms(lambda: torch.matmul(x, w), 20)
    lib_dev_ms = device_ms(lambda: torch.matmul(x, w), 20)
    bound_ms, bound_by = bound(nbytes(x, w, got), 2.0 * N * k * n)
    tc_ms, tc_by = tc_bound(nbytes(x, w, got), 2.0 * N * k * n)
    print(f'[kernels] table_gemm {label} ({N} x {k}) . ({k} x {n}): max_abs_err '
          f'{err:.3e} (tol {tol:.3e}) kernel {ms:.4f} ms (device {dev_ms:.4f}) '
          f'plain (einsum) {plain_ms:.4f} ms library (torch.matmul) '
          f'{library_ms:.4f} ms (device {lib_dev_ms:.4f}) bound 3xTF32 '
          f'{tc_ms:.4f} ms ({tc_by}; f32 {bound_ms:.4f} ms, {bound_by})')
    if not err <= tol:
        raise AssertionError(f'table_gemm {label}: error {err} > {tol}')
    return {'N': N, 'k': k, 'n': n, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'library_ms': library_ms,
            'bound_ms': tc_ms, 'bound_by': tc_by, 'f32_bound_ms': bound_ms}


def check_table_gemm_bwd(gen, N, k, n, label):
    """The table GEMM's backward (``table_gemm_bwd``: dx = g . w^T and
    dw = x^T . g, once per backward pass of the fused LSTM word steps)
    against torch.einsum on the same inputs: each output's max abs error
    <= 1e-5 * sqrt(terms) * its max|ref| (f32 sums of n, respectively N,
    terms in another order, TF32 off).  Beside it, as a yardstick used
    nowhere in the port, the two torch.matmul calls of the same products
    (no single PyTorch call computes both, so library_ms is null)."""
    import torch
    from dvc_tpu_torch.ops.dsa_tables import table_gemm_bwd
    x = torch.randn((N, k), generator=gen, device='cuda')
    w = torch.randn((k, n), generator=gen, device='cuda') / k ** 0.5
    g = torch.randn((N, n), generator=gen, device='cuda')
    got = table_gemm_bwd(x, w, g)

    def plain():
        return (torch.einsum('nm,km->nk', g, w),
                torch.einsum('nk,nm->km', x, g))

    want = plain()
    errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
    tols = [1e-5 * t ** 0.5 * float(b.abs().max())
            for t, b in zip((n, N), want)]
    ms = cuda_ms(lambda: table_gemm_bwd(x, w, g), 20)
    dev_ms = device_ms(lambda: table_gemm_bwd(x, w, g), 20)
    plain_ms = cuda_ms(plain, 20)

    def matmuls():
        return torch.matmul(g, w.T), torch.matmul(x.T, g)

    matmul_ms, matmul_dev_ms = cuda_ms(matmuls, 20), device_ms(matmuls, 20)
    bound_ms, bound_by = bound(nbytes(x, w, g, *got), 4.0 * N * k * n)
    tc_ms, tc_by = tc_bound(nbytes(x, w, g, *got), 4.0 * N * k * n)
    print(f'[kernels] table_gemm_bwd {label} ({N} x {k}) . ({k} x {n}): '
          f'max_abs_err dx {errs[0]:.3e} (tol {tols[0]:.3e}) dw '
          f'{errs[1]:.3e} (tol {tols[1]:.3e}) kernel {ms:.4f} ms (device '
          f'{dev_ms:.4f}) plain (einsum) {plain_ms:.4f} ms two torch.matmul '
          f'{matmul_ms:.4f} ms (device {matmul_dev_ms:.4f}) bound 3xTF32 '
          f'{tc_ms:.4f} ms ({tc_by}; f32 {bound_ms:.4f} ms, {bound_by})')
    if not all(e <= t for e, t in zip(errs, tols)):
        raise AssertionError(f'table_gemm_bwd {label}: errors {errs} > {tols}')
    return {'N': N, 'k': k, 'n': n, 'max_abs_err': max(errs), 'ms': ms,
            'plain_ms': plain_ms, 'library_ms': None, 'bound_ms': tc_ms,
            'bound_by': tc_by, 'f32_bound_ms': bound_ms}


# dsa::gemm reached directly: the outer sums and G . Wc^T run inside K5
# and K10, which have no entry point of their own for them, so the library
# exports dsa::gemm as dvc_dsa_gemm.  A tree from before that export (the
# parent's, in an A/B) gets a probe of the same signature, built from that
# tree's csrc/ into dvc_tpu_torch/_build/probe/<hash>/.
_PROBE_SRC = r"""
#include "dsa_common.cuh"
extern "C" int dvc_probe_gemm(const float* x, int ldx, int x_by_term, const float* y,
                              int ldy, int y_by_term, int M, int N, int T, int accumulate,
                              float* out, float* work, long long work_floats, int bf16,
                              void* stream) {
  if (bf16) return (int)cudaErrorNotSupported;
  return (int)dsa::gemm(dsa::Operand{x, ldx, x_by_term != 0},
                        dsa::Operand{y, ldy, y_by_term != 0}, M, N, T, accumulate != 0,
                        out, work, (size_t)work_floats, (cudaStream_t)stream);
}
"""
_PROBE = {}


def gemm_probe():
    """dsa::gemm behind ``dvc_probe_gemm`` (the signature of
    ``dvc_dsa_gemm``), built from this checkout's csrc/ at first call."""
    import ctypes
    import hashlib
    from dvc_tpu_torch.ops import _cuda
    if 'fn' not in _PROBE:
        h = hashlib.sha256((_PROBE_SRC + ' '.join(_cuda.NVCC_FLAGS)).encode())
        for f in sorted(os.listdir(_cuda.CSRC)):
            with open(os.path.join(_cuda.CSRC, f), 'rb') as fh:
                h.update(f.encode() + fh.read())
        out = os.path.join(_cuda.BUILD_ROOT, 'probe', h.hexdigest()[:16])
        lib = os.path.join(out, 'libprobe.so')
        if not os.path.exists(lib):
            os.makedirs(out, exist_ok=True)
            src, tmp = os.path.join(out, 'probe.cu'), f'{lib}.{os.getpid()}.tmp'
            with open(src, 'w') as f:
                f.write(_PROBE_SRC)
            proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-shared',
                                   '-I', _cuda.CSRC, '-o', tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f'gemm probe: nvcc failed:\n{proc.stdout}'
                                   f'{proc.stderr}')
            os.replace(tmp, lib)
        fn = ctypes.CDLL(lib).dvc_probe_gemm
        P, I = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [P, I, I, P, I, I, I, I, I, I, P, P, ctypes.c_longlong, I,
                       P]
        fn.restype = I
        _PROBE['fn'] = fn
    return _PROBE['fn']


def gemm_fn():
    """The C function (x, ldx, x_by_term, y, ldy, y_by_term, M, N, T,
    accumulate, out, work, work_floats, bf16, stream) -> CUDA error code
    that runs
    dsa::gemm (csrc/dsa_gemm.cuh): the library's ``dvc_dsa_gemm``, else
    the probe."""
    from dvc_tpu_torch.ops import _cuda
    cdll = _cuda.lib().cdll
    return cdll.dvc_dsa_gemm if hasattr(cdll, 'dvc_dsa_gemm') else gemm_probe()


def outer_sum_work(X, Y):
    """The split-K workspace that the kernels give out (m, n) = X^T Y: the
    GEMM's own rule (an older tree: the 8 partial tiles it allowed)."""
    import torch
    from dvc_tpu_torch.ops import _cuda
    (rows, m), n = X.shape, Y.shape[1]
    if hasattr(_cuda, 'gemm_work'):
        return _cuda.gemm_work(X.device, (m, n, rows))
    return torch.empty(_cuda.WORK_SPLITS * m * n, device=X.device)


def run_outer_sum(X, Y, out, work, bf16=0):
    """out (m, n) = X (rows, m)^T Y (rows, n) by dsa::gemm's outer_sum, as
    K5 and K10 run it (both operands along the terms; ``bf16``: in the
    bf16-operand mode, as K5-bf16 runs it), on the current stream; raises
    on a refused launch."""
    import torch
    from dvc_tpu_torch.ops import _cuda
    (rows, m), n = X.shape, Y.shape[1]
    if bf16 and hasattr(_cuda, 'bf16_flags'):   # X, Y as stored: bf16 or f32
        bf16 = _cuda.bf16_flags(X, Y)
    code = gemm_fn()(X.data_ptr(), X.stride(0), 1, Y.data_ptr(), Y.stride(0), 1,
                     m, n, rows, 0, out.data_ptr(), work.data_ptr(),
                     work.numel(), bf16, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f'dsa::gemm outer sum: CUDA error {code}')
    return out


# the error of an f32 GEMM in units of each output's products: |out - X'Y'|
# (the product in f64) over the root-sum-square of its T products
# X'[i, t] Y'[t, j].  One-pass TF32 rounds each operand to 10 mantissa bits
# (2^-11 of its value), so each product errs by ~4e-4 of itself and the
# largest element's sum by ~1e-3 of this unit at every T; 3xTF32 keeps
# 2^-21 an operand and errs by its f32 accumulation, which grows with the
# length of a split-K chunk (gemm_plan caps it at 2,048 terms).  The limit
# lies between the two (PERF.md, the shared GEMM's findings).
GEMM_PRODUCT_TOL = 2e-4


def product_err(got, xp, yp):
    """Largest error of ``got`` = xp (M, T) @ yp (T, N) in units of its
    products (``GEMM_PRODUCT_TOL``), against the f64 product on the card."""
    x, y = xp.double(), yp.double()
    rss = ((x * x) @ (y * y)).sqrt()
    return float(((got.double() - x @ y).abs() / rss.clamp_min(1e-30)).max())


def tf32_matmul(xp, yp):
    """xp @ yp by torch.matmul with TF32 allowed (one pass): the control
    that the GEMM checks must tell from f32."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(xp, yp)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# the weight gradients' outer sums at the phase-3 shapes: (label, rows, m,
# n, sums of that shape a launch); K5 at B=16, Q=90, K=29 (41,760 rows;
# value^T G over B*S = 6,000, as the table backward's at B=16, H=1), K10
# at B=16, Q=100 (1,600 rows)
OUTER_SUMS = (('K5 hs_prev^T dz, ctx^T dz', 41760, 512, 2048, 2),
              ('K5 hs_prev^T dhvec', 41760, 512, 512, 1),
              ('K5 hs_prev^T doff', 41760, 512, 16, 1),
              ('K5 value^T G, the table backward value^T G', 6000, 512, 512,
               1),
              ('K10 h^T dz, ctx^T dz', 1600, 512, 2048, 2))


def check_outer_sum(gen, rows, m, n, label):
    """One outer sum out (m, n) = X^T Y over ``rows`` rows by dsa::gemm as
    the kernels run it (``run_outer_sum``), against torch.einsum on the
    same inputs: max abs error <= 1e-5 * sqrt(rows) * max|ref| (the
    tolerance of ``check_table_gemm_bwd``), and in units of its products
    (``product_err``) within GEMM_PRODUCT_TOL, which torch.matmul with
    one-pass TF32 on the same operands must exceed; torch.matmul(X.T, Y)
    timed beside it as a yardstick (library_ms, TF32 off), used nowhere in
    the port."""
    import torch
    X = torch.randn((rows, m), generator=gen, device='cuda')
    Y = torch.randn((rows, n), generator=gen, device='cuda')
    out = torch.empty((m, n), device='cuda')
    work = outer_sum_work(X, Y)
    run_outer_sum(X, Y, out, work)
    want = torch.einsum('nk,nm->km', X, Y)
    err = float((out - want).abs().max())
    tol = 1e-5 * rows ** 0.5 * float(want.abs().max())
    unit_err = product_err(out, X.T, Y)
    tf32_err = product_err(tf32_matmul(X.T, Y), X.T, Y)
    ms = cuda_ms(lambda: run_outer_sum(X, Y, out, work), 10)
    plain_ms = cuda_ms(lambda: torch.einsum('nk,nm->km', X, Y), 10)
    library_ms = cuda_ms(lambda: torch.matmul(X.T, Y), 10)
    bound_ms, bound_by = bound(nbytes(X, Y, out), 2.0 * rows * m * n)
    tc_ms, tc_by = tc_bound(nbytes(X, Y, out), 2.0 * rows * m * n)
    print(f'[kernels] outer_sum {label} ({rows} x {m})^T ({rows} x {n}): '
          f'max_abs_err {err:.3e} (tol {tol:.3e}), in product units '
          f'{unit_err:.2e} (tol {GEMM_PRODUCT_TOL:.0e}; one-pass TF32 '
          f'{tf32_err:.2e}) kernel {ms:.4f} ms plain (einsum) {plain_ms:.4f} '
          f'ms library (torch.matmul) {library_ms:.4f} ms bound 3xTF32 '
          f'{tc_ms:.4f} ms ({tc_by}; f32 {bound_ms:.4f} ms, {bound_by})')
    if not err <= tol or not unit_err <= GEMM_PRODUCT_TOL < tf32_err:
        raise AssertionError(f'outer_sum {label}: error {err} > {tol}, or in '
                             f'product units {unit_err} against TF32\'s '
                             f'{tf32_err} (limit {GEMM_PRODUCT_TOL})')
    return {'rows': rows, 'm': m, 'n': n, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'library_ms': library_ms,
            'bound_ms': tc_ms, 'bound_by': tc_by, 'f32_bound_ms': bound_ms}


def check_outer_sums(gen):
    """Every shape of OUTER_SUMS, then K5's five sums at B=16 together;
    raises after the last line if any shape failed its checks."""
    res, failed = [], []
    for label, rows, m, n, _ in OUTER_SUMS:
        try:
            res.append(check_outer_sum(gen, rows, m, n, label))
        except AssertionError as e:
            failed.append(str(e))
    if failed:
        raise AssertionError('; '.join(failed))
    k5 = [(r, c) for r, (label, *_, c) in zip(res, OUTER_SUMS)
          if label.startswith('K5')]
    total = {key: sum(c * r[key] for r, c in k5)
             for key in ('ms', 'library_ms', 'bound_ms', 'f32_bound_ms')}
    print(f'[kernels] outer_sum K5 B=16, its five sums: kernel '
          f'{total["ms"]:.4f} ms library (torch.matmul) '
          f'{total["library_ms"]:.4f} ms bound 3xTF32 {total["bound_ms"]:.4f} '
          f'ms (f32 {total["f32_bound_ms"]:.4f} ms)')
    return res


def step_inputs(gen, B, Q, H, lstm, R=512, A=512, d=512, P=4):
    """Random operands of one word step (K7, or with ``lstm`` K9) at the
    caption head's widths: positions over each level's range and past its
    ends, weights scaled like fan-in-normalised ones."""
    import torch
    dev = 'cuda'
    Dh = d // H
    L, S = len(MSDA_LEVELS), sum(MSDA_LEVELS)
    LP = L * P

    def w(*shape, fan_in):
        return torch.randn(shape, generator=gen, device=dev) / fan_in ** 0.5

    T = torch.tensor(MSDA_LEVELS, dtype=torch.float32, device=dev)
    pos = ((torch.rand((B, H, Q, L, P), generator=gen, device=dev) * 1.2
            - 0.1) * T[:, None] - 0.5).reshape(B, H, Q, LP)
    head = (torch.randn((B, H, S, Dh), generator=gen, device=dev), pos,
            w(B, Q, A, fan_in=4))
    tail = (w(Dh, A, fan_in=Dh), w(A, fan_in=100), w(A, fan_in=A),
            torch.tensor(0.05, device=dev))
    if not lstm:
        return head + tail
    return head + (w(B, Q, 4 * R, fan_in=4), torch.tanh(w(B, Q, R, fan_in=1)),
                   w(B, Q, R, fan_in=1), w(H, Dh, 4 * R, fan_in=d),
                   w(R, 4 * R, fan_in=R)) + tail


def word_step_macs(args, lstm, table_given=False):
    """Least MACs of one word-step kernel over its B*Q queries (``args``:
    ``step_inputs``'s): the scores' taps . Wc (``lerp_rows_macs``; with
    ``table_given``, the kernels alone with VW = value . Wc an operand, a
    lerp of two VW rows, 2A per tap) and . aw, the context (a lerp of two
    value rows and a weighted sum per tap, 3*Dh); with the LSTM cell also
    h . W_hh and ctx . ctx_w3 (4R*(R + H*Dh)).  hvec and the offsets are
    computed outside the kernels; elementwise work is left out."""
    value_t, pos, hvec = args[:3]
    B, H, S, Dh = value_t.shape
    Q, LP = pos.shape[2], pos.shape[3]
    A, n = hvec.shape[-1], B * Q
    macs = ((n * H * LP * 2 * A if table_given
             else lerp_rows_macs(n, B, H, S, LP, Dh, A, True))
            + n * H * LP * (A + 3 * Dh))
    if lstm:
        R = args[4].shape[-1]
        macs += n * 4 * R * (R + H * Dh)
    return macs


def check_step(gen, B, Q, H, lstm):
    """K7 and K8 (or, with ``lstm``, K9 and K10) against the plain word step
    and autograd through it, at the JAX boundary.  The kernels take the
    table VW = value_t . cw (``kernel_args``); K8's 7 (K10's 12) gradients
    at the JAX boundary are composed with the table's backward
    (``dsa_sample_attend_grads``, ``dsa_lstm_step_grads``), and their times
    and bounds are the kernels' alone with VW given (the table's forward and
    backward have their own lines: ``check_table_gemm``,
    ``check_table_gemm_bwd``).  Tolerances: outputs
    max abs error <= 1e-4 * max|ref|; each gradient <= 1e-3 * its max |ref|
    + 1e-5 (f32 sums in another order, atomics in dvalue, G, dWc and the
    bias sums).  d alpha_b is zero in exact arithmetic, so both sides hold
    only the rounding of a sum of N = B*Q*H*LP terms in no fixed order: its
    floor is check_scan's max(5e-5, 2.5e-10 * N), or 64 unit roundoffs
    times sqrt(N) times the terms' mean magnitude where that is larger (a
    unit-scale random cotangent of ctx makes the terms larger than a train
    step's).  Bound: ``word_step_macs`` at the f32 peak, the backward three
    times the forward; bytes at the HBM rate."""
    import torch
    from dvc_tpu_torch.ops import dsa_step as ds
    args = step_inputs(gen, B, Q, H, lstm)
    kargs = kernel_args(args, lstm)
    if lstm:
        names, fwd, bwd = ds.LSTM_NAMES, ds.dsa_lstm_step_fwd, \
            ds.dsa_lstm_step_bwd
        ref, bwd_ref = ds.lstm_step_ref, ds.lstm_step_bwd_ref
        grads_of = ds.dsa_lstm_step_grads
    else:
        names, fwd, bwd = ds.STEP_NAMES, ds.dsa_sample_attend_fwd, \
            ds.dsa_sample_attend_bwd
        ref, bwd_ref = ds.sample_attend_ref, ds.sample_attend_bwd_ref
        grads_of = ds.dsa_sample_attend_grads

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    outs, want = tup(fwd(*kargs, MSDA_LEVELS)), tup(ref(*args, MSDA_LEVELS))
    fwd_err = max(float((a - b).abs().max()) for a, b in zip(outs, want))
    fwd_tol = 1e-4 * max(float(b.abs().max()) for b in want)
    cot = tuple(torch.randn(o.shape, generator=gen, device='cuda')
                for o in outs)
    grads = grads_of(*args, MSDA_LEVELS, *cot)
    wgrads = bwd_ref(*args, MSDA_LEVELS, *cot)
    # d alpha_b's N terms, one per tap row: its gradient with alpha_b
    # broadcast to every row; their sum is zero in exact arithmetic
    rows = args[-1].expand(args[1].shape).clone().requires_grad_()
    with torch.enable_grad():
        terms = torch.autograd.grad(tup(ref(*args[:-1], rows, MSDA_LEVELS)),
                                    rows, cot)[0]
    N = terms.numel()
    atol = {n: 1e-5 for n in names}
    atol['ab'] = max(5e-5, 2.5e-10 * N,
                     2.0 ** -18 * N ** 0.5 * float(terms.abs().mean()))
    rel = {n: float((a - b).abs().max())
           / (float(b.abs().max()) + atol[n] / 1e-3)
           for n, a, b in zip(names, grads, wgrads)}
    bwd_err = max(float((a - b).abs().max()) for a, b in zip(grads, wgrads))
    fwd_ms = cuda_ms(lambda: fwd(*kargs, MSDA_LEVELS), 20)
    fwd_plain = cuda_ms(lambda: ref(*args, MSDA_LEVELS), 5)
    bwd_ms = cuda_ms(lambda: bwd(*kargs, MSDA_LEVELS, *cot), 20)
    bwd_plain = cuda_ms(lambda: bwd_ref(*args, MSDA_LEVELS, *cot), 5)
    macs = word_step_macs(args, lstm, table_given=True)
    inputs = [t for t in kargs if torch.is_tensor(t)]
    fwd_bound = bound(nbytes(*inputs, *outs), 2.0 * macs)
    bwd_bound = bound(nbytes(*inputs, *cot, *grads), 6.0 * macs)
    kind = 'dsa_lstm' if lstm else 'dsa_step'
    shape = (f'B={B} Q={Q} H={H} Dh={512 // H} S=375 LP=16 A=512'
             + (' R=512' if lstm else '') + ', VW given')
    print(f'[kernels] {kind}_fwd {shape}: max_abs_err {fwd_err:.3e} (tol '
          f'{fwd_tol:.3e}) kernel {fwd_ms:.4f} ms plain {fwd_plain:.4f} ms '
          f'bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})')
    print(f'[kernels] {kind}_bwd {shape}: max_abs_err {bwd_err:.3e}, worst '
          f'relative {max(rel, key=rel.get)} {max(rel.values()):.2e} (tol '
          f'1e-3, floor 1e-5, d alpha_b {atol["ab"]:.2e}) kernel '
          f'{bwd_ms:.4f} ms plain {bwd_plain:.4f} ms bound '
          f'{bwd_bound[0]:.4f} ms ({bwd_bound[1]})')
    if not fwd_err <= fwd_tol or not max(rel.values()) <= 1e-3:
        raise AssertionError(f'{kind} B={B} H={H}: forward error {fwd_err}, '
                             f'gradient relative errors {rel}')
    return ({'B': B, 'Q': Q, 'H': H, 'max_abs_err': fwd_err, 'ms': fwd_ms,
             'plain_ms': fwd_plain, 'bound_ms': fwd_bound[0],
             'bound_by': fwd_bound[1]},
            {'B': B, 'Q': Q, 'H': H, 'max_abs_err': bwd_err, 'ms': bwd_ms,
             'plain_ms': bwd_plain, 'bound_ms': bwd_bound[0],
             'bound_by': bwd_bound[1]})


def phase_gemm(gen=None):
    """The GEMM's lines of phase 3 (alone: ``python3 chip_smoke.py --gemm``):
    value . Wc at the word-step shapes (the stepwise path trains at B=1,
    H=1), embed . token_w, the table's backward, and the outer sums."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    if gen is None:
        gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        return {
            'table_gemm': [
                check_table_gemm(gen, 375, 512, 512, 'value . Wc, B=1 H=1'),
                check_table_gemm(gen, 16 * 375, 512, 512, 'value . Wc, B=16 H=1'),
                check_table_gemm(gen, 16 * 8 * 375, 64, 512, 'value . Wc, B=16 H=8'),
                check_table_gemm(gen, 1608, 512, 2048, 'embed . token_w')],
            'table_gemm_bwd': [
                check_table_gemm_bwd(gen, 375, 512, 512, 'value . Wc, B=1 H=1'),
                check_table_gemm_bwd(gen, 16 * 375, 512, 512, 'value . Wc, B=16 H=1'),
                check_table_gemm_bwd(gen, 16 * 8 * 375, 64, 512, 'value . Wc, B=16 H=8')],
            'outer_sum': check_outer_sums(gen)}


def phase_kernels():
    """Every kernel against its plain version at the main paths' shapes:
    serving (MSDA forward and greedy at B=16) and training (MSDA forward and
    backward at B=1, the backward, on its shared dvalue slice, also at B=16
    and on the encoder's locations, scan at B=1 and B=16 with
    Q = 3 layers x 30 gt pairs and K = 29 word steps, and at B=1 with
    cap_nheads 8); the word-step
    kernels at the stepwise path's train shape (B=1, Q=90, H=1) and serve
    shape (B=16, Q=100, H=1 and 8); the tables' GEMM, its backward and the
    weight gradients' outer sums at those paths' shapes.  Returns {kernel:
    [result per shape]}."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        res = {'msda_fwd': [check_msda(gen, 16, 375), check_msda(gen, 16, 100),
                            check_msda(gen, 1, 375)],
               'dsa_greedy': [check_greedy(gen, 16, 100, 1),
                              check_greedy(gen, 16, 100, 8)]}
    res.update(phase_gemm(gen))
    res['msda_bwd'] = [check_msda_bwd(gen, B, Q)
                       for B in (1, 16) for Q in (375, 100)]
    res['msda_bwd'].append(check_msda_bwd(gen, 16, 375, encoder=True))
    scans = [check_scan(gen, 1, 90, 29, 1), check_scan(gen, 16, 90, 29, 1),
             check_scan(gen, 1, 90, 29, 8)]
    res['dsa_scan_fwd'] = [f for f, _ in scans]
    res['dsa_scan_bwd'] = [b for _, b in scans]
    for lstm, kind in ((False, 'dsa_step'), (True, 'dsa_lstm')):
        steps = [check_step(gen, 1, 90, 1, lstm),
                 check_step(gen, 16, 100, 1, lstm),
                 check_step(gen, 16, 100, 8, lstm)]
        res[f'{kind}_fwd'] = [f for f, _ in steps]
        res[f'{kind}_bwd'] = [b for _, b in steps]
    return res


# --------------------------------------------------------------------------
# 3b. the assignment solver
# --------------------------------------------------------------------------

# The matcher's problems, (decoder layers, videos, gt slots G, queries Nq):
# the flagship's three layers with aux loss at B=16, G=30 against Nq=100;
# integer costs (ties everywhere); nan / +-inf entries; and the anet
# recipes' G=30 against Nq=10, where videos of <= 10 and of > 10 events
# take the port's two G > Nq rules.
ASSIGNMENT_CASES = (('flagship', 3, 16, 30, 100, 'normal'),
                    ('ties', 3, 16, 30, 100, 'ties'),
                    ('nonfinite', 3, 16, 30, 100, 'nonfinite'),
                    ('anet', 3, 16, 30, 10, 'normal'))


def assignment_inputs(case, device, seed=0):
    """One case's costs (D, B, G, Nq) f32 and gt mask (B, G), from numpy:
    each video's real count drawn from 0 to G (one video of none, one of
    G), its real slots first as the collation puts them, or (odd videos)
    scattered over the slots."""
    import numpy as np
    import torch
    _, D, B, G, Nq, kind = case
    rng = np.random.default_rng(seed)
    if kind == 'ties':
        cost = rng.integers(0, 4, (D, B, G, Nq)).astype(np.float32)
    else:
        cost = (rng.standard_normal((D, B, G, Nq)) * 3).astype(np.float32)
    if kind == 'nonfinite':
        spots = rng.random(cost.shape)
        cost[spots < 0.01] = np.nan
        cost[(spots >= 0.01) & (spots < 0.02)] = np.inf
        cost[(spots >= 0.02) & (spots < 0.03)] = -np.inf
    counts = rng.integers(0, G + 1, B)
    counts[:2] = 0, G
    mask = np.zeros((B, G), bool)
    for b, n in enumerate(counts):
        mask[b, rng.permutation(G)[:n] if b % 2 else np.arange(n)] = True
    return (torch.from_numpy(cost).to(device),
            torch.from_numpy(mask).to(device))


def scipy_round_trip(cost, mask):
    """What the matcher did before the solver came to the card: the costs
    and the mask to the host in one copy, scipy on each (layer, video)'s
    real rows (padded rows given the free columns in order), the indices
    uploaded.  Returns col4row (D, B, G) int64 on the costs' device."""
    import numpy as np
    import torch
    from scipy.optimize import linear_sum_assignment
    D, B, G, Nq = cost.shape
    packed = torch.cat([cost.reshape(-1),
                        mask.float().reshape(-1)]).cpu().numpy()
    C = np.nan_to_num(packed[:D * B * G * Nq].reshape(D, B, G, Nq),
                      nan=1e9, posinf=1e9, neginf=-1e9)
    real = packed[D * B * G * Nq:].reshape(B, G) > 0
    idx = np.full((D, B, G), -1, np.int64)
    for layer in range(D):
        for b in range(B):
            rows = np.flatnonzero(real[b])
            r, c = linear_sum_assignment(C[layer, b][rows])
            idx[layer, b, rows[r]] = c
            free = np.setdiff1d(np.arange(Nq), c)
            pad = np.flatnonzero(~real[b])[:len(free)]
            idx[layer, b, pad] = free[:len(pad)]
    return torch.from_numpy(idx).to(cost.device)


def optimal_totals(cost, mask, col4row):
    """Per (layer, video): the total cost of the real slots' matched
    columns (float64) and scipy's optimum on the real rows; the columns
    must be distinct and as many as min(real slots, Nq)."""
    import numpy as np
    from scipy.optimize import linear_sum_assignment
    C = np.nan_to_num(cost.cpu().numpy().astype(np.float64), nan=1e9,
                      posinf=1e9, neginf=-1e9)
    real, idx = mask.cpu().numpy(), col4row.cpu().numpy()
    worst = 0.0
    for layer, b in np.ndindex(*idx.shape[:2]):
        rows = np.flatnonzero(real[b])
        got = idx[layer, b, rows]
        kept = got >= 0
        used = idx[layer, b][idx[layer, b] >= 0]
        if (kept.sum() != min(len(rows), C.shape[-1])
                or len(set(used.tolist())) != len(used)):
            raise AssertionError(f'assignment of ({layer}, {b}): {idx[layer, b]}')
        r, c = linear_sum_assignment(C[layer, b][rows])
        want = C[layer, b][rows][r, c].sum()
        total = C[layer, b][rows[kept], got[kept]].sum()
        worst = max(worst, abs(total - want) / max(abs(want), 1.0))
    return worst


ASSIGNMENT_TOTAL_TOL = 1e-6      # relative, float64 sums, against scipy


def check_assignment(case):
    """The kernel against its plain version on the card, exactly equal
    col4row and Dijkstra steps; its CUDA-event ms, the plain version's and
    the host-clock ms of the scipy round trip it replaces; the bound (the
    costs and mask read once, col4row written once, over the HBM rate, or
    4 operations a relaxation of the steps this run's data needs); the
    totals against scipy's optimum."""
    import numpy as np
    import torch
    from dvc_tpu_torch.ops.assignment import assignment, assignment_ref
    label, D, B, G, Nq, _ = case
    cost, mask = assignment_inputs(case, 'cuda')
    got, steps = assignment(cost, mask, with_steps=True)
    want, want_steps = assignment_ref(cost, mask, with_steps=True)
    torch.cuda.synchronize()
    diff = int((got != want).sum()) + int((steps != want_steps).sum())
    ms = cuda_ms(lambda: assignment(cost, mask), 20)
    plain_ms = cuda_ms(lambda: assignment_ref(cost, mask), 1)
    scipy_round_trip(cost, mask)                       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        scipy_round_trip(cost, mask)
    torch.cuda.synchronize()
    scipy_ms = (time.perf_counter() - t0) / 5 * 1e3
    n = mask.sum(1).cpu().numpy()
    cols = np.where((G > Nq) & (n > Nq), n, Nq)        # each problem's columns
    steps_np = steps.cpu().numpy()
    relax = float((steps_np * cols[None, :]).sum())
    bound_ms, by = bound(nbytes(cost, mask, got),
                         4.0 * relax)
    worst = optimal_totals(cost, mask, got)
    sub = (f'; videos of <= {Nq} events {int((n <= Nq).sum())}, of more '
           f'{int((n > Nq).sum())}' if G > Nq else '')
    print(f'[assignment] {label} (D, B, G, Nq) = ({D}, {B}, {G}, {Nq}): '
          f'kernel vs plain col4row and steps differing in {diff} entries; '
          f'{D * B} problems, Dijkstra steps {int(steps_np.sum())} in all, '
          f'{int(steps_np.max())} the longest chain; kernel {ms:.4f} ms, '
          f'plain {plain_ms:.3f} ms, scipy round trip (copy, {D * B} '
          f'solves, upload; host clock) {scipy_ms:.3f} ms; bound '
          f'{bound_ms:.5f} ms ({by}); total cost against scipy\'s optimum '
          f'{worst:.2e} relative{sub}')
    if diff or worst > ASSIGNMENT_TOTAL_TOL:
        raise AssertionError(f'assignment {label}: {diff} entries differ '
                             f'from the plain version, totals off by {worst}')
    return {'max_abs_err': float((got - want).abs().max()), 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': by,
            'library_ms': scipy_ms, 'steps': int(steps_np.sum()),
            'chain': int(steps_np.max())}


def phase_assignment():
    """Phase 3b: the assignment kernel at every case of
    ASSIGNMENT_CASES.  Returns {'assignment': [result per case]}."""
    return {'assignment': [check_assignment(c) for c in ASSIGNMENT_CASES]}


AB_MATCHER_REPS = 10          # timed B=16 steps a run, after a warm-up


def matcher_ab_run():
    """The B=16 train step of the flagship at full width in this file's
    tree (copied into another tree, that tree's): host-clock ms a step
    (mean of AB_MATCHER_REPS after a warm-up, synchronized at the end) and
    one traced step's window, device busy ms and idle share (synchronized
    inside the window), TF32 off as in the full run; one JSON line."""
    import torch
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        recipe = write_synthetic_run(tmp, load_config(CFG, root=ROOT))
        opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE],
                         root=ROOT)
        trainer = Trainer(opt, device=DEVICE)
        batch = train_batch(opt, 16)
        ms, _ = time_steps(trainer, batch, opt.lr, AB_MATCHER_REPS)
        res = trace('B=16 train_step', lambda: (
            trainer.train_step(batch, opt.lr), torch.cuda.synchronize()))
    print(json.dumps({'ab_matcher': {'root': ROOT, 'ms': ms, **res}}))


def ab_matcher(parent):
    """This tree's B=16 train step against the tree at ``parent`` (an
    unpacked checkout of the parent commit, in a directory that .gitignore
    lists, e.g. _checkout/parent): this file is copied into it, and
    ``--ab-matcher-run`` runs in each tree in turns, parent, this, this,
    parent, twice (four runs a side, a process each).  Prints each run and
    a summary JSON line; claims nothing."""
    import shutil
    shutil.copy(os.path.abspath(__file__), os.path.join(parent,
                                                         'chip_smoke.py'))
    runs = {'parent': [], 'this': []}
    for side in ('parent', 'this', 'this', 'parent') * 2:
        root = os.path.abspath(parent) if side == 'parent' else ROOT
        out = subprocess.run(
            [sys.executable, os.path.join(root, 'chip_smoke.py'),
             '--ab-matcher-run'], cwd=root, capture_output=True, text=True,
            timeout=600)
        if out.returncode:
            print(out.stdout[-4000:], out.stderr[-4000:])
            raise RuntimeError(f'--ab-matcher-run in {root} failed')
        for line in out.stdout.splitlines():
            if line.startswith('[trace]'):
                print(f'[ab-matcher] {side}: {line}')
        r = json.loads([line for line in out.stdout.splitlines()
                        if line.startswith('{"ab_matcher"')][-1])['ab_matcher']
        runs[side].append(r)
        print(f'[ab-matcher] {side}: B=16 train step {r["ms"]:.2f} ms (host '
              f'clock); traced step window {r.get("window_ms", 0):.2f} ms, '
              f'device busy {r.get("busy_ms", 0):.2f} ms, idle share '
              f'{r.get("idle", float("nan")):.4f}')
    print(json.dumps({'ab_matcher': {
        side: {k: [r.get(k) for r in rs]
               for k in ('ms', 'window_ms', 'busy_ms', 'idle', 'activities')}
        for side, rs in runs.items()}}))


# The phase split of the redesigned kernels: each kernel timed as built from
# the sources, then as built with one phase's code taken out (a textual edit
# of a copy of csrc/ in dvc_tpu_torch/_build/phases/, never of the
# sources, built with the GEMM's plan, csrc/dsa_gemm_plan.cc, where the tree
# has one); full minus the variant is that phase's share.  A variant
# computes on stale operands, so only its time means anything.
# SPLITS[spec][kernel] = (source, [(phase, [(file, old text, new text)])]);
# 'pr5' splits K9 and K10 as they were before their table (run it from a
# checkout of that tree: python3 chip_smoke.py --split pr5).
_CELL = ('        const float c = sigmoidf_(z[1][q]) * c_s[q * ldR + r]\n'
         '                        + sigmoidf_(z[0][q]) * tanhf(z[2][q]);\n'
         '        const float h = sigmoidf_(z[3][q]) * tanhf(c);')
_NO_CELL = ('        const float c = z[1][q] + z[0][q] + z[2][q];\n'
            '        const float h = z[3][q] + c;')
_GATES_H = ('add_gates(sm.h, ldR, R, a.w_hh, r, R, z);\n      add_gates(sm.ctx,',
            'add_gates(sm.ctx,')
_GATES_CTX = ('add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);', '')
# the table form's attention backward (dsa_common.cuh), shared by K5, K8
# and K10
_TABLE_BWD = [
    ('context term', [('dsa_common.cuh', 'for (int c = lane * 4; c < Dh; c += 128) {',
                       'for (int c = Dh; c < Dh; c += 128) {')]),
    ('dvalue atomics', [('dsa_common.cuh',
                         '      atomic_add4(dv + il + c, mul4(wl, t));\n'
                         '      atomic_add4(dv + ih + c, mul4(wh, t));\n', '')]),
    ('scores term', [('dsa_common.cuh',
                      'for (int row = q * HLP; row < (q + 1) * HLP; ++row) {',
                      'for (int row = (q + 1) * HLP; row < (q + 1) * HLP; ++row) {')]),
    ('G atomics', [('dsa_common.cuh',
                    '      atomic_add4(G_b + ol + c, mul4(wl, ub));\n'
                    '      atomic_add4(G_b + oh + c, mul4(wh, ub));\n', '')]),
]
# the product-form word step that the 'pr5' spec splits: its gate products
# (shared by K9 and K10's recompute) and the K10 recompute's attention
_PR5_GATES_H = ('  add_gates(sm.h, pad4(R), R, a.w_hh, r, R, z);\n', '')
_PR5_GATES_CTX = ('  add_gates(sm.ctx, pad4(HD), HD, a.ctx_w3, r, R, z);\n', '')
_PR5_BWD_CTX = ('  for (int i = tid; i < kQT * HD; i += kThreads) {\n'
                '    const int q = i / HD, hd = i % HD;\n')
# the cell backward of K10 (both trees) and the cell of K9
_CELL_BWD = ('      const float dc_prev = cell_bwd(z[0][q], z[1][q], z[2][q], z[3][q],\n'
             '                                     a.c[row * R + r],\n'
             '                                     valid ? o.gh[row * R + r] : 0.f,\n'
             '                                     valid ? o.gc[row * R + r] : 0.f, dzg);',
             '      const float dc_prev = a.c[row * R + r]\n'
             '          + (valid ? o.gh[row * R + r] + o.gc[row * R + r] : 0.f);\n'
             '      for (int g = 0; g < 4; ++g) dzg[g] = z[g][q];')
_STEP_CELL = ('      const float c = sigmoidf_(z[1][q]) * a.c[o] + '
              'sigmoidf_(z[0][q]) * tanhf(z[2][q]);\n'
              '      h_out[o] = sigmoidf_(z[3][q]) * tanhf(c);',
              '      const float c = z[1][q] + z[0][q] + z[2][q];\n'
              '      h_out[o] = z[3][q] + c;')
# the gate products of K9 and of K10's recompute (gate_preact)
_STEP_GATES_H = ('  add_gates<QT>(h, pad4(R), R, a.w_hh, r, R, z);\n', '')
_STEP_GATES_CTX = ('  add_gates<QT>(ctx, pad4(HD), HD, a.ctx_w3, r, R, z);\n', '')
# the attention of K9 and K10 (either mode): the scores from VW, ctx (the
# softmax kept); K10's outer sums h^T dz and ctx^T dz
_STEP_FWD_SCORES = ('scores from VW', [
    ('dsa_step.cu', '  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));\n'
                    '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
     '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n')])
_STEP_FWD_CTX = ('ctx', [('dsa_step.cu', '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
                          '  attend_softmax<QT>(at, sm);\n\n')])
_STEP_BWD_SCORES = ('scores from VW', [
    ('dsa_step.cu', '  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));\n'
                    '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for',
     '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for')])
_STEP_BWD_CTX = ('ctx', [('dsa_step.cu', '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for',
                          '  attend_softmax<QT>(at, sm);\n  for')])
_STEP_OUTER_SUMS = ('dsa_step.cu', 'const int N = B * Q, HD = H * Dh;',
                    'const int N = 0, HD = H * Dh;')
# the gate backward of K5-bf16 and K10-bf16 on the tensor cores
# (dsa_common.cuh, gates_bwd_bf16): the staging of x, the backprop's
# product dz . P, and the cell backward replaced by a pass-through of the
# preactivations (the recompute's product is gate_sums', _FWD_GATES)
_BWD_STAGE = ('dsa_common.cuh',
              '  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;\n'
              '  stage_gate_inputs<QT>(h, ldR, ctx, ldHD, gg, xb);\n',
              '  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;\n')
_BF16_BACKPROP = ('dsa_common.cuh',
                  '    gate_mma<QT, 1, 8>(wb, gg.Rp / 4, mt, dzb, gg.lddz, acc);\n', '')
_CELL_PASS = [('dsa_common.cuh', 'put(qi, u, cell_bwd(', 'put(qi, u, cell_pass('),
              ('dsa_common.cuh',
               'template <int QT, typename Z0, typename Cot, typename Put, typename Back>\n',
               '__device__ __forceinline__ float cell_pass(float zi, float zf, float zg, '
               'float zo, float c_prev, float gh, float gc, float (&dz)[4]) {\n'
               '  dz[0] = zi; dz[1] = zf; dz[2] = zg; dz[3] = zo;\n'
               '  return c_prev + gh + gc;\n}\n\n'
               'template <int QT, typename Z0, typename Cot, typename Put, typename Back>\n')]
# the forward gates of K4-bf16, K6-bf16 and K9-bf16 on the tensor cores
# (dsa_common.cuh, gates_fwd_bf16): the staging of x, the product (gate_sums,
# also the recompute of K5-bf16 and K10-bf16), and the cell replaced by a
# pass-through of the preactivations; K6-bf16's logits (dsa_greedy.cu,
# logits_bf16): the product and its online merge replaced by token 0, and
# the merge alone replaced by keeping the last logit (its index stays a
# valid token); hvec = h . W_h2att on the
# tensor cores (attend_hvec_mma, its staging included: the scores then
# read stale hvec), and before it on the CUDA cores (attend_hvec_taps, the
# 'cuda_core_bf16' spec)
_FWD_STAGE = ('dsa_common.cuh',
              '__nv_bfloat16* xb, Z0 z0, C c_prev, Out out) {\n'
              '  stage_gate_inputs<QT>(h, ldR, ctx, ldHD, gg, xb);\n',
              '__nv_bfloat16* xb, Z0 z0, C c_prev, Out out) {\n')
_FWD_GATES = ('dsa_common.cuh',
              '    gate_mma<QT, 2, 4>(wr, gg.KKp / 16, 2 * ub, xb, gg.ldx, acc);\n', '')
_FWD_CELL = ('dsa_common.cuh',
             '    const float c = sigmoidf_(zf) * c_prev(qi, u) + sigmoidf_(zi) * tanhf(zg);\n'
             '    const float hv = sigmoidf_(zo) * tanhf(c);\n',
             '    const float c = zf + zi + zg;\n'
             '    const float hv = zo + c;\n')
_LOGITS = ('dsa_greedy.cu',
           '  hidden_mma<QT>(a.lpack, hg, xb, gg.ldx, [&](int n, int nt, int j, float v) {\n'
           '    lse_merge(mm[nt][j], ss[nt][j], ii[nt][j], v + __ldg(a.logit_b + n), 1.f, n);\n'
           '  });\n',
           '  for (int t = 0; t < NT * 2; ++t) {\n'
           '    mm[t / 2][t % 2] = 0.f; ss[t / 2][t % 2] = 1.f; ii[t / 2][t % 2] = 0;\n'
           '  }\n')
_LOGITS_MERGE = ('dsa_greedy.cu',
                 '    lse_merge(mm[nt][j], ss[nt][j], ii[nt][j], v + __ldg(a.logit_b + n), 1.f, n);\n',
                 '    { mm[nt][j] = v; ss[nt][j] = 1.f; ii[nt][j] = n; }\n')
_HVEC_SCAN = ('dsa_scan.cu', '    //      and ctx\n    if (B16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);\n',
              '    //      and ctx\n')
_HVEC_SCAN_BWD = ('dsa_scan.cu',
                  '    //      weights, ctx\n    if (at.bf16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);\n',
                  '    //      weights, ctx\n')
_HVEC_GREEDY = ('dsa_greedy.cu', '    if (B16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);\n', '')
_HVEC_CUDA_CORE = ('dsa_common.cuh',
         '  for (int col = tid; col < A; col += kThreads) {\n    float acc[QT] = {};\n'
         '    rows_dot_col<QT>(s.h, ldR, R, a.h2att_w, A, col, acc);',
         '  for (int col = tid; col < 0; col += kThreads) {\n    float acc[QT] = {};\n'
         '    rows_dot_col<QT>(s.h, ldR, R, a.h2att_w, A, col, acc);')
_MSDA_GATHERS = ('        for (; j + 4 <= n; j += 4)\n'
                 '          gather_points<V, 4>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);\n'
                 '        for (; j < n; ++j)\n'
                 '          gather_points<V, 1>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);\n')
_MSDA_BWD_POINTS = ('          if (j / G < n)   // the group\'s first point\n'
                    '            scatter_points<V, G, STAGED>(vrows, ld, sdv, D, c, in, gv, tap, aw, j, lane, x);\n')
_MSDA_BWD_ATOMICS = '  add_shared<V, G>(p, add, on);\n'
# the half-warps' reduce-scatter of the 16 sums replaced by a lane's own sum
_MSDA_BWD_REDUCE = ('const float lo = reduce_halves(x, lane);',
                    'float lo = 0.f;\n      for (int i = 0; i < kChunk; ++i) lo += x[i];')
_MSDA_BWD_FLUSH = ('  if (a.flush == 16) flush_rows<16>(dst, sdv, S, D, HD, a.add);\n'
                   '  else if (a.flush == 8) flush_rows<8>(dst, sdv, S, D, HD, a.add);\n'
                   '  else flush_rows<4>(dst, sdv, S, D, HD, a.add);\n')
_MSDA_BWD_L2 = ('ms_deform_attn.cu', 'const bool stage = 2 * slice <= (size_t)optin;',
                'const bool stage = false;')
# the attention phases of the forward kernels K4 and K6, either mode: the
# per-launch tables, the scores from VW, ctx (the softmax kept)
_SCAN_FWD_ATTENTION = [
    ('table VW', [('dsa_scan.cu', '  if (a.at.bf16)\n    e = row_table16(',
                   '  if (false)\n    e = row_table16('),
                  ('dsa_scan.cu', '  else\n    e = row_table(value_t, static_cast',
                   '  else if (false)\n    e = row_table(value_t, static_cast')]),
    ('scores from VW', [('dsa_scan.cu',
                         '    attend_scores_table<QT>(at, sm, vw_b, ab);\n'
                         '    attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
                         '    attend_softmax_ctx<QT>(at, sm, value_b);\n\n')]),
    ('ctx', [('dsa_scan.cu', 'attend_softmax_ctx<QT>(at, sm, value_b);\n\n    // ---- z',
              'attend_softmax<QT>(at, sm);\n\n    // ---- z')]),
]
_GREEDY_ATTENTION = [
    ('tables VW, TW', [('dsa_greedy.cu', '  if (at.bf16) {\n    // value and cw in bf16',
                        '  if (false) {\n    // value and cw in bf16'),
                       ('dsa_greedy.cu', '} else if ((e = row_table(value_t,',
                        '} else if (false && (e = row_table(value_t,')]),
    ('scores from VW', [('dsa_greedy.cu', '    attend_scores_table<QT>(at, sm, vw_b, ab);\n', '')]),
    ('ctx', [('dsa_greedy.cu', 'attend_softmax_ctx<QT>(at, sm, value_b);',
              'attend_softmax<QT>(at, sm);')]),
]
SPLITS = {
    'pr5': {
        'dsa_lstm_fwd': ('dsa_step.cu', [
            ('scores taps.Wc', [('dsa_step.cu',
                                 '  attend_scores(at, sm, value_b, __ldg(a.ab));\n'
                                 '  attend_softmax_ctx(at, sm, value_b);\n\n  // a thread',
                                 '  attend_softmax_ctx(at, sm, value_b);\n\n  // a thread')]),
            ('softmax + ctx', [('dsa_step.cu',
                                '  attend_softmax_ctx(at, sm, value_b);\n\n  // a thread',
                                '\n  // a thread')]),
            ('h.W_hh', [('dsa_step.cu', *_PR5_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_PR5_GATES_CTX)]),
            ('cell', [('dsa_step.cu', *_STEP_CELL)]),
        ]),
        'dsa_lstm_bwd': ('dsa_step.cu', [
            ('scores taps.Wc', [('dsa_step.cu',
                                 '  attend_scores(at, sm, value_b, __ldg(a.ab));\n'
                                 '  attend_softmax_ctx(at, sm, value_b);\n' + _PR5_BWD_CTX,
                                 '  attend_softmax_ctx(at, sm, value_b);\n' + _PR5_BWD_CTX)]),
            ('softmax + ctx', [('dsa_step.cu',
                                '  attend_softmax_ctx(at, sm, value_b);\n' + _PR5_BWD_CTX,
                                _PR5_BWD_CTX)]),
            ('h.W_hh', [('dsa_step.cu', *_PR5_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_PR5_GATES_CTX)]),
            ('cell_bwd', [('dsa_step.cu', *_CELL_BWD)]),
            ('dz.W^T', [('dsa_step.cu', 'gates_backprop(dz_s, R, HD,',
                         'gates_backprop(dz_s, R, -R,')]),
            ('du recompute', [('dsa_common.cuh',
                               'score_tile(a, s, value_b, r0, 0, acc);',
                               'for (int i = 0; i < 4; ++i) for (int j = 0; j < 8; ++j)'
                               ' acc[i][j] = 0.f;')]),
            ('du.Wc^T', [('dsa_common.cuh', 'for (int a0 = 0; a0 < A; a0 += kBK) {',
                          'for (int a0 = A; a0 < A; a0 += kBK) {')]),
            ('G atomics', [('dsa_common.cuh',
                            '          atomicAdd(Gh + (size_t)s.lo[row] * A, s.wlo[row] * du);\n'
                            '          atomicAdd(Gh + (size_t)s.hi[row] * A, s.whi[row] * du);\n',
                            '')]),
            ('dvalue atomics', [('dsa_common.cuh',
                                 '          atomicAdd(dv + il + dh, wl * t);\n'
                                 '          atomicAdd(dv + ih + dh, wh * t);\n', '')]),
            ('outer sums h^T dz, ctx^T dz', [('dsa_step.cu', 'const int N = B * Q, HD = H * Dh;',
                                              'const int N = 0, HD = H * Dh;')]),
            ('outer sum value^T G', [('dsa_step.cu', 'G, A, B * H * S, Dh, A, dcw, st, work, wf)',
                                      'G, A, 0, Dh, A, dcw, st, work, wf)')]),
        ]),
    },
    'current': {
        'msda_bwd': ('ms_deform_attn.cu', [
            ('staging', [('ms_deform_attn.cu',
                          '    if (a.copy == 16) stage_rows<16>(sv, vrows, S, D, HD);\n'
                          '    else if (a.copy == 8) stage_rows<8>(sv, vrows, S, D, HD);\n'
                          '    else stage_rows<4>(sv, vrows, S, D, HD);\n', '')]),
            ('zeroing', [('ms_deform_attn.cu', '  zero_floats(sdv, S * D);\n', '')]),
            ('point loop', [('ms_deform_attn.cu', _MSDA_BWD_POINTS, '          ;\n')]),
            ('shared adds', [('ms_deform_attn.cu', _MSDA_BWD_ATOMICS, '')]),
            ('reduce-scatter', [('ms_deform_attn.cu', *_MSDA_BWD_REDUCE)]),
            ('flush', [('ms_deform_attn.cu', _MSDA_BWD_FLUSH, '')]),
            # not phases: the shared adds as float atomicAdds (each a
            # compare-and-swap loop of one float, waiting for the last), in
            # place of the batched vector compare-and-swaps; the value rows read
            # through L2 in place of the staged slice, at every shape, and
            # so with two blocks an SM
            ('float atomicAdd', [('ms_deform_attn.cu', _MSDA_BWD_ATOMICS,
                                  '  for (int t = 0; t < G; ++t)\n'
                                  '    for (int k = 0; k < V; ++k)\n'
                                  '      if (on[t]) atomicAdd(p[t] + k, add[t][k]);\n')]),
            ('value through L2', [_MSDA_BWD_L2]),
            ('value through L2, two blocks an SM', [
                _MSDA_BWD_L2, ('ms_deform_attn.cu',
                               '__launch_bounds__(kThreads, 1)\nmsda_bwd_kernel',
                               '__launch_bounds__(kThreads, 2)\nmsda_bwd_kernel')]),
        ]),
        'msda_fwd': ('ms_deform_attn.cu', [
            ('staging', [('ms_deform_attn.cu',
                          '  if (copy == 16) stage_rows<16>(sv, src, S, D, HD);\n'
                          '  else if (copy == 8) stage_rows<8>(sv, src, S, D, HD);\n'
                          '  else stage_rows<4>(sv, src, S, D, HD);\n', '')]),
            ('gathers', [('ms_deform_attn.cu', _MSDA_GATHERS, '')]),
        ]),
        'dsa_greedy': ('dsa_greedy.cu', [
            *_GREEDY_ATTENTION,
            ('h.W_hh + ctx.ctx_w3', [('dsa_greedy.cu',
                                      'add_gates(sm.h, ldR, R, a.w_hh, r, R, z);\n'
                                      '      add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);', '')]),
            ('logits', [('dsa_greedy.cu',
                         'cols_dot_rows<QT, LC>(sm.h, ldR, R, a.logit_w, a.V1, n0, acc);', '')]),
        ]),
        'dsa_scan_bwd': ('dsa_scan.cu', [
            ('table VW', [('dsa_scan.cu', '  e = rb ? row_table16(op16(value16, Dh), op16(cw, A), BHS, Dh, A, vw, st, work, wf)\n'
                           '         : row_table(value_t, cwf, BHS, Dh, A, vw, st, work, wf);\n',
                           '  e = cudaSuccess;\n')]),
            ('scores from VW', [('dsa_scan.cu',
                                 '    attend_scores_table<QT>(at, sm, vw_b, ab);\n'
                                 '    attend_softmax_ctx<QT>(at, sm, value_b);\n    for (int i',
                                 '    attend_softmax_ctx<QT>(at, sm, value_b);\n    for (int i')]),
            ('gates + cell bwd', [('dsa_scan.cu',
                                   'add_gates(sm.h, ldR, R, a.w_hh, r, R, z);\n'
                                   '      add_gates(cx_s, ldHD, HD, a.ctx_w3, r, R, z);', '')]),
            ('dz.W^T', [('dsa_scan.cu', 'gates_backprop_rows<QT>(dz_s, R, HD,',
                         'gates_backprop_rows<QT>(dz_s, R, -R,')]),
            *_TABLE_BWD,
            ('dh += dhvec.W_h2att^T + doff.off_w^T', [
                ('dsa_scan.cu', 'for (int r0 = tid * 2; r0 < R;', 'for (int r0 = R; r0 < R;')]),
            ('dvalue += G.Wc^T', [('dsa_scan.cu', 'BHS, Dh, A, true,', '0, Dh, A, true,')]),
            ('outer sums', [('dsa_scan.cu', 'const int N = B * K * Q, HD',
                             'const int N = 0, HD'),
                            ('dsa_scan.cu', 'G, A, BHS, Dh, A, dcw', 'G, A, 0, Dh, A, dcw')]),
        ]),
        'dsa_scan_bwd_bf16': ('dsa_scan.cu', [
            ('table VW', [('dsa_scan.cu', '  e = rb ? row_table16(op16(value16, Dh), op16(cw, A), BHS, Dh, A, vw, st, work, wf)\n'
                           '         : row_table(value_t, cwf, BHS, Dh, A, vw, st, work, wf);\n',
                           '  e = cudaSuccess;\n')]),
            ('hvec (mma)', [_HVEC_SCAN_BWD]),
            ('gate recompute', [_FWD_GATES]),
            ('cell backward', _CELL_PASS),
            ('dz.W^T', [_BF16_BACKPROP]),
            ('attention', [('dsa_scan.cu',
                            '    attend_scores_table<QT>(at, sm, vw_b, ab);\n'
                            '    attend_softmax_ctx<QT>(at, sm, value_b);\n    for (int i',
                            '    attend_softmax_ctx<QT>(at, sm, value_b);\n    for (int i')]
             + [edit for _, edits in _TABLE_BWD for edit in edits]),
            ('dvalue += G.Wc^T', [('dsa_scan.cu', 'B * H * S, Dh, A, true, dvalue',
                                   '0, Dh, A, true, dvalue')]),
            ('outer sums', [('dsa_scan.cu', 'const int N = B * K * Q, HD',
                             'const int N = 0, HD'),
                            ('dsa_scan.cu', 'G16, BHS, Dh, A, dcw', 'G16, 0, Dh, A, dcw')]),
        ]),
        'dsa_scan_fwd_bf16': ('dsa_scan.cu', [
            *_SCAN_FWD_ATTENTION,
            ('hvec (mma)', [_HVEC_SCAN]),
            ('staging x', [_FWD_STAGE]),
            ('gates (mma)', [_FWD_GATES]),
            ('cell', [_FWD_CELL]),
        ]),
        'dsa_greedy_bf16': ('dsa_greedy.cu', [
            *_GREEDY_ATTENTION,
            ('hvec (mma)', [_HVEC_GREEDY]),
            ('staging x', [_FWD_STAGE]),
            ('gates (mma)', [_FWD_GATES]),
            ('cell', [_FWD_CELL]),
            ('logits (mma and merge)', [_LOGITS]),
            ('logits merge', [_LOGITS_MERGE]),
        ]),
        'dsa_scan_fwd': ('dsa_scan.cu', [
            *_SCAN_FWD_ATTENTION,
            ('h.W_hh', [('dsa_scan.cu', *_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_scan.cu', *_GATES_CTX)]),
            ('cell', [('dsa_scan.cu', _CELL, _NO_CELL)]),
        ]),
        'dsa_step_fwd': ('dsa_step.cu', [
            ('scores from VW', [('dsa_step.cu',
                                 '  attend_scores_table4<QT>(at, sm, vw_b, __ldg(a.ab));\n', '')]),
            ('ctx', [('dsa_step.cu', '  attend_softmax_ctx<QT>(at, sm, value_b);\n  // the tile',
                      '  attend_softmax<QT>(at, sm);\n  // the tile')]),
        ]),
        'dsa_step_bwd': ('dsa_step.cu', [
            ('scores from VW', [('dsa_step.cu',
                                 '  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));\n'
                                 '  attend_softmax<QT>(at, sm);\n',
                                 '  attend_softmax<QT>(at, sm);\n')]),
            *_TABLE_BWD,
        ]),
        'dsa_lstm_fwd': ('dsa_step.cu', [
            _STEP_FWD_SCORES, _STEP_FWD_CTX,
            ('h.W_hh', [('dsa_step.cu', *_STEP_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_STEP_GATES_CTX)]),
            ('cell', [('dsa_step.cu', *_STEP_CELL)]),
        ]),
        'dsa_lstm_bwd': ('dsa_step.cu', [
            _STEP_BWD_SCORES, _STEP_BWD_CTX,
            ('h.W_hh', [('dsa_step.cu', *_STEP_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_STEP_GATES_CTX)]),
            ('cell_bwd', [('dsa_step.cu', *_CELL_BWD)]),
            ('dz.W^T', [('dsa_step.cu', 'gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh,',
                         'gates_backprop_rows<QT>(dz_s, R, -R, a.w_hh,')]),
            *_TABLE_BWD,
            ('outer sums', [_STEP_OUTER_SUMS]),
        ]),
        'dsa_lstm_fwd_bf16': ('dsa_step.cu', [
            _STEP_FWD_SCORES, _STEP_FWD_CTX,
            ('staging x', [_FWD_STAGE]),
            ('gates (mma)', [_FWD_GATES]),
            ('cell', [_FWD_CELL]),
        ]),
        'dsa_lstm_bwd_bf16': ('dsa_step.cu', [
            _STEP_BWD_SCORES, _STEP_BWD_CTX,
            ('staging x', [_BWD_STAGE]),
            ('gates (mma)', [_FWD_GATES]),
            ('cell_bwd', _CELL_PASS),
            ('dz.P (mma)', [_BF16_BACKPROP]),
            *_TABLE_BWD,
            ('outer sums', [_STEP_OUTER_SUMS]),
        ]),
    },
}

# K7-bf16's and K8-bf16's phases (the product form, dsa_step.cu): the taps'
# staging, the scores (pre = taps . Wc on mma and the tanh on the
# accumulators), ctx; K8-bf16's d wts, du (pre again, the tanh, du and its
# sums), dtaps (du . Wc^T on mma, dpos, the dvalue scatter), dcw (mma in
# the block) and, where the GEMM sums dcw, its outer sum
_ATTEND16_STAGE = ('dsa_step.cu',
                   '      *reinterpret_cast<uint4*>(t.taps + (size_t)row * t.g.ldt + (i % c8) * 8) =\n'
                   '          make_uint4(o[0], o[1], o[2], o[3]);\n', '')
_ATTEND16_SCORES = ('dsa_step.cu', '  attend16_scores<MT, kRes>(at, t, t.part);\n', '')
# within the scores and the du phase: the products alone (the accumulators
# zeroed instead) and the tanh alone (the preactivation passed through)
_ATTEND16_SCORE_MMA = ('dsa_step.cu', '      taps_wc<MT, kRes>(t, mt0, mtn, j, acc);\n',
                       '      for (auto& x : acc) for (auto& y : x) for (auto& z : y) z = 0.f;\n')
_ATTEND16_SCORE_TANH = ('dsa_step.cu',
                        '            const float a = tanhf(__fadd_rn(__fadd_rn(acc[i][nt][e], '
                        'e & 1 ? cb.y : cb.x),\n',
                        '            const float a = (__fadd_rn(__fadd_rn(acc[i][nt][e], '
                        'e & 1 ? cb.y : cb.x),\n')
SPLITS['current']['dsa_step_fwd_bf16'] = ('dsa_step.cu', [
    ('taps staging', [_ATTEND16_STAGE]),
    ('scores (mma, tanh)', [_ATTEND16_SCORES]),
    ('scores\' mma', [_ATTEND16_SCORE_MMA]),
    ('scores\' tanh', [_ATTEND16_SCORE_TANH]),
    ('ctx', [('dsa_step.cu',
              '          acc[0] = fmaf(w, lerp_tap(wl, bf_lo(vl[k]), wh, bf_lo(vh[k])), acc[0]);\n'
              '          acc[1] = fmaf(w, lerp_tap(wl, bf_hi(vl[k]), wh, bf_hi(vh[k])), acc[1]);\n',
              '')]),
])
SPLITS['current']['dsa_step_bwd_bf16'] = ('dsa_step.cu', [
    ('taps staging', [_ATTEND16_STAGE]),
    ('scores (mma, tanh)', [_ATTEND16_SCORES]),
    ('d wts', [('dsa_step.cu',
                '                acc = fmaf(lerp_tap(wl, bf_lo(lw[e]), wh, bf_lo(hw[e])), d8[2 * e], '
                'acc);\n'
                '                acc = fmaf(lerp_tap(wl, bf_hi(lw[e]), wh, bf_hi(hw[e])), d8[2 * e + 1], '
                'acc);\n', '')]),
    ('du (mma, tanh, sums)', [('dsa_step.cu',
                               '      attend16_du<MT, kSmall>(at, t, m0, nmt, ddot, dhvec, dcb, '
                               'daw);\n', '')]),
    ('du\'s mma', [('dsa_step.cu',
                    '      taps_wc<MT, kRes>(t, m0 / 16 + i0, m0 / 16 + nmt, j, acc);\n',
                    '      for (auto& x : acc) for (auto& y : x) for (auto& z : y) z = 0.f;\n')]),
    ('du\'s tanh', [('dsa_step.cu', '            const float th = tanhf(__fadd_rn(',
                     '            const float th = (__fadd_rn(')]),
    ('dtaps (mma, dpos, dvalue)', [('dsa_step.cu',
                                    '      attend16_dtaps<MTD, kSmall>(at, t, m0, nmt, q0, dctx, '
                                    'part, dvalue_b);\n', '')]),
    ('dcw (mma)', [('dsa_step.cu', '        attend16_dcw(t, m0, nmt, dcw);\n', '')]),
    ('dcw outer sum', [('dsa_step.cu', 'B * Q * H * LP, Dh, A, dcw, st,',
                        '0, Dh, A, dcw, st,')]),
])

# the bf16 kernels as they were before their tensor-core gates (the f32
# kernels' code on bf16-rounded operands): run it from a checkout of a tree
# from before them with this file copied in, python3 chip_smoke.py --split
# cuda_core_bf16 (K4-bf16 and K6-bf16: a tree whose K4 has no bf16
# instantiation; K9-bf16 and K10-bf16: one whose K9 has none)
SPLITS['cuda_core_bf16'] = {
    'dsa_scan_fwd_bf16': ('dsa_scan.cu', SPLITS['current']['dsa_scan_fwd'][1]
                          + [('hvec', [_HVEC_CUDA_CORE])]),
    'dsa_greedy_bf16': ('dsa_greedy.cu', SPLITS['current']['dsa_greedy'][1]
                        + [('hvec', [_HVEC_CUDA_CORE])]),
    'dsa_lstm_fwd_bf16': SPLITS['current']['dsa_lstm_fwd'],
    'dsa_lstm_bwd_bf16': SPLITS['current']['dsa_lstm_bwd'],
}


# the kernels whose phase split the full run prints: every variant of a
# split is a build of its whole source, and all of SPLITS['current'] (92
# builds) took 364 s of a 1,118 s run on an NVIDIA H100 80GB HBM3 machine,
# so the full run splits the latest slice's kernels and `--split current`
# the rest on demand
FULL_RUN_SPLITS = ('dsa_step_fwd_bf16', 'dsa_step_bwd_bf16')


def build_variants(csrc, specs):
    """One library per kernel and variant, specs = {kernel: (source,
    {variant: [(file, old, new)]})} (the empty edit list builds the kernel
    as it is): every nvcc started together, a variant that two kernels share
    (the same source and edits) built once; returns {kernel: {variant:
    loaded KernelLib}}."""
    import ctypes
    import hashlib
    import shutil
    from dvc_tpu_torch.ops import _cuda
    jobs, where = {}, {}
    for kernel, (source, variants) in specs.items():
        for name, edits in variants.items():
            digest = hashlib.sha256(repr((source, edits)).encode())
            for f in sorted(os.listdir(csrc)):
                with open(os.path.join(csrc, f), 'rb') as fh:
                    digest.update(fh.read())
            out = os.path.join(_cuda.BUILD_ROOT, 'phases',
                               digest.hexdigest()[:16])
            lib = os.path.join(out, 'lib.so')
            where[kernel, name] = lib
            if lib in jobs or os.path.exists(lib):
                jobs.setdefault(lib, None)
                continue
            shutil.rmtree(out, ignore_errors=True)
            shutil.copytree(csrc, out)
            for f, old, new in edits:
                path = os.path.join(out, f)
                with open(path) as fh:
                    text = fh.read()
                if text.count(old) != 1:
                    raise AssertionError(f'split {kernel} {name}: {old!r} '
                                         f'occurs {text.count(old)} times '
                                         f'in {f}')
                with open(path, 'w') as fh:
                    fh.write(text.replace(old, new))
            plan = os.path.join(out, 'dsa_gemm_plan.cc')
            jobs[lib] = subprocess.Popen(
                [_cuda._nvcc(), *_cuda.NVCC_FLAGS, '-shared', '-o', lib,
                 os.path.join(out, source),
                 *([plan] if os.path.exists(plan) else [])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loaded = {}
    for lib, proc in jobs.items():
        if proc is not None and proc.wait() != 0:
            raise RuntimeError(f'split {lib}: nvcc failed:\n'
                               f'{proc.stdout.read()}')
        cdll = ctypes.CDLL(lib)
        for fn, argtypes in _cuda._SIGNATURES.items():
            if hasattr(cdll, fn):
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = ctypes.c_int
        loaded[lib] = _cuda.KernelLib(cdll, lib, 0.0, '')
    libs = {}
    for (kernel, name), lib in where.items():
        libs.setdefault(kernel, {})[name] = loaded[lib]
    return libs


def kernel_args(args, lstm):
    """The operands of the word-step kernels alone from ``step_inputs``'s
    (those of the JAX boundary): value_t, the table VW = value_t . cw, then
    the rest without cw.  A tree whose kernels take cw (an older tree, from
    before their table form) gets ``args`` as they are."""
    from dvc_tpu_torch.ops import dsa_step
    if not hasattr(dsa_step, 'lstm_step_table_ref' if lstm
                   else 'STEP_TABLE_NAMES'):
        return args
    from dvc_tpu_torch.ops.dsa_tables import table_gemm
    i = 8 if lstm else 3
    value_t, cw = args[0], args[i]
    B, H, S, Dh = value_t.shape
    vw = table_gemm(value_t.reshape(-1, Dh), cw).reshape(B, H, S, -1)
    return (value_t, vw) + tuple(args[1:i]) + tuple(args[i + 1:])


def gate_pack_kw(args):
    """The keyword arguments that K9-bf16 and K10-bf16 take beside the
    JAX-boundary operands ``args`` (``step_inputs``' with ``lstm``): the
    gate weights packed once (``pack_gate_weights(w_hh, ctx_w3)``), in a
    tree whose wrappers take a pack; none in an older one, whose bf16
    kernels read ctx_w3 and w_hh (given rounded)."""
    import inspect
    from dvc_tpu_torch.ops import dsa_step
    if 'pack' not in inspect.signature(dsa_step.dsa_lstm_step_fwd).parameters:
        return {}
    from dvc_tpu_torch.ops.dsa_scan import pack_gate_weights
    return {'pack': pack_gate_weights(args[7], args[6])}


def bf16_kernel_args(args, lstm):
    """The bf16 word-step kernels' operands alone from ``step_inputs``':
    value_t (K9/K10: also ctx_w3 and w_hh, which a tree with the gate pack
    does not read) rounded to bf16, the table VW in its bf16 mode, then the
    rest without cw; and their keyword arguments (K9/K10-bf16:
    ``gate_pack_kw``)."""
    from dvc_tpu_torch.ops import dsa_bf16
    from dvc_tpu_torch.ops.dsa_tables import table_gemm
    i = 8 if lstm else 3
    ops = [dsa_bf16.bf16(a) if j in ((0, 6, 7) if lstm else (0,)) else a
           for j, a in enumerate(args)]
    B, H, S, Dh = args[0].shape
    vw = table_gemm(ops[0].reshape(-1, Dh), args[i], BF16).reshape(B, H, S, -1)
    return ([ops[0], vw] + ops[1:i] + ops[i + 1:],
            gate_pack_kw(args) if lstm else {})


def attend16_kernel_args(args):
    """K7-bf16's and K8-bf16's operands alone from ``step_inputs``' (without
    ``lstm``) and their keyword arguments: in a tree whose bf16 wrappers
    take the Wc pack, value_t in torch.bfloat16, no VW, the rest without cw,
    and {'pack': ``pack_attend_weights(cw)``}; in an older one the table
    form's (``bf16_kernel_args``)."""
    from dvc_tpu_torch.ops import dsa_step
    if not hasattr(dsa_step, 'pack_attend_weights'):
        return bf16_kernel_args(args, False)
    from dvc_tpu_torch.ops.dsa_bf16 import bf16_operand
    return ([bf16_operand(args[0]), None] + list(args[1:3]) + list(args[4:]),
            {'pack': dsa_step.pack_attend_weights(args[3])})


def attend16_macs(args):
    """MACs of K7-bf16's product form over its B*Q queries (``args``:
    ``step_inputs``'): each tap row's taps . Wc (Dh*A) and . aw (A), and the
    context (3*Dh a tap); K8-bf16 does three such products."""
    value_t, pos = args[:2]
    B, H, S, Dh = value_t.shape
    A = args[2].shape[-1]
    return B * pos.shape[2] * H * pos.shape[3] * (Dh * A + A + 3 * Dh)


def split_cases(kernels):
    """(kernel, shape label, call) of each split of ``kernels``: K3 at
    (B, Q) = (16, 375), (16, 100), (1, 375) and at (16, 375) on encoder
    locations; K1/K2 at
    the MSDA shapes of ``phase_kernels`` ((B, Q) = (16, 375), (16, 100),
    (1, 375)); K6 at the serving shape (B=16, Q=100, H=1 and 8), K6-bf16
    also at B=1; K4 and K5 at the train shapes (Q=90, K=29; B=1 and 16 at
    H=1, B=1 at H=8), K4-bf16 and K5-bf16 at the same shapes; K7-K10
    (alone, with VW given) at the word-step shapes of ``check_step`` (B=1,
    Q=90, H=1; B=16, Q=100, H=1 and 8), K7-bf16 to K10-bf16 at
    STEP_BF16_SHAPES."""
    import torch
    from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan
    from dvc_tpu_torch.ops.dsa_scan import (dsa_teacher_scan_bwd,
                                            dsa_teacher_scan_fwd)
    from dvc_tpu_torch.ops.dsa_step import (dsa_lstm_step_bwd,
                                            dsa_lstm_step_fwd,
                                            dsa_sample_attend_bwd,
                                            dsa_sample_attend_fwd)
    from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                  ms_deform_attn_bwd)
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = []
    if 'msda_bwd' in kernels:
        for B, Q, enc in ((16, 375, False), (16, 100, False), (1, 375, False),
                          (16, 375, True)):
            value, loc, attn = (msda_encoder_inputs(gen, B) if enc
                                else msda_inputs(gen, B, Q))
            g = torch.randn((B, Q, 512), generator=gen, device='cuda')
            cases.append(('msda_bwd', f'B={B} Q={Q}' + ' encoder' * enc,
                          lambda a=(value, loc, attn, g):
                          ms_deform_attn_bwd(a[0], MSDA_LEVELS, *a[1:])))
    if 'msda_fwd' in kernels:
        for B, Q in ((16, 375), (16, 100), (1, 375)):
            args = msda_inputs(gen, B, Q)
            cases.append(('msda_fwd', f'B={B} Q={Q}', lambda args=args:
                          ms_deform_attn(args[0], MSDA_LEVELS, *args[1:])))
    if 'dsa_greedy' in kernels:
        for H in (1, 8):
            args = greedy_inputs(gen, 16, 100, H)
            cases.append(('dsa_greedy', f'B=16 Q=100 H={H}',
                          lambda args=args: dsa_greedy_scan(*args, MSDA_LEVELS, 30)))
    if 'dsa_greedy_bf16' in kernels:
        for B, H in ((16, 1), (16, 8), (1, 1), (1, 8)):
            args = greedy_inputs(gen, B, 100, H)
            cases.append(('dsa_greedy_bf16', f'B={B} Q=100 H={H}',
                          lambda args=args: dsa_greedy_scan(*args, MSDA_LEVELS, 30,
                                                            precision=BF16)))
    for B, H in ((1, 1), (16, 1), (1, 8)):
        if 'dsa_scan_fwd_bf16' not in kernels:
            break
        args = scan_inputs(gen, B, 90, 29, H)
        cases.append(('dsa_scan_fwd_bf16', f'B={B} Q=90 K=29 H={H}',
                      lambda args=args: dsa_teacher_scan_fwd(*args, MSDA_LEVELS,
                                                             precision=BF16)))
    for B, H in ((1, 1), (16, 1), (1, 8)):
        if 'dsa_scan_bwd_bf16' not in kernels:
            break
        args = scan_inputs(gen, B, 90, 29, H)
        hs, cs = dsa_teacher_scan_fwd(*args, MSDA_LEVELS, precision=BF16)
        g = torch.randn(hs.shape, generator=gen, device='cuda')
        cases.append(('dsa_scan_bwd_bf16', f'B={B} Q=90 K=29 H={H}',
                      lambda args=args, hs=hs, cs=cs, g=g:
                      dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g,
                                           precision=BF16)))
    for B, H in ((1, 1), (16, 1), (1, 8)):
        if not {'dsa_scan_fwd', 'dsa_scan_bwd'} & set(kernels):
            break
        args = scan_inputs(gen, B, 90, 29, H)
        shape = f'B={B} Q=90 K=29 H={H}'
        if 'dsa_scan_fwd' in kernels:
            cases.append(('dsa_scan_fwd', shape, lambda args=args:
                          dsa_teacher_scan_fwd(*args, MSDA_LEVELS)))
        if 'dsa_scan_bwd' in kernels:
            hs, cs = dsa_teacher_scan_fwd(*args, MSDA_LEVELS)
            g = torch.randn(hs.shape, generator=gen, device='cuda')
            cases.append(('dsa_scan_bwd', shape,
                          lambda args=args, hs=hs, cs=cs, g=g:
                          dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g)))
    for B, Q, H in ((1, 90, 1), (16, 100, 1), (16, 100, 8)):
        if not {'dsa_step_fwd', 'dsa_step_bwd'} & set(kernels):
            break
        args = kernel_args(step_inputs(gen, B, Q, H, False), False)
        shape = f'B={B} Q={Q} H={H}'
        if 'dsa_step_fwd' in kernels:
            cases.append(('dsa_step_fwd', shape, lambda args=args:
                          dsa_sample_attend_fwd(*args, MSDA_LEVELS)))
        if 'dsa_step_bwd' in kernels:
            g = torch.randn((B, H, Q, 512 // H), generator=gen, device='cuda')
            cases.append(('dsa_step_bwd', shape, lambda args=args, g=g:
                          dsa_sample_attend_bwd(*args, MSDA_LEVELS, g)))
    for B, Q, H in ((1, 90, 1), (16, 100, 1), (16, 100, 8)):
        if not {'dsa_lstm_fwd', 'dsa_lstm_bwd'} & set(kernels):
            break
        args = kernel_args(step_inputs(gen, B, Q, H, True), True)
        shape = f'B={B} Q={Q} H={H}'
        if 'dsa_lstm_fwd' in kernels:
            cases.append(('dsa_lstm_fwd', shape, lambda args=args:
                          dsa_lstm_step_fwd(*args, MSDA_LEVELS)))
        if 'dsa_lstm_bwd' in kernels:
            gh, gc = (torch.randn((B, Q, 512), generator=gen, device='cuda')
                      for _ in range(2))
            cases.append(('dsa_lstm_bwd', shape,
                          lambda args=args, gh=gh, gc=gc:
                          dsa_lstm_step_bwd(*args, MSDA_LEVELS, gh, gc)))
    for B, Q, H in STEP_BF16_SHAPES:
        if not {'dsa_step_fwd_bf16', 'dsa_step_bwd_bf16'} & set(kernels):
            break
        args, kw = attend16_kernel_args(step_inputs(gen, B, Q, H, False))
        shape = f'B={B} Q={Q} H={H}'
        if 'dsa_step_fwd_bf16' in kernels:
            cases.append(('dsa_step_fwd_bf16', shape, lambda args=args, kw=kw:
                          dsa_sample_attend_fwd(*args, MSDA_LEVELS,
                                                precision=BF16, **kw)))
        if 'dsa_step_bwd_bf16' in kernels:
            g = torch.randn((B, H, Q, 512 // H), generator=gen, device='cuda')
            cases.append(('dsa_step_bwd_bf16', shape,
                          lambda args=args, kw=kw, g=g:
                          dsa_sample_attend_bwd(*args, MSDA_LEVELS, g,
                                                precision=BF16, **kw)))
    for B, Q, H in STEP_BF16_SHAPES:
        if not {'dsa_lstm_fwd_bf16', 'dsa_lstm_bwd_bf16'} & set(kernels):
            break
        args, kw = bf16_kernel_args(step_inputs(gen, B, Q, H, True), True)
        shape = f'B={B} Q={Q} H={H}'
        if 'dsa_lstm_fwd_bf16' in kernels:
            cases.append(('dsa_lstm_fwd_bf16', shape, lambda args=args, kw=kw:
                          dsa_lstm_step_fwd(*args, MSDA_LEVELS, precision=BF16,
                                            **kw)))
        if 'dsa_lstm_bwd_bf16' in kernels:
            gh, gc = (torch.randn((B, Q, 512), generator=gen, device='cuda')
                      for _ in range(2))
            cases.append(('dsa_lstm_bwd_bf16', shape,
                          lambda args=args, kw=kw, gh=gh, gc=gc:
                          dsa_lstm_step_bwd(*args, MSDA_LEVELS, gh, gc,
                                            precision=BF16, **kw)))
    return cases


def phase_split(spec, kernels=None):
    """Print one line per kernel (of ``kernels``, default every kernel of
    the spec) and shape: its time as built, and each
    phase's share (as built minus the variant without that phase; CUDA
    events, mean of 3 after a warm-up; the MSDA kernels, whose small
    launches the host's time would hide, in device time, mean of 20).
    Returns {kernel: [lines]}."""
    import torch
    from dvc_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    libs = build_variants(_cuda.CSRC, {
        kernel: (source, {'as built': [], **dict(phases)})
        for kernel, (source, phases) in SPLITS[spec].items()
        if kernels is None or kernel in kernels})
    print(f'[split] {sum(map(len, libs.values()))} variants of '
          f'{len(libs)} kernels built in {time.perf_counter() - t0:.1f} s')
    saved, out = _cuda._LIB, {}
    try:
        with torch.inference_mode():
            for kernel, shape, call in split_cases(libs):
                times = {}
                for name, lib in libs[kernel].items():
                    _cuda._LIB = lib
                    times[name] = (device_ms(call, 20) if kernel[:4] == 'msda'
                                   else cuda_ms(call, 3))
                full = times.pop('as built')
                line = (f'[split] {kernel} {shape} ({spec}): as built '
                        f'{full:.3f} ms; without each phase, its share: '
                        + '; '.join(f'{n} {full - t:.3f} ms'
                                    for n, t in times.items()))
                print(line)
                out.setdefault(kernel, []).append(line)
    finally:
        _cuda._LIB = saved
    return out


# the tables' shapes of the stepwise path (value . Wc: B*H*S rows, Dh, A)
TABLE_SHAPES = (('B=1 H=1', 375, 512, 512), ('B=16 H=1', 6000, 512, 512),
                ('B=16 H=8', 48000, 64, 512))


def ab_bf16_times():
    """Kernel-only CUDA-event times (ms) of K4-bf16 and K5-bf16 at the
    train shapes (Q=90, K=29; (B, H) = (1, 1), (16, 1), (1, 8)), K4 and K5
    in f32 beside them, of K6-bf16 and K6 at the serving shapes (Q=100, K=30;
    (B, H) = (16, 1), (16, 8), (1, 1), (1, 8)), and of dsa::gemm's bf16
    mode at every shape of OUTER_SUMS and TABLE_SHAPES
    (the table and its backward), of K9-bf16 and K10-bf16 with VW given at
    STEP_BF16_SHAPES, f32 K9 and K10 beside them, of K7-bf16 and K8-bf16 at
    STEP_BF16_SHAPES (f32 K7 and K8 beside them, VW given) as each tree's
    wrappers take them (VW given, or value16
    and the Wc pack: ``attend16_kernel_args``), each also with 1/29 of its
    per-pass work (``+pass/29``: the table's bf16 mode and its backward, or
    the Wc pack) and, where it returns G, the add of a step's G (``G
    add``), and the device time and device activities of one traced bf16
    --dsa_lstm_fuse 1 train step at B=1 and B=16
    (``lstm_fuse_step_traces``) and of one --dsa_lstm_fuse 0 step at B=16,
    cap_nheads 1 and 8 (``unfused_step_traces``), as one JSON line: the half of
    an A/B of two trees in one call (``--ab-bf16``; run it from each tree's
    root in turns, old, new, new, old, as ``--ab``).  A tree whose GEMM
    reads f32 operands in its bf16 mode (no ``_cuda.bf16_flags``) is timed
    on f32 operands, a newer one on torch.bfloat16 ones, and K9/K10-bf16
    get the gate pack where the tree's wrappers take one
    (``gate_pack_kw``), as each tree's kernels hand them over.  The GEMM's,
    the tables' and the word steps' also in device time (the profiler's;
    ``(device)`` keys: at B=1 the event time is the host's)."""
    import torch
    from dvc_tpu_torch.ops import _cuda
    from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan
    from dvc_tpu_torch.ops.dsa_scan import (dsa_teacher_scan_bwd,
                                            dsa_teacher_scan_fwd)
    from dvc_tpu_torch.ops import dsa_step
    from dvc_tpu_torch.ops.dsa_step import (dsa_lstm_step_bwd,
                                            dsa_lstm_step_fwd,
                                            dsa_sample_attend_bwd,
                                            dsa_sample_attend_fwd)
    from dvc_tpu_torch.ops.dsa_tables import (dsa_value_table, table_gemm,
                                              table_gemm_bwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    bf16_stored = hasattr(_cuda, 'bf16_flags')

    def operand(*shape):
        x = torch.randn(shape, generator=gen, device='cuda')
        return x.bfloat16() if bf16_stored else x

    out = {}
    with torch.inference_mode():
        for B, H in ((1, 1), (16, 1), (1, 8)):
            args = scan_inputs(gen, B, 90, 29, H)
            hs, cs = dsa_teacher_scan_fwd(*args, MSDA_LEVELS, precision=BF16)
            g = torch.randn(hs.shape, generator=gen, device='cuda')
            out[f'dsa_scan_fwd_bf16 B={B} H={H}'] = cuda_ms(
                lambda: dsa_teacher_scan_fwd(*args, MSDA_LEVELS,
                                             precision=BF16), 5)
            out[f'dsa_scan_bwd_bf16 B={B} H={H}'] = cuda_ms(
                lambda: dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g,
                                             precision=BF16), 5)
            out[f'dsa_scan_fwd B={B} H={H}'] = cuda_ms(
                lambda: dsa_teacher_scan_fwd(*args, MSDA_LEVELS), 5)
            hs, cs = dsa_teacher_scan_fwd(*args, MSDA_LEVELS)
            out[f'dsa_scan_bwd B={B} H={H}'] = cuda_ms(
                lambda: dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g), 5)
        for B, H in ((16, 1), (16, 8), (1, 1), (1, 8)):
            args = greedy_inputs(gen, B, 100, H)
            out[f'dsa_greedy_bf16 B={B} H={H}'] = cuda_ms(
                lambda: dsa_greedy_scan(*args, MSDA_LEVELS, 30,
                                        precision=BF16), 5)
            out[f'dsa_greedy B={B} H={H}'] = cuda_ms(
                lambda: dsa_greedy_scan(*args, MSDA_LEVELS, 30), 5)
        calls = {}
        for label, rows, m, n, _ in OUTER_SUMS:
            X, Y = operand(rows, m), operand(rows, n)
            o = torch.empty((m, n), device='cuda')
            work = outer_sum_work(X, Y)
            calls[f'gemm_bf16 {label}'] = (
                lambda X=X, Y=Y, o=o, work=work:
                run_outer_sum(X, Y, o, work, bf16=1))
        for label, N, k, n in TABLE_SHAPES:
            x, w, g = operand(N, k), operand(k, n), operand(N, n)
            calls[f'table_gemm_bf16 {label}'] = (
                lambda x=x, w=w: table_gemm(x, w, BF16))
            calls[f'table_gemm_bwd_bf16 {label}'] = (
                lambda x=x, w=w, g=g: table_gemm_bwd(x, w, g, BF16))
        L = MSDA_LEVELS
        for B, Q, H in STEP_BF16_SHAPES:
            args = step_inputs(gen, B, Q, H, True)
            k16, kw = bf16_kernel_args(args, True)
            k32 = kernel_args(args, True)
            gh, gc = (torch.randn((B, Q, 512), generator=gen, device='cuda')
                      for _ in range(2))
            label = f'B={B} Q={Q} H={H}'
            calls[f'dsa_lstm_fwd_bf16 {label}'] = (
                lambda k16=k16, kw=kw:
                dsa_lstm_step_fwd(*k16, L, precision=BF16, **kw))
            calls[f'dsa_lstm_bwd_bf16 {label}'] = (
                lambda k16=k16, kw=kw, gh=gh, gc=gc:
                dsa_lstm_step_bwd(*k16, L, gh, gc, precision=BF16, **kw))
            calls[f'dsa_lstm_fwd {label}'] = (
                lambda k32=k32: dsa_lstm_step_fwd(*k32, L))
            calls[f'dsa_lstm_bwd {label}'] = (
                lambda k32=k32, gh=gh, gc=gc:
                dsa_lstm_step_bwd(*k32, L, gh, gc))
        # K7-bf16 and K8-bf16 alone, and beside them the per-pass work a
        # step carries 1/29 of: the parent's table in its bf16 mode (cw
        # rounded, the GEMM) for K7 and its backward (G rounded, the GEMM's
        # backward) for K8, where the tree's K7/K8-bf16 read VW; the Wc
        # pack for K7 where they read it; and the parent's sum of a step's G
        # into the others' (an add of (B, H, S, A), once a step)
        passes = {}
        for B, Q, H in STEP_BF16_SHAPES:
            full = step_inputs(gen, B, Q, H, False)
            k16, kw = attend16_kernel_args(full)
            g = torch.randn((B, H, Q, 512 // H), generator=gen, device='cuda')
            label = f'B={B} Q={Q} H={H}'
            calls[f'dsa_step_fwd_bf16 {label}'] = (
                lambda k16=k16, kw=kw:
                dsa_sample_attend_fwd(*k16, L, precision=BF16, **kw))
            calls[f'dsa_step_bwd_bf16 {label}'] = (
                lambda k16=k16, kw=kw, g=g:
                dsa_sample_attend_bwd(*k16, L, g, precision=BF16, **kw))
            k32 = kernel_args(full, False)    # f32 K7 and K8 (VW given) beside them
            calls[f'dsa_step_fwd {label}'] = (
                lambda k32=k32: dsa_sample_attend_fwd(*k32, L))
            calls[f'dsa_step_bwd {label}'] = (
                lambda k32=k32, g=g: dsa_sample_attend_bwd(*k32, L, g))
            value_t, cw = full[0], full[3]
            if kw:
                passes[f'dsa_step_fwd_bf16 {label}'] = (
                    lambda cw=cw: dsa_step.pack_attend_weights(cw))
                continue
            x16 = value_t.reshape(-1, value_t.shape[-1]).bfloat16()
            G = torch.randn((B, H, 375, 512), generator=gen, device='cuda')
            acc = torch.zeros_like(G)
            passes[f'dsa_step_fwd_bf16 {label}'] = (
                lambda value_t=value_t, cw=cw, x16=x16:
                dsa_value_table(value_t, cw, BF16, x16))
            passes[f'dsa_step_bwd_bf16 {label}'] = (
                lambda x16=x16, cw=cw, G=G: table_gemm_bwd(
                    x16, cw.bfloat16(), G.reshape(x16.shape[0], -1).bfloat16(),
                    BF16))
            calls[f'dsa_step_bwd_bf16 {label} G add'] = (
                lambda acc=acc, G=G: acc.add_(G))
        for key, call in calls.items():
            out[key] = cuda_ms(call, 20)
            out[f'{key} (device)'] = device_ms(call, 20)
        for key in [k for k in calls if k.startswith('dsa_step_')
                    and '_bf16 ' in k and not k.endswith('G add')]:
            share = cuda_ms(passes[key], 20) if key in passes else 0.0
            out[f'{key} +pass/29'] = out[key] + share / 29
    out.update(lstm_fuse_step_traces())
    out.update(unfused_step_traces())
    print(json.dumps({'ab_bf16': out, 'bf16_stored': bf16_stored}))


def unfused_step_traces(recipe=None, heads=(1, 8), B=16):
    """One traced bf16 train step through K7/K8-bf16 (``--dsa_scan_fuse 0``
    with the bf16 flags, ``--dsa_lstm_fuse 0``) at B=16 at each cap_nheads
    of ``heads``, after a warm-up step, on the synthetic full-width run of
    ``recipe`` (or one written here): {'unfused_bf16 H=<H> <busy_ms |
    activities | idle | table launches>': value} (``traced``; the table's
    launches, forward and backward, in the traced step).  The
    scheduled-sampling route runs the same word steps."""
    import torch
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    if recipe is None:
        with tempfile.TemporaryDirectory() as tmp:
            return unfused_step_traces(
                write_synthetic_run(tmp, load_config(CFG, root=ROOT)), heads,
                B)
    out = {}
    for H in heads:
        opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE,
                          '--dsa_scan_fuse', '0', '--dsa_lstm_fuse', '0',
                          *BF16_FLAGS], root=ROOT)
        opt.cap_nheads = H        # the recipe file (1) overlays the flag
        trainer = Trainer(opt, device=DEVICE)
        batch = train_batch(opt, B)
        trainer.train_step(batch, opt.lr)
        torch.cuda.synchronize()
        reset_counts()
        t = trace(f'B={B} H={H} bf16 --dsa_lstm_fuse 0 train step (K7/K8-bf16, '
                  f'{word_steps(batch)} word steps)',
                  lambda: trainer.train_step(batch, opt.lr))
        launches, _ = read_counts()
        for k in ('busy_ms', 'activities', 'idle'):
            if k in t:
                out[f'unfused_bf16 H={H} {k}'] = t[k]
        out[f'unfused_bf16 H={H} table launches'] = (
            launches['table_gemm_bf16'] + launches['table_gemm_bwd_bf16'])
        del trainer
    return out


def lstm_fuse_step_traces(recipe=None, batches=(1, 16)):
    """One traced bf16 train step through K9-bf16/K10-bf16 (``--dsa_scan_fuse
    0 --dsa_lstm_fuse 1`` with the bf16 flags) at each B of ``batches``,
    after a warm-up step, on the synthetic full-width run of ``recipe`` (or
    one written here): {'lstm_fuse_bf16 B=<B> <busy_ms | activities |
    idle>': value} (``traced``: device busy ms, device activities, idle
    share; empty when the profiler saw no device activity)."""
    import torch
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    if recipe is None:
        with tempfile.TemporaryDirectory() as tmp:
            return lstm_fuse_step_traces(
                write_synthetic_run(tmp, load_config(CFG, root=ROOT)), batches)
    opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE,
                      '--dsa_scan_fuse', '0', '--dsa_lstm_fuse', '1',
                      *BF16_FLAGS], root=ROOT)
    trainer = Trainer(opt, device=DEVICE)
    out = {}
    for B in batches:
        batch = train_batch(opt, B)
        trainer.train_step(batch, opt.lr)
        torch.cuda.synchronize()
        t = trace(f'B={B} bf16 --dsa_lstm_fuse 1 train step (K9/K10-bf16, '
                  f'{word_steps(batch)} word steps)',
                  lambda: trainer.train_step(batch, opt.lr))
        for k in ('busy_ms', 'activities', 'idle'):
            if k in t:
                out[f'lstm_fuse_bf16 B={B} {k}'] = t[k]
    return out


def ab_times():
    """Kernel-only CUDA-event times (ms) of every kernel at the phase-3
    shapes, plus the greedy decode at B=1 (a single caption_features
    request), and of the GEMM at every shape of ``phase_gemm``, as one JSON
    line: the half of an A/B of two trees in one call.  The MSDA forward
    and backward also in device time (the profiler's; the event time of a
    small launch is the wrapper's host time), the backward also at B=16 on
    the encoder's locations; the word-step kernels alone (with VW given
    where the tree's kernels take it), and K7 and K8 also with 1/29 of the
    table's forward or backward at their shape (``+table/29``: the share of
    one table per 29-step pass; a tree whose K7 and K8 take cw has no
    table, so there the key is the kernel alone).  Run ``python3
    chip_smoke.py --ab`` from each tree's root in turns (old, new, new,
    old)."""
    import torch
    from dvc_tpu_torch import ops
    from dvc_tpu_torch.ops import dsa_tables
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    out = {}
    with torch.inference_mode():
        for B, Q in ((16, 375), (16, 100), (1, 375)):
            value, loc, attn = msda_inputs(gen, B, Q)
            out[f'msda_fwd B={B} Q={Q}'] = cuda_ms(
                lambda: ops.ms_deform_attn(value, MSDA_LEVELS, loc, attn), 50)
            out[f'msda_fwd B={B} Q={Q} (device)'] = device_ms(
                lambda: ops.ms_deform_attn(value, MSDA_LEVELS, loc, attn), 50)
        for B, H in ((16, 1), (16, 8), (1, 1), (1, 8)):
            args = greedy_inputs(gen, B, 100, H)
            out[f'dsa_greedy B={B} Q=100 H={H}'] = cuda_ms(
                lambda: ops.dsa_greedy_scan(*args, MSDA_LEVELS, 30), 3)
        for B, Q, enc in ((1, 375, ''), (1, 100, ''), (16, 375, ''),
                          (16, 100, ''), (16, 375, ' encoder')):
            value, loc, attn = (msda_encoder_inputs(gen, B) if enc
                                else msda_inputs(gen, B, Q))
            g = torch.randn((B, Q, 512), generator=gen, device='cuda')
            out[f'msda_bwd B={B} Q={Q}{enc}'] = cuda_ms(
                lambda: ops.ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn,
                                               g), 50)
            out[f'msda_bwd B={B} Q={Q}{enc} (device)'] = device_ms(
                lambda: ops.ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn,
                                               g), 50)
        for B, H in ((1, 1), (16, 1), (1, 8)):
            args = scan_inputs(gen, B, 90, 29, H)
            hs, cs = ops.dsa_teacher_scan_fwd(*args, MSDA_LEVELS)
            g = torch.randn(hs.shape, generator=gen, device='cuda')
            out[f'dsa_scan_fwd B={B} Q=90 H={H}'] = cuda_ms(
                lambda: ops.dsa_teacher_scan_fwd(*args, MSDA_LEVELS), 3)
            out[f'dsa_scan_bwd B={B} Q=90 H={H}'] = cuda_ms(
                lambda: ops.dsa_teacher_scan_bwd(*args, MSDA_LEVELS, hs, cs, g), 3)
        for lstm, kind in ((False, 'dsa_step'), (True, 'dsa_lstm')):
            fwd = ops.dsa_lstm_step_fwd if lstm else ops.dsa_sample_attend_fwd
            bwd = ops.dsa_lstm_step_bwd if lstm else ops.dsa_sample_attend_bwd
            for B, Q, H in ((1, 90, 1), (16, 100, 1), (16, 100, 8)):
                full = step_inputs(gen, B, Q, H, lstm)
                args = kernel_args(full, lstm)      # with VW where taken
                outs = fwd(*args, MSDA_LEVELS)
                outs = outs if isinstance(outs, tuple) else (outs,)
                cot = tuple(torch.randn(o.shape, generator=gen, device='cuda')
                            for o in outs)
                shape = f'B={B} Q={Q} H={H}'
                out[f'{kind}_fwd {shape}'] = cuda_ms(
                    lambda: fwd(*args, MSDA_LEVELS), 20)
                out[f'{kind}_bwd {shape}'] = cuda_ms(
                    lambda: bwd(*args, MSDA_LEVELS, *cot), 20)
                if lstm:
                    continue
                table = {'fwd': 0.0, 'bwd': 0.0}
                if args is not full:        # the table's share of a pass
                    rows = full[0].reshape(-1, full[0].shape[-1])
                    cw, G = full[3], torch.randn_like(args[1])
                    table['fwd'] = cuda_ms(
                        lambda: dsa_tables.table_gemm(rows, cw), 20)
                    table['bwd'] = cuda_ms(lambda: dsa_tables.table_gemm_bwd(
                        rows, cw, G.reshape(rows.shape[0], -1)), 20)
                for d in ('fwd', 'bwd'):
                    out[f'{kind}_{d} {shape} +table/29'] = \
                        out[f'{kind}_{d} {shape}'] + table[d] / 29
        # the table VW = value . Wc of K7-K10 and its backward (a tree from
        # before the table form has no backward), embed . token_w, and the
        # outer sums that K5 and K10 run inside their launches
        for N, k, n, label in ((375, 512, 512, 'value . Wc B=1 H=1'),
                               (16 * 375, 512, 512, 'value . Wc B=16 H=1'),
                               (16 * 8 * 375, 64, 512, 'value . Wc B=16 H=8'),
                               (1608, 512, 2048, 'embed . token_w')):
            x = torch.randn((N, k), generator=gen, device='cuda')
            w = torch.randn((k, n), generator=gen, device='cuda')
            g = torch.randn((N, n), generator=gen, device='cuda')
            out[f'table_gemm {label}'] = cuda_ms(
                lambda: ops.table_gemm(x, w), 20)
            if hasattr(dsa_tables, 'table_gemm_bwd') and label[0] == 'v':
                out[f'table_gemm_bwd {label}'] = cuda_ms(
                    lambda: dsa_tables.table_gemm_bwd(x, w, g), 20)
            if N == 375:
                # at B=1 the event times are the host's; the device's too
                out[f'table_gemm {label} (device)'] = device_ms(
                    lambda: ops.table_gemm(x, w), 20)
                if hasattr(dsa_tables, 'table_gemm_bwd'):
                    out[f'table_gemm_bwd {label} (device)'] = device_ms(
                        lambda: dsa_tables.table_gemm_bwd(x, w, g), 20)
        for label, rows, m, n, _ in OUTER_SUMS:
            X = torch.randn((rows, m), generator=gen, device='cuda')
            Y = torch.randn((rows, n), generator=gen, device='cuda')
            res, work = torch.empty((m, n), device='cuda'), outer_sum_work(X, Y)
            out[f'outer_sum {label}'] = cuda_ms(
                lambda: run_outer_sum(X, Y, res, work), 10)
    print(json.dumps({'ab': out}))
    return out


# --------------------------------------------------------------------------
# 4. serve
# --------------------------------------------------------------------------

# (frames, duration s, with sound): lengths that are all resized to T=200
REQUESTS = ((150, 37.5, True), (200, 120.0, False), (333, 240.0, True),
            (80, 12.0, False))


def check_events(events, duration):
    assert events, 'no events'
    for e in events:
        t0, t1 = e['timestamp']
        assert 0.0 <= t0 <= t1 <= duration * (1 + 1e-6), e['timestamp']
        assert isinstance(e['sentence'], str), e
        for k in ('proposal_score', 'sentence_score'):
            assert e[k] == e[k] and abs(e[k]) != float('inf'), e
    assert [e['timestamp'] for e in events] == sorted(
        e['timestamp'] for e in events)


def make_captioner(opt, tmp):
    """The port's DenseCaptioner over seeded random weights and a
    synthetic vocabulary of the config's size."""
    from dvc_tpu_torch.models import make_fusion_model
    from dvc_tpu_torch.serve import DenseCaptioner
    words = [f'word{i}' for i in range(1, opt.vocab_size + 1)]
    vocab = os.path.join(tmp, 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'word_to_ix': {w: i for i, w in enumerate(words, 1)},
                   'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}},
                  f)
    state_dict = make_fusion_model(opt, 'cpu', seed=0).state_dict()
    return DenseCaptioner(opt=opt, state_dict=state_dict, dict_file=vocab,
                          device='cuda')


def trace(label, fn):
    """``fn()`` under ``torch.profiler`` (:func:`traced`)."""
    with traced(label) as result:
        fn()
    return result


@contextlib.contextmanager
def traced(label):
    """The body under ``torch.profiler``: the device time of each kernel as
    a share of the body's host-clock window, and the share of that window
    in which no kernel or copy ran on the card.  Yields a dict that gets
    ``window_ms``, ``busy_ms`` and ``idle`` (empty when the profiler saw
    no device activity)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    result = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            yield result
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e.time_range for e in events if e.name == label
               and e.device_type == DeviceType.CPU)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != label)
    window = win.end - win.start
    if not spans:
        print('[trace] the profiler recorded no device activity: kernel '
              'shares and idle share not measured')
        return
    busy, covered, per_name, count = 0.0, win.start, {}, {}
    for t0, t1, name in spans:     # union of the spans inside the window
        busy += max(min(t1, win.end) - max(t0, covered), 0.0)
        covered = max(covered, min(t1, win.end))
        per_name[name] = per_name.get(name, 0.0) + (t1 - t0)
        count[name] = count.get(name, 0) + 1
    result.update(window_ms=window / 1e3, busy_ms=busy / 1e3,
                  idle=1 - busy / window, activities=len(spans))
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    print(f'[trace] {label} under the profiler: window {window / 1e3:.3f} '
          f'ms, device busy {busy / 1e3:.3f} ms, idle share '
          f'{1 - busy / window:.4f}, {len(spans)} device activities')
    for name, us in top:
        print(f'[trace]   {us / 1e3:9.3f} ms  {us / window:.4f} of window  '
              f'{name[:90]}')
    k5 = sum(us for n, us in per_name.items() if 'scan_bwd_kernel' in n)
    if k5:
        print(f'[trace]   {k5 / 1e3:9.3f} ms  {k5 / window:.4f} of window  K5 '
              f'(scan_bwd_kernel; its GEMMs below), {k5 / busy:.4f} of the '
              f'device time')
    gemm = {n: us for n, us in per_name.items()
            if 'gemm_kernel' in n or 'gemm16_kernel' in n
            or 'split_sum_kernel' in n or 'round_bf16_kernel' in n}
    if gemm:
        outer = sum(us for n, us in gemm.items() if 'true, true>' in n)
        print(f'[trace]   {sum(gemm.values()) / 1e3:9.3f} ms  dsa::gemm in all '
              f'(tables, G . Wc^T, outer sums, split sums); the outer sums\' '
              f'kernels (both operands along the terms) {outer / 1e3:.3f} ms')
    solve = sum(us for n, us in per_name.items() if 'assignment_kernel' in n)
    if solve:
        print(f'[trace]   {solve / 1e3:9.3f} ms  {solve / window:.4f} of window  '
              f'the assignment solver (assignment_kernel)')
    msda = {d: [(us, count[n]) for n, us in per_name.items()
                if f'msda_{d}_kernel' in n] for d in ('fwd', 'bwd')}
    us = {d: sum(u for u, _ in v) for d, v in msda.items()}
    n = {d: sum(c for _, c in v) for d, v in msda.items()}
    print(f'[trace]   {(us["fwd"] + us["bwd"]) / 1e3:9.3f} ms  msda in all: '
          f'forward (K1/K2) {us["fwd"] / 1e3:.3f} ms in {n["fwd"]} launches, '
          f'backward (K3) {us["bwd"] / 1e3:.3f} ms in {n["bwd"]} launches')


def phase_serve(dc):
    import numpy as np
    import torch
    opt = dc.opt
    rng = np.random.default_rng(0)
    C = opt.feature_dim
    feats = [rng.standard_normal((n, C)).astype(np.float32)
             for n, _, _ in REQUESTS]
    sounds = [rng.standard_normal((n, C)).astype(np.float32) if s else None
              for n, _, s in REQUESTS]
    batch16 = [rng.standard_normal((int(n), C)).astype(np.float32)
               for n in rng.integers(60, 400, 16)]
    durs16 = [float(d) for d in rng.uniform(10, 300, 16)]

    reset_counts()
    for (n, dur, _), f, s in zip(REQUESTS, feats, sounds):
        t0 = time.perf_counter()
        events = dc.caption_features(f, dur, sound=s)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        check_events(events, dur)
        print(f'[serve] request frames={n} duration={dur} sound={s is not None}'
              f': {len(events)} events in {ms:.1f} ms; first '
              f'{events[0]["timestamp"]} "{events[0]["sentence"][:48]}..."')
    dc.caption_batch(batch16, durs16)                     # warm-up
    reps = 3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        results = dc.caption_batch(batch16, durs16)
    torch.cuda.synchronize()
    sec = (time.perf_counter() - t0) / reps
    for events, dur in zip(results, durs16):
        check_events(events, dur)
    print(f'[serve] B=16 caption_batch: {sec * 1e3:.1f} ms per batch, '
          f'{16 / sec:.2f} videos/s (host clock, postprocess included)')
    trace('B=16 caption_batch', lambda: dc.caption_batch(batch16, durs16))
    launches, plain = read_counts()
    print(f'[serve] kernel launches {launches}, plain-version calls {plain}')
    if (min(launches['msda_fwd'], launches['dsa_greedy']) < 1 or plain
            or any(launches[k] for k in STEP_KERNELS)):
        raise AssertionError(f'serve path did not run on the kernels: '
                             f'launches {launches}, plain calls {plain}')
    return launches


# --------------------------------------------------------------------------
# 5. agreement with the plain path
# --------------------------------------------------------------------------

def phase_agreement(dc):
    """The served model on the card (kernels) against the same weights on
    the CPU (plain versions) for one request: trunk outputs within 1e-3
    (f32 on both, summation orders differ), and at least 90% of the
    captions identical token for token (a near-tie in a random-weight
    vocabulary projection may flip one greedy choice, after which that
    caption is decoded from another token)."""
    import numpy as np
    import torch
    from dvc_tpu_torch.models import make_fusion_model
    rng = np.random.default_rng(1)
    f = rng.standard_normal((170, dc.opt.feature_dim)).astype(np.float32)
    s = rng.standard_normal((170, dc.opt.feature_dim)).astype(np.float32)
    batch = dc._make_batch([f], [95.0], [s])
    cpu = make_fusion_model(dc.opt, 'cpu', seed=0)
    with torch.inference_mode():
        got = {k: v.cpu() for k, v in dc.model(batch).items()}
        want = cpu({k: v.cpu() for k, v in batch.items()})
    errs = {k: float((got[k] - want[k]).abs().max())
            for k in ('pred_logits', 'pred_count', 'pred_boxes')}
    same = (got['seq'] == want['seq']).all(-1)
    rows = float(same.float().mean())
    lp_err = (float((got['cap_prob_eval'] - want['cap_prob_eval'])
                    .abs()[same].max()) if same.any() else float('inf'))
    print(f'[agreement] card vs CPU plain: max abs diff {errs}; captions '
          f'identical {rows:.3f}; cap_prob_eval max abs diff on those '
          f'{lp_err:.2e}')
    if max(errs.values()) > 1e-3 or rows < 0.9 or lp_err > 1e-3:
        raise AssertionError('card and CPU disagree')


# --------------------------------------------------------------------------
# 6. train
# --------------------------------------------------------------------------

TRAIN_VIDEOS = 16
VAL_VIDEOS = 16


def letter_words(n):
    """n distinct words of letters only ('wa', 'wb', ..., 'wz', 'waa',
    ...): the paragraph metric keeps only letters (``para_eval.parse_sent``),
    so words that differ in digits would all become one word there."""
    def word(i):
        out = ''
        while i:
            i, r = divmod(i - 1, 26)
            out = chr(ord('a') + r) + out
        return 'w' + out
    return [word(i) for i in range(1, n + 1)]


def write_synthetic_run(root, opt, n_videos=TRAIN_VIDEOS, seed=0):
    """A YouCook2-shaped training set at the recipe's widths, and a
    held-out val set of VAL_VIDEOS videos from the same generator (another
    seed) with its paragraph ground truth.  Returns the recipe file that
    inherits the model from CFG and points at this data."""
    feat_dir = os.path.join(root, 'features')
    sound_dir = os.path.join(root, 'sound')
    os.makedirs(feat_dir)
    os.makedirs(sound_dir)
    words = letter_words(opt.vocab_size)
    vocab = os.path.join(root, 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'word_to_ix': {w: i for i, w in enumerate(words, 1)},
                   'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}},
                  f)
    paths = {}
    for name, prefix, n, s in (('train', 'v_smoke', n_videos, seed),
                               ('val', 'v_valid', VAL_VIDEOS, seed + 1)):
        anno = write_videos(root, prefix, n, s, opt.feature_dim, words)
        paths[name] = os.path.join(root, f'{name}.json')
        with open(paths[name], 'w') as f:
            json.dump(anno, f)
    paths['para'] = os.path.join(root, 'para_val.json')
    with open(paths['para'], 'w') as f:
        json.dump({k: ' '.join(v['sentences']) for k, v in anno.items()}, f)
    recipe = os.path.join(root, 'smoke.yml')
    with open(recipe, 'w') as f:
        json.dump({'base_cfg_path': CFG, 'id': 'smoke',
                   'save_dir': os.path.join(root, 'save'),
                   'train_caption_file': paths['train'],
                   'val_caption_file': paths['val'],
                   'gt_file_for_eval': [paths['val']],
                   'gt_file_for_para_eval': [paths['para']],
                   'dict_file': vocab,
                   'visual_feature_folder': [feat_dir],
                   'invalid_video_json': [],
                   'sound_feature_folder': sound_dir, 'epoch': 1}, f)
    return recipe


def write_videos(root, prefix, n_videos, seed, feature_dim, words,
                 features=None, sound=True):
    """n_videos YouCook2-shaped videos keyed ``prefix`` + 6 digits: clip
    features (feature_dim wide, 150-400 clips) in root/features, or, with
    ``features`` [(path of a key, width)], one file of each; with
    ``sound``, cached sound features for every other video in root/sound
    (the rest fall back to zeros); and 3-40 captioned events per video
    (captions of 3-27 words, so after BOS/EOS at most 29 word steps).
    Returns their annotations."""
    import numpy as np
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, 'features')
    sound_dir = os.path.join(root, 'sound')
    features = features or [
        (lambda key: os.path.join(feat_dir, key[:13] + '.npy'), feature_dim)]
    anno = {}
    for v in range(n_videos):
        key = f'{prefix}{v:06d}'
        n_clips = int(rng.integers(150, 400))
        duration = float(rng.uniform(60, 600))
        for path, width in features:
            np.save(path(key), rng.standard_normal((n_clips, width))
                    .astype(np.float32))
        if sound and v % 2 == 0:
            np.save(os.path.join(sound_dir, key[:13] + '.npy'),
                    rng.standard_normal((n_clips, feature_dim))
                    .astype(np.float32))
        n_events = int(rng.integers(3, 41))
        starts = np.sort(rng.uniform(0, 0.9, n_events)) * duration
        ends = np.minimum(starts + rng.uniform(0.02, 0.2, n_events) * duration,
                          duration)
        anno[key] = {
            'duration': duration,
            'timestamps': [[float(a), float(b)] for a, b in zip(starts, ends)],
            'sentences': [' '.join(rng.choice(words, int(rng.integers(3, 28))))
                          for _ in range(n_events)]}
    return anno


def _counted():
    """(kernel wrappers by name, plain versions) of every counted kernel."""
    from dvc_tpu_torch import ops
    from dvc_tpu_torch.ops import dsa_step, dsa_tables
    kernels = {'msda_fwd': ops.ms_deform_attn,
               'msda_bwd': ops.ms_deform_attn_bwd,
               'dsa_scan_fwd': ops.dsa_teacher_scan_fwd,
               'dsa_scan_bwd': ops.dsa_teacher_scan_bwd,
               'dsa_greedy': ops.dsa_greedy_scan,
               'dsa_step_fwd': ops.dsa_sample_attend_fwd,
               'dsa_step_bwd': ops.dsa_sample_attend_bwd,
               'dsa_lstm_fwd': ops.dsa_lstm_step_fwd,
               'dsa_lstm_bwd': ops.dsa_lstm_step_bwd,
               'table_gemm': dsa_tables.table_gemm,
               'table_gemm_bwd': dsa_tables.table_gemm_bwd,
               'assignment': ops.assignment}
    plain = (ops.ms_deform_attn_ref, ops.linear_sum_assignment_ref, ops.dsa_teacher_scan_ref,
             ops.dsa_greedy_scan_ref, ops.sample_attend_ref,
             dsa_step.sample_attend_table_ref, ops.lstm_step_ref,
             dsa_step.lstm_step_table_ref, dsa_tables.table_gemm_ref,
             dsa_tables.table_gemm_bwd_ref)
    return kernels, plain


# the kernels with a bf16-operand variant (K4-bf16 to K10-bf16 and the
# table's): each wrapper counts those launches apart, read here as
# '<kernel>_bf16'
BF16_VARIANTS = ('dsa_scan_fwd', 'dsa_scan_bwd', 'dsa_greedy') + STEP_KERNELS


def reset_counts():
    """Sets every kernel's launch count (the bf16 variants' included),
    every plain version's call count and the matcher's device-to-host copy
    count to 0."""
    from dvc_tpu_torch.models.matcher import hungarian_match
    kernels, plain = _counted()
    for fn in kernels.values():
        fn.launches = 0
    for k in BF16_VARIANTS:
        kernels[k].launches_bf16 = 0
    for fn in plain:
        fn.calls = 0
    hungarian_match.copies = 0


def matcher_copies():
    """The matcher's device-to-host copies since reset_counts() (none
    since the solver runs on the device; gated at 0)."""
    from dvc_tpu_torch.models.matcher import hungarian_match
    return hungarian_match.copies


def read_counts():
    """({kernel: launches}, plain-version calls) since reset_counts(); the
    bf16 variants as '<kernel>_bf16'."""
    kernels, plain = _counted()
    launches = {k: fn.launches for k, fn in kernels.items()}
    launches.update({f'{k}_bf16': kernels[k].launches_bf16
                     for k in BF16_VARIANTS})
    return launches, sum(fn.calls for fn in plain)


def train_batch(opt, B, plain=False):
    """One collated batch of the first B synthetic videos, for FusionPDVC
    or (``plain``) for a plain PDVC."""
    from dvc_tpu_torch.data import (DenseCaptionDataset, FusionDataset,
                                    collate, fusion_collate)
    ds = (DenseCaptionDataset if plain else FusionDataset)(
        opt.train_caption_file, opt.visual_feature_folder, opt.dict_file,
        opt, seed=opt.seed)
    batch, _ = (collate if plain else fusion_collate)(
        [ds[i % len(ds)] for i in range(B)], opt.frame_embedding_num,
        opt.gt_proposal_sample_num, opt.max_caption_len)
    return batch


def time_steps(trainer, batch, lr, reps, ss_prob=0.0):
    """Host-clock ms of one train step (after one warm-up step), and the
    last step's losses."""
    import torch
    trainer.train_step(batch, lr, ss_prob)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        losses = trainer.train_step(batch, lr, ss_prob)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, losses


EVAL_SCORES = ('METEOR', 'soda_c', 'para_METEOR', 'Recall', 'Precision')


def check_validation(folder, epochs):
    """The validation that new_train ran after each epoch: epoch{N}.json
    with finite METEOR and soda_c, its scores in info.json's val_history,
    and model-best.pth."""
    import math
    with open(os.path.join(folder, 'info.json')) as f:
        info = json.load(f)
    for epoch in epochs:
        with open(os.path.join(folder, f'epoch{epoch}.json')) as f:
            scores = json.load(f)
        if not all(math.isfinite(scores[k]) for k in ('METEOR', 'soda_c')) \
                or str(epoch) not in info['val_history']:
            raise AssertionError(f'validation of epoch {epoch}: {info}')
    if not os.path.exists(os.path.join(folder, 'model-best.pth')):
        raise AssertionError(f'no model-best.pth in {folder}')
    history = info['val_history'][str(epochs[-1])]
    return ', '.join(f'{k} {history[k]:.4f}' for k in EVAL_SCORES)


def phase_train(tmp):
    """The port's training driver (``dvc_tpu_torch.new_train.main``) for
    one --debug epoch (5 steps at B=1) of the full-width recipe on the
    synthetic run, which validates after it (6 val videos at B=1, K1/K2
    and K6), with the launch counts set to 0 just before and read just
    after; then its best checkpoint served on the card, a repeated-batch
    check, and the step's time at B=1 and B=16."""
    import math
    import numpy as np
    import torch
    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.serve import DenseCaptioner
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    recipe = write_synthetic_run(tmp, load_config(CFG, root=ROOT))
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', DEVICE],
                     root=ROOT)
    reset_counts()
    t0 = time.perf_counter()
    folder, losses = train_main(opt)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    copies = matcher_copies()
    print(f'[train] new_train.main --debug, B=1: {seconds:.1f} s (setup, '
          f'5 steps, validation, checkpoints); mean losses {json.dumps({k: round(v, 4) for k, v in losses.items()})}')
    print(f'[train] kernel launches {launches}, plain-version calls {plain}, '
          f'matcher device-to-host copies {copies} (5 steps, 6 val batches)')
    one_solve = launches['assignment'] == 5 + 6
    bad = [k for k, v in losses.items() if not math.isfinite(v)]
    if bad or 'loss_caption' not in losses:
        raise AssertionError(f'train losses not finite: {bad}')
    if copies or not one_solve:
        raise AssertionError(f'{copies} matcher copies, {launches["assignment"]}'
                             f' assignment launches: not 0 and one a step')
    if (min(launches[k] for k in ('msda_fwd', 'msda_bwd', 'dsa_scan_fwd',
                                  'dsa_scan_bwd', 'dsa_greedy')) < 1 or plain
            or any(launches[k] for k in STEP_KERNELS)):
        raise AssertionError(f'train path did not run on the kernels: '
                             f'launches {launches}, plain calls {plain}')
    print(f'[train] validation of epoch 1: {check_validation(folder, [1])}')

    dc = DenseCaptioner(folder, device=DEVICE)             # which='best'

    rng = np.random.default_rng(3)
    events = dc.caption_features(
        rng.standard_normal((240, opt.feature_dim)).astype(np.float32), 150.0,
        sound=rng.standard_normal((240, opt.feature_dim)).astype(np.float32))
    check_events(events, 150.0)
    print(f'[train] the best checkpoint served one request on the card: '
          f'{len(events)} events, first {events[0]["timestamp"]}')

    # the total falls on a repeated batch (dropout on, as in training)
    trainer = Trainer(opt, device=DEVICE)
    batch = train_batch(opt, 1)
    totals = [float(trainer.train_step(batch, opt.lr)['total_loss'])
              for _ in range(10)]
    print(f'[train] repeated B=1 batch, 10 steps at lr {opt.lr}: total loss '
          f'{[round(t, 4) for t in totals]}')
    if not (all(map(math.isfinite, totals))
            and np.mean(totals[-3:]) < np.mean(totals[:3])):
        raise AssertionError(f'the total loss did not fall: {totals}')

    ms1, _ = time_steps(trainer, batch, opt.lr, 5)
    batch16 = train_batch(opt, 16)
    ms16, losses16 = time_steps(trainer, batch16, opt.lr, 3)
    if not all(math.isfinite(float(v)) for v in losses16.values()):
        raise AssertionError('B=16 train losses not finite')
    print(f'[train] train step (host clock, after a warm-up): B=1 '
          f'{ms1:.1f} ms, {1e3 / ms1:.2f} videos/s; B=16 {ms16:.1f} ms, '
          f'{16e3 / ms16:.2f} videos/s; peak device memory '
          f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    # synchronized inside the window: with the matcher on the card the host
    # returns before the backward has run
    trace('B=16 train_step', lambda: (trainer.train_step(batch16, opt.lr),
                                      torch.cuda.synchronize()))
    return launches, opt, folder


# --------------------------------------------------------------------------
# 7. train agreement
# --------------------------------------------------------------------------

MATCH_TIE_TOL = 1e-4      # a pinned matching's cost over the card's own,
                          # relative, in each (layer, video)


def phase_train_agreement(opt, label='train-agreement', plain=False):
    """One train step's forward and backward on the card (kernels) against
    the CPU plain path, same weights and batch, dropout off, the card's
    step taking the CPU step's matching of every layer: every loss within
    1e-4 relative (f32 on both, summation orders differ); every
    parameter's gradient within a relative L2 error of 1e-3 + 1e-5
    absolute (atomics and summation order), except alpha_net's bias, whose
    gradient is zero in exact arithmetic (as in ``check_scan``) and whose
    floor is 5e-5.  The card's own matching is computed too: where it
    differs from the CPU's it must be a near-tie, the CPU's matching
    costing at most MATCH_TIE_TOL relative more than the card's own under
    the card's cost matrices (a few ulps of the trunk flip such ties,
    ROADMAP C: an aux layer's at the plain recipe's G = 30, and since the
    matcher runs JAX's f32 solver the flagship's too); whether it is
    identical is printed.  ``plain``: a plain PDVC (``run_train``'s model)
    in place of the FusionPDVC."""
    import torch
    from dvc_tpu_torch.models import criterion, make_fusion_model, \
        make_pdvc_model
    from dvc_tpu_torch.models.criterion import build_weight_dict
    from dvc_tpu_torch.train import bucket_caption_length
    batch = bucket_caption_length(train_batch(opt, 1, plain))
    weights = build_weight_dict(opt)
    make = make_pdvc_model if plain else make_fusion_model
    real, pinned, own, excess = criterion.hungarian_match, [], [], []

    def record(*args):
        pinned.append(real(*args))
        return pinned[-1]

    def replay(*args):
        mine = real(*args)
        own.append(mine.cpu())
        taken = pinned[len(own) - 1].to(mine.device)
        with torch.no_grad():
            cost_own, cost_taken = (matching_cost(*args, m)
                                    for m in (mine, taken))
        excess.append(float(((cost_taken - cost_own)
                             / cost_own.abs().clamp(min=1e-12)).max()))
        return taken

    results = {}
    for run, dev in (('cpu', 'cpu'), ('card', DEVICE)):
        model = make(opt, dev, seed=0).train()
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        criterion.hungarian_match = record if run == 'cpu' else replay
        try:
            out, losses = model.forward_train(tb)
        finally:
            criterion.hungarian_match = real
        sum(losses[k] * w for k, w in weights.items()
            if k in losses and w).backward()
        results[run] = (out['matched_indices'].cpu(),
                        {k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters() if p.grad is not None})
    (gi, gl, gg), (ci, cl, cg) = results['card'], results['cpu']
    loss_err = max(abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-6) for k in cl)
    floor = {n: (5e-5 if n.endswith('alpha_net.bias') else 1e-5) for n in cg}
    grad_err = {n: float((gg[n] - cg[n]).norm()
                         / (cg[n].norm() + floor[n] / 1e-3)) for n in cg}
    ranked = sorted(grad_err, key=grad_err.get, reverse=True)
    worst = ranked[0]
    same = bool((gi == ci).all())
    agree = all(torch.equal(a, b.cpu()) for a, b in zip(own, pinned))
    print(f'[{label}] the card ran the CPU\'s matching; its own, every '
          f'layer: identical {agree}, the CPU\'s costing at most '
          f'{max(excess):.2e} relative more under the card\'s costs (gated '
          f'at {MATCH_TIE_TOL})')
    print(f'[{label}] card vs CPU plain, one B=1 step: matching '
          f'identical {same}; worst loss relative error {loss_err:.2e}; '
          f'worst gradient relative L2 errors over {len(cg)} parameters: '
          + ', '.join(f'{n} {grad_err[n]:.2e} (|grad| '
                      f'{float(cg[n].norm()):.2e})' for n in ranked[:3]))
    if not same or loss_err > 1e-4 or grad_err[worst] > 1e-3 \
            or sorted(gg) != sorted(cg) or max(excess) > MATCH_TIE_TOL:
        raise AssertionError('card and CPU disagree on the train step')


# --------------------------------------------------------------------------
# 8. the stepwise caption path
# --------------------------------------------------------------------------

SS_PROB = 0.25
STEPWISE = {False: ('dsa_step_fwd', 'dsa_step_bwd'),
            True: ('dsa_lstm_fwd', 'dsa_lstm_bwd')}


def stepwise_opt(tmp, lstm_fuse):
    """The synthetic run's recipe for two --debug epochs with scheduled
    sampling from epoch 1 (ss_prob 0 in epoch 0, SS_PROB in epoch 1)."""
    from dvc_tpu_torch.utils.config import parse_opts
    opt = parse_opts(['--cfg_path', os.path.join(tmp, 'smoke.yml'), '--debug',
                      '--device', DEVICE, '--epoch', '2',
                      '--scheduled_sampling_start', '0',
                      '--basic_ss_prob', str(SS_PROB),
                      '--dsa_lstm_fuse', str(int(lstm_fuse))], root=ROOT)
    opt.epoch = 2                 # the recipe file's epoch (1) overlays it
    return opt


def word_steps(batch):
    """The word steps of one train step on ``batch`` (after the trainer's
    caption-length bucketing)."""
    from dvc_tpu_torch.train import bucket_caption_length
    return bucket_caption_length(batch)['cap_tensor'].shape[-1] - 1


def phase_stepwise_train(tmp):
    """``new_train.main`` for two --debug epochs (5 steps each at B=1) with
    scheduled sampling from epoch 1, once with each word-step kernel pair
    (--dsa_lstm_fuse 0: K7/K8, 1: K9/K10), with the counts set to 0 just
    before each run and read just after: epoch 0 runs the fused scan (one
    K4 and one K5 launch per step), epoch 1 the stepwise path; then one
    step checked for one launch of each kernel of the pair per word step,
    and the step timed at B=1 and B=16 at ss_prob SS_PROB, and one B=16
    step traced.  Returns
    ({pair: launches}, the lstm-fuse run's folder)."""
    import math
    import torch
    from dvc_tpu_torch.models.caption_heads import DSACaptionHead
    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.train import Trainer, ss_prob_for_epoch
    out, folder = {}, None
    for lstm_fuse in (False, True):
        fwd, bwd = STEPWISE[lstm_fuse]
        opt = stepwise_opt(tmp, lstm_fuse)
        assert [ss_prob_for_epoch(opt, e) for e in (0, 1)] == [0.0, SS_PROB]
        reset_counts()
        DSACaptionHead.fed_samples.clear()
        t0 = time.perf_counter()
        folder, losses = train_main(opt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        fed = DSACaptionHead.fed_sample_count()
        other = STEPWISE[not lstm_fuse]
        print(f'[stepwise] new_train.main --debug --epoch 2 '
              f'--scheduled_sampling_start 0 --basic_ss_prob {SS_PROB} '
              f'--dsa_lstm_fuse {int(lstm_fuse)}, B=1: {seconds:.1f} s; '
              f'epoch 1 mean losses '
              f'{json.dumps({k: round(v, 4) for k, v in losses.items()})}')
        print(f'[stepwise] kernel launches {launches}, plain-version calls '
              f'{plain}, scheduled-sampling tokens fed {fed}')
        bad = [k for k, v in losses.items() if not math.isfinite(v)]
        # one table VW and one table backward per stepwise train step
        # (epoch 1's 5) under either flag
        tables = 5
        if (bad or plain or fed < 1
                or launches['dsa_scan_fwd'] != 5
                or launches['dsa_scan_bwd'] != 5
                or launches[fwd] < 5 or launches[fwd] != launches[bwd]
                or launches[other[0]] or launches[other[1]]
                or launches['table_gemm'] != tables
                or launches['table_gemm_bwd'] != tables
                or min(launches['msda_fwd'], launches['msda_bwd']) < 1):
            raise AssertionError(f'stepwise train path: losses {losses}, '
                                 f'launches {launches}, plain {plain}, fed '
                                 f'{fed}')
        out[lstm_fuse] = launches
        print(f'[stepwise] validation of epochs 1 and 2 (fused greedy '
              f'decode): {check_validation(folder, [1, 2])}')

        trainer = Trainer(opt, device=DEVICE)
        batch = train_batch(opt, 1)
        reset_counts()
        trainer.train_step(batch, opt.lr, SS_PROB)
        launches, plain = read_counts()
        K = word_steps(batch)
        print(f'[stepwise] one B=1 step at ss_prob {SS_PROB}: {K} word '
              f'steps, {fwd} {launches[fwd]} and {bwd} {launches[bwd]} '
              f'launches, table_gemm {launches["table_gemm"]} and '
              f'table_gemm_bwd {launches["table_gemm_bwd"]}, plain-version '
              f'calls {plain}')
        if (launches[fwd] != K or launches[bwd] != K or plain
                or launches['table_gemm'] != 1
                or launches['table_gemm_bwd'] != 1):
            raise AssertionError(f'stepwise step: {launches}, K={K}')
        ms1, _ = time_steps(trainer, batch, opt.lr, 3, SS_PROB)
        batch16 = train_batch(opt, 16)
        ms16, losses16 = time_steps(trainer, batch16, opt.lr, 2, SS_PROB)
        if not all(math.isfinite(float(v)) for v in losses16.values()):
            raise AssertionError('B=16 stepwise train losses not finite')
        print(f'[stepwise] train step at ss_prob {SS_PROB} through '
              f'{fwd}/{bwd} (host clock, after a warm-up): B=1 {ms1:.1f} ms '
              f'({word_steps(batch)} word steps); B=16 {ms16:.1f} ms '
              f'({word_steps(batch16)} word steps); peak device memory '
              f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        trace(f'B=16 stepwise train_step ({fwd}/{bwd})',
              lambda: trainer.train_step(batch16, opt.lr, SS_PROB))
        del trainer
    return out, folder


def phase_stepwise_serve(folder):
    """The lstm-fuse run's checkpoint served with --dsa_greedy_fuse 0 on a
    B=16 batch, through K7 (--dsa_lstm_fuse 0) and through K9 (1), against
    the fused greedy kernel on the same weights: the raw outputs' captions
    must be identical token for token on at least 90% of the queries (the
    rule of ``phase_agreement``), every launch of the stepwise kernel one
    per decode step, no plain version; each path's caption_batch timed."""
    import numpy as np
    import torch
    from dvc_tpu_torch.serve import DenseCaptioner
    from dvc_tpu_torch.utils.config import Config
    fused = DenseCaptioner(folder, which='last', device=DEVICE)
    C, K = fused.opt.feature_dim, fused.opt.max_caption_len
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((int(n), C)).astype(np.float32)
             for n in rng.integers(60, 400, 16)]
    durs = [float(d) for d in rng.uniform(10, 300, 16)]
    batch = fused._make_batch(feats, durs)

    def timed(dc):
        dc.caption_batch(feats, durs)                     # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dc.caption_batch(feats, durs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    with torch.inference_mode():
        want = fused.model(batch)
    fused_ms = timed(fused)
    print(f'[stepwise-serve] fused greedy kernel, B=16 caption_batch: '
          f'{fused_ms:.1f} ms')
    for lstm_fuse in (False, True):
        fwd = STEPWISE[lstm_fuse][0]
        opt = Config({**fused.opt.to_dict(), 'dsa_greedy_fuse': 0,
                      'dsa_lstm_fuse': int(lstm_fuse)})
        dc = DenseCaptioner(opt=opt, state_dict=fused.model.state_dict(),
                            device=DEVICE)
        reset_counts()
        with torch.inference_mode():
            got = dc.model(batch)
        torch.cuda.synchronize()
        launches, plain = read_counts()
        same = (got['seq'] == want['seq']).all(-1)
        rows = float(same.float().mean())
        lp_err = (float((got['cap_prob_eval'] - want['cap_prob_eval'])
                        .abs()[same].max()) if same.any() else float('inf'))
        ms = timed(dc)
        print(f'[stepwise-serve] --dsa_greedy_fuse 0 --dsa_lstm_fuse '
              f'{int(lstm_fuse)}: {fwd} launches {launches[fwd]}, table_gemm '
              f'{launches["table_gemm"]}, greedy kernel '
              f'{launches["dsa_greedy"]}, plain-version calls {plain}; '
              f'captions identical to the fused kernel\'s {rows:.3f}, '
              f'cap_prob_eval max abs diff on those {lp_err:.2e}; B=16 '
              f'caption_batch {ms:.1f} ms')
        if (launches[fwd] != K or launches['dsa_greedy'] or plain
                or launches['table_gemm'] != 1
                or rows < 0.9 or lp_err > 1e-3):
            raise AssertionError('stepwise serving disagrees with the fused '
                                 'greedy decode')


def phase_stepwise_agreement(opt):
    """``phase_train_agreement`` with --dsa_scan_fuse 0 (ss_prob 0), so the
    caption head runs the stepwise path: K7/K8 and then K9/K10 on the card
    against the plain word step on the CPU."""
    from dvc_tpu_torch.utils.config import Config
    for lstm_fuse in (0, 1):
        phase_train_agreement(
            Config({**opt.to_dict(), 'dsa_scan_fuse': 0,
                    'dsa_lstm_fuse': lstm_fuse}),
            label=f'stepwise-agreement lstm_fuse={lstm_fuse}')


# --------------------------------------------------------------------------
# 9. eval: run_eval on the card
# --------------------------------------------------------------------------

def check_eval_json(path, n_videos, scored):
    """eval_results.json / dvc_results.json: every record's timestamp in
    [0, duration], sentences strings, n_videos videos; finite scores where
    the metrics ran, none where they did not."""
    import math
    with open(path) as f:
        out = json.load(f)
    bad = [e for events in out['results'].values() for e in events
           if not (0.0 <= e['timestamp'][0] <= e['timestamp'][1]
                   <= e['vid_duration'] * (1 + 1e-6))
           or not isinstance(e['sentence'], str)]
    if out['valid_video_num'] != n_videos or bad:
        raise AssertionError(f'{path}: {out["valid_video_num"]} videos, '
                             f'bad records {bad[:3]}')
    if scored != all(k in out for k in EVAL_SCORES) or (
            scored and not all(math.isfinite(out[k]) for k in EVAL_SCORES)):
        raise AssertionError(f'{path}: scores {[out.get(k) for k in EVAL_SCORES]}')
    return out


class CallTimer:
    """Patches named functions (module or class attributes) to add up the
    host-clock seconds and calls of each while active; with ``sync`` a
    function's time is taken between two ``torch.cuda.synchronize``."""

    def __init__(self, targets):
        self.targets = targets          # label: (owner, name, sync)
        self.seconds = {k: 0.0 for k in targets}
        self.calls = {k: 0 for k in targets}

    def __enter__(self):
        import torch
        self.saved = {}
        for label, (owner, name, sync) in self.targets.items():
            fn = getattr(owner, name)
            self.saved[label] = fn

            def timed(*a, _fn=fn, _label=label, _sync=sync, **k):
                if _sync and DEVICE != 'cpu':
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                if _sync and DEVICE != 'cpu':
                    torch.cuda.synchronize()
                self.seconds[_label] += time.perf_counter() - t0
                self.calls[_label] += 1
                return out
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for label, (owner, name, _) in self.targets.items():
            setattr(owner, name, self.saved[label])


def eval_timer():
    from dvc_tpu_torch.eval import eval_utils
    from dvc_tpu_torch.models import criterion
    from dvc_tpu_torch.train import Trainer
    return CallTimer({
        'eval_step': (Trainer, 'eval_step', True),
        'matcher': (criterion, 'hungarian_match', False),
        'postprocess': (eval_utils, 'postprocess', True),
        'to_dvc_records': (eval_utils, 'to_dvc_records', False),
        'rerank': (eval_utils, 'reranking', False),
        'dvc': (eval_utils, 'eval_dvc', False),
        'soda': (eval_utils, 'eval_soda', False),
        'para': (eval_utils, 'eval_para', False)})


def run_eval_counted(args, timer=None):
    """``run_eval.main(args)`` with the launch counts set to 0 just before
    and read just after: (json path, scores, launches, plain calls,
    seconds)."""
    import contextlib
    import torch
    from dvc_tpu_torch import run_eval
    reset_counts()
    t0 = time.perf_counter()
    with timer or contextlib.nullcontext():
        path, scores = run_eval.main(args)
    if DEVICE != 'cpu':
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    return path, scores, launches, plain, seconds


def phase_eval(tmp, folder, card):
    """``dvc_tpu_torch.run_eval`` on phase 6's run folder (its best
    checkpoint) over the VAL_VIDEOS synthetic val videos on the card, at
    --eval_batch_size 16 and 1, each timed by part, with the launch counts set
    to 0 before each run and read after: a K1/K2 launch per trunk layer (6)
    and one K6 launch a batch, no word-step kernel, no plain version; well-formed
    eval_results.json with finite scores; --eval_mode test writes
    dvc_results.json without them; one B=16 eval step traced; then two val
    videos evaluated on the CPU (plain versions) and on the card, their
    records held to phase 5's gates.  Returns the B=16 run's launches."""
    import torch
    from dvc_tpu_torch.serve import run_options
    ropt = run_options(folder)
    layers = ropt.enc_layers + ropt.dec_layers       # K1/K2 a forward
    out = {}
    for bs in (16, 1):
        timer = eval_timer()
        path, scores, launches, plain, seconds = run_eval_counted(
            ['--eval_save_dir', folder, '--eval_batch_size', str(bs),
             '--eval_device', DEVICE], timer)
        copies = matcher_copies()
        batches = -(-VAL_VIDEOS // bs)
        check_eval_json(path, VAL_VIDEOS, scored=True)
        print(f'[eval] run_eval --eval_batch_size {bs}: {seconds:.2f} s; '
              f'{", ".join(f"{k} {scores[k]:.4f}" for k in EVAL_SCORES)}; '
              f'kernel launches {launches}, plain-version calls {plain}, '
              f'matcher device-to-host copies {copies} in {batches} batches')
        if (launches['msda_fwd'] < layers * batches
                or copies or timer.calls['matcher'] != batches
                or launches['assignment'] != batches
                or launches['dsa_greedy'] != batches or plain
                or any(launches[k] for k in STEP_KERNELS + (
                    'msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd'))):
            raise AssertionError(f'eval path at B={bs} did not run on the '
                                 f'kernels: {launches}, plain {plain}')
        out[bs] = launches
        t = timer.seconds
        rest = seconds - sum(v for k, v in t.items() if k != 'matcher')
        print(f'[eval] where the time of the B={bs} run goes ({card}), '
              f'host-clock s: eval_step {t["eval_step"]:.3f} in '
              f'{timer.calls["eval_step"]} calls (synchronized; of it the '
              f'matcher {t["matcher"]:.3f} in {timer.calls["matcher"]} '
              f'calls, each queuing its cost matrices and one assignment '
              f'launch); '
              f'postprocess {t["postprocess"]:.3f}; to_dvc_records '
              f'{t["to_dvc_records"]:.3f}; eval_metrics: rerank '
              f'{t["rerank"]:.3f}, dvc {t["dvc"]:.3f}, SODA {t["soda"]:.3f}, '
              f'paragraph {t["para"]:.3f}; the rest (model build, weights, '
              f'data, json) {rest:.3f}; total {seconds:.3f}')

    path, scores, launches, plain, _ = run_eval_counted(
        ['--eval_save_dir', folder, '--eval_batch_size', '16',
         '--eval_mode', 'test', '--eval_device', DEVICE])
    check_eval_json(path, VAL_VIDEOS, scored=False)
    if scores is not None or not path.endswith('dvc_results.json') or plain:
        raise AssertionError(f'test mode: {path}, {scores}, plain {plain}')
    print(f'[eval] --eval_mode test: {os.path.basename(path)} written, no '
          f'scores; launches msda_fwd {launches["msda_fwd"]}, dsa_greedy '
          f'{launches["dsa_greedy"]}')

    # one B=16 eval step traced: the card's idle share
    from dvc_tpu_torch.data import FusionBatchLoader, FusionDataset
    from dvc_tpu_torch.serve import load_run
    from dvc_tpu_torch.train import Trainer
    opt, state_dict = load_run(folder)
    trainer = Trainer(opt, device=DEVICE)
    trainer.model.load_state_dict(state_dict)
    ds = FusionDataset(opt.val_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt)
    batch, _ = next(iter(FusionBatchLoader(ds, 16, False, opt)))
    trainer.eval_step(batch)                              # warm-up
    if DEVICE != 'cpu':
        # synchronized inside the window: the greedy decode, launched
        # last, runs after the host has returned
        trace('B=16 eval_step', lambda: (trainer.eval_step(batch),
                                         torch.cuda.synchronize()))
    del trainer

    eval_agreement(tmp, folder, opt, 'eval-agreement')
    if DEVICE != 'cpu':
        torch.cuda.synchronize()
    return out[16]


def eval_agreement(tmp, folder, opt, label):
    """Two val videos of the run in ``folder`` evaluated by run_eval on the
    CPU (plain versions) and on the card, held to phase 5's gates: >= 90%
    of the captions identical, and where they are, timestamps (relative to
    the duration) and proposal scores (relative) within 1e-3; the same
    event counts."""
    import math
    from dvc_tpu_torch import run_eval
    with open(opt.val_caption_file) as f:
        two = dict(list(json.load(f).items())[:2])
    val2 = os.path.join(tmp, f'val2_{label}.json')
    with open(val2, 'w') as f:
        json.dump(two, f)
    runs = {}
    for dev in ('cpu', DEVICE):
        save = os.path.join(tmp, f'agree_{label}_{dev}')
        os.makedirs(save, exist_ok=True)
        path, scores = run_eval.main(
            ['--eval_save_dir', save, '--eval_checkpoint_path',
             os.path.join(folder, 'model-best.pth'), '--eval_caption_file',
             val2, '--eval_batch_size', '2', '--eval_device', dev])
        runs[dev] = (check_eval_json(path, 2, scored=True)['results'], scores)
    (got, gs), (want, ws) = runs[DEVICE], runs['cpu']
    same = total = 0
    err = 0.0
    for key, events in want.items():
        by_query = {e['query_id']: e for e in got[key]}
        for w in events:
            g = by_query[w['query_id']]
            total += 1
            if g['sentence'] != w['sentence']:
                continue
            same += 1
            dur = w['vid_duration']
            err = max(err, *(abs(a - b) / dur for a, b in
                             zip(g['timestamp'], w['timestamp'])),
                      abs(g['proposal_score'] - w['proposal_score'])
                      / abs(w['proposal_score']))
            if g['pred_event_count'] != w['pred_event_count']:
                raise AssertionError(f'event counts differ on {key}')
    print(f'[{label}] two val videos, card vs CPU plain: captions '
          f'identical {same}/{total}; timestamps (relative to the duration) '
          f'and proposal scores (relative) on those, worst {err:.2e}; '
          f'METEOR {gs["METEOR"]:.6f} vs {ws["METEOR"]:.6f}, soda_c '
          f'{gs["soda_c"]:.6f} vs {ws["soda_c"]:.6f} (not gated)')
    if same < 0.9 * total or not err <= 1e-3 or not math.isfinite(err):
        raise AssertionError('card and CPU disagree on the eval records')


# --------------------------------------------------------------------------
# 10. the input pipeline: new_train with and without the device prefetch
# --------------------------------------------------------------------------

# 20 steps at B=16; both windows end before the prefetch's worker, which
# runs up to 4 batches ahead, has the epoch's last batch collated
PIPELINE_VIDEOS = 320
TIMED_STEPS = (2, 12)                 # ms per step: entries of steps 2..12
TRACED_STEPS = (12, 15)               # the profiler: entries of steps 12..15
# (--device_prefetch, the epoch collated before its first step), in turns;
# the last run shows the loop with no collation left in it
PIPELINE_RUNS = ((1, False), (0, False), (0, False), (1, False), (1, True))


class StepRecorder:
    """Patches ``Trainer.train_step`` while active to note, for each step,
    the host clock at its entry and the durations of its batch's videos
    (which name the videos), the first step's losses, and to run the
    profiler (:func:`traced`) from the entry of step TRACED_STEPS[0] to
    that of TRACED_STEPS[1], so it sees whole iterations of new_train's
    loop: collation wait, upload, step and loss read."""

    def __init__(self, label):
        self.label = label
        self.trace_steps = DEVICE != 'cpu'
        self.entries, self.durations, self.first = [], [], None
        self.trace, self._ctx = {}, None

    def __enter__(self):
        import numpy as np
        import torch
        from dvc_tpu_torch.train import Trainer
        self.saved = Trainer.train_step
        original = self.saved

        def train_step(trainer, batch, *args, **kwargs):
            step = len(self.entries)
            self.entries.append(time.perf_counter())
            if self.trace_steps and step == TRACED_STEPS[0]:
                self._ctx = traced(self.label)
                self.trace = self._ctx.__enter__()
            elif self._ctx is not None and step == TRACED_STEPS[1]:
                self._ctx.__exit__(None, None, None)
                self._ctx = None
            losses = original(trainer, batch, *args, **kwargs)
            lengths = batch['video_length']
            lengths = (lengths.cpu().numpy() if torch.is_tensor(lengths)
                       else np.asarray(lengths))
            self.durations.append(tuple(float(d) for d in lengths[:, 1]))
            if self.first is None:
                self.first = {k: float(v) for k, v in losses.items()}
            return losses
        Trainer.train_step = train_step
        return self

    def __exit__(self, *exc):
        from dvc_tpu_torch.train import Trainer
        Trainer.train_step = self.saved
        if self._ctx is not None:
            self._ctx.__exit__(None, None, None)

    def step_ms(self):
        """Host-clock ms of each iteration from one step's entry to the
        next's."""
        return [(b - a) * 1e3 for a, b in zip(self.entries, self.entries[1:])]

    def ms_per_step(self):
        a, b = TIMED_STEPS
        return (self.entries[b] - self.entries[a]) / (b - a) * 1e3


def input_costs(opt, reps=4):
    """Host-clock ms of the input layer at B=16 on this machine: collating
    one batch (``FusionBatchLoader``), uploading it as the trainer did
    before the prefetch (pageable arrays, a blocking ``.to`` each), and
    ``Trainer.prepare_batch`` (pinned host tensors, copies on the copy
    stream), each ended by a synchronize; means over ``reps``."""
    import numpy as np
    import torch
    from dvc_tpu_torch.data import FusionBatchLoader, FusionDataset
    from dvc_tpu_torch.train import Trainer, bucket_caption_length
    ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt, seed=opt.seed)
    batches, collate = [], []
    it = iter(FusionBatchLoader(ds, 16, True, opt, seed=1))
    for _ in range(reps):
        t0 = time.perf_counter()
        batches.append(next(it)[0])
        collate.append(time.perf_counter() - t0)
    trainer = Trainer(opt, device=DEVICE)
    pageable, pinned = [], []
    for batch in batches:
        for out, prepare in (
                (pageable, lambda b: {
                    k: torch.as_tensor(np.asarray(v)).to(trainer.device)
                    for k, v in bucket_caption_length(b).items()}),
                (pinned, trainer.prepare_batch)):
            t0 = time.perf_counter()
            prepare(batch)
            if DEVICE != 'cpu':
                torch.cuda.synchronize()
            out.append(time.perf_counter() - t0)
    mb = sum(np.asarray(v).nbytes
             for v in bucket_caption_length(batches[0]).values()) / 2**20
    return {k: float(np.mean(v[1:]) * 1e3) for k, v in
            (('collate', collate), ('pageable', pageable),
             ('pinned', pinned))}, mb


def phase_pipeline(tmp, card):
    """``new_train.main`` for one epoch (not --debug, no validation: the
    recipe validates every 5) at B=16 over PIPELINE_VIDEOS synthetic
    videos, 20 steps, five times with the same seed as PIPELINE_RUNS says,
    the counts set to 0 before each run and
    read after: the same videos in the same order at every step, the first
    step's losses within 1e-6 relative, every loss finite, the same launch
    counts, no plain version, one matcher copy a step.  The last run
    collates the whole epoch before its first step (:class:`Precollated`),
    so its loop holds the uploads, steps and loss reads only.  Prints each
    run's ms per step of the whole loop (host clock between the entries of
    steps 2 and 12; each step ends in the loss read, a synchronize) with
    every iteration's ms, the idle share of a profiler trace over steps
    12-14, and the input layer's own costs (:func:`input_costs`)."""
    import math
    import numpy as np
    import torch
    from dvc_tpu_torch import new_train
    from dvc_tpu_torch.data import FusionBatchLoader, native_io
    from dvc_tpu_torch.utils.config import load_config, parse_opts

    class Precollated(FusionBatchLoader):
        """Collates the whole epoch when its iteration starts."""

        def __iter__(self):
            return iter(list(super().__iter__()))

    root = os.path.join(tmp, 'pipeline')
    os.makedirs(root)
    recipe = write_synthetic_run(root, load_config(CFG, root=ROOT),
                                 n_videos=PIPELINE_VIDEOS, seed=5)
    with open(os.path.join(root, 'train.json')) as f:
        anno = json.load(f)
    keys = sorted(anno)
    durations = np.array([anno[k]['duration'] for k in keys])

    def key_of(duration):         # the video of a batch row, by duration
        i = int(np.abs(durations - duration).argmin())
        return keys[i] if abs(durations[i] - duration) < 1e-3 else None

    def options(prefetch):
        opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE,
                          '--device_prefetch', str(prefetch)], root=ROOT)
        opt.batch_size = 16           # the recipe file's (1) overlays it
        return opt

    costs, mb = input_costs(options(1))
    print(f'[pipeline] input layer at B=16 ({mb:.1f} MiB a batch after '
          f'bucketing; host clock, {card}): collation {costs["collate"]:.1f} '
          f'ms, pageable upload {costs["pageable"]:.2f} ms, pinned upload on '
          f'the copy stream (Trainer.prepare_batch) {costs["pinned"]:.2f} ms')
    print(f'[pipeline] B=16 collation through the native feature-IO '
          f'library {costs["collate"]:.1f} ms ({card}); PR 20\'s, numpy '
          f'only, {PR20_COLLATION_MS} ms (NVIDIA H100 80GB HBM3, 700.00 W; '
          f'one host-clock sample each, not gated)')
    runs = []
    for prefetch, ahead in PIPELINE_RUNS:
        opt = options(prefetch)
        how = (f'--device_prefetch {prefetch}'
               + (', the epoch collated before it' if ahead else ''))
        reset_counts()
        native_io.calls = 0
        t0 = time.perf_counter()
        new_train.FusionBatchLoader = Precollated if ahead else \
            FusionBatchLoader
        try:
            with StepRecorder(f'new_train loop, {how}, steps '
                              f'{TRACED_STEPS[0]}-{TRACED_STEPS[1] - 1}'
                              ) as rec:
                _, losses = new_train.main(opt)
        finally:
            new_train.FusionBatchLoader = FusionBatchLoader
        if DEVICE != 'cpu':
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        copies = matcher_copies()
        native_calls = native_io.calls
        order = [[key_of(d) for d in step] for step in rec.durations]
        steps = len(rec.entries)
        ms = rec.ms_per_step() if steps > TIMED_STEPS[1] else float('nan')
        print(f'[pipeline] new_train.main, one epoch at B=16, {how}: '
              f'{steps} steps, {seconds:.1f} s in all; {ms:.1f} ms per step '
              f'of the loop (host clock, steps {TIMED_STEPS[0]}-'
              f'{TIMED_STEPS[1] - 1}, collation, upload, step and loss read; '
              f'{card}); each iteration '
              f'{[round(t, 1) for t in rec.step_ms()]} ms; idle share of the '
              f'traced steps {rec.trace.get("idle", float("nan")):.4f}; '
              f'kernel launches {launches}, plain-version calls {plain}, '
              f'matcher copies {copies}, native feature-IO calls '
              f'{native_calls}')
        bad = [k for k, v in {**losses, **rec.first}.items()
               if not math.isfinite(v)]
        if (bad or plain or copies or launches['assignment'] != steps
                or native_calls < 1
                or steps != PIPELINE_VIDEOS // 16
                or any(None in row for row in order)
                or min(launches[k] for k in ('msda_fwd', 'msda_bwd',
                                             'dsa_scan_fwd', 'dsa_scan_bwd')) < 1
                or any(launches[k] for k in STEP_KERNELS)):
            raise AssertionError(f'pipeline run, {how}: '
                                 f'{steps} steps, losses {losses}, launches '
                                 f'{launches}, plain {plain}, copies {copies}, '
                                 f'native feature-IO calls {native_calls}')
        runs.append(dict(prefetch=prefetch, ahead=ahead, order=order,
                         first=rec.first, launches=launches, ms=ms,
                         idle=rec.trace.get('idle', float('nan'))))
    ref = runs[0]
    err = max(abs(r['first'][k] - ref['first'][k])
              / max(abs(ref['first'][k]), 1e-12)
              for r in runs for k in ref['first'])
    same = all(r['order'] == ref['order'] and r['launches'] == ref['launches']
               and sorted(r['first']) == sorted(ref['first']) for r in runs)

    def summary(prefetch, ahead=False):
        mine = [r for r in runs
                if (r['prefetch'], r['ahead']) == (prefetch, ahead)]
        return (', '.join(f'{r["ms"]:.1f}' for r in mine) + ' ms a step, '
                'idle ' + ', '.join(f'{r["idle"]:.4f}' for r in mine))
    print(f'[pipeline] runs in the order (--device_prefetch, collated '
          f'before) {PIPELINE_RUNS}: batch order and launch counts identical '
          f'{same}, first step\'s losses worst relative difference '
          f'{err:.2e}; prefetch on: {summary(1)}; off: {summary(0)}; on, '
          f'the epoch collated before it: {summary(1, True)} ({card})')
    if not same or err > 1e-6:
        raise AssertionError('the prefetch changed what new_train computed')
    return runs


# --------------------------------------------------------------------------
# 11. sampling: --caption_sample_max 0 on the card
# --------------------------------------------------------------------------

SAMPLED = ((0, 1.0), (0, 0.5), (1, 1.0))     # (--dsa_lstm_fuse, temperature)


def sampled_agreement(cpu, batch, tokens, lps):
    """The CPU plain path's teacher-forced log-probabilities of the card's
    sampled ``tokens`` (B, Nq, K) on the videos of ``batch`` (dropout
    off), against the card's emitted ``lps``, on each caption's positions
    up to and including its first EOS.  Returns (worst abs difference,
    positions compared)."""
    import torch
    from dvc_tpu_torch.models.caption_heads import truncate_levels
    pdvc = cpu.pdvcModel
    c = pdvc.cfg
    with torch.inference_mode():
        enc, hs, refs, _ = pdvc.trunk(cpu._fuse(batch))
        memory, shapes, valid_ratios, mask_flat = enc
        center, scale = pdvc.caption_reference(refs[-1], valid_ratios, shapes)
        shapes_t, mem_t, mask_t, center_t, scale_t = truncate_levels(
            c.caption, shapes, memory, mask_flat, center, scale)
        n, K = tokens.shape[0] * tokens.shape[1], tokens.shape[2]
        seq = tokens.reshape(n, K).long()
        tf = torch.cat([torch.zeros((n, 1), dtype=torch.long), seq], 1)
        lp = pdvc.caption_head[c.dec_layers - 1].teacher_forcing(
            hs[-1], center_t, scale_t, mem_t, shapes_t, mask_t, tf)
    want = torch.gather(lp, -1, seq[..., None])[..., 0]
    alive = torch.cumprod((seq > 0).long(), 1)
    valid = torch.cat([torch.ones((n, 1), dtype=torch.long), alive[:, :-1]],
                      1) > 0
    diff = (want - lps.reshape(n, K)).abs()[valid]
    return float(diff.max()), int(valid.sum())


def phase_sampling(folder):
    """Phase 6's model-best.pth served with --caption_sample_max 0 on a B=16
    batch at temperatures 1.0 and 0.5 through K7 (--dsa_lstm_fuse 0), and
    1.0 through K9 (1), counts set to 0 before each decode and read after:
    one launch of the word-step kernel per decode step and one table, no
    K6 launch, no plain version; tokens in the vocabulary, log-probs
    finite and <= 0; two videos' sampled tokens teacher-forced on the CPU
    plain path, their log-probs within 1e-3 of the card's; each decode's
    caption_batch timed beside the greedy (fused K6) one."""
    import math
    import numpy as np
    import torch
    from dvc_tpu_torch.models import make_fusion_model
    from dvc_tpu_torch.serve import DenseCaptioner, load_run
    from dvc_tpu_torch.utils.config import Config
    opt, state_dict = load_run(folder)                        # the best
    greedy = DenseCaptioner(opt=opt, state_dict=state_dict, device=DEVICE)
    C, K, V = opt.feature_dim, opt.max_caption_len, opt.vocab_size
    rng = np.random.default_rng(6)
    feats = [rng.standard_normal((int(n), C)).astype(np.float32)
             for n in rng.integers(60, 400, 16)]
    durs = [float(d) for d in rng.uniform(10, 300, 16)]
    batch = greedy._make_batch(feats, durs)
    cpu_batch = {k: v[:2].cpu() for k, v in batch.items()}

    def timed(dc):
        dc.caption_batch(feats, durs)                     # warm-up
        if DEVICE != 'cpu':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            dc.caption_batch(feats, durs)
        if DEVICE != 'cpu':
            torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 3 * 1e3

    greedy_ms = timed(greedy)
    del greedy
    cpu = make_fusion_model(opt, 'cpu')
    cpu.load_state_dict(state_dict, strict=True)
    for lstm_fuse, temperature in SAMPLED:
        fwd = STEPWISE[bool(lstm_fuse)][0]
        sopt = Config({**opt.to_dict(), 'caption_sample_max': 0,
                       'caption_sample_temperature': temperature,
                       'dsa_lstm_fuse': lstm_fuse})
        dc = DenseCaptioner(opt=sopt, state_dict=state_dict, device=DEVICE)
        reset_counts()
        with torch.inference_mode():
            out = dc.model(batch, dc.gen)
        if DEVICE != 'cpu':
            torch.cuda.synchronize()
        launches, plain = read_counts()
        seq, lps = out['seq'].cpu(), out['cap_prob_eval'].cpu()
        ok_values = bool(seq.min() >= 0 and seq.max() <= V
                         and torch.isfinite(lps).all() and (lps <= 0).all())
        err, compared = sampled_agreement(cpu, cpu_batch, seq[:2], lps[:2])
        ms = timed(dc)
        print(f'[sampling] --caption_sample_max 0 --caption_sample_temperature '
              f'{temperature} --dsa_lstm_fuse {lstm_fuse}, B=16: {fwd} '
              f'launches {launches[fwd]}, table_gemm {launches["table_gemm"]}, '
              f'greedy kernel {launches["dsa_greedy"]}, plain-version calls '
              f'{plain}; tokens in [0, {V}] and log-probs finite and <= 0 '
              f'{ok_values}; mean caption length '
              f'{float((seq > 0).sum(-1).float().mean()):.2f}; two videos\' '
              f'tokens teacher-forced on the CPU: worst log-prob difference '
              f'{err:.2e} over {compared} positions; caption_batch {ms:.1f} ms '
              f'(greedy, fused K6: {greedy_ms:.1f} ms)')
        if (launches[fwd] != K or launches['table_gemm'] != 1
                or launches['dsa_greedy'] or plain or not ok_values
                or not math.isfinite(err) or err > 1e-3):
            raise AssertionError('the sampling decode did not run on the '
                                 'word-step kernel or disagrees')
        del dc
    return greedy_ms


# --------------------------------------------------------------------------
# 12. --pretrain on the card
# --------------------------------------------------------------------------

def phase_pretrain(opt, folder):
    """--pretrain encoder from phase 6's model-best.pth into a fresh
    Trainer on the card, through ``new_train.pretrain`` (what
    ``new_train.main`` calls when not resuming): the encoder's parameters
    equal the source's, every other one the fresh initialisation."""
    import torch
    from dvc_tpu_torch.new_train import pretrain
    from dvc_tpu_torch.train import Trainer, is_encoder_param, load_checkpoint
    from dvc_tpu_torch.utils.config import Config
    path = os.path.join(folder, 'model-best.pth')
    popt = Config({**opt.to_dict(), 'pretrain': 'encoder',
                   'pretrain_path': path})
    trainer = Trainer(popt, device=DEVICE)
    fresh = {k: v.cpu().clone() for k, v in
             trainer.model.state_dict().items()}
    taken = set(pretrain(trainer, popt))
    source = load_checkpoint(path)['model']
    encoder = {k for k in fresh if k.startswith('pdvcModel.')
               and is_encoder_param(k[len('pdvcModel.'):])}
    wrong = [k for k, v in trainer.model.state_dict().items()
             if not torch.equal(v.cpu(), source[k] if k in encoder
                                else fresh[k])]
    moved = sum(not torch.equal(source[k], fresh[k]) for k in encoder)
    print(f'[pretrain] --pretrain encoder from {os.path.basename(path)} on '
          f'the card: {len(taken)} encoder parameters restored ({moved} of '
          f'them differ from the fresh ones), {len(fresh) - len(taken)} '
          f'others kept; mismatches {wrong[:3]}')
    if taken != encoder or wrong or not moved:
        raise AssertionError('--pretrain encoder restored the wrong set')


# --------------------------------------------------------------------------
# 13. plain PDVC: run_train, run_eval and serving of the plain recipes
# --------------------------------------------------------------------------

PLAIN = {'standard': 'cfgs/yc2_tsp_pdvc.yml', 'light': 'cfgs/yc2_tsn_pdvcl.yml',
         'two_stage': 'cfgs/yc2_tsn_pdvcl_gt.yml',
         'none': 'cfgs/anet_c3d_props.yml'}
TRUNK = ('msda_fwd', 'msda_bwd')
CAPTION_KERNELS = ('dsa_scan_fwd', 'dsa_scan_bwd', 'dsa_greedy') \
    + STEP_KERNELS + ('table_gemm', 'table_gemm_bwd')
FUSED = ('dsa_scan_fwd', 'dsa_scan_bwd', 'dsa_greedy', 'dsa_lstm_fwd',
         'dsa_lstm_bwd')


def event_ms(fn):
    """(fn(), the ms between two CUDA events around it, synchronized; the
    host clock on the CPU)."""
    import torch
    if DEVICE == 'cpu':
        t0 = time.perf_counter()
        return fn(), (time.perf_counter() - t0) * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def write_plain_run(tmp, name, **over):
    """The synthetic train (TRAIN_VIDEOS) and val (VAL_VIDEOS) sets of
    ``PLAIN[name]`` at its feature types and widths (one file per type
    and video, where the dataset reads it; no sound), its vocabulary, the
    metrics' gt files, and a recipe that inherits it with ``over``.
    Returns the run's --debug options on DEVICE."""
    from dvc_tpu_torch.data.dataset import FEATURE_SPECS
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    recipe = PLAIN[name]
    base = load_config(recipe, root=ROOT)
    root = os.path.join(tmp, f'plain_{name}')
    vtype = base.visual_feature_type
    types = list(vtype) if isinstance(vtype, (list, tuple)) else [vtype]
    folders = [os.path.join(root, f'features_{t}') for t in types]
    for folder in folders:
        os.makedirs(folder)
    features = [(lambda key, t=t, f=f: FEATURE_SPECS[t]['path'](f, key),
                 base.feature_dim if len(types) == 1
                 else FEATURE_SPECS[t]['dim'])
                for t, f in zip(types, folders)]
    words = letter_words(base.vocab_size)
    vocab = os.path.join(root, 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'word_to_ix': {w: i for i, w in enumerate(words, 1)},
                   'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}},
                  f)
    paths = {}
    for split, prefix, n, seed in (('train', 'v_plntr', TRAIN_VIDEOS, 0),
                                   ('val', 'v_plnvl', VAL_VIDEOS, 1)):
        anno = write_videos(root, prefix, n, seed, base.feature_dim, words,
                            features, sound=False)
        paths[split] = os.path.join(root, f'{split}.json')
        with open(paths[split], 'w') as f:
            json.dump(anno, f)
    para = os.path.join(root, 'para_val.json')
    with open(para, 'w') as f:
        json.dump({k: ' '.join(v['sentences']) for k, v in anno.items()}, f)
    path = os.path.join(root, 'plain.yml')
    with open(path, 'w') as f:
        json.dump({'base_cfg_path': recipe, 'id': name,
                   'save_dir': os.path.join(root, 'save'),
                   'train_caption_file': paths['train'],
                   'val_caption_file': paths['val'],
                   'gt_file_for_eval': [paths['val']],
                   'gt_file_for_para_eval': [para], 'dict_file': vocab,
                   'visual_feature_folder': (folders if isinstance(
                       vtype, (list, tuple)) else folders[0]),
                   'invalid_video_json': [], 'epoch': 1, **over}, f)
    return parse_opts(['--cfg_path', path, '--debug', '--device', DEVICE],
                      root=ROOT)


def check_launches(label, launches, plain, want, zero, exact=None):
    """Every kernel of ``want`` launched, none of ``zero``, each of
    ``exact`` {kernel: launches} as often as it says, no plain version."""
    if (min(launches[k] for k in want) < 1 or plain
            or any(launches[k] for k in zero)
            or any(launches[k] != v for k, v in (exact or {}).items())):
        raise AssertionError(f'[{label}] did not run on the kernels: '
                             f'launches {launches}, plain calls {plain}')


def plain_train(opt, label, want, zero, card):
    """``run_train.main`` (one --debug epoch: 5 steps at B=1, then the
    validation of 6 val videos at B=1) with the launch counts set to 0
    just before and read just after; finite losses, the kernels of
    ``want`` launched and none of ``zero``, no plain version, the
    validation's files.  Returns (run folder, launches)."""
    import math
    from dvc_tpu_torch import run_train
    reset_counts()
    (folder, losses), ms = event_ms(lambda: run_train.main(opt))
    launches, plain = read_counts()
    print(f'[{label}] run_train.main --debug, B=1, {opt.caption_decoder_type}'
          f' head, {opt.transformer_input_type} ({card}): {ms:.0f} ms (CUDA events; '
          f'setup, 5 steps, validation, checkpoints); mean losses '
          f'{json.dumps(losses)}; kernel launches {launches}, plain-version '
          f'calls {plain}')
    if not all(math.isfinite(v) for v in losses.values()) or (
            ('loss_caption' in losses) != (opt.caption_decoder_type != 'none')):
        raise AssertionError(f'[{label}] losses {losses}')
    check_launches(label, launches, plain, want, zero)
    print(f'[{label}] validation of epoch 1: '
          f'{check_validation(folder, [1])}')
    return folder, launches


def check_run_folder(folder, label):
    """``run_train``'s records in ``folder`` (train.py's): metrics.jsonl
    with ``lr``, ``videos_per_sec`` and each ``train/<loss>`` of every
    epoch of ``loss_history`` and ``val/<score>`` of every validation of
    ``val_history``, all finite, at one step count each epoch; ``backup/``
    with ``cfgs/`` and ``dvc_tpu_torch/``, and no ``_build/`` or
    ``__pycache__``; the option table in train.log."""
    import math
    with open(os.path.join(folder, 'info.json')) as f:
        info = json.load(f)
    with open(os.path.join(folder, 'metrics.jsonl')) as f:
        lines = [json.loads(x) for x in f.read().splitlines()]
    tags = {}
    for x in lines:
        tags.setdefault(x['tag'], []).append(x['step'])
    steps = tags.get('lr', [])
    want = {'lr': steps, 'videos_per_sec': steps,
            **{f'train/{k}': steps for k in
               {k for v in info['loss_history'].values() for k in v}},
            **{f'val/{k}': steps[-len(info['val_history']):] for k in
               {k for v in info['val_history'].values() for k in v}}}
    backup = os.path.join(folder, 'backup')
    junk = [d for _, dirs, _ in os.walk(backup) for d in dirs
            if d in ('_build', '__pycache__')]
    with open(os.path.join(folder, 'train.log')) as f:
        table = sum('] | ' in line for line in f)
    ok = (len(steps) == len(info['loss_history']) and tags == want
          and all(math.isfinite(x['value']) for x in lines)
          and all(os.path.isdir(os.path.join(backup, d))
                  for d in ('cfgs', 'dvc_tpu_torch'))
          and not junk and table > 100)
    n_train = sum(t.startswith('train/') for t in want)
    print(f'[{label}] run folder: metrics.jsonl {len(lines)} lines, lr, '
          f'videos_per_sec, {n_train} train/ and {len(want) - n_train - 2} '
          f'val/ tags at steps {steps}, all finite: {ok}; backup/ holds '
          f'cfgs/ and dvc_tpu_torch/ without _build/: {not junk}; option '
          f'table rows in train.log: {table}')
    if not ok:
        raise AssertionError(f'[{label}] run folder: tags {tags}, want '
                             f'{want}, junk {junk}, table {table}')


def plain_eval_and_serve(folder, label, want, zero, greedy, card):
    """run_eval on the run folder at --eval_batch_size 16 (one batch of
    the VAL_VIDEOS val videos), counted: ``greedy`` K6 launches, the
    kernels of ``want`` launched, none of ``zero``; then
    ``DenseCaptioner(folder)`` answers one request."""
    import numpy as np
    from dvc_tpu_torch.serve import DenseCaptioner
    path, scores, launches, plain, seconds = run_eval_counted(
        ['--eval_save_dir', folder, '--eval_batch_size', '16',
         '--eval_device', DEVICE])
    check_eval_json(path, VAL_VIDEOS, scored=True)
    print(f'[{label}] run_eval --eval_batch_size 16 ({card}): {seconds:.2f} s '
          f'(host clock); '
          f'{", ".join(f"{k} {scores[k]:.4f}" for k in EVAL_SCORES)}; '
          f'kernel launches {launches}, plain-version calls {plain}')
    check_launches(label, launches, plain, want, zero,
                   exact={'dsa_greedy': greedy})
    dc = DenseCaptioner(folder, device=DEVICE)
    rng = np.random.default_rng(4)
    events, ms = event_ms(lambda: dc.caption_features(
        rng.standard_normal((240, dc.opt.feature_dim)).astype(np.float32),
        150.0))
    check_events(events, 150.0)
    print(f'[{label}] DenseCaptioner(folder) served one request ({card}) in '
          f'{ms:.1f} ms (CUDA events): {len(events)} events, first '
          f'{events[0]["timestamp"]}')
    return dc


def light_decode_times(dc, card):
    """The light head's word loop alone on the card (K word steps of small
    GEMMs, no kernel of its own), at B=1 and B=16 over the recipe's
    queries (``cuda_ms``)."""
    import torch
    head = dc.model.caption_head[-1]
    opt = dc.opt
    gen = torch.Generator(device=dc.device).manual_seed(5)
    out = []
    for B in (1, 16):
        feats = torch.randn((B * opt.num_queries, opt.hidden_dim),
                            generator=gen, device=dc.device)
        with torch.inference_mode():
            ms = cuda_ms(lambda: head(feats), 3)
        out.append(f'B={B} ({B * opt.num_queries} queries x '
                   f'{opt.max_caption_len} steps) {ms:.2f} ms')
    print(f'[plain-light] the light head\'s greedy word loop alone ({card}), '
          f'mean of 3 after a warm-up (CUDA events): {"; ".join(out)}')


def plain_two_stage(tmp, card):
    """(c) two-stage light head on gt proposals: every layer's boxes equal
    the gt boxes where gt_boxes_mask holds (within 1e-6), the weighted
    loss_ce, loss_bbox and loss_giou are 0, the losses finite, one train
    step on the card; then its checkpoint through run_eval (test mode):
    G records a video."""
    import math
    import torch
    from dvc_tpu_torch.models import make_pdvc_model
    from dvc_tpu_torch.models.criterion import build_weight_dict
    from dvc_tpu_torch.new_train import save_info_json
    from dvc_tpu_torch.train import Trainer, save_checkpoint
    opt = write_plain_run(tmp, 'two_stage')
    trainer = Trainer(opt, device=DEVICE,
                      model=make_pdvc_model(opt, DEVICE, seed=0))
    batch = train_batch(opt, 2, plain=True)
    tb = trainer._device_batch(batch, trainer.prepare_batch)
    reset_counts()
    with torch.no_grad():
        _, hs, refs, deltas = trainer.model.trunk(tb)
        boxes = trainer.model.layer_outputs(hs, refs, deltas,
                                            train_path=True)['pred_boxes']
    mask = tb['gt_boxes_mask']
    err = float((boxes[:, mask] - tb['gt_boxes'][mask]).abs().max())
    weights = build_weight_dict(opt)
    zeroed = {k: w for k, w in weights.items()
              if k.split('_')[1] in ('ce', 'bbox', 'giou')}
    losses, ms = event_ms(lambda: trainer.train_step(batch, opt.lr))
    losses = {k: float(v) for k, v in losses.items()}
    launches, plain = read_counts()
    print(f'[plain-two-stage] {PLAIN["two_stage"]} ({card}): G = '
          f'{opt.gt_proposal_sample_num} queries from the gt boxes; every '
          f'layer\'s boxes vs the gt boxes where masked, max abs diff '
          f'{err:.2e}; weights of {sorted(zeroed)} all 0: '
          f'{not any(zeroed.values())}; one B=2 train step {ms:.1f} ms, '
          f'losses {json.dumps(losses)}; launches {launches}, plain {plain}')
    if (err > 1e-6 or any(zeroed.values()) or len(zeroed) != 3 * opt.dec_layers
            or not all(math.isfinite(v) for v in losses.values())):
        raise AssertionError('two-stage boxes, weights or losses wrong')
    check_launches('plain-two-stage', launches, plain, TRUNK,
                   CAPTION_KERNELS)
    folder = os.path.join(tmp, 'plain_two_stage', 'run')
    save_checkpoint(folder, 'best', trainer, 1)
    save_info_json(folder, {'best': {'epoch': 1, 'opt': opt.to_dict()}})
    path, _, launches, plain, seconds = run_eval_counted(
        ['--eval_save_dir', folder, '--eval_mode', 'test',
         '--eval_batch_size', '16', '--eval_device', DEVICE])
    out = check_eval_json(path, VAL_VIDEOS, scored=False)
    counts = {len(v) for v in out['results'].values()}
    print(f'[plain-two-stage] run_eval --eval_mode test over the val set\'s '
          f'gt boxes: {seconds:.2f} s, records a video {counts}; launches '
          f'{launches}, plain {plain}')
    check_launches('plain-two-stage', launches, plain, ('msda_fwd',),
                   CAPTION_KERNELS)
    if counts != {opt.gt_proposal_sample_num}:
        raise AssertionError('two-stage records are not one a gt slot')


def plain_none(tmp, card):
    """(d) the 'none' head (localisation only): no caption kernel, empty
    sentences, finite Recall and Precision."""
    import math
    opt = write_plain_run(tmp, 'none')
    folder, _ = plain_train(opt, 'plain-none', TRUNK, CAPTION_KERNELS, card)
    with open(os.path.join(folder, 'epoch1.json')) as f:
        sentences = {e['sentence'] for v in json.load(f)['results'].values()
                     for e in v}
    with open(os.path.join(folder, 'info.json')) as f:
        history = json.load(f)['val_history']['1']
    print(f'[plain-none] sentences {sentences}; Recall {history["Recall"]}, '
          f'Precision {history["Precision"]}')
    if sentences != {''} or not all(math.isfinite(history[k])
                                    for k in ('Recall', 'Precision')):
        raise AssertionError('the none head wrote captions or no scores')


def plain_cores(opt, card):
    """(e) the LSTM-DSA core beyond the fused kernels' case, one train step
    and one eval step each on a B=1 batch, counted: at num_layers 2 one K7
    per word step of the decode and one K7 and one K8 per word step of
    training, one table and one table backward a step, and no K4, K5, K6,
    K9 or K10, under --dsa_lstm_fuse 0 and 1; at att_hid_size 0 (one
    layer) no word-step kernel at all and the trunk kernels."""
    from dvc_tpu_torch.models import make_pdvc_model
    from dvc_tpu_torch.train import Trainer, bucket_caption_length
    from dvc_tpu_torch.utils.config import Config
    batch = train_batch(opt, 1, plain=True)
    steps = bucket_caption_length(batch)['cap_tensor'].shape[-1] - 1
    for over in ({'num_layers': 2}, {'num_layers': 2, 'dsa_lstm_fuse': 1},
                 {'att_hid_size': 0}):
        copt = Config({**opt.to_dict(), **over})
        trainer = Trainer(copt, device=DEVICE,
                          model=make_pdvc_model(copt, DEVICE, seed=0))
        reset_counts()
        _, train_ms = event_ms(lambda: trainer.train_step(batch, copt.lr))
        train, tplain = read_counts()
        reset_counts()
        _, eval_ms = event_ms(lambda: trainer.eval_step(batch))
        evals, eplain = read_counts()
        print(f'[plain-core] {over} ({card}, CUDA events): train step '
          f'{train_ms:.1f} ms, launches '
              f'{train}; eval step {eval_ms:.1f} ms, launches {evals} '
              f'({steps} teacher-forced word steps, {copt.max_caption_len} '
              f'decode steps)')
        if 'num_layers' in over:
            check_launches('plain-core', train, tplain, TRUNK, FUSED,
                           exact=dict(dsa_step_fwd=steps, dsa_step_bwd=steps,
                                      table_gemm=1, table_gemm_bwd=1))
            check_launches('plain-core', evals, eplain, ('msda_fwd',),
                           FUSED + ('msda_bwd', 'dsa_step_bwd'),
                           exact=dict(dsa_step_fwd=copt.max_caption_len,
                                      table_gemm=1))
        else:
            check_launches('plain-core', train, tplain, TRUNK,
                           CAPTION_KERNELS)
            check_launches('plain-core', evals, eplain, ('msda_fwd',),
                           CAPTION_KERNELS)
        del trainer


def plain_steps_per_dispatch(opt, card):
    """(g) --steps_per_dispatch 2: ``Trainer.train_steps`` on two batches
    against two ``train_step`` calls from the same weights (dropout off):
    the same first losses, the parameters within phase 7's tolerance
    (relative L2 error 1e-3 + 1e-5), except where the gradient is zero in
    exact arithmetic and Adam turns its rounding into steps of +-lr
    (alpha_net's bias; the key third of the self-attention's
    in_proj_bias), as tests/test_torch_train.py; then ``run_train.main``
    --steps_per_dispatch 2 for a --debug epoch (6 steps, no validation):
    one device-to-host loss copy per two steps.  Both with one assignment
    launch a step, no matcher copy and no plain version."""
    import torch
    from dvc_tpu_torch import run_train
    from dvc_tpu_torch.data import BatchLoader, DenseCaptionDataset
    from dvc_tpu_torch.models import make_pdvc_model
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import Config
    gopt = Config({**opt.to_dict(), 'drop_prob': 0.0,
                   'transformer_dropout_prob': 0.0})
    loader = iter(BatchLoader(DenseCaptionDataset(
        gopt.train_caption_file, gopt.visual_feature_folder, gopt.dict_file,
        gopt), 1, False, gopt))
    batches = [next(loader)[0] for _ in range(2)]
    pair = [Trainer(gopt, device=DEVICE,
                    model=make_pdvc_model(gopt, DEVICE, seed=0))
            for _ in range(2)]
    copies = run_train.host_losses.copies
    reset_counts()
    stacked, ms2 = event_ms(lambda: run_train.host_losses(
        pair[0].train_steps(batches, gopt.lr)))
    one_copy = run_train.host_losses.copies - copies == 1
    matching = read_counts(), matcher_copies()
    singles = [float(pair[1].train_step(b, gopt.lr)['total_loss'])
               for b in batches]
    worst, name = 0.0, ''
    for (n, p), q in zip(pair[0].model.named_parameters(),
                         pair[1].model.parameters()):
        a, b = p.detach().cpu(), q.detach().cpu()
        if n.endswith('alpha_net.bias'):
            continue
        if n.endswith('in_proj_bias'):
            E = len(a) // 3
            a, b = torch.cat([a[:E], a[2 * E:]]), torch.cat([b[:E], b[2 * E:]])
        err = float((a - b).norm() / (b.norm() + 1e-5 / 1e-3))
        if err > worst:
            worst, name = err, n
    print(f'[plain-dispatch] train_steps of 2 batches in {ms2:.1f} ms ({card}, '
          f'CUDA events; one '
          f'loss copy: {one_copy}) vs 2 train_step: summed total loss '
          f'{stacked["total_loss"]:.6f} vs {sum(singles):.6f}; worst '
          f'parameter relative L2 error {worst:.2e} ({name}); '
          f'assignment launches {matching[0][0]["assignment"]}, plain-version '
          f'calls {matching[0][1]}, matcher copies {matching[1]}')
    if (matching[0][0]['assignment'], matching[0][1], matching[1]) != (2, 0, 0):
        raise AssertionError(f'train_steps: {matching}, not one assignment '
                             f'launch a step and no copy')
    if not one_copy or worst > 1e-3 or abs(
            stacked['total_loss'] - sum(singles)) > 1e-4 * abs(sum(singles)):
        raise AssertionError('stacked steps disagree with single steps')
    dopt = Config({**opt.to_dict(), 'steps_per_dispatch': 2,
                   'save_checkpoint_every': 99, 'id': 'dispatch'})
    copies = run_train.host_losses.copies
    reset_counts()
    _, losses = run_train.main(dopt)
    n = run_train.host_losses.copies - copies
    launches, plain = read_counts()
    print(f'[plain-dispatch] run_train --steps_per_dispatch 2 --debug: '
          f'{n} device-to-host loss copies; assignment launches '
          f'{launches["assignment"]}, plain-version calls {plain}, matcher '
          f'copies {matcher_copies()}; mean losses {json.dumps(losses)}')
    if n != 3:
        raise AssertionError(f'{n} loss copies for 6 steps, not 3')
    if launches['assignment'] != 6 or plain or matcher_copies():
        raise AssertionError(f'run_train --steps_per_dispatch 2: '
                             f'{launches}, plain {plain}, not one '
                             f'assignment launch a step and no copy')


def phase_plain(tmp, card):
    """Phase 13: plain PDVC through ``run_train`` and ``run_eval`` at full
    width on synthetic features, each check failing the run.  Returns the
    launches of the standard recipe's training run."""
    import torch
    # f32 throughout, as phase 3 sets it (cuDNN's convolutions would take
    # TF32 by default, and the agreements are held at f32's tolerances)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # (a) the README's first recipe, the LSTM-DSA head
    opt_a = write_plain_run(tmp, 'standard')
    no_step = STEP_KERNELS + ('table_gemm', 'table_gemm_bwd')
    folder, launches = plain_train(
        opt_a, 'plain-standard', TRUNK + ('dsa_scan_fwd', 'dsa_scan_bwd',
                                          'dsa_greedy'), no_step, card)
    check_run_folder(folder, 'plain-standard')
    plain_eval_and_serve(folder, 'plain-standard', ('msda_fwd',), no_step,
                         1, card)
    # (b) the light head, 3072-d features, 100 queries
    opt_b = write_plain_run(tmp, 'light')
    folder_b, _ = plain_train(opt_b, 'plain-light', TRUNK, CAPTION_KERNELS,
                              card)
    dc = plain_eval_and_serve(folder_b, 'plain-light', ('msda_fwd',),
                              CAPTION_KERNELS, 0, card)
    light_decode_times(dc, card)
    del dc
    eval_agreement(tmp, folder_b, opt_b, 'plain-light-agreement')
    # (c) two-stage, (d) no caption head, (e) the cores
    plain_two_stage(tmp, card)
    plain_none(tmp, card)
    plain_cores(opt_a, card)
    # (f) train agreement, (g) stacked steps
    from dvc_tpu_torch.utils.config import Config
    for opt, label in ((opt_a, 'standard'), (opt_b, 'light'),
                       (Config({**opt_a.to_dict(), 'num_layers': 2}),
                        'two-layer')):
        phase_train_agreement(opt, f'plain-{label}-train-agreement',
                              plain=True)
    plain_steps_per_dispatch(opt_a, card)
    return launches


# --------------------------------------------------------------------------
# 14. TSP extraction and streaming
# --------------------------------------------------------------------------

TSP_RECIPE = 'cfgs/yc2_tsp_mvit_ete.yml'
TSP_BACKBONES = (('mvit_v2_s', None), ('r2plus1d_34', None))  # (name, MViT config)
TSP_CLIP_LEN = 16
TSP_BATCH = 32             # clips a backbone batch
TSP_SECONDS = 30           # each synthetic video: 30 s at 30 fps, 27 clips
TSP_TRAIN_VIDEOS = 8
TSP_F32_TOL = 1e-3         # card f32 vs CPU f32, relative L2 of the features
TSP_BF16_TOL = 5e-2        # card bf16 vs card f32, relative L2
BF16_FLOP_PER_S = 989e12   # dense, on the tensor cores


def noisy_tsp_model(name, seed, config=None, **heads):
    """The TSP model of ``name`` (one head, or ``heads``' num_classes and
    num_heads) on the CPU with seeded weights: the flax-like init, then
    every tensor that it leaves at 0 or 1 (biases, the MViT's rel-pos
    tables and class token, the norms' scales, the BatchNorm statistics)
    drawn from seeded noise, so that no path of the forward is trivially
    zero."""
    import torch
    from dvc_tpu_torch.models.tsp import make_tsp_model
    model = make_tsp_model(name, 'cpu', seed, config=config, **heads)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for k, t in model.state_dict().items():
            if not t.is_floating_point():
                continue
            if k.endswith('running_var'):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.dim() == 1 and k.endswith('weight'):
                t.copy_(1 + 0.1 * torch.randn(t.shape, generator=gen))
            elif k.endswith(('bias', 'running_mean', 'rel_pos_h',
                             'rel_pos_w', 'rel_pos_t', 'class_token')):
                t.copy_(0.1 * torch.randn(t.shape, generator=gen))
    return model


def mvit_macs(cfg):
    """Multiply-adds of one MViTv2 clip from its block table: the patchify
    conv, and per block the qkv, depthwise pool, score, rel-pos bias,
    attention-value, projection, skip-projection and MLP products."""
    from dvc_tpu_torch.models.tsp.backbones import (mvit_block_specs,
                                                    patch_grid, pooled)
    thw = patch_grid(cfg)
    n = thw[0] * thw[1] * thw[2]
    macs = n * cfg.embed_dim * 3 * 3 * 7 * 7
    for s in mvit_block_specs(cfg):
        D = s.out_ch // s.heads
        q, k = pooled(thw, s.q_stride), pooled(thw, s.kv_stride)
        lq, lk = q[0] * q[1] * q[2], k[0] * k[1] * k[2]
        macs += (1 + n) * s.in_ch * 3 * s.out_ch               # qkv
        macs += s.heads * D * 27 * (lq + 2 * lk)                # pools
        macs += 2 * s.heads * (1 + lq) * (1 + lk) * D           # q.k, a.v
        macs += s.heads * lq * D * sum(k)                       # rel-pos
        macs += (1 + lq) * s.out_ch * s.out_ch                  # project
        if s.in_ch != s.out_ch:
            macs += (1 + n) * s.in_ch * s.out_ch                # skip proj
        macs += 2 * (1 + lq) * s.out_ch * int(s.out_ch * cfg.mlp_ratio)
        thw, n = q, lq
    return macs


def counted_flops(model, x):
    """torch.utils.flop_counter's count of one forward (its matmuls and
    convolutions, 2 per multiply-add)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    counter = FlopCounterMode(display=False)
    with torch.inference_mode(), counter:
        model(x)
    return counter.get_total_flops()


def tsp_kernel_classes(model, x, card):
    """One forward under torch.profiler: the kernels' device time by name
    and by class (convolutions, matmuls, the rest)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode():
        model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            model(x)
            torch.cuda.synchronize()
    per = {e.key: e.device_time_total for e in prof.key_averages()
           if e.device_time_total > 0}
    total = sum(per.values())
    if not total:
        print('[tsp] the profiler recorded no device time: kernel classes '
              'not measured')
        return
    classes = {'convolutions': ('conv', 'depthwise', 'implicit', 'winograd'),
               'matmuls': ('gemm', 'xmma', 'cutlass', 'sm90', 'matmul',
                           'nvjet')}
    sums = {c: 0.0 for c in (*classes, 'rest')}
    for name, us in per.items():
        c = next((c for c, keys in classes.items()
                  if any(k in name.lower() for k in keys)), 'rest')
        sums[c] += us
    print(f'[tsp] one bf16 MViTv2-S batch under the profiler ({card}): '
          f'device {total / 1e3:.2f} ms; by class: ' + ', '.join(
              f'{c} {us / 1e3:.2f} ms ({us / total:.3f})'
              for c, us in sums.items()))
    for name, us in sorted(per.items(), key=lambda kv: -kv[1])[:10]:
        print(f'[tsp]   {us / 1e3:9.3f} ms  {us / total:.4f}  {name[:100]}')


def pool_layout_ab(ex, x, card):
    """The MViT's pool convs and skip max-pools fed the contiguous grid
    (``backbones._grid``, as built) against a channels-last view of the
    tokens (no copy), in turns (contiguous, view, view, contiguous):
    ms a batch, CUDA events."""
    from dvc_tpu_torch.models.tsp import backbones
    grid = backbones._grid

    def view(t, B, thw, C):
        return t.reshape(B, *thw, C).permute(0, 4, 1, 2, 3)
    times = {'contiguous': [], 'channels-last view': []}
    try:
        for label in ('contiguous', 'channels-last view',
                      'channels-last view', 'contiguous'):
            backbones._grid = grid if label == 'contiguous' else view
            times[label].append(cuda_ms(lambda: ex.features(x), 2))
    finally:
        backbones._grid = grid
    print(f'[tsp] MViTv2-S bf16 B={TSP_BATCH}, pool input layout in turns '
          f'({card}): ' + '; '.join(
              f'{k} {", ".join(f"{t:.2f}" for t in v)} ms'
              for k, v in times.items()))


def tsp_backbones(card):
    """The backbones at full width on the card, float32 and bfloat16:
    ms per clip (CUDA events, a batch of TSP_BATCH clips after a warm-up),
    peak memory and the bound; card f32 against CPU f32 on two clips and
    card bf16 against card f32 on the batch."""
    import torch
    from dvc_tpu_torch.models.tsp import FeatureExtractor
    from dvc_tpu_torch.models.tsp.backbones import MViTConfig
    from dvc_tpu_torch.data.video_clips import BACKBONE_INPUT
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    for name, config in TSP_BACKBONES:
        hw = BACKBONE_INPUT[name]['crop'][0]
        sd = noisy_tsp_model(name, 0, config).state_dict()
        x = torch.randn((TSP_BATCH, TSP_CLIP_LEN, hw, hw, 3), generator=gen,
                        device=DEVICE)
        feats, flops, count = {}, None, ''
        for dtype, peak in (('float32', F32_FLOP_PER_S),
                            ('bfloat16', BF16_FLOP_PER_S)):
            ex = FeatureExtractor(name, clip_len=TSP_CLIP_LEN, dtype=dtype,
                                  device=DEVICE, config=config, state_dict=sd)
            if flops is None:
                with ex.precision():
                    flops = counted_flops(
                        ex.model, x[:1].permute(0, 4, 1, 2, 3)) * TSP_BATCH
                count = f'flop counter {flops / 1e12:.3f} TFLOP'
                if name == 'mvit_v2_s':
                    table = 2 * mvit_macs(config or MViTConfig()) * TSP_BATCH
                    count = (f'block table {table / 1e12:.3f} TFLOP, '
                             f'{count}')
                    flops = table
            torch.cuda.reset_peak_memory_stats()
            feats[dtype] = ex.features(x)
            ms = cuda_ms(lambda: ex.features(x), 3)
            peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
            weights = sum(v.numel() * v.element_size()
                          for v in ex.model.state_dict().values())
            t_bytes = (nbytes(x) + weights + TSP_BATCH * ex.feat_dim * 4) \
                / HBM_BYTES_PER_S * 1e3
            t_ops = flops / peak * 1e3
            bound_ms, by = max((t_bytes, 'bytes'), (t_ops, 'operations'))
            print(f'[tsp] {name} {TSP_CLIP_LEN}x{hw}x{hw}, B={TSP_BATCH}, '
                  f'{dtype} ({card}): {ms:.2f} ms a batch, '
                  f'{ms / TSP_BATCH:.3f} ms a clip (CUDA events, mean of 3 '
                  f'after a warm-up); peak memory {peak_gib:.2f} GiB; '
                  f'2 x MACs: {count}; bound {bound_ms:.3f} ms ({by}, '
                  f'{peak / 1e12:.0f} TFLOP/s), {bound_ms / ms:.3f} of it')
            if name == 'mvit_v2_s' and dtype == 'bfloat16':
                tsp_kernel_classes(ex.model, x.to(torch.bfloat16)
                                   .permute(0, 4, 1, 2, 3), card)
                pool_layout_ab(ex, x, card)
            del ex
        cpu = FeatureExtractor(name, clip_len=TSP_CLIP_LEN, dtype='float32',
                               device='cpu', config=config, state_dict=sd)
        ref = cpu.features(x[:2].cpu())
        got = feats['float32'][:2].cpu()
        f32_err = float((got - ref).norm() / ref.norm())
        bf16_err = float((feats['bfloat16'] - feats['float32']).norm()
                         / feats['float32'].norm())
        print(f'[tsp] {name}: card f32 vs CPU f32 on 2 clips: relative L2 '
              f'{f32_err:.2e} (max abs {float((got - ref).abs().max()):.2e}, '
              f'tolerance {TSP_F32_TOL}); card bf16 vs card f32 on '
              f'{TSP_BATCH} clips: relative L2 {bf16_err:.2e} (tolerance '
              f'{TSP_BF16_TOL})')
        if not (f32_err <= TSP_F32_TOL and bf16_err <= TSP_BF16_TOL
                and torch.isfinite(feats['bfloat16']).all()):
            raise AssertionError(f'[tsp] {name} features disagree')
        del feats, x


def write_tsp_videos(root, prefix, n, seed, words, seconds=None):
    """n synthetic mp4v videos (160x120, 30 fps, ``seconds`` long: moving
    seeded colour ramps) in root, keyed ``prefix`` + 6 digits, and their
    annotations (3-10 captioned events each)."""
    import cv2
    import numpy as np
    rng = np.random.default_rng(seed)
    seconds = seconds or TSP_SECONDS
    os.makedirs(root, exist_ok=True)
    anno = {}
    ramp = np.arange(160)[None, :, None] + np.arange(120)[:, None, None]
    for v in range(n):
        key = f'{prefix}{v:06d}'
        w = cv2.VideoWriter(os.path.join(root, key + '.mp4'),
                            cv2.VideoWriter_fourcc(*'mp4v'), 30.0, (160, 120))
        base, speed = rng.integers(0, 255, 3), rng.integers(1, 6, 3)
        for i in range(int(seconds * 30)):
            w.write(((base + speed * i + ramp) % 255).astype(np.uint8))
        w.release()
        k = int(rng.integers(3, 11))
        starts = np.sort(rng.uniform(0, 0.8, k)) * seconds
        ends = np.minimum(starts + rng.uniform(0.05, 0.2, k) * seconds,
                          seconds)
        anno[key] = {'duration': float(seconds),
                     'timestamps': [[float(a), float(b)]
                                    for a, b in zip(starts, ends)],
                     'sentences': [' '.join(rng.choice(words, int(
                         rng.integers(3, 12)))) for _ in range(k)]}
    return anno


def tsp_extract(root, ckpt, backbone, card):
    """``python -m dvc_tpu_torch.extract_features`` on the card over three
    synthetic videos (bf16, its default), then on a fourth, of 3
    s (2 clips), in float32 on the card and on the CPU."""
    import numpy as np
    import torch
    from dvc_tpu_torch import extract_features
    write_tsp_videos(os.path.join(root, 'videos_a'), 'v_extra', 3, 20, ['w'])
    write_tsp_videos(os.path.join(root, 'videos_b'), 'v_extrb', 1, 21, ['w'],
                     seconds=3)
    flags = ['--local-checkpoint', ckpt, '--backbone', backbone,
             '--clip-len', str(TSP_CLIP_LEN)]
    t0 = time.perf_counter()
    written = extract_features.main(
        ['--video-dir', os.path.join(root, 'videos_a'), '--output-dir',
         os.path.join(root, 'features_a'), '--device', DEVICE] + flags)
    seconds = time.perf_counter() - t0
    shapes = [np.load(p).shape for p in written]
    print(f'[tsp] extract_features --backbone {backbone} --device {DEVICE} '
          f'(bf16) over 3 videos of '
          f'{TSP_SECONDS} s ({card}): {seconds:.2f} s (host clock, the '
          f'backbone\'s build and weights included), features {shapes}')
    if len(written) != 3 or not all(np.isfinite(np.load(p)).all()
                                    for p in written):
        raise AssertionError('[tsp] extract_features wrote no features')
    out = []
    for i, device in enumerate((DEVICE, 'cpu')):
        (path,) = extract_features.main(
            ['--video-dir', os.path.join(root, 'videos_b'), '--output-dir',
             os.path.join(root, f'features_b{i}'), '--device', device,
             '--dtype', 'float32'] + flags)
        out.append(torch.from_numpy(np.load(path)))
    err = float((out[0] - out[1]).norm() / out[1].norm())
    print(f'[tsp] extract_features --dtype float32 on a 3 s video, '
          f'{tuple(out[1].shape)}: --device {DEVICE} vs cpu relative L2 '
          f'{err:.2e} (tolerance {TSP_F32_TOL})')
    if err > TSP_F32_TOL:
        raise AssertionError('[tsp] the driver\'s card and CPU features '
                             'disagree')


@contextlib.contextmanager
def extractors_made():
    """Yields the list of every FeatureExtractor built in the body."""
    from dvc_tpu_torch.models.tsp import extractor as module
    made, init = [], module.FeatureExtractor.__init__

    def record(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    module.FeatureExtractor.__init__ = record
    try:
        yield made
    finally:
        module.FeatureExtractor.__init__ = init


def tsp_split(label, extractors, timer, seconds, card):
    ex = extractors[0]
    steps = {k: (timer.seconds[k], timer.calls[k]) for k in timer.seconds}
    print(f'[{label}] where the time goes ({card}, host clock; the parts '
          f'overlap: decode runs in a worker thread, the backbone in the '
          f'loader\'s): {ex.videos} videos, {ex.clips} clips featurized; '
          f'decode {ex.decode_seconds:.2f} s '
          f'({ex.decode_seconds / max(ex.videos, 1):.3f} s a video), '
          f'backbone {ex.backbone_seconds:.2f} s '
          f'({ex.backbone_seconds / max(ex.videos, 1):.3f} s a video, to the '
          f'features on the host); PDVC ' + ', '.join(
              f'{k} {s:.2f} s in {n} calls (synchronized)'
              for k, (s, n) in steps.items() if n)
          + f'; total {seconds:.2f} s')


def phase_tsp(tmp, card):
    """Phase 14: the TSP backbones at full width, the extraction driver,
    and a streaming run_train and run_eval at the yc2_tsp_mvit_ete
    recipe's full width, each check failing the run."""
    import torch
    from dvc_tpu_torch import run_train
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tsp_backbones(card)
    root = os.path.join(tmp, 'tsp')
    base = load_config(TSP_RECIPE, root=ROOT)
    config = dict(TSP_BACKBONES).get(base.backbone_tsp)
    ckpt = os.path.join(root, 'tsp.pth')
    os.makedirs(root)
    torch.save({'model': noisy_tsp_model(base.backbone_tsp, 3, config)
                .state_dict()}, ckpt)
    tsp_extract(root, ckpt, base.backbone_tsp, card)

    words = letter_words(base.vocab_size)
    vocab = os.path.join(root, 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'word_to_ix': {w: i for i, w in enumerate(words, 1)},
                   'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}},
                  f)
    videos = os.path.join(root, 'videos')
    paths = {}
    for split, prefix, n, seed in (('train', 'v_tsptr', TSP_TRAIN_VIDEOS, 0),
                                   ('val', 'v_tspvl', VAL_VIDEOS, 1)):
        anno = write_tsp_videos(videos, prefix, n, seed, words)
        paths[split] = os.path.join(root, f'{split}.json')
        with open(paths[split], 'w') as f:
            json.dump(anno, f)
    para = os.path.join(root, 'para_val.json')
    with open(para, 'w') as f:
        json.dump({k: ' '.join(v['sentences']) for k, v in anno.items()}, f)
    recipe = os.path.join(root, 'tsp.yml')
    with open(recipe, 'w') as f:
        json.dump({'base_cfg_path': TSP_RECIPE, 'id': 'tsp',
                   'save_dir': os.path.join(root, 'save'),
                   'train_caption_file': paths['train'],
                   'val_caption_file': paths['val'],
                   'gt_file_for_eval': [paths['val']],
                   'gt_file_for_para_eval': [para], 'dict_file': vocab,
                   'video_folder': videos, 'tsp_checkpoint': ckpt,
                   'invalid_video_json': [], 'epoch': 1}, f)
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', DEVICE],
                     root=ROOT)
    timer = CallTimer({'train_step': (Trainer, 'train_step', True),
                       'eval_step': (Trainer, 'eval_step', True)})
    reset_counts()
    t0 = time.perf_counter()
    with extractors_made() as made, timer:
        folder, losses = run_train.main(opt)
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    print(f'[tsp-train] run_train --streaming_features 1 --debug, '
          f'{TSP_RECIPE} ({opt.backbone_tsp} {opt.extraction_dtype} '
          f'features, {opt.enc_layers}+{opt.dec_layers} layers, '
          f'{opt.num_queries} queries, {opt.caption_decoder_type} head; '
          f'{card}): {seconds:.1f} s; mean losses {json.dumps(losses)}; '
          f'kernel launches {launches}, plain-version calls {plain}')
    if len(made) != 1 or not all(
            math.isfinite(v) for v in losses.values()):
        raise AssertionError(f'[tsp-train] {len(made)} extractors, losses '
                             f'{losses}')
    check_launches('tsp-train', launches, plain,
                   TRUNK + ('dsa_scan_fwd', 'dsa_scan_bwd', 'dsa_greedy'),
                   STEP_KERNELS)
    print(f'[tsp-train] validation of epoch 1: '
          f'{check_validation(folder, [1])}')
    tsp_split('tsp-train', made, timer, seconds, card)

    timer = CallTimer({'eval_step': (Trainer, 'eval_step', True)})
    with extractors_made() as made:
        path, scores, launches, plain, seconds = run_eval_counted(
            ['--eval_save_dir', folder, '--eval_batch_size', '16',
             '--eval_device', DEVICE], timer)
    check_eval_json(path, VAL_VIDEOS, scored=True)
    print(f'[tsp-eval] run_eval --eval_batch_size 16 of the streaming run '
          f'({card}): {seconds:.2f} s; '
          f'{", ".join(f"{k} {scores[k]:.4f}" for k in EVAL_SCORES)}; '
          f'kernel launches {launches}, plain-version calls {plain}')
    check_launches('tsp-eval', launches, plain, ('msda_fwd',),
                   ('msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd')
                   + STEP_KERNELS, exact={'dsa_greedy': 1})
    tsp_split('tsp-eval', made, timer, seconds, card)


# --------------------------------------------------------------------------
# 15. TSP training
# --------------------------------------------------------------------------

# (backbone, --dtype, --train-bn): the YC2 launcher's R(2+1)D-34, train_tsp's
# default MViTv2-S in float32 and bfloat16, and R(2+1)D-34 under --train-bn 1
TSP_TRAIN = (('r2plus1d_34', 'float32', 0), ('mvit_v2_s', 'float32', 0),
             ('mvit_v2_s', 'bfloat16', 0), ('r2plus1d_34', 'float32', 1))
TSP_TRAIN_BATCH = 32        # scripts/train_tsp_on_yc2.sh --batch-size
TSP_TRAIN_LRS = ('--backbone-lr', '0.0001', '--fc-lr', '0.002')  # its lrs
TSP_TRAIN_SEGMENTS = 32     # x 2 clips: two steps an epoch at B=32
TSP_VALID_SEGMENTS = 16     # one validation batch
TSP_TRAIN_SECONDS = 12
TSP_TRAIN_LOSS_TOL = 1e-4   # card f32 vs CPU f32, relative, each loss
TSP_TRAIN_PARAM_TOL = 1e-3  # the updated tensors, relative L2 each
TSP_TRAIN_CLASSES = (10, 2)


def write_tsp_gt(root, n_segments, seed):
    """A TSP groundtruth CSV of ``n_segments`` segments (1.5-4 s, four a
    synthetic 12 s video; action labels 0-9, every fifth a background
    segment: action -1, region 0)."""
    import csv
    import numpy as np
    prefix = f'v_tg{seed}'              # + 6 digits: a 13-character key
    write_tsp_videos(root, prefix, -(-n_segments // 4), seed, ['w'],
                     seconds=TSP_TRAIN_SECONDS)
    rng = np.random.default_rng(seed)
    path = os.path.join(root, f'{prefix}.csv')
    with open(path, 'w', newline='') as f:
        w = csv.DictWriter(f, fieldnames=[
            'filename', 'fps', 't-start', 't-end', 'video-duration',
            'action-label', 'temporal-region-label'])
        w.writeheader()
        for i in range(n_segments):
            t0 = float(rng.uniform(0, 8))
            bg = i % 5 == 4
            w.writerow({'filename': os.path.join(root,
                                                  f'{prefix}{i // 4:06d}.mp4'),
                        'fps': 30, 't-start': t0,
                        't-end': t0 + float(rng.uniform(1.5, 4)),
                        'video-duration': TSP_TRAIN_SECONDS,
                        'action-label': -1 if bg else int(rng.integers(10)),
                        'temporal-region-label': int(not bg)})
    return path


def tsp_train_opt(name, dtype, train_bn):
    """The options ``train_tsp`` gives TSPTrainer for the YC2 launcher's
    flags (two heads, its lrs, the default schedule at two steps an
    epoch)."""
    from dvc_tpu_torch.utils.config import load_config
    opt = load_config(backbone_tsp=name, tsp_num_classes=TSP_TRAIN_CLASSES,
                      tsp_num_heads=2, loss_alphas=[1.0, 1.0],
                      backbone_lr=1e-4, fc_lr=2e-3, momentum=0.9,
                      tsp_weight_decay=0.005, tsp_train_bn=train_bn,
                      tsp_dtype=dtype, tpu_mesh_data=1)
    opt.lr_milestones, opt.lr_gamma, opt.lr_warmup_iters = (8, 12), 0.01, 4
    return opt


def tsp_clip_batch(name, B, seed):
    """A train batch of B random clips at the backbone's crop and seeded
    labels (a few -1), pinned host tensors as the driver's."""
    import torch
    from dvc_tpu_torch.data.video_clips import BACKBONE_INPUT
    gen = torch.Generator().manual_seed(seed)
    hw = BACKBONE_INPUT[name]['crop'][0]
    batch = {'clip': torch.randn((B, TSP_CLIP_LEN, hw, hw, 3),
                                 generator=gen)}
    for i, n in enumerate(TSP_TRAIN_CLASSES):
        batch[f'label{i}'] = torch.randint(-1, n, (B,), generator=gen)
    return {k: v.pin_memory() if DEVICE != 'cpu' else v
            for k, v in batch.items()}


def tsp_train_step(name, dtype, train_bn, sd, card):
    """One train step at full width on the card at the launcher's B=32 (or
    the largest power of two that fits): ms a step (CUDA events, mean of 3
    after a warm-up), clips/s, peak memory and the bound (3 x the forward's
    operations, at 67 TFLOP/s f32 or 989 bf16; or the bytes of the clips
    and of 4 passes over the weights).  Returns the batch size."""
    import torch
    from dvc_tpu_torch.models.tsp.backbones import MViTConfig
    from dvc_tpu_torch.train.tsp_trainer import TSPTrainer
    trainer = TSPTrainer(tsp_train_opt(name, dtype, train_bn), DEVICE)
    B = TSP_TRAIN_BATCH
    while True:
        state = trainer.init_state(state_dict=sd)
        batch = tsp_clip_batch(name, B, 15)
        try:
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: trainer.train_step(state, batch, 10), 3)
            break
        except torch.cuda.OutOfMemoryError:
            del state, batch
            torch.cuda.empty_cache()
            if B == 1:
                raise
            B //= 2
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if name == 'mvit_v2_s':
        fwd = 2 * mvit_macs(MViTConfig())
    else:
        model = state['model'].eval()
        with trainer.precision():
            fwd = counted_flops(model, batch['clip'][:1].to(
                DEVICE, torch.float32).permute(0, 4, 1, 2, 3))
    flops = 3 * fwd * B
    peak_rate = BF16_FLOP_PER_S if dtype == 'bfloat16' else F32_FLOP_PER_S
    weights = sum(v.numel() * 4 for v in sd.values())
    t_bytes = (nbytes(batch['clip']) + 4 * weights) / HBM_BYTES_PER_S * 1e3
    bound_ms, by = max((t_bytes, 'bytes'),
                       (flops / peak_rate * 1e3, 'operations'))
    cut = '' if B == TSP_TRAIN_BATCH else (
        f' (B={TSP_TRAIN_BATCH} did not fit: cut to the largest power of '
        'two that does)')
    print(f'[tsp-train] {name} {TSP_CLIP_LEN}x'
          f'{batch["clip"].shape[2]}x{batch["clip"].shape[3]} --dtype {dtype} '
          f'--train-bn {train_bn}, B={B}{cut} ({card}): {ms:.2f} ms a train '
          f'step (CUDA events, mean of 3 after a warm-up; upload, forward, '
          f'backward, SGD), {B / ms * 1e3:.1f} clips/s; peak memory '
          f'{peak:.2f} GiB; 3 x forward {flops / 1e12:.3f} TFLOP; bound '
          f'{bound_ms:.3f} ms ({by}, {peak_rate / 1e12:.0f} TFLOP/s), '
          f'{bound_ms / ms:.3f} of it')
    del trainer, state, batch
    torch.cuda.empty_cache()
    return B


def tsp_one_step(name, dtype, train_bn, sd, batch, device, f64=False):
    """One train step from ``sd`` (``f64``: the float32 options run in
    float64, a referee on the CPU): (losses, floating state, momentum)."""
    import torch
    from dvc_tpu_torch.train.tsp_trainer import TSPTrainer
    trainer = TSPTrainer(tsp_train_opt(name, dtype, train_bn), device)
    state = trainer.init_state(state_dict=sd)
    if f64:
        trainer.dtype = torch.float64
        state['model'].double()
    # iteration 5: past the warmup, before the first milestone
    state, m = trainer.train_step(state, batch, 5)
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().cpu() for k, v in
             state['model'].state_dict().items() if v.is_floating_point()},
            {k: v.cpu() for k, v in trainer.momentum_buffers(state).items()})


def rel_errors(got, ref):
    """Each tensor's relative L2 distance from ``ref``'s."""
    return {k: float((got[k].double() - ref[k].double()).norm()
                     / ref[k].double().norm().clamp(min=1e-30)) for k in ref}


def tsp_train_agreement(name, dtype, train_bn, sd):
    """One step on a 2-clip batch from the same weights: float32 on the
    card (TF32 off) against the CPU (each loss, each updated tensor), and
    for a VideoResNet both against a float64 step on the CPU (the SGD
    momentum, i.e. the gradient: not gated); bfloat16 on the card against
    float32 on the card (the losses)."""
    batch = tsp_clip_batch(name, 2, 16)
    got, got_sd, got_g = tsp_one_step(name, dtype, train_bn, sd, batch,
                                      DEVICE)
    ref, ref_sd, ref_g = tsp_one_step(
        name, 'float32', train_bn, sd, batch,
        DEVICE if dtype == 'bfloat16' else 'cpu')
    loss_err = max(abs(got[k] - ref[k]) / abs(ref[k]) for k in ref)
    label = f'{name} --dtype {dtype} --train-bn {train_bn}'
    if dtype == 'bfloat16':
        print(f'[tsp-train] {label}: card bf16 vs card f32, one step on 2 '
              f'clips: losses within {loss_err:.2e} relative (tolerance '
              f'{TSP_BF16_TOL}); {got}')
        ok = loss_err <= TSP_BF16_TOL
    else:
        errs = rel_errors(got_sd, ref_sd)
        grads = rel_errors(got_g, ref_g)
        worst = max(errs, key=errs.get)
        worst_g = max(grads, key=grads.get)
        print(f'[tsp-train] {label}: card f32 (TF32 off) vs CPU f32, one '
              f'step on 2 clips: losses within {loss_err:.2e} relative '
              f'(tolerance {TSP_TRAIN_LOSS_TOL}); updated tensors within '
              f'{errs[worst]:.2e} relative L2 ({worst}; tolerance '
              f'{TSP_TRAIN_PARAM_TOL}); SGD momentum after the step (the '
              f'gradient + weight decay) within {grads[worst_g]:.2e} '
              f'relative L2 ({worst_g}; not gated)')
        if name != 'mvit_v2_s':
            g64 = tsp_one_step(name, 'float32', train_bn, sd, batch, 'cpu',
                               f64=True)[2]
            for side, g in (('card f32', got_g), ('CPU f32', ref_g)):
                e = rel_errors(g, g64)
                w = max(e, key=e.get)
                print(f'[tsp-train] {label}: {side} SGD momentum vs a '
                      f'float64 step on the CPU: within {e[w]:.2e} relative '
                      f'L2 ({w}), median tensor '
                      f'{sorted(e.values())[len(e) // 2]:.2e} (not gated)')
        ok = (loss_err <= TSP_TRAIN_LOSS_TOL
              and errs[worst] <= TSP_TRAIN_PARAM_TOL)
    if not (ok and all(math.isfinite(v) for v in got.values())):
        raise AssertionError(f'[tsp-train] {label}: the card and the '
                             f'reference disagree: {got} vs {ref}')


def tsp_train_driver(root, name, dtype, train_bn, B, gt, valid, card):
    """``python -m dvc_tpu_torch.train_tsp`` on the card: epoch 0 from the
    seeded weights (two steps, validated), then ``--resume`` from its
    ``tsp-last.pth`` for epoch 1, counters set to 0 before and read after
    (no kernel of K1-K10 lies on this path).  Returns the output folder."""
    from dvc_tpu_torch import train_tsp
    from dvc_tpu_torch.train.tsp_trainer import TSPTrainer
    out = os.path.join(root, f'{name}-{dtype}-bn{train_bn}')
    flags = ['--train-csv', gt, '--valid-csv', valid, '--backbone', name,
             '--clip-len', str(TSP_CLIP_LEN), '--batch-size', str(B),
             '--clips-per-segment', '2',
             *TSP_TRAIN_LRS, '--dtype', dtype, '--train-bn', str(train_bn),
             '--output-dir', out, '--device', DEVICE, '--print-freq', '0']
    timer = CallTimer({'train_step': (TSPTrainer, 'train_step', True),
                       'eval_step': (TSPTrainer, 'eval_step', True)})
    reset_counts()
    t0 = time.perf_counter()
    with timer:
        train_tsp.main(flags + ['--epochs', '1'])
        train_tsp.main(flags + ['--epochs', '2', '--resume',
                                os.path.join(out, 'tsp-last.pth')])
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    with open(os.path.join(out, 'metrics.jsonl')) as f:
        recs = [json.loads(line) for line in f]
    with open(os.path.join(out, 'results.txt')) as f:
        valid_lines = [l.strip() for l in f if l.startswith('** Valid')]
    print(f'[tsp-train] train_tsp --backbone {name} --dtype {dtype} '
          f'--train-bn {train_bn} --batch-size {B}, epoch 0 then --resume '
          f'for epoch 1 ({card}): {seconds:.1f} s (host clock, model builds '
          f'included); train_step {timer.seconds["train_step"]:.2f} s in '
          f'{timer.calls["train_step"]} calls, eval_step '
          f'{timer.seconds["eval_step"]:.2f} s in '
          f'{timer.calls["eval_step"]} calls (synchronized); epochs '
          + '; '.join(f'{r["epoch"]}: {json.dumps(r["train"])}, '
                      f'{r["clips_per_sec"]} clips/s (decode included), '
                      f'valid {r.get("valid_avg_accuracy")}' for r in recs)
          + f'; kernel launches {launches}, plain-version calls {plain}')
    for line in valid_lines:
        print(f'[tsp-train]   {line}')
    if (any(launches.values()) or plain or len(recs) != 2
            or len(valid_lines) != 2
            or [r['epoch'] for r in recs] != [0, 1]
            or not all(math.isfinite(v) for r in recs
                       for v in r['train'].values())
            or not os.path.exists(os.path.join(out, 'tsp-best.pth'))):
        raise AssertionError(f'[tsp-train] the {name} run failed: {recs}')
    return out


def phase_tsp_train(tmp, card):
    """Phase 15: TSP training at full width on the card, each check failing
    the run."""
    import gc
    import numpy as np
    import torch
    from dvc_tpu_torch import extract_features
    gc.collect()
    torch.cuda.empty_cache()            # the earlier phases' cached blocks
    root = os.path.join(tmp, 'tsp_train')
    os.makedirs(root)
    gt = write_tsp_gt(os.path.join(root, 'videos'), TSP_TRAIN_SEGMENTS, 30)
    valid = write_tsp_gt(os.path.join(root, 'videos'), TSP_VALID_SEGMENTS,
                         31)
    folders = {}
    for name, dtype, train_bn in TSP_TRAIN:
        sd = noisy_tsp_model(name, 0, num_classes=TSP_TRAIN_CLASSES,
                             num_heads=2).state_dict()
        B = tsp_train_step(name, dtype, train_bn, sd, card)
        tsp_train_agreement(name, dtype, train_bn, sd)
        folders[(name, dtype, train_bn)] = tsp_train_driver(
            root, name, dtype, train_bn, B, gt, valid, card)
        torch.cuda.empty_cache()
    best = os.path.join(folders[TSP_TRAIN[0]], 'tsp-best.pth')
    written = extract_features.main(
        ['--video-dir', os.path.join(root, 'videos'), '--output-dir',
         os.path.join(root, 'features'), '--local-checkpoint', best,
         '--backbone', TSP_TRAIN[0][0], '--device', DEVICE])
    shapes = {np.load(p).shape for p in written}
    print(f'[tsp-train] extract_features --local-checkpoint tsp-best.pth of '
          f'the {TSP_TRAIN[0][0]} run ({card}): {len(written)} videos, '
          f'features {sorted(shapes)}')
    if not written or not all(np.isfinite(np.load(p)).all()
                              for p in written):
        raise AssertionError('[tsp-train] extract_features did not read '
                             'the trained checkpoint')


# --------------------------------------------------------------------------
# 16. bf16
# --------------------------------------------------------------------------

BF16 = 'bfloat16'
BF16_FLAGS = ['--tpu_compute_dtype', BF16, '--fusion_dtype', BF16]
BF16_MARGIN = 1e-3    # a greedy step's top-2 logit margin that is no near-tie
# K4-K6-bf16 against their plain bf16 versions, as a share of how far the
# plain f32 version lies from those (forward outputs; each gradient of
# K5-bf16), and the least share of the plain bf16 version's distance from
# the plain f32 version at which a kernel's output lies from it.  Readings
# (H100, phase 16): forward 0.50-0.55, gradients 0.05-0.37, from f32
# 0.96-1.02 (PERF.md section 6).
BF16_FWD_SHARE, BF16_BWD_SHARE, BF16_ROUNDS = 0.75, 0.5, 0.5


def rel_l2(got, want):
    """Relative L2 distance of two tensors, in float64."""
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def bf16_bound(n_bytes, macs):
    """(least ms, what bounds it) of the same work on bf16 operands: the
    bytes over the HBM rate (``n_bytes`` counts each operand of a product
    at 2 bytes) and 2 x the MACs over the tensor cores' bf16 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * macs / BF16_FLOP_PER_S * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def bf16_bytes(args, operands, others=()):
    """Bytes of the inputs ``args``: the tensors at the indices
    ``operands`` (value and the weights: operands of products) at 2 bytes
    an element, the rest (positions, scales, biases, z) as stored, plus the
    tensors ``others`` (outputs) as stored."""
    import torch
    return (sum(t.numel() * (2 if i in operands else t.element_size())
                for i, t in enumerate(args) if torch.is_tensor(t))
            + nbytes(*others))


def greedy_divergence(tok, ref_tok, ok):
    """Share of the comparable (b, k, q) (``ok``) at or after a query's
    first token that differs from ``ref_tok``."""
    import torch
    diverged = ~torch.cumprod((tok == ref_tok).int(), dim=1).bool()
    return float((diverged & ok).sum()) / max(1, int(ok.sum()))


def check_greedy_bf16(gen, B, Q, H, K=30):
    """K6-bf16 against its plain bf16 version (the TPU kernel's bf16
    products, ``dsa_greedy_scan_ref(precision='bfloat16')``), held to how
    far that lies from the plain f32 version on the same inputs: on the
    (b, k, q) before a query's first plain-bf16 near-tie (top-2 margin
    under 1e-3), the share past a first differing token, and the log-probs'
    relative L2 where all three decodes agree, each at most BF16_FWD_SHARE
    of f32's.  And the kernel rounds: its log-probs lie at least
    BF16_ROUNDS of the plain bf16 version's distance from the plain f32
    version (a kernel that skipped the bf16 rounding would lie at f32
    noise from it, and at f32's distance from the plain bf16 version).
    The table form's plain mirror (``dsa_bf16.greedy_scan(table=True)``,
    what the kernel computes) is printed beside it; the f32 kernel is
    timed on the same inputs."""
    import torch
    from dvc_tpu_torch.ops import dsa_bf16
    from dvc_tpu_torch.ops.dsa_greedy import (dsa_greedy_scan,
                                              dsa_greedy_scan_ref)
    args = greedy_inputs(gen, B, Q, H)
    L = MSDA_LEVELS
    tok, lp = dsa_greedy_scan(*args, L, K, precision=BF16)
    ref_tok, ref_lp, margin = dsa_greedy_scan_ref(*args, L, K,
                                                  with_margin=True,
                                                  precision=BF16)
    f_tok, f_lp = dsa_greedy_scan_ref(*args, L, K)
    t_tok, t_lp = dsa_bf16.greedy_scan(*args, L, K, table=True)
    ok = torch.cumprod((margin > BF16_MARGIN).int(), dim=1).bool()
    div = {n: greedy_divergence(t, ref_tok, ok)
           for n, t in (('kernel', tok), ('f32', f_tok), ('mirror', t_tok))}
    same = ok & torch.cumprod(((tok == ref_tok) & (f_tok == ref_tok)
                               & (t_tok == ref_tok)).int(), dim=1).bool()
    dist = {n: rel_l2(x[same], ref_lp[same])
            for n, x in (('kernel', lp), ('f32', f_lp), ('mirror', t_lp))}
    mirror = rel_l2(lp[same], t_lp[same])
    rounds = (rel_l2(lp[same], f_lp[same]), rel_l2(ref_lp[same], f_lp[same]))
    ms = cuda_ms(lambda: dsa_greedy_scan(*args, L, K, precision=BF16), 3)
    f32_ms = cuda_ms(lambda: dsa_greedy_scan(*args, L, K), 3)
    plain_ms = cuda_ms(lambda: dsa_greedy_scan_ref(*args, L, K,
                                                   precision=BF16), 3)
    macs, n = greedy_macs(args, K)
    bound_ms, bound_by = bf16_bound(
        bf16_bytes(args, (0, 4, 5, 6, 8, 9, 11, 15, 16)) + 8 * n, macs)
    print(f'[bf16] dsa_greedy_bf16 B={B} Q={Q} H={H} K={K}: compared '
          f'{float(same.float().mean()):.3f} of (b,k,q); against the plain '
          f'bf16 version, diverged share kernel {div["kernel"]:.4f} / plain '
          f'f32 {div["f32"]:.4f} / table mirror {div["mirror"]:.4f}, lp '
          f'relative L2 kernel {dist["kernel"]:.3e} / plain f32 '
          f'{dist["f32"]:.3e} / table mirror {dist["mirror"]:.3e} (limit '
          f'{BF16_FWD_SHARE} x plain f32); kernel vs table mirror '
          f'{mirror:.3e}; lp relative L2 from the plain f32 version: kernel '
          f'{rounds[0]:.3e} / plain bf16 {rounds[1]:.3e} (at least '
          f'{BF16_ROUNDS} x); kernel bf16 {ms:.3f} ms, f32 '
          f'{f32_ms:.3f} ms, plain bf16 {plain_ms:.3f} ms, bound '
          f'{bound_ms:.4f} ms ({bound_by})')
    if (div['kernel'] > BF16_FWD_SHARE * div['f32']
            or dist['kernel'] > BF16_FWD_SHARE * dist['f32']
            or rounds[0] < BF16_ROUNDS * rounds[1]
            or float(same.float().mean()) < 0.5):
        raise AssertionError(f'dsa_greedy_bf16 B={B} H={H}: {div}, {dist}, '
                             f'from f32 {rounds}')
    return {'B': B, 'Q': Q, 'H': H,
            'max_abs_err': float((lp - ref_lp)[same].abs().max()),
            'ms': ms, 'f32_ms': f32_ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


def scan_positions_bf16(args, hs):
    """``scan_positions`` with the bf16 offsets of K4-bf16 and K5-bf16:
    base_pos + (bf16(h_{k-1}) . bf16(off_w)) * scale_t, in float64."""
    from dvc_tpu_torch.ops.dsa_bf16 import bf16
    rounded = list(args)
    rounded[4] = bf16(args[4])
    return scan_positions(rounded, bf16(hs))


def check_scan_bf16(gen, B, Q, K, H):
    """K4-bf16 and K5-bf16 against their plain bf16 versions
    (``dsa_bf16.scan_fwd`` / ``scan_bwd``, the TPU kernels' bf16 products;
    the backward on K4-bf16's trajectory), each held to how far that lies
    from the plain f32 version on the same inputs: hs and cs, and each of
    the 13 gradients (but d alpha_b, zero in exact arithmetic), in relative
    L2, the kernel's distance at most BF16_FWD_SHARE (forward) or
    BF16_BWD_SHARE (each gradient) of f32's; and each lies at least
    BF16_ROUNDS of the plain bf16 version's distance from the plain f32
    version, so the kernel rounds (``check_greedy_bf16``).  The cotangent is zero on
    the queries with a tap within an ulp of a level-relative integer on the
    kernel's trajectory (``near_integer`` of the bf16 positions), where the
    position's gradient jumps (ROADMAP C).  The table form's plain mirror
    is printed beside each; the f32 kernels are timed on the same inputs."""
    import torch
    from dvc_tpu_torch.ops import dsa_bf16
    from dvc_tpu_torch.ops.dsa_scan import (NAMES, dsa_teacher_scan_bwd,
                                            dsa_teacher_scan_bwd_ref,
                                            dsa_teacher_scan_fwd,
                                            dsa_teacher_scan_ref)
    args = scan_inputs(gen, B, Q, K, H)
    L = MSDA_LEVELS
    hs, cs = dsa_teacher_scan_fwd(*args, L, precision=BF16)
    ref_hs, ref_cs = dsa_teacher_scan_ref(*args, L, precision=BF16)
    f_hs, f_cs = dsa_teacher_scan_ref(*args, L)
    t_hs, _ = dsa_bf16.scan_fwd(*args, L, table=True)
    fwd = {n: max(rel_l2(a, ref_hs), rel_l2(b, ref_cs))
           for n, a, b in (('kernel', hs, cs), ('f32', f_hs, f_cs))}
    fwd['mirror'] = rel_l2(t_hs, ref_hs)
    fwd_rounds = (min(rel_l2(hs, f_hs), rel_l2(cs, f_cs)),
                  max(rel_l2(ref_hs, f_hs), rel_l2(ref_cs, f_cs)))
    near = near_integer(scan_positions_bf16(args, hs))
    g = torch.randn(hs.shape, generator=gen, device='cuda') \
        * (~near)[:, None, :, None]
    grads = dsa_teacher_scan_bwd(*args, L, hs, cs, g, precision=BF16)
    want = dsa_bf16.scan_bwd(*args, L, hs, cs, g)
    mirror = dsa_bf16.scan_bwd(*args, L, hs, cs, g, table=True)
    f32 = dsa_teacher_scan_bwd_ref(*args, L, f_hs, f_cs, g)
    bwd = {n: (rel_l2(a, w), rel_l2(f, w), rel_l2(m, w), rel_l2(a, f),
               rel_l2(w, f))
           for n, a, w, f, m in zip(NAMES, grads, want, f32, mirror)
           if n != 'ab'}
    worst = max(bwd, key=lambda n: bwd[n][0] / bwd[n][1])
    least = min(bwd, key=lambda n: bwd[n][3] / bwd[n][4])
    fwd_ms = cuda_ms(lambda: dsa_teacher_scan_fwd(*args, L, precision=BF16),
                     3)
    fwd_f32 = cuda_ms(lambda: dsa_teacher_scan_fwd(*args, L), 3)
    fwd_plain = cuda_ms(lambda: dsa_teacher_scan_ref(*args, L,
                                                     precision=BF16), 3)
    bwd_ms = cuda_ms(lambda: dsa_teacher_scan_bwd(*args, L, hs, cs, g,
                                                  precision=BF16), 3)
    bwd_f32 = cuda_ms(lambda: dsa_teacher_scan_bwd(*args, L, hs, cs, g), 3)
    bwd_plain = cuda_ms(lambda: dsa_bf16.scan_bwd(*args, L, hs, cs, g), 3)
    fwd_macs, bwd_macs = scan_macs(args)
    weights = (0, 4, 5, 7, 11, 12)          # value and the products' weights
    fwd_bound = bf16_bound(bf16_bytes(args, weights, (hs, cs)), fwd_macs)
    bwd_bound = bf16_bound(bf16_bytes(args, weights, (hs, cs, g, *grads)),
                           bwd_macs)
    print(f'[bf16] dsa_scan_fwd_bf16 B={B} Q={Q} K={K} H={H}: against the '
          f'plain bf16 version, hs/cs relative L2 kernel {fwd["kernel"]:.3e} '
          f'/ plain f32 {fwd["f32"]:.3e} / table mirror {fwd["mirror"]:.3e} '
          f'(limit {BF16_FWD_SHARE} x plain f32); from the plain f32 '
          f'version, kernel {fwd_rounds[0]:.3e} / plain bf16 '
          f'{fwd_rounds[1]:.3e} (at least {BF16_ROUNDS} x); '
          f'kernel bf16 {fwd_ms:.3f} ms, f32 {fwd_f32:.3f} ms, plain bf16 '
          f'{fwd_plain:.3f} ms, bound {fwd_bound[0]:.4f} ms ({fwd_bound[1]})')
    print(f'[bf16] dsa_scan_bwd_bf16 B={B} Q={Q} K={K} H={H}: '
          f'{int(near.sum())} queries near a tap boundary get a zero '
          f'cotangent; gradients against the plain bf16 backward, relative '
          f'L2 kernel / plain f32 / table mirror: '
          + ', '.join(f'{n} {a:.2e}/{f:.2e}/{m:.2e}'
                      for n, (a, f, m, _, _) in bwd.items())
          + f' (limit {BF16_BWD_SHARE} x plain f32); closest to its f32 '
          f'distance {worst}; from the plain f32 backward, kernel / plain '
          f'bf16: ' + ', '.join(f'{n} {k:.2e}/{w:.2e}'
                                for n, (_, _, _, k, w) in bwd.items())
          + f' (at least {BF16_ROUNDS} x), least {least}; kernel bf16 '
          f'{bwd_ms:.3f} ms, f32 {bwd_f32:.3f} ms, plain bf16 '
          f'{bwd_plain:.3f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})')
    if (fwd['kernel'] > BF16_FWD_SHARE * fwd['f32']
            or fwd_rounds[0] < BF16_ROUNDS * fwd_rounds[1]
            or bwd[worst][0] > BF16_BWD_SHARE * bwd[worst][1]
            or bwd[least][3] < BF16_ROUNDS * bwd[least][4]):
        raise AssertionError(f'dsa_scan_bf16 B={B} H={H}: forward {fwd} '
                             f'{fwd_rounds}, {worst} {bwd[worst]}, {least} '
                             f'{bwd[least]}')
    return ({'B': B, 'Q': Q, 'K': K, 'H': H,
             'max_abs_err': float((hs - ref_hs).abs().max()), 'ms': fwd_ms,
             'f32_ms': fwd_f32, 'plain_ms': fwd_plain,
             'bound_ms': fwd_bound[0], 'bound_by': fwd_bound[1]},
            {'B': B, 'Q': Q, 'K': K, 'H': H,
             'max_abs_err': max(float((a - w).abs().max()) for a, w in
                                zip(grads, want)), 'ms': bwd_ms,
             'f32_ms': bwd_f32, 'plain_ms': bwd_plain,
             'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1]})


def check_gemm_bf16(gen, rows, m, n, label):
    """dsa::gemm's bf16-operand mode (``dvc_dsa_gemm``'s bf16, the outer sums
    of K5-bf16 and K10-bf16) on one outer sum out (m, n) = X^T Y over bf16
    operands (torch.bfloat16, as K5-bf16 writes its rows): against the
    float64 product of the same values (their products are exact in f32,
    so what remains is the f32 accumulation), in units of its products
    within GEMM_PRODUCT_TOL; timed beside the f32 mode (3xTF32) on the same
    values in f32 and torch.matmul of the bf16 tensors (library_ms, a
    yardstick used nowhere).  Returns the result."""
    import torch
    X = torch.randn((rows, m), generator=gen, device='cuda').bfloat16()
    Y = torch.randn((rows, n), generator=gen, device='cuda').bfloat16()
    out = torch.empty((m, n), device='cuda')
    work = outer_sum_work(X, Y)
    run_outer_sum(X, Y, out, work, bf16=1)
    err = product_err(out, X.float().T, Y.float())
    abs_err = float((out.double() - X.double().T @ Y.double()).abs().max())
    ms = cuda_ms(lambda: run_outer_sum(X, Y, out, work, bf16=1), 10)
    Xf, Yf = X.float(), Y.float()
    f32_ms = cuda_ms(lambda: run_outer_sum(Xf, Yf, torch.empty_like(out),
                                           work), 10)
    library_ms = cuda_ms(lambda: torch.matmul(X.T, Y), 10)
    bound_ms, bound_by = bf16_bound(nbytes(X, Y, out), rows * m * n)
    print(f'[bf16] gemm_bf16 {label} ({rows} x {m})^T ({rows} x {n}): '
          f'in product units {err:.2e} (tol {GEMM_PRODUCT_TOL:.0e}); bf16 '
          f'mode {ms:.4f} ms, f32 mode (3xTF32) {f32_ms:.4f} ms, library '
          f'(torch.matmul, bf16) {library_ms:.4f} ms, bound {bound_ms:.4f} '
          f'ms ({bound_by})')
    if not err <= GEMM_PRODUCT_TOL:
        raise AssertionError(f'gemm_bf16 {label}: {err} in product units')
    return {'rows': rows, 'm': m, 'n': n, 'max_abs_err': abs_err, 'ms': ms,
            'f32_ms': f32_ms, 'library_ms': library_ms, 'bound_ms': bound_ms,
            'bound_by': bound_by}


def bf16_kernels():
    """K6-bf16 at the serving shapes (B=16 and B=1, Q=100, cap_nheads 1
    and 8) and K4-bf16 / K5-bf16 at the training shapes (Q=90, K=29: B=1
    and B=16 at H=1, B=1 at H=8).  Returns {'<kernel>_bf16': [result per
    shape]}."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        for label, rows, m, n, _ in OUTER_SUMS:
            check_gemm_bf16(gen, rows, m, n, label)
        res = {'dsa_greedy_bf16': [check_greedy_bf16(gen, B, 100, H)
                                   for B, H in ((16, 1), (16, 8), (1, 1),
                                                (1, 8))]}
    scans = [check_scan_bf16(gen, B, 90, 29, H)
             for B, H in ((1, 1), (16, 1), (1, 8))]
    res['dsa_scan_fwd_bf16'] = [f for f, _ in scans]
    res['dsa_scan_bwd_bf16'] = [b for _, b in scans]
    return res


def bf16_opt(opt):
    """A copy of ``opt`` with --tpu_compute_dtype and --fusion_dtype
    bfloat16."""
    import copy
    opt = copy.deepcopy(opt)
    opt.tpu_compute_dtype = opt.fusion_dtype = BF16
    return opt


def bf16_serve(opt, tmp, card):
    """A B=16 request set through ``DenseCaptioner.caption_batch`` with
    seeded weights at full width, bf16 and f32 in turns (f32, bf16, bf16,
    f32; host clock, 3 batches each after a warm-up): 16 results of
    well-formed events, and in the bf16 runs K1/K2 (f32) and K6-bf16
    launched, no f32 K6, no plain version; then one batch of each traced
    (device busy time, window, activities).  Returns the bf16 launches of
    one timed batch."""
    import numpy as np
    import torch
    rng = np.random.default_rng(5)
    C = opt.feature_dim
    feats = [rng.standard_normal((int(n), C)).astype(np.float32)
             for n in rng.integers(60, 400, 16)]
    sounds = [rng.standard_normal(f.shape).astype(np.float32) for f in feats]
    durs = [float(d) for d in rng.uniform(10, 300, 16)]
    dcs = {'f32': make_captioner(opt, tmp), 'bf16':
           make_captioner(bf16_opt(opt), tmp)}
    times, launches = {'f32': [], 'bf16': []}, None
    for name in ('f32', 'bf16', 'bf16', 'f32'):
        dc = dcs[name]
        dc.caption_batch(feats, durs, sound_list=sounds)      # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            results = dc.caption_batch(feats, durs, sound_list=sounds)
        torch.cuda.synchronize()
        times[name].append((time.perf_counter() - t0) / 3 * 1e3)
        counts, plain = read_counts()
        if len(results) != 16:
            raise AssertionError(f'{len(results)} results for 16 requests')
        for events, dur in zip(results, durs):
            check_events(events, dur)
        if name == 'bf16':
            check_launches('bf16-serve', counts, plain,
                           ('msda_fwd', 'dsa_greedy_bf16'),
                           ('dsa_greedy',) + STEP_KERNELS + STEP_KERNELS_BF16)
            launches = {k: v // 3 for k, v in counts.items()}
    traces = {name: trace(f'B=16 {name} caption_batch',
                          lambda dc=dc: dc.caption_batch(feats, durs,
                                                         sound_list=sounds))
              for name, dc in dcs.items()}
    print(f'[bf16] B=16 caption_batch ({card}), host clock, ms per batch '
          f'in the order f32, bf16, bf16, f32: f32 '
          f'{times["f32"][0]:.1f} / {times["f32"][1]:.1f}, bf16 '
          f'{times["bf16"][0]:.1f} / {times["bf16"][1]:.1f}; traced batch, '
          f'device busy / window ms, device activities: '
          + ', '.join(f'{n} {t.get("busy_ms", 0):.3f} / '
                      f'{t.get("window_ms", 0):.3f}, {t.get("activities", 0)}'
                      for n, t in traces.items())
          + f'; 16 results, first "{results[0][0]["sentence"][:40]}..."; '
          f'bf16 launches a batch {launches}')
    return launches


def bf16_train(tmp, card):
    """``new_train.main --debug`` (5 steps at B=1, then the validation of 6
    val videos) with the bf16 flags on a synthetic full-width run: finite
    losses, K1-K3 (f32) and K4-bf16, K5-bf16 and K6-bf16 launched, no f32
    K4-K6, no word-step kernel, no plain version; the train step at B=1 and
    B=16 in bf16 and f32 in turns; the card against the CPU on one step
    (``bf16_train_agreement``).  Returns (launches, opt, run folder,
    recipe)."""
    import math
    import torch
    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    root = os.path.join(tmp, 'bf16')
    os.makedirs(root)
    recipe = write_synthetic_run(root, load_config(CFG, root=ROOT))
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', DEVICE,
                      *BF16_FLAGS], root=ROOT)
    reset_counts()
    t0 = time.perf_counter()
    folder, losses = train_main(opt)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    print(f'[bf16] new_train.main --debug {" ".join(BF16_FLAGS)}, B=1: '
          f'{seconds:.1f} s; mean losses '
          f'{json.dumps({k: round(v, 4) for k, v in losses.items()})}; '
          f'kernel launches {launches}, plain-version calls {plain}')
    if not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f'bf16 train losses not finite: {losses}')
    check_launches('bf16-train', launches, plain,
                   ('msda_fwd', 'msda_bwd', 'dsa_scan_fwd_bf16',
                    'dsa_scan_bwd_bf16', 'dsa_greedy_bf16'),
                   ('dsa_scan_fwd', 'dsa_scan_bwd', 'dsa_greedy')
                   + STEP_KERNELS + STEP_KERNELS_BF16)
    ms, traces = {}, {}
    for dtype in ('f32', 'bf16', 'bf16', 'f32'):
        o = opt if dtype == 'bf16' else parse_opts(
            ['--cfg_path', recipe, '--debug', '--device', DEVICE], root=ROOT)
        trainer = Trainer(o, device=DEVICE)
        for B, reps in ((1, 5), (16, 3)):
            batch = train_batch(o, B)
            ms.setdefault((dtype, B), []).append(
                time_steps(trainer, batch, o.lr, reps)[0])
            if B == 16 and dtype not in traces:
                traces[dtype] = trace(
                    f'B=16 {dtype} train step',
                    lambda: trainer.train_step(batch, o.lr))
        del trainer
    print(f'[bf16] train step ({card}), host clock ms after a warm-up, in '
          f'the order f32, bf16, bf16, f32: '
          + '; '.join(f'B={B} {d} ' + ' / '.join(f'{t:.1f}' for t in ms[d, B])
                      for B in (1, 16) for d in ('f32', 'bf16'))
          + '; traced B=16 step, device busy / window ms: '
          + ', '.join(f'{d} {t.get("busy_ms", float("nan")):.1f} / '
                      f'{t.get("window_ms", float("nan")):.1f}'
                      for d, t in traces.items()))
    bf16_train_agreement(opt, parse_opts(
        ['--cfg_path', recipe, '--device', DEVICE], root=ROOT))
    return launches, opt, folder, recipe


BF16_LOSS_GROUPS = ('loss_caption', 'loss_ce', 'loss_bbox', 'loss_giou',
                    'loss_counter')
# bf16_train_agreement's limits on a parameter's card-to-CPU gradient
# distance: BF16_GRAD_SHARE x the larger of its f32 and its f32-noise
# distances, plus BF16_GRAD_FLOOR
BF16_GRAD_SHARE, BF16_GRAD_FLOOR = 3.0, 1e-3


def bf16_step_grads(opt, dev, batch, weights, table=False, noise=None):
    """One train step of ``opt``'s model (seed 0, dropout off) on ``dev``
    and ``batch``: (losses, {loss group: {parameter: gradient}}, {loss
    group: gradient of the decoder's initial reference logits (Nq,)},
    the count of channels whose maximum over the queries, which the count
    head pools, is tied, summed over the decoder layers), one backward
    per group of BF16_LOSS_GROUPS (each loss times its weight), the
    gradients on the CPU.  ``table``: the CPU's bf16 caption
    scan and word steps in the card kernels' table form (``dsa_bf16``'s
    ``table=True``).
    ``noise``: a generator that moves each input feature by about an f32
    ulp (a relative normal draw of 2^-23)."""
    import functools
    import torch
    from dvc_tpu_torch.models import make_fusion_model
    from dvc_tpu_torch.ops import dsa_bf16
    model = make_fusion_model(opt, dev, seed=0).train()
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    if noise is not None:
        for k in ('video_tensor', 'sound_tensor'):
            tb[k] = tb[k] * (1 + 2.0 ** -23 * torch.randn(tb[k].shape,
                                                          generator=noise))
    tb = {k: v.to(dev) for k, v in tb.items()}
    refs = []

    def keep(module, inputs, out):
        out.retain_grad()
        refs.append(out)

    ties = []

    def count_ties(module, inputs, out):
        hs = out.detach()
        ties.append(int(((hs == hs.amax(dim=1, keepdim=True)).sum(1) > 1)
                        .sum()))

    hooks = [model.pdvcModel.transformer.reference_points
             .register_forward_hook(keep)] + [
        layer.register_forward_hook(count_ties)
        for layer in model.pdvcModel.transformer.decoder.layers]
    plain = ('scan_fwd', 'scan_bwd', 'sample_attend_fwd', 'sample_attend_bwd',
             'lstm_step_fwd', 'lstm_step_bwd')
    saved = {n: getattr(dsa_bf16, n) for n in plain}
    if table:
        for n, fn in saved.items():
            setattr(dsa_bf16, n, functools.partial(fn, table=True))
    try:
        _, losses = model.forward_train(tb)
        params = dict(model.named_parameters())
        grads, ref_grads = {}, {}
        prev = {n: 0.0 for n in params}
        prev_ref = 0.0
        for group in BF16_LOSS_GROUPS:
            loss = sum(losses[k] * w for k, w in weights.items()
                       if k.startswith(group) and k in losses and w)
            if torch.is_tensor(loss):
                loss.backward(retain_graph=True)
            now = {n: p.grad.cpu().clone() for n, p in params.items()
                   if p.grad is not None}
            grads[group] = {n: g - prev[n] for n, g in now.items()}
            prev.update(now)
            ref = (refs[0].grad.cpu().flatten().clone()
                   if refs[0].grad is not None else prev_ref)
            ref_grads[group] = ref - prev_ref
            prev_ref = ref
    finally:
        for n, fn in saved.items():
            setattr(dsa_bf16, n, fn)
        for hook in hooks:
            hook.remove()
    return ({k: float(v.detach()) for k, v in losses.items()}, grads,
            ref_grads, sum(ties))


def bf16_train_agreement(opt, opt32):
    """One bf16 train step (``opt``) on the card against the same step on
    the CPU, same weights and batch, dropout off, all on the CPU bf16
    step's matching (bf16 rounding flips Hungarian near-ties more often
    than f32's ulps do, ROADMAP C; whether the card's own matching agreed
    is printed, not gated).  The CPU runs the step four ways: bf16 with
    the TPU kernels' rounding points (the plain bf16 versions: the
    reference), the same on input features moved by about an f32 ulp
    (how far f32-sized differences, such as the card's other summation
    orders, carry through bf16 rounding: ``noise``), bf16 with the card
    kernels' table form (``dsa_bf16``'s ``table=True``), and f32 (how far
    bf16 rounding moves each gradient).  Gates: every loss within 1e-2
    relative; each parameter's card-to-CPU gradient distance (relative
    L2, alpha_net's bias, zero in exact arithmetic, floored at 5e-5 as in
    ``check_scan``) at most BF16_GRAD_SHARE x the larger of its f32 and
    noise distances + BF16_GRAD_FLOOR; the median over the parameters of
    card over f32 distance at most 1.5; and the card rounds: all its
    gradients together lie from the f32 step at least BF16_ROUNDS of the
    CPU bf16 step's distance.  Printed for the parameters closest to
    their limit: each loss group's share of the gap, and the decoder's
    initial reference logits' gradient per query."""
    import math
    import torch
    from dvc_tpu_torch.models import criterion
    from dvc_tpu_torch.models.criterion import build_weight_dict
    from dvc_tpu_torch.train import bucket_caption_length
    batch = bucket_caption_length(train_batch(opt, 1))
    weights = build_weight_dict(opt)
    real, pinned, own = criterion.hungarian_match, [], []

    def record(*args):
        pinned.append(real(*args))
        return pinned[-1]

    def replay(*args):
        own.append(real(*args).cpu())
        return pinned[(len(own) - 1) % len(pinned)].to(args[1].device)

    runs, card_own = {}, None
    for name, o, dev, table, noise in (
            ('cpu', opt, 'cpu', False, None),
            ('noise', opt, 'cpu', False, torch.Generator().manual_seed(1)),
            ('table', opt, 'cpu', True, None),
            ('card', opt, DEVICE, False, None),
            ('f32', opt32, 'cpu', False, None)):
        criterion.hungarian_match = record if name == 'cpu' else replay
        try:
            runs[name] = bf16_step_grads(o, dev, batch, weights, table, noise)
        finally:
            criterion.hungarian_match = real
        if name == 'card':
            card_own = list(own)
        own.clear()
    total = {k: {n: sum(g[n] for g in r[1].values()) for n in r[1][
        BF16_LOSS_GROUPS[0]]} for k, r in runs.items()}
    cl, cg = runs['cpu'][0], total['cpu']
    agree = all(torch.equal(a, b) for a, b in zip(card_own, pinned))
    loss_errs = {k: max(abs(r[0][n] - cl[n]) / max(abs(cl[n]), 1e-6)
                        for n in cl) for k, r in runs.items() if k != 'cpu'}
    loss_err = loss_errs['card']

    def dist(a, b, n):
        floor = 5e-5 if n.endswith('alpha_net.bias') else 1e-5
        return float((a[n] - b[n]).norm() / (b[n].norm() + floor / 1e-3))

    d = {k: {n: dist(total[k], cg, n) for n in cg}
         for k in total if k != 'cpu'}
    limit = {n: BF16_GRAD_SHARE * max(d['f32'][n], d['noise'][n])
             + BF16_GRAD_FLOOR for n in cg}
    ranked = sorted(cg, key=lambda n: d['card'][n] / limit[n], reverse=True)
    q = sorted(d['card'][n] / max(d['f32'][n], 1e-3) for n in cg)
    median = q[len(q) // 2]

    def rms(x):
        return math.sqrt(sum(v ** 2 for v in x) / len(x))

    together = {k: rms(d[k].values()) for k in d}
    rounds = (rms([dist(total['card'], total['f32'], n) for n in cg]),
              together['f32'])
    print(f'[bf16-train-agreement] card vs CPU, one bf16 B=1 step on the '
          f'CPU\'s matching (the card\'s own identical {agree}, not gated): '
          f'worst loss relative error {loss_err:.2e} (tol 1e-2; '
          + ', '.join(f'{k} {v:.2e}' for k, v in loss_errs.items()
                      if k != 'card')
          + f'); gradients\' '
          f'relative L2 from the CPU bf16 step, RMS over {len(cg)} '
          f'parameters: ' + ', '.join(f'{k} {v:.3e}'
                                      for k, v in together.items())
          + f'; card / f32 ratio quantiles 0.1/0.5/0.9 {q[len(q) // 10]:.3f}/'
          f'{median:.3f}/{q[9 * len(q) // 10]:.3f} (median tol 1.5); from '
          f'the f32 step, card {rounds[0]:.3e} / CPU bf16 {rounds[1]:.3e} '
          f'(at least {BF16_ROUNDS} x); per parameter at most '
          f'{BF16_GRAD_SHARE} x max(f32, noise) + {BF16_GRAD_FLOOR}, '
          f'closest: {ranked[0]} {d["card"][ranked[0]]:.3e} of '
          f'{limit[ranked[0]]:.3e}')
    bias = 'pdvcModel.transformer.reference_points.bias'
    for n in ranked[:3] + [bias] * (bias not in ranked[:3]):
        print(f'[bf16-train-agreement]   {n} |grad| '
              f'{float(cg[n].norm()):.3e}; from the CPU bf16 step: '
              + ', '.join(f'{k} {d[k][n]:.2e}' for k in d)
              + '; by loss group, |run - CPU| for ' + '/'.join(d)
              + ' (|CPU|): ' + ', '.join(
                  f'{g[5:]} ' + '/'.join(
                      f'{float((runs[k][1][g][n] - runs["cpu"][1][g][n]).norm()):.1e}'
                      for k in d)
                  + f' ({float(runs["cpu"][1][g][n].norm()):.1e})'
                  for g in BF16_LOSS_GROUPS))
    refs = {k: sum(r[2].values()) for k, r in runs.items()}
    print('[bf16-train-agreement]   the initial reference logits\' gradient '
          '(Nq), |run - CPU| / |CPU|: '
          + ', '.join(f'{k} {float((refs[k] - refs["cpu"]).norm()):.2e}'
                      for k in d)
          + f' / {float(refs["cpu"].norm()):.2e}; its sum (the bias\' '
          f'gradient) ' + ', '.join(f'{k} {float(v.sum()):.4e}'
                                     for k, v in refs.items())
          + '; channels tied at the count head\'s maximum over the '
          'queries, all decoder layers: '
          + ', '.join(f'{k} {r[3]}' for k, r in runs.items()))
    if (loss_err > 1e-2 or sorted(total['card']) != sorted(cg)
            or d['card'][ranked[0]] > limit[ranked[0]] or median > 1.5
            or rounds[0] < BF16_ROUNDS * rounds[1]):
        raise AssertionError('card and CPU disagree on the bf16 train step')


def bf16_eval(folder, card):
    """``run_eval`` on the bf16 run's folder at --eval_batch_size 16 (the
    run's saved options carry the bf16 flags): K1/K2 (f32) a trunk layer
    and one K6-bf16 a batch, no f32 K6, finite scores.  Returns the
    launches."""
    from dvc_tpu_torch.serve import run_options
    ropt = run_options(folder)
    if (ropt.tpu_compute_dtype, ropt.fusion_dtype) != (BF16, BF16):
        raise AssertionError('the run did not save the bf16 flags')
    batches = -(-VAL_VIDEOS // 16)
    path, scores, launches, plain, seconds = run_eval_counted(
        ['--eval_save_dir', folder, '--eval_batch_size', '16',
         '--eval_device', DEVICE])
    check_eval_json(path, VAL_VIDEOS, scored=True)
    print(f'[bf16] run_eval --eval_batch_size 16 of the bf16 run ({card}): '
          f'{seconds:.2f} s; '
          f'{", ".join(f"{k} {scores[k]:.4f}" for k in EVAL_SCORES)}; '
          f'kernel launches {launches}, plain-version calls {plain}')
    check_launches('bf16-eval', launches, plain, ('msda_fwd',),
                   ('dsa_greedy', 'msda_bwd', 'dsa_scan_fwd_bf16')
                   + STEP_KERNELS + STEP_KERNELS_BF16,
                   {'dsa_greedy_bf16': batches})
    return launches


def check_table_bf16(gen, N, k, n, label):
    """The table GEMM's bf16-operand mode (``table_gemm`` /
    ``table_gemm_bwd`` at precision='bfloat16', on bf16 tensors as the
    caption head's ``ValueTable`` hands them over: VW = bf16(value) .
    bf16(Wc) of K7-K10-bf16, once per stepwise forward pass, and its
    backward bf16(G) . bf16(Wc)^T and bf16(value)^T bf16(G), once per
    backward pass) against the float64 products of the bf16-rounded
    operands (their plain versions), in units of their products within
    GEMM_PRODUCT_TOL; timed beside the f32 mode (3xTF32) on the same inputs
    and torch.matmul of the bf16 operands (library_ms of the forward, a
    yardstick used nowhere; no single call computes the backward's two
    products).  Returns the forward's and the backward's results."""
    import torch
    from dvc_tpu_torch.ops.dsa_bf16 import bf16
    from dvc_tpu_torch.ops.dsa_tables import (table_gemm, table_gemm_bwd,
                                              table_gemm_bwd_ref,
                                              table_gemm_ref)
    x = torch.randn((N, k), generator=gen, device='cuda')
    w = torch.randn((k, n), generator=gen, device='cuda') / k ** 0.5
    g = torch.randn((N, n), generator=gen, device='cuda')
    xb, wb, gb = bf16(x), bf16(w), bf16(g)
    # the operands as the caption head hands them to the table's GEMMs:
    # value_t, cw and G rounded once each, in torch.bfloat16
    xh, wh, gh = x.bfloat16(), w.bfloat16(), g.bfloat16()
    got = table_gemm(xh, wh, BF16)
    dx, dw = table_gemm_bwd(xh, wh, gh, BF16)
    errs = (product_err(got, xb, wb), product_err(dx, gb, wb.T),
            product_err(dw, xb.T, gb))
    rounds = (rel_l2(got, x @ w), rel_l2(dw, x.T @ g))
    ms = cuda_ms(lambda: table_gemm(xh, wh, BF16), 20)
    f32_ms = cuda_ms(lambda: table_gemm(x, w), 20)
    plain_ms = cuda_ms(lambda: table_gemm_ref(x, w, BF16), 20)
    library_ms = cuda_ms(lambda: torch.matmul(xh, wh), 20)
    bwd_ms = cuda_ms(lambda: table_gemm_bwd(xh, wh, gh, BF16), 20)
    bwd_f32 = cuda_ms(lambda: table_gemm_bwd(x, w, g), 20)
    bwd_plain = cuda_ms(lambda: table_gemm_bwd_ref(x, w, g, BF16), 20)
    fwd_bound = bf16_bound(2 * (x.numel() + w.numel()) + nbytes(got),
                           N * k * n)
    bwd_bound = bf16_bound(2 * (x.numel() + w.numel() + g.numel())
                           + nbytes(dx, dw), 2 * N * k * n)
    print(f'[bf16] table_gemm_bf16 {label} ({N} x {k}) . ({k} x {n}): in '
          f'product units {errs[0]:.2e} (tol {GEMM_PRODUCT_TOL:.0e}), '
          f'relative L2 from the f32 product {rounds[0]:.2e}; bf16 mode '
          f'{ms:.4f} ms, f32 mode (3xTF32) {f32_ms:.4f} ms, plain bf16 '
          f'{plain_ms:.4f} ms, library (torch.matmul, bf16) '
          f'{library_ms:.4f} ms, bound {fwd_bound[0]:.4f} ms '
          f'({fwd_bound[1]})')
    print(f'[bf16] table_gemm_bwd_bf16 {label}: dx, dw in product units '
          f'{errs[1]:.2e}, {errs[2]:.2e} (tol {GEMM_PRODUCT_TOL:.0e}), dw '
          f'relative L2 from the f32 product {rounds[1]:.2e}; bf16 mode '
          f'{bwd_ms:.4f} ms, f32 mode {bwd_f32:.4f} ms, plain bf16 '
          f'{bwd_plain:.4f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})')
    # rounding bf16's operands moves a product by ~2^-9 of itself
    if not max(errs) <= GEMM_PRODUCT_TOL or min(rounds) < 1e-4:
        raise AssertionError(f'table_gemm_bf16 {label}: {errs}, {rounds}')
    abs_err = max(float((a - b).abs().max()) for a, b in
                  ((got, xb.double() @ wb.double()),
                   (dx, gb.double() @ wb.double().T),
                   (dw, xb.double().T @ gb.double())))
    return ({'N': N, 'k': k, 'n': n, 'max_abs_err': abs_err, 'ms': ms,
             'f32_ms': f32_ms, 'plain_ms': plain_ms,
             'library_ms': library_ms, 'bound_ms': fwd_bound[0],
             'bound_by': fwd_bound[1]},
            {'N': N, 'k': k, 'n': n, 'max_abs_err': abs_err, 'ms': bwd_ms,
             'f32_ms': bwd_f32, 'plain_ms': bwd_plain, 'library_ms': None,
             'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1]})


# K9/K10-bf16's gradients in the table form against the product form:
# nearer than the plain f32 version (a single step's table form lies from
# the product form at up to 0.85 of f32's distance, value_t's gradient;
# the scan's sum over K steps at up to 0.37, PERF.md section 6)
BF16_STEP_GAP = 1.0
# the word-step kernels against the plain form that computes their rounding
# points (K7/K8-bf16: the product form; K9/K10-bf16: the table mirror): the
# outputs within BF16_MIRROR_FWD and each gradient within BF16_MIRROR_BWD of
# the plain f32 version's distance from the mirror (read on an H100 for the
# table form: outputs at most 2e-3 x, gradients 8.4e-2 x, cw's, whose
# bf16(G) flips where f32 sums differ in the last bit); and
# K7's ctx and K8's and K10's dpos and dhvec, which JAX leaves unrounded
# for the f32 products outside the kernels, with at most BF16_EXACT_MAX of
# their nonzero elements on a bf16 value (an f32 sum lands on one with odds
# of about 2^-16; a rounded output, every time)
BF16_MIRROR_FWD, BF16_MIRROR_BWD, BF16_EXACT_MAX = 0.1, 0.2, 0.01


def bf16_exact_share(x):
    """The share of x's nonzero elements that bf16 holds exactly."""
    from dvc_tpu_torch.ops.dsa_bf16 import bf16
    nz = x != 0
    return float(((bf16(x) == x) & nz).sum()) / max(int(nz.sum()), 1)


def check_step_bf16(gen, B, Q, H, lstm):
    """K7-bf16 and K8-bf16 (or, with ``lstm``, K9-bf16 and K10-bf16)
    against their plain bf16 versions (``dsa_bf16``'s word steps) at the
    JAX boundary, each held to how far the plain f32 version lies from it:
    the output(s) and each gradient (but d alpha_b) in relative L2.  The
    mirror is the form the kernels compute: K7/K8-bf16 the product form
    (the TPU kernels' bf16 products) itself, K9/K10-bf16 the table form
    (``table=True``).  Against the mirror the limits are BF16_MIRROR_FWD
    (the output(s)) and BF16_MIRROR_BWD (each gradient) of f32's distance,
    and K7's ctx and the backward kernel's dpos and dhvec must not be
    rounded to bf16 (``bf16_exact_share`` at most BF16_EXACT_MAX); against
    the product form K9/K10-bf16 at most BF16_FWD_SHARE of f32's forward
    and BF16_STEP_GAP of it for each gradient; and the kernel lies at
    least BF16_ROUNDS of the product form's distance from f32 (the kernel
    rounds).  K7-bf16 and K8-bf16 take value_t in bf16 and Wc packed once
    for both (``attend16_kernel_args``), and K8-bf16 returns the 7
    gradients at the JAX boundary itself (``dsa_sample_attend_grads``
    calls it); K9-bf16 and K10-bf16 take value_t rounded to bf16, VW from
    the table's bf16 mode and the gate weights packed once for both
    (``bf16_kernel_args``), their 12 gradients at the JAX boundary
    composed with the table's bf16 backward (``dsa_lstm_step_grads``).  The
    cotangent is zero on the queries with a tap within an ulp of a
    level-relative integer (``near_integer``), where the position's
    gradient jumps.  Times: the kernels alone in bf16, the f32 ones (VW
    given) on the same inputs, and the plain bf16 version (the product
    form).  Returns the forward's and the backward's results."""
    import torch
    from dvc_tpu_torch.ops import dsa_bf16
    from dvc_tpu_torch.ops import dsa_step as ds
    args = step_inputs(gen, B, Q, H, lstm)
    L = MSDA_LEVELS
    if lstm:
        kind, names = 'dsa_lstm', ds.LSTM_NAMES
        fwd, bwd = ds.dsa_lstm_step_fwd, ds.dsa_lstm_step_bwd
        pf, pb = dsa_bf16.lstm_step_fwd, dsa_bf16.lstm_step_bwd
        ref, bwd_ref = ds.lstm_step_ref, ds.lstm_step_bwd_ref
        grads_of = ds.dsa_lstm_step_grads
    else:
        kind, names = 'dsa_step', ds.STEP_NAMES
        fwd, bwd = ds.dsa_sample_attend_fwd, ds.dsa_sample_attend_bwd
        pf, pb = dsa_bf16.sample_attend_fwd, dsa_bf16.sample_attend_bwd
        ref, bwd_ref = ds.sample_attend_ref, ds.sample_attend_bwd_ref
        grads_of = ds.dsa_sample_attend_grads

    def tup(x):
        return x if isinstance(x, tuple) else (x,)

    # the kernels' own operands and packs: K7/K8-bf16 (value16, no VW, the
    # rest without cw) and the Wc pack; K9/K10-bf16 (value_t, VW, the rest
    # without cw) and the gate pack.  The mirror: the form they compute
    Dh = args[0].shape[-1]
    kargs, kw = (bf16_kernel_args(args, lstm) if lstm
                 else attend16_kernel_args(args))
    kargs32 = kernel_args(args, lstm)
    outs = tup(fwd(*kargs, L, precision=BF16, **kw))
    want = tup(pf(*args, L))
    mirror = tup(pf(*args, L, table=True)) if lstm else want
    mname = 'table mirror' if lstm else 'product form (the kernels\' own)'
    f32 = tup(ref(*args, L))
    fwd_d = {n: max(rel_l2(a, w) for a, w in zip(x, want))
             for n, x in (('kernel', outs), ('f32', f32), ('mirror', mirror))}
    fwd_d['kernel-mirror'] = max(rel_l2(a, m) for a, m in zip(outs, mirror))
    fwd_d['f32-mirror'] = min(rel_l2(f, m) for f, m in zip(f32, mirror))
    fwd_rounds = (min(rel_l2(a, f) for a, f in zip(outs, f32)),
                  max(rel_l2(w, f) for w, f in zip(want, f32)))
    keep = ~near_integer(args[1].double())                 # (B, Q)
    mask = keep[:, :, None] if lstm else keep[:, None, :, None]
    cot = tuple(torch.randn(o.shape, generator=gen, device='cuda') * mask
                for o in outs)
    grads = grads_of(*args, L, *cot, precision=BF16)
    kgrads = bwd(*kargs, L, *cot, precision=BF16, **kw)
    # the outputs that stay f32: K7's ctx, the kernel's dpos and dhvec
    # (K10's in the order of its operands, K8-bf16's in JAX's)
    ip = 2 if lstm else 1
    exact = {'dpos': bf16_exact_share(kgrads[ip]),
             'dhvec': bf16_exact_share(kgrads[ip + 1])}
    if not lstm:
        exact['ctx'] = bf16_exact_share(outs[0])
    wgrads = pb(*args, L, *cot)
    mgrads = pb(*args, L, *cot, table=True) if lstm else wgrads
    fgrads = bwd_ref(*args, L, *cot)
    # per gradient: kernel, f32, table mirror against the product form;
    # kernel, product form against f32; kernel, f32 against the mirror
    bwd_d = {n: (rel_l2(a, w), rel_l2(f, w), rel_l2(m, w), rel_l2(a, f),
                 rel_l2(w, f), rel_l2(a, m), rel_l2(f, m))
             for n, a, w, f, m in zip(names, grads, wgrads, fgrads, mgrads)
             if n != 'ab'}
    worst = max(bwd_d, key=lambda n: bwd_d[n][0] / bwd_d[n][1])
    least = min(bwd_d, key=lambda n: bwd_d[n][3] / bwd_d[n][4])
    off = max(bwd_d, key=lambda n: bwd_d[n][5] / bwd_d[n][6])
    fwd_ms = cuda_ms(lambda: fwd(*kargs, L, precision=BF16, **kw), 20)
    fwd_f32 = cuda_ms(lambda: fwd(*kargs32, L), 20)
    fwd_plain = cuda_ms(lambda: pf(*args, L), 5)
    bwd_ms = cuda_ms(lambda: bwd(*kargs, L, *cot, precision=BF16, **kw), 20)
    bwd_f32 = cuda_ms(lambda: bwd(*kargs32, L, *cot), 20)
    bwd_plain = cuda_ms(lambda: pb(*args, L, *cot), 5)
    if lstm:
        # value_t, ctx_w3 and w_hh enter products (2 bytes); VW is the
        # table's f32 output, lerped
        macs, narrow, pack = word_step_macs(args, lstm, table_given=True), \
            (0, 7, 8), ()
    else:
        # value16 and the Wc pack (bf16), the step's own tensors as stored
        macs, narrow, pack = attend16_macs(args), (), (kw['pack'],)
    fwd_bound = bf16_bound(bf16_bytes(kargs, narrow, (*outs, *pack)), macs)
    bwd_bound = bf16_bound(bf16_bytes(kargs, narrow, (*cot, *kgrads, *pack)),
                           3 * macs)
    shape = (f'B={B} Q={Q} H={H} Dh={Dh} S=375 LP=16 A=512'
             + (' R=512, VW given' if lstm else ', value16 and the Wc pack '
                'given'))
    print(f'[bf16] {kind}_fwd_bf16 {shape}: against the plain bf16 version, '
          f'relative L2 kernel {fwd_d["kernel"]:.3e} / plain f32 '
          f'{fwd_d["f32"]:.3e} / {mname} {fwd_d["mirror"]:.3e} (limit '
          f'{BF16_FWD_SHARE} x plain f32); against the {mname}, '
          f'kernel {fwd_d["kernel-mirror"]:.3e} / plain f32 '
          f'{fwd_d["f32-mirror"]:.3e} (limit {BF16_MIRROR_FWD} x); on a bf16 '
          f'value: ' + ', '.join(f'{k} {v:.1e}' for k, v in exact.items())
          + f' of the nonzero elements (at most {BF16_EXACT_MAX}); from the '
          f'plain f32 version, kernel '
          f'{fwd_rounds[0]:.3e} / plain bf16 {fwd_rounds[1]:.3e} (at least '
          f'{BF16_ROUNDS} x); kernel bf16 {fwd_ms:.4f} ms, f32 {fwd_f32:.4f} '
          f'ms, plain bf16 {fwd_plain:.4f} ms, bound {fwd_bound[0]:.4f} ms '
          f'({fwd_bound[1]})')
    print(f'[bf16] {kind}_bwd_bf16 {shape}: {int((~keep).sum())} queries '
          f'near a tap boundary get a zero cotangent; gradients against the '
          f'plain bf16 backward, relative L2 kernel / plain f32 / '
          f'{mname} (kernel vs mirror): '
          + ', '.join(f'{n} {a:.2e}/{f:.2e}/{m:.2e} ({km:.1e})'
                      for n, (a, f, m, _, _, km, _) in bwd_d.items())
          + f' (limit {BF16_STEP_GAP} x plain f32); closest to its f32 '
          f'distance {worst} {bwd_d[worst][0] / bwd_d[worst][1]:.2f} x; '
          f'against the {mname}, kernel / plain f32 at most '
          f'{bwd_d[off][5] / bwd_d[off][6]:.1e} x ({off}; limit '
          f'{BF16_MIRROR_BWD} x); from the plain f32 backward, kernel / '
          f'plain bf16: ' + ', '.join(f'{n} {a:.2e}/{w:.2e}' for n, (
              _, _, _, a, w, _, _) in bwd_d.items())
          + f' (at least {BF16_ROUNDS} x), least {least}; kernel bf16 '
          f'{bwd_ms:.4f} ms, f32 {bwd_f32:.4f} ms, plain bf16 '
          f'{bwd_plain:.4f} ms, bound {bwd_bound[0]:.4f} ms ({bwd_bound[1]})')
    if (fwd_d['kernel'] > BF16_FWD_SHARE * fwd_d['f32']
            or fwd_d['kernel-mirror'] > BF16_MIRROR_FWD * fwd_d['f32-mirror']
            or fwd_rounds[0] < BF16_ROUNDS * fwd_rounds[1]
            or bwd_d[worst][0] > BF16_STEP_GAP * bwd_d[worst][1]
            or bwd_d[off][5] > BF16_MIRROR_BWD * bwd_d[off][6]
            or bwd_d[least][3] < BF16_ROUNDS * bwd_d[least][4]
            or max(exact.values()) > BF16_EXACT_MAX):
        raise AssertionError(f'{kind}_bf16 B={B} H={H}: forward {fwd_d} '
                             f'{fwd_rounds}, {worst} {bwd_d[worst]}, {off} '
                             f'{bwd_d[off]}, {least} {bwd_d[least]}, on a '
                             f'bf16 value {exact}')
    return ({'B': B, 'Q': Q, 'H': H,
             'max_abs_err': max(float((a - w).abs().max())
                                for a, w in zip(outs, want)),
             'ms': fwd_ms, 'f32_ms': fwd_f32, 'plain_ms': fwd_plain,
             'bound_ms': fwd_bound[0], 'bound_by': fwd_bound[1]},
            {'B': B, 'Q': Q, 'H': H,
             'max_abs_err': max(float((a - w).abs().max())
                                for a, w in zip(grads, wgrads)),
             'ms': bwd_ms, 'f32_ms': bwd_f32, 'plain_ms': bwd_plain,
             'bound_ms': bwd_bound[0], 'bound_by': bwd_bound[1]})


# the stepwise path's kernel shapes in bf16: the train step's (B=1, Q=90)
# and a serving batch's (B=16, Q=100), at cap_nheads 1 (the recipe's) and 8
STEP_BF16_SHAPES = ((1, 90, 1), (16, 100, 1), (16, 100, 8), (1, 90, 8))


def bf16_step_kernels():
    """The table GEMM's bf16 mode and K7-bf16 to K10-bf16 at
    STEP_BF16_SHAPES (``check_table_bf16``, ``check_step_bf16``).
    Returns {'<kernel>_bf16': [result per shape]}, the first shape
    first."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(16)
    res = {}
    with torch.inference_mode():
        for B, _, H in STEP_BF16_SHAPES:
            f, b = check_table_bf16(gen, B * H * 375, 512 // H, 512,
                                    f'value . Wc, B={B} H={H}')
            res.setdefault('table_gemm_bf16', []).append(f)
            res.setdefault('table_gemm_bwd_bf16', []).append(b)
    for lstm in (False, True):
        kind = 'dsa_lstm' if lstm else 'dsa_step'
        for B, Q, H in STEP_BF16_SHAPES:
            f, b = check_step_bf16(gen, B, Q, H, lstm)
            res.setdefault(f'{kind}_fwd_bf16', []).append(f)
            res.setdefault(f'{kind}_bwd_bf16', []).append(b)
    return res


# the stepwise bf16 train runs: (label, flags, epochs, the word-step pair
# that runs); the scheduled-sampling run trains epoch 0 on the fused scan
# (ss_prob 0) and epoch 1 stepwise at SS_PROB
BF16_STEPWISE_RUNS = (
    ('unfused', ['--dsa_scan_fuse', '0', '--dsa_greedy_fuse', '0'], 1,
     False),
    ('lstm_fuse', ['--dsa_scan_fuse', '0', '--dsa_greedy_fuse', '0',
                   '--dsa_lstm_fuse', '1'], 1, True),
    ('scheduled_sampling', ['--scheduled_sampling_start', '0',
                            '--basic_ss_prob', str(SS_PROB)], 2, False))


def bf16_stepwise_train(recipe, card):
    """``new_train.main --debug`` with the bf16 flags on the stepwise caption
    routes of BF16_STEPWISE_RUNS (5 train steps an epoch at B=1, a
    validation each epoch), with the counts set to 0 just before each run
    and read just after: finite losses; the run's word-step pair in its
    bf16 mode (K7-bf16/K8-bf16, or K9-bf16/K10-bf16) as often forward as
    backward launched, the table's bf16 mode with K9/K10-bf16 only (K7/K8-bf16
    compute the product form: no table launch); no f32 word-step or table
    launch, none of the other pair, no plain version; the unfused runs
    validate through the bf16 word steps (K9/K10: one table a val batch),
    the scheduled-sampling run trains epoch 0 on K4-bf16/K5-bf16 (5 each),
    epoch 1 stepwise on K7/K8-bf16, feeds sampled tokens and validates on
    K6-bf16.  Returns {label: (launches, opt, run folder)}."""
    import math
    import torch
    from dvc_tpu_torch.models.caption_heads import DSACaptionHead
    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.train import ss_prob_for_epoch
    from dvc_tpu_torch.utils.config import parse_opts
    runs = {}
    for label, flags, epochs, lstm in BF16_STEPWISE_RUNS:
        opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', DEVICE,
                          *BF16_FLAGS, *flags], root=ROOT)
        opt.epoch = epochs        # the recipe file's epoch (1) overlays it
        fwd, bwd = STEPWISE[lstm]
        other = STEPWISE[not lstm]
        reset_counts()
        DSACaptionHead.fed_samples.clear()
        t0 = time.perf_counter()
        folder, losses = train_main(opt)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches, plain = read_counts()
        fed = DSACaptionHead.fed_sample_count()
        print(f'[bf16-stepwise] new_train.main --debug {" ".join(flags)} '
              f'--epoch {epochs} with the bf16 flags, B=1: {seconds:.1f} s; '
              f'mean losses '
              f'{json.dumps({k: round(v, 4) for k, v in losses.items()})}; '
              f'kernel launches {launches}, plain-version calls {plain}, '
              f'scheduled-sampling tokens fed {fed}')
        if not all(math.isfinite(v) for v in losses.values()):
            raise AssertionError(f'bf16 stepwise train losses: {losses}')
        tables = ('table_gemm_bf16', 'table_gemm_bwd_bf16')
        want = ('msda_fwd', 'msda_bwd', f'{fwd}_bf16') + tables * lstm
        zero = STEP_KERNELS + (f'{other[0]}_bf16', f'{other[1]}_bf16',
                               'dsa_scan_fwd', 'dsa_scan_bwd',
                               'dsa_greedy') + tables * (not lstm)
        f, b = launches[f'{fwd}_bf16'], launches[f'{bwd}_bf16']
        if epochs == 1:
            # 5 train steps, then the validation's stepwise decodes: more
            # forward launches than backward ones, a table a val batch
            check_launches(f'bf16-stepwise {label}', launches, plain, want,
                           zero + ('dsa_scan_fwd_bf16', 'dsa_scan_bwd_bf16',
                                   'dsa_greedy_bf16'),
                           {'table_gemm_bwd_bf16': 5} if lstm else {})
            ok = b >= 5 and f > b and (
                launches['table_gemm_bf16'] > 5 or not lstm)
        else:
            assert [ss_prob_for_epoch(opt, e) for e in (0, 1)] == \
                [0.0, SS_PROB]
            check_launches(f'bf16-stepwise {label}', launches, plain,
                           want + ('dsa_greedy_bf16',), zero,
                           {'dsa_scan_fwd_bf16': 5, 'dsa_scan_bwd_bf16': 5})
            ok = b >= 5 and f == b and fed > 0
        if not ok:
            raise AssertionError(f'[bf16-stepwise {label}] launches '
                                 f'{launches}, tokens fed {fed}')
        runs[label] = (launches, opt, folder)
    return runs


def bf16_stepwise_eval(folder, card):
    """``run_eval`` at --eval_batch_size 16 of the unfused bf16 run (its
    saved options: --dsa_greedy_fuse 0 and the bf16 flags), greedy and with
    --caption_sample_max 0: max_caption_len K7-bf16 launches a batch and no
    table (K7-bf16 computes the product form), no K6 of either mode, no f32
    word step, no plain version, finite scores."""
    from dvc_tpu_torch.serve import run_options
    ropt = run_options(folder)
    if (ropt.tpu_compute_dtype, ropt.dsa_greedy_fuse) != (BF16, 0):
        raise AssertionError('the run did not save its flags')
    batches = -(-VAL_VIDEOS // 16)
    for extra in ([], ['--caption_sample_max', '0']):
        path, scores, launches, plain, seconds = run_eval_counted(
            ['--eval_save_dir', folder, '--eval_batch_size', '16',
             '--eval_device', DEVICE, *extra])
        check_eval_json(path, VAL_VIDEOS, scored=True)
        print(f'[bf16-stepwise] run_eval --eval_batch_size 16 '
              f'{" ".join(extra)} of the --dsa_greedy_fuse 0 run ({card}): '
              f'{seconds:.2f} s; '
              f'{", ".join(f"{k} {scores[k]:.4f}" for k in EVAL_SCORES)}; '
              f'kernel launches {launches}, plain-version calls {plain}')
        check_launches('bf16-stepwise-eval', launches, plain, ('msda_fwd',),
                       ('dsa_greedy', 'dsa_greedy_bf16', 'msda_bwd')
                       + STEP_KERNELS + ('dsa_step_bwd_bf16',
                                         'dsa_lstm_fwd_bf16',
                                         'dsa_lstm_bwd_bf16',
                                         'table_gemm_bf16',
                                         'table_gemm_bwd_bf16'),
                       {'dsa_step_fwd_bf16': ropt.max_caption_len * batches})


def bf16_stepwise(recipe, card):
    """The stepwise caption routes in bf16 (phase 16's second part): the
    train runs (``bf16_stepwise_train``); the B=16 train step through
    K7/K8 (--dsa_scan_fuse 0) in f32 and bf16 in turns (f32, bf16, bf16,
    f32; host clock) and one step of each traced (device time, device
    activities, idle share); one traced bf16 step through K9/K10-bf16 at
    B=1 and B=16 (``lstm_fuse_step_traces``); one bf16 step of the K7/K8
    route on the card against the CPU (``bf16_train_agreement``); ``run_eval`` of the unfused
    run greedy and sampled (``bf16_stepwise_eval``).  Returns the launches
    of the kernels line: K7/K8-bf16 from the unfused run, K9/K10-bf16 from
    the lstm_fuse run, the tables' from both (the unfused run's: none)."""
    import torch
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import parse_opts
    runs = bf16_stepwise_train(recipe, card)
    opts = {d: parse_opts(['--cfg_path', recipe, '--device', DEVICE,
                           '--dsa_scan_fuse', '0']
                          + (BF16_FLAGS if d == 'bf16' else []), root=ROOT)
            for d in ('f32', 'bf16')}
    ms, traces = {}, {}
    for dtype in ('f32', 'bf16', 'bf16', 'f32'):
        o = opts[dtype]
        trainer = Trainer(o, device=DEVICE)
        batch = train_batch(o, 16)
        ms.setdefault(dtype, []).append(time_steps(trainer, batch, o.lr,
                                                   2)[0])
        if dtype not in traces:
            traces[dtype] = trace(
                f'B=16 {dtype} stepwise train step (K7/K8)',
                lambda: trainer.train_step(batch, o.lr))
        del trainer
    print(f'[bf16-stepwise] B=16 train step through K7/K8 '
          f'(--dsa_scan_fuse 0, {word_steps(train_batch(opts["f32"], 16))} '
          f'word steps; {card}), host clock ms after a warm-up, in the order '
          f'f32, bf16, bf16, f32: '
          + '; '.join(f'{d} ' + ' / '.join(f'{t:.1f}' for t in ms[d])
                      for d in ('f32', 'bf16'))
          + '; traced step, device busy / window ms, device activities, '
          'idle share: '
          + ', '.join(f'{d} {t.get("busy_ms", float("nan")):.1f} / '
                      f'{t.get("window_ms", float("nan")):.1f}, '
                      f'{t.get("activities", 0)}, '
                      f'{t.get("idle", float("nan")):.3f}'
                      for d, t in traces.items()))
    lstm = lstm_fuse_step_traces(recipe)
    print(f'[bf16-stepwise] traced bf16 --dsa_lstm_fuse 1 train step '
          f'(K9/K10-bf16; {card}), device busy ms, device activities, idle '
          f'share: ' + ', '.join(f'{k[15:]} {v:.4g}' for k, v in lstm.items()))
    bf16_train_agreement(opts['bf16'], opts['f32'])
    bf16_stepwise_eval(runs['unfused'][2], card)
    unfused, fused = runs['unfused'][0], runs['lstm_fuse'][0]
    return {**{k: unfused[k] for k in ('dsa_step_fwd_bf16',
                                       'dsa_step_bwd_bf16')},
            **{k: fused[k] for k in ('dsa_lstm_fwd_bf16',
                                     'dsa_lstm_bwd_bf16')},
            **{k: unfused[k] + fused[k] for k in ('table_gemm_bf16',
                                                  'table_gemm_bwd_bf16')}}


def phase_bf16(tmp, card):
    """Phase 16 (``--bf16`` runs it alone): the bf16 kernels against their
    plain versions (``bf16_kernels``, ``bf16_step_kernels``), a bf16 B=16
    caption_batch (``bf16_serve``), five bf16 train steps, the step times
    and the card's agreement with the CPU (``bf16_train``), run_eval of
    that run (``bf16_eval``), then the stepwise routes
    (``bf16_stepwise``).  Returns (kernel results, launches: K4-bf16 and
    K5-bf16 from the train run, K6-bf16 from run_eval, K7-bf16 to K10-bf16
    and the table's from the stepwise runs)."""
    from dvc_tpu_torch.utils.config import load_config
    t0 = time.perf_counter()
    kernels = bf16_kernels()
    kernels.update(bf16_step_kernels())
    t1 = time.perf_counter()
    bf16_serve(load_config(CFG, root=ROOT), tmp, card)
    train_launches, _, folder, recipe = bf16_train(tmp, card)
    eval_launches = bf16_eval(folder, card)
    t2 = time.perf_counter()
    step_launches = bf16_stepwise(recipe, card)
    print(f'[bf16] phase 16 in {time.perf_counter() - t0:.1f} s: the kernel '
          f'checks {t1 - t0:.1f} s, the fused routes {t2 - t1:.1f} s, the '
          f'stepwise routes {time.perf_counter() - t2:.1f} s')
    launches = {'dsa_scan_fwd_bf16': train_launches['dsa_scan_fwd_bf16'],
                'dsa_scan_bwd_bf16': train_launches['dsa_scan_bwd_bf16'],
                'dsa_greedy_bf16': eval_launches['dsa_greedy_bf16'],
                **step_launches}
    return kernels, launches


# --------------------------------------------------------------------------
# 17. inputs: the reference's checkpoints, native feature IO, HuBERT
# --------------------------------------------------------------------------

# the plain recipe whose reference .pth phase 17 serves (phase 13's (a))
REF_PLAIN = 'standard'
# phase 10's B=16 collation in PR 20's full run, before the native
# library (NVIDIA H100 80GB HBM3, 700.00 W; host clock, one sample)
PR20_COLLATION_MS = 73.5
HUBERT_SECONDS = (1.0, 3.0)      # the card-vs-CPU segments
HUBERT_TOL = 1e-4                # relative L2, f32 with TF32 off
HUBERT_CLIP = 16 / 15            # s: a TSP clip, 16 frames at 15 fps
AUDIO_VIDEOS = 16
AUDIO_SR = 44100


def reference_pth(state_dict, fusion, input_type, extra=None):
    """A port ``state_dict`` as the reference's trainers save it: under
    'model' beside 'epoch' and 'optimizer', every key behind ``module.``,
    with the tensors the reference saves but never uses (the caption
    sampler's attention weights and output projection, the decoder's
    ``bbox_head`` aliases, the dormant ``reference_points`` / ``pos_trans``
    branch, ``enc_output``, a NewModel's HuBERT ``sound_model.*``) and
    ``extra``."""
    import torch
    pre = 'pdvcModel.' if fusion else ''
    dead = {}
    for k, v in state_dict.items():
        if k.endswith('core.deformable_att.sampling_offsets.weight'):
            base = k[:-len('sampling_offsets.weight')]
            d = v.shape[1]
            for name, rows in (('attention_weights', v.shape[0] // 2),
                               ('output_proj', d)):
                dead[f'{base}{name}.weight'] = torch.zeros(rows, d)
                dead[f'{base}{name}.bias'] = torch.zeros(rows)
        if k.startswith(pre + 'bbox_head.'):
            dead[pre + 'transformer.decoder.' + k[len(pre):]] = v
    d = state_dict[pre + 'transformer.level_embed'].shape[1]
    if input_type == 'gt_proposals':
        dormant = {'transformer.reference_points.weight': (1, d),
                   'transformer.reference_points.bias': (1,)}
    else:
        dormant = {'transformer.pos_trans.weight': (2 * d, 2 * d),
                   'transformer.pos_trans.bias': (2 * d,),
                   'transformer.pos_trans_norm.weight': (2 * d,),
                   'transformer.pos_trans_norm.bias': (2 * d,)}
    dormant['transformer.enc_output.weight'] = (d, d)
    dead.update({pre + k: torch.zeros(s) for k, s in dormant.items()})
    if fusion:
        dead['sound_model.feature_extractor.conv_layers.0.conv.weight'] = \
            torch.zeros(512, 1, 10)
    model = {f'module.{k}': v
             for k, v in {**state_dict, **dead, **(extra or {})}.items()}
    return {'model': model, 'epoch': 1,
            'optimizer': {'state': {}, 'param_groups': [{'lr': 5e-5}]}}


def serve_counted(dc, feats, durations, sounds=None):
    """``dc.caption_batch`` with the counts set to 0 just before and read
    just after, and the model's raw output of that call: (events,
    launches, plain calls, output, ms by CUDA events)."""
    captured = {}
    hook = dc.model.register_forward_hook(
        lambda m, args, out: captured.update(out))
    try:
        reset_counts()
        events, ms = event_ms(lambda: dc.caption_batch(
            feats, durations, sound_list=sounds))
        launches, plain = read_counts()
    finally:
        hook.remove()
    return events, launches, plain, captured, ms


def serving_batch(opt, seed, fusion):
    """16 requests: clip features of 60-400 frames, durations, and (for a
    FusionPDVC) sound features of every other video."""
    import numpy as np
    rng = np.random.default_rng(seed)
    C = opt.feature_dim
    feats = [rng.standard_normal((int(n), C)).astype(np.float32)
             for n in rng.integers(60, 400, 16)]
    durations = [float(d) for d in rng.uniform(10, 300, 16)]
    sounds = ([rng.standard_normal((len(f), C)).astype(np.float32)
               if i % 2 == 0 else None for i, f in enumerate(feats)]
              if fusion else None)
    return feats, durations, sounds


def reference_checkpoints(tmp, card):
    """The flagship FusionPDVC and ``cfgs/yc2_tsp_pdvc.yml``'s plain PDVC,
    seeded weights at full width, saved as the reference saves them
    (:func:`reference_pth`) and as the port saves them: each file served
    for one B=16 batch through ``DenseCaptioner`` (K1/K2 and one K6, no
    word-step kernel, no plain version), the tokens and log-probs of the
    reference's file bitwise those of the port's; ``run_eval
    --eval_checkpoint_path`` on the reference's file at B=16 over the 16
    val videos (one K6); a file with one unknown key raises.  Returns the
    FusionPDVC served from the reference's file."""
    import torch
    from dvc_tpu_torch.models import make_fusion_model, make_pdvc_model
    from dvc_tpu_torch.serve import DenseCaptioner, load_weights
    from dvc_tpu_torch.utils.config import load_config, parse_opts
    no_step = STEP_KERNELS + ('table_gemm', 'table_gemm_bwd')
    served = None
    for label, fusion in (('fusion', True), ('plain', False)):
        if fusion:
            root = os.path.join(tmp, 'ref_fusion')
            recipe = write_synthetic_run(root, load_config(CFG, root=ROOT))
            opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE],
                             root=ROOT)
        else:
            opt = write_plain_run(tmp, REF_PLAIN)
            root = os.path.join(tmp, f'plain_{REF_PLAIN}')
        make = make_fusion_model if fusion else make_pdvc_model
        sd = make(opt, 'cpu', seed=0).state_dict()
        paths = {'port': os.path.join(root, 'model-best.pth'),
                 'reference': os.path.join(root, 'reference.pth'),
                 'unknown key': os.path.join(root, 'unknown.pth')}
        torch.save({'model': sd, 'epoch': 1}, paths['port'])
        ref = reference_pth(sd, fusion, opt.transformer_input_type)
        extra = len(ref['model']) - len(sd)
        torch.save(ref, paths['reference'])
        del ref
        bad_key = ('pdvcModel.' if fusion else '') + 'query_embed.extra'
        torch.save(reference_pth(sd, fusion, opt.transformer_input_type,
                                 extra={bad_key: torch.zeros(3)}),
                   paths['unknown key'])
        with open(os.path.join(root, 'info.json'), 'w') as f:
            json.dump({'best': {'epoch': 1, 'opt': opt.to_dict()}}, f)
        feats, durations, sounds = serving_batch(opt, 7, fusion)
        outs = {}
        for name in ('port', 'reference'):
            dc = DenseCaptioner(opt=opt, state_dict=load_weights(paths[name]),
                                device=DEVICE)
            events, launches, plain, out, ms = serve_counted(
                dc, feats, durations, sounds)
            for ev, dur in zip(events, durations):
                check_events(ev, dur)
            check_launches(f'inputs-{label}', launches, plain,
                           ('msda_fwd',), no_step, exact={'dsa_greedy': 1})
            outs[name] = (out['seq'].cpu(), out['cap_prob_eval'].cpu(),
                          events)
            print(f'[inputs] {label} ({opt.caption_decoder_type} head, '
                  f'{card}): DenseCaptioner of the {name}\'s .pth, B=16 '
                  f'caption_batch {ms:.1f} ms (CUDA events); kernel launches '
                  f'{launches}, plain-version calls {plain}')
            if fusion and name == 'reference':
                served = dc
            del dc
        same = (torch.equal(outs['port'][0], outs['reference'][0])
                and torch.equal(outs['port'][1], outs['reference'][1])
                and outs['port'][2] == outs['reference'][2])
        print(f'[inputs] {label}: the reference\'s .pth ({extra} tensors '
              f'beyond the model, keys under module.) and the port\'s give '
              f'bitwise equal tokens and log-probs: {same}')
        if not same:
            raise AssertionError(f'[inputs] {label}: the reference .pth '
                                 'served other outputs than the port\'s')
        path, _, launches, plain, seconds = run_eval_counted([
            '--eval_save_dir', root, '--eval_folder', 'eval_reference',
            '--eval_checkpoint_path', paths['reference'], '--eval_batch_size',
            '16', '--eval_mode', 'test', '--eval_device', DEVICE])
        check_eval_json(path, VAL_VIDEOS, scored=False)
        check_launches(f'inputs-{label}', launches, plain, ('msda_fwd',),
                       no_step, exact={'dsa_greedy': 1})
        print(f'[inputs] {label}: run_eval --eval_checkpoint_path '
              f'reference.pth --eval_batch_size 16 ({card}): {seconds:.2f} s '
              f'(host clock); kernel launches {launches}, plain-version '
              f'calls {plain}')
        try:
            DenseCaptioner(opt=opt, state_dict=load_weights(
                paths['unknown key']), device=DEVICE)
        except ValueError as e:
            if bad_key not in str(e):
                raise
            print(f'[inputs] {label}: a .pth with the unknown key {bad_key} '
                  f'raises: {str(e)[:100]}...')
        else:
            raise AssertionError(f'[inputs] {label}: an unknown key loaded')
    return served


def native_feature_io(tmp, card):
    """The native library against its numpy versions on 16 feature files
    at the flagship's width (f4 and f8, one Fortran-ordered, which the
    library refuses, one missing): ``load_npy``, ``resize_feature``
    ('nearest' and 'linear' to 200 rows, and 3 -> 5 rows), ``load_batch``,
    each equal; the library's build time and a B=16 load and resample
    timed against numpy's (host clock)."""
    import numpy as np
    from dvc_tpu_torch.data import native_io
    native_io.lib()
    print(f'[inputs] native feature IO: libdvc_feature_io.so built from '
          f'native/feature_io.cpp in {native_io.build_seconds:.2f} s (g++ '
          f'{" ".join(native_io.CXX_FLAGS)}; 0 where an earlier phase built '
          f'it) at first use')
    root = os.path.join(tmp, 'native_io')
    os.makedirs(root)
    rng = np.random.default_rng(11)
    paths = []
    for i in range(16):
        x = rng.standard_normal((int(rng.integers(150, 400)), 768))
        x = x.astype(np.float32) if i % 2 else x
        paths.append(os.path.join(root, f'v{i}.npy'))
        np.save(paths[-1], np.asfortranarray(x) if i == 5 else x)
    paths.append(os.path.join(root, 'missing.npy'))
    bad = []
    for p in paths[:-1]:
        got, want = native_io.load_npy(p), native_io.load_npy_ref(p)
        if (got is None) != (want is None) or (
                got is not None and not np.array_equal(got, want)):
            bad.append(('load_npy', p))
        x = want if want is not None else np.load(p).astype(np.float32)
        for method in ('nearest', 'linear'):
            if not np.array_equal(native_io.resize_feature(x, 200, method),
                                  native_io.resize_feature_ref(
                                      x, 200, method)):
                bad.append(('resize_feature', p, method))
    x = rng.standard_normal((3, 768)).astype(np.float32)
    for method in ('nearest', 'linear'):
        if not np.array_equal(native_io.resize_feature(x, 5, method),
                              native_io.resize_feature_ref(x, 5, method)):
            bad.append(('resize_feature 3 -> 5', method))
    times = {}
    for method in ('nearest', 'linear'):
        for name, fn in (('library', native_io.load_batch),
                         ('numpy', native_io.load_batch_ref)):
            t0 = time.perf_counter()
            out = fn(paths, 200, 768, True, method)
            times[name, method] = (time.perf_counter() - t0) * 1e3
            if name == 'library':
                got = out
        want = native_io.load_batch_ref(paths, 200, 768, True, method)
        if not all(np.array_equal(g, w) for g, w in zip(got, want)):
            bad.append(('load_batch', method))
    print(f'[inputs] native feature IO vs its numpy versions on 16 files of '
          f'150-400 x 768 (f4, f8, one Fortran-ordered, one missing): '
          f'load_npy, resize_feature (nearest, linear, to 200 rows and 3 -> '
          f'5), load_batch equal: {not bad}; load_batch of the 16 to 200 '
          f'rows, nearest {times["library", "nearest"]:.1f} ms (numpy '
          f'{times["numpy", "nearest"]:.1f}), linear '
          f'{times["library", "linear"]:.1f} ms (numpy '
          f'{times["numpy", "linear"]:.1f}) (host clock, one run, {card})')
    if bad:
        raise AssertionError(f'[inputs] the native library disagrees with '
                             f'its numpy versions: {bad}')


def noisy_hubert(seed=0):
    """HuBERT-base at full width on the CPU, every parameter moved by
    seeded noise (no LayerNorm left at 1, no bias at 0)."""
    import torch
    from dvc_tpu_torch.models.hubert import Hubert, HubertConfig
    model = Hubert(HubertConfig(), device='cpu')
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def write_wav(path, seconds, seed):
    """A stereo 16-bit wave at AUDIO_SR: a tone and noise."""
    import wave
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * AUDIO_SR)) / AUDIO_SR
    data = np.stack([0.3 * np.sin(2 * np.pi * (200 + 20 * seed) * t),
                     0.2 * rng.standard_normal(len(t))], -1)
    with wave.open(path, 'wb') as f:
        f.setnchannels(2)
        f.setsampwidth(2)
        f.setframerate(AUDIO_SR)
        f.writeframes((np.clip(data, -1, 1) * 32767).astype('<i2').tobytes())


def hubert_extraction(tmp, card, dc):
    """HuBERT-base at full width with seeded weights, f32 with TF32 off:
    the card against the port's CPU run on segments of HUBERT_SECONDS
    (relative L2 <= HUBERT_TOL), ms a TSP-clip segment at B=1 and 16 (CUDA
    events) and the peak memory; then ``FusionDataset``'s live-audio route
    over AUDIO_VIDEOS synthetic stereo 44.1 kHz ``.wav`` files with the
    card's ``HubertExtractor`` (one file corrupt: zeros), the cache
    written, then read back on a second pass without a model call; and
    ``dc`` (the flagship FusionPDVC) serving a B=16 ``caption_batch`` of
    those sound features (K1/K2 and one K6, no plain version)."""
    import dataclasses
    import numpy as np
    import torch
    from dvc_tpu_torch.data import FusionDataset
    from dvc_tpu_torch.data.audio import HUBERT_SR, HubertExtractor
    from dvc_tpu_torch.utils.config import Config
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root = os.path.join(tmp, 'hubert')
    folder = os.path.join(root, 'hubert-base')
    os.makedirs(folder)
    model = noisy_hubert()
    config = model.config
    with open(os.path.join(folder, 'config.json'), 'w') as f:
        json.dump(dataclasses.asdict(config), f)
    torch.save(model.state_dict(), os.path.join(folder, 'pytorch_model.bin'))
    rng = np.random.default_rng(3)
    errs = []
    with torch.no_grad():
        for seconds in HUBERT_SECONDS:
            x = torch.from_numpy(rng.standard_normal(
                (1, int(seconds * HUBERT_SR))).astype(np.float32) * 0.1)
            want = model(x)
            model.to(DEVICE)
            got = model(x.to(DEVICE)).cpu()
            model.to('cpu')
            errs.append(rel_l2(got, want))
        model.to(DEVICE)
        timed = {}
        for B in (1, 16):
            x = torch.randn(B, int(HUBERT_CLIP * HUBERT_SR), device=DEVICE)
            model(x)
            if DEVICE != 'cpu':
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            _, ms = event_ms(lambda: [model(x) for _ in range(5)])
            peak = (torch.cuda.max_memory_allocated() / 2**30
                    if DEVICE != 'cpu' else float('nan'))
            timed[B] = (ms / 5 / B, peak)
    del model
    print(f'[inputs] HuBERT-base ({config.hidden_size} wide, '
          f'{config.num_hidden_layers} layers, seeded weights, f32, TF32 '
          f'off) card vs the port\'s CPU run, segments of '
          f'{HUBERT_SECONDS} s: relative L2 {[f"{e:.2e}" for e in errs]} '
          f'(gate {HUBERT_TOL}); a {HUBERT_CLIP:.3f} s segment '
          f'{timed[1][0]:.2f} ms at B=1, {timed[16][0]:.2f} ms a segment at '
          f'B=16 (CUDA events), peak memory {timed[1][1]:.2f} / '
          f'{timed[16][1]:.2f} GiB ({card})')
    if max(errs) > HUBERT_TOL:
        raise AssertionError(f'[inputs] HuBERT card vs CPU: {errs}')

    # FusionDataset's live-audio route
    words = letter_words(dc.opt.vocab_size)
    os.makedirs(os.path.join(root, 'features'))
    anno = write_videos(root, 'v_audio', AUDIO_VIDEOS, 9,
                        dc.opt.feature_dim, words, sound=False)
    audio = os.path.join(root, 'audio')
    os.makedirs(audio)
    for v, (key, entry) in enumerate(anno.items()):
        seconds = 8.0 + v % 5
        scale = seconds / entry['duration']
        entry['duration'] = seconds
        entry['timestamps'] = [[a * scale, b * scale]
                               for a, b in entry['timestamps']]
        wav = os.path.join(audio, key[:13] + '.wav')
        if v == 3:
            with open(wav, 'wb') as f:
                f.write(b'RIFF, but not a wave')
        else:
            write_wav(wav, seconds, v)
    anno_path = os.path.join(root, 'audio.json')
    with open(anno_path, 'w') as f:
        json.dump(anno, f)
    opt = Config({**dc.opt.to_dict(), 'sound_feature_folder': None,
                  'invalid_video_json': []})
    extractor = HubertExtractor(cache_dir=os.path.join(root, 'cache'),
                                model_name=folder, device=DEVICE)
    calls = [0]
    extractor._load_model().register_forward_pre_hook(
        lambda *a: calls.__setitem__(0, calls[0] + 1))
    passes = []
    for _ in range(2):
        ds = FusionDataset(anno_path, [os.path.join(root, 'features')],
                           opt.dict_file, opt, audio_folder=audio,
                           extractor=extractor)
        t0 = time.perf_counter()
        samples = [ds[i] for i in range(len(ds))]
        passes.append((samples, time.perf_counter() - t0, calls[0]))
    (first, s1, c1), (second, s2, c2) = passes
    cached = sorted(os.listdir(os.path.join(root, 'cache')))
    segments = sum(len(s['feats']) for s in first)
    ok = (c1 > 0 and c2 == c1 and len(cached) == AUDIO_VIDEOS - 1
          and not first[3]['sound'].any()
          and all(s['sound'].shape == (opt.frame_embedding_num, 768)
                  and np.isfinite(s['sound']).all() for s in first)
          and all(np.abs(s['sound']).max() > 0
                  for i, s in enumerate(first) if i != 3)
          and all(np.array_equal(a['sound'], b['sound'])
                  for a, b in zip(first, second)))
    print(f'[inputs] FusionDataset live audio ({AUDIO_VIDEOS} stereo '
          f'{AUDIO_SR} Hz .wav files, one corrupt; {segments} segments, '
          f'uniform windows): first pass {s1:.2f} s with {c1} HuBERT passes '
          f'on the card, {len(cached)} videos cached; second pass {s2:.2f} s '
          f'from the cache with {c2 - c1} model calls; the corrupt video\'s '
          f'sound zeros: {not first[3]["sound"].any()} (host clock, {card})')
    if not ok:
        raise AssertionError('[inputs] the live-audio route: calls '
                             f'{c1}, {c2}, cached {cached}')
    feats = [s['feats'] for s in first]
    durations = [s['duration'] for s in first]
    events, launches, plain, _, ms = serve_counted(
        dc, feats, durations, [s['sound'] for s in first])
    for ev, dur in zip(events, durations):
        check_events(ev, dur)
    check_launches('inputs-hubert', launches, plain, ('msda_fwd',),
                   STEP_KERNELS + ('table_gemm', 'table_gemm_bwd'),
                   exact={'dsa_greedy': 1})
    print(f'[inputs] B=16 caption_batch from the extracted sound features '
          f'({card}): {ms:.1f} ms (CUDA events); kernel launches {launches}, '
          f'plain-version calls {plain}')


def phase_inputs(tmp, card):
    """Phase 17 (``--inputs`` runs it alone): the reference's checkpoints
    in serving and ``run_eval``, the native feature-IO library, HuBERT
    extraction on the card."""
    import torch
    root = os.path.join(tmp, 'inputs')
    os.makedirs(root)
    t0 = time.perf_counter()
    dc = reference_checkpoints(root, card)
    native_feature_io(root, card)
    hubert_extraction(root, card, dc)
    del dc
    if DEVICE != 'cpu':
        torch.cuda.empty_cache()
    print(f'[inputs] phase 17 took {time.perf_counter() - t0:.1f} s (host '
          f'clock)')


# --------------------------------------------------------------------------
# 18. data parallel
# --------------------------------------------------------------------------

DDP_VIDEOS = 80           # one --debug epoch: 5 steps at B=16
DDP_BATCH = 16
DDP_TSP = 'r2plus1d_34'
DDP_TSP_BATCH = 8         # 4 clips a rank
DDP_SECONDS = 600         # a rank's or a torchrun worker's time limit
DDP_LOSS_TOL = 1e-4       # relative, each loss
DDP_GRAD_TOL = 1e-3       # relative L2 (+ floor), each gradient: phase 7
DDP_ATOL, DDP_RTOL = 2e-5, 1e-3   # parameters: tests/test_torch_train.py
DDP_TIE_TOL = 1e-4        # a pinned matching's cost over a rank's own
DDP_F64_TOL = 1e-8        # float64 TSP: a tensor's max error / its max


def ddp_recipe(root):
    """A full-width synthetic run of DDP_VIDEOS training videos (the
    validation set of VAL_VIDEOS) at B=DDP_BATCH, dropout off; its
    recipe."""
    from dvc_tpu_torch.utils.config import load_config
    base = write_synthetic_run(root, load_config(CFG, root=ROOT),
                               n_videos=DDP_VIDEOS)
    recipe = os.path.join(root, 'ddp.yml')
    with open(recipe, 'w') as f:
        json.dump({'base_cfg_path': base, 'batch_size': DDP_BATCH,
                   'transformer_dropout_prob': 0.0, 'drop_prob': 0.0}, f)
    return recipe


def ddp_worker(out, argv):
    """``chip_smoke.py --ddp-worker OUT ARGV...``: what ``python -m
    dvc_tpu_torch.new_train ARGV`` runs (``parse_opts``, the seeds,
    ``main``), with the launch counts set to 0 before and read after and
    each train step timed on the host clock between two synchronisations;
    writes them, the losses and the group's backend to OUT (JSON)."""
    import numpy as np
    import torch
    from dvc_tpu_torch import new_train, parallel
    from dvc_tpu_torch.train import trainer as trainer_module
    from dvc_tpu_torch.utils.config import parse_opts
    opt = parse_opts(argv, root=ROOT)
    np.random.seed(opt.seed)
    torch.manual_seed(opt.seed)
    real = trainer_module.Trainer.train_step
    steps, backends = [], set()

    def sync():
        if opt.device != 'cpu':
            torch.cuda.synchronize()

    def timed(self, *a, **k):
        sync()
        t0 = time.perf_counter()
        losses = real(self, *a, **k)
        sync()
        steps.append((time.perf_counter() - t0) * 1e3)
        backends.add(torch.distributed.get_backend() if parallel.active()
                     else None)
        return losses

    trainer_module.Trainer.train_step = timed
    try:
        reset_counts()
        folder, losses = new_train.main(opt)
        launches, plain = read_counts()
    finally:
        trainer_module.Trainer.train_step = real
    ab = (world_one_costs(opt, os.path.dirname(out))
          if 'WORLD_SIZE' in os.environ else None)
    with open(out, 'w') as f:
        json.dump({'folder': folder, 'losses': losses, 'step_ms': steps,
                   'backends': sorted(map(str, backends)),
                   'launches': launches, 'plain': plain, 'ab': ab}, f)


def world_one_costs(opt, root, turns=5):
    """In the torchrun worker after its run: a one-rank group of its own
    (NCCL on the card; a file store in root) and, in this one process, B=16
    train steps with the trainer's collectives on and off in turns
    (``Trainer.data_parallel``; host clock between synchronisations, after
    two warm-up steps), then the gradient sum alone (host clock and CUDA
    events): what the collectives cost at world 1 apart from the
    process."""
    import torch
    from dvc_tpu_torch import parallel
    from dvc_tpu_torch.parallel import mesh
    from dvc_tpu_torch.train import Trainer
    dev = torch.device('cpu' if opt.device == 'cpu' else 'cuda')

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize()

    mesh.init_group(torch.device(dev.type, 0) if dev.type == 'cuda' else dev,
                    'file://' + os.path.join(root, 'costs_store'), 0, 1)
    try:
        trainer = Trainer(opt, device=dev)
        batch = train_batch(opt, DDP_BATCH)
        for _ in range(2):
            trainer.train_step(batch, opt.lr)
        ms = {True: [], False: []}
        for _ in range(turns):
            for on in (True, False):
                trainer.data_parallel = on
                sync()
                t0 = time.perf_counter()
                trainer.train_step(batch, opt.lr)
                sync()
                ms[on].append((time.perf_counter() - t0) * 1e3)
        grads = [p.grad for p in trainer.params]
        host = []
        for _ in range(turns):
            sync()
            t0 = time.perf_counter()
            parallel.sum_gradients(grads)
            sync()
            host.append((time.perf_counter() - t0) * 1e3)
        events = (cuda_ms(lambda: parallel.sum_gradients(grads), turns)
                  if dev.type == 'cuda' else None)
        return {'with': ms[True], 'without': ms[False], 'sum_host': host,
                'sum_events': events, 'tensors': len(grads),
                'bytes': sum(g.numel() * g.element_size() for g in grads)}
    finally:
        torch.distributed.destroy_process_group()


def run_command(cmd, timeout):
    """``cmd`` in a session of its own (its children included, killed on
    a timeout); its stdout, or an error with the end of its output."""
    import signal
    p = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    try:
        output, _ = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        p.communicate()
        raise AssertionError(f'{cmd[:6]}... did not end within {timeout} s')
    if p.returncode:
        raise AssertionError(f'{cmd[:6]}... exited {p.returncode}:\n'
                             f'{output[-4000:]}')
    return output


def ddp_torchrun(root, recipe, card):
    """18(a): new_train's entry point under ``torchrun --standalone
    --nproc_per_node 1`` (a one-rank NCCL group) and without a group, each
    in a process of its own: launches, losses, ms a step."""
    runs = {}
    for label, launcher in (
            ('torchrun', [sys.executable, '-m', 'torch.distributed.run',
                          '--standalone', '--nproc_per_node', '1']),
            ('no group', [sys.executable])):
        out = os.path.join(root, f'{label.replace(" ", "_")}.json')
        cmd = launcher + [os.path.join(ROOT, 'chip_smoke.py'),
                          '--ddp-worker', out, '--cfg_path', recipe,
                          '--debug', '--device', DEVICE,
                          '--tpu_mesh_data', '1']
        t0 = time.perf_counter()
        run_command(cmd, DDP_SECONDS)
        with open(out) as f:
            runs[label] = json.load(f)
        runs[label]['seconds'] = time.perf_counter() - t0
    group, alone = runs['torchrun'], runs['no group']
    if group['backends'] != [('nccl' if DEVICE != 'cpu' else 'gloo')] \
            or alone['backends'] != ['None']:
        raise AssertionError(f'[ddp] groups {group["backends"]}, '
                             f'{alone["backends"]}')
    for label, run in runs.items():
        check_launches(f'ddp {label}', run['launches'], run['plain'],
                       ('msda_fwd', 'msda_bwd', 'dsa_scan_fwd',
                        'dsa_scan_bwd', 'dsa_greedy'), STEP_KERNELS)
        if len(run['step_ms']) != 5 or not all(
                math.isfinite(v) for v in run['losses'].values()):
            raise AssertionError(f'[ddp] {label}: {run}')
    ms = {k: sum(r['step_ms'][1:]) / len(r['step_ms'][1:])
          for k, r in runs.items()}
    err = max(abs(group['losses'][k] - v) / max(abs(v), 1e-6)
              for k, v in alone['losses'].items())
    print(f'[ddp] (a) new_train --debug --tpu_mesh_data 1, B={DDP_BATCH} '
          f'({card}): under torchrun --standalone --nproc_per_node 1 '
          f'(one-rank {group["backends"][0]} group) '
          f'{ms["torchrun"]:.1f} ms a step, without a group '
          f'{ms["no group"]:.1f} ms (host clock, synchronised, mean of '
          f'steps 2-5; all: '
          f'{[round(v, 1) for v in group["step_ms"]]} / '
          f'{[round(v, 1) for v in alone["step_ms"]]}); difference '
          f'{ms["torchrun"] - ms["no group"]:+.1f} ms; processes '
          f'{group["seconds"]:.1f} / {alone["seconds"]:.1f} s; the '
          f'epoch\'s mean losses within {err:.2e} relative of each other')
    print(f'[ddp] (a) torchrun worker launches {group["launches"]}, plain '
          f'calls {group["plain"]}')
    ab = group['ab']
    mean = {k: sum(ab[k]) / len(ab[k]) for k in ('with', 'without',
                                                  'sum_host')}
    print(f'[ddp] (a) in the torchrun worker after its run, one process, a '
          f'one-rank group ({card}): B={DDP_BATCH} steps with the '
          f'collectives {mean["with"]:.1f} ms, without '
          f'{mean["without"]:.1f} ms (host clock, {len(ab["with"])} turns '
          f'each: {[round(v, 1) for v in ab["with"]]} / '
          f'{[round(v, 1) for v in ab["without"]]}); the gradient sum alone '
          f'({ab["tensors"]} tensors, {ab["bytes"] / 2**20:.1f} MiB, '
          f'{-(-ab["bytes"] // (64 << 20))} buckets) {mean["sum_host"]:.2f} '
          f'ms host clock, '
          + (f'{ab["sum_events"]:.3f} ms CUDA events'
             if ab['sum_events'] is not None else 'no card'))
    return ms


def spawn_ranks(fn, n, root, *args):
    """``fn(rank, root, *args)`` on n spawned processes; their results
    (``root/rank{r}.pt``, written by ``fn``).  A rank's failure raises with
    its traceback; ranks still running after DDP_SECONDS are killed."""
    import torch
    import torch.multiprocessing as mp
    ctx = mp.start_processes(fn, args=(root,) + args, nprocs=n, join=False,
                             start_method='spawn')
    deadline = time.monotonic() + DDP_SECONDS
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(f'[ddp] {fn.__name__}: {n} ranks did not '
                                 f'end within {DDP_SECONDS} s')
    return [torch.load(os.path.join(root, f'rank{r}.pt'), weights_only=False)
            for r in range(n)]


def tf32_flags():
    """This process's TF32 switches (matmul, cuDNN): phase 3 turns both
    off for the rest of a full run, and a spawned rank starts with
    PyTorch's defaults (cuDNN's on), so the ranks take the parent's."""
    import torch
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


def gloo_group(rank, root, device, tf32, n=2):
    """Rank ``rank`` of a gloo group of n meeting at a file store in root,
    with the TF32 switches ``tf32`` (:func:`tf32_flags`); whether gloo
    all-reduces a tensor on ``device`` (a CUDA tensor on the card) in this
    torch build."""
    import torch
    import torch.distributed as dist
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = \
        tf32
    dist.init_process_group('gloo', init_method='file://' + os.path.join(
        root, 'store'), rank=rank, world_size=n)
    probe = torch.full((4,), rank + 1.0, device=device)
    dist.all_reduce(probe)
    return probe.tolist() == [n * (n + 1) / 2] * 4


def matching_cost(cfg, logits, boxes, labels, gt_boxes, gt_mask, col4row):
    """The total matching cost of ``col4row`` (D', B, G) in each (layer,
    video), under the matcher's cost matrices of these outputs, (D', B)."""
    import torch
    from dvc_tpu_torch.models.matcher import match_cost_matrix
    col4row = col4row.to(logits.device)
    out = []
    for l in range(len(col4row)):
        C = match_cost_matrix(cfg, logits[l], boxes[l], labels, gt_boxes)
        idx = col4row[l].clamp(min=0)
        picked = torch.gather(C, 1, idx[:, None, :])[:, 0]        # (B, G)
        out.append((picked * (gt_mask & (col4row[l] >= 0))).sum(-1))
    return torch.stack(out).double().cpu()


def recording_matcher(pinned=None, part=None):
    """``criterion.hungarian_match`` wrapped to keep each call's own
    matching (on the host) and, with ``pinned`` (a matching a call, (D',
    B, G)), to return the rows ``part`` of the pinned one instead; (the
    matchings, the pinned rows' relative excess of cost over the own ones
    under this run's cost matrices, a function that puts the real one
    back)."""
    from dvc_tpu_torch.models import criterion
    real, seen, excess = criterion.hungarian_match, [], []

    def record(*args):
        out = real(*args)
        seen.append(out.cpu())
        if pinned is None:
            return out
        taken = pinned[len(seen) - 1][:, part]
        own, other = (matching_cost(*args, m) for m in (out, taken))
        excess.append((other - own) / own.abs().clamp(min=1e-12))
        return taken.to(out.device)
    criterion.hungarian_match = record
    return seen, excess, lambda: setattr(criterion, 'hungarian_match', real)


def pdvc_steps(trainer, batches, lr, part=None, pinned=None):
    """Two optimizer steps (one a batch, ``part`` its rows; ``pinned``:
    the matchings to take, :func:`recording_matcher`): (losses a step, the
    first step's gradients, the final parameters, the own matchings, the
    pinned ones' cost excess), on the host."""
    seen, excess, restore = recording_matcher(pinned, part)
    losses, grads = [], None
    try:
        for b in batches:
            if part is not None:
                b = {k: v[part] for k, v in b.items()}
            out = trainer.train_step(b, lr)
            losses.append({k: float(v) for k, v in out.items()})
            if grads is None:
                grads = {n: p.grad.cpu() for n, p in
                         trainer.model.named_parameters()}
    finally:
        restore()
    return losses, grads, {k: v.cpu() for k, v in
                           trainer.model.state_dict().items()}, seen, excess


def split_steps(trainer, batches, lr, pinned, n=2):
    """The two steps as n ranks take them, in this one process and with
    no collective: each rank's rows of a global batch forward and backward
    in turn, with the global batch's counts (from the pinned matching) as
    the losses' denominators and the gradients accumulated (their sum),
    then ``Trainer.train_step``'s zero fill, clipping and optimizer step.
    Returns what :func:`pdvc_steps` returns but the matchings."""
    import torch
    from dvc_tpu_torch import parallel
    from dvc_tpu_torch.models.matcher import matched_mask
    from dvc_tpu_torch.train.trainer import clip_by_global_norm_
    losses, grads = [], None
    for step, batch in enumerate(batches):
        gt = torch.as_tensor(batch['gt_boxes_mask'])
        counts = torch.stack(
            [gt.sum(), torch.tensor(len(gt))]
            + [matched_mask(m, gt).sum() for m in pinned[step]]).float()
        counts = counts.to(trainer.device)
        for group in trainer.optimizer.param_groups:
            group['lr'] = lr
        trainer.optimizer.zero_grad(set_to_none=False)
        sums = {}
        for r in range(n):
            part = parallel.rows(len(gt), r, n)
            _, _, restore = recording_matcher(pinned[step:step + 1], part)
            try:
                rows = trainer._device_batch(
                    {k: v[part] for k, v in batch.items()},
                    trainer.prepare_batch)
                _, out = trainer.model.forward_train(rows, trainer.gen, 0.0,
                                                     lambda c: counts)
            finally:
                restore()
            out['total_loss'] = trainer.total_loss(out)
            out['total_loss'].backward()
            for k, v in out.items():
                sums[k] = sums.get(k, 0.0) + float(v.detach())
        for p in trainer.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_([p.grad for p in trainer.params],
                             trainer.opt.grad_clip)
        trainer.optimizer.step()
        losses.append(sums)
        if grads is None:
            grads = {k: p.grad.cpu() for k, p in
                     trainer.model.named_parameters()}
    return losses, grads, {k: v.cpu() for k, v in
                           trainer.model.state_dict().items()}


def ddp_pdvc_rank(rank, root, device, opt, tf32):
    """18(b): one of two gloo ranks on ``device`` (cuda:0 for both), from
    rank 0's weights (root/ref.pt), two steps on its rows of the global
    batches; writes root/rank{r}.pt."""
    import torch
    import torch.distributed as dist
    from dvc_tpu_torch import parallel
    from dvc_tpu_torch.train import Trainer
    gloo_cuda = gloo_group(rank, root, device, tf32)
    try:
        ref = torch.load(os.path.join(root, 'ref.pt'), weights_only=False)
        trainer = Trainer(opt, device=device)
        if rank == 0:
            trainer.model.load_state_dict(ref['state'], strict=True)
        parallel.broadcast_module(trainer.model)
        reset_counts()
        losses, grads, state, seen, excess = pdvc_steps(
            trainer, ref['batches'], opt.lr,
            parallel.rows(len(ref['batches'][0]['video_tensor'])),
            ref['matching'])
        launches, plain = read_counts()
        torch.save({'losses': losses, 'grads': grads, 'state': state,
                    'matching': seen, 'excess': excess,
                    'launches': launches, 'plain': plain,
                    'gloo_cuda': gloo_cuda},
                   os.path.join(root, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def exempt_param(name, got, ref):
    """(got, ref) of a parameter, less the entries whose exact gradient is
    zero (tests/test_torch_train.py): None for alpha_net's bias, the key
    third dropped from an in_proj_bias."""
    if name.endswith('alpha_net.bias'):
        return None
    if name.endswith('in_proj_bias'):
        E = len(ref) // 3
        keep = [i for i in range(len(ref)) if not E <= i < 2 * E]
        return got[keep], ref[keep]
    return got, ref


def param_excess(got, ref):
    """The worst parameter's excess over atol + rtol |ref| (<= 1: within
    DDP_ATOL + DDP_RTOL), and its name."""
    worst, name = 0.0, None
    for k, r in ref.items():
        if not r.is_floating_point():
            continue
        pair = exempt_param(k, got[k].double(), r.double())
        if pair is None:
            continue
        g, r2 = pair
        e = float(((g - r2).abs() / (DDP_ATOL + DDP_RTOL * r2.abs())).max()) \
            if r2.numel() else 0.0
        if e > worst:
            worst, name = e, k
    return worst, name


def off_boundary_(model, seed=0, scale=1e-2):
    """Every sampling-offset kernel of ``model`` set to small seeded
    normal values (tests/test_torch_train.py's ``off_boundary``): the
    seeded init puts every sampling point exactly on a tap boundary, where
    the gradient with respect to the location jumps and one ulp picks the
    side, so that two summation orders (a B=8 and a B=16 launch) may take
    different sides."""
    import torch
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith('sampling_offsets.weight'):
                p.copy_(torch.randn(p.shape, generator=gen) * scale)


DDP_ERRORS = {'loss': ('worst loss relative error', DDP_LOSS_TOL),
              'grad': ('worst gradient relative L2', DDP_GRAD_TOL),
              'param': ('final parameters in units of atol + rtol', 1.0)}
# the limits that take a reference's rounding floor: Adam and the sampling
# offsets amplify rounding in these; the losses keep DDP_LOSS_TOL
DDP_FLOORED = ('grad', 'param')


def step_errors(got, ref):
    """A two-step run against a reference run, both (losses a step, the
    first step's gradients or None, the final state): {'loss': the worst
    loss's relative error, 'grad': the worst gradient's relative L2 error
    with phase 7's floors, 'param': the final parameters' worst excess in
    units of atol + rtol |ref|} and {kind: where}."""
    losses, grads, state = got
    ref_losses, ref_grads, ref_state = ref
    err = {'loss': max(abs(losses[i][k] - v) / max(abs(v), 1e-6)
                       for i, step in enumerate(ref_losses)
                       for k, v in step.items()), 'grad': 0.0}
    where = {'grad': None}
    for n, r in (ref_grads or {}).items():
        floor = 5e-5 if n.endswith('alpha_net.bias') else 1e-5
        e = float((grads[n] - r).norm() / (r.norm() + floor / DDP_GRAD_TOL))
        if e >= err['grad']:
            err['grad'], where['grad'] = e, n
    err['param'], where['param'] = param_excess(state, ref_state)
    return err, where


def floor_gates(label, got, floor):
    """Each error of ``got`` (:func:`step_errors` against a reference run)
    within its stated tolerance (DDP_ERRORS); for the kinds of DDP_FLOORED,
    within the larger of that and twice the reference's own rounding floor
    ``floor`` (errors of the same kinds: the reference against itself,
    where atomics make no step bitwise repeatable, or against the same
    arithmetic in another summation order); prints both; whether all are
    within."""
    (err, where), (floor, _) = got, floor
    ok, parts = True, []
    for kind, (name, tol) in DDP_ERRORS.items():
        limit = max(tol, 2 * floor[kind]) if kind in DDP_FLOORED else tol
        ok &= err[kind] <= limit
        parts.append(f'{name} {err[kind]:.3g} (floor {floor[kind]:.3g}; '
                     f'limit {limit:.3g})'
                     + (f' at {where[kind]}' if where.get(kind)
                        and err[kind] else ''))
    print(f'[ddp] {label}: ' + '; '.join(parts))
    return ok


def ddp_pdvc(root, recipe, card):
    """18(b): two gloo ranks on the one card against one process, from
    seeded weights with the sampling offsets off the tap boundaries; the
    one process's step twice, for its own run-to-run error."""
    import torch
    from dvc_tpu_torch.train import Trainer
    from dvc_tpu_torch.utils.config import parse_opts
    opt = parse_opts(['--cfg_path', recipe, '--device', DEVICE], root=ROOT)
    batches = [train_batch(opt, DDP_BATCH),
               {k: v[::-1].copy() for k, v in
                train_batch(opt, DDP_BATCH).items()}]
    runs, seen, initial = [], None, None
    for split in (False, False, True):
        trainer = Trainer(opt, device=DEVICE)
        if initial is None:
            off_boundary_(trainer.model)
            initial = {k: v.detach().cpu().clone()
                       for k, v in trainer.model.state_dict().items()}
        else:
            trainer.model.load_state_dict(initial, strict=True)
        if split:
            runs.append(split_steps(trainer, batches, opt.lr, seen))
        else:
            losses, grads, state, own, _ = pdvc_steps(
                trainer, batches, opt.lr, slice(None), seen)
            seen = seen or own
            runs.append((losses, grads, state))
        del trainer
    torch.cuda.empty_cache()
    torch.save({'state': initial, 'batches': batches, 'matching': seen},
               os.path.join(root, 'ref.pt'))
    t0 = time.perf_counter()
    ranks = spawn_ranks(ddp_pdvc_rank, 2, root, DEVICE, opt, tf32_flags())
    seconds = time.perf_counter() - t0
    own = [torch.cat([r['matching'][i] for r in ranks], 1)
           for i in range(len(seen))]
    flips = sum(int((o != m).any(-1).sum()) for o, m in zip(own, seen))
    rows_all = sum(m.shape[0] * m.shape[1] for m in seen)
    gap = max(float(e.max()) for r in ranks for e in r['excess'])
    equal = all(torch.equal(ranks[0]['state'][k], ranks[1]['state'][k])
                for k in runs[0][2])
    print(f'[ddp] (b) two gloo ranks on one card (cuda:0 both; gloo '
          f'all-reduces CUDA tensors in torch {torch.__version__}: '
          f'{all(r["gloo_cuda"] for r in ranks)}), global B={DDP_BATCH} '
          f'({DDP_BATCH // 2} a rank), two steps, against one process at '
          f'B={DDP_BATCH} ({card}): the ranks took the one process\'s '
          f'matching (their own differs in {flips} of {rows_all} (layer, '
          f'video) rows, whose cost the taken matching exceeds by at most '
          f'{gap:.1e} relative under the rank\'s own cost matrices: '
          f'near-ties where within {DDP_TIE_TOL}, gated); ranks equal '
          f'{equal}; ranks {seconds:.1f} s (spawn included)')
    # the one process against itself, and its split arithmetic (each
    # rank's rows in turn, no collective) against its whole-batch step
    repeat, split = step_errors(runs[1], runs[0]), step_errors(runs[2],
                                                              runs[0])
    # the split arithmetic shares the ranks' loss normalisation, so it
    # serves as a floor only once its losses hold the fixed gate
    ok = split[0]['loss'] <= DDP_LOSS_TOL
    floor = ({k: max(repeat[0][k], split[0][k]) for k in repeat[0]}, None)
    for r, rank in enumerate(ranks):
        got = (rank['losses'], rank['grads'], rank['state'])
        ok &= floor_gates(f'(b) rank {r} against one process (floor: the '
                          'larger of the one process against itself and '
                          'its split arithmetic against it)',
                          step_errors(got, runs[0]), floor)
        ok &= floor_gates(f'(b) rank {r} against the split arithmetic in '
                          'one process (floor: the one process against '
                          'itself)', step_errors(got, runs[2]), repeat)
    print('[ddp] (b) the one process against itself: '
          + ', '.join(f'{k} {v:.3g}' for k, v in repeat[0].items())
          + '; its split arithmetic against it: '
          + ', '.join(f'{k} {v:.3g} ({split[1].get(k) or "-"})'
                      for k, v in split[0].items())
          + f' (loss gated at {DDP_LOSS_TOL} before it serves as a floor)')
    for r, rank in enumerate(ranks):
        print(f'[ddp] (b) rank {r} launches {rank["launches"]}, plain '
              f'calls {rank["plain"]}')
        check_launches(f'ddp rank {r}', rank['launches'], rank['plain'],
                       ('msda_fwd', 'msda_bwd', 'dsa_scan_fwd',
                        'dsa_scan_bwd'), STEP_KERNELS)
    if not (ok and equal and gap <= DDP_TIE_TOL
            and all(r['gloo_cuda'] for r in ranks)):
        raise AssertionError('[ddp] (b) two ranks and one process disagree')


def tsp_steps_on(trainer, state, batches, part=None):
    """Two TSP steps (iterations 5, 6) on ``batches`` (``part``: their
    rows): (losses a step, the final floating state on the host)."""
    losses = []
    for it, b in zip((5, 6), batches):
        if part is not None:
            b = {k: v[part] for k, v in b.items()}
        state, m = trainer.train_step(state, b, it)
        losses.append({k: float(v) for k, v in m.items()})
    return losses, {k: v.detach().cpu() for k, v in
                    state['model'].state_dict().items()
                    if v.is_floating_point()}


def tsp_trainer_in(opt, device, f64):
    """A TSPTrainer and its seeded state, in float64 (weights, statistics
    and compute, as ``tsp_one_step``'s float64 referee) where ``f64``."""
    import torch
    from dvc_tpu_torch.train.tsp_trainer import TSPTrainer
    trainer = TSPTrainer(opt, device)
    state = trainer.init_state(seed=0)
    if f64:
        trainer.dtype = torch.float64
        state['model'].double()
    return trainer, state


def ddp_tsp_rank(rank, root, device, opt, tf32):
    """18(c): one of two gloo ranks of the TSP step on ``device`` (cuda:0
    for both), on its rows of root/ref.pt's batches, in float64 and then
    in float32."""
    import torch
    import torch.distributed as dist
    from dvc_tpu_torch import parallel
    gloo_group(rank, root, device, tf32)
    try:
        batches = torch.load(os.path.join(root, 'ref.pt'))['batches']
        part = parallel.rows(len(batches[0]['clip']))
        out = {}
        for f64 in (True, False):
            trainer, state = tsp_trainer_in(opt, device, f64)
            out[f64] = tsp_steps_on(trainer, state, batches, part)
            del trainer, state
        torch.save(out, os.path.join(root, f'rank{rank}.pt'))
    finally:
        dist.destroy_process_group()


def ddp_tsp(root, card):
    """18(c): TSP under --train-bn 1 on two gloo ranks against one
    process.  Gated in float64: in float32 the step is chaotic at random
    weights (ReLU kinks and BatchNorm over few values a channel in the last
    stages turn ulps into 1e-4-1e-3 of the loss), so a float32 comparison
    measures that more than the global statistics' sums; it is printed
    beside the one process's float32 step against itself (not gated)."""
    import torch
    opt = tsp_train_opt(DDP_TSP, 'float32', 1)
    batches = [tsp_clip_batch(DDP_TSP, DDP_TSP_BATCH, 30 + i)
               for i in range(2)]
    ref = {}
    for f64, times in ((True, 1), (False, 2)):
        for _ in range(times):
            trainer, state = tsp_trainer_in(opt, DEVICE, f64)
            ref.setdefault(f64, []).append(tsp_steps_on(trainer, state,
                                                        batches))
            del trainer, state
    torch.cuda.empty_cache()
    torch.save({'batches': batches}, os.path.join(root, 'ref.pt'))
    t0 = time.perf_counter()
    ranks = spawn_ranks(ddp_tsp_rank, 2, root, DEVICE, opt, tf32_flags())
    seconds = time.perf_counter() - t0
    final = ref[True][0][1]
    stats = [k for k in final if k.endswith(('running_mean', 'running_var'))]
    rel = {k: float((ranks[0][True][1][k] - v).abs().max()
                    / v.abs().max().clamp(min=1e-300))
           for k, v in final.items()}
    worst = max(rel, key=rel.get)
    worst_s = max(stats, key=rel.get)
    equal = all(torch.equal(r[True][1][k], ranks[0][True][1][k])
                for r in ranks for k in final)
    print(f'[ddp] (c) {DDP_TSP} --train-bn 1 in float64 on two gloo ranks on '
          f'one card at a global batch of {DDP_TSP_BATCH} clips, two steps, '
          f'against one process ({card}): each tensor\'s max abs error over '
          f'its max |ref|: worst {rel[worst]:.2e} ({worst}), running '
          f'statistics {rel[worst_s]:.2e} ({worst_s}; limit '
          f'{DDP_F64_TOL}); ranks equal {equal}; ranks {seconds:.1f} s '
          f'(spawn included; both dtypes)')
    ok = all([floor_gates(f'(c) rank {r} against one process, float64',
                          step_errors((rank[True][0], None, rank[True][1]),
                                      (ref[True][0][0], None, final)),
                          ({k: 0.0 for k in DDP_ERRORS}, None))
              for r, rank in enumerate(ranks)])
    f32 = [(a[0], None, a[1]) for a in ref[False]]
    floor_gates('(c) rank 0 against one process, float32 (not gated; '
                'floor: the one process against itself)',
                step_errors((ranks[0][False][0], None, ranks[0][False][1]),
                            f32[0]), step_errors(f32[1], f32[0]))
    if not (ok and equal and stats and rel[worst] <= DDP_F64_TOL):
        raise AssertionError('[ddp] (c) two ranks and one process disagree')


def ddp_refusal(root, recipe):
    """18(d): new_train with one rank more than the visible cards raises
    before it makes its run folder."""
    import torch
    from dvc_tpu_torch.new_train import main as train_main
    from dvc_tpu_torch.utils.config import parse_opts
    n = torch.cuda.device_count() + 1 if DEVICE != 'cpu' else 2
    opt = parse_opts(['--cfg_path', recipe, '--debug', '--device', DEVICE,
                      '--tpu_mesh_data', str(n)], root=ROOT)
    opt.save_dir = os.path.join(root, 'refused')
    opt.batch_size = 2 * n
    try:
        train_main(opt)
    except RuntimeError as e:
        if os.path.exists(opt.save_dir):
            raise AssertionError('[ddp] (d) a run folder was made') from e
        print(f'[ddp] (d) new_train --tpu_mesh_data {n} with '
              f'{n - 1} visible card(s) raised before any work: {e}')
        return
    raise AssertionError(f'[ddp] (d) --tpu_mesh_data {n} did not raise')


def phase_ddp(tmp, card):
    """Phase 18 (``--ddp`` runs it alone): data-parallel training
    (``dvc_tpu_torch.parallel``) on the one card."""
    root = os.path.join(tmp, 'ddp')
    os.makedirs(root)
    t0 = time.perf_counter()
    recipe = ddp_recipe(root)
    ddp_torchrun(root, recipe, card)
    for sub, run in (('pdvc', lambda d: ddp_pdvc(d, recipe, card)),
                     ('tsp', lambda d: ddp_tsp(d, card))):
        os.makedirs(os.path.join(root, sub))
        run(os.path.join(root, sub))
    ddp_refusal(root, recipe)
    print(f'[ddp] phase 18 took {time.perf_counter() - t0:.1f} s (host '
          f'clock)')


def main():
    device = phase_device()
    phase_build()
    kernels = phase_kernels()
    kernels.update(phase_assignment())
    phase_split('current', FULL_RUN_SPLITS)
    from dvc_tpu_torch.utils.config import load_config
    opt = load_config(CFG, root=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        dc = make_captioner(opt, tmp)
    phase_serve(dc)
    phase_agreement(dc)
    del dc
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_opt, train_folder = phase_train(tmp)
        phase_train_agreement(train_opt)
        step_launches, folder = phase_stepwise_train(tmp)
        phase_stepwise_serve(folder)
        phase_stepwise_agreement(train_opt)
        eval_launches = phase_eval(tmp, train_folder, device['smi'])
        phase_pipeline(tmp, device['smi'])
        phase_sampling(train_folder)
        phase_pretrain(train_opt, train_folder)
        bf16_results, bf16_launches = phase_bf16(tmp, device['smi'])
        phase_plain(tmp, device['smi'])
        phase_tsp(tmp, device['smi'])
        phase_tsp_train(tmp, device['smi'])
        phase_inputs(tmp, device['smi'])
        phase_ddp(tmp, device['smi'])
    foreign = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                            'dvc_tpu'))
    pkg = os.path.join(ROOT, 'dvc_tpu') + os.sep
    foreign += sorted(name for name, m in list(sys.modules.items())
                      if (getattr(m, '__file__', None) or '').startswith(pkg))
    if foreign:
        raise AssertionError(f'the port imported {foreign}')
    # the first shape of each kernel: MSDA forward at the encoder shape
    # (B=16, Q=375), greedy at H=1 (the recipe's cap_nheads), the training
    # kernels at B=1, the word-step kernels at the train shape (B=1, Q=90,
    # H=1; alone with VW given), the table of K7-K10 and its
    # backward at B=1, H=1 (its products lie inside the TPU kernels'
    # bodies; their bound is the 3xTF32 one that the GEMM is built for);
    # the [kernels] lines above give every shape.  launches: the eval
    # path's B=16 run_eval for msda_fwd and dsa_greedy (the serve path's
    # counts are in its [serve] line), the train path's for the
    # others, the stepwise train runs' for the word-step kernels, and both
    # stepwise runs' for the table; the bf16 variants': phase 16's bf16
    # train run for K4-bf16 and K5-bf16, its run_eval at B=16 for K6-bf16,
    # its unfused stepwise run for K7-bf16 and K8-bf16, its lstm_fuse run
    # for K9-bf16 and K10-bf16 and the table's bf16 mode (their first
    # shapes: K6-bf16 at B=16, H=1, K4/K5-bf16 at B=1, H=1, K7-K10-bf16
    # and the table at B=1, Q=90, H=1); the assignment solver's: phase 6's
    # train run (5 steps and 6 validation batches), first shape the
    # flagship's (3, 16, 30, 100), its library_ms the scipy round trip it
    # replaces (host clock)
    kernels.update(bf16_results)
    launches = {**bf16_launches,'msda_fwd': eval_launches['msda_fwd'],
                'dsa_greedy': eval_launches['dsa_greedy'],
                **{k: train_launches[k] for k in
                   ('msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd')},
                **{k: step_launches[lstm][k]
                   for lstm, names in STEPWISE.items() for k in names},
                **{k: step_launches[False][k] + step_launches[True][k]
                   for k in ('table_gemm', 'table_gemm_bwd')},
                'assignment': train_launches['assignment']}
    sources = {'msda_fwd': ('ms_deform_attn.cu', 'ms_deform_attn.py:309'),
               'msda_bwd': ('ms_deform_attn.cu', 'ms_deform_attn.py:551'),
               'dsa_scan_fwd': ('dsa_scan.cu', 'dsa_scan.py:149'),
               'dsa_scan_bwd': ('dsa_scan.cu', 'dsa_scan.py:182'),
               'dsa_greedy': ('dsa_greedy.cu', 'dsa_greedy.py:131'),
               'dsa_step_fwd': ('dsa_step.cu', 'dsa_step.py:311'),
               'dsa_step_bwd': ('dsa_step.cu', 'dsa_step.py:324'),
               'dsa_lstm_fwd': ('dsa_step.cu', 'dsa_step.py:545'),
               'dsa_lstm_bwd': ('dsa_step.cu', 'dsa_step.py:566'),
               'table_gemm': ('dsa_tables.cu', 'dsa_step.py:545'),
               'table_gemm_bwd': ('dsa_tables.cu', 'dsa_step.py:566'),
               'dsa_scan_fwd_bf16': ('dsa_scan.cu', 'dsa_scan.py:149'),
               'dsa_scan_bwd_bf16': ('dsa_scan.cu', 'dsa_scan.py:182'),
               'dsa_greedy_bf16': ('dsa_greedy.cu', 'dsa_greedy.py:131'),
               'dsa_step_fwd_bf16': ('dsa_step.cu', 'dsa_step.py:311'),
               'dsa_step_bwd_bf16': ('dsa_step.cu', 'dsa_step.py:324'),
               'dsa_lstm_fwd_bf16': ('dsa_step.cu', 'dsa_step.py:545'),
               'dsa_lstm_bwd_bf16': ('dsa_step.cu', 'dsa_step.py:566'),
               'table_gemm_bf16': ('dsa_tables.cu', 'dsa_step.py:545'),
               'table_gemm_bwd_bf16': ('dsa_tables.cu', 'dsa_step.py:566'),
               'assignment': ('assignment.cu', 'assignment.py:31')}
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda',
         'source': f'dvc_tpu_torch/csrc/{src}',
         'replaces': f'dvc_tpu/ops/{tpu}',
         'launches': launches[name],
         'max_abs_err': max(r['max_abs_err'] for r in kernels[name]),
         'ms': kernels[name][0]['ms'], 'plain_ms': kernels[name][0]['plain_ms'],
         'bound_ms': kernels[name][0]['bound_ms'],
         'bound_by': kernels[name][0]['bound_by'],
         'library_ms': kernels[name][0].get('library_ms')}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device['kind'], 'count': device['count']}}))


if __name__ == '__main__':
    if sys.argv[1:2] == ['--split']:    # [spec [kernel ...]]
        phase_device()
        phase_split(sys.argv[2] if len(sys.argv) > 2 else 'current',
                    sys.argv[3:] or None)
    elif sys.argv[1:2] == ['--ab']:
        phase_device()
        ab_times()
    elif sys.argv[1:2] == ['--ab-bf16']:
        phase_device()
        ab_bf16_times()
    elif sys.argv[1:2] == ['--assignment']:
        phase_device()
        phase_build()
        phase_assignment()
    elif sys.argv[1:2] == ['--ab-matcher']:     # PARENT_CHECKOUT
        phase_device()
        ab_matcher(sys.argv[2])
    elif sys.argv[1:2] == ['--ab-matcher-run']:
        matcher_ab_run()
    elif sys.argv[1:2] == ['--gemm']:
        phase_device()
        phase_build()
        phase_gemm()
    elif sys.argv[1:2] == ['--tsp']:
        card = phase_device()['smi']
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_tsp(tmp, card)
    elif sys.argv[1:2] == ['--bf16']:
        card = phase_device()['smi']
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_bf16(tmp, card)
    elif sys.argv[1:2] == ['--inputs']:
        card = phase_device()['smi']
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_inputs(tmp, card)
    elif sys.argv[1:2] == ['--ddp']:
        card = phase_device()['smi']
        phase_build()
        with tempfile.TemporaryDirectory() as tmp:
            phase_ddp(tmp, card)
    elif sys.argv[1:2] == ['--ddp-worker']:     # OUT new_train-argv...
        ddp_worker(sys.argv[2], sys.argv[3:])
    elif sys.argv[1:2] == ['--tsp-train']:
        card = phase_device()['smi']
        with tempfile.TemporaryDirectory() as tmp:
            phase_tsp_train(tmp, card)
    else:
        main()
