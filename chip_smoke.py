#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (one or more lines each; the last line is the JSON verdict):

1. device — the card's name, count and ``nvidia-smi`` name and power limit;
   no CUDA device is an error (there is no CPU carry-on).
2. build  — compile the hand-written kernels of ``dvc_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build time and ptxas resource lines.
3. kernels vs plain — each kernel against its plain PyTorch version on the
   card at the serving path's shapes (TF32 off), with errors and CUDA-event
   times.  Tolerances: MSDA max abs error <= 1e-4 * max|out|; greedy tokens
   equal and log-probs within 1e-3 on every (video, step, query) whose
   plain-version top-2 logit margin exceeded 1e-3 at that step and all
   earlier ones (after a near-tie the fed-back tokens may differ, so the
   rest of that query's decode is not comparable).
4. serve  — the FusionPDVC of ``cfgs/yc2_newModel_sound.yml`` at full width
   with seeded random weights behind the port's ``DenseCaptioner``: four
   requests of different lengths and durations, with and without sound,
   checked for well-formed events; one B=16 batch timed (videos/s) and one
   traced with ``torch.profiler`` (each kernel's share of the batch, the
   card's idle share).  Both kernels' launch counters must rise and no
   plain version may run.
5. agreement — the same model's raw outputs on the card against the CPU
   run of the plain versions on one video; then a check that neither JAX
   nor the JAX package ``dvc_tpu`` was imported.

Nothing catches a phase's failure: any failure exits non-zero and the last
line ``{"ok": true, ...}`` is printed only when every phase passed.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

MSDA_LEVELS = (200, 100, 50, 25)      # T = 200 frames, 4 levels, S = 375
CFG = 'cfgs/yc2_newModel_sound.yml'
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


def check_msda(gen, B, Q):
    from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn,
                                                  ms_deform_attn_ref)
    value, loc, attn = msda_inputs(gen, B, Q)
    out = ms_deform_attn(value, MSDA_LEVELS, loc, attn)
    ref = ms_deform_attn_ref(value, MSDA_LEVELS, loc, attn)
    err = float((out - ref).abs().max())
    tol = 1e-4 * float(ref.abs().max())
    ms = cuda_ms(lambda: ms_deform_attn(value, MSDA_LEVELS, loc, attn), 50)
    plain_ms = cuda_ms(
        lambda: ms_deform_attn_ref(value, MSDA_LEVELS, loc, attn), 10)
    print(f'[kernels] msda_fwd B={B} Q={Q} S={value.shape[1]} H=8 D=64 '
          f'L=4 P=4: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} '
          f'ms plain {plain_ms:.4f} ms')
    if not err <= tol:
        raise AssertionError(f'msda_fwd Q={Q}: error {err} > {tol}')
    return {'B': B, 'Q': Q, 'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}


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
    print(f'[kernels] dsa_greedy B={B} Q={Q} H={H} Dh={512 // H} S=375 LP=16 '
          f'A=R=E=512 V+1=1608 K={K}: compared {frac:.3f} of (b,k,q), '
          f'token mismatches {mismatches}, max |lp diff| {lp_err:.3e}, '
          f'all tokens equal {bool((tok == ref_tok).all())}; kernel '
          f'{ms:.3f} ms plain {plain_ms:.3f} ms')
    if mismatches or not lp_err <= 1e-3 or frac < 0.5:
        raise AssertionError(f'dsa_greedy H={H}: {mismatches} token '
                             f'mismatches, lp err {lp_err}, compared {frac}')
    return {'B': B, 'Q': Q, 'H': H, 'max_abs_err': lp_err,
            'compared': frac, 'ms': ms, 'plain_ms': plain_ms}


def phase_kernels():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        msda = [check_msda(gen, 16, 375), check_msda(gen, 16, 100)]
        greedy = [check_greedy(gen, 16, 100, 1), check_greedy(gen, 16, 100, 8)]
    return msda, greedy


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


def trace_batch(dc, feats, durs):
    """One ``caption_batch`` under ``torch.profiler``: the device time of
    each kernel as a share of the call's host-clock window, and the share of
    that window in which no kernel or copy ran on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function('caption_batch'):
            dc.caption_batch(feats, durs)
        torch.cuda.synchronize()
    events = prof.events()
    win = next(e.time_range for e in events if e.name == 'caption_batch'
               and e.device_type == DeviceType.CPU)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in events if e.device_type == DeviceType.CUDA
                   and e.name != 'caption_batch')
    window = win.end - win.start
    if not spans:
        print('[trace] the profiler recorded no device activity: kernel '
              'shares and idle share not measured')
        return
    busy, covered, per_name = 0.0, win.start, {}
    for t0, t1, name in spans:     # union of the spans inside the window
        busy += max(min(t1, win.end) - max(t0, covered), 0.0)
        covered = max(covered, min(t1, win.end))
        per_name[name] = per_name.get(name, 0.0) + (t1 - t0)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:6]
    print(f'[trace] B={len(feats)} caption_batch under the profiler: window '
          f'{window / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle '
          f'share {1 - busy / window:.4f}, {len(spans)} device activities')
    for name, us in top:
        print(f'[trace]   {us / 1e3:9.3f} ms  {us / window:.4f} of window  '
              f'{name[:90]}')


def phase_serve(dc):
    import numpy as np
    import torch
    from dvc_tpu_torch.ops import (dsa_greedy_scan, dsa_greedy_scan_ref,
                                   ms_deform_attn, ms_deform_attn_ref)
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

    for fn in (ms_deform_attn, dsa_greedy_scan):
        fn.launches = 0
    for fn in (ms_deform_attn_ref, dsa_greedy_scan_ref):
        fn.calls = 0
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
    trace_batch(dc, batch16, durs16)
    launches ={'msda_fwd': ms_deform_attn.launches,
                'dsa_greedy': dsa_greedy_scan.launches}
    plain = ms_deform_attn_ref.calls + dsa_greedy_scan_ref.calls
    print(f'[serve] kernel launches {launches}, plain-version calls {plain}')
    if min(launches.values()) < 1 or plain:
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


def main():
    device = phase_device()
    phase_build()
    msda, greedy = phase_kernels()
    from dvc_tpu_torch.utils.config import load_config
    opt = load_config(CFG, root=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        dc = make_captioner(opt, tmp)
    launches = phase_serve(dc)
    phase_agreement(dc)
    foreign = sorted(m for m in sys.modules
                     if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax',
                                            'dvc_tpu'))
    if foreign:
        raise AssertionError(f'the port imported {foreign}')
    # ms / plain_ms: MSDA at the encoder shape (Q=375), greedy at H=1 (the
    # recipe's cap_nheads); the [kernels] lines above give every shape
    print(json.dumps({'kernels': [
        {'name': 'msda_fwd', 'route': 'cuda',
         'source': 'dvc_tpu_torch/csrc/ms_deform_attn.cu',
         'replaces': 'dvc_tpu/ops/ms_deform_attn.py:309',
         'launches': launches['msda_fwd'],
         'max_abs_err': max(m['max_abs_err'] for m in msda),
         'ms': msda[0]['ms'], 'plain_ms': msda[0]['plain_ms']},
        {'name': 'dsa_greedy', 'route': 'cuda',
         'source': 'dvc_tpu_torch/csrc/dsa_greedy.cu',
         'replaces': 'dvc_tpu/ops/dsa_greedy.py:131',
         'launches': launches['dsa_greedy'],
         'max_abs_err': max(g['max_abs_err'] for g in greedy),
         'ms': greedy[0]['ms'], 'plain_ms': greedy[0]['plain_ms']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device['kind'], 'count': device['count']}}))


if __name__ == '__main__':
    main()
