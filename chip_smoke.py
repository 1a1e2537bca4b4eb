#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``dvc_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases (one or more lines each; the last line is the JSON verdict):

1. device — the card's name, count and ``nvidia-smi`` name and power limit;
   no CUDA device is an error (there is no CPU carry-on).
2. build  — compile the hand-written kernels of ``dvc_tpu_torch/csrc`` with
   nvcc (sm_90a) and print the build time and ptxas resource lines.
3. kernels vs plain — each of the five kernels against its plain PyTorch
   version on the card at the serving and training paths' shapes (TF32
   off), with errors, CUDA-event times and each kernel's bound (bytes over
   the HBM rate or f32 operations over the CUDA cores' peak).  Tolerances:
   MSDA forward max abs error <= 1e-4 * max|out|, and each of its
   gradients <= 1e-4 * its max |ref|; greedy tokens equal and log-probs
   within 1e-3 on every (video, step, query) whose plain-version top-2
   logit margin exceeded 1e-3 at that step and all earlier ones (after a
   near-tie the fed-back tokens may differ, so the rest of that query's
   decode is not comparable); scan hs and cs <= 1e-4 * max|ref|, each of
   its 13 gradients <= 1e-3 * its max |ref| + 1e-5, with a wider floor for
   the one that is zero in exact arithmetic (``check_scan``).
4. serve  — the FusionPDVC of ``cfgs/yc2_newModel_sound.yml`` at full width
   with seeded random weights behind the port's ``DenseCaptioner``: four
   requests of different lengths and durations, with and without sound,
   checked for well-formed events; one B=16 batch timed (videos/s) and one
   traced with ``torch.profiler`` (each kernel's share of the batch, the
   card's idle share).  Both kernels' launch counters must rise and no
   plain version may run.
5. agreement — the same model's raw outputs on the card against the CPU
   run of the plain versions on one video.
6. train — ``dvc_tpu_torch.new_train.main`` for one ``--debug`` epoch (5
   steps at B=1) of the same recipe on a synthetic run written to a temp
   dir: finite losses, the launch counters of the MSDA forward and
   backward and of the scan forward and backward must rise and no plain
   version may run; the checkpoint it wrote serves one request on the
   card; the total loss falls on a repeated batch; the train step timed at
   B=1 and B=16 and one B=16 step traced.
7. train agreement — one train step's losses and gradients on the card
   against the CPU plain path (same weights and batch, dropout off); then
   a check that neither JAX nor any module of the JAX package ``dvc_tpu``
   (by name or by file) was imported.

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


def bound(n_bytes, flops):
    """(least ms, what bounds it): the larger of the bytes the function must
    move (each input read once, each output written once) over the HBM rate
    and its operations over the f32 peak."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
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
    plain_ms = cuda_ms(
        lambda: ms_deform_attn_ref(value, MSDA_LEVELS, loc, attn), 10)
    bound_ms, bound_by = msda_bound(value, loc, attn, out)
    print(f'[kernels] msda_fwd B={B} Q={Q} S={value.shape[1]} H=8 D=64 '
          f'L=4 P=4: max_abs_err {err:.3e} (tol {tol:.3e}) kernel {ms:.4f} '
          f'ms plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})')
    if not err <= tol:
        raise AssertionError(f'msda_fwd Q={Q}: error {err} > {tol}')
    return {'B': B, 'Q': Q, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by}


def check_msda_bwd(gen, B, Q):
    """K3 against autograd through the plain version; tolerance per
    gradient 1e-4 * its max |value| (dvalue is summed with atomics in no
    fixed order, the reductions over D in another order)."""
    import torch
    from dvc_tpu_torch.ops.ms_deform_attn import (ms_deform_attn_bwd,
                                                  ms_deform_attn_bwd_ref)
    value, loc, attn = msda_inputs(gen, B, Q)
    g = torch.randn((B, Q, value.shape[2] * value.shape[3]), generator=gen,
                    device='cuda')
    got = ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn, g)
    want = ms_deform_attn_bwd_ref(value, MSDA_LEVELS, loc, attn, g)
    errs = [float((a - b).abs().max()) / float(b.abs().max())
            for a, b in zip(got, want)]
    err = max(float((a - b).abs().max()) for a, b in zip(got, want))
    ms = cuda_ms(lambda: ms_deform_attn_bwd(value, MSDA_LEVELS, loc, attn, g),
                 50)
    plain_ms = cuda_ms(
        lambda: ms_deform_attn_bwd_ref(value, MSDA_LEVELS, loc, attn, g), 10)
    bound_ms, bound_by = msda_bwd_bound(value, loc, attn, g, got)
    print(f'[kernels] msda_bwd B={B} Q={Q} S={value.shape[1]} H=8 D=64 L=4 '
          f'P=4: max_abs_err {err:.3e}, relative (dvalue, dloc, dattn) '
          f'{[f"{e:.2e}" for e in errs]} (tol 1e-4) kernel {ms:.4f} ms '
          f'plain {plain_ms:.4f} ms bound {bound_ms:.4f} ms ({bound_by})')
    if not max(errs) <= 1e-4:
        raise AssertionError(f'msda_bwd Q={Q}: relative errors {errs}')
    return {'B': B, 'Q': Q, 'max_abs_err': err, 'ms': ms,
            'plain_ms': plain_ms, 'bound_ms': bound_ms, 'bound_by': bound_by}


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
    value_t, base_pos, _, const_z, embed = args[:5]
    B, H, S, Dh = value_t.shape
    Q, LP = base_pos.shape[2], base_pos.shape[3]
    V1, E = embed.shape
    R = const_z.shape[2] // 4
    A = args[9].shape[1]
    n = B * Q * K
    macs = (step_macs(n, B, H, S, LP, Dh, R, A)
            + min(n, V1) * E * 4 * R + n * R * V1)
    import torch
    inputs = [t for t in args if torch.is_tensor(t)]
    return bound(nbytes(*inputs) + 8 * n, 2.0 * macs)


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


def check_scan(gen, B, Q, K, H):
    """K4 and K5 against the plain scan and autograd through it.
    Tolerances: hs and cs max abs error <= 1e-4 * max|ref|; each of the 13
    gradients <= 1e-3 * its max |ref| + 1e-5 (K recurrent f32 steps summed
    in another order, atomics in dvalue, dWc and the bias sums), as in
    ``tests/test_torch_cuda_kernels.py``.  d alpha_b alone has the floor
    max(5e-5, 2.5e-10 * B*K*Q*H*LP) in place of 1e-5: it is zero in exact
    arithmetic because the softmax's gradients sum to zero, so both sides
    hold only the rounding of a sum of B*K*Q*H*LP terms in no fixed order
    (up to about 1e-5 at B=1 and 3e-5 at B=16 in the runs so far)."""
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
    want = dsa_teacher_scan_bwd_ref(*args, MSDA_LEVELS, ref_hs, ref_cs, g)
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
    if not fwd_err <= fwd_tol or not max(rel.values()) <= 1e-3:
        raise AssertionError(f'dsa_scan B={B}: forward error {fwd_err}, '
                             f'gradient relative errors {rel}')
    return ({'B': B, 'Q': Q, 'K': K, 'max_abs_err': fwd_err, 'ms': fwd_ms,
             'plain_ms': fwd_plain, 'bound_ms': fwd_bound[0],
             'bound_by': fwd_bound[1]},
            {'B': B, 'Q': Q, 'K': K, 'max_abs_err': bwd_err, 'ms': bwd_ms,
             'plain_ms': bwd_plain, 'bound_ms': bwd_bound[0],
             'bound_by': bwd_bound[1]})


def phase_kernels():
    """Every kernel against its plain version at the main paths' shapes:
    serving (MSDA forward and greedy at B=16) and training (MSDA forward and
    backward at B=1, scan at B=1 and B=16 with Q = 3 layers x 30 gt pairs
    and K = 29 word steps).  Returns {kernel: [result per shape]}."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device='cuda').manual_seed(0)
    with torch.inference_mode():
        res = {'msda_fwd': [check_msda(gen, 16, 375), check_msda(gen, 16, 100),
                            check_msda(gen, 1, 375)],
               'dsa_greedy': [check_greedy(gen, 16, 100, 1),
                              check_greedy(gen, 16, 100, 8)]}
    res['msda_bwd'] = [check_msda_bwd(gen, 1, 375), check_msda_bwd(gen, 1, 100)]
    scans = [check_scan(gen, 1, 90, 29, 1), check_scan(gen, 16, 90, 29, 1)]
    res['dsa_scan_fwd'] = [f for f, _ in scans]
    res['dsa_scan_bwd'] = [b for _, b in scans]
    return res


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
    """``fn()`` under ``torch.profiler``: the device time of each kernel as
    a share of the call's host-clock window, and the share of that window
    in which no kernel or copy ran on the card."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(label):
            fn()
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
    busy, covered, per_name = 0.0, win.start, {}
    for t0, t1, name in spans:     # union of the spans inside the window
        busy += max(min(t1, win.end) - max(t0, covered), 0.0)
        covered = max(covered, min(t1, win.end))
        per_name[name] = per_name.get(name, 0.0) + (t1 - t0)
    top = sorted(per_name.items(), key=lambda kv: -kv[1])[:8]
    print(f'[trace] {label} under the profiler: window {window / 1e3:.3f} '
          f'ms, device busy {busy / 1e3:.3f} ms, idle share '
          f'{1 - busy / window:.4f}, {len(spans)} device activities')
    for name, us in top:
        print(f'[trace]   {us / 1e3:9.3f} ms  {us / window:.4f} of window  '
              f'{name[:90]}')


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
    if min(launches['msda_fwd'], launches['dsa_greedy']) < 1 or plain:
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


def write_synthetic_run(root, opt, n_videos=TRAIN_VIDEOS, seed=0):
    """A YouCook2-shaped training set at the recipe's widths: clip features
    (feature_dim wide, 150-400 clips), cached sound features for every
    other video (the rest fall back to zeros), a vocabulary of vocab_size
    words, and 3-40 captioned events per video (captions of 3-27 words, so
    after BOS/EOS at most 29 word steps).  Returns the recipe file that
    inherits the model from CFG and points at this data."""
    import numpy as np
    rng = np.random.default_rng(seed)
    feat_dir = os.path.join(root, 'features')
    sound_dir = os.path.join(root, 'sound')
    os.makedirs(feat_dir)
    os.makedirs(sound_dir)
    words = [f'word{i}' for i in range(1, opt.vocab_size + 1)]
    vocab = os.path.join(root, 'vocab.json')
    with open(vocab, 'w') as f:
        json.dump({'word_to_ix': {w: i for i, w in enumerate(words, 1)},
                   'ix_to_word': {str(i): w for i, w in enumerate(words, 1)}},
                  f)
    anno = {}
    for v in range(n_videos):
        key = f'v_smoke{v:06d}'
        n_clips = int(rng.integers(150, 400))
        duration = float(rng.uniform(60, 600))
        np.save(os.path.join(feat_dir, key[:13] + '.npy'),
                rng.standard_normal((n_clips, opt.feature_dim))
                .astype(np.float32))
        if v % 2 == 0:
            np.save(os.path.join(sound_dir, key[:13] + '.npy'),
                    rng.standard_normal((n_clips, opt.feature_dim))
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
    anno_path = os.path.join(root, 'train.json')
    with open(anno_path, 'w') as f:
        json.dump(anno, f)
    recipe = os.path.join(root, 'smoke.yml')
    with open(recipe, 'w') as f:
        json.dump({'base_cfg_path': CFG, 'id': 'smoke',
                   'save_dir': os.path.join(root, 'save'),
                   'train_caption_file': anno_path,
                   'val_caption_file': anno_path, 'dict_file': vocab,
                   'visual_feature_folder': [feat_dir],
                   'invalid_video_json': [],
                   'sound_feature_folder': sound_dir, 'epoch': 1}, f)
    return recipe


def reset_counts():
    from dvc_tpu_torch.ops import (dsa_greedy_scan, dsa_greedy_scan_ref,
                                   dsa_teacher_scan_bwd, dsa_teacher_scan_fwd,
                                   dsa_teacher_scan_ref, ms_deform_attn,
                                   ms_deform_attn_bwd, ms_deform_attn_ref)
    for fn in (ms_deform_attn, ms_deform_attn_bwd, dsa_teacher_scan_fwd,
               dsa_teacher_scan_bwd, dsa_greedy_scan):
        fn.launches = 0
    for fn in (ms_deform_attn_ref, dsa_teacher_scan_ref, dsa_greedy_scan_ref):
        fn.calls = 0


def read_counts():
    from dvc_tpu_torch.ops import (dsa_greedy_scan, dsa_greedy_scan_ref,
                                   dsa_teacher_scan_bwd, dsa_teacher_scan_fwd,
                                   dsa_teacher_scan_ref, ms_deform_attn,
                                   ms_deform_attn_bwd, ms_deform_attn_ref)
    launches = {'msda_fwd': ms_deform_attn.launches,
                'msda_bwd': ms_deform_attn_bwd.launches,
                'dsa_scan_fwd': dsa_teacher_scan_fwd.launches,
                'dsa_scan_bwd': dsa_teacher_scan_bwd.launches,
                'dsa_greedy': dsa_greedy_scan.launches}
    plain = (ms_deform_attn_ref.calls + dsa_teacher_scan_ref.calls
             + dsa_greedy_scan_ref.calls)
    return launches, plain


def train_batch(opt, B):
    """One collated batch of the first B synthetic videos."""
    from dvc_tpu_torch.data import FusionDataset, fusion_collate
    ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt, seed=opt.seed)
    batch, _ = fusion_collate([ds[i % len(ds)] for i in range(B)],
                              opt.frame_embedding_num,
                              opt.gt_proposal_sample_num, opt.max_caption_len)
    return batch


def time_steps(trainer, batch, lr, reps):
    """Host-clock ms of one train step (after one warm-up step), and the
    last step's losses."""
    import torch
    trainer.train_step(batch, lr)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        losses = trainer.train_step(batch, lr)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3, losses


def phase_train(tmp):
    """The port's training driver (``dvc_tpu_torch.new_train.main``) for
    one --debug epoch (5 steps at B=1) of the full-width recipe on the
    synthetic run, with the launch counts set to 0 just before and read
    just after; then its checkpoint served on the card, a repeated-batch
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
    print(f'[train] new_train.main --debug, B=1: {seconds:.1f} s (setup, '
          f'5 steps, checkpoint); mean losses {json.dumps({k: round(v, 4) for k, v in losses.items()})}')
    print(f'[train] kernel launches {launches}, plain-version calls {plain}')
    bad = [k for k, v in losses.items() if not math.isfinite(v)]
    if bad or 'loss_caption' not in losses:
        raise AssertionError(f'train losses not finite: {bad}')
    if (min(launches[k] for k in ('msda_fwd', 'msda_bwd', 'dsa_scan_fwd',
                                  'dsa_scan_bwd')) < 1 or plain):
        raise AssertionError(f'train path did not run on the kernels: '
                             f'launches {launches}, plain calls {plain}')

    dc = DenseCaptioner(folder, which='last', device=DEVICE)
    rng = np.random.default_rng(3)
    events = dc.caption_features(
        rng.standard_normal((240, opt.feature_dim)).astype(np.float32), 150.0,
        sound=rng.standard_normal((240, opt.feature_dim)).astype(np.float32))
    check_events(events, 150.0)
    print(f'[train] the checkpoint served one request on the card: '
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
    trace('B=16 train_step', lambda: trainer.train_step(batch16, opt.lr))
    return launches, opt


# --------------------------------------------------------------------------
# 7. train agreement
# --------------------------------------------------------------------------

def phase_train_agreement(opt):
    """One train step's forward and backward on the card (kernels) against
    the CPU plain path, same weights and batch, dropout off: the same
    matching; every loss within 1e-4 relative (f32 on both, summation orders
    differ); every parameter's gradient within a relative L2 error of 1e-3
    + 1e-5 absolute (atomics and summation order), except alpha_net's bias,
    whose gradient is zero in exact arithmetic (as in ``check_scan``) and
    whose floor is 5e-5."""
    import torch
    from dvc_tpu_torch.models import make_fusion_model
    from dvc_tpu_torch.models.criterion import build_weight_dict
    from dvc_tpu_torch.train import bucket_caption_length
    batch = bucket_caption_length(train_batch(opt, 1))
    weights = build_weight_dict(opt)
    results = {}
    for dev in (DEVICE, 'cpu'):
        model = make_fusion_model(opt, dev, seed=0).train()
        tb = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        out, losses = model.forward_train(tb)
        sum(losses[k] * w for k, w in weights.items()
            if k in losses and w).backward()
        results[dev] = (out['matched_indices'].cpu(),
                        {k: float(v.detach()) for k, v in losses.items()},
                        {n: p.grad.cpu() for n, p in
                         model.named_parameters() if p.grad is not None})
    (gi, gl, gg), (ci, cl, cg) = results[DEVICE], results['cpu']
    loss_err = max(abs(gl[k] - cl[k]) / max(abs(cl[k]), 1e-6) for k in cl)
    floor = {n: (5e-5 if n.endswith('alpha_net.bias') else 1e-5) for n in cg}
    grad_err = {n: float((gg[n] - cg[n]).norm()
                         / (cg[n].norm() + floor[n] / 1e-3)) for n in cg}
    ranked = sorted(grad_err, key=grad_err.get, reverse=True)
    worst = ranked[0]
    same = bool((gi == ci).all())
    print(f'[train-agreement] card vs CPU plain, one B=1 step: matching '
          f'identical {same}; worst loss relative error {loss_err:.2e}; '
          f'worst gradient relative L2 errors over {len(cg)} parameters: '
          + ', '.join(f'{n} {grad_err[n]:.2e} (|grad| '
                      f'{float(cg[n].norm()):.2e})' for n in ranked[:3]))
    if not same or loss_err > 1e-4 or grad_err[worst] > 1e-3 \
            or sorted(gg) != sorted(cg):
        raise AssertionError('card and CPU disagree on the train step')


def main():
    device = phase_device()
    phase_build()
    kernels = phase_kernels()
    from dvc_tpu_torch.utils.config import load_config
    opt = load_config(CFG, root=ROOT)
    with tempfile.TemporaryDirectory() as tmp:
        dc = make_captioner(opt, tmp)
    serve_launches = phase_serve(dc)
    phase_agreement(dc)
    del dc
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, train_opt = phase_train(tmp)
        phase_train_agreement(train_opt)
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
    # kernels at B=1; the [kernels] lines above give every shape.  launches:
    # the serve path's run for msda_fwd and dsa_greedy, the train path's for
    # the others
    launches = {'msda_fwd': serve_launches['msda_fwd'],
                'dsa_greedy': serve_launches['dsa_greedy'],
                **{k: train_launches[k] for k in
                   ('msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd')}}
    sources = {'msda_fwd': ('ms_deform_attn.cu', 'ms_deform_attn.py:309'),
               'msda_bwd': ('ms_deform_attn.cu', 'ms_deform_attn.py:551'),
               'dsa_scan_fwd': ('dsa_scan.cu', 'dsa_scan.py:149'),
               'dsa_scan_bwd': ('dsa_scan.cu', 'dsa_scan.py:182'),
               'dsa_greedy': ('dsa_greedy.cu', 'dsa_greedy.py:131')}
    print(json.dumps({'kernels': [
        {'name': name, 'route': 'cuda',
         'source': f'dvc_tpu_torch/csrc/{src}',
         'replaces': f'dvc_tpu/ops/{tpu}',
         'launches': launches[name],
         'max_abs_err': max(r['max_abs_err'] for r in kernels[name]),
         'ms': kernels[name][0]['ms'], 'plain_ms': kernels[name][0]['plain_ms'],
         'bound_ms': kernels[name][0]['bound_ms'],
         'bound_by': kernels[name][0]['bound_by'], 'library_ms': None}
        for name, (src, tpu) in sources.items()]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': device['kind'], 'count': device['count']}}))


if __name__ == '__main__':
    main()
