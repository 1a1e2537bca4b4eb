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
   of their products' size against one-pass TF32; the MSDA backward at
   B=1 and at the B=16 train step's shapes; the scan also at cap_nheads 8,
   the word-step kernels (K7-K10, each with VW given; K8's and K10's
   gradients composed with the table's backward) at the stepwise path's
   train (B=1, Q=90) and serve (B=16, Q=100, H=1 and 8) shapes, to the
   scan's tolerances (``check_step``); then the phase split of the kernels
   redesigned for the card (K1/K2, K4-K10; ``SPLITS['current']``, one
   ``[split]`` line per kernel and shape).
   Tolerances:
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
   card's idle share).  Both kernels' launch counters must rise, no
   word-step kernel may launch and no plain version may run.
5. agreement — the same model's raw outputs on the card against the CPU
   run of the plain versions on one video.
6. train — ``dvc_tpu_torch.new_train.main`` for one ``--debug`` epoch (5
   steps at B=1) of the same recipe on a synthetic run written to a temp
   dir: finite losses, the launch counters of the MSDA forward and
   backward and of the scan forward and backward must rise, no word-step
   kernel may launch and no plain version may run; the checkpoint it wrote
   serves one request on the
   card; the total loss falls on a repeated batch; the train step timed at
   B=1 and B=16 and one B=16 step traced.
7. train agreement — one train step's losses and gradients on the card
   against the CPU plain path (same weights and batch, dropout off).
8. stepwise — the stepwise caption path: ``new_train.main`` for two
   --debug epochs with scheduled sampling from epoch 1 (ss_prob 0.25),
   once through K7/K8 and once with --dsa_lstm_fuse 1 through K9/K10 (the
   fused scan K4/K5 in epoch 0; one launch per word step, and under either
   flag one table VW and one table backward per train step; no plain
   version; tokens fed by scheduled sampling), the step timed at
   B=1 and B=16; the second run's checkpoint served with --dsa_greedy_fuse
   0 through K7 and K9 against the fused greedy kernel (>= 90% of the
   captions identical); the train agreement of phase 7 with
   --dsa_scan_fuse 0 for both pairs.  Then a check that neither JAX nor
   any module of the JAX package ``dvc_tpu`` (by name or by file) was
   imported.

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
# the word-step kernels of the stepwise caption path and their table VW
# (built by the caption head), which the default flags (fused scan and
# greedy decode) never launch
STEP_KERNELS = ('dsa_step_fwd', 'dsa_step_bwd', 'dsa_lstm_fwd',
                'dsa_lstm_bwd', 'table_gemm', 'table_gemm_bwd')
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
                              float* out, float* work, long long work_floats,
                              void* stream) {
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
        fn.argtypes = [P, I, I, P, I, I, I, I, I, I, P, P, ctypes.c_longlong, P]
        fn.restype = I
        _PROBE['fn'] = fn
    return _PROBE['fn']


def gemm_fn():
    """The C function (x, ldx, x_by_term, y, ldy, y_by_term, M, N, T,
    accumulate, out, work, work_floats, stream) -> CUDA error code that runs
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


def run_outer_sum(X, Y, out, work):
    """out (m, n) = X (rows, m)^T Y (rows, n) by dsa::gemm's outer_sum, as
    K5 and K10 run it (both operands along the terms), on the current
    stream; raises on a refused launch."""
    import torch
    (rows, m), n = X.shape, Y.shape[1]
    code = gemm_fn()(X.data_ptr(), X.stride(0), 1, Y.data_ptr(), Y.stride(0), 1,
                     m, n, rows, 0, out.data_ptr(), work.data_ptr(),
                     work.numel(), torch.cuda.current_stream().cuda_stream)
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
    backward at B=1, the backward also at B=16, scan at B=1 and B=16 with
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
                    '      atomic_add4(G_b + ol + c, mul4(wl, du));\n'
                    '      atomic_add4(G_b + oh + c, mul4(wh, du));\n', '')]),
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
_MSDA_GATHERS = ('        for (; j + 4 <= n; j += 4)\n'
                 '          gather_points<V, 4>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);\n'
                 '        for (; j < n; ++j)\n'
                 '          gather_points<V, 1>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);\n')
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
        'msda_fwd': ('ms_deform_attn.cu', [
            ('staging', [('ms_deform_attn.cu',
                          '  if (copy == 16) stage_rows<16>(sv, src, S, D, HD);\n'
                          '  else if (copy == 8) stage_rows<8>(sv, src, S, D, HD);\n'
                          '  else stage_rows<4>(sv, src, S, D, HD);\n', '')]),
            ('gathers', [('ms_deform_attn.cu', _MSDA_GATHERS, '')]),
        ]),
        'dsa_greedy': ('dsa_greedy.cu', [
            ('tables VW, TW', [('dsa_greedy.cu', '(e = row_table(value_t, cw, B * H * S, Dh, A, vw, st, work, wf)) != cudaSuccess ||\n'
                                '      (e = row_table(embed, token_w, V1, E, 4 * R, tw, st, work, wf)) != cudaSuccess',
                                'false')]),
            ('scores from VW', [('dsa_greedy.cu', '    attend_scores_table<QT>(at, sm, vw_b, ab);\n', '')]),
            ('ctx', [('dsa_greedy.cu', 'attend_softmax_ctx<QT>(at, sm, value_b);',
                      'attend_softmax<QT>(at, sm);')]),
            ('h.W_hh + ctx.ctx_w3', [('dsa_greedy.cu',
                                      'add_gates(sm.h, ldR, R, a.w_hh, r, R, z);\n'
                                      '      add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);', '')]),
            ('logits', [('dsa_greedy.cu',
                         'cols_dot_rows<QT, LC>(sm.h, ldR, R, a.logit_w, a.V1, n0, acc);', '')]),
        ]),
        'dsa_scan_bwd': ('dsa_scan.cu', [
            ('table VW', [('dsa_scan.cu', 'if ((e = row_table(value_t, cw, BHS, Dh, A, vw, st, work, wf)) != cudaSuccess) return (int)e;', '')]),
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
        'dsa_scan_fwd': ('dsa_scan.cu', [
            ('table VW', [('dsa_scan.cu', '  e = row_table(value_t, cw, B * H * S, Dh, A, vw, st, work, work_floats);\n', '')]),
            ('scores from VW', [('dsa_scan.cu',
                                 '    attend_scores_table<QT>(at, sm, vw_b, ab);\n'
                                 '    attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
                                 '    attend_softmax_ctx<QT>(at, sm, value_b);\n\n')]),
            ('ctx', [('dsa_scan.cu', 'attend_softmax_ctx<QT>(at, sm, value_b);\n\n    // ---- z',
                      'attend_softmax<QT>(at, sm);\n\n    // ---- z')]),
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
            ('scores from VW', [('dsa_step.cu',
                                 '  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));\n'
                                 '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
                                 '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n')]),
            ('ctx', [('dsa_step.cu', '  attend_softmax_ctx<QT>(at, sm, value_b);\n\n',
                      '  attend_softmax<QT>(at, sm);\n\n')]),
            ('h.W_hh', [('dsa_step.cu', *_STEP_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_STEP_GATES_CTX)]),
            ('cell', [('dsa_step.cu', *_STEP_CELL)]),
        ]),
        'dsa_lstm_bwd': ('dsa_step.cu', [
            ('scores from VW', [('dsa_step.cu',
                                 '  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));\n'
                                 '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for',
                                 '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for')]),
            ('ctx', [('dsa_step.cu', '  attend_softmax_ctx<QT>(at, sm, value_b);\n  for',
                      '  attend_softmax<QT>(at, sm);\n  for')]),
            ('h.W_hh', [('dsa_step.cu', *_STEP_GATES_H)]),
            ('ctx.ctx_w3', [('dsa_step.cu', *_STEP_GATES_CTX)]),
            ('cell_bwd', [('dsa_step.cu', *_CELL_BWD)]),
            ('dz.W^T', [('dsa_step.cu', 'gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh,',
                         'gates_backprop_rows<QT>(dz_s, R, -R, a.w_hh,')]),
            *_TABLE_BWD,
            ('outer sums', [('dsa_step.cu', 'const int N = B * Q, HD = H * Dh;',
                             'const int N = 0, HD = H * Dh;')]),
        ]),
    },
}


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


def split_cases(kernels):
    """(kernel, shape label, call) of each split of ``kernels``: K1/K2 at
    the MSDA shapes of ``phase_kernels`` ((B, Q) = (16, 375), (16, 100),
    (1, 375)); K6 at the serving shape (B=16, Q=100, H=1 and 8); K4 and K5
    at the train shapes (Q=90, K=29; B=1 and 16 at H=1, B=1 at H=8); K7-K10
    (alone, with VW given) at the word-step shapes of ``check_step`` (B=1,
    Q=90, H=1; B=16, Q=100, H=1 and 8)."""
    import torch
    from dvc_tpu_torch.ops.dsa_greedy import dsa_greedy_scan
    from dvc_tpu_torch.ops.dsa_scan import (dsa_teacher_scan_bwd,
                                            dsa_teacher_scan_fwd)
    from dvc_tpu_torch.ops.dsa_step import (dsa_lstm_step_bwd,
                                            dsa_lstm_step_fwd,
                                            dsa_sample_attend_bwd,
                                            dsa_sample_attend_fwd)
    from dvc_tpu_torch.ops.ms_deform_attn import ms_deform_attn
    gen = torch.Generator(device='cuda').manual_seed(0)
    cases = []
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
    return cases


def phase_split(spec):
    """Print one line per kernel and shape: its time as built, and each
    phase's share (as built minus the variant without that phase; CUDA
    events, mean of 3 after a warm-up).  Returns {kernel: [lines]}."""
    import torch
    from dvc_tpu_torch.ops import _cuda
    t0 = time.perf_counter()
    libs = build_variants(_cuda.CSRC, {
        kernel: (source, {'as built': [], **dict(phases)})
        for kernel, (source, phases) in SPLITS[spec].items()})
    print(f'[split] {sum(map(len, libs.values()))} variants of '
          f'{len(libs)} kernels built in {time.perf_counter() - t0:.1f} s')
    saved, out = _cuda._LIB, {}
    try:
        with torch.inference_mode():
            for kernel, shape, call in split_cases(libs):
                times = {}
                for name, lib in libs[kernel].items():
                    _cuda._LIB = lib
                    times[name] = cuda_ms(call, 3)
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


def ab_times():
    """Kernel-only CUDA-event times (ms) of every kernel at the phase-3
    shapes, plus the greedy decode at B=1 (a single caption_features
    request), and of the GEMM at every shape of ``phase_gemm``, as one JSON
    line: the half of an A/B of two trees in one call.  The MSDA forward
    also in device time (the profiler's; the event time of a small launch
    is the wrapper's host time); the word-step kernels alone (with VW given
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
        for B, Q in ((1, 375), (1, 100), (16, 375), (16, 100)):
            value, loc, attn = msda_inputs(gen, B, Q)
            g = torch.randn((B, Q, 512), generator=gen, device='cuda')
            out[f'msda_bwd B={B} Q={Q}'] = cuda_ms(
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
    gemm = {n: us for n, us in per_name.items()
            if 'gemm_kernel' in n or 'split_sum_kernel' in n}
    if gemm:
        outer = sum(us for n, us in gemm.items() if 'true, true>' in n)
        print(f'[trace]   {sum(gemm.values()) / 1e3:9.3f} ms  dsa::gemm in all '
              f'(tables, G . Wc^T, outer sums, split sums); the outer sums\' '
              f'kernels (both operands along the terms) {outer / 1e3:.3f} ms')


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
               'table_gemm_bwd': dsa_tables.table_gemm_bwd}
    plain = (ops.ms_deform_attn_ref, ops.dsa_teacher_scan_ref,
             ops.dsa_greedy_scan_ref, ops.sample_attend_ref,
             dsa_step.sample_attend_table_ref, ops.lstm_step_ref,
             dsa_step.lstm_step_table_ref, dsa_tables.table_gemm_ref,
             dsa_tables.table_gemm_bwd_ref)
    return kernels, plain


def reset_counts():
    kernels, plain = _counted()
    for fn in kernels.values():
        fn.launches = 0
    for fn in plain:
        fn.calls = 0


def read_counts():
    """({kernel: launches}, plain-version calls) since reset_counts()."""
    kernels, plain = _counted()
    return ({k: fn.launches for k, fn in kernels.items()},
            sum(fn.calls for fn in plain))


def train_batch(opt, B):
    """One collated batch of the first B synthetic videos."""
    from dvc_tpu_torch.data import FusionDataset, fusion_collate
    ds = FusionDataset(opt.train_caption_file, opt.visual_feature_folder,
                       opt.dict_file, opt, seed=opt.seed)
    batch, _ = fusion_collate([ds[i % len(ds)] for i in range(B)],
                              opt.frame_embedding_num,
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
                                  'dsa_scan_bwd')) < 1 or plain
            or any(launches[k] for k in STEP_KERNELS)):
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

def phase_train_agreement(opt, label='train-agreement'):
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
    print(f'[{label}] card vs CPU plain, one B=1 step: matching '
          f'identical {same}; worst loss relative error {loss_err:.2e}; '
          f'worst gradient relative L2 errors over {len(cg)} parameters: '
          + ', '.join(f'{n} {grad_err[n]:.2e} (|grad| '
                      f'{float(cg[n].norm()):.2e})' for n in ranked[:3]))
    if not same or loss_err > 1e-4 or grad_err[worst] > 1e-3 \
            or sorted(gg) != sorted(cg):
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


def main():
    device = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_split('current')
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
        step_launches, folder = phase_stepwise_train(tmp)
        phase_stepwise_serve(folder)
        phase_stepwise_agreement(train_opt)
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
    # the [kernels] lines above give every shape.  launches: the
    # serve path's run for msda_fwd and dsa_greedy, the train path's for the
    # others, the stepwise train runs' for the word-step kernels, and both
    # stepwise runs' for the table
    launches = {'msda_fwd': serve_launches['msda_fwd'],
                'dsa_greedy': serve_launches['dsa_greedy'],
                **{k: train_launches[k] for k in
                   ('msda_bwd', 'dsa_scan_fwd', 'dsa_scan_bwd')},
                **{k: step_launches[lstm][k]
                   for lstm, names in STEPWISE.items() for k in names},
                **{k: step_launches[False][k] + step_launches[True][k]
                   for k in ('table_gemm', 'table_gemm_bwd')}}
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
               'table_gemm_bwd': ('dsa_tables.cu', 'dsa_step.py:566')}
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
    if sys.argv[1:2] == ['--split']:
        phase_device()
        phase_split(sys.argv[2] if len(sys.argv) > 2 else 'current')
    elif sys.argv[1:2] == ['--ab']:
        phase_device()
        ab_times()
    elif sys.argv[1:2] == ['--gemm']:
        phase_device()
        phase_build()
        phase_gemm()
    else:
        main()
