"""Teacher-forcing word scan of the LSTM-DSA caption head, forward and
backward (port of ``dvc_tpu/ops/dsa_scan.py``).

* :func:`dsa_teacher_scan_ref` — the plain PyTorch K-step loop (the JAX
  ``dsa_teacher_scan_ref``): each step is the greedy decode's attention
  (:func:`dvc_tpu_torch.ops.dsa_greedy.attend_step`) and the bias-free
  LSTM cell on ``z_all[:, k] + h W_hh + ctx ctx_w3``.  Its backward is
  autograd through it (:func:`dsa_teacher_scan_bwd_ref`).
* :func:`dsa_teacher_scan` — the wrapper the caption head calls: CUDA
  tensors go to :class:`DSATeacherScanFunction` (forward kernel
  ``dvc_dsa_scan_fwd``, backward kernel ``dvc_dsa_scan_bwd`` in
  ``csrc/dsa_scan.cu``; both build the table ``value_t . cw`` first, and
  the backward adds ``G . cw^T`` to dvalue last); CPU tensors go to the
  plain version.
* :func:`dsa_teacher_scan_fwd` / :func:`dsa_teacher_scan_bwd` — the two
  kernels alone: they take CUDA tensors only.

Arguments, as in the JAX package: value_t (B, H, S, Dh); base_pos
(B, H, Q, LP) level-relative base positions; scale_t (B, Q, LP); z_all
(B, K, Q, 4R) the hoisted token and query shares of the LSTM
preactivation; off_w_h (H, R, LP); h2att_w (R, A); h2att_b (A,); cw
(Dh, A); cb (A,); aw (A,); ab a 0-d tensor; ctx_w3 (H, Dh, 4R); w_hh
(R, 4R).  The scan returns hs (B, K, Q, R), the hidden state after each
word step.

``precision='bfloat16'`` (``--tpu_compute_dtype bfloat16``) is the TPU
kernels' bf16 variant: every product of the step and of its backward on
bf16-rounded operands with f32 accumulation.  Its plain versions are
:func:`dvc_tpu_torch.ops.dsa_bf16.scan_fwd` and ``scan_bwd`` (on the CPU
:class:`~dvc_tpu_torch.ops.dsa_bf16.PlainScanBf16` joins them for
autograd); on the card the same kernels run in their bf16-operand mode
(K4-bf16, K5-bf16), counted apart in ``launches_bf16``, with the step's
large products on the tensor cores from weights packed once a forward
and backward (``pack_scan_weights``: ``pack_gate_weights`` and
``pack_hidden_weights``; ``gate_products_tiles`` and
``hidden_products_tiles`` mirror those products on the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _cuda, dsa_bf16
from .dsa_greedy import _level_bounds, attend_step, check_precision, lstm_cell

NAMES = ('value_t', 'base_pos', 'scale_t', 'z_all', 'off_w_h', 'h2att_w',
         'h2att_b', 'cw', 'cb', 'aw', 'ab', 'ctx_w3', 'w_hh')


def dsa_teacher_scan_ref(value_t, base_pos, scale_t, z_all, off_w_h,
                         h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3, w_hh,
                         temporal_shapes, precision='float32'):
    """Plain K-step scan.  Returns (hs, cs), each (B, K, Q, R).
    ``precision`` 'bfloat16': the bf16-operand products (:mod:`.dsa_bf16`)."""
    dsa_teacher_scan_ref.calls += 1
    if check_precision(precision):
        return dsa_bf16.scan_fwd(value_t, base_pos, scale_t, z_all, off_w_h,
                                 h2att_w, h2att_b, cw, cb, aw, ab, ctx_w3,
                                 w_hh, temporal_shapes)
    B, K, Q = z_all.shape[:3]
    R = w_hh.shape[0]
    P = scale_t.shape[-1] // len(temporal_shapes)
    hib, s0 = _level_bounds(temporal_shapes, P, value_t.device)
    h = value_t.new_zeros((B, Q, R))
    c = value_t.new_zeros((B, Q, R))
    hs, cs = [], []
    for k in range(K):
        ctx = attend_step(h, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, ab, hib, s0)
        z = (z_all[:, k] + h @ w_hh
             + torch.einsum('bhqd,hdr->bqr', ctx, ctx_w3))
        h, c = lstm_cell(z, c)
        hs.append(h)
        cs.append(c)
    return torch.stack(hs, 1), torch.stack(cs, 1)


dsa_teacher_scan_ref.calls = 0


def dsa_teacher_scan_bwd_ref(*args, precision='float32'):
    """Plain backward: autograd through :func:`dsa_teacher_scan_ref`.
    ``args`` = the 13 operands, temporal_shapes, hs, cs, g (hs and cs are
    recomputed, not read).  Returns the 13 gradients in argument order.
    ``precision`` 'bfloat16': the TPU kernel's bf16 backward
    (:func:`dvc_tpu_torch.ops.dsa_bf16.scan_bwd`, which reads hs and cs)."""
    if check_precision(precision):
        return dsa_bf16.scan_bwd(*args)
    *ops, temporal_shapes, _hs, _cs, g = args
    with torch.enable_grad():
        ops = [torch.as_tensor(t).detach().requires_grad_() for t in ops]
        hs, _ = dsa_teacher_scan_ref(*ops, temporal_shapes)
        return torch.autograd.grad(hs, ops, g)


def gate_geometry(R, HD):
    """(Rp, KKp): the units and the terms of the packed gate weights, R
    padded to a multiple of 32 and R + HD to one of 64, as the kernel's
    ``GateGeom`` (csrc/dsa_common.cuh)."""
    return -(-R // 32) * 32, -(-(R + HD) // 64) * 64


def _fragment_order(idx):
    """idx (M, K), M and K multiples of 16, as (M/16, K/16, 32, 8): for each
    16 x 16 tile the A fragment of mma.sync.m16n8k16 of each of the 32
    lanes (lane l: rows l/4 and l/4 + 8, terms 2(l%4) + {0, 1, 8, 9}; pairs
    a0 = (row l/4, terms 2(l%4), +1), a1 = (row l/4 + 8, same terms), a2 and
    a3 the same rows at terms + 8)."""
    M, K = idx.shape
    t = idx.reshape(M // 16, 16, K // 16, 16).permute(0, 2, 1, 3)
    lane = torch.arange(32, device=idx.device)
    g, q = lane // 4, 2 * (lane % 4)
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    cols = torch.stack([q, q + 1, q, q + 1, q + 8, q + 9, q + 8, q + 9], 1)
    return t[:, :, rows, cols]


_GATE_INDEX = {}


def gate_index(R, HD, device):
    """The source of each bf16 element of the packed gate weights
    (``pack_gate_weights``) as an index into cat(w_hh.flatten(),
    ctx_w3.flatten(), [0]) (the last element: the zero padding), made once
    per (R, H*Dh, device).  P (KKp, 4Rp) holds [W_hh; ctx_w3] (KK = R + HD
    rows, 4R gate columns) with its columns in unit-block order: column
    ub*32 + gate*8 + j is gate (i, f, g, o) of unit ub*8 + j.  The packing is
    P^T's fragments (the recompute, M = 4Rp) followed by P's (the
    backprop, M = KKp)."""
    key = (R, HD, str(device))
    if key not in _GATE_INDEX:
        with torch.inference_mode(False):      # a normal tensor, reused
            _GATE_INDEX[key] = _gate_index(R, HD, device)
    return _GATE_INDEX[key]


def _gate_index(R, HD, device):
    Rp, KKp = gate_geometry(R, HD)
    rho = torch.arange(4 * Rp, device=device)
    unit = rho // 32 * 8 + rho % 8
    col = (rho % 32) // 8 * R + unit
    k = torch.arange(KKp, device=device)
    flat = torch.where((k[:, None] < R + HD) & (unit[None, :] < R),
                       k[:, None] * 4 * R + col[None, :], (R + HD) * 4 * R)
    return torch.cat([_fragment_order(flat.T).reshape(-1),
                      _fragment_order(flat).reshape(-1)])


_ZERO = {}


def _zero(dev):
    """A one-element zero on ``dev``, the packings' padding, made once."""
    if dev not in _ZERO:
        with torch.inference_mode(False):
            _ZERO[dev] = torch.zeros(1, dtype=torch.float32, device=dev)
    return _ZERO[dev]


def pack_gate_weights(w_hh, ctx_w3, backprop=True):
    """The gate weights of K4-bf16, K5-bf16 and K6-bf16, packed once a
    launch: W_hh (R, 4R) and ctx_w3 (H, Dh, 4R) rounded to bf16 in the
    order in which the kernels read their A fragments (``gate_index``), a
    flat torch.bfloat16 tensor of 2 x 4Rp x KKp elements (8 MB at R = H*Dh
    = 512); ``backprop=False``: the first half only, P^T, which the
    forward kernels read (K6-bf16).  Three device activities: the
    concatenation, the rounding, the gather."""
    R = w_hh.shape[0]
    HD = ctx_w3.numel() // (4 * R)
    dev = w_hh.device
    index = gate_index(R, HD, dev)
    if not backprop:
        Rp, KKp = gate_geometry(R, HD)
        index = index[:4 * Rp * KKp]
    with torch.no_grad():       # a kernel operand: its gradient is the kernel's
        src = torch.cat([w_hh.reshape(-1), ctx_w3.reshape(-1), _zero(dev)])
        return src.to(torch.bfloat16)[index]


def unpack_gate_weights(packed, R, HD):
    """(P^T, P) from ``pack_gate_weights``' output: the recompute's and
    the backprop's operands (4Rp, KKp) and (KKp, 4Rp) in bf16, zero where
    padded (the inverse of the fragment order)."""
    Rp, KKp = gate_geometry(R, HD)
    n = 4 * Rp * KKp
    return (_unfragment(packed[:n], 4 * Rp, KKp),
            _unfragment(packed[n:], KKp, 4 * Rp))


def _unfragment(part, M, K):
    """The (M, K) operand whose fragment order (``_fragment_order``) is
    ``part``."""
    pos = _fragment_order(torch.arange(M * K, device=part.device)
                          .reshape(M, K)).reshape(-1)
    flat = torch.empty(M * K, dtype=part.dtype, device=part.device)
    flat[pos] = part
    return flat.reshape(M, K)


def hidden_geometry(R, N):
    """(Np, Rl): the rows and the terms of a packed product h . W of the
    hidden state (``pack_hidden_weights``), W's N columns padded to a
    multiple of 16 (an m-tile) and its R rows to one of 64 (batches of 4
    k-tiles), as the kernels' ``HiddenGeom`` (csrc/dsa_common.cuh)."""
    return -(-N // 16) * 16, -(-R // 64) * 64


_HIDDEN_INDEX = {}


def hidden_index(R, N, device):
    """The source of each bf16 element of a packed W (R, N)
    (``pack_hidden_weights``) as an index into cat(W.flatten(), [0]) (the
    last element: the zero padding), made once per (R, N, device): the
    fragments of W^T (Np, Rl), whose element (n, k) is W[k, n] for n < N
    and k < R."""
    key = (R, N, str(device))
    if key not in _HIDDEN_INDEX:
        Np, Rl = hidden_geometry(R, N)
        n = torch.arange(Np, device=device)
        k = torch.arange(Rl, device=device)
        flat = torch.where((n[:, None] < N) & (k[None, :] < R),
                           k[None, :] * N + n[:, None], R * N)
        with torch.inference_mode(False):      # a normal tensor, reused
            _HIDDEN_INDEX[key] = _fragment_order(flat).reshape(-1).clone()
    return _HIDDEN_INDEX[key]


def pack_hidden_weights(w):
    """A weight W (R, N) of a product h . W of the hidden state, packed
    once a launch for the tensor cores (K6-bf16's logit_w; hvec's h2att_w
    in K4-K6-bf16): W^T rounded to bf16, zero-padded to (Np, Rl)
    (``hidden_geometry``), in the fragment order of ``pack_gate_weights``
    (``hidden_index``), a flat torch.bfloat16 tensor (1.6 MB for logit_w
    at R = 512, V1 = 1608; 0.5 MB for h2att_w at A = 512).  Three device
    activities: the concatenation, the rounding, the gather."""
    R, N = w.shape
    dev = w.device
    with torch.no_grad():
        src = torch.cat([w.reshape(-1), _zero(dev)])
        return src.to(torch.bfloat16)[hidden_index(R, N, dev)]


def unpack_hidden_weights(packed, R, N):
    """W^T (Np, Rl) in bf16 from ``pack_hidden_weights``' output, zero
    where padded."""
    return _unfragment(packed, *hidden_geometry(R, N))


def _tile_product(frags, M, K, act):
    """Plain mirror of ``gate_mma`` (csrc/dsa_common.cuh): the (M, K)
    operand read as 16 x 16 A tiles from its packed fragments (lane l's 8
    elements at their rows and terms) times the activations act (QT, <= K)
    rounded to bf16, the tile's queries the n side in n8 tiles (two at QT =
    16), each tile's product summed over the k-tiles in order in f32.
    Returns (M, QT)."""
    QT = act.shape[0]
    NT = -(-QT // 8)
    lane = torch.arange(32)
    g, q = lane // 4, 2 * (lane % 4)
    rows = torch.stack([g, g, g + 8, g + 8, g, g, g + 8, g + 8], 1)
    cols = torch.stack([q, q + 1, q, q + 1, q + 8, q + 9, q + 8, q + 9], 1)
    tiles = frags.reshape(M // 16, K // 16, 32, 8).float()
    b = torch.zeros((K, 8 * NT), dtype=torch.float32)
    b[:act.shape[1], :QT] = act.to(torch.bfloat16).float().T
    out = torch.zeros((M, 8 * NT), dtype=torch.float32)
    for mt in range(M // 16):
        for nt in range(NT):
            d = torch.zeros((16, 8), dtype=torch.float32)
            for kt in range(K // 16):
                a = torch.zeros((16, 16), dtype=torch.float32)
                a[rows, cols] = tiles[mt, kt]
                d += a @ b[kt * 16:(kt + 1) * 16, nt * 8:(nt + 1) * 8]
            out[mt * 16:(mt + 1) * 16, nt * 8:(nt + 1) * 8] = d
    return out[:, :QT]


def gate_products_tiles(packed, x, dz, R, HD):
    """Plain mirror of the bf16 gate products as the kernels address them
    (K4-bf16's and K6-bf16's forward, K5-bf16's recompute and backprop):
    z^T = P^T x^T (x (QT, KK) = [h | ctx]) and [dh | dctx]^T = P dz^T (dz
    (QT, 4R)) tile by tile from the packed fragments (``_tile_product``),
    QT <= 16.  ``dz`` None: the forward only (``packed`` may then be P^T's
    half alone).  Returns (z (QT, 4R) without its other terms, in the
    natural gate order, and [dh | dctx] (QT, KK) or None)."""
    Rp, KKp = gate_geometry(R, HD)
    QT = x.shape[0]
    n = 4 * Rp * KKp
    zt = _tile_product(packed[:n], 4 * Rp, KKp, x)        # rows: gate order
    rho = torch.arange(4 * Rp)
    unit = rho // 32 * 8 + rho % 8
    keep = unit < R
    col = ((rho % 32) // 8 * R + unit)[keep]
    z = torch.zeros((QT, 4 * R), dtype=torch.float32)
    z[:, col] = zt[keep].T
    if dz is None:
        return z, None
    dzp = torch.zeros((QT, 4 * Rp), dtype=torch.float32)
    dzp[:, keep] = dz[:, col]
    dxt = _tile_product(packed[n:], KKp, 4 * Rp, dzp)
    return z, dxt[:R + HD].T


def hidden_products_tiles(packed, h, R, N):
    """Plain mirror of a product h . W on the tensor cores as the kernels
    address it (``hidden_mma``: K6-bf16's logits, hvec in K4-K6-bf16):
    (h W)^T = W^T h^T (h (QT, R), QT <= 16) tile by tile from the packed W^T
    (``pack_hidden_weights``), the padded rows included.  Returns (QT, Np),
    without a bias."""
    Np, Rl = hidden_geometry(R, N)
    return _tile_product(packed, Np, Rl, h).T


def lse_merge(a, b):
    """Mirror of ``lse_merge`` (csrc/dsa_greedy.cu): (max, sum of exp(x -
    max), first-max index) a with b merged in; sum 0 marks an empty
    partial.  f32 arithmetic."""
    m, s, i = a
    m2, s2, i2 = b
    if s2 == 0:
        return a
    if s == 0:
        return b
    if m2 > m:
        return m2, s * np.exp(m - m2) + s2, i2
    return m, s + s2 * np.exp(m2 - m), min(i, i2) if m2 == m else i


def logits_pick_tiles(logits, logit_b, V1, warps=16):
    """Plain mirror of K6-bf16's choice from the logits (QT, V1p) of
    ``hidden_products_tiles`` as the kernel merges them: warp w takes the
    m-tiles w, w + warps, ..., its lane (g, q) the rows g and g + 8 of a
    tile for the queries 2q + {0, 1} (+ 8), each logit (plus the bias)
    merged into the lane's online (max, sum-exp, first-max index), rows n
    >= V1 skipped; then the lanes of a warp (the shuffles down by 16, 8,
    4, 2, 1) and the warps in order.  Returns (tok (QT,) int32, lp (QT,)
    = max - log(sum-exp))."""
    QT, V1p = logits.shape
    one = np.float32(1)
    empty = (np.float32(-np.inf), np.float32(0), 2 ** 31 - 1)
    logits, bias = logits.float().numpy(), logit_b.float().numpy()
    toks, lps = [], []
    for qi in range(QT):
        per_warp = []
        for w in range(warps):
            lanes = [empty] * 32
            for mt in range(w, V1p // 16, warps):
                for lane in range(32):
                    g, q = lane // 4, lane % 4
                    if (qi % 8) // 2 != q:
                        continue
                    for hh in (0, 1):
                        n = mt * 16 + g + 8 * hh
                        if n < V1:
                            lanes[lane] = lse_merge(
                                lanes[lane], (logits[qi, n] + bias[n], one, n))
            for o in (16, 8, 4, 2, 1):
                lanes = [lse_merge(lanes[i], lanes[i + o]) if i + o < 32
                         else lanes[i] for i in range(32)]
            per_warp.append(lanes[0])
        m, s, i = empty
        for part in per_warp:
            m, s, i = lse_merge((m, s, i), part)
        toks.append(i)
        lps.append(m - (m + np.log(s)))
    return (torch.tensor(toks, dtype=torch.int32),
            torch.from_numpy(np.array(lps, dtype=np.float32)))


def _kernel_operands(args, temporal_shapes, rb=False, packs=None,
                     forward=False):
    """Check the operands of a kernel launch; returns (dims, contiguous
    operands, ab as a one-element device tensor, extras).  Where ``rb``
    (K4-bf16, K5-bf16): value_t and the weights of the step's products
    rounded to bf16, cw in bf16 (the table's GEMM operand only), and extras
    = (value_t in bf16, for the GEMMs; the packed gate weights and
    h2att_w, ``packs`` where given (``pack_scan_weights``), else packed
    here); the kernels then read neither w_hh nor ctx_w3, and the forward
    (``forward``) not h2att_w either, so those are passed unrounded; else
    extras = (None, None, None)."""
    (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b, cw, cb,
     aw, ab, ctx_w3, w_hh) = args
    dev = value_t.device
    ab = torch.as_tensor(ab, dtype=torch.float32, device=dev).reshape(1)
    tensors = (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b,
               cw, cb, aw, ab, ctx_w3, w_hh)
    if dev.type != 'cuda':
        raise ValueError('the scan kernels take CUDA tensors; the plain '
                         'versions are dsa_teacher_scan_ref and '
                         'dsa_teacher_scan_bwd_ref')
    if any(t.dtype != torch.float32 or t.device != dev for t in tensors):
        raise TypeError('the scan kernels take float32 tensors on one device')
    B, H, S, Dh = value_t.shape
    K, Q = z_all.shape[1], z_all.shape[2]
    R = w_hh.shape[0]
    LP = scale_t.shape[-1]
    A = h2att_w.shape[1]
    L = len(temporal_shapes)
    expect = ((B, H, S, Dh), (B, H, Q, LP), (B, Q, LP), (B, K, Q, 4 * R),
              (H, R, LP), (R, A), (A,), (Dh, A), (A,), (A,), (1,),
              (H, Dh, 4 * R), (R, 4 * R))
    bad = [NAMES[i] for i, (t, s) in enumerate(zip(tensors, expect))
           if tuple(t.shape) != s]
    if bad or LP % L or sum(temporal_shapes) != S:
        raise ValueError(f'scan kernel: inconsistent shapes of {bad}')
    extras = (None, None, None)
    if rb:
        value16 = dsa_bf16.bf16_operand(value_t)
        if packs is None:
            packs = pack_scan_weights(w_hh, ctx_w3, h2att_w)
        kept = ('value_t', 'cw', 'ctx_w3', 'w_hh') + ('h2att_w',) * forward
        tensors = [dsa_bf16.bf16(t) if n in dsa_bf16.ROUNDED and n not in kept
                   else t for n, t in zip(NAMES, tensors)]
        tensors[0] = value16.float()
        tensors[7] = dsa_bf16.bf16_operand(cw)
        extras = (value16, *packs)
    # the backward reads rows as float4: a view's storage offset may leave
    # them unaligned, a copy does not
    tensors = [t.contiguous() for t in tensors]
    tensors = [t.clone() if t.data_ptr() % 16 else t for t in tensors]
    return (B, H, S, Dh, Q, LP, L, A, R, K), tensors, extras


def pack_scan_weights(w_hh, ctx_w3, h2att_w):
    """The packed bf16 operands of K4-bf16's and K5-bf16's tensor-core
    products: (the gate weights, ``pack_gate_weights``; h2att_w,
    ``pack_hidden_weights``)."""
    return pack_gate_weights(w_hh, ctx_w3), pack_hidden_weights(h2att_w)


def _ptr(t):
    """A tensor's device pointer, or 0 (NULL) for None."""
    return 0 if t is None else t.data_ptr()


def dsa_teacher_scan_fwd(*args, precision='float32', packs=None):
    """(hs, cs) of the scan by the kernel ``dvc_dsa_scan_fwd`` (K4, or
    K4-bf16 under ``precision='bfloat16'``), or an error.  ``args`` = the
    13 operands (CUDA tensors), temporal_shapes.  ``packs``: K4-bf16's
    packed weights (``pack_scan_weights``), else packed here."""
    rb = check_precision(precision)
    *ops, temporal_shapes = args
    dims, ops, (value16, wpack, hpack) = _kernel_operands(
        ops, temporal_shapes, rb, packs, forward=True)
    B, H, S, Dh, Q, LP, L, A, R, K = dims
    hs = torch.empty((B, K, Q, R), dtype=torch.float32, device=ops[0].device)
    cs = torch.empty_like(hs)
    # scratch: the table value_t . cw that the kernel scores from, and its
    # GEMM's split-K partial tiles
    vw = torch.empty((B, H, S, A), dtype=torch.float32, device=hs.device)
    work = _cuda.gemm_work(hs.device, (B * H * S, A, Dh))
    _cuda.check(_cuda.lib().cdll.dvc_dsa_scan_fwd(
        ops[0].data_ptr(), _ptr(value16), *(t.data_ptr() for t in ops[1:]),
        _ptr(wpack), _ptr(hpack), _cuda.levels_array(temporal_shapes),
        hs.data_ptr(), cs.data_ptr(), vw.data_ptr(), work.data_ptr(), *dims,
        work.numel(), int(rb), _cuda.stream_ptr(hs.device)), 'dvc_dsa_scan_fwd')
    _cuda.count_launch(dsa_teacher_scan_fwd, rb)
    return hs, cs


dsa_teacher_scan_fwd.launches = 0
dsa_teacher_scan_fwd.launches_bf16 = 0


def dsa_teacher_scan_bwd(*args, precision='float32', packs=None):
    """The 13 gradients of the scan for the cotangent g (B, K, Q, R) of hs,
    by the kernel ``dvc_dsa_scan_bwd`` (K5, or K5-bf16 under
    ``precision='bfloat16'``), or an error.  ``args`` = the 13 operands
    (CUDA tensors), temporal_shapes, hs, cs, g.  ``packs``: K5-bf16's
    packed weights (the forward's, ``pack_scan_weights``), else packed
    here."""
    rb = check_precision(precision)
    *ops, temporal_shapes, hs, cs, g = args
    ab_shape = torch.as_tensor(ops[10]).shape
    dims, ops, (value16, wpack, hpack) = _kernel_operands(
        ops, temporal_shapes, rb, packs)
    B, H, S, Dh, Q, LP, L, A, R, K = dims
    if (hs.shape != (B, K, Q, R) or cs.shape != hs.shape
            or g.shape != hs.shape):
        raise ValueError('scan kernel: hs, cs and g must be (B, K, Q, R)')
    dev = hs.device
    # step k's backward recomputes it from (h_{k-1}, c_{k-1}); K5-bf16
    # reads h_{k-1} in bf16 (an operand of products only)
    hs_prev = (dsa_bf16.shifted_bf16(hs) if rb else
               torch.cat([torch.zeros_like(hs[:, :1]), hs[:, :-1]], 1))
    cs_prev = torch.cat([torch.zeros_like(cs[:, :1]), cs[:, :-1]], 1)
    g = g.to(torch.float32).contiguous()

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    def empty(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    dvalue, dbase, dscale = zeros(B, H, S, Dh), zeros(B, H, Q, LP), \
        zeros(B, Q, LP)
    dz, doffw, dh2w, dcw = empty(B, K, Q, 4 * R), empty(R, H * LP), \
        empty(R, A), empty(Dh, A)
    dcb, daw, dab = zeros(A), zeros(A), zeros(1)
    dctx_w3, dwhh = empty(H * Dh, 4 * R), empty(R, 4 * R)
    # G, the weight gradients' rows (bf16 in K5-bf16, with a bf16 copy of
    # dz), the table value_t . cw, and the split-K partial tiles of its
    # GEMMs: the table, G . cw^T and the five outer sums
    N, BHS = B * K * Q, B * H * S
    work = _cuda.gemm_work(dev, (BHS, A, Dh), (BHS, Dh, A), (R, 4 * R, N),
                           (H * Dh, 4 * R, N), (R, A, N), (R, H * LP, N),
                           (Dh, A, BHS))
    def rows(*shape):
        return torch.empty(shape, device=dev, dtype=torch.bfloat16 if rb
                           else torch.float32)

    dz16 = rows(B, K, Q, 4 * R) if rb else None
    scratch = (zeros(B, H, S, A), rows(B, K, Q, H * Dh), rows(B, K, Q, A),
               rows(B, K, Q, H * LP), empty(B, H, S, A), work)
    outs = (dvalue, dbase, dscale, dz)
    outs2 = (doffw, dh2w, dcw, dcb, daw, dab, dctx_w3, dwhh)
    _cuda.check(_cuda.lib().cdll.dvc_dsa_scan_bwd(
        ops[0].data_ptr(), _ptr(value16), *(t.data_ptr() for t in ops[1:]),
        _ptr(wpack), _ptr(hpack), hs_prev.data_ptr(), cs_prev.data_ptr(),
        g.data_ptr(), _cuda.levels_array(temporal_shapes),
        *(t.data_ptr() for t in outs), _ptr(dz16),
        *(t.data_ptr() for t in outs2 + scratch), *dims, work.numel(), int(rb),
        _cuda.stream_ptr(dev)), 'dvc_dsa_scan_bwd')
    _cuda.count_launch(dsa_teacher_scan_bwd, rb)
    return (dvalue, dbase, dscale, dz,
            doffw.reshape(R, H, LP).permute(1, 0, 2), dh2w, dcb.clone(),
            dcw, dcb, daw, dab.reshape(ab_shape),
            dctx_w3.reshape(H, Dh, 4 * R), dwhh)


dsa_teacher_scan_bwd.launches = 0
dsa_teacher_scan_bwd.launches_bf16 = 0


class DSATeacherScanFunction(torch.autograd.Function):
    """The scan on the card: forward ``dvc_dsa_scan_fwd``, backward
    ``dvc_dsa_scan_bwd``; the last two arguments are the level table and
    the precision.  In bf16 the gate weights and h2att_w are packed once,
    in the forward (``pack_scan_weights``; it reads P^T's half of the gate
    weights), and the backward reuses the packs."""

    @staticmethod
    def forward(ctx, *args):
        *ops, temporal_shapes, precision = args
        ctx.packs = (pack_scan_weights(ops[12], ops[11], ops[5])
                     if check_precision(precision) else None)
        hs, cs = dsa_teacher_scan_fwd(*ops, temporal_shapes,
                                      precision=precision, packs=ctx.packs)
        ctx.temporal_shapes, ctx.precision = temporal_shapes, precision
        ctx.save_for_backward(*ops, hs, cs)
        return hs

    @staticmethod
    def backward(ctx, g):
        *ops, hs, cs = ctx.saved_tensors
        grads = dsa_teacher_scan_bwd(*ops, ctx.temporal_shapes, hs, cs, g,
                                     precision=ctx.precision,
                                     packs=ctx.packs)
        return (*grads, None, None)


def dsa_teacher_scan(value_t, base_pos, scale_t, z_all, off_w_h, h2att_w,
                     h2att_b, cw, cb, aw, ab, ctx_w3, w_hh, temporal_shapes,
                     precision='float32'):
    """Whole teacher-forcing scan, differentiable.  Returns hs (B, K, Q, R).
    CPU tensors: the plain version (f32: autograd through it; bf16: the
    plain bf16 forward and backward).  CUDA tensors: the kernels (f32, or
    K4-bf16 and K5-bf16 under ``precision='bfloat16'``) or an error."""
    rb = check_precision(precision)
    args = (value_t, base_pos, scale_t, z_all, off_w_h, h2att_w, h2att_b,
            cw, cb, aw, ab, ctx_w3, w_hh)
    if not value_t.is_cuda:
        if rb:
            dsa_teacher_scan_ref.calls += 1
            return dsa_bf16.PlainScanBf16.apply(*args, tuple(temporal_shapes))
        hs, _ = dsa_teacher_scan_ref(*args, temporal_shapes)
        return hs
    return DSATeacherScanFunction.apply(*args, tuple(temporal_shapes),
                                        precision)
