// Teacher-forcing word scan of the LSTM-DSA caption head, forward and
// backward: all K word steps of a video in one launch each.
//
// Forward replaces the Pallas TPU kernel `_make_scan_fwd_kernel`
// (dvc_tpu/ops/dsa_scan.py): the greedy decode's step (dsa_common.cuh) with
// the token's LSTM preactivation z_all[b, k] given instead of fed back,
// and no vocab projection:
//
//   ctx      = attention of the step from h_{k-1}        (dsa_common.cuh)
//   z        = z_all[b, k] + h_{k-1} W_hh + ctx ctx_w3                (Q, 4R)
//   (h_k, c_k) = bias-free LSTM cell of z; hs[b, k] = h_k, cs[b, k] = c_k
//
// The TPU grid (B, K) runs k in order on one core with h and c in VMEM
// scratch.  On Hopper the queries are independent, so one block owns
// (b, a tile of kQT queries) and loops over the K steps with h, c, hvec,
// ctx and the tap table in shared memory, as the greedy kernel does.
//
// Backward replaces `_make_scan_bwd_kernel` (same file), the reverse-time
// scan.  One block per (b, query tile) walks k from K-1 down to 0 (8
// queries a tile where that grid fills the card; on a small grid, such as
// a B=1 step's, tiles of 2 or 4 queries spread the scan over more SMs): it
// recomputes step k's attention and gates from (h_{k-1}, c_{k-1}) (the
// caller passes hs and cs shifted by one step, zeros first), carries dh and
// dc in shared memory, and writes dz.  The launch first builds the per-video
// table VW = value_t Wc (B, H, S, A) with the tiled GEMM of dsa_common.cuh:
// a tap is a lerp of two value rows, so taps Wc is the same lerp of two VW
// rows, and the scores are recomputed from it (attend_scores_table, then
// again per (query, column half) in attend_backward_table to form
// du = ddot * alpha_w * (1 - tanh^2)), with no Dh x A product per tap.  What
// a block cannot own is scattered with float4 atomics: dvalue's context
// term (the lerp-scatter of wts * dctx; shared by every query tile of a
// video) and G = the lerp-scatter of du onto the value rows.  The scores'
// term of dvalue, du Wc^T scattered the same way, equals G Wc^T: one GEMM
// per launch after the scan, and dpos takes it as (VW[hi] - VW[lo]) . du.
// dbase and dscale belong to one block.  The per-step rows that the weight
// gradients need (h_{k-1}, dz, ctx, dhvec, doff) are written out, and the
// same tiled GEMM reduces them (split along the rows into fixed chunks
// added in order, so deterministic):
//
//   dW_hh = h_prev^T dz    dctx_w3 = ctx^T dz    dh2att_w = h_prev^T dhvec
//   doff_w = h_prev^T doff    dWc = value^T G     (sums over rows b, k, q)
//
// dcb = dh2att_b and daw are per-lane partial sums kept in registers for the
// whole scan, dab a per-block one, each added with atomics at the end.
//
// Bound on this card: the per-step products (the gates' recompute h W_hh,
// ctx ctx_w3 and their transposes dz W_hh^T, dz ctx_w3^T, a thread per two
// output units with the activations broadcast from shared memory) read
// their weights (4 MB each at R = 512) from L2, so L2 bandwidth and the
// FP32 issue rate bound them.  dvalue, G (so dWc) and the atomically summed
// vectors vary by a few ulps from run to run; the GEMMs are deterministic.
// The cell backward lives in dsa_common.cuh, shared with the single
// word-step backwards of dsa_step.cu, which keep the product form.  Shared
// memory of a block of 8 queries (R = A = 512, LP = 16): 167,440 bytes at
// cap_nheads 1 and 192,528 at cap_nheads 8 (the card allows 232,448).  Limits: A <= 512
// (two float4 column groups per lane and column half), A, Dh and R
// multiples of 4, and the shared memory of a block (checked at launch).

#include <cuda_runtime.h>
#include <math.h>

#include "dsa_common.cuh"

namespace {

using namespace dsa;

struct ScanArgs {
  AttendArgs at;
  const float* z_all;   // (B, K, Q, 4R)
  const float* ctx_w3;  // (H*Dh, 4R)
  const float* w_hh;    // (R, 4R)
  const float* ab;      // (1)
  int B, K;
};

// ----------------------------------------------------------------------------
// forward
// ----------------------------------------------------------------------------

struct FwdLayout {
  int h, hn, c, hvec, ctx, taps, wc, wlo, whi, d, red;  // float offsets
  int lo, hi;                                           // int offsets
  int floats, ints;
  __host__ __device__ FwdLayout(int R, int A, int HD, int NR) {
    int o = 0;
    h = o;    o += kQT * pad4(R);
    hn = o;   o += kQT * pad4(R);
    c = o;    o += kQT * pad4(R);
    hvec = o; o += kQT * pad4(A);
    ctx = o;  o += kQT * pad4(HD);
    taps = o; o += kBK * kBM;
    wc = o;   o += kBK * kBN;
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    red = o;  o += kWarps * kRed;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

__global__ void __launch_bounds__(kThreads)
scan_fwd_kernel(ScanArgs a, float* __restrict__ hs, float* __restrict__ cs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh, Q = at.Q;
  const int HD = H * Dh, R4 = 4 * R, NR = kQT * H * at.LP;
  const int ldR = pad4(R), ldHD = pad4(HD);
  const FwdLayout L(R, A, HD, NR);
  float* hn_s = smem + L.hn;
  float* c_s = smem + L.c;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm;
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.taps = smem + L.taps; sm.wc = smem + L.wc; sm.wlo = smem + L.wlo;
  sm.whi = smem + L.whi; sm.d = smem + L.d; sm.red = smem + L.red;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;

  // queries past the end of the ragged last tile compute on a copy of the
  // last query and write nothing
  int qg[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) qg[q] = min(q0 + q, Q - 1);

  for (int i = tid; i < kQT * ldR; i += kThreads) { sm.h[i] = 0.f; c_s[i] = 0.f; }
  __syncthreads();

  const float* value_b = at.value + (size_t)b * H * at.S * Dh;
  const float ab = __ldg(a.ab);

  for (int k = 0; k < a.K; ++k) {
    attend_hvec_taps(at, sm, b, q0);
    __syncthreads();
    attend_scores(at, sm, value_b, ab);
    attend_softmax_ctx(at, sm, value_b);

    // z = z_all[b, k] + h W_hh + ctx ctx_w3, then the LSTM cell; a thread
    // owns hidden unit r (its 4 gate columns)
    for (int r = tid; r < R; r += kThreads) {
      float z[4][kQT];
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float* zk = a.z_all + (((size_t)b * a.K + k) * Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = zk[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float c = sigmoidf_(z[1][q]) * c_s[q * ldR + r]
                        + sigmoidf_(z[0][q]) * tanhf(z[2][q]);
        const float h = sigmoidf_(z[3][q]) * tanhf(c);
        c_s[q * ldR + r] = c;
        hn_s[q * ldR + r] = h;
        if (q0 + q < Q) {
          const size_t o = (((size_t)b * a.K + k) * Q + q0 + q) * R + r;
          hs[o] = h;
          cs[o] = c;
        }
      }
    }
    __syncthreads();
    { float* t = sm.h; sm.h = hn_s; hn_s = t; }
  }
}

// ----------------------------------------------------------------------------
// backward
// ----------------------------------------------------------------------------

struct BwdOut {
  const float* hs_prev;  // (B, K, Q, R) h_{k-1}, zeros at k = 0
  const float* cs_prev;  // (B, K, Q, R)
  const float* g;        // (B, K, Q, R) cotangent of hs
  const float* vw;       // (B, H, S, A)    the table value . Wc
  float* dvalue;         // (B, H, S, Dh)   zeroed; atomics
  float* G;              // (B, H, S, A)    zeroed; atomics
  float* dbase;          // (B, H, Q, LP)   zeroed; block-owned
  float* dscale;         // (B, Q, LP)      zeroed; block-owned
  float* dz;             // (B, K, Q, 4R)
  float* ctx_all;        // (B, K, Q, H*Dh) rows for dctx_w3
  float* dhvec_all;      // (B, K, Q, A)    rows for dh2att_w
  float* doff_all;       // (B, K, Q, H*LP) rows for doff_w
  float* dcb;            // (A)             zeroed; atomics
  float* daw;            // (A)             zeroed; atomics
  float* dab;            // (1)             zeroed; atomics
};

struct BwdLayout {
  int h, dh, dc, hvec, cx, dctx, dz;          // float offsets
  int wlo, whi, d, ddot, dpos, dab;
  int lo, hi;                                 // int offsets
  int floats, ints;
  __host__ __device__ BwdLayout(int QT, int R, int A, int HD, int NR) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    int o = 0;
    h = o;    o += QT * pad4(R);
    dh = o;   o += QT * pad4(R);
    dc = o;   o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    cx = o;   o += QT * CX;          // ctx, then dhvec
    dctx = o; o += QT * pad4(HD);
    dz = o;   o += QT * 4 * R;       // staged dz (QT, 4R)
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);          // softmax weights, then dpos * offset
    ddot = o; o += pad4(NR);          // dwts, then ddot, then doff
    dpos = o; o += pad4(NR);
    dab = o;  o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

template <int QT>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(ScanArgs a, BwdOut o) {
  static_assert(kWarps % QT == 0, "warps per query");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh, Q = at.Q, LP = at.LP;
  const int S = at.S, K = a.K;
  const int HD = H * Dh, R4 = 4 * R, HLP = H * LP, NR = QT * HLP;
  const int ldR = pad4(R), ldA = pad4(A), ldHD = pad4(HD);
  const BwdLayout L(QT, R, A, HD, NR);
  float* dh_s = smem + L.dh;
  float* dc_s = smem + L.dc;
  float* cx_s = smem + L.cx;
  float* dz_s = smem + L.dz;
  float* ddot_s = smem + L.ddot;
  float* dpos_s = smem + L.dpos;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = cx_s;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  TableGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = cx_s; gs.ddot = ddot_s; gs.dpos = dpos_s;
  gs.dab = smem + L.dab;
  const ColGroups cols(A, kWarps / QT);
  float4 dcb[kColGroups], daw[kColGroups];
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) { dcb[j] = f4(0.f); daw[j] = f4(0.f); }

  // a query past the end of the ragged last tile runs on a copy of the
  // last query with a zero cotangent: every gradient it adds is exactly 0,
  // and it writes no row
  int qg[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) qg[q] = min(q0 + q, Q - 1);

  for (int i = tid; i < QT * ldR; i += kThreads) { dh_s[i] = 0.f; dc_s[i] = 0.f; }
  if (tid == 0) gs.dab[0] = 0.f;

  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = o.vw + (size_t)b * H * S * A;
  const float ab = __ldg(a.ab);

  for (int k = K - 1; k >= 0; --k) {
    const size_t bk = (size_t)b * K + k;
    // ---- h_{k-1} of the tile
    for (int i = tid; i < QT * R; i += kThreads) {
      const int q = i / R, r = i % R;
      sm.h[q * ldR + r] = o.hs_prev[(bk * Q + qg[q]) * R + r];
    }
    __syncthreads();

    // ---- recompute the step's attention: hvec, taps, the scores from the
    //      table, softmax weights, ctx
    attend_hvec_taps<QT>(at, sm, b, q0);
    __syncthreads();
    attend_scores_table<QT>(at, sm, vw_b, ab);
    attend_softmax_ctx<QT>(at, sm, value_b);
    for (int i = tid; i < QT * HD; i += kThreads) {
      const int q = i / HD, hd = i % HD;
      if (q0 + q < Q) o.ctx_all[(bk * Q + q0 + q) * HD + hd] = cx_s[q * ldHD + hd];
    }

    // ---- gates from (h_{k-1}, c_{k-1}) and the LSTM cell backward; dz is
    //      written out and staged in dz_s as (QT, 4R)
    for (int r = tid; r < R; r += kThreads) {
      float z[4][QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float* zk = a.z_all + (bk * Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = zk[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(cx_s, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const bool valid = q0 + q < Q;
        const size_t row = bk * Q + qg[q];
        const float c_prev = o.cs_prev[row * R + r];
        const float gh = valid ? o.g[row * R + r] + dh_s[q * ldR + r] : 0.f;
        const float gc = valid ? dc_s[q * ldR + r] : 0.f;
        float dzg[4];
        const float dc_prev = cell_bwd(z[0][q], z[1][q], z[2][q], z[3][q],
                                       c_prev, gh, gc, dzg);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dz_s[q * R4 + g * R + r] = dzg[g];
          if (valid) o.dz[row * R4 + g * R + r] = dzg[g];
        }
        dc_s[q * ldR + r] = dc_prev;
      }
    }
    __syncthreads();

    // ---- dh_{k-1} = dz W_hh^T and dctx = dz ctx_w3^T
    gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
      if (u < R) dh_s[q * ldR + u] = v;
      else gs.dctx[q * ldHD + u - R] = v;
    });
    __syncthreads();

    // ---- attention and sampling backward of the step from the table;
    //      dpos_s then holds dpos and cx_s dhvec
    attend_backward_table<QT>(at, sm, gs, value_b, vw_b, o.dvalue + (size_t)b * H * S * Dh,
                          o.G + (size_t)b * H * S * A, cols, dcb, daw);

    // ---- sampling backward: dbase += dpos, doff = dpos * scale (ddot_s is
    //      free now and holds doff), dscale += sum_hh dpos * off with the
    //      offsets h_{k-1} . off_w recomputed rather than kept
    for (int row = tid; row < NR; row += kThreads) {
      const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
      const float dp = dpos_s[row];
      const float sc = at.scale[((size_t)b * Q + qg[q]) * LP + p];
      ddot_s[row] = dp * sc;
      if (q0 + q < Q) {
        o.dbase[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] += dp;
        o.doff_all[(bk * Q + q0 + q) * HLP + hh * LP + p] = dp * sc;
      }
      sm.d[row] = dp * row_offset(at, sm.h, row);
    }
    for (int i = tid; i < QT * A; i += kThreads) {
      const int q = i / A, col = i % A;
      if (q0 + q < Q) o.dhvec_all[(bk * Q + q0 + q) * A + col] = cx_s[q * ldA + col];
    }
    __syncthreads();
    for (int i = tid; i < QT * LP; i += kThreads) {
      const int q = i / LP, p = i % LP;
      if (q0 + q >= Q) continue;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc += sm.d[(q * H + hh) * LP + p];
      o.dscale[((size_t)b * Q + q0 + q) * LP + p] += acc;
    }

    // ---- dh_{k-1} += dhvec W_h2att^T + doff off_w^T (a thread per two
    //      units r)
    for (int r0 = tid * 2; r0 < R; r0 += kThreads * 2) {
      float acc[2][QT] = {};
      rows_dot_rows<2, QT>(cx_s, ldA, A, at.h2att_w, A, r0, R, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + i;
        if (r >= R) continue;
        for (int m = 0; m < HLP; ++m) {
          const float wo = at.off_w[((size_t)(m / LP) * R + r) * LP + m % LP];
#pragma unroll
          for (int q = 0; q < QT; ++q) acc[i][q] = fmaf(ddot_s[q * HLP + m], wo, acc[i][q]);
        }
#pragma unroll
        for (int q = 0; q < QT; ++q) dh_s[q * ldR + r] += acc[i][q];
      }
    }
    __syncthreads();
  }

  // the lane's column sums of dcb and daw (zero for queries past Q)
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    if (!cols.ok[j]) continue;
    atomic_add4(o.dcb + cols.c[j], dcb[j]);
    atomic_add4(o.daw + cols.c[j], daw[j]);
  }
  if (tid == 0) atomicAdd(o.dab, gs.dab[0]);
}

// dsa::fill_attend plus the operands of a step that starts from h
bool fill_hidden_attend(AttendArgs* at, const float* value_t, const float* base_pos,
                        const float* scale_t, const float* off_w_h, const float* h2att_w,
                        const float* h2att_b, const float* cw, const float* cb,
                        const float* aw, const int* shapes, int H, int S, int Dh, int Q,
                        int LP, int L, int A, int R) {
  if (!fill_attend(at, value_t, cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return false;
  at->base_pos = base_pos; at->scale = scale_t; at->off_w = off_w_h;
  at->h2att_w = h2att_w; at->h2att_b = h2att_b;
  return true;
}

}  // namespace

// Shapes as in dsa_teacher_scan_ref (dvc_tpu/ops/dsa_scan.py): value_t
// (B, H, S, Dh), base_pos (B, H, Q, LP), scale_t (B, Q, LP), z_all
// (B, K, Q, 4R), off_w_h (H, R, LP), h2att_w (R, A), h2att_b (A), cw
// (Dh, A), cb (A), aw (A), ab one float in device memory, ctx_w3
// (H*Dh, 4R), w_hh (R, 4R); hs and cs (B, K, Q, R) are written.  All f32,
// contiguous, on the current device; shapes is a host array of the L level
// lengths.  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int dvc_dsa_scan_fwd(
    const float* value_t, const float* base_pos, const float* scale_t,
    const float* z_all, const float* off_w_h, const float* h2att_w,
    const float* h2att_b, const float* cw, const float* cb, const float* aw,
    const float* ab, const float* ctx_w3, const float* w_hh, const int* shapes,
    float* hs, float* cs, int B, int H, int S, int Dh, int Q, int LP, int L,
    int A, int R, int K, void* stream) {
  ScanArgs a;
  if (!fill_hidden_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  a.z_all = z_all; a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab;
  a.B = B; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  const size_t smem = FwdLayout(R, A, H * Dh, kQT * H * LP).bytes();
  cudaError_t e = set_smem(scan_fwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  scan_fwd_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a, hs, cs);
  return (int)cudaGetLastError();
}

// Gradients of dvc_dsa_scan_fwd for the cotangent g (B, K, Q, R) of hs.
// hs_prev / cs_prev are hs / cs shifted one step later (zeros at k = 0).
// Outputs: dvalue (B, H, S, Dh), dbase (B, H, Q, LP), dscale (B, Q, LP),
// dcb (A), daw (A), dab (1) zeroed by the caller; dz (B, K, Q, 4R),
// doffw (R, H*LP) [(r, hh*LP + p)], dh2w (R, A), dcw (Dh, A),
// dctx_w3 (H*Dh, 4R), dwhh (R, 4R) fully written.  Scratch: G (B, H, S, A)
// zeroed by the caller, ctx_all (B, K, Q, H*Dh), dhvec_all (B, K, Q, A),
// doff_all (B, K, Q, H*LP), vw (B, H, S, A) for the table value . Wc, and
// work (work_floats floats, at most kGSplitMax (8) times the largest weight
// gradient are used) for the outer sums' partial tiles.  dh2att_b equals
// dcb.  A, Dh, R multiples of 4, A <= 512; every operand 16-byte aligned.
extern "C" int dvc_dsa_scan_bwd(
    const float* value_t, const float* base_pos, const float* scale_t,
    const float* z_all, const float* off_w_h, const float* h2att_w,
    const float* h2att_b, const float* cw, const float* cb, const float* aw,
    const float* ab, const float* ctx_w3, const float* w_hh,
    const float* hs_prev, const float* cs_prev, const float* g,
    const int* shapes, float* dvalue, float* dbase, float* dscale, float* dz,
    float* doffw, float* dh2w, float* dcw, float* dcb, float* daw, float* dab,
    float* dctx_w3, float* dwhh, float* G, float* ctx_all, float* dhvec_all,
    float* doff_all, float* vw, float* work, int B, int H, int S, int Dh, int Q,
    int LP, int L, int A, int R, int K, int work_floats, void* stream) {
  ScanArgs a;
  if (!fill_hidden_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  if (A > 256 * kColGroups || A % 4 != 0 || Dh % 4 != 0 || R % 4 != 0 ||
      reinterpret_cast<size_t>(value_t) % 16 != 0 ||
      reinterpret_cast<size_t>(w_hh) % 16 != 0 || reinterpret_cast<size_t>(ctx_w3) % 16 != 0 ||
      reinterpret_cast<size_t>(h2att_w) % 16 != 0 || reinterpret_cast<size_t>(cb) % 16 != 0 ||
      reinterpret_cast<size_t>(aw) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  a.z_all = z_all; a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab;
  a.B = B; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  BwdOut o;
  o.hs_prev = hs_prev; o.cs_prev = cs_prev; o.g = g; o.vw = vw;
  o.dvalue = dvalue; o.G = G; o.dbase = dbase; o.dscale = dscale; o.dz = dz;
  o.ctx_all = ctx_all; o.dhvec_all = dhvec_all; o.doff_all = doff_all;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  // the query tile: 8 queries where the grid of 8-query tiles fills the
  // card (the weights' L2 reads per query are then fewest); on a small grid
  // the smallest tile of 2 or 4 queries whose grid still fits half the
  // SMs, so that more SMs share the scan's fixed work per step
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int QT = kQT;
  for (int qt : {2, 4})
    if (QT == kQT && 2 * (size_t)B * ((Q + qt - 1) / qt) <= (size_t)sms) QT = qt;
  const size_t smem = BwdLayout(QT, R, A, H * Dh, QT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 2 ? set_smem(scan_bwd_kernel<2>, smem)
                  : QT == 4 ? set_smem(scan_bwd_kernel<4>, smem)
                            : set_smem(scan_bwd_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int BHS = B * H * S;
  // the table value . Wc, once per launch
  if ((e = row_table(value_t, cw, BHS, Dh, A, vw, st)) != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 2)
    scan_bwd_kernel<2><<<grid, kThreads, smem, st>>>(a, o);
  else if (QT == 4)
    scan_bwd_kernel<4><<<grid, kThreads, smem, st>>>(a, o);
  else
    scan_bwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, o);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // the scores' share of dvalue, once per launch: dvalue += G . Wc^T
  if ((e = gemm(Operand{G, A, false}, Operand{cw, A, false}, BHS, Dh, A, true,
                dvalue, nullptr, 0, st)) != cudaSuccess)
    return (int)e;
  const int N = B * K * Q, HD = H * Dh, HLP = H * LP;
  const size_t wf = work_floats > 0 ? (size_t)work_floats : 0;
  float* w = wf > 0 ? work : nullptr;
  if ((e = outer_sum(hs_prev, R, dz, 4 * R, N, R, 4 * R, dwhh, st, w, wf)) != cudaSuccess ||
      (e = outer_sum(ctx_all, HD, dz, 4 * R, N, HD, 4 * R, dctx_w3, st, w, wf)) != cudaSuccess ||
      (e = outer_sum(hs_prev, R, dhvec_all, A, N, R, A, dh2w, st, w, wf)) != cudaSuccess ||
      (e = outer_sum(hs_prev, R, doff_all, HLP, N, R, HLP, doffw, st, w, wf)) != cudaSuccess ||
      (e = outer_sum(value_t, Dh, G, A, BHS, Dh, A, dcw, st, w, wf)) != cudaSuccess)
    return (int)e;
  return 0;
}
