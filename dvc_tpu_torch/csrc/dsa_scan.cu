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
// scan.  One block per (b, query tile) walks k from K-1 down to 0: it
// recomputes step k's attention and gates from (h_{k-1}, c_{k-1}) (the
// caller passes hs and cs shifted by one step, zeros first), carries dh and
// dc in shared memory, and writes dz.  The scores are recomputed twice: once
// for the softmax weights, once tile by tile to form
// du = ddot * alpha_w * (1 - tanh^2) without storing the (rows, A) tanh
// activations.  What a block cannot own is scattered with atomics: dvalue
// (shared by every query tile of a video) and G = the lerp-weighted scatter
// of du onto the value rows, from which dWc = sum_{b,h} value^T G follows
// (a tap is a lerp of two value rows, so sum_rows taps^T du equals it); the
// (B*K*H*Q*LP, Dh) taps and (.., A) du factors are never stored.
// dbase and dscale belong to one block.  The per-step rows that the weight
// gradients need (h_{k-1}, dz, ctx, dhvec, doff) are written out, and a
// second, hand-written tiled kernel (outer_sum_kernel) reduces them:
//
//   dW_hh = h_prev^T dz    dctx_w3 = ctx^T dz    dh2att_w = h_prev^T dhvec
//   doff_w = h_prev^T doff    dWc = value^T G     (sums over rows b, k, q)
//
// dcb = dh2att_b, daw and dab are per-block partial sums added with one
// atomic per column at the end.
//
// Bound on this card: as the greedy kernel, the per-step products read
// activations from shared memory and weights (W_hh and ctx_w3 4 MB each at
// R = 512) from L2, so shared-load throughput and L2 bandwidth bound them, not
// the FP32 peak; the backward adds the atomics into dvalue and G (2*(Dh + A)
// per tap row and step).  dvalue, G (so dWc) and the atomically summed
// vectors vary by a few ulps from run to run; the outer sums are
// deterministic.  The attention half of the backward (attend_backward), the
// cell backward and dz W^T live in dsa_common.cuh, shared with the single
// word-step backwards of dsa_step.cu.  Shared memory of a block: 207,376
// bytes at cap_nheads 1 and 228,880 at cap_nheads 8 (R = A = 512, LP = 16;
// the card allows 232,448): the sampling offsets are recomputed in the sampling
// backward instead of kept, and dpos takes the softmax weights' buffer row
// tile by row tile.  Limits: A <= 512 and R <= 512 in the backward (a du
// tile row and the staged dz of a tile fit one kBM x kBN buffer), and the
// shared memory of a block (checked at launch).

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
  int h, dh, dc, hvec, cx, dctx, taps, wc, big;  // float offsets
  int wlo, whi, d, ddot, red, dcb, daw, dab;
  int lo, hi;                                    // int offsets
  int floats, ints;
  __host__ __device__ BwdLayout(int R, int A, int HD, int NR) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    int o = 0;
    h = o;    o += kQT * pad4(R);
    dh = o;   o += kQT * pad4(R);
    dc = o;   o += kQT * pad4(R);
    hvec = o; o += kQT * pad4(A);
    cx = o;   o += kQT * CX;          // ctx, then dhvec
    dctx = o; o += kQT * pad4(HD);
    taps = o; o += kBK * kBM;
    wc = o;   o += kBK * kBN;
    big = o;  o += kBM * kBN;         // staged dz (kQT, 4R), then du tiles
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);          // softmax weights, then dpos, then
                                      // dpos * offset
    ddot = o; o += pad4(NR);          // dwts, then ddot, then doff
    red = o;  o += kWarps * kRed;
    dcb = o;  o += pad4(A);
    daw = o;  o += pad4(A);
    dab = o;  o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(ScanArgs a, BwdOut o) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh, Q = at.Q, LP = at.LP;
  const int S = at.S, K = a.K;
  const int HD = H * Dh, R4 = 4 * R, HLP = H * LP, NR = kQT * HLP;
  const int ldR = pad4(R), ldA = pad4(A), ldHD = pad4(HD);
  const BwdLayout L(R, A, HD, NR);
  float* dh_s = smem + L.dh;
  float* dc_s = smem + L.dc;
  float* cx_s = smem + L.cx;
  float* dctx_s = smem + L.dctx;
  float* big_s = smem + L.big;
  float* ddot_s = smem + L.ddot;
  float* dcb_s = smem + L.dcb;
  float* daw_s = smem + L.daw;
  float* dab_s = smem + L.dab;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm;
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = cx_s;
  sm.taps = smem + L.taps; sm.wc = smem + L.wc; sm.wlo = smem + L.wlo;
  sm.whi = smem + L.whi; sm.d = smem + L.d; sm.red = smem + L.red;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  AttendGradSmem gs;
  gs.dctx = dctx_s; gs.dhvec = cx_s; gs.ddot = ddot_s; gs.du = big_s;
  gs.dcb = dcb_s; gs.daw = daw_s; gs.dab = dab_s;

  // a query past the end of the ragged last tile runs on a copy of the
  // last query with a zero cotangent: every gradient it adds is exactly 0,
  // and it writes no row
  int qg[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) qg[q] = min(q0 + q, Q - 1);

  for (int i = tid; i < kQT * ldR; i += kThreads) { dh_s[i] = 0.f; dc_s[i] = 0.f; }
  for (int i = tid; i < ldA; i += kThreads) { dcb_s[i] = 0.f; daw_s[i] = 0.f; }
  if (tid == 0) dab_s[0] = 0.f;

  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float ab = __ldg(a.ab);

  for (int k = K - 1; k >= 0; --k) {
    const size_t bk = (size_t)b * K + k;
    // ---- h_{k-1} of the tile
    for (int i = tid; i < kQT * R; i += kThreads) {
      const int q = i / R, r = i % R;
      sm.h[q * ldR + r] = o.hs_prev[(bk * Q + qg[q]) * R + r];
    }
    __syncthreads();

    // ---- recompute the step's attention: hvec, taps, softmax weights, ctx
    attend_hvec_taps(at, sm, b, q0);
    __syncthreads();
    attend_scores(at, sm, value_b, ab);
    attend_softmax_ctx(at, sm, value_b);
    for (int i = tid; i < kQT * HD; i += kThreads) {
      const int q = i / HD, hd = i % HD;
      if (q0 + q < Q) o.ctx_all[(bk * Q + q0 + q) * HD + hd] = cx_s[q * ldHD + hd];
    }

    // ---- gates from (h_{k-1}, c_{k-1}) and the LSTM cell backward; dz is
    //      written out and staged in big_s as (kQT, 4R)
    for (int r = tid; r < R; r += kThreads) {
      float z[4][kQT];
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float* zk = a.z_all + (bk * Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = zk[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(cx_s, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
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
          big_s[q * R4 + g * R + r] = dzg[g];
          if (valid) o.dz[row * R4 + g * R + r] = dzg[g];
        }
        dc_s[q * ldR + r] = dc_prev;
      }
    }
    __syncthreads();

    // ---- dh_{k-1} = dz W_hh^T and dctx = dz ctx_w3^T
    gates_backprop(big_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
      if (u < R) dh_s[q * ldR + u] = v;
      else dctx_s[q * ldHD + u - R] = v;
    });
    __syncthreads();

    // ---- attention and sampling backward of the step; sm.d then holds
    //      dpos and cx_s dhvec
    attend_backward(at, sm, gs, value_b, o.dvalue + (size_t)b * H * S * Dh,
                    o.G + (size_t)b * H * S * A);

    // ---- sampling backward: dbase += dpos, doff = dpos * scale (ddot_s is
    //      free now and holds doff), dscale += sum_hh dpos * off with the
    //      offsets h_{k-1} . off_w recomputed rather than kept (at
    //      cap_nheads 8 that keeps the block under the card's 227 KB)
    for (int row = tid; row < NR; row += kThreads) {
      const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
      const float dp = sm.d[row];
      const float sc = at.scale[((size_t)b * Q + qg[q]) * LP + p];
      ddot_s[row] = dp * sc;
      if (q0 + q < Q) {
        o.dbase[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] += dp;
        o.doff_all[(bk * Q + q0 + q) * HLP + hh * LP + p] = dp * sc;
      }
      sm.d[row] = dp * row_offset(at, sm.h, row);
    }
    for (int i = tid; i < kQT * A; i += kThreads) {
      const int q = i / A, col = i % A;
      if (q0 + q < Q) o.dhvec_all[(bk * Q + q0 + q) * A + col] = cx_s[q * ldA + col];
    }
    __syncthreads();
    for (int i = tid; i < kQT * LP; i += kThreads) {
      const int q = i / LP, p = i % LP;
      if (q0 + q >= Q) continue;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc += sm.d[(q * H + hh) * LP + p];
      o.dscale[((size_t)b * Q + q0 + q) * LP + p] += acc;
    }

    // ---- dh_{k-1} += dhvec W_h2att^T + doff off_w^T (a warp per unit r)
    for (int r = warp; r < R; r += kWarps) {
      const float* w2 = at.h2att_w + (size_t)r * A;
      float acc[kQT] = {};
      for (int c = lane; c < A; c += 32) {
        const float wc = w2[c];
#pragma unroll
        for (int q = 0; q < kQT; ++q) acc[q] = fmaf(cx_s[q * ldA + c], wc, acc[q]);
      }
      for (int m = lane; m < HLP; m += 32) {
        const float wo = at.off_w[((size_t)(m / LP) * R + r) * LP + m % LP];
#pragma unroll
        for (int q = 0; q < kQT; ++q) acc[q] = fmaf(ddot_s[q * HLP + m], wo, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float v = warp_sum(acc[q]);
        if (lane == 0) dh_s[q * ldR + r] += v;
      }
    }
    __syncthreads();
  }

  for (int col = tid; col < A; col += kThreads) {
    atomicAdd(o.dcb + col, dcb_s[col]);
    atomicAdd(o.daw + col, daw_s[col]);
  }
  if (tid == 0) atomicAdd(o.dab, dab_s[0]);
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
// doff_all (B, K, Q, H*LP).  dh2att_b equals dcb.
extern "C" int dvc_dsa_scan_bwd(
    const float* value_t, const float* base_pos, const float* scale_t,
    const float* z_all, const float* off_w_h, const float* h2att_w,
    const float* h2att_b, const float* cw, const float* cb, const float* aw,
    const float* ab, const float* ctx_w3, const float* w_hh,
    const float* hs_prev, const float* cs_prev, const float* g,
    const int* shapes, float* dvalue, float* dbase, float* dscale, float* dz,
    float* doffw, float* dh2w, float* dcw, float* dcb, float* daw, float* dab,
    float* dctx_w3, float* dwhh, float* G, float* ctx_all, float* dhvec_all,
    float* doff_all, int B, int H, int S, int Dh, int Q, int LP, int L, int A,
    int R, int K, void* stream) {
  ScanArgs a;
  if (!fill_hidden_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  if (A > kBN || kQT * 4 * R > kBM * kBN) return (int)cudaErrorInvalidValue;
  a.z_all = z_all; a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab;
  a.B = B; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  BwdOut o;
  o.hs_prev = hs_prev; o.cs_prev = cs_prev; o.g = g;
  o.dvalue = dvalue; o.G = G; o.dbase = dbase; o.dscale = dscale; o.dz = dz;
  o.ctx_all = ctx_all; o.dhvec_all = dhvec_all; o.doff_all = doff_all;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  const size_t smem = BwdLayout(R, A, H * Dh, kQT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = set_smem(scan_bwd_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  scan_bwd_kernel<<<grid, kThreads, smem, st>>>(a, o);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int N = B * K * Q, HD = H * Dh, HLP = H * LP;
  if ((e = outer_sum(hs_prev, R, dz, 4 * R, N, R, 4 * R, dwhh, st)) != cudaSuccess ||
      (e = outer_sum(ctx_all, HD, dz, 4 * R, N, HD, 4 * R, dctx_w3, st)) != cudaSuccess ||
      (e = outer_sum(hs_prev, R, dhvec_all, A, N, R, A, dh2w, st)) != cudaSuccess ||
      (e = outer_sum(hs_prev, R, doff_all, HLP, N, R, HLP, doffw, st)) != cudaSuccess ||
      (e = outer_sum(value_t, Dh, G, A, B * H * S, Dh, A, dcw, st)) != cudaSuccess)
    return (int)e;
  return 0;
}
