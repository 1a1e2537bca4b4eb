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
// deterministic.  Limits: A <= 512 and R <= 512 in the backward (a du tile
// row and the staged dz of a tile fit one kBM x kBN buffer), and the shared
// memory of a block (checked at launch).

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
    attend_hvec_taps(at, sm, b, q0, nullptr);
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
  int wlo, whi, d, ddot, off, dpos, red, dcb, daw, dab;
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
    d = o;    o += pad4(NR);          // softmax weights
    ddot = o; o += pad4(NR);          // dwts, then ddot, then doff
    off = o;  o += pad4(NR);
    dpos = o; o += pad4(NR);
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
  const int rg = tid / 64;
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
  float* off_s = smem + L.off;
  float* dpos_s = smem + L.dpos;
  float* red_s = smem + L.red;
  float* dcb_s = smem + L.dcb;
  float* daw_s = smem + L.daw;
  float* dab_s = smem + L.dab;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm;
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = cx_s;
  sm.taps = smem + L.taps; sm.wc = smem + L.wc; sm.wlo = smem + L.wlo;
  sm.whi = smem + L.whi; sm.d = smem + L.d; sm.red = red_s;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;

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
    attend_hvec_taps(at, sm, b, q0, off_s);
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
        const float si = sigmoidf_(z[0][q]), sf = sigmoidf_(z[1][q]);
        const float tg = tanhf(z[2][q]), so = sigmoidf_(z[3][q]);
        const float c_new = sf * c_prev + si * tg;
        const float th = tanhf(c_new);
        const float dc_tot = gc + gh * so * (1.f - th * th);
        const float dzg[4] = {dc_tot * tg * si * (1.f - si),
                              dc_tot * c_prev * sf * (1.f - sf),
                              dc_tot * si * (1.f - tg * tg),
                              gh * th * so * (1.f - so)};
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          big_s[q * R4 + g * R + r] = dzg[g];
          if (valid) o.dz[row * R4 + g * R + r] = dzg[g];
        }
        dc_s[q * ldR + r] = dc_tot * sf;
      }
    }
    __syncthreads();

    // ---- dh_{k-1} = dz W_hh^T and dctx = dz ctx_w3^T: a warp per output
    //      unit, lanes along the 4R gate columns (coalesced weight rows)
    for (int u = warp; u < R + HD; u += kWarps) {
      const float* w = u < R ? a.w_hh + (size_t)u * R4 : a.ctx_w3 + (size_t)(u - R) * R4;
      float acc[kQT] = {};
      for (int j = lane; j < R4; j += 32) {
        const float wj = w[j];
#pragma unroll
        for (int q = 0; q < kQT; ++q) acc[q] = fmaf(big_s[q * R4 + j], wj, acc[q]);
      }
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float v = warp_sum(acc[q]);
        if (lane == 0) {
          if (u < R) dh_s[q * ldR + u] = v;
          else dctx_s[q * ldHD + u - R] = v;
        }
      }
    }
    __syncthreads();

    // ---- attention backward: dwts = taps . dctx (a warp per tap row),
    //      then ddot = wts * (dwts - sum_p wts * dwts) per (q, head)
    for (int row = warp; row < NR; row += kWarps) {
      const int q = row / HLP, hh = (row / LP) % H;
      const float* v = value_b + (size_t)hh * S * Dh;
      const float* dc = dctx_s + q * ldHD + hh * Dh;
      const float wl = sm.wlo[row], wh = sm.whi[row];
      const size_t il = (size_t)sm.lo[row] * Dh, ih = (size_t)sm.hi[row] * Dh;
      float acc = 0.f;
      for (int dh = lane; dh < Dh; dh += 32)
        acc = fmaf(wl * v[il + dh] + wh * v[ih + dh], dc[dh], acc);
      acc = warp_sum(acc);
      if (lane == 0) ddot_s[row] = acc;
    }
    for (int i = tid; i < kQT * ldA; i += kThreads) cx_s[i] = 0.f;  // dhvec
    __syncthreads();
    for (int gi = tid; gi < kQT * H; gi += kThreads) {
      float* dw = ddot_s + gi * LP;
      const float* wts = sm.d + gi * LP;
      float sum = 0.f;
      for (int p = 0; p < LP; ++p) sum += wts[p] * dw[p];
      float tot = 0.f;
      for (int p = 0; p < LP; ++p) {
        const float dd = wts[p] * (dw[p] - sum);
        dw[p] = dd;
        tot += dd;
      }
      atomicAdd(dab_s, tot);
    }
    __syncthreads();

    // ---- scores again, tile by tile: du = ddot * aw * (1 - tanh^2), then
    //      dtaps = wts * dctx + du Wc^T, dvalue, G and dpos
    for (int r0 = 0; r0 < NR; r0 += kBM) {
      float acc[4][8];
      score_tile(at, sm, value_b, r0, 0, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(0, j);
        if (col >= A) continue;
        const float cbv = a.at.cb[col], awv = a.at.aw[col];
        float dcb_p = 0.f, daw_p = 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int rr = rg * 4 + i, row = r0 + rr;
          float du = 0.f;
          if (row < NR) {
            const int q = row / HLP, hh = (row / LP) % H;
            const float t = tanhf((acc[i][j] + cbv) + sm.hvec[q * ldA + col]);
            const float dd = ddot_s[row];
            du = dd * awv * (1.f - t * t);
            daw_p += dd * t;
            dcb_p += du;
            atomicAdd(cx_s + q * ldA + col, du);
            float* Gb = o.G + ((size_t)b * H + hh) * S * A + col;
            atomicAdd(Gb + (size_t)sm.lo[row] * A, sm.wlo[row] * du);
            atomicAdd(Gb + (size_t)sm.hi[row] * A, sm.whi[row] * du);
          }
          big_s[rr * kBN + col] = du;
        }
        atomicAdd(dcb_s + col, dcb_p);
        atomicAdd(daw_s + col, daw_p);
      }
      __syncthreads();

      float dpos_p[4] = {};
      for (int n0 = 0; n0 < Dh; n0 += kBN) {
        float dt[4][8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) dt[i][j] = 0.f;
        for (int a0 = 0; a0 < A; a0 += kBK) {
          for (int i = tid; i < kBK * kBN; i += kThreads) {  // Wc^T slice
            const int kk = i / kBN, dh = n0 + i % kBN;
            sm.wc[i] = (a0 + kk < A && dh < Dh) ? a.at.cw[(size_t)dh * A + a0 + kk] : 0.f;
          }
          __syncthreads();
          const int kmax = min(kBK, A - a0);
          for (int kk = 0; kk < kmax; ++kk) {
            float du[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) du[i] = big_s[(rg * 4 + i) * kBN + a0 + kk];
            const float4 u4 = ld4(sm.wc + kk * kBN + (threadIdx.x % 64) * 4);
            const float4 v4 = ld4(sm.wc + kk * kBN + 256 + (threadIdx.x % 64) * 4);
            const float w[8] = {u4.x, u4.y, u4.z, u4.w, v4.x, v4.y, v4.z, v4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) dt[i][j] = fmaf(du[i], w[j], dt[i][j]);
          }
          __syncthreads();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + rg * 4 + i;
          if (row >= NR) continue;
          const int q = row / HLP, hh = (row / LP) % H;
          const float wts = sm.d[row], wl = sm.wlo[row], wh = sm.whi[row];
          const size_t vrow = ((size_t)b * H + hh) * S;
          const float* v = at.value + vrow * Dh;
          float* dv = o.dvalue + vrow * Dh;
          const size_t il = (size_t)sm.lo[row] * Dh, ih = (size_t)sm.hi[row] * Dh;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int dh = tile_col(n0, j);
            if (dh >= Dh) continue;
            const float t = dt[i][j] + wts * dctx_s[q * ldHD + hh * Dh + dh];
            atomicAdd(dv + il + dh, wl * t);
            atomicAdd(dv + ih + dh, wh * t);
            dpos_p[i] += t * (v[ih + dh] - v[il + dh]);
          }
        }
      }
      // the 64 threads of a row group are warps 2*rg and 2*rg + 1
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = warp_sum(dpos_p[i]);
        if (lane == 0) red_s[warp * kRed + i] = v;
      }
      __syncthreads();
      if (tid < kBM && r0 + tid < NR) {
        const int g = tid / 4, i = tid % 4;
        dpos_s[r0 + tid] = red_s[2 * g * kRed + i] + red_s[(2 * g + 1) * kRed + i];
      }
      __syncthreads();
    }

    // ---- sampling backward: dbase += dpos, dscale += sum_hh dpos * off,
    //      doff = dpos * scale (ddot_s is free now and holds doff)
    for (int row = tid; row < NR; row += kThreads) {
      const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
      const float dp = dpos_s[row];
      const float sc = at.scale[((size_t)b * Q + qg[q]) * LP + p];
      ddot_s[row] = dp * sc;
      if (q0 + q < Q) {
        o.dbase[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] += dp;
        o.doff_all[(bk * Q + q0 + q) * HLP + hh * LP + p] = dp * sc;
      }
    }
    for (int i = tid; i < kQT * LP; i += kThreads) {
      const int q = i / LP, p = i % LP;
      if (q0 + q >= Q) continue;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) {
        const int row = (q * H + hh) * LP + p;
        acc += dpos_s[row] * off_s[row];
      }
      o.dscale[((size_t)b * Q + q0 + q) * LP + p] += acc;
    }
    for (int i = tid; i < kQT * A; i += kThreads) {
      const int q = i / A, col = i % A;
      if (q0 + q < Q) o.dhvec_all[(bk * Q + q0 + q) * A + col] = cx_s[q * ldA + col];
    }
    __syncthreads();

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

// ----------------------------------------------------------------------------
// out (m, n) = X^T Y over N rows: X (N, m), Y (N, n), row-major with leading
// dimensions ldx, ldy.  64 x 64 output tiles, 256 threads of 4 x 4 outputs,
// 16-row slices of X and Y staged in shared memory.
// ----------------------------------------------------------------------------

constexpr int kOT = 64, kOK = 16, kOThreads = 256;

__global__ void __launch_bounds__(kOThreads)
outer_sum_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y,
                 int ldy, int N, int m, int n, float* __restrict__ out) {
  __shared__ float xs[kOK][kOT];
  __shared__ float ys[kOK][kOT];
  const int tid = threadIdx.x, ti = tid / 16, tj = tid % 16;
  const int i0 = blockIdx.y * kOT, j0 = blockIdx.x * kOT;
  float acc[4][4] = {};
  for (int t0 = 0; t0 < N; t0 += kOK) {
    for (int e = tid; e < kOK * kOT; e += kOThreads) {
      const int t = e / kOT, c = e % kOT;
      xs[t][c] = (t0 + t < N && i0 + c < m) ? X[(size_t)(t0 + t) * ldx + i0 + c] : 0.f;
      ys[t][c] = (t0 + t < N && j0 + c < n) ? Y[(size_t)(t0 + t) * ldy + j0 + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int t = 0; t < kOK; ++t) {
      float x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) { x[u] = xs[t][ti * 4 + u]; y[u] = ys[t][tj * 4 + u]; }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(x[u], y[v], acc[u][v]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int i = i0 + ti * 4 + u, j = j0 + tj * 4 + v;
      if (i < m && j < n) out[(size_t)i * n + j] = acc[u][v];
    }
}

cudaError_t outer_sum(const float* X, int ldx, const float* Y, int ldy, int N,
                      int m, int n, float* out, cudaStream_t stream) {
  const dim3 grid((n + kOT - 1) / kOT, (m + kOT - 1) / kOT);
  outer_sum_kernel<<<grid, kOThreads, 0, stream>>>(X, ldx, Y, ldy, N, m, n, out);
  return cudaGetLastError();
}

bool fill_attend(AttendArgs* at, const float* value_t, const float* base_pos,
                 const float* scale_t, const float* off_w_h, const float* h2att_w,
                 const float* h2att_b, const float* cw, const float* cb,
                 const float* aw, const int* shapes, int H, int S, int Dh, int Q,
                 int LP, int L, int A, int R) {
  if (L < 1 || LP % L != 0) return false;
  at->value = value_t; at->base_pos = base_pos; at->scale = scale_t;
  at->off_w = off_w_h; at->h2att_w = h2att_w; at->h2att_b = h2att_b;
  at->cw = cw; at->cb = cb; at->aw = aw;
  at->H = H; at->S = S; at->Dh = Dh; at->Q = Q; at->LP = LP; at->P = LP / L;
  at->A = A; at->R = R;
  return make_levels(L, shapes, S, &at->lv);
}

template <typename Kernel>
cudaError_t set_smem(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
  if (!fill_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w, h2att_b,
                   cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
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
  if (!fill_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w, h2att_b,
                   cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
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
