// The attention half of one LSTM-DSA word step, shared by the fused greedy
// decode (dsa_greedy.cu), the teacher-forcing scan and its backward
// (dsa_scan.cu) and the single word-step kernels and their backwards
// (dsa_step.cu), so all of them sample and score with the same arithmetic.
// A block owns (video b, a tile of kQT queries); for the hidden state h of
// its queries in shared memory one step computes (the word-step kernels are
// given pos and hvec instead: attend_given)
//
//   hvec = h W_h2att + b                                         (Q, A)
//   pos  = base_pos + (h off_w_h[hh]) * scale_t    per head hh   (Q, LP)
//   taps = border-mode lerp of value_t[b, hh] at pos             (Q, LP, Dh)
//   d    = tanh(taps Wc + cb + hvec) . alpha_w + alpha_b; wts = softmax_LP(d)
//   ctx  = sum_p wts * taps                                      (Q, H*Dh)
//
// Every product is written here (no cuBLAS).  Activations are read from
// shared memory as float4 (rows padded to 16 bytes); weights come from global
// memory, where they stay L2-resident.  Positions stay level-relative f32 and
// base_pos + off*scale_t is computed with __fmul_rn/__fadd_rn: an FMA would
// round differently from the reference, and floor() would then pick another
// tap at exact boundaries.  tanhf/expf are exact (no fast-math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace dsa {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 8;         // queries per block
constexpr int kMaxLevels = 8;
constexpr int kRed = 3 * kQT;  // per-warp floats of block reductions
// scoring product (tap rows x Dh) . (Dh x A) as a tiled GEMM: kBM rows x
// kBN columns per tile, kBK-wide reduction slices of both operands staged
// in shared memory; thread (tid / 64, tid % 64) owns 4 rows x 8 columns
constexpr int kBM = 32;
constexpr int kBN = 512;
constexpr int kBK = 16;
static_assert(kBM * kBK == kThreads && (kBM / 4) * 64 == kThreads, "tiling");

struct Levels {
  int n;
  int T[kMaxLevels];
  int start[kMaxLevels];
};

// level table of the S axis from the host array of level lengths
inline bool make_levels(int L, const int* shapes, int S, Levels* lv) {
  if (L < 1 || L > kMaxLevels) return false;
  lv->n = L;
  int acc = 0;
  for (int l = 0; l < L; ++l) {
    lv->T[l] = shapes[l];
    lv->start[l] = acc;
    acc += shapes[l];
  }
  return acc == S;
}

__host__ __device__ constexpr int pad4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ float sigmoidf_(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[n] += sum_{j < len} x[n*ld + j] * W[j*stride + col] for N rows x in
// shared memory (rows 16-byte aligned, ld a multiple of 4), W row-major
template <int N>
__device__ __forceinline__ void rows_dot_col(const float* x, int ld, int len,
                                             const float* __restrict__ W,
                                             int stride, int col,
                                             float (&acc)[N]) {
  const float* w = W + col;
  const int len4 = len & ~3;
  for (int j = 0; j < len4; j += 4) {
    const float w0 = w[(size_t)j * stride], w1 = w[(size_t)(j + 1) * stride];
    const float w2 = w[(size_t)(j + 2) * stride], w3 = w[(size_t)(j + 3) * stride];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float4 v = ld4(x + n * ld + j);
      acc[n] = fmaf(v.x, w0, acc[n]);
      acc[n] = fmaf(v.y, w1, acc[n]);
      acc[n] = fmaf(v.z, w2, acc[n]);
      acc[n] = fmaf(v.w, w3, acc[n]);
    }
  }
  for (int j = len4; j < len; ++j) {
    const float wj = w[(size_t)j * stride];
#pragma unroll
    for (int n = 0; n < N; ++n) acc[n] = fmaf(x[n * ld + j], wj, acc[n]);
  }
}

// z[q, g*R + r] += sum_j x[q, j] * W[j, g*R + r] for the 4 gates g of
// hidden unit r; x (kQT, len) in shared memory with row stride ld, W
// (len, 4R) row-major
template <int QT = kQT>
__device__ __forceinline__ void add_gates(const float* x, int ld, int len,
                                          const float* __restrict__ W, int r,
                                          int R, float (&z)[4][QT]) {
  const int len4 = len & ~3;
  for (int j = 0; j < len4; j += 4) {
    float w[4][4];  // [j offset][gate]
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) w[u][g] = W[(size_t)(j + u) * 4 * R + g * R + r];
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4 v = ld4(x + q * ld + j);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        z[g][q] = fmaf(v.x, w[0][g], z[g][q]);
        z[g][q] = fmaf(v.y, w[1][g], z[g][q]);
        z[g][q] = fmaf(v.z, w[2][g], z[g][q]);
        z[g][q] = fmaf(v.w, w[3][g], z[g][q]);
      }
    }
  }
  for (int j = len4; j < len; ++j) {
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      const float wg = W[(size_t)j * 4 * R + g * R + r];
#pragma unroll
      for (int q = 0; q < QT; ++q) z[g][q] = fmaf(x[q * ld + j], wg, z[g][q]);
    }
  }
}

// operands of the attention half of a step
struct AttendArgs {
  const float* value;     // (B, H, S, Dh)
  const float* base_pos;  // (B, H, Q, LP)
  const float* scale;     // (B, Q, LP)
  const float* off_w;     // (H, R, LP)
  const float* h2att_w;   // (R, A)
  const float* h2att_b;   // (A)
  const float* cw;        // (Dh, A)
  const float* cb;        // (A)
  const float* aw;        // (A)
  int H, S, Dh, Q, LP, P, A, R;
  Levels lv;
};

// the block's shared buffers that the attention phases use; a row is
// (q, hh, p) of the tile, NR = kQT*H*LP rows
struct AttendSmem {
  float* h;     // (kQT, pad4(R)) hidden state the step starts from
  float* hvec;  // (kQT, pad4(A))
  float* ctx;   // (kQT, pad4(H*Dh))
  float* taps;  // (kBK, kBM) GEMM staging
  float* wc;    // (kBK, kBN) GEMM staging
  float* wlo;   // (NR) lerp weights of the two taps
  float* whi;
  float* d;     // (NR) scores, then softmax weights
  float* red;   // (kWarps, kRed)
  int* lo;      // (NR) flat S indices of the two taps
  int* hi;
};

// the border-mode tap pair of tap row `row` (level tap p) at the
// level-relative position pos: the one place that writes the border rule
__device__ __forceinline__ void tap_row(const AttendArgs& a,
                                        const AttendSmem& s, int row, int p,
                                        float pos) {
  const int l = p / a.P;
  const float hib = (float)(a.lv.T[l] - 1);
  const float f_lo = floorf(pos);
  const float w_hi = __fsub_rn(pos, f_lo);
  s.wlo[row] = __fsub_rn(1.f, w_hi);
  s.whi[row] = w_hi;
  s.lo[row] = (int)fminf(fmaxf(f_lo, 0.f), hib) + a.lv.start[l];
  s.hi[row] = (int)fminf(fmaxf(f_lo + 1.f, 0.f), hib) + a.lv.start[l];
}

// the sampling offset h[q] . off_w[hh][:, p] of tap row (q, hh, p), from
// the hidden states h (kQT, pad4(R)) in shared memory
__device__ __forceinline__ float row_offset(const AttendArgs& a,
                                            const float* h, int row) {
  const int HLP = a.H * a.LP, q = row / HLP, hh = (row / a.LP) % a.H;
  const int ldR = pad4(a.R);
  float o[1] = {};
  rows_dot_col<1>(h + q * ldR, ldR, a.R, a.off_w + (size_t)hh * a.R * a.LP,
                  a.LP, row % a.LP, o);
  return o[0];
}

// phases 1 and 2 from the hidden state: hvec, and the tap table of every
// row at pos = base_pos + (h . off_w) * scale_t.  No barrier at the end.
template <int QT = kQT>
__device__ __forceinline__ void attend_hvec_taps(const AttendArgs& a,
                                                 const AttendSmem& s, int b,
                                                 int q0) {
  const int tid = threadIdx.x, R = a.R, A = a.A, H = a.H, LP = a.LP;
  const int HLP = H * LP, NR = QT * HLP, ldR = pad4(R), ldA = pad4(A);
  for (int col = tid; col < A; col += kThreads) {
    float acc[QT] = {};
    rows_dot_col<QT>(s.h, ldR, R, a.h2att_w, A, col, acc);
    const float bias = a.h2att_b[col];
#pragma unroll
    for (int q = 0; q < QT; ++q) s.hvec[q * ldA + col] = acc[q] + bias;
  }
  for (int row = tid; row < NR; row += kThreads) {
    const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
    const float o = row_offset(a, s.h, row);
    const int qq = min(q0 + q, a.Q - 1);
    const float base = a.base_pos[(((size_t)b * H + hh) * a.Q + qq) * LP + p];
    const float sc = a.scale[((size_t)b * a.Q + qq) * LP + p];
    tap_row(a, s, row, p, __fadd_rn(base, __fmul_rn(o, sc)));
  }
}

// phases 1 and 2 from given operands, for the single word-step kernels:
// hvec (B, Q, A) and the level-relative positions pos (B, H, Q, LP) of the
// tile's queries (one past Q reads the last query).  No barrier at the end.
__device__ __forceinline__ void attend_given(const AttendArgs& a,
                                             const AttendSmem& s, int b,
                                             int q0, const float* pos,
                                             const float* hvec) {
  const int tid = threadIdx.x, A = a.A, H = a.H, LP = a.LP, Q = a.Q;
  const int HLP = H * LP, NR = kQT * HLP, ldA = pad4(A);
  for (int i = tid; i < kQT * A; i += kThreads) {
    const int q = i / A, col = i % A, qq = min(q0 + q, Q - 1);
    s.hvec[q * ldA + col] = hvec[((size_t)b * Q + qq) * A + col];
  }
  for (int row = tid; row < NR; row += kThreads) {
    const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
    const int qq = min(q0 + q, Q - 1);
    tap_row(a, s, row, p, pos[(((size_t)b * H + hh) * Q + qq) * LP + p]);
  }
}

// acc[i][j] = sum_dh taps[r0 + rg*4 + i, dh] * Wc[dh, col_j] for the
// thread's 4 rows and its 8 columns col_j = n0 + cg*4 + j (j < 4) and
// n0 + 256 + cg*4 + j - 4, with (rg, cg) = (tid / 64, tid % 64); the taps
// are lerped from value on the fly.  Barriers inside; all threads call it.
__device__ __forceinline__ void score_tile(const AttendArgs& a,
                                           const AttendSmem& s,
                                           const float* value_b, int r0,
                                           int n0, float (&acc)[4][8]) {
  const int tid = threadIdx.x, rg = tid / 64, cg = tid % 64;
  const int NR = kQT * a.H * a.LP, Dh = a.Dh, A = a.A;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < Dh; k0 += kBK) {
    {  // one tap value per thread, stored k-major
      const int kk = tid / kBM, rr = tid % kBM, row = r0 + rr, dh = k0 + kk;
      float t = 0.f;
      if (row < NR && dh < Dh) {
        const float* v = value_b + (size_t)((row / a.LP) % a.H) * a.S * Dh + dh;
        t = s.wlo[row] * v[(size_t)s.lo[row] * Dh] + s.whi[row] * v[(size_t)s.hi[row] * Dh];
      }
      s.taps[kk * kBM + rr] = t;
    }
    for (int i = tid; i < kBK * kBN; i += kThreads) {
      const int dh = k0 + i / kBN, col = n0 + i % kBN;
      s.wc[i] = (dh < Dh && col < A) ? a.cw[(size_t)dh * A + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 t4 = ld4(s.taps + kk * kBM + rg * 4);
      const float4 u4 = ld4(s.wc + kk * kBN + cg * 4);
      const float4 v4 = ld4(s.wc + kk * kBN + 256 + cg * 4);
      const float t[4] = {t4.x, t4.y, t4.z, t4.w};
      const float w[8] = {u4.x, u4.y, u4.z, u4.w, v4.x, v4.y, v4.z, v4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(t[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }
}

__device__ __forceinline__ int tile_col(int n0, int j) {
  const int cg = threadIdx.x % 64;
  return n0 + (j < 4 ? cg * 4 + j : 256 + cg * 4 + j - 4);
}

// phase 3: d[row] = tanh(taps Wc + cb + hvec) . aw + ab for every row.
// Barriers inside; ends with one.
__device__ __forceinline__ void attend_scores(const AttendArgs& a,
                                              const AttendSmem& s,
                                              const float* value_b, float ab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rg = tid / 64;
  const int HLP = a.H * a.LP, NR = kQT * HLP, A = a.A, ldA = pad4(A);
  for (int r0 = 0; r0 < NR; r0 += kBM) {
    float part[4] = {};
    for (int n0 = 0; n0 < A; n0 += kBN) {
      float acc[4][8];
      score_tile(a, s, value_b, r0, n0, acc);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tile_col(n0, j);
        if (col >= A) continue;
        const float cbv = a.cb[col], awv = a.aw[col];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = min(r0 + rg * 4 + i, NR - 1) / HLP;
          part[i] += tanhf((acc[i][j] + cbv) + s.hvec[q * ldA + col]) * awv;
        }
      }
    }
    // the 64 threads of a row group are warps 2*rg and 2*rg + 1
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = warp_sum(part[i]);
      if (lane == 0) s.red[warp * kRed + i] = v;
    }
    __syncthreads();
    if (tid < kBM && r0 + tid < NR) {
      const int g = tid / 4, i = tid % 4;
      s.d[r0 + tid] = (s.red[2 * g * kRed + i] + s.red[(2 * g + 1) * kRed + i]) + ab;
    }
    __syncthreads();
  }
}

// phase 4: softmax over the LP taps of each (q, head), in place in s.d.
// Ends with a barrier.
template <int QT = kQT>
__device__ __forceinline__ void attend_softmax(const AttendArgs& a,
                                               const AttendSmem& s) {
  const int tid = threadIdx.x, LP = a.LP;
  for (int g = tid; g < QT * a.H; g += kThreads) {
    float* dg = s.d + g * LP;
    float m = -INFINITY;
    for (int p = 0; p < LP; ++p) m = fmaxf(m, dg[p]);
    float sum = 0.f;
    for (int p = 0; p < LP; ++p) {
      const float e = expf(dg[p] - m);
      dg[p] = e;
      sum += e;
    }
    for (int p = 0; p < LP; ++p) dg[p] = dg[p] / sum;
  }
  __syncthreads();
}

// phases 4 and 5: the softmax, then ctx[q, hh*Dh + dh] = sum_p wts * taps.
// Ends with a barrier.
template <int QT = kQT>
__device__ __forceinline__ void attend_softmax_ctx(const AttendArgs& a,
                                                   const AttendSmem& s,
                                                   const float* value_b) {
  const int tid = threadIdx.x, H = a.H, LP = a.LP, Dh = a.Dh, HD = H * Dh;
  const int ldHD = pad4(HD);
  attend_softmax<QT>(a, s);
  for (int i = tid; i < QT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
    const float* v = value_b + (size_t)hh * a.S * Dh + dh;
    const int r0 = (q * H + hh) * LP;
    float acc = 0.f;
    for (int p = 0; p < LP; ++p) {
      const int row = r0 + p;
      const float t = s.wlo[row] * v[(size_t)s.lo[row] * Dh]
                      + s.whi[row] * v[(size_t)s.hi[row] * Dh];
      acc = fmaf(s.d[row], t, acc);
    }
    s.ctx[q * ldHD + hd] = acc;
  }
  __syncthreads();
}

// ----------------------------------------------------------------------------
// backward pieces, shared by the scan backward (dsa_scan.cu) and the word-step
// backwards (dsa_step.cu)
// ----------------------------------------------------------------------------

// backward of the bias-free LSTM cell of one (query, unit) from its gate
// preactivations (i, f, g, o), c_prev and the cotangents gh, gc of (h, c):
// writes the 4 gates' dz and returns d c_prev
__device__ __forceinline__ float cell_bwd(float zi, float zf, float zg,
                                          float zo, float c_prev, float gh,
                                          float gc, float (&dz)[4]) {
  const float si = sigmoidf_(zi), sf = sigmoidf_(zf);
  const float tg = tanhf(zg), so = sigmoidf_(zo);
  const float c_new = sf * c_prev + si * tg;
  const float th = tanhf(c_new);
  const float dc_tot = gc + gh * so * (1.f - th * th);
  dz[0] = dc_tot * tg * si * (1.f - si);
  dz[1] = dc_tot * c_prev * sf * (1.f - sf);
  dz[2] = dc_tot * si * (1.f - tg * tg);
  dz[3] = gh * th * so * (1.f - so);
  return dc_tot * sf;
}

// dz (kQT, 4R) in shared memory times the transposed gate weights: for
// u < R, store(q, u, dz[q] . W_hh[u]) (d h); for u = R + i, store(q, u,
// dz[q] . ctx_w3[i]) (d ctx).  A warp per output unit, lanes along the 4R
// gate columns (coalesced weight rows).  No barrier.
template <typename Store>
__device__ __forceinline__ void gates_backprop(const float* dz, int R, int HD,
                                               const float* __restrict__ w_hh,
                                               const float* __restrict__ ctx_w3,
                                               Store store) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, R4 = 4 * R;
  for (int u = warp; u < R + HD; u += kWarps) {
    const float* w = u < R ? w_hh + (size_t)u * R4 : ctx_w3 + (size_t)(u - R) * R4;
    float acc[kQT] = {};
    for (int j = lane; j < R4; j += 32) {
      const float wj = w[j];
#pragma unroll
      for (int q = 0; q < kQT; ++q) acc[q] = fmaf(dz[q * R4 + j], wj, acc[q]);
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      const float v = warp_sum(acc[q]);
      if (lane == 0) store(q, u, v);
    }
  }
}

// shared buffers of the attention backward
struct AttendGradSmem {
  float* dctx;   // (kQT, pad4(H*Dh)) in: d ctx of the tile
  float* dhvec;  // (kQT, pad4(A)) out: d hvec (zeroed here)
  float* ddot;   // (NR) d wts, then d of the scores
  float* du;     // (kBM, kBN) one row tile's d of the score preactivations
  float* dcb;    // (A) block partial sums, added to
  float* daw;    // (A)
  float* dab;    // (1)
};

// backward of phases 3-5 for the cotangent g.dctx.  On entry: the tap
// table, hvec and the softmax weights (in s.d) of the tile, after a barrier.
// The value rows of video b receive atomics: dvalue_b (H, S, Dh), and G_b
// (H, S, A), the lerp-weighted scatter of du onto the value rows, from which
// dWc = value^T G (a tap is a lerp of two value rows, so sum taps^T du
// equals it).  The scores are recomputed tile by tile to form
// du = ddot * alpha_w * (1 - tanh^2) without storing the (rows, A) tanh
// activations.  On return s.d holds d pos of every tap row; ends with a
// barrier.  A query whose d ctx is zero adds exactly zero everywhere.
__device__ __forceinline__ void attend_backward(const AttendArgs& a,
                                                const AttendSmem& s,
                                                const AttendGradSmem& g,
                                                const float* value_b,
                                                float* dvalue_b, float* G_b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, rg = tid / 64;
  const int H = a.H, Dh = a.Dh, LP = a.LP, S = a.S, A = a.A;
  const int HLP = H * LP, NR = kQT * HLP, ldA = pad4(A), ldHD = pad4(H * Dh);

  // dwts = taps . dctx (a warp per tap row), then
  // ddot = wts * (dwts - sum_p wts * dwts) per (q, head)
  for (int row = warp; row < NR; row += kWarps) {
    const int q = row / HLP, hh = (row / LP) % H;
    const float* v = value_b + (size_t)hh * S * Dh;
    const float* dc = g.dctx + q * ldHD + hh * Dh;
    const float wl = s.wlo[row], wh = s.whi[row];
    const size_t il = (size_t)s.lo[row] * Dh, ih = (size_t)s.hi[row] * Dh;
    float acc = 0.f;
    for (int dh = lane; dh < Dh; dh += 32)
      acc = fmaf(wl * v[il + dh] + wh * v[ih + dh], dc[dh], acc);
    acc = warp_sum(acc);
    if (lane == 0) g.ddot[row] = acc;
  }
  for (int i = tid; i < kQT * ldA; i += kThreads) g.dhvec[i] = 0.f;
  __syncthreads();
  for (int gi = tid; gi < kQT * H; gi += kThreads) {
    float* dw = g.ddot + gi * LP;
    const float* wts = s.d + gi * LP;
    float sum = 0.f;
    for (int p = 0; p < LP; ++p) sum += wts[p] * dw[p];
    float tot = 0.f;
    for (int p = 0; p < LP; ++p) {
      const float dd = wts[p] * (dw[p] - sum);
      dw[p] = dd;
      tot += dd;
    }
    atomicAdd(g.dab, tot);
  }
  __syncthreads();

  // the scores again, tile by tile: du, then dtaps = wts * dctx + du Wc^T,
  // dvalue, G and dpos
  for (int r0 = 0; r0 < NR; r0 += kBM) {
    float acc[4][8];
    score_tile(a, s, value_b, r0, 0, acc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tile_col(0, j);
      if (col >= A) continue;
      const float cbv = a.cb[col], awv = a.aw[col];
      float dcb_p = 0.f, daw_p = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int rr = rg * 4 + i, row = r0 + rr;
        float du = 0.f;
        if (row < NR) {
          const int q = row / HLP, hh = (row / LP) % H;
          const float t = tanhf((acc[i][j] + cbv) + s.hvec[q * ldA + col]);
          const float dd = g.ddot[row];
          du = dd * awv * (1.f - t * t);
          daw_p += dd * t;
          dcb_p += du;
          atomicAdd(g.dhvec + q * ldA + col, du);
          float* Gh = G_b + (size_t)hh * S * A + col;
          atomicAdd(Gh + (size_t)s.lo[row] * A, s.wlo[row] * du);
          atomicAdd(Gh + (size_t)s.hi[row] * A, s.whi[row] * du);
        }
        g.du[rr * kBN + col] = du;
      }
      atomicAdd(g.dcb + col, dcb_p);
      atomicAdd(g.daw + col, daw_p);
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
          s.wc[i] = (a0 + kk < A && dh < Dh) ? a.cw[(size_t)dh * A + a0 + kk] : 0.f;
        }
        __syncthreads();
        const int kmax = min(kBK, A - a0);
        for (int kk = 0; kk < kmax; ++kk) {
          float du[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) du[i] = g.du[(rg * 4 + i) * kBN + a0 + kk];
          const float4 u4 = ld4(s.wc + kk * kBN + (threadIdx.x % 64) * 4);
          const float4 v4 = ld4(s.wc + kk * kBN + 256 + (threadIdx.x % 64) * 4);
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
        const float wts = s.d[row], wl = s.wlo[row], wh = s.whi[row];
        const float* v = value_b + (size_t)hh * S * Dh;
        float* dv = dvalue_b + (size_t)hh * S * Dh;
        const size_t il = (size_t)s.lo[row] * Dh, ih = (size_t)s.hi[row] * Dh;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int dh = tile_col(n0, j);
          if (dh >= Dh) continue;
          const float t = dt[i][j] + wts * g.dctx[q * ldHD + hh * Dh + dh];
          atomicAdd(dv + il + dh, wl * t);
          atomicAdd(dv + ih + dh, wh * t);
          dpos_p[i] += t * (v[ih + dh] - v[il + dh]);
        }
      }
    }
    // the 64 threads of a row group are warps 2*rg and 2*rg + 1; every read
    // of this tile's softmax weights is done, so s.d takes its dpos
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = warp_sum(dpos_p[i]);
      if (lane == 0) s.red[warp * kRed + i] = v;
    }
    __syncthreads();
    if (tid < kBM && r0 + tid < NR) {
      const int gr = tid / 4, i = tid % 4;
      s.d[r0 + tid] = s.red[2 * gr * kRed + i] + s.red[(2 * gr + 1) * kRed + i];
    }
    __syncthreads();
  }
}

// ----------------------------------------------------------------------------
// the attention from the per-video table VW = value . Wc (B, H, S, A), for
// the greedy decode (dsa_greedy.cu) and the scan backward (dsa_scan.cu).  A
// tap is the lerp of two value rows, so taps . Wc is the same lerp of two VW
// rows: a score costs 2A loads and A tanh, and no Dh x A product.  The scan
// forward and the word-step kernels keep the product form above
// (attend_scores, score_tile, attend_backward).
// ----------------------------------------------------------------------------

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// one vector atomic (sm_90) adding v to the 4 floats at p (16-byte aligned)
__device__ __forceinline__ void atomic_add4(float* p, float4 v) {
  atomicAdd(reinterpret_cast<float4*>(p), v);
}

// the score preactivation of one column from the two VW entries of a tap
__device__ __forceinline__ float score_pre(float wl, float xl, float wh,
                                           float xh, float cb, float hv) {
  return ((wl * xl + wh * xh) + cb) + hv;
}

// phase 3 from the table: d[row] = tanh(wlo VW[lo] + whi VW[hi] + cb +
// hvec[q]) . aw + ab, a warp per tap row, lanes along A.  Ends with a
// barrier.
template <int QT = kQT>
__device__ __forceinline__ void attend_scores_table(const AttendArgs& a,
                                                    const AttendSmem& s,
                                                    const float* vw_b, float ab) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int H = a.H, LP = a.LP, A = a.A, HLP = H * LP, NR = QT * HLP;
  const int ldA = pad4(A);
  for (int row = warp; row < NR; row += kWarps) {
    const int q = row / HLP, hh = (row / LP) % H;
    const float* vw = vw_b + (size_t)hh * a.S * A;
    const float* xl = vw + (size_t)s.lo[row] * A;
    const float* xh = vw + (size_t)s.hi[row] * A;
    const float* hv = s.hvec + q * ldA;
    const float wl = s.wlo[row], wh = s.whi[row];
    float acc = 0.f;
    for (int c = lane; c < A; c += 32)
      acc = fmaf(tanhf(score_pre(wl, __ldg(xl + c), wh, __ldg(xh + c),
                                 __ldg(a.cb + c), hv[c])),
                 __ldg(a.aw + c), acc);
    acc = warp_sum(acc);
    if (lane == 0) s.d[row] = acc + ab;
  }
  __syncthreads();
}

// shared buffers of the table-form attention backward
struct TableGradSmem {
  float* dctx;   // (QT, pad4(H*Dh)) in: d ctx of the tile
  float* dhvec;  // (QT, pad4(A)) out: d hvec
  float* ddot;   // (NR) d wts, then d of the scores
  float* dpos;   // (NR) out: d pos of every tap row
  float* dab;    // (1) block partial sum, added to
};

// a lane's columns of the score backward: with QT queries a block, warp w
// owns query w / (kWarps / QT) and the part w % (kWarps / QT) of the A
// columns; a lane the float4 groups part*Ap + lane*4 + 128*j (j <
// kColGroups) below the part's end, Ap = the part's width
constexpr int kColGroups = 2;

struct ColGroups {
  int c[kColGroups];
  bool ok[kColGroups];
  __device__ ColGroups(int A, int parts) {
    const int part = (threadIdx.x >> 5) % parts, lane = threadIdx.x & 31;
    const int Ap = pad4((A + parts - 1) / parts), end = min(A, (part + 1) * Ap);
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      c[j] = part * Ap + lane * 4 + 128 * j;
      ok[j] = c[j] < end;
    }
  }
};

__device__ __forceinline__ float4 f4(float v) { return make_float4(v, v, v, v); }
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 mul4(float s, float4 a) {
  return make_float4(s * a.x, s * a.y, s * a.z, s * a.w);
}

// backward of phases 3-5 for the cotangent g.dctx, in the table form.  On
// entry (after a barrier): the tap table, hvec and the softmax weights (in
// s.d) of the tile.  Adds to dvalue_b (H, S, Dh) only the context's term,
// the lerp-scatter of wts * dctx (the scores' term, du . Wc^T scattered the
// same way, is G . Wc^T, one product per launch); to G_b (H, S, A) the
// lerp-scatter of du = ddot * aw * (1 - tanh^2), from which dWc = value^T G;
// and to the lane's column sums dcb, daw (kColGroups float4 each, kept in
// registers across steps; see ColGroups).  Writes g.dhvec and g.dpos (the
// context's term (v[hi] - v[lo]) . wts dctx plus the scores' (VW[hi] -
// VW[lo]) . du).  Every atomic into global memory is a float4.  Ends with a
// barrier.  A query whose d ctx is zero adds exactly zero everywhere.
template <int QT>
__device__ __forceinline__ void attend_backward_table(
    const AttendArgs& a, const AttendSmem& s, const TableGradSmem& g,
    const float* value_b, const float* vw_b, float* dvalue_b, float* G_b,
    const ColGroups& cols, float4 (&dcb)[kColGroups], float4 (&daw)[kColGroups]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Dh = a.Dh, LP = a.LP, S = a.S, A = a.A;
  const int HLP = H * LP, NR = QT * HLP, ldA = pad4(A), ldHD = pad4(H * Dh);

  // the context's term, a warp per tap row: dwts = taps . dctx, dvalue +=
  // the lerp of wts * dctx, dpos = wts (v[hi] - v[lo]) . dctx
  for (int row = warp; row < NR; row += kWarps) {
    const int q = row / HLP, hh = (row / LP) % H;
    const float* v = value_b + (size_t)hh * S * Dh;
    float* dv = dvalue_b + (size_t)hh * S * Dh;
    const float* dc = g.dctx + q * ldHD + hh * Dh;
    const float wl = s.wlo[row], wh = s.whi[row], w = s.d[row];
    const size_t il = (size_t)s.lo[row] * Dh, ih = (size_t)s.hi[row] * Dh;
    float dw = 0.f, dp = 0.f;
    for (int c = lane * 4; c < Dh; c += 128) {
      const float4 vl = ldg4(v + il + c), vh = ldg4(v + ih + c), d4 = ld4(dc + c);
      dw = fmaf(wl * vl.x + wh * vh.x, d4.x, dw);
      dw = fmaf(wl * vl.y + wh * vh.y, d4.y, dw);
      dw = fmaf(wl * vl.z + wh * vh.z, d4.z, dw);
      dw = fmaf(wl * vl.w + wh * vh.w, d4.w, dw);
      dp = fmaf(vh.x - vl.x, d4.x, dp);
      dp = fmaf(vh.y - vl.y, d4.y, dp);
      dp = fmaf(vh.z - vl.z, d4.z, dp);
      dp = fmaf(vh.w - vl.w, d4.w, dp);
      const float4 t = mul4(w, d4);
      atomic_add4(dv + il + c, mul4(wl, t));
      atomic_add4(dv + ih + c, mul4(wh, t));
    }
    dw = warp_sum(dw);
    dp = warp_sum(dp);
    if (lane == 0) {
      g.ddot[row] = dw;
      g.dpos[row] = w * dp;
    }
  }
  __syncthreads();
  // ddot = wts * (dwts - sum_p wts * dwts) per (q, head)
  for (int gi = tid; gi < QT * H; gi += kThreads) {
    float* dw = g.ddot + gi * LP;
    const float* wts = s.d + gi * LP;
    float sum = 0.f;
    for (int p = 0; p < LP; ++p) sum += wts[p] * dw[p];
    float tot = 0.f;
    for (int p = 0; p < LP; ++p) {
      const float dd = wts[p] * (dw[p] - sum);
      dw[p] = dd;
      tot += dd;
    }
    atomicAdd(g.dab, tot);
  }
  __syncthreads();

  // the scores' term, a warp per (query, column part) over the query's tap
  // rows: the scores again from the table, du, and its scatters
  const int q = warp / (kWarps / QT);
  float4 cbv[kColGroups], awv[kColGroups], hv[kColGroups], dhv[kColGroups];
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    dhv[j] = f4(0.f);
    if (!cols.ok[j]) continue;
    cbv[j] = ldg4(a.cb + cols.c[j]);
    awv[j] = ldg4(a.aw + cols.c[j]);
    hv[j] = ld4(s.hvec + q * ldA + cols.c[j]);
  }
  for (int row = q * HLP; row < (q + 1) * HLP; ++row) {
    const int hh = (row / LP) % H;
    const size_t ol = ((size_t)hh * S + s.lo[row]) * A, oh = ((size_t)hh * S + s.hi[row]) * A;
    const float wl = s.wlo[row], wh = s.whi[row], dd = g.ddot[row];
    float dp = 0.f;
#pragma unroll
    for (int j = 0; j < kColGroups; ++j) {
      if (!cols.ok[j]) continue;
      const int c = cols.c[j];
      const float4 xl = ldg4(vw_b + ol + c), xh = ldg4(vw_b + oh + c);
      const float u[4] = {tanhf(score_pre(wl, xl.x, wh, xh.x, cbv[j].x, hv[j].x)),
                          tanhf(score_pre(wl, xl.y, wh, xh.y, cbv[j].y, hv[j].y)),
                          tanhf(score_pre(wl, xl.z, wh, xh.z, cbv[j].z, hv[j].z)),
                          tanhf(score_pre(wl, xl.w, wh, xh.w, cbv[j].w, hv[j].w))};
      const float4 du = make_float4(dd * awv[j].x * (1.f - u[0] * u[0]),
                                    dd * awv[j].y * (1.f - u[1] * u[1]),
                                    dd * awv[j].z * (1.f - u[2] * u[2]),
                                    dd * awv[j].w * (1.f - u[3] * u[3]));
      daw[j] = add4(daw[j], make_float4(dd * u[0], dd * u[1], dd * u[2], dd * u[3]));
      dcb[j] = add4(dcb[j], du);
      dhv[j] = add4(dhv[j], du);
      dp = fmaf(du.x, xh.x - xl.x, dp);
      dp = fmaf(du.y, xh.y - xl.y, dp);
      dp = fmaf(du.z, xh.z - xl.z, dp);
      dp = fmaf(du.w, xh.w - xl.w, dp);
      atomic_add4(G_b + ol + c, mul4(wl, du));
      atomic_add4(G_b + oh + c, mul4(wh, du));
    }
    dp = warp_sum(dp);
    if (lane == 0) atomicAdd(g.dpos + row, dp);   // the column parts
  }
#pragma unroll
  for (int j = 0; j < kColGroups; ++j)
    if (cols.ok[j]) *reinterpret_cast<float4*>(g.dhvec + q * ldA + cols.c[j]) = dhv[j];
  __syncthreads();
}

// acc[i][q] += sum_{j < len} x[q*ldx + j] * W[(u0 + i)*ldw + j] for the QT
// rows of x in shared memory and U consecutive rows of W (both 16-byte
// aligned, ldx and ldw multiples of 4); rows past n_rows read the last one
// (the caller drops them).  A thread owns U output units: each weight is
// read once per block and used for the QT queries, each activation is a
// shared-memory broadcast used for U units.
template <int U, int QT>
__device__ __forceinline__ void rows_dot_rows(const float* x, int ldx, int len,
                                              const float* __restrict__ W, int ldw,
                                              int u0, int n_rows, float (&acc)[U][QT]) {
  const float* w[U];
#pragma unroll
  for (int i = 0; i < U; ++i) w[i] = W + (size_t)min(u0 + i, n_rows - 1) * ldw;
  const int len8 = len & ~7;
  for (int j = 0; j < len8; j += 8) {
    float4 wa[U], wb[U];
#pragma unroll
    for (int i = 0; i < U; ++i) { wa[i] = ldg4(w[i] + j); wb[i] = ldg4(w[i] + j + 4); }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4 xa = ld4(x + q * ldx + j), xb = ld4(x + q * ldx + j + 4);
#pragma unroll
      for (int i = 0; i < U; ++i) {
        float t = acc[i][q];
        t = fmaf(xa.x, wa[i].x, t); t = fmaf(xa.y, wa[i].y, t);
        t = fmaf(xa.z, wa[i].z, t); t = fmaf(xa.w, wa[i].w, t);
        t = fmaf(xb.x, wb[i].x, t); t = fmaf(xb.y, wb[i].y, t);
        t = fmaf(xb.z, wb[i].z, t); t = fmaf(xb.w, wb[i].w, t);
        acc[i][q] = t;
      }
    }
  }
  for (int j = len8; j < len; ++j)
#pragma unroll
    for (int i = 0; i < U; ++i) {
      const float wj = __ldg(w[i] + j);
#pragma unroll
      for (int q = 0; q < QT; ++q) acc[i][q] = fmaf(x[q * ldx + j], wj, acc[i][q]);
    }
}

// gates_backprop with a thread per two output units (rows_dot_rows): for
// u < R, store(q, u, dz[q] . W_hh[u]) (d h); for u = R + i, store(q, u,
// dz[q] . ctx_w3[i]) (d ctx).  dz (QT, 4R) in shared memory; R even.  No
// barrier.
template <int QT, typename Store>
__device__ __forceinline__ void gates_backprop_rows(const float* dz, int R, int HD,
                                                    const float* __restrict__ w_hh,
                                                    const float* __restrict__ ctx_w3,
                                                    Store store) {
  constexpr int U = 2;
  const int R4 = 4 * R;
  for (int u0 = threadIdx.x * U; u0 < R + HD; u0 += kThreads * U) {
    float acc[U][QT] = {};
    const bool hid = u0 < R;
    const int n = hid ? R : HD;
    rows_dot_rows<U, QT>(dz, R4, R4, hid ? w_hh : ctx_w3, R4, hid ? u0 : u0 - R, n, acc);
#pragma unroll
    for (int i = 0; i < U; ++i) {
      if ((hid ? u0 + i : u0 + i - R) >= n) continue;
#pragma unroll
      for (int q = 0; q < QT; ++q) store(q, u0 + i, acc[i][q]);
    }
  }
}

// ----------------------------------------------------------------------------
// host side
// ----------------------------------------------------------------------------

// The tiled f32 GEMM of the per-video tables, of dvalue's G . Wc^T and of
// the weight gradients' outer sums: out (M, N) (+)= X' Y' summed over T
// terms, X' (M, T) and Y' (T, N).  An operand is stored either along its
// output axis (X (M, T) or Y (N, T): element (i, t) at p[i*ld + t]) or
// along the terms (X (T, M) or Y (T, N): element (t, i) at p[t*ld + i]);
// the callers use three of the four pairs (X along the terms goes with Y
// along the terms only).
// 128 x 128 output tiles, 256 threads of 8 x 8 outputs, 8-term slices of
// both operands staged in shared memory while the next slice is fetched into
// registers.  With a workspace, T is cut into fixed chunks (split-K) whose
// partial tiles a second kernel adds in chunk order: deterministic.  The
// kernels and the host helpers below are static: one copy per translation
// unit (nvcc's stubs do not tell a nested anonymous namespace from the
// file's own).
constexpr int kGT = 128, kGK = 8, kGThreads = 256, kGSplitMax = 8;

struct Operand {
  const float* p;
  int ld;
  bool by_term;  // element (t, i) at p[t*ld + i]; else (i, t) at p[i*ld + t]
};

template <bool ByTerm>
__device__ __forceinline__ float gemm_fetch(const float* __restrict__ p, int ld,
                                            int e, int i0, int t0, int M, int t_end) {
  const int t = ByTerm ? e / kGT : e % kGK, i = ByTerm ? e % kGT : e / kGK;
  if (i0 + i >= M || t0 + t >= t_end) return 0.f;
  return __ldg(p + (ByTerm ? (size_t)(t0 + t) * ld + i0 + i : (size_t)(i0 + i) * ld + t0 + t));
}

template <bool XByTerm, bool YByTerm>
static __global__ void __launch_bounds__(kGThreads, 2)
gemm_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
            int M, int N, int T, int chunk, int accumulate, float* __restrict__ out) {
  __shared__ __align__(16) float xs[kGK][kGT + 4];
  __shared__ __align__(16) float ys[kGK][kGT + 4];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int i0 = blockIdx.y * kGT, j0 = blockIdx.x * kGT;
  const int t_begin = blockIdx.z * chunk, t_end = min(T, t_begin + chunk);
  constexpr int kPer = kGT * kGK / kGThreads;
  float xr[kPer], yr[kPer], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    xr[u] = gemm_fetch<XByTerm>(X, ldx, tid + u * kGThreads, i0, t_begin, M, t_end);
    yr[u] = gemm_fetch<YByTerm>(Y, ldy, tid + u * kGThreads, j0, t_begin, N, t_end);
  }
  for (int t0 = t_begin; t0 < t_end; t0 += kGK) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int e = tid + u * kGThreads;
      xs[XByTerm ? e / kGT : e % kGK][XByTerm ? e % kGT : e / kGK] = xr[u];
      ys[YByTerm ? e / kGT : e % kGK][YByTerm ? e % kGT : e / kGK] = yr[u];
    }
    __syncthreads();
    if (t0 + kGK < t_end) {
#pragma unroll
      for (int u = 0; u < kPer; ++u) {
        xr[u] = gemm_fetch<XByTerm>(X, ldx, tid + u * kGThreads, i0, t0 + kGK, M, t_end);
        yr[u] = gemm_fetch<YByTerm>(Y, ldy, tid + u * kGThreads, j0, t0 + kGK, N, t_end);
      }
    }
#pragma unroll
    for (int k = 0; k < kGK; ++k) {
      const float4 a0 = ld4(&xs[k][ty * 4]), a1 = ld4(&xs[k][64 + ty * 4]);
      const float4 b0 = ld4(&ys[k][tx * 4]), b1 = ld4(&ys[k][64 + tx * 4]);
      const float x[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float y[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(x[i], y[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = i0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (c >= N) continue;
      const size_t at = (size_t)r * N + c;
      o[at] = accumulate ? o[at] + acc[i][j] : acc[i][j];
    }
  }
}

// out[i] (+)= sum_z part[z][i] in chunk order
static __global__ void split_sum_kernel(const float* __restrict__ part, int splits,
                                        size_t n, int accumulate,
                                        float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = accumulate ? out[i] : 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
    out[i] = s;
  }
}

// out (M, N) row-major (+)= X' Y' over T terms (see gemm_kernel).  work, if
// not null, holds work_floats floats for split-K partial tiles: the terms
// are cut into up to kGSplitMax chunks, as many as keep the grid within one
// wave of two blocks per SM.
static cudaError_t gemm(Operand x, Operand y, int M, int N, int T, bool accumulate,
                        float* out, float* work, size_t work_floats,
                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const int tiles = ((M + kGT - 1) / kGT) * ((N + kGT - 1) / kGT);
  int splits = 1;
  if (work != nullptr && T > 0) {
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    splits = std::min(2 * sms / tiles, kGSplitMax);
    splits = std::min(splits, std::max(1, T / (32 * kGK)));
    splits = (int)std::min((size_t)splits, work_floats / ((size_t)M * N));
    splits = std::max(splits, 1);
  }
  int chunk = ((T + splits - 1) / splits + kGK - 1) / kGK * kGK;
  if (chunk == 0) chunk = kGK;
  splits = T > 0 ? (T + chunk - 1) / chunk : 1;
  const dim3 grid((N + kGT - 1) / kGT, (M + kGT - 1) / kGT, splits);
  float* dst = splits > 1 ? work : out;
  const int acc = splits > 1 ? 0 : (int)accumulate;
  if (x.by_term && !y.by_term) return cudaErrorInvalidValue;  // no caller
  if (x.by_term)
    gemm_kernel<true, true><<<grid, kGThreads, 0, stream>>>(x.p, x.ld, y.p, y.ld, M, N, T, chunk, acc, dst);
  else if (y.by_term)
    gemm_kernel<false, true><<<grid, kGThreads, 0, stream>>>(x.p, x.ld, y.p, y.ld, M, N, T, chunk, acc, dst);
  else
    gemm_kernel<false, false><<<grid, kGThreads, 0, stream>>>(x.p, x.ld, y.p, y.ld, M, N, T, chunk, acc, dst);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min((n + 255) / 256, (size_t)4096);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(work, splits, n, (int)accumulate, out);
  return cudaGetLastError();
}

// out (m, n) = X^T Y over N rows: X (N, m), Y (N, n), row-major with leading
// dimensions ldx, ldy (the weight gradients' reductions over (video, step,
// query) rows); deterministic
static cudaError_t outer_sum(const float* X, int ldx, const float* Y, int ldy,
                             int N, int m, int n, float* out,
                             cudaStream_t stream, float* work = nullptr,
                             size_t work_floats = 0) {
  return gemm(Operand{X, ldx, true}, Operand{Y, ldy, true}, m, n, N, false, out,
              work, work_floats, stream);
}

// table (N, n) = X (N, k) W (k, n), both row-major: the per-video table
// value . Wc (N = B*H*S rows) and the vocabulary's embed . token_w
static cudaError_t row_table(const float* X, const float* W, int N, int k, int n,
                             float* table, cudaStream_t stream) {
  return gemm(Operand{X, k, false}, Operand{W, n, true}, N, n, k, false, table,
              nullptr, 0, stream);
}

// the attention operands that every kernel takes; base_pos, scale, off_w
// and h2att are set by the kernels that start from the hidden state
static bool fill_attend(AttendArgs* at, const float* value_t, const float* cw,
                        const float* cb, const float* aw, const int* shapes,
                        int H, int S, int Dh, int Q, int LP, int L, int A,
                        int R) {
  if (L < 1 || LP % L != 0) return false;
  *at = AttendArgs{};
  at->value = value_t; at->cw = cw; at->cb = cb; at->aw = aw;
  at->H = H; at->S = S; at->Dh = Dh; at->Q = Q; at->LP = LP; at->P = LP / L;
  at->A = A; at->R = R;
  return make_levels(L, shapes, S, &at->lv);
}

// opt a kernel into `smem` bytes of dynamic shared memory, or refuse
template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace dsa
