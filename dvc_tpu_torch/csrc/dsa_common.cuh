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
__device__ __forceinline__ void add_gates(const float* x, int ld, int len,
                                          const float* __restrict__ W, int r,
                                          int R, float (&z)[4][kQT]) {
  const int len4 = len & ~3;
  for (int j = 0; j < len4; j += 4) {
    float w[4][4];  // [j offset][gate]
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < 4; ++g) w[u][g] = W[(size_t)(j + u) * 4 * R + g * R + r];
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
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
      for (int q = 0; q < kQT; ++q) z[g][q] = fmaf(x[q * ld + j], wg, z[g][q]);
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
__device__ __forceinline__ void attend_hvec_taps(const AttendArgs& a,
                                                 const AttendSmem& s, int b,
                                                 int q0) {
  const int tid = threadIdx.x, R = a.R, A = a.A, H = a.H, LP = a.LP;
  const int HLP = H * LP, NR = kQT * HLP, ldR = pad4(R), ldA = pad4(A);
  for (int col = tid; col < A; col += kThreads) {
    float acc[kQT] = {};
    rows_dot_col<kQT>(s.h, ldR, R, a.h2att_w, A, col, acc);
    const float bias = a.h2att_b[col];
#pragma unroll
    for (int q = 0; q < kQT; ++q) s.hvec[q * ldA + col] = acc[q] + bias;
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
__device__ __forceinline__ void attend_softmax(const AttendArgs& a,
                                               const AttendSmem& s) {
  const int tid = threadIdx.x, LP = a.LP;
  for (int g = tid; g < kQT * a.H; g += kThreads) {
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
__device__ __forceinline__ void attend_softmax_ctx(const AttendArgs& a,
                                                   const AttendSmem& s,
                                                   const float* value_b) {
  const int tid = threadIdx.x, H = a.H, LP = a.LP, Dh = a.Dh, HD = H * Dh;
  const int ldHD = pad4(HD);
  attend_softmax(a, s);
  for (int i = tid; i < kQT * HD; i += kThreads) {
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
// host side
// ----------------------------------------------------------------------------

// out (m, n) = X^T Y over N rows: X (N, m), Y (N, n), row-major with leading
// dimensions ldx, ldy.  64 x 64 output tiles, 256 threads of 4 x 4 outputs,
// 16-row slices of X and Y staged in shared memory.  Deterministic: the
// weight gradients' reductions over (video, step, query) rows.  The
// kernel and the host helpers below are static: one copy per translation
// unit (nvcc's stubs do not tell a nested anonymous namespace from the
// file's own).
constexpr int kOT = 64, kOK = 16, kOThreads = 256;

static __global__ void __launch_bounds__(kOThreads)
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

static cudaError_t outer_sum(const float* X, int ldx, const float* Y, int ldy,
                             int N, int m, int n, float* out,
                             cudaStream_t stream) {
  const dim3 grid((n + kOT - 1) / kOT, (m + kOT - 1) / kOT);
  outer_sum_kernel<<<grid, kOThreads, 0, stream>>>(X, ldx, Y, ldy, N, m, n, out);
  return cudaGetLastError();
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
