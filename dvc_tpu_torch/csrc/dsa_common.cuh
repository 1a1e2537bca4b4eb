// The attention half of one LSTM-DSA word step, shared by the fused greedy
// decode (dsa_greedy.cu) and the teacher-forcing scan and its backward
// (dsa_scan.cu), so the three kernels sample and score with the same
// arithmetic.  A block owns (video b, a tile of kQT queries); for the hidden
// state h of its queries in shared memory one step computes
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

// phases 1 and 2: hvec, and the border-mode tap table of every row; off
// (nullable) receives each row's offset h . off_w.  No barrier at the end.
__device__ __forceinline__ void attend_hvec_taps(const AttendArgs& a,
                                                 const AttendSmem& s, int b,
                                                 int q0, float* off) {
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
    float o[1] = {};
    rows_dot_col<1>(s.h + q * ldR, ldR, R, a.off_w + (size_t)hh * R * LP,
                    LP, p, o);
    const int qq = min(q0 + q, a.Q - 1);
    const float base = a.base_pos[(((size_t)b * H + hh) * a.Q + qq) * LP + p];
    const float sc = a.scale[((size_t)b * a.Q + qq) * LP + p];
    const float pos = __fadd_rn(base, __fmul_rn(o[0], sc));
    const int l = p / a.P;
    const float hib = (float)(a.lv.T[l] - 1);
    const float f_lo = floorf(pos);
    const float w_hi = __fsub_rn(pos, f_lo);
    s.wlo[row] = __fsub_rn(1.f, w_hi);
    s.whi[row] = w_hi;
    s.lo[row] = (int)fminf(fmaxf(f_lo, 0.f), hib) + a.lv.start[l];
    s.hi[row] = (int)fminf(fmaxf(f_lo + 1.f, 0.f), hib) + a.lv.start[l];
    if (off) off[row] = o[0];
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

// phases 4 and 5: softmax over the LP taps of each (q, head), then
// ctx[q, hh*Dh + dh] = sum_p wts * taps.  Ends with a barrier.
__device__ __forceinline__ void attend_softmax_ctx(const AttendArgs& a,
                                                   const AttendSmem& s,
                                                   const float* value_b) {
  const int tid = threadIdx.x, H = a.H, LP = a.LP, Dh = a.Dh, HD = H * Dh;
  const int ldHD = pad4(HD);
  for (int g = tid; g < kQT * H; g += kThreads) {
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

}  // namespace dsa
