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
// Every product is written here (no cuBLAS); the GEMM of the tables and the
// weight gradients is dsa_gemm.cuh's.  Activations are read from
// shared memory as float4 (rows padded to 16 bytes); weights come from global
// memory, where they stay L2-resident.  Positions stay level-relative f32 and
// base_pos + off*scale_t is computed with __fmul_rn/__fadd_rn: an FMA would
// round differently from the reference, and floor() would then pick another
// tap at exact boundaries.  tanhf/expf are exact (no fast-math).
//
// The bf16-operand mode (AttendArgs::bf16, the bf16 variants of K4-K6): the
// TPU kernels round both operands of every product to bf16 and accumulate
// in f32 (dvc_tpu/ops/dsa_step.py::_make_dot('bfloat16')).  Here the wrapper
// rounds value and the step's weights once per launch (they enter products
// only), the GEMM rounds its operands (dsa_gemm.cuh), and the activations
// that a product reads from shared memory are stored rounded: h, ctx, the
// lerp weights (where both taps clamp to one row, that row's weight is
// bf16(w_lo + w_hi), as the TPU kernel's one-hot matrix M holds it), and in
// the backwards dz, dhvec, doff and the scattered wts * dctx and du.
// Positions, gates, tanh and the softmax stay f32, as there.  The word-step
// kernels (K7-K10-bf16, dsa_step.cu) are given hvec and pos and return ctx,
// dhvec and dpos to f32 products outside the kernel (h_top . h2att_w, the
// offsets, ctx . ctx_w under K7), which the TPU kernels do not round: there
// dhvec (hvec_given) and K7's ctx (ctx_f32) stay f32.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

#include "dsa_gemm.cuh"

namespace dsa {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kQT = 8;         // queries per block
constexpr int kMaxLevels = 8;

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

// x rounded to bf16 where on (the bf16-operand mode), else x
__device__ __forceinline__ float round_if(bool on, float x) {
  return on ? __uint_as_float(bf16_bits(x)) : x;
}

// round_if on each of x's four lanes
__device__ __forceinline__ float4 round4_if(bool on, float4 x) {
  return on ? make_float4(round_if(true, x.x), round_if(true, x.y), round_if(true, x.z),
                          round_if(true, x.w))
            : x;
}

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
  const float* cb;        // (A)
  const float* aw;        // (A)
  int H, S, Dh, Q, LP, P, A, R;
  int bf16;               // the bf16-operand mode (see the top of this file)
  int hvec_given;         // hvec and pos are operands (the word steps): dhvec
                          // stays f32 in the bf16 mode
  int ctx_f32;            // ctx is an output (K7): stored f32 in the bf16 mode
  Levels lv;
};

// the block's shared buffers that the attention phases use; a row is
// (q, hh, p) of the tile, NR = kQT*H*LP rows
struct AttendSmem {
  float* h;     // (kQT, pad4(R)) hidden state the step starts from
  float* hvec;  // (kQT, pad4(A))
  float* ctx;   // (kQT, pad4(H*Dh))
  float* wlo;   // (NR) lerp weights of the two taps
  float* whi;
  float* d;     // (NR) scores, then softmax weights
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
  const float w_lo = __fsub_rn(1.f, w_hi);
  const int lo = (int)fminf(fmaxf(f_lo, 0.f), hib) + a.lv.start[l];
  const int hi = (int)fminf(fmaxf(f_lo + 1.f, 0.f), hib) + a.lv.start[l];
  s.lo[row] = lo;
  s.hi[row] = hi;
  if (a.bf16 && lo == hi) {
    s.wlo[row] = round_if(true, __fadd_rn(w_lo, w_hi));
    s.whi[row] = 0.f;
  } else {
    s.wlo[row] = round_if(a.bf16, w_lo);
    s.whi[row] = round_if(a.bf16, w_hi);
  }
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
template <int QT = kQT>
__device__ __forceinline__ void attend_given(const AttendArgs& a,
                                             const AttendSmem& s, int b,
                                             int q0, const float* pos,
                                             const float* hvec) {
  const int tid = threadIdx.x, A = a.A, H = a.H, LP = a.LP, Q = a.Q;
  const int HLP = H * LP, NR = QT * HLP, ldA = pad4(A);
  for (int i = tid; i < QT * A; i += kThreads) {
    const int q = i / A, col = i % A, qq = min(q0 + q, Q - 1);
    s.hvec[q * ldA + col] = hvec[((size_t)b * Q + qq) * A + col];
  }
  for (int row = tid; row < NR; row += kThreads) {
    const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
    const int qq = min(q0 + q, Q - 1);
    tap_row(a, s, row, p, pos[(((size_t)b * H + hh) * Q + qq) * LP + p]);
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
    s.ctx[q * ldHD + hd] = round_if(a.bf16 && !a.ctx_f32, acc);
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

// ----------------------------------------------------------------------------
// the attention from the per-video table VW = value . Wc (B, H, S, A), for
// the greedy decode (dsa_greedy.cu), the scan and its backward (dsa_scan.cu)
// and the word-step kernels K7-K10 (dsa_step.cu).  A tap is the lerp of two
// value rows, so taps . Wc is the same lerp of two VW rows: a score costs 2A
// loads and A tanh, and no Dh x A product.
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

// phase 3 from the table as attend_scores_table, each lane on float4 column
// groups (A a multiple of 4; VW rows, cb, aw and hvec rows 16-byte aligned)
// with a row's loads issued ahead of its tanh: the word step's forward K7,
// whose scores are nearly all it computes, so the L2 latency of a row's
// 2A loads is not hidden behind other work.  Ends with a barrier.
template <int QT>
__device__ __forceinline__ void attend_scores_table4(const AttendArgs& a,
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
#pragma unroll 4
    for (int c = lane * 4; c < A; c += 128) {
      const float4 l = ldg4(xl + c), h = ldg4(xh + c), cb = ldg4(a.cb + c);
      const float4 aw = ldg4(a.aw + c), hq = ld4(hv + c);
      acc = fmaf(tanhf(score_pre(wl, l.x, wh, h.x, cb.x, hq.x)), aw.x, acc);
      acc = fmaf(tanhf(score_pre(wl, l.y, wh, h.y, cb.y, hq.y)), aw.y, acc);
      acc = fmaf(tanhf(score_pre(wl, l.z, wh, h.z, cb.z, hq.z)), aw.z, acc);
      acc = fmaf(tanhf(score_pre(wl, l.w, wh, h.w, cb.w, hq.w)), aw.w, acc);
    }
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
// barrier.  A query whose d ctx is zero adds exactly zero everywhere.  In
// the bf16-operand mode the scattered wts * dctx and du, du in dpos's
// scores term, and dhvec (but where hvec is given, a.hvec_given) are
// rounded to bf16 (they are operands of the TPU kernel's products); dcb and
// daw take du in f32.
template <int QT>
__device__ __forceinline__ void attend_backward_table(
    const AttendArgs& a, const AttendSmem& s, const TableGradSmem& g,
    const float* value_b, const float* vw_b, float* dvalue_b, float* G_b,
    const ColGroups& cols, float4 (&dcb)[kColGroups], float4 (&daw)[kColGroups]) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int H = a.H, Dh = a.Dh, LP = a.LP, S = a.S, A = a.A;
  const int HLP = H * LP, NR = QT * HLP, ldA = pad4(A), ldHD = pad4(H * Dh);
  const bool rb = a.bf16;

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
      const float4 t = round4_if(rb, mul4(w, d4));
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
      const float4 ub = round4_if(rb, du);
      dp = fmaf(ub.x, xh.x - xl.x, dp);
      dp = fmaf(ub.y, xh.y - xl.y, dp);
      dp = fmaf(ub.z, xh.z - xl.z, dp);
      dp = fmaf(ub.w, xh.w - xl.w, dp);
      atomic_add4(G_b + ol + c, mul4(wl, ub));
      atomic_add4(G_b + oh + c, mul4(wh, ub));
    }
    dp = warp_sum(dp);
    if (lane == 0) atomicAdd(g.dpos + row, dp);   // the column parts
  }
#pragma unroll
  for (int j = 0; j < kColGroups; ++j)
    if (cols.ok[j])
      *reinterpret_cast<float4*>(g.dhvec + q * ldA + cols.c[j]) =
          round4_if(rb && !a.hvec_given, dhv[j]);
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

// dz (QT, 4R) in shared memory times the transposed gate weights, a thread
// per two output units (rows_dot_rows): for u < R, store(q, u, dz[q] .
// W_hh[u]) (d h); for u = R + i, store(q, u, dz[q] . ctx_w3[i]) (d ctx).
// R even.  No barrier.
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

// the attention operands that every kernel takes; base_pos, scale, off_w
// and h2att are set by the kernels that start from the hidden state
static bool fill_attend(AttendArgs* at, const float* value_t,
                        const float* cb, const float* aw, const int* shapes,
                        int H, int S, int Dh, int Q, int LP, int L, int A,
                        int R) {
  if (L < 1 || LP % L != 0) return false;
  *at = AttendArgs{};
  at->value = value_t; at->cb = cb; at->aw = aw;
  at->H = H; at->S = S; at->Dh = Dh; at->Q = Q; at->LP = LP; at->P = LP / L;
  at->A = A; at->R = R;
  return make_levels(L, shapes, S, &at->lv);
}

// the query tile of a (video, query tile) grid: kQT (8) queries; `largest`
// (16) where kQT-query tiles would take more than one wave, so that each
// weight read serves twice the queries; on a small grid (B = 1) the smallest
// tile of 2 or 4 queries, at least `smallest`, whose grid still fits half
// the SMs, so that more SMs share the fixed work of a step
static int query_tile(int B, int Q, int smallest, int largest) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int QT = (size_t)B * ((Q + kQT - 1) / kQT) > (size_t)sms ? largest : kQT;
  for (int qt : {2, 4})
    if (QT == kQT && qt >= smallest && 2 * (size_t)B * ((Q + qt - 1) / qt) <= (size_t)sms)
      QT = qt;
  return QT;
}

}  // namespace dsa
