// Fused greedy caption decode of the LSTM-DSA head: all K word steps in one
// launch.
//
// Replaces the Pallas TPU kernel `_make_greedy_kernel`
// (dvc_tpu/ops/dsa_greedy.py).  The TPU grid (B, K) runs k in order on one
// core and keeps h, c and the fed-back token in VMEM scratch.  On Hopper the
// queries of a video are independent (they share only value[b] and the
// weights), so here one block owns (b, a tile of kQT queries) and loops over
// the K steps itself, with h, c, hvec, the staged embedding rows, ctx, the
// tap table and the fed-back tokens in shared memory.  Each word step:
//
//   hvec = h W_h2att + b_h2att                                   (Q, A)
//   pos  = base_pos + (h off_w_h[hh]) * scale_t    per head hh   (Q, LP)
//   taps = border-mode lerp of value_t[b, hh] at pos             (Q, LP, Dh)
//   d    = tanh(taps Wc + cb + hvec) . alpha_w + alpha_b; wts = softmax_LP(d)
//   ctx  = sum_p wts * taps                                      (Q, H*Dh)
//   z    = const_z + embed[tok] token_w + h W_hh + ctx ctx_w3    (Q, 4R)
//   (h, c) = bias-free LSTM cell of z (gate order i, f, g, o)
//   logits = h logit_w + logit_b;  tok = first argmax;  lp = max - logsumexp
//
// Every product is written here (no cuBLAS).  The weights (~20 MB f32 at
// R = A = E = 512, V+1 = 1608) are read from global memory, where they stay
// L2-resident; a tile of kQT queries shares each weight read.  The vocab
// projection keeps an online (max, sum-exp, first-max index) per query, so
// the (kQT, V+1) logits are never stored.
//
// Bound on this card: the products read their activations from shared
// memory and their weights from L2, so they are bound by shared-load issue
// and L2 bandwidth rather than the FP32 peak.  Activations are read as
// float4 (rows padded to 16 bytes), each thread keeps several outputs in
// registers (4 gates x 8 queries in the LSTM product, 4 vocab columns x 8
// queries in the logits, a 4 x 8 tile of the scoring GEMM), and 512
// threads (16 warps per SM) hide the L2 latency of the weight reads.  The
// largest product is taps Wc (H*LP*Dh*A MACs per query and step); it
// equals the lerp of a precomputed value Wc, which a later version can
// hoist out of the loop.
//
// Positions stay level-relative f32 and base_pos + off*scale_t is computed
// with __fmul_rn/__fadd_rn: an FMA would round differently from the
// reference, and floor() would then pick another tap at exact boundaries.
// The transcendentals are the exact tanhf/expf/logf (no fast-math).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

namespace {

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
constexpr int kLC = 4;         // vocab columns per thread per pass
static_assert(kBM * kBK == kThreads && (kBM / 4) * 64 == kThreads, "tiling");

struct Levels {
  int n;
  int T[kMaxLevels];
  int start[kMaxLevels];
};

struct GreedyArgs {
  const float* value;     // (B, H, S, Dh)
  const float* base_pos;  // (B, H, Q, LP)
  const float* scale;     // (B, Q, LP)
  const float* const_z;   // (B, Q, 4R)
  const float* embed;     // (V1, E)
  const float* token_w;   // (E, 4R)
  const float* logit_w;   // (R, V1)
  const float* logit_b;   // (V1)
  const float* off_w;     // (H, R, LP)
  const float* h2att_w;   // (R, A)
  const float* h2att_b;   // (A)
  const float* cw;        // (Dh, A)
  const float* cb;        // (A)
  const float* aw;        // (A)
  const float* ctx_w3;    // (H*Dh, 4R)
  const float* w_hh;      // (R, 4R)
  const float* ab;        // (1): read on the card, so the host never waits
  int* tok;               // (B, K, Q)
  float* lp;              // (B, K, Q)
  int B, H, S, Dh, Q, LP, P, A, R, E, V1, K;
  Levels lv;
};

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

// merge (m2, s2, i2) into the running (max, sum of exp(x - max), first-max
// index); s == 0 marks an empty partial
__device__ __forceinline__ void lse_merge(float& m, float& s, int& i, float m2,
                                          float s2, int i2) {
  if (s2 == 0.f) return;
  if (s == 0.f) {
    m = m2; s = s2; i = i2;
    return;
  }
  if (m2 > m) {
    s = s * expf(m - m2) + s2;
    m = m2;
    i = i2;
  } else {
    s = s + s2 * expf(m2 - m);
    if (m2 == m && i2 < i) i = i2;
  }
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

// acc[c][q] += sum_{j < len} x[q*ld + j] * W[j*stride + n_c] for the kLC
// columns n_c = n0 + c*kThreads (clamped to the last column; the caller
// drops the ones past it) and the kQT rows of x in shared memory
__device__ __forceinline__ void cols_dot_rows(const float* x, int ld, int len,
                                              const float* __restrict__ W,
                                              int stride, int n0,
                                              float (&acc)[kLC][kQT]) {
  int n[kLC];
#pragma unroll
  for (int c = 0; c < kLC; ++c) n[c] = min(n0 + c * kThreads, stride - 1);
  const int len4 = len & ~3;
  for (int j = 0; j < len4; j += 4) {
    float w[kLC][4];
#pragma unroll
    for (int c = 0; c < kLC; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) w[c][u] = W[(size_t)(j + u) * stride + n[c]];
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      const float4 v = ld4(x + q * ld + j);
#pragma unroll
      for (int c = 0; c < kLC; ++c) {
        acc[c][q] = fmaf(v.x, w[c][0], acc[c][q]);
        acc[c][q] = fmaf(v.y, w[c][1], acc[c][q]);
        acc[c][q] = fmaf(v.z, w[c][2], acc[c][q]);
        acc[c][q] = fmaf(v.w, w[c][3], acc[c][q]);
      }
    }
  }
  for (int j = len4; j < len; ++j) {
#pragma unroll
    for (int c = 0; c < kLC; ++c) {
      const float wj = W[(size_t)j * stride + n[c]];
#pragma unroll
      for (int q = 0; q < kQT; ++q) acc[c][q] = fmaf(x[q * ld + j], wj, acc[c][q]);
    }
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

// shared-memory layout (floats, then ints), shared by host and device; every
// row of a (rows, len) region starts 16-byte aligned (stride pad4(len))
struct Layout {
  int h, hn, c, hvec, emb, ctx, taps, wc, wlo, whi, d, red;  // float offsets
  int lo, hi, tok;                                            // int offsets
  int floats, ints;
  __host__ __device__ Layout(int R, int A, int E, int HD, int NR) {
    int o = 0;
    h = o;    o += kQT * pad4(R);
    hn = o;   o += kQT * pad4(R);
    c = o;    o += kQT * pad4(R);
    hvec = o; o += kQT * pad4(A);
    emb = o;  o += kQT * pad4(E);
    ctx = o;  o += kQT * pad4(HD);
    taps = o; o += kBK * kBM;
    wc = o;   o += kBK * kBN;
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    red = o;  o += kWarps * kRed;
    floats = o;
    int j = 0;
    lo = j;  j += NR;
    hi = j;  j += NR;
    tok = j; j += kQT;
    ints = j;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

__global__ void __launch_bounds__(kThreads) greedy_kernel(GreedyArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int R = a.R, A = a.A, E = a.E, H = a.H, Dh = a.Dh, LP = a.LP;
  const int HD = H * Dh, R4 = 4 * R, HLP = H * LP, NR = kQT * HLP;
  const int ldR = pad4(R), ldA = pad4(A), ldE = pad4(E), ldHD = pad4(HD);
  const Layout L(R, A, E, HD, NR);
  float* h_s = smem + L.h;
  float* hn_s = smem + L.hn;
  float* c_s = smem + L.c;
  float* hvec_s = smem + L.hvec;
  float* emb_s = smem + L.emb;
  float* ctx_s = smem + L.ctx;
  float* taps_s = smem + L.taps;
  float* wc_s = smem + L.wc;
  float* wlo_s = smem + L.wlo;
  float* whi_s = smem + L.whi;
  float* d_s = smem + L.d;
  float* red_s = smem + L.red;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  int* lo_s = ints + L.lo;
  int* hi_s = ints + L.hi;
  int* tok_s = ints + L.tok;

  // queries past the end of the ragged last tile compute on a copy of the
  // last query and write nothing
  int qg[kQT];
#pragma unroll
  for (int q = 0; q < kQT; ++q) qg[q] = min(q0 + q, a.Q - 1);

  // zero h and c, padding included (the float4 reads never use it)
  for (int i = tid; i < kQT * ldR; i += kThreads) { h_s[i] = 0.f; c_s[i] = 0.f; }
  if (tid < kQT) tok_s[tid] = 0;  // BOS
  __syncthreads();

  const float* value_b = a.value + (size_t)b * H * a.S * Dh;
  const float ab = __ldg(a.ab);

  for (int k = 0; k < a.K; ++k) {
    // ---- 1. hvec = h W_h2att + b
    for (int col = tid; col < A; col += kThreads) {
      float acc[kQT] = {};
      rows_dot_col<kQT>(h_s, ldR, R, a.h2att_w, A, col, acc);
      const float bias = a.h2att_b[col];
#pragma unroll
      for (int q = 0; q < kQT; ++q) hvec_s[q * ldA + col] = acc[q] + bias;
    }
    // ---- 2. sampling offsets -> border-mode tap table; rows (q, hh, p)
    for (int row = tid; row < NR; row += kThreads) {
      const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
      float off[1] = {};
      rows_dot_col<1>(h_s + q * ldR, ldR, R, a.off_w + (size_t)hh * R * LP,
                      LP, p, off);
      const int qq = min(q0 + q, a.Q - 1);
      const float base = a.base_pos[(((size_t)b * H + hh) * a.Q + qq) * LP + p];
      const float sc = a.scale[((size_t)b * a.Q + qq) * LP + p];
      const float pos = __fadd_rn(base, __fmul_rn(off[0], sc));
      const int l = p / a.P;
      const float hib = (float)(a.lv.T[l] - 1);
      const float f_lo = floorf(pos);
      const float w_hi = __fsub_rn(pos, f_lo);
      wlo_s[row] = __fsub_rn(1.f, w_hi);
      whi_s[row] = w_hi;
      lo_s[row] = (int)fminf(fmaxf(f_lo, 0.f), hib) + a.lv.start[l];
      hi_s[row] = (int)fminf(fmaxf(f_lo + 1.f, 0.f), hib) + a.lv.start[l];
    }
    // ---- embedding rows of the fed-back tokens
    for (int i = tid; i < kQT * E; i += kThreads) {
      const int q = i / E, e = i % E;
      emb_s[q * ldE + e] = a.embed[(size_t)tok_s[q] * E + e];
    }
    __syncthreads();

    // ---- 3. attention scores d = tanh(taps Wc + cb + hvec) . aw + ab:
    //         tiles of kBM tap rows x kBN columns, kBK-slices of the taps
    //         (lerped from value on the fly) and of Wc in shared memory
    {
      const int rg = tid / 64, cg = tid % 64;  // rows rg*4.., cols cg*4.., 256+cg*4..
      for (int r0 = 0; r0 < NR; r0 += kBM) {
        float part[4] = {};
        for (int n0 = 0; n0 < A; n0 += kBN) {
          float acc[4][8] = {};
          for (int k0 = 0; k0 < Dh; k0 += kBK) {
            {  // one tap value per thread, stored k-major
              const int kk = tid / kBM, rr = tid % kBM, row = r0 + rr, dh = k0 + kk;
              float t = 0.f;
              if (row < NR && dh < Dh) {
                const float* v = value_b + (size_t)((row / LP) % H) * a.S * Dh + dh;
                t = wlo_s[row] * v[(size_t)lo_s[row] * Dh]
                    + whi_s[row] * v[(size_t)hi_s[row] * Dh];
              }
              taps_s[kk * kBM + rr] = t;
            }
            for (int i = tid; i < kBK * kBN; i += kThreads) {
              const int dh = k0 + i / kBN, col = n0 + i % kBN;
              wc_s[i] = (dh < Dh && col < A) ? a.cw[(size_t)dh * A + col] : 0.f;
            }
            __syncthreads();
#pragma unroll
            for (int kk = 0; kk < kBK; ++kk) {
              const float4 t4 = ld4(taps_s + kk * kBM + rg * 4);
              const float4 u4 = ld4(wc_s + kk * kBN + cg * 4);
              const float4 v4 = ld4(wc_s + kk * kBN + 256 + cg * 4);
              const float t[4] = {t4.x, t4.y, t4.z, t4.w};
              const float w[8] = {u4.x, u4.y, u4.z, u4.w, v4.x, v4.y, v4.z, v4.w};
#pragma unroll
              for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(t[i], w[j], acc[i][j]);
            }
            __syncthreads();
          }
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int col = n0 + (j < 4 ? cg * 4 + j : 256 + cg * 4 + j - 4);
            if (col >= A) continue;
            const float cbv = a.cb[col], awv = a.aw[col];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int q = min(r0 + rg * 4 + i, NR - 1) / HLP;
              part[i] += tanhf((acc[i][j] + cbv) + hvec_s[q * ldA + col]) * awv;
            }
          }
        }
        // the 64 threads of a row group are warps 2*rg and 2*rg + 1
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = warp_sum(part[i]);
          if (lane == 0) red_s[warp * kRed + i] = v;
        }
        __syncthreads();
        if (tid < kBM && r0 + tid < NR) {
          const int g = tid / 4, i = tid % 4;
          d_s[r0 + tid] = (red_s[2 * g * kRed + i] + red_s[(2 * g + 1) * kRed + i])
                          + ab;
        }
        __syncthreads();
      }
    }

    // ---- 4. softmax over the LP taps of each (q, head)
    for (int g = tid; g < kQT * H; g += kThreads) {
      float* dg = d_s + g * LP;
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

    // ---- 5. ctx[q, hh*Dh + dh] = sum_p wts * taps
    for (int i = tid; i < kQT * HD; i += kThreads) {
      const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
      const float* v = value_b + (size_t)hh * a.S * Dh + dh;
      const int r0 = (q * H + hh) * LP;
      float acc = 0.f;
      for (int p = 0; p < LP; ++p) {
        const int row = r0 + p;
        const float t = wlo_s[row] * v[(size_t)lo_s[row] * Dh]
                        + whi_s[row] * v[(size_t)hi_s[row] * Dh];
        acc = fmaf(d_s[row], t, acc);
      }
      ctx_s[q * ldHD + hd] = acc;
    }
    __syncthreads();

    // ---- 6. z = const_z + emb token_w + h W_hh + ctx ctx_w3, then the LSTM
    //         cell; a thread owns hidden unit r (its 4 gate columns)
    for (int r = tid; r < R; r += kThreads) {
      float z[4][kQT];
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float* cz = a.const_z + ((size_t)b * a.Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = cz[g * R];
      }
      add_gates(emb_s, ldE, E, a.token_w, r, R, z);
      add_gates(h_s, ldR, R, a.w_hh, r, R, z);
      add_gates(ctx_s, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < kQT; ++q) {
        const float c = sigmoidf_(z[1][q]) * c_s[q * ldR + r]
                        + sigmoidf_(z[0][q]) * tanhf(z[2][q]);
        c_s[q * ldR + r] = c;
        hn_s[q * ldR + r] = sigmoidf_(z[3][q]) * tanhf(c);
      }
    }
    __syncthreads();
    { float* t = h_s; h_s = hn_s; hn_s = t; }

    // ---- 7. logits with an online (max, sum-exp, first-max index)
    float m[kQT], s[kQT];
    int ix[kQT];
#pragma unroll
    for (int q = 0; q < kQT; ++q) { m[q] = -INFINITY; s[q] = 0.f; ix[q] = INT_MAX; }
    for (int n0 = tid; n0 < a.V1; n0 += kThreads * kLC) {
      // columns n0, n0 + kThreads, ... in increasing order, so a tie keeps
      // the first index as jnp.argmax does
      float acc[kLC][kQT] = {};
      cols_dot_rows(h_s, ldR, R, a.logit_w, a.V1, n0, acc);
#pragma unroll
      for (int c = 0; c < kLC; ++c) {
        const int n = n0 + c * kThreads;
        if (n >= a.V1) break;
        const float bias = a.logit_b[n];
#pragma unroll
        for (int q = 0; q < kQT; ++q) lse_merge(m[q], s[q], ix[q], acc[c][q] + bias, 1.f, n);
      }
    }
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_down_sync(0xffffffffu, m[q], o);
        const float s2 = __shfl_down_sync(0xffffffffu, s[q], o);
        const int i2 = __shfl_down_sync(0xffffffffu, ix[q], o);
        lse_merge(m[q], s[q], ix[q], m2, s2, i2);
      }
      if (lane == 0) {
        red_s[warp * kRed + 3 * q] = m[q];
        red_s[warp * kRed + 3 * q + 1] = s[q];
        red_s[warp * kRed + 3 * q + 2] = __int_as_float(ix[q]);
      }
    }
    __syncthreads();
    if (tid < kQT) {
      float mm = -INFINITY, ss = 0.f;
      int ii = INT_MAX;
      for (int w = 0; w < kWarps; ++w)
        lse_merge(mm, ss, ii, red_s[w * kRed + 3 * tid], red_s[w * kRed + 3 * tid + 1],
                  __float_as_int(red_s[w * kRed + 3 * tid + 2]));
      tok_s[tid] = ii;
      if (q0 + tid < a.Q) {
        const size_t o = ((size_t)b * a.K + k) * a.Q + q0 + tid;
        const float lse = mm + logf(ss);
        a.tok[o] = ii;
        a.lp[o] = mm - lse;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Shapes as in dsa_greedy_scan_ref (dvc_tpu/ops/dsa_greedy.py); ctx_w3 is
// (H, Dh, 4R) = (H*Dh, 4R) row-major; ab is one float in device memory.
// All f32 and contiguous on the current device; tok (int32) and lp are
// (B, K, Q).  shapes: host array of
// the L level lengths of value's S axis; LP = L * P.  Returns
// cudaGetLastError() of the launch, or cudaErrorInvalidValue for shapes
// the kernel does not take.
extern "C" int dvc_dsa_greedy(
    const float* value_t, const float* base_pos, const float* scale_t,
    const float* const_z, const float* embed, const float* token_w,
    const float* logit_w, const float* logit_b, const float* off_w_h,
    const float* h2att_w, const float* h2att_b, const float* cw,
    const float* cb, const float* aw, const float* ctx_w3, const float* w_hh,
    const float* ab, const int* shapes, int* tok, float* lp, int B, int H, int S,
    int Dh, int Q, int LP, int L, int A, int R, int E, int V1, int K,
    void* stream) {
  if (L < 1 || L > kMaxLevels || LP % L != 0) return (int)cudaErrorInvalidValue;
  GreedyArgs a;
  a.value = value_t; a.base_pos = base_pos; a.scale = scale_t;
  a.const_z = const_z; a.embed = embed; a.token_w = token_w;
  a.logit_w = logit_w; a.logit_b = logit_b; a.off_w = off_w_h;
  a.h2att_w = h2att_w; a.h2att_b = h2att_b; a.cw = cw; a.cb = cb; a.aw = aw;
  a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab; a.tok = tok; a.lp = lp;
  a.B = B; a.H = H; a.S = S; a.Dh = Dh; a.Q = Q; a.LP = LP; a.P = LP / L;
  a.A = A; a.R = R; a.E = E; a.V1 = V1; a.K = K;
  a.lv.n = L;
  int acc = 0;
  for (int l = 0; l < L; ++l) {
    a.lv.T[l] = shapes[l];
    a.lv.start[l] = acc;
    acc += shapes[l];
  }
  if (acc != S) return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0 || K == 0) return 0;
  const Layout lay(R, A, E, H * Dh, kQT * H * LP);
  const size_t smem = lay.bytes();
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      greedy_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  greedy_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
