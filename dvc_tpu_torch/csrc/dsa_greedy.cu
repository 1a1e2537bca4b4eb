// Fused greedy caption decode of the LSTM-DSA head: all K word steps in one
// launch.
//
// Replaces the Pallas TPU kernel `_make_greedy_kernel`
// (dvc_tpu/ops/dsa_greedy.py).  The TPU grid (B, K) runs k in order on one
// core and keeps h, c and the fed-back token in VMEM scratch.  On Hopper the
// queries of a video are independent (they share only value[b] and the
// weights), so here one block owns (b, a tile of QT queries) and loops over
// the K steps itself, with h, c, hvec, ctx, the tap table and the fed-back
// tokens in shared memory.  Each word step:
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
// Two products are hoisted out of the step into per-launch tables, built
// first by the tiled GEMM of dsa_common.cuh: VW = value_t Wc (B, H, S, A),
// since a tap is the lerp of two value rows and so taps Wc is the same lerp
// of two VW rows (attend_scores_table: 2A loads and A tanh per tap row, no
// Dh x A product); and TW = embed token_w (V+1, 4R), so the fed-back
// token's share of z is one gathered row.  Every product is written here
// (no cuBLAS).  The step's weights (W_hh, ctx_w3, logit_w, W_h2att: ~13 MB
// f32 at R = A = 512, V+1 = 1608) are read from global memory, where they
// stay L2-resident; a tile of QT queries shares each weight read.  The
// vocab projection keeps an online (max, sum-exp, first-max index) per
// query, so the (QT, V+1) logits are never stored.
//
// Bound on this card: the products read their activations from shared
// memory and their weights from L2, so they are bound by shared-load issue
// and L2 bandwidth rather than the FP32 peak.  Activations are read as
// float4 (rows padded to 16 bytes), each thread keeps several outputs in
// registers (4 gates x 8 queries in the LSTM product, 4 vocab columns x 8
// queries in the logits).  A block owns 16 queries where 8-query tiles
// would take more than one wave (each weight read then serves twice the
// queries), and 2 or 4 queries on a small grid such as one request's, so
// that its fixed per-step work spreads over more SMs (the host picks, from
// B, Q and the SM count).  Shared memory of a block at R = A = 512: 172,096
// bytes at 16 queries and H=1, 207,936 at H=8; one block per SM (two blocks
// of 8 queries would fit, but their 64 registers a thread spill).
//
// Steps 1-5 (hvec, taps, scores, softmax, ctx) live in dsa_common.cuh,
// shared with the teacher-forcing scan.  The transcendentals are the exact
// tanhf/expf/logf (no fast-math).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#include "dsa_common.cuh"

namespace {

using namespace dsa;


struct GreedyArgs {
  AttendArgs at;          // value, base_pos, scale, off_w, h2att, cw, cb, aw
  const float* const_z;   // (B, Q, 4R)
  const float* vw;        // (B, H, S, A) the table value_t Wc
  const float* tw;        // (V1, 4R) the table embed token_w
  const float* logit_w;   // (R, V1)
  const float* logit_b;   // (V1)
  const float* ctx_w3;    // (H*Dh, 4R)
  const float* w_hh;      // (R, 4R)
  const float* ab;        // (1): read on the card, so the host never waits
  int* tok;               // (B, K, Q)
  float* lp;              // (B, K, Q)
  int V1, K;
};

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

// acc[c][q] += sum_{j < len} x[q*ld + j] * W[j*stride + n_c] for the LC
// columns n_c = n0 + c*kThreads (clamped to the last column; the caller
// drops the ones past it) and the QT rows of x in shared memory
template <int QT, int LC>
__device__ __forceinline__ void cols_dot_rows(const float* x, int ld, int len,
                                              const float* __restrict__ W,
                                              int stride, int n0,
                                              float (&acc)[LC][QT]) {
  int n[LC];
#pragma unroll
  for (int c = 0; c < LC; ++c) n[c] = min(n0 + c * kThreads, stride - 1);
  const int len4 = len & ~3;
  for (int j = 0; j < len4; j += 4) {
    float w[LC][4];
#pragma unroll
    for (int c = 0; c < LC; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) w[c][u] = W[(size_t)(j + u) * stride + n[c]];
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const float4 v = ld4(x + q * ld + j);
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        acc[c][q] = fmaf(v.x, w[c][0], acc[c][q]);
        acc[c][q] = fmaf(v.y, w[c][1], acc[c][q]);
        acc[c][q] = fmaf(v.z, w[c][2], acc[c][q]);
        acc[c][q] = fmaf(v.w, w[c][3], acc[c][q]);
      }
    }
  }
  for (int j = len4; j < len; ++j) {
#pragma unroll
    for (int c = 0; c < LC; ++c) {
      const float wj = W[(size_t)j * stride + n[c]];
#pragma unroll
      for (int q = 0; q < QT; ++q) acc[c][q] = fmaf(x[q * ld + j], wj, acc[c][q]);
    }
  }
}

// shared-memory layout (floats, then ints), shared by host and device; every
// row of a (rows, len) region starts 16-byte aligned (stride pad4(len))
struct Layout {
  int h, hn, c, hvec, ctx, wlo, whi, d, red;  // float offsets
  int lo, hi, tok;                            // int offsets
  int floats, ints;
  __host__ __device__ Layout(int QT, int R, int A, int HD, int NR) {
    int o = 0;
    h = o;    o += QT * pad4(R);
    hn = o;   o += QT * pad4(R);
    c = o;    o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    ctx = o;  o += QT * pad4(HD);
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    red = o;  o += kWarps * 3 * QT;
    floats = o;
    int j = 0;
    lo = j;  j += NR;
    hi = j;  j += NR;
    tok = j; j += QT;
    ints = j;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

template <int QT>
__global__ void __launch_bounds__(kThreads) greedy_kernel(GreedyArgs a) {
  constexpr int LC = QT >= 4 ? 32 / QT : 8;  // vocab columns per thread per pass
  constexpr int kR3 = 3 * QT;   // per-warp floats of the logits reduction
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh;
  const int HD = H * Dh, R4 = 4 * R, NR = QT * H * at.LP;
  const int ldR = pad4(R), ldHD = pad4(HD);
  const Layout L(QT, R, A, HD, NR);
  float* hn_s = smem + L.hn;
  float* c_s = smem + L.c;
  float* red_s = smem + L.red;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  int* tok_s = ints + L.tok;
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.red = red_s; sm.lo = ints + L.lo; sm.hi = ints + L.hi;

  // queries past the end of the ragged last tile compute on a copy of the
  // last query and write nothing
  int qg[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) qg[q] = min(q0 + q, at.Q - 1);

  // zero h and c, padding included (the float4 reads never use it)
  for (int i = tid; i < QT * ldR; i += kThreads) { sm.h[i] = 0.f; c_s[i] = 0.f; }
  if (tid < QT) tok_s[tid] = 0;  // BOS
  __syncthreads();

  const float* value_b = at.value + (size_t)b * H * at.S * Dh;
  const float* vw_b = a.vw + (size_t)b * H * at.S * A;
  const float ab = __ldg(a.ab);

  for (int k = 0; k < a.K; ++k) {
    // ---- 1-2. hvec and the tap table
    attend_hvec_taps<QT>(at, sm, b, q0);
    __syncthreads();
    // ---- 3-5. scores from the table, softmax over the LP taps, ctx
    attend_scores_table<QT>(at, sm, vw_b, ab);
    attend_softmax_ctx<QT>(at, sm, value_b);

    // ---- 6. z = const_z + TW[tok] + h W_hh + ctx ctx_w3, then the LSTM
    //         cell; a thread owns hidden unit r (its 4 gate columns)
    for (int r = tid; r < R; r += kThreads) {
      float z[4][QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float* cz = a.const_z + ((size_t)b * at.Q + qg[q]) * R4 + r;
        const float* tw = a.tw + (size_t)tok_s[q] * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = cz[g * R] + tw[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float c = sigmoidf_(z[1][q]) * c_s[q * ldR + r]
                        + sigmoidf_(z[0][q]) * tanhf(z[2][q]);
        c_s[q * ldR + r] = c;
        hn_s[q * ldR + r] = sigmoidf_(z[3][q]) * tanhf(c);
      }
    }
    __syncthreads();
    { float* t = sm.h; sm.h = hn_s; hn_s = t; }

    // ---- 7. logits with an online (max, sum-exp, first-max index)
    float m[QT], s[QT];
    int ix[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) { m[q] = -INFINITY; s[q] = 0.f; ix[q] = INT_MAX; }
    for (int n0 = tid; n0 < a.V1; n0 += kThreads * LC) {
      // columns n0, n0 + kThreads, ... in increasing order, so a tie keeps
      // the first index as jnp.argmax does
      float acc[LC][QT] = {};
      cols_dot_rows<QT, LC>(sm.h, ldR, R, a.logit_w, a.V1, n0, acc);
#pragma unroll
      for (int c = 0; c < LC; ++c) {
        const int n = n0 + c * kThreads;
        if (n >= a.V1) break;
        const float bias = a.logit_b[n];
#pragma unroll
        for (int q = 0; q < QT; ++q) lse_merge(m[q], s[q], ix[q], acc[c][q] + bias, 1.f, n);
      }
    }
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      for (int o = 16; o > 0; o >>= 1) {
        const float m2 = __shfl_down_sync(0xffffffffu, m[q], o);
        const float s2 = __shfl_down_sync(0xffffffffu, s[q], o);
        const int i2 = __shfl_down_sync(0xffffffffu, ix[q], o);
        lse_merge(m[q], s[q], ix[q], m2, s2, i2);
      }
      if (lane == 0) {
        red_s[warp * kR3 + 3 * q] = m[q];
        red_s[warp * kR3 + 3 * q + 1] = s[q];
        red_s[warp * kR3 + 3 * q + 2] = __int_as_float(ix[q]);
      }
    }
    __syncthreads();
    if (tid < QT) {
      float mm = -INFINITY, ss = 0.f;
      int ii = INT_MAX;
      for (int w = 0; w < kWarps; ++w)
        lse_merge(mm, ss, ii, red_s[w * kR3 + 3 * tid], red_s[w * kR3 + 3 * tid + 1],
                  __float_as_int(red_s[w * kR3 + 3 * tid + 2]));
      tok_s[tid] = ii;
      if (q0 + tid < at.Q) {
        const size_t o = ((size_t)b * a.K + k) * at.Q + q0 + tid;
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
// (B, K, Q).  Scratch: vw (B, H, S, A) and tw (V1, 4R), the tables built
// here first.  shapes: host array of the L level lengths of value's S
// axis; LP = L * P.  Returns cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int dvc_dsa_greedy(
    const float* value_t, const float* base_pos, const float* scale_t,
    const float* const_z, const float* embed, const float* token_w,
    const float* logit_w, const float* logit_b, const float* off_w_h,
    const float* h2att_w, const float* h2att_b, const float* cw,
    const float* cb, const float* aw, const float* ctx_w3, const float* w_hh,
    const float* ab, const int* shapes, int* tok, float* lp, float* vw,
    float* tw, int B, int H, int S, int Dh, int Q, int LP, int L, int A, int R,
    int E, int V1, int K, void* stream) {
  GreedyArgs a;
  AttendArgs& at = a.at;
  if (!fill_attend(&at, value_t, cw, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  at.base_pos = base_pos; at.scale = scale_t;
  at.off_w = off_w_h; at.h2att_w = h2att_w; at.h2att_b = h2att_b;
  a.const_z = const_z; a.vw = vw; a.tw = tw;
  a.logit_w = logit_w; a.logit_b = logit_b;
  a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab; a.tok = tok; a.lp = lp;
  a.V1 = V1; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  // the query tile: 16 queries where 8-query tiles would not fit on the
  // card in one wave (the weights' L2 reads per query halve); on a small
  // grid (a single request) the smallest tile of 2 or 4 queries whose grid
  // still fits half the SMs, so that more SMs share the decode's fixed work
  // per step
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  int QT = (size_t)B * ((Q + kQT - 1) / kQT) > (size_t)sms ? 16 : kQT;
  for (int qt : {2, 4})
    if (QT == kQT && 2 * (size_t)B * ((Q + qt - 1) / qt) <= (size_t)sms) QT = qt;
  const size_t smem = Layout(QT, R, A, H * Dh, QT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 2 ? set_smem(greedy_kernel<2>, smem)
                  : QT == 4 ? set_smem(greedy_kernel<4>, smem)
                  : QT == 16 ? set_smem(greedy_kernel<16>, smem)
                             : set_smem(greedy_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  // the tables, once per launch
  if ((e = row_table(value_t, cw, B * H * S, Dh, A, vw, st)) != cudaSuccess ||
      (e = row_table(embed, token_w, V1, E, 4 * R, tw, st)) != cudaSuccess)
    return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 2)
    greedy_kernel<2><<<grid, kThreads, smem, st>>>(a);
  else if (QT == 4)
    greedy_kernel<4><<<grid, kThreads, smem, st>>>(a);
  else if (QT == 16)
    greedy_kernel<16><<<grid, kThreads, smem, st>>>(a);
  else
    greedy_kernel<kQT><<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
