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
// first by the 3xTF32 GEMM of dsa_gemm.cuh: VW = value_t Wc (B, H, S, A),
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
//
// K6-bf16 (bf16 != 0, --tpu_compute_dtype bfloat16) is the kernel's bf16
// instantiation (B16) in the bf16-operand mode of dsa_common.cuh: the TPU
// kernel's bf16 variant rounds both operands of hvec, the offsets, the
// taps, taps Wc, the token share, the gates and the logits to bf16 and
// accumulates in f32 (_make_dot('bfloat16')).  The wrapper passes value
// and off_w rounded, the tables come from dsa::gemm's bf16 mode, and h and
// ctx are stored rounded.  The step's three large products run on the
// tensor cores as mma.sync.m16n8k16 from weights that the wrapper packs
// once a launch in bf16 in fragment order (dsa_common.cuh): hvec = h
// W_h2att (attend_hvec_mma), the gates [h | ctx] [W_hh; ctx_w3]
// (gates_fwd_bf16, P^T's half of pack_gate_weights; the cell on the
// accumulators) and the logits h logit_w (logits_bf16: logit_w^T's 1608
// rows padded to 1616, the padded rows never merged, so that none can win
// where every real logit is negative).  The tile's queries are the n side:
// at 16 queries each A fragment feeds two n8 tiles, so a block reads each
// step's weights once, 6.2 MB in bf16 where the f32 mode reads 13 MB
// through the CUDA cores' FMAs.  Shared memory: x = [h | ctx] staged in
// bf16 takes the next h's room (the cell writes h in place; the logits and
// the next step's hvec restage h there), 208,192 bytes at 16 queries, R =
// A = 512 and H=8 (172,352 at H=1).  One rounding point moves with the
// table form: the TPU kernel scores bf16(sum_t bf16(w_t) bf16(v_t)) .
// bf16(Wc), the taps rounded after the lerp; here sum_t bf16(w_t) (bf16(v_t)
// . bf16(Wc)), a lerp of two rows of the bf16 table, so the taps are never
// rounded (the gap is measured by tests/test_torch_bf16_kernels.py and
// chip_smoke.py --bf16).

#include <cuda_runtime.h>
#include <float.h>
#include <limits.h>
#include <math.h>

#include "dsa_common.cuh"

namespace {

using namespace dsa;


struct GreedyArgs {
  AttendArgs at;          // value, base_pos, scale, off_w, h2att, cb, aw
  const float* const_z;   // (B, Q, 4R)
  const float* vw;        // (B, H, S, A) the table value_t Wc
  const float* tw;        // (V1, 4R) the table embed token_w
  const float* logit_w;   // (R, V1)
  const float* logit_b;   // (V1)
  const float* ctx_w3;    // (H*Dh, 4R)
  const float* w_hh;      // (R, 4R)
  const uint4* gpack;     // K6-bf16: P^T = [W_hh; ctx_w3]^T packed in bf16 (GateGeom)
  const uint4* lpack;     // K6-bf16: logit_w^T packed in bf16 (V1p x Rl)
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

// K6-bf16's logits on the tensor cores: the new h (rounded f32 in h)
// staged in bf16 in xb (stage_hidden), then logits^T = logit_w^T h^T from
// the packed logit_w^T (a.lpack: V1 rows padded to 16, R terms to 64;
// hidden_mma); each lane merges the logits (plus the bias) of its rows and
// queries into an online (max, sum-exp, first-max index) a query, the
// padded rows (n >= V1) never merged, so that none can win.  Returns them
// in m, s, ix at the lane's queries (8nt + 2(lane % 4) + {0, 1}), which
// the caller leaves empty (s = 0) at the others, for its merge across the
// lanes and the warps.  One barrier, after the staging.
template <int QT>
__device__ __forceinline__ void logits_bf16(const GreedyArgs& a, const GateGeom& gg,
                                            const float* h, int ldR, __nv_bfloat16* xb,
                                            float (&m)[QT], float (&s)[QT], int (&ix)[QT]) {
  constexpr int NT = (QT + 7) / 8;
  const HiddenGeom hg(gg.R, a.V1);
  const int q = threadIdx.x & 3;
  stage_hidden<QT>(h, ldR, gg.R, hg.Rl, xb, gg.ldx);
  __syncthreads();
  float mm[NT][2], ss[NT][2];
  int ii[NT][2];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int j = 0; j < 2; ++j) { mm[nt][j] = -INFINITY; ss[nt][j] = 0.f; ii[nt][j] = INT_MAX; }
  // rows in increasing order within a lane; lse_merge keeps the first
  // index of a tie in any order
  hidden_mma<QT>(a.lpack, hg, xb, gg.ldx, [&](int n, int nt, int j, float v) {
    lse_merge(mm[nt][j], ss[nt][j], ii[nt][j], v + __ldg(a.logit_b + n), 1.f, n);
  });
#pragma unroll
  for (int qq = 0; qq < QT; ++qq)
    if ((qq % 8) / 2 == q) {
      m[qq] = mm[qq / 8][qq % 2];
      s[qq] = ss[qq / 8][qq % 2];
      ix[qq] = ii[qq / 8][qq % 2];
    }
}

// shared-memory layout (floats, then ints), shared by host and device; every
// row of a (rows, len) region starts 16-byte aligned (stride pad4(len)); in
// the bf16 mode (b16) the next h's room holds the staged x = [h | ctx] in
// bf16 instead (QT rows of GateGeom::ldx), since the cell writes the new h
// in place, and then the new h for the logits
struct Layout {
  int h, hn, c, hvec, ctx, wlo, whi, d, red;  // float offsets
  int lo, hi, tok;                            // int offsets
  int floats, ints;
  __host__ __device__ Layout(int QT, int R, int A, int HD, int NR, bool b16) {
    int o = 0;
    h = o;    o += QT * pad4(R);
    hn = o;   o += b16 ? pad4(QT * GateGeom(R, HD).ldx / 2) : QT * pad4(R);
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

// B16: K6-bf16's instantiation (the bf16-operand mode with its products on
// the tensor cores); the f32 one compiles none of that in.  One block an
// SM, as its shared memory allows: without that minimum ptxas gives the
// bf16 instantiations 40-64 registers, too few to keep the mma loops' A
// fragments in flight (1.4x slower at B = 1)
template <int QT, bool B16>
__global__ void __launch_bounds__(kThreads, 1) greedy_kernel(GreedyArgs a) {
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
  const Layout L(QT, R, A, HD, NR, B16);
  const GateGeom gg(R, HD);
  float* hn_s = smem + L.hn;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(hn_s);  // the bf16 mode's x
  float* c_s = smem + L.c;
  float* red_s = smem + L.red;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  int* tok_s = ints + L.tok;
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;

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
    // ---- 1-2. hvec (K6-bf16: on the tensor cores) and the tap table
    if (B16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);
    attend_hvec_taps<QT>(at, sm, b, q0);
    __syncthreads();
    // ---- 3-5. scores from the table, softmax over the LP taps, ctx
    attend_scores_table<QT>(at, sm, vw_b, ab);
    attend_softmax_ctx<QT>(at, sm, value_b);

    // ---- 6. z = const_z + TW[tok] + h W_hh + ctx ctx_w3, then the LSTM
    //         cell; a thread owns hidden unit r (its 4 gate columns).
    //         K6-bf16: the products on the tensor cores and the cell on
    //         their accumulators (gates_fwd_bf16), the new h in place
    if (B16)
      gates_fwd_bf16<QT>(
          a.gpack, gg, sm.h, ldR, sm.ctx, ldHD, xb,
          [&](int qi, int u, int gate) {
            const int qq = min(q0 + qi, at.Q - 1);
            return a.const_z[((size_t)b * at.Q + qq) * R4 + gate * R + u]
                   + a.tw[(size_t)tok_s[qi] * R4 + gate * R + u];
          },
          [&](int qi, int u) { return c_s[qi * ldR + u]; },
          [&](int qi, int u, float h, float c) {
            c_s[qi * ldR + u] = c;
            sm.h[qi * ldR + u] = round_if(true, h);
          });
    for (int r = tid; !B16 && r < R; r += kThreads) {
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
        hn_s[q * ldR + r] = round_if(at.bf16, sigmoidf_(z[3][q]) * tanhf(c));
      }
    }
    __syncthreads();
    if (!B16) { float* t = sm.h; sm.h = hn_s; hn_s = t; }

    // ---- 7. logits with an online (max, sum-exp, first-max index)
    //         (K6-bf16: on the tensor cores, logits_bf16)
    float m[QT], s[QT];
    int ix[QT];
#pragma unroll
    for (int q = 0; q < QT; ++q) { m[q] = -INFINITY; s[q] = 0.f; ix[q] = INT_MAX; }
    if (B16) logits_bf16<QT>(a, gg, sm.h, ldR, xb, m, s, ix);
    for (int n0 = tid; !B16 && n0 < a.V1; n0 += kThreads * LC) {
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

// the decode kernel of query tile QT (2, 4, 8 or 16) in the mode b16
static void (*greedy_variant(int QT, bool b16))(GreedyArgs) {
  if (b16)
    return QT == 2 ? greedy_kernel<2, true> : QT == 4 ? greedy_kernel<4, true>
           : QT == 16 ? greedy_kernel<16, true> : greedy_kernel<kQT, true>;
  return QT == 2 ? greedy_kernel<2, false> : QT == 4 ? greedy_kernel<4, false>
         : QT == 16 ? greedy_kernel<16, false> : greedy_kernel<kQT, false>;
}

}  // namespace

// Shapes as in dsa_greedy_scan_ref (dvc_tpu/ops/dsa_greedy.py); ctx_w3 is
// (H, Dh, 4R) = (H*Dh, 4R) row-major; ab is one float in device memory.
// All f32 and contiguous on the current device; tok (int32) and lp are
// (B, K, Q).  Scratch: vw (B, H, S, A) and tw (V1, 4R), the tables built
// here first, and work (work_floats floats) for their split-K partial tiles
// (see dsa::gemm_as).  shapes: host array of the L level lengths of value's S
// axis; LP = L * P.  bf16: K6-bf16, with value_t and off_w_h given
// rounded to bf16, value16 and cw in bf16 (torch.bfloat16) for the table
// value . Wc (the table embed . token_w rounds its f32 operands in the
// GEMM's producer), gpack the packed P^T (pack_gate_weights' first half),
// lpack the packed logit_w^T and hpack the packed h2att_w^T
// (pack_hidden_weights), each 16-byte aligned; ctx_w3, w_hh, logit_w and
// h2att_w are then unread.  Else value16 and the packs are unused and cw
// f32.  Returns cudaGetLastError() of the launches, or
// cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int dvc_dsa_greedy(
    const float* value_t, const void* value16, const float* base_pos, const float* scale_t,
    const float* const_z, const float* embed, const float* token_w,
    const float* logit_w, const float* logit_b, const float* off_w_h,
    const float* h2att_w, const float* h2att_b, const void* cw,
    const float* cb, const float* aw, const float* ctx_w3, const float* w_hh,
    const void* gpack, const void* lpack, const void* hpack, const float* ab,
    const int* shapes, int* tok, float* lp, float* vw, float* tw, float* work, int B,
    int H, int S, int Dh, int Q, int LP, int L, int A, int R, int E, int V1, int K,
    int work_floats, int bf16, void* stream) {
  GreedyArgs a;
  AttendArgs& at = a.at;
  if (!fill_attend(&at, value_t, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  at.base_pos = base_pos; at.scale = scale_t;
  at.off_w = off_w_h; at.h2att_w = h2att_w; at.h2att_b = h2att_b;
  at.bf16 = bf16 != 0;
  if (at.bf16 && !(packed_operand(gpack) && packed_operand(lpack) && packed_operand(hpack)))
    return (int)cudaErrorInvalidValue;
  if (at.bf16) at.h2att_pack = static_cast<const uint4*>(hpack);
  a.const_z = const_z; a.vw = vw; a.tw = tw;
  a.logit_w = logit_w; a.logit_b = logit_b;
  a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab; a.tok = tok; a.lp = lp;
  a.gpack = static_cast<const uint4*>(gpack);
  a.lpack = static_cast<const uint4*>(lpack);
  a.V1 = V1; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  const int QT = query_tile(B, Q, 2, 16);
  const size_t smem = Layout(QT, R, A, H * Dh, QT * H * LP, at.bf16).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  const auto kernel = greedy_variant(QT, at.bf16);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // the tables, once per launch
  const size_t wf = work_floats > 0 ? (size_t)work_floats : 0;
  if (at.bf16) {
    // value and cw in bf16; embed and token_w f32, rounded by the GEMM's producer
    if ((e = row_table16(op16(value16, Dh), op16(cw, A), B * H * S, Dh, A, vw, st, work,
                         wf)) != cudaSuccess ||
        (e = row_table16(op16(embed, E, true), op16(token_w, 4 * R, true), V1, E, 4 * R, tw,
                         st, work, wf)) != cudaSuccess)
      return (int)e;
  } else if ((e = row_table(value_t, static_cast<const float*>(cw), B * H * S, Dh, A, vw, st,
                            work, wf)) != cudaSuccess ||
             (e = row_table(embed, token_w, V1, E, 4 * R, tw, st, work, wf)) != cudaSuccess) {
    return (int)e;
  }
  const dim3 grid((Q + QT - 1) / QT, B);
  kernel<<<grid, kThreads, smem, st>>>(a);
  return (int)cudaGetLastError();
}
