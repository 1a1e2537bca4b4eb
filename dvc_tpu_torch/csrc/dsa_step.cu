// One word step of the LSTM-DSA caption head, for the stepwise caption path
// (scheduled sampling, --dsa_scan_fuse 0, --dsa_greedy_fuse 0): four kernels,
// each one launch per word step.
//
//   K7 step_fwd_kernel  replaces `_make_fwd_kernel` (dvc_tpu/ops/dsa_step.py):
//       border-mode taps of value_t at the given level-relative positions
//       pos, additive attention with the given hvec = h W_h2att + b,
//       ctx = sum_p wts * taps                                  (B, H, Q, Dh)
//   K8 step_bwd_kernel  replaces `_make_bwd_kernel`: K7's seven gradients
//       (dvalue, dpos, dhvec, dWc, dcb, d alpha_w, d alpha_b) for d ctx
//   K9 lstm_fwd_kernel  replaces `_make_lstm_fwd_kernel`: K7, then
//       z = z0 + h W_hh + ctx ctx_w3 and the bias-free LSTM cell -> (h', c')
//   K10 lstm_bwd_kernel replaces `_make_lstm_bwd_kernel`: K9's twelve
//       gradients for the cotangents (gh, gc) of (h', c')
//
// The offsets -> pos chain and h2att stay outside, under autograd, as in the
// JAX package.  The TPU kernels' grid runs over B alone with all Q queries in
// one VMEM block; here a block owns (video b, a tile of queries).  The
// attention phases are those of the fused scan and greedy kernels
// (dsa_common.cuh), entered through attend_given.
//
// All four score from the per-video table VW = value_t Wc (B, H, S, A),
// an operand: a tap is a lerp of two value rows, so taps . Wc is the same
// lerp of two VW rows (attend_scores_table: 2A loads and A tanh per tap
// row, no Dh x A product).  VW does not change across the word steps of one
// forward pass, so the caller builds it once per pass (dvc_dsa_table_gemm,
// dsa_tables.cu) and its backward, G . Wc^T into dvalue and dWc = value^T G
// (dvc_dsa_table_gemm_bwd), runs once per backward pass on G summed over
// the steps.  K7 is K9 without the gates and the cell: attend_given, the
// scores from VW with float4 lanes (attend_scores_table4), then
// attend_softmax_ctx.  K9 is one step of the scan forward K4
// (attend_scores_table, attend_softmax_ctx, then add_gates and the cell)
// with the given pos and hvec; K8 and K10 one reverse step of the scan backward K5 with the
// incoming d ctx (K8) or (dh, dc) (K10) given: the recompute from VW
// (cell_bwd and gates_backprop_rows in K10), attend_backward_table (du
// formed once per (query, column part) from VW, dpos written directly);
// they write G = dL/dVW and only the context's term of dvalue.  The host
// picks their query tile from B, Q and the SM count (query_tile): K7 2 or 4
// (it has no weight product for a larger tile to share, so more blocks and
// more warps in flight hide more of its L2 latency), K9 as K4 (4 queries
// on a small grid such as a B = 1 step's, 16 where 8-query tiles would take
// more than a wave), K8 and K10 as K5 (2 or 4 on a small grid, else 8).
//
// On the TPU the weight gradients accumulate in revisited blocks over the
// sequential grid; here blocks run in parallel, so (as in K5) dvalue and G,
// the lerp-weighted scatter of du onto the value rows, take float4 atomics;
// dW_hh = h^T dz and dctx_w3 = ctx^T dz (K10) are reduced by the GEMM's
// outer_sum (dsa_gemm.cuh), and dcb, d alpha_w, d alpha_b are per-lane
// partial sums added with atomics.
//
// Bound on this card: K7 and K8 the bytes of VW and value (B*H*S*A and
// B*H*S*Dh floats, 12 MB each at B = 16, H = 1) and the scores' 2A loads
// and A tanh per tap row from L2; K9 and K10 f32 operations, h W_hh and
// ctx ctx_w3, 4R*(R + H*Dh) per query, with their transposes in K10: as in
// the scan kernels the gate products read activations from shared memory
// and weights (8 MB at R = 512) from L2 once per query tile, so L2
// bandwidth and the FP32 issue rate bound them.
// K7-K10-bf16 (bf16 != 0, --tpu_compute_dtype bfloat16 on the stepwise
// path) are the same kernels in the bf16-operand mode of dsa_common.cuh: the
// TPU kernels' bf16 variants round both operands of every in-kernel product
// to bf16 and accumulate in f32 (_make_dot('bfloat16')): the taps M . value
// (M's lerp weights rounded), the scores taps . Wc, in K9 h . W_hh and
// ctx . ctx_w3, and in K8 and K10 every transposed product and weight
// gradient's outer sum.  Here the caller passes value_t, ctx_w3 and w_hh
// rounded (once per forward pass, not per step) and VW from the table
// GEMM's bf16 mode; the kernels store rounded the lerp weights, h (load_h),
// the ctx that K9 and K10 multiply, dz, and the scattered wts * dctx and du;
// the outer sums h^T dz and ctx^T dz run in the GEMM's bf16 mode.  Where the
// word steps differ from the scan K4/K5-bf16: hvec, the offsets and ctx .
// ctx_w (around K7) are f32 products outside the kernel in JAX too, so K7
// writes ctx unrounded (ctx_f32) and K8 and K10 write dhvec and dpos
// unrounded (hvec_given).  The table form moves rounding points as in K4-K6
// (dsa_scan.cu): the taps are never rounded before their product with Wc,
// and dvalue's scores term and dWc come from bf16(G) in the table's
// backward (measured in tests/test_torch_bf16_step.py and chip_smoke.py
// --bf16).
//
// Limits of K7-K10: A <= 512 (two float4 column groups per lane and column
// part in the backwards), A and Dh multiples of 4 (K9, K10 also R), and the
// shared memory of a block (checked at launch: K10's staged dz, QT x 4R
// floats, takes most of it).

#include <cuda_runtime.h>
#include <math.h>

#include <initializer_list>

#include "dsa_common.cuh"

namespace {

using namespace dsa;

struct StepArgs {
  AttendArgs at;        // value, cb, aw and the shapes
  const float* pos;     // (B, H, Q, LP) level-relative positions
  const float* hvec;    // (B, Q, A)
  const float* ab;      // (1): read on the card, so the host never waits
  const float* z0;      // (B, Q, 4R)   K9/K10
  const float* h;       // (B, Q, R)
  const float* c;       // (B, Q, R)
  const float* ctx_w3;  // (H*Dh, 4R)
  const float* w_hh;    // (R, 4R)
};

struct StepGrads {
  const float* g;   // (B, H, Q, Dh) cotangent of ctx            K8
  const float* gh;  // (B, Q, R) cotangents of h', c'             K10
  const float* gc;
  float* dvalue;    // (B, H, S, Dh) zeroed; atomics
  float* G;         // (B, H, S, A)  zeroed; atomics
  float* dpos;      // (B, H, Q, LP)
  float* dhvec;     // (B, Q, A)
  float* dcb;       // (A) zeroed; atomics
  float* daw;       // (A) zeroed; atomics
  float* dab;       // (1) zeroed; atomics
  float* dz0;       // (B, Q, 4R)                                 K10
  float* dh;        // (B, Q, R)
  float* dc;        // (B, Q, R)
  float* ctx_all;   // (B, Q, H*Dh) rows for dctx_w3
};

// the tile's hidden states h (B, Q, R) into sm.h, rounded to bf16 in the
// bf16 mode (an operand of h . W_hh only); a query past Q reads the last
// one.  No barrier.
template <int QT>
__device__ __forceinline__ void load_h(const StepArgs& a, const AttendSmem& sm,
                                       int b, int q0) {
  const int R = a.at.R, Q = a.at.Q, ldR = pad4(R);
  for (int i = threadIdx.x; i < QT * R; i += kThreads) {
    const int q = i / R, r = i % R;
    sm.h[q * ldR + r] =
        round_if(a.at.bf16, a.h[((size_t)b * Q + min(q0 + q, Q - 1)) * R + r]);
  }
}

// z[g][q] = z0 + h W_hh + ctx ctx_w3 for hidden unit r's 4 gates (K4's
// products), from h and ctx in shared memory
template <int QT>
__device__ __forceinline__ void gate_preact(const StepArgs& a, const float* h,
                                            const float* ctx, int b, int q0,
                                            int r, float (&z)[4][QT]) {
  const int R = a.at.R, Q = a.at.Q, HD = a.at.H * a.at.Dh;
#pragma unroll
  for (int q = 0; q < QT; ++q) {
    const float* zq = a.z0 + ((size_t)b * Q + min(q0 + q, Q - 1)) * 4 * R + r;
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g][q] = zq[g * R];
  }
  add_gates<QT>(h, pad4(R), R, a.w_hh, r, R, z);
  add_gates<QT>(ctx, pad4(HD), HD, a.ctx_w3, r, R, z);
}

// after attend_backward_table (K8, K10): the tile's dpos and dhvec rows,
// the lane's column sums of dcb and d alpha_w and the block's d alpha_b
template <int QT>
__device__ __forceinline__ void store_table_grads(
    const AttendArgs& at, const TableGradSmem& gs, const ColGroups& cols,
    const float4 (&dcb)[kColGroups], const float4 (&daw)[kColGroups], int b,
    int q0, const StepGrads& o) {
  const int tid = threadIdx.x, H = at.H, LP = at.LP, Q = at.Q, A = at.A;
  const int HLP = H * LP, NR = QT * HLP, ldA = pad4(A);
  for (int row = tid; row < NR; row += kThreads) {
    const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
    if (q0 + q < Q) o.dpos[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] = gs.dpos[row];
  }
  for (int i = tid; i < QT * A; i += kThreads) {
    const int q = i / A, col = i % A;
    if (q0 + q < Q) o.dhvec[((size_t)b * Q + q0 + q) * A + col] = gs.dhvec[q * ldA + col];
  }
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    if (!cols.ok[j]) continue;
    atomic_add4(o.dcb + cols.c[j], dcb[j]);
    atomic_add4(o.daw + cols.c[j], daw[j]);
  }
  if (tid == 0) atomicAdd(o.dab, gs.dab[0]);
}

// ----------------------------------------------------------------------------
// forwards
// ----------------------------------------------------------------------------

// shared memory of K7 and K9: h (K9; R = 0 for K7), hvec and ctx of the
// tile (QT rows each) and its tap table
struct ForwardLayout {
  int h, hvec, ctx, wlo, whi, d;  // float offsets
  int lo, hi;                     // int offsets
  int floats, ints;
  __host__ __device__ ForwardLayout(int QT, int R, int A, int HD, int NR) {
    int o = 0;
    h = o;    o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    ctx = o;  o += QT * pad4(HD);
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

// K7: the attention of one word step from the given pos and hvec, with the
// scores from the table VW = value . Wc (K9 without the gates and the cell)
template <int QT>
__global__ void __launch_bounds__(kThreads)
step_fwd_kernel(StepArgs a, const float* __restrict__ vw, float* __restrict__ ctx_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, HD = H * Dh, ldHD = pad4(HD);
  const ForwardLayout L(QT, 0, at.A, HD, QT * H * at.LP);
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = vw + (size_t)b * H * S * at.A;

  attend_given<QT>(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores_table4<QT>(at, sm, vw_b, __ldg(a.ab));
  attend_softmax_ctx<QT>(at, sm, value_b);
  // the tile's ctx rows
  for (int i = tid; i < QT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
    if (q0 + q < Q)
      ctx_out[(((size_t)b * H + hh) * Q + q0 + q) * Dh + dh] = sm.ctx[q * ldHD + hd];
  }
}

// K9: one step of the scan forward (K4) from the given pos and hvec, with
// the scores from the table VW = value . Wc
template <int QT>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(StepArgs a, const float* __restrict__ vw, float* __restrict__ h_out,
                float* __restrict__ c_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, R = at.R, S = at.S;
  const ForwardLayout L(QT, R, at.A, H * Dh, QT * H * at.LP);
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = vw + (size_t)b * H * S * at.A;

  load_h<QT>(a, sm, b, q0);
  attend_given<QT>(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));
  attend_softmax_ctx<QT>(at, sm, value_b);

  // a thread owns hidden unit r (its 4 gate columns), as in K4
  for (int r = tid; r < R; r += kThreads) {
    float z[4][QT];
    gate_preact<QT>(a, sm.h, sm.ctx, b, q0, r, z);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      if (q0 + q >= Q) continue;
      const size_t o = ((size_t)b * Q + q0 + q) * R + r;
      const float c = sigmoidf_(z[1][q]) * a.c[o] + sigmoidf_(z[0][q]) * tanhf(z[2][q]);
      h_out[o] = sigmoidf_(z[3][q]) * tanhf(c);
      c_out[o] = c;
    }
  }
}

// ----------------------------------------------------------------------------
// backwards
// ----------------------------------------------------------------------------

// shared memory of K8: hvec, dhvec and dctx of the tile (QT rows each), its
// tap table, the softmax weights, d wts and dpos
struct TableBwdLayout {
  int hvec, dhvec, dctx, wlo, whi, d, ddot, dpos, dab;  // float offsets
  int lo, hi;                                          // int offsets
  int floats, ints;
  __host__ __device__ TableBwdLayout(int QT, int A, int HD, int NR) {
    int o = 0;
    hvec = o;  o += QT * pad4(A);
    dhvec = o; o += QT * pad4(A);
    dctx = o;  o += QT * pad4(HD);
    wlo = o;   o += pad4(NR);
    whi = o;   o += pad4(NR);
    d = o;     o += pad4(NR);
    ddot = o;  o += pad4(NR);
    dpos = o;  o += pad4(NR);
    dab = o;   o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

// K8: one reverse step of the scan backward (K5) from the given pos and
// hvec, with the scores and du from the table VW = value . Wc
template <int QT>
__global__ void __launch_bounds__(kThreads)
step_bwd_kernel(StepArgs a, StepGrads o, const float* __restrict__ vw) {
  static_assert(kWarps % QT == 0, "warps per query");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, LP = at.LP;
  const int HD = H * Dh, NR = QT * H * LP, ldHD = pad4(HD);
  const TableBwdLayout L(QT, A, HD, NR);
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.hvec = smem + L.hvec; sm.wlo = smem + L.wlo; sm.whi = smem + L.whi;
  sm.d = smem + L.d; sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  TableGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = smem + L.dhvec; gs.ddot = smem + L.ddot;
  gs.dpos = smem + L.dpos; gs.dab = smem + L.dab;
  const ColGroups cols(A, kWarps / QT);
  float4 dcb[kColGroups], daw[kColGroups];
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) { dcb[j] = f4(0.f); daw[j] = f4(0.f); }
  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = vw + (size_t)b * H * S * A;

  if (tid == 0) gs.dab[0] = 0.f;
  attend_given<QT>(at, sm, b, q0, a.pos, a.hvec);
  // d ctx of the tile; a query past Q gets a zero cotangent, so every
  // gradient it adds is exactly 0
  for (int i = tid; i < QT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
    gs.dctx[q * ldHD + hd] =
        q0 + q < Q ? o.g[(((size_t)b * H + hh) * Q + q0 + q) * Dh + dh] : 0.f;
  }
  __syncthreads();
  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));
  attend_softmax<QT>(at, sm);
  attend_backward_table<QT>(at, sm, gs, value_b, vw_b, o.dvalue + (size_t)b * H * S * Dh,
                            o.G + (size_t)b * H * S * A, cols, dcb, daw);
  store_table_grads<QT>(at, gs, cols, dcb, daw, b, q0, o);
}

// shared memory of K10: h, hvec, ctx (then dhvec) and dctx of the tile (QT
// rows each), its staged dz (QT, 4R), tap table, softmax weights, d wts and
// dpos
struct LstmBwdLayout {
  int h, hvec, cx, dctx, dz, wlo, whi, d, ddot, dpos, dab;  // float offsets
  int lo, hi;                                              // int offsets
  int floats, ints;
  __host__ __device__ LstmBwdLayout(int QT, int R, int A, int HD, int NR) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    int o = 0;
    h = o;    o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    cx = o;   o += QT * CX;
    dctx = o; o += QT * pad4(HD);
    dz = o;   o += QT * 4 * R;
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    ddot = o; o += pad4(NR);
    dpos = o; o += pad4(NR);
    dab = o;  o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

// K10: one reverse step of the scan backward (K5) with the given pos, hvec
// and incoming (gh, gc), with the scores and du from the table VW
template <int QT>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(StepArgs a, StepGrads o, const float* __restrict__ vw) {
  static_assert(kWarps % QT == 0, "warps per query");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, R = at.R;
  const int HD = H * Dh, R4 = 4 * R, ldHD = pad4(HD);
  const LstmBwdLayout L(QT, R, A, HD, QT * H * at.LP);
  float* cx_s = smem + L.cx;
  float* dz_s = smem + L.dz;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = cx_s;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  TableGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = cx_s; gs.ddot = smem + L.ddot;
  gs.dpos = smem + L.dpos; gs.dab = smem + L.dab;
  const ColGroups cols(A, kWarps / QT);
  float4 dcb[kColGroups], daw[kColGroups];
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) { dcb[j] = f4(0.f); daw[j] = f4(0.f); }
  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = vw + (size_t)b * H * S * A;

  // ---- recompute the step: attention from the table, ctx (rows kept for
  //      dctx_w3)
  if (tid == 0) gs.dab[0] = 0.f;
  load_h<QT>(a, sm, b, q0);
  attend_given<QT>(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores_table<QT>(at, sm, vw_b, __ldg(a.ab));
  attend_softmax_ctx<QT>(at, sm, value_b);
  for (int i = tid; i < QT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD;
    if (q0 + q < Q) o.ctx_all[((size_t)b * Q + q0 + q) * HD + hd] = cx_s[q * ldHD + hd];
  }

  // ---- gates and the LSTM cell backward with the given (gh, gc): a query
  //      past Q gets zero cotangents, so its dz (hence its d ctx and every
  //      gradient it adds) is exactly 0; dz is written out and staged as
  //      (QT, 4R)
  for (int r = tid; r < R; r += kThreads) {
    float z[4][QT];
    gate_preact<QT>(a, sm.h, cx_s, b, q0, r, z);
#pragma unroll
    for (int q = 0; q < QT; ++q) {
      const bool valid = q0 + q < Q;
      const size_t row = (size_t)b * Q + min(q0 + q, Q - 1);
      float dzg[4];
      const float dc_prev = cell_bwd(z[0][q], z[1][q], z[2][q], z[3][q],
                                     a.c[row * R + r],
                                     valid ? o.gh[row * R + r] : 0.f,
                                     valid ? o.gc[row * R + r] : 0.f, dzg);
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        dz_s[q * R4 + g * R + r] = round_if(a.at.bf16, dzg[g]);
        if (valid) o.dz0[row * R4 + g * R + r] = dzg[g];
      }
      if (valid) o.dc[row * R + r] = dc_prev;
    }
  }
  __syncthreads();

  // ---- dh = dz W_hh^T (the kernel's h input; the h -> hvec, pos chain is
  //      outside) and d ctx = dz ctx_w3^T
  gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
    if (u >= R) gs.dctx[q * ldHD + u - R] = v;
    else if (q0 + q < Q) o.dh[((size_t)b * Q + q0 + q) * R + u] = v;
  });
  __syncthreads();

  // ---- attention and sampling backward with g = d ctx, from the table
  attend_backward_table<QT>(at, sm, gs, value_b, vw_b, o.dvalue + (size_t)b * H * S * Dh,
                            o.G + (size_t)b * H * S * A, cols, dcb, daw);
  store_table_grads<QT>(at, gs, cols, dcb, daw, b, q0, o);
}

bool fill_step(StepArgs* a, const float* value_t, const float* pos,
               const float* hvec, const float* cb, const float* aw,
               const float* ab, const int* shapes, int H, int S, int Dh, int Q,
               int LP, int L, int A, int R, int bf16) {
  *a = StepArgs{};
  a->pos = pos; a->hvec = hvec; a->ab = ab;
  if (!fill_attend(&a->at, value_t, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return false;
  a->at.bf16 = bf16 != 0;
  a->at.hvec_given = 1;
  return true;
}

// the limits of K7-K10 (see the top) and their float4 reads: value rows,
// VW rows, cb, alpha_w, and the gate weights' rows in K10
bool table_limits(int A, int Dh, std::initializer_list<const float*> f4) {
  if (A > 256 * kColGroups || A % 4 != 0 || Dh % 4 != 0) return false;
  for (const float* p : f4)
    if (reinterpret_cast<size_t>(p) % 16 != 0) return false;
  return true;
}

}  // namespace

// Shapes as in the JAX kernels' operands (dvc_tpu/ops/dsa_step.py): value_t
// (B, H, S, Dh), pos (B, H, Q, LP) level-relative, hvec (B, Q, A), cb (A),
// aw (A), ab one float in device memory, and in place of the JAX kernels' cw
// (Dh, A) the table vw (B, H, S, A) = value_t . cw.  All f32, contiguous, on
// the current device; shapes is a host array of the L level lengths.  bf16
// != 0: the bf16-operand mode (K7-K10-bf16, see the top of this file), with
// value_t, and for K9 and K10 ctx_w3 and w_hh, given rounded to bf16 and vw
// the table of the bf16 mode (dvc_dsa_table_gemm's bf16).  Each entry point
// returns cudaGetLastError() of its launches, or cudaErrorInvalidValue for
// shapes it does not take.
//
// K7: ctx (B, H, Q, Dh) is written.  A <= 512, A and Dh multiples of 4;
// vw, cb and aw 16-byte aligned (read as float4).
extern "C" int dvc_dsa_step_fwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* cb, const float* aw, const float* ab, const int* shapes,
    float* ctx, int B, int H, int S, int Dh, int Q, int LP, int L, int A,
    int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, 0, bf16) ||
      !table_limits(A, Dh, {vw, cb, aw}))
    return (int)cudaErrorInvalidValue;
  a.at.ctx_f32 = 1;
  if (B == 0 || Q == 0) return 0;
  // no weight product to share, so the most blocks: 2 or 4 queries where
  // that grid fits half the SMs (B = 1), 4 where 8-query tiles would take
  // more than a wave (B = 16), else 8
  const int QT = query_tile(B, Q, 2, 4);
  const size_t smem = ForwardLayout(QT, 0, A, H * Dh, QT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 2 ? set_smem(step_fwd_kernel<2>, smem)
                  : QT == 4 ? set_smem(step_fwd_kernel<4>, smem)
                            : set_smem(step_fwd_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 2)
    step_fwd_kernel<2><<<grid, kThreads, smem, st>>>(a, vw, ctx);
  else if (QT == 4)
    step_fwd_kernel<4><<<grid, kThreads, smem, st>>>(a, vw, ctx);
  else
    step_fwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, vw, ctx);
  return (int)cudaGetLastError();
}

// K7's gradients for the cotangent g (B, H, Q, Dh) of ctx, with respect to
// its operands: dvalue (B, H, S, Dh), the context's term only (the scores'
// reach value through vw), and G (B, H, S, A) = dL/dvw, both zeroed by the
// caller with dcb (A), daw (A) and dab (1) (atomics); dpos (B, H, Q, LP) and
// dhvec (B, Q, A) fully written.  A <= 512, A and Dh multiples of 4;
// value_t, vw, cb and aw 16-byte aligned (read as float4).
extern "C" int dvc_dsa_step_bwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* cb, const float* aw, const float* ab, const float* g,
    const int* shapes, float* dvalue, float* G, float* dpos, float* dhvec,
    float* dcb, float* daw, float* dab, int B, int H, int S, int Dh, int Q,
    int LP, int L, int A, int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, 0, bf16) ||
      !table_limits(A, Dh, {value_t, vw, cb, aw}))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  StepGrads o{};
  o.g = g; o.dvalue = dvalue; o.G = G; o.dpos = dpos; o.dhvec = dhvec;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  // at most 8 queries a tile: a warp of the score backward owns a (query,
  // column part), and A <= 512 needs two parts
  const int QT = query_tile(B, Q, 2, kQT);
  const size_t smem = TableBwdLayout(QT, A, H * Dh, QT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 2 ? set_smem(step_bwd_kernel<2>, smem)
                  : QT == 4 ? set_smem(step_bwd_kernel<4>, smem)
                            : set_smem(step_bwd_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 2)
    step_bwd_kernel<2><<<grid, kThreads, smem, st>>>(a, o, vw);
  else if (QT == 4)
    step_bwd_kernel<4><<<grid, kThreads, smem, st>>>(a, o, vw);
  else
    step_bwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, o, vw);
  return (int)cudaGetLastError();
}

// K9: as dvc_dsa_step_fwd, plus z0 (B, Q, 4R), h and c (B, Q, R), ctx_w3 (H*Dh, 4R)
// and w_hh (R, 4R); h_new and c_new (B, Q, R) are written.  A <= 512; A,
// Dh and R multiples of 4.
extern "C" int dvc_dsa_lstm_fwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* z0, const float* h, const float* c, const float* ctx_w3,
    const float* w_hh, const float* cb, const float* aw, const float* ab,
    const int* shapes, float* h_new, float* c_new, int B, int H, int S, int Dh,
    int Q, int LP, int L, int A, int R, int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, R, bf16) ||
      !table_limits(A, Dh, {}) || R % 4 != 0)
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  if (B == 0 || Q == 0) return 0;
  // as K4: 4 queries at least, 16 where 8-query tiles would take more than
  // a wave
  const int QT = query_tile(B, Q, 4, 16);
  const size_t smem = ForwardLayout(QT, R, A, H * Dh, QT * H * LP).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 4 ? set_smem(lstm_fwd_kernel<4>, smem)
                  : QT == 16 ? set_smem(lstm_fwd_kernel<16>, smem)
                             : set_smem(lstm_fwd_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 4)
    lstm_fwd_kernel<4><<<grid, kThreads, smem, st>>>(a, vw, h_new, c_new);
  else if (QT == 16)
    lstm_fwd_kernel<16><<<grid, kThreads, smem, st>>>(a, vw, h_new, c_new);
  else
    lstm_fwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, vw, h_new, c_new);
  return (int)cudaGetLastError();
}

// K9's gradients for the cotangents gh, gc (B, Q, R) of (h_new, c_new),
// with respect to its operands: dvalue (B, H, S, Dh), the context's term
// only (the scores' reach value through vw), and G (B, H, S, A) = dL/dvw,
// both zeroed by the caller with dcb, daw and dab; dpos, dhvec, dz0
// (B, Q, 4R), dh, dc (B, Q, R), dctx_w3 (H*Dh, 4R) and dwhh (R, 4R) fully
// written; scratch ctx_all (B, Q, H*Dh) and work (work_floats floats, the
// outer sums' split-K partial tiles).  A <= 512; A, Dh and R multiples of
// 4; value_t, vw, cb, aw, ctx_w3 and w_hh 16-byte aligned (read as float4).
extern "C" int dvc_dsa_lstm_bwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* z0, const float* h, const float* c, const float* ctx_w3,
    const float* w_hh, const float* cb, const float* aw, const float* ab,
    const float* gh, const float* gc, const int* shapes, float* dvalue,
    float* G, float* dpos, float* dhvec, float* dz0, float* dh, float* dc,
    float* dctx_w3, float* dwhh, float* dcb, float* daw, float* dab,
    float* ctx_all, float* work, int B, int H, int S, int Dh, int Q, int LP,
    int L, int A, int R, int work_floats, int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, R, bf16) ||
      !table_limits(A, Dh, {value_t, vw, cb, aw, ctx_w3, w_hh}) || R % 4 != 0)
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  StepGrads o{};
  o.gh = gh; o.gc = gc; o.dvalue = dvalue; o.G = G; o.dpos = dpos;
  o.dhvec = dhvec; o.dcb = dcb; o.daw = daw; o.dab = dab; o.dz0 = dz0;
  o.dh = dh; o.dc = dc; o.ctx_all = ctx_all;
  cudaStream_t st = (cudaStream_t)stream;
  const int N = B * Q, HD = H * Dh;
  const size_t wf = work_floats > 0 ? (size_t)work_floats : 0;
  cudaError_t e = cudaSuccess;
  if (B > 0 && Q > 0) {
    // as K5: at most 8 queries a tile (a warp of the score backward owns a
    // (query, column part)), 2 or 4 on a small grid
    const int QT = query_tile(B, Q, 2, kQT);
    const size_t smem = LstmBwdLayout(QT, R, A, HD, QT * H * LP).bytes();
    e = QT == 2 ? set_smem(lstm_bwd_kernel<2>, smem)
        : QT == 4 ? set_smem(lstm_bwd_kernel<4>, smem)
                  : set_smem(lstm_bwd_kernel<kQT>, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((Q + QT - 1) / QT, B);
    if (QT == 2)
      lstm_bwd_kernel<2><<<grid, kThreads, smem, st>>>(a, o, vw);
    else if (QT == 4)
      lstm_bwd_kernel<4><<<grid, kThreads, smem, st>>>(a, o, vw);
    else
      lstm_bwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, o, vw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  const bool rb = a.at.bf16;
  if ((e = outer_sum(h, R, dz0, 4 * R, N, R, 4 * R, dwhh, st, work, wf, rb)) != cudaSuccess)
    return (int)e;
  return (int)outer_sum(ctx_all, HD, dz0, 4 * R, N, HD, 4 * R, dctx_w3, st, work, wf, rb);
}
