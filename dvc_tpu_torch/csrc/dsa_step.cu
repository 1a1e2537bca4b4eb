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
//   K7-bf16 step_fwd16_kernel and K8-bf16 step_bwd16_kernel: the same two
//       in the bf16 variant, in the TPU kernels' product form (below)
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
// In f32 (and K9/K10 in bf16) they score from the per-video table VW =
// value_t Wc (B, H, S, A), an operand: a tap is a lerp of two value rows, so taps . Wc is the same
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
// path): the TPU kernels' bf16 variants round both operands of every
// in-kernel product to bf16 and accumulate in f32 (_make_dot('bfloat16')):
// the taps M . value (M's lerp weights rounded), the scores taps . Wc, in K9
// h . W_hh and ctx . ctx_w3, and in K8 and K10 every transposed product and
// weight gradient's outer sum.  Where the word steps differ from the scan
// K4/K5-bf16: hvec, the offsets and ctx . ctx_w (around K7) are f32
// products outside the kernel in JAX too, so K7 writes ctx unrounded and
// K8 and K10 write dhvec and dpos unrounded (hvec_given).
//
// K7-bf16 and K8-bf16 compute the TPU kernels' product form on the tensor
// cores (step_fwd16_kernel, step_bwd16_kernel; the f32 kernels compile none
// of it), with no table and no G: the table VW = value . Wc is A/Dh times
// value's size (98 MB at B = 16, cap_nheads 8, twice the L2), and a step's
// 2A loads a tap row from it (840 MB a launch there) and K8's scatter of
// du into G of the same size were what bounded the table form.  One block
// an SM loops over (video, query tile) tiles; a tile's tap rows, each
// query's H*LP rows padded to a whole m-tile of 16, are staged in shared
// memory as bf16(taps), the lerp of two rows of value_t in bf16 (value16,
// which the caption head rounds once per forward pass).  Wc comes from a
// pack in fragment order (ops/dsa_step.py::pack_attend_weights: Wc^T, then
// Wc, each lane's 16 bytes a pair of B fragments) that the head makes once
// per forward pass and DSASampleAttendFunction hands to both kernels;
// where Dh <= 64 and A <= 512 (cap_nheads 8) each block copies it into
// shared memory once, else the kernels read it from L2.  A warp per 16
// columns of A, four m-tiles at a time (K8-bf16 with the pack resident:
// one, for the registers below):
//
//   pre  = bf16(taps) . Wc            mma.sync.m16n8k16, A from ldmatrix
//   d    = sum_A tanh((pre + cb) + hvec) . alpha_w + alpha_b   (accumulators)
//   ctx  = sum_p softmax(d) * taps    (K7: the taps again from value16, f32)
//
// K8-bf16 recomputes d, forms d wts and ddot from the unrounded taps, then
// in chunks of 32 or 64 rows: pre again, du = (ddot alpha_w)(1 - a^2) on the
// accumulators, du's f32 sums into dhvec, dcb and (ddot a) d alpha_w, and
// bf16(du) staged; dtaps = wts dctx + bf16(du) . Wc^T (mma, the pack's
// second half; a warp per 16 columns of Dh), dpos = dtaps . (v[hi] - v[lo])
// from the unrounded dtaps, and bf16(dtaps) lerp-scattered into dvalue
// (float4 atomics, two lanes' halves traded: Dh floats a tap row where G
// took A); dcw = bf16(taps)^T bf16(du) on mma from ldmatrix's transposed
// loads, summed in the block's registers across its tiles (a warp owns 32
// columns of A and all of Dh <= 64: 64 floats a thread) and added with
// atomics once a block, or, where Dh * A is larger (cap_nheads 1: 262,144
// sums), as bf16 rows of the taps and of du reduced by the GEMM's outer
// sum.  What bounds them: the tanh of every (tap row, column of A), 105 M a
// launch at B = 16, Q = 100, cap_nheads 8, twice in K8 (the MUFU and FP32
// pipes), the products (6.7 GMAC each), and, at cap_nheads 1, Wc (512 KB)
// streamed from L2 once per 64 rows; K8-bf16's dcw accumulators leave its
// other phases few registers (PERF.md section 6).  Shared memory at
// LP = 16, A = 512: the tile is 2 queries (at least 64 rows) at cap_nheads
// 8, 4 at cap_nheads 1, halved while the tiles would not fill the SMs or
// the layout would not fit (attend16_plan): K8-bf16 at cap_nheads 8 takes
// 1 query (the pack, 128 KB, resident).
//
// K9-bf16 and K10-bf16 keep the table form on the bf16-operand mode of
// dsa_common.cuh: the caller passes value_t rounded (once per forward pass)
// and VW from the table GEMM's bf16 mode; the kernels store rounded the lerp
// weights, h (load_h), the ctx that they multiply, dz, and the scattered
// wts * dctx and du; the outer sums h^T dz and ctx^T dz run in the GEMM's
// bf16 mode.  The table form moves rounding points as in K4-K6
// (dsa_scan.cu): the taps are never rounded before their product with Wc,
// and dvalue's scores term and dWc come from bf16(G) in the table's
// backward (measured in tests/test_torch_bf16_step.py and chip_smoke.py
// --bf16).
//
// K9-bf16 and K10-bf16 are instantiations of their own (B16; the f32 ones
// compile none of this) whose gate products run on the tensor cores as
// K4-bf16's and K5-bf16's (dsa_common.cuh, GateGeom): mma.sync.m16n8k16
// from P = [W_hh; ctx_w3] packed in bf16 in fragment order, which the
// caption head packs once per forward pass (ops/dsa_scan.py::
// pack_gate_weights, 8 MB at R = H*Dh = 512) and DSALSTMStepFunction hands
// to K9-bf16 and, for its backward, K10-bf16.  K9-bf16 (gates_fwd_bf16): x =
// [h | ctx] staged in bf16, z = z0 + [h | ctx] P from P^T's half with the
// cell on the accumulators (at 16 queries, B = 16, each A fragment feeds
// two n8 tiles).  K10-bf16 (gates_bwd_bf16, shared with K5-bf16): the same
// recompute, so it reproduces K9-bf16's gates bit for bit, the cell
// backward on the accumulators, then [dh | dctx] = dz P from P's half; x
// and dz staged in bf16 in the room of the f32 dz tile.  Neither reads the
// f32 w_hh or ctx_w3.
//
// Limits of K7-K10 (K7/K8-bf16: the entry points' own): A <= 512 (two float4
// column groups per lane and column part in the backwards), A and Dh
// multiples of 4 (K9, K10 also R), and the
// shared memory of a block (checked at launch: K10's staged dz, QT x 4R
// floats in f32 and x and dz in bf16 in K10-bf16, takes most of it).  At R
// = A = H*Dh = 512 and LP = 16, cap_nheads 1 / 8: K9 at 16 queries 103,424
// / 139,264 bytes, K9-bf16 136,448 / 172,288; K10 at 8 queries 134,672 /
// 159,760, K10-bf16 118,544 / 143,632 (the card allows 232,448).

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
  const float* ctx_w3;  // (H*Dh, 4R)       the f32 K9/K10
  const float* w_hh;    // (R, 4R)
  const uint4* wpack;   // K9/K10-bf16: [W_hh; ctx_w3] packed in bf16 (GateGeom);
                        // K7/K8-bf16: the Wc pack (Attend16Geom)
  const void* value16;  // K7/K8-bf16: value_t (B, H, S, Dh) in bf16
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
  void* ctx_all;    // (B, Q, H*Dh) rows for dctx_w3 (bf16 in the bf16 mode)
  float* dcw;       // (Dh, A)  K8-bf16: zeroed, atomics (or the GEMM's output)
  void* rows_t;     // K8-bf16 with the GEMM's outer sum: bf16(taps) rows
  void* rows_u;     //   (B*Q*H*LP, Dh) and bf16(du) rows (B*Q*H*LP, A)
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
// tile (QT rows each), in K9-bf16 (b16) x = [h | ctx] staged in bf16 (QT
// rows of GateGeom::ldx), and the tile's tap table
struct ForwardLayout {
  int h, hvec, ctx, x, wlo, whi, d;  // float offsets
  int lo, hi;                        // int offsets
  int floats, ints;
  __host__ __device__ ForwardLayout(int QT, int R, int A, int HD, int NR, bool b16 = false) {
    int o = 0;
    h = o;    o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    ctx = o;  o += QT * pad4(HD);
    x = o;    o += b16 ? pad4(QT * GateGeom(R, HD).ldx / 2) : 0;
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
// the scores from the table VW = value . Wc.  B16: K9-bf16's body, whose
// gate products run on the tensor cores (gates_fwd_bf16 from the packed
// P^T, the cell on the accumulators); the f32 body compiles none of that
template <int QT, bool B16>
__device__ __forceinline__ void lstm_fwd_step(const StepArgs& a, const float* __restrict__ vw,
                                              float* __restrict__ h_out,
                                              float* __restrict__ c_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, R = at.R, S = at.S, HD = H * Dh;
  const ForwardLayout L(QT, R, at.A, HD, QT * H * at.LP, B16);
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

  // K9-bf16: z = z0 + [h | ctx] P on the tensor cores, a warp per unit
  // block, and the cell on the accumulators (h' and c' written unrounded)
  if constexpr (B16)
    gates_fwd_bf16<QT>(
        a.wpack, GateGeom(R, HD), sm.h, pad4(R), sm.ctx, pad4(HD),
        reinterpret_cast<__nv_bfloat16*>(smem + L.x),
        [&](int qi, int u, int gate) {
          return a.z0[((size_t)b * Q + min(q0 + qi, Q - 1)) * 4 * R + gate * R + u];
        },
        [&](int qi, int u) { return a.c[((size_t)b * Q + min(q0 + qi, Q - 1)) * R + u]; },
        [&](int qi, int u, float h, float c) {
          if (q0 + qi >= Q) return;
          const size_t o = ((size_t)b * Q + q0 + qi) * R + u;
          h_out[o] = h;
          c_out[o] = c;
        });
  // a thread owns hidden unit r (its 4 gate columns), as in K4
  for (int r = tid; !B16 && r < R; r += kThreads) {
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

template <int QT>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(StepArgs a, const float* __restrict__ vw, float* __restrict__ h_out,
                float* __restrict__ c_out) {
  lstm_fwd_step<QT, false>(a, vw, h_out, c_out);
}

// K9-bf16: one block an SM (its shared memory allows no more), so that
// ptxas gives the mma loops the registers to keep their A fragments in
// flight, as K4-bf16
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd16_kernel(StepArgs a, const float* __restrict__ vw, float* __restrict__ h_out,
                  float* __restrict__ c_out) {
  lstm_fwd_step<QT, true>(a, vw, h_out, c_out);
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

// ----------------------------------------------------------------------------
// K7-bf16 and K8-bf16: the TPU kernels' product form on the tensor cores
// ----------------------------------------------------------------------------

// four 8 x 8 bf16 matrices from shared memory (ldmatrix), each lane giving
// the address of one row: as stored, or transposed (trans)
template <bool Trans>
__device__ __forceinline__ uint4 ldsm4(const __nv_bfloat16* p) {
  uint4 r;
  const uint32_t a = (uint32_t)__cvta_generic_to_shared(p);
  if constexpr (Trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "r"(a));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "r"(a));
  return r;
}

// the two bf16 halves of a 32-bit word as f32 (lo: the element at the
// lower address)
__device__ __forceinline__ float bf_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// a tap's value: the lerp of its two value elements, as the TPU kernel's
// M . value sums it (both products exact in f32, one rounding)
__device__ __forceinline__ float lerp_tap(float wl, float vl, float wh, float vh) {
  return __fadd_rn(__fmul_rn(wl, vl), __fmul_rn(wh, vh));
}

// a fragment of the Wc pack: from shared memory where it is resident, else
// from global memory (L2)
template <bool kRes>
__device__ __forceinline__ uint4 ld_frag(const uint4* p) {
  if constexpr (kRes)
    return *p;
  else
    return __ldg(p);
}

// the tiles of K7-bf16 and K8-bf16.  A tile's QT queries hold RQ tap rows
// each, their H*LP rows padded to a whole m-tile of 16 (zero taps, left
// out of the softmax), so that an m-tile lies within one query; K8-bf16's
// du is staged in chunks of RC rows.  The Wc pack (ops/dsa_step.py::
// pack_attend_weights) holds Wc^T and then Wc in pack_hidden_weights'
// tiles, each lane's 16 bytes in B order: tile (j, kt) of the first half,
// 16 columns of A x 16 terms of Dh, is the pair of B fragments of taps .
// Wc for the n8 tiles 2j (uint4 .x, .y) and 2j + 1 (.z, .w); the second
// half's tile (j, kt), 16 columns of Dh x 16 terms of A, those of du . Wc^T
struct Attend16Geom {
  int QT, RC, HLP, RQ, NR, Dh, A, ldt, ldu, kd, ka, pk1, pk2, off2;
  __host__ __device__ Attend16Geom(int QT_, int RC_, int H, int LP, int Dh_, int A_)
      : QT(QT_), RC(RC_), HLP(H * LP), RQ((H * LP + 15) / 16 * 16), Dh(Dh_), A(A_) {
    NR = QT * RQ;
    ldt = Dh + 8;                   // bf16 strides of the staged taps and du
    ldu = A + 8;                    // rows: 16 bytes of padding, so that
                                    // ldmatrix's 8 rows hit 32 banks
    kd = Dh / 16;                   // k-tiles of taps . Wc
    ka = A / 16;                    // k-tiles of du . Wc^T; 16-column chunks
    pk1 = (Dh + 63) / 64 * 4;       // k-tiles a row of the first half
    pk2 = (A + 63) / 64 * 4;        // and of the second (pack_hidden_weights'
                                    // terms are padded to 64)
    off2 = ((A + 15) / 16) * pk1 * 32;  // 16-byte index of the second half
  }
  // 16-byte units of the pack's first half, and of both
  __host__ __device__ int pack1() const { return off2; }
  __host__ __device__ int pack2() const { return off2 + (Dh + 15) / 16 * pk2 * 32; }
};

// K8-bf16's chunks of du rows: at most 64 (their partial row sums are
// double-buffered)
constexpr int kChunk = 64;

// shared memory of K7-bf16 (bwd false) and K8-bf16: the tile's hvec, its
// tap table over the padded rows (lo, hi, lerp weights, scores then softmax
// weights), the warps' partial row sums (of the tile's scores; of K8's
// chunks, double-buffered), and its taps in bf16; K8-bf16 also the tile's
// dctx, d wts then d scores, dpos and dhvec, the block's dcb, d alpha_w and
// d alpha_b, and a chunk's du in bf16; where kRes, the Wc pack (K7-bf16
// its first half)
struct Attend16Layout {
  int hvec, wlo, whi, d, part, lo, hi, mq, dctx, ddot, dpos, dhvec, dcb, daw, dab;  // words
  size_t taps, du, pack, bytes;                                                 // bytes
  __host__ __device__ Attend16Layout(const Attend16Geom& g, int HD, bool bwd, bool res) {
    int o = 0;
    hvec = o;  o += g.QT * g.A;
    wlo = o;   o += g.NR;
    whi = o;   o += g.NR;
    d = o;     o += g.NR;
    part = o;  o += kWarps * (g.NR > 2 * kChunk ? g.NR : 2 * kChunk);
    lo = o;    o += g.NR;
    hi = o;    o += g.NR;
    mq = o;    o += pad4(g.NR / 16);
    dctx = o;  o += bwd ? g.QT * HD : 0;
    ddot = o;  o += bwd ? g.NR : 0;
    dpos = o;  o += bwd ? g.NR : 0;
    dhvec = o; o += bwd ? g.QT * g.A : 0;
    dcb = o;   o += bwd ? g.A : 0;
    daw = o;   o += bwd ? g.A : 0;
    dab = o;   o += 4;
    taps = (size_t)pad4(o) * 4;
    du = taps + (size_t)g.NR * g.ldt * 2;
    pack = du + (bwd ? (size_t)g.RC * g.ldu * 2 : 0);
    bytes = pack + (res ? (size_t)16 * (bwd ? g.pack2() : g.pack1()) : 0);
  }
};

// the block's view of its shared memory and operands; value points at the
// current tile's video
struct Attend16 {
  Attend16Geom g;
  Attend16Layout L;
  float *hvec, *d, *part;
  int* mq;        // the query of each m-tile
  AttendSmem sm;  // lo, hi, wlo, whi of the tap table (tap_row)
  __nv_bfloat16 *taps, *du;
  const __nv_bfloat16* value;  // value16[b] (H, S, Dh)
  const uint4* pack;           // the Wc pack, 16 bytes a lane and tile
  __device__ Attend16(const AttendArgs& at, int QT, int RC, bool bwd, bool res)
      : g(QT, RC, at.H, at.LP, at.Dh, at.A), L(g, at.H * at.Dh, bwd, res) {
    extern __shared__ float4 smem4[];
    float* s = reinterpret_cast<float*>(smem4);
    hvec = s + L.hvec; d = s + L.d; part = s + L.part;
    mq = reinterpret_cast<int*>(s + L.mq);
    sm = AttendSmem{};
    sm.wlo = s + L.wlo; sm.whi = s + L.whi; sm.d = d;
    sm.lo = reinterpret_cast<int*>(s + L.lo); sm.hi = reinterpret_cast<int*>(s + L.hi);
    taps = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem4) + L.taps);
    du = reinterpret_cast<__nv_bfloat16*>(reinterpret_cast<char*>(smem4) + L.du);
    value = nullptr;
    pack = nullptr;
  }
  // (query, head, tap) of padded row `row`; false on a padding row
  __device__ bool unpad(int row, int& q, int& hh, int& p, int LP) const {
    q = row / g.RQ;
    const int r = row % g.RQ;
    hh = r / LP;
    p = r % LP;
    return r < g.HLP;
  }
};

// the Wc pack where it is read: copied into shared memory once a block
// (kRes: n16 16-byte units), else global.  No barrier.
template <bool kRes>
__device__ __forceinline__ void attend16_pack(Attend16& t, const uint4* wpack, int n16) {
  if constexpr (kRes) {
    extern __shared__ float4 smem4[];
    uint4* dst = reinterpret_cast<uint4*>(reinterpret_cast<char*>(smem4) + t.L.pack);
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = __ldg(wpack + i);
    t.pack = dst;
  } else {
    t.pack = wpack;
  }
}

// phases 1 and 2 of a tile: hvec of its queries and its tap table over the
// padded rows (tap_row's bf16 rule; padding rows: no weight), then the taps
// lerp(value16[lo], value16[hi]) rounded to bf16 into t.taps (the operand
// of taps . Wc; zero on padding rows), a thread per 8 columns of a row with
// four rows' loads in flight.  A query past Q reads the last one.  Ends
// with a barrier.
__device__ __forceinline__ void attend16_taps(const AttendArgs& at, const Attend16& t, int b,
                                              int q0, const float* pos, const float* hvec) {
  const int tid = threadIdx.x, A = at.A, Q = at.Q, LP = at.LP, Dh = at.Dh;
  for (int i = tid; i < t.g.QT * A; i += kThreads) {
    const int q = i / A, qq = min(q0 + q, Q - 1);
    t.hvec[i] = hvec[((size_t)b * Q + qq) * A + i % A];
  }
  for (int row = tid; row < t.g.NR; row += kThreads) {
    int q, hh, p;
    if (t.unpad(row, q, hh, p, LP)) {
      const int qq = min(q0 + q, Q - 1);
      tap_row(at, t.sm, row, p, pos[(((size_t)b * at.H + hh) * Q + qq) * LP + p]);
    } else {
      t.sm.lo[row] = t.sm.hi[row] = 0;
      t.sm.wlo[row] = t.sm.whi[row] = 0.f;
    }
    if (row % 16 == 0) t.mq[row / 16] = q;
  }
  __syncthreads();
  const int c8 = Dh / 8, n8 = t.g.NR * c8;
  for (int i0 = tid; i0 < n8; i0 += 4 * kThreads) {
    uint4 l[4], h[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, row = i / c8;
      int q, hh, p;
      l[k] = h[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < n8 && t.unpad(row, q, hh, p, LP)) {
        const __nv_bfloat16* v = t.value + (size_t)hh * at.S * Dh + (i % c8) * 8;
        l[k] = __ldg(reinterpret_cast<const uint4*>(v + (size_t)t.sm.lo[row] * Dh));
        h[k] = __ldg(reinterpret_cast<const uint4*>(v + (size_t)t.sm.hi[row] * Dh));
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int i = i0 + k * kThreads, row = i / c8;
      if (i >= n8) break;
      const float wl = t.sm.wlo[row], wh = t.sm.whi[row];   // 0 on a padding row
      const uint32_t lw[4] = {l[k].x, l[k].y, l[k].z, l[k].w};
      const uint32_t hw[4] = {h[k].x, h[k].y, h[k].z, h[k].w};
      uint32_t o[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[e] = bf16_pair(lerp_tap(wl, bf_lo(lw[e]), wh, bf_lo(hw[e])),
                         lerp_tap(wl, bf_hi(lw[e]), wh, bf_hi(hw[e])));
      *reinterpret_cast<uint4*>(t.taps + (size_t)row * t.g.ldt + (i % c8) * 8) =
          make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
  __syncthreads();
}

// acc[i][nt] (D fragments) = taps . Wc of the tile's m-tiles mt0 + i (i <
// MT, below mtn) and the n8 tiles 2j + nt (columns 16j + 8nt ..): A
// fragments from the staged taps (ldmatrix; a tile past mtn reads mt0's
// rows and is left out), B fragments from the pack's first half (from L2:
// four k-tiles' in flight), summed over the Dh/16 k-tiles in order from
// zero
template <int MT, bool kRes>
__device__ __forceinline__ void taps_wc(const Attend16& t, int mt0, int mtn, int j,
                                        float (&acc)[MT][2][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][nt][e] = 0.f;
  const uint4* bp = t.pack + (size_t)j * t.g.pk1 * 32 + lane;
  const __nv_bfloat16* ap[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i)
    ap[i] = t.taps + (size_t)(16 * (mt0 + i < mtn ? mt0 + i : mt0) + (lane & 15)) * t.g.ldt +
            (lane >> 4) * 8;
  constexpr int KB = kRes ? 1 : 4;
  for (int k0 = 0; k0 < t.g.kd; k0 += KB) {
    uint4 b[KB];
#pragma unroll
    for (int k = 0; k < KB; ++k)
      if (k0 + k < t.g.kd) b[k] = ld_frag<kRes>(bp + (k0 + k) * 32);
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      if (k0 + k >= t.g.kd) break;
      uint4 a[MT];   // the A fragments loaded ahead of their products
#pragma unroll
      for (int i = 0; i < MT; ++i) a[i] = ldsm4<false>(ap[i] + (k0 + k) * 16);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_bf16_16816(acc[i][0], a[i], b[k].x, b[k].y);
        mma_bf16_16816(acc[i][1], a[i], b[k].z, b[k].w);
      }
    }
  }
}

// phase 3 of K7-bf16 and K8-bf16: every row's score.  A warp per 16-column
// chunk of A (its chunks j = warp, warp + 16, ...), MT m-tiles of the tile
// at a time: pre = taps . Wc on the tensor cores and on the accumulators
// each row's sum over the warp's columns of tanh((pre + cb) + hvec[q]) *
// alpha_w, into part (kWarps x NR).  No barrier.
template <int MT, bool kRes>
__device__ __forceinline__ void attend16_scores(const AttendArgs& at, const Attend16& t,
                                                float* part) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int mtn = t.g.NR / 16;
  for (int mt0 = 0; mt0 < mtn; mt0 += MT) {
    float rs[MT][2] = {};
    for (int j = warp; j < t.g.ka; j += kWarps) {
      float acc[MT][2][4];
      taps_wc<MT, kRes>(t, mt0, mtn, j, acc);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * j + 8 * nt + 2 * tq;
        const float2 cb = *reinterpret_cast<const float2*>(at.cb + c);
        const float2 aw = *reinterpret_cast<const float2*>(at.aw + c);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int qr = t.mq[mt0 + i < mtn ? mt0 + i : mt0];   // the m-tile's query
          const float2 hv = *reinterpret_cast<const float2*>(t.hvec + (size_t)qr * t.g.A + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float a = tanhf(__fadd_rn(__fadd_rn(acc[i][nt][e], e & 1 ? cb.y : cb.x),
                                            e & 1 ? hv.y : hv.x));
            rs[i][e >> 1] = fmaf(a, e & 1 ? aw.y : aw.x, rs[i][e >> 1]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[i][h] += __shfl_xor_sync(0xffffffffu, rs[i][h], 1);
        rs[i][h] += __shfl_xor_sync(0xffffffffu, rs[i][h], 2);
        if (tq == 0 && mt0 + i < mtn)
          part[warp * t.g.NR + 16 * (mt0 + i) + gq + 8 * h] = rs[i][h];
      }
  }
}

// dst[m0 + r] = sum over the warps of part[w * ld + r] (in warp order) +
// add, for the rows r < rows.  No barrier.
__device__ __forceinline__ void reduce_part(const float* part, int ld, float* dst, int m0,
                                            int rows, float add) {
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float s = 0.f;
#pragma unroll 4
    for (int w = 0; w < kWarps; ++w) s += part[w * ld + r];
    dst[m0 + r] = s + add;
  }
}

// phases 3 and 4 of a tile: every row's score (attend16_scores), then the
// softmax over each (query, head)'s LP taps in place in t.d (padding rows:
// weight 0).  Ends with a barrier.
template <int MT, bool kRes>
__device__ __forceinline__ void attend16_softmax(const AttendArgs& at, const Attend16& t,
                                                 float ab) {
  const int NR = t.g.NR, LP = at.LP;
  attend16_scores<MT, kRes>(at, t, t.part);
  __syncthreads();
  reduce_part(t.part, NR, t.d, 0, NR, ab);
  __syncthreads();
  for (int gi = threadIdx.x; gi < t.g.QT * at.H; gi += kThreads) {
    float* dg = t.d + gi / at.H * t.g.RQ + gi % at.H * LP;
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
  for (int row = threadIdx.x; row < NR; row += kThreads)
    if (row % t.g.RQ >= t.g.HLP) t.d[row] = 0.f;
  __syncthreads();
}

// K7-bf16: K7 in the TPU kernel's product form (see the top of this file),
// a block per SM looping over the (video, query tile) tiles; kRes: the Wc
// pack's first half in shared memory
template <bool kRes>
__global__ void __launch_bounds__(kThreads, 1)
step_fwd16_kernel(StepArgs a, int B, int QT, int RC, float* __restrict__ ctx_out) {
  const AttendArgs& at = a.at;
  const int H = at.H, Dh = at.Dh, Q = at.Q, LP = at.LP, HD = H * Dh, nq = (Q + QT - 1) / QT;
  Attend16 t(at, QT, RC, false, kRes);
  attend16_pack<kRes>(t, a.wpack, t.g.pack1());
  const __nv_bfloat16* value16 = static_cast<const __nv_bfloat16*>(a.value16);
  for (int tile = blockIdx.x; tile < B * nq; tile += gridDim.x) {
    const int b = tile / nq, q0 = tile % nq * QT;
    t.value = value16 + (size_t)b * H * at.S * Dh;
    attend16_taps(at, t, b, q0, a.pos, a.hvec);
    attend16_softmax<4, kRes>(at, t, __ldg(a.ab));
    // ctx = sum_p wts * taps from the unrounded taps, written in f32: a
    // thread per two columns of a (query, head), eight taps' loads in flight
    const int HD2 = HD / 2;
    for (int i = threadIdx.x; i < QT * HD2; i += kThreads) {
      const int q = i / HD2, hd = 2 * (i % HD2), hh = hd / Dh, dh = hd % Dh;
      if (q0 + q >= Q) continue;
      const __nv_bfloat16* v = t.value + (size_t)hh * at.S * Dh + dh;
      const int r0 = q * t.g.RQ + hh * LP;
      float acc[2] = {0.f, 0.f};
      for (int p0 = 0; p0 < LP; p0 += 8) {
        uint32_t vl[8], vh[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (p0 + k >= LP) break;
          vl[k] = __ldg(reinterpret_cast<const unsigned int*>(v + (size_t)t.sm.lo[r0 + p0 + k] * Dh));
          vh[k] = __ldg(reinterpret_cast<const unsigned int*>(v + (size_t)t.sm.hi[r0 + p0 + k] * Dh));
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          if (p0 + k >= LP) break;
          const int row = r0 + p0 + k;
          const float wl = t.sm.wlo[row], wh = t.sm.whi[row], w = t.d[row];
          acc[0] = fmaf(w, lerp_tap(wl, bf_lo(vl[k]), wh, bf_lo(vh[k])), acc[0]);
          acc[1] = fmaf(w, lerp_tap(wl, bf_hi(vl[k]), wh, bf_hi(vh[k])), acc[1]);
        }
      }
      *reinterpret_cast<float2*>(ctx_out + (((size_t)b * H + hh) * Q + q0 + q) * Dh + dh) =
          make_float2(acc[0], acc[1]);
    }
    __syncthreads();   // before the next tile's table
  }
}

// K8-bf16's du phase of one staged chunk (rows m0.., nmt m-tiles): a warp
// per 16-column chunk of A (its chunks j = warp, warp + 16, ..., so that it
// alone adds to those columns' sums), MT m-tiles a pass: pre = taps . Wc
// again, a = tanh((pre + cb) + hvec), du = (ddot * aw) * (1 - a a) on the
// accumulators; bf16(du) into t.du (the chunk's rows); du summed in f32
// over the rows of each m-tile into the query's dhvec and the block's dcb,
// ddot * a into the block's d alpha_w.  No barrier.
template <int MT, bool kRes>
__device__ __forceinline__ void attend16_du(const AttendArgs& at, const Attend16& t, int m0,
                                            int nmt, const float* ddot, float* dhvec,
                                            float* dcb, float* daw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  for (int j = warp; j < t.g.ka; j += kWarps) {
    float cdu[2][2] = {}, cdaw[2][2] = {};  // [nt][column]: over the chunk
    for (int i0 = 0; i0 < nmt; i0 += MT) {
      float acc[MT][2][4];
      taps_wc<MT, kRes>(t, m0 / 16 + i0, m0 / 16 + nmt, j, acc);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i0 + i >= nmt) break;
        const int r0 = m0 + 16 * (i0 + i), qr = t.mq[r0 / 16];
        const float dd[2] = {ddot[r0 + gq], ddot[r0 + gq + 8]};
        float sdu[2][2];  // [nt][column]: over the m-tile's rows
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int c = 16 * j + 8 * nt + 2 * tq;
          const float2 hv = *reinterpret_cast<const float2*>(t.hvec + (size_t)qr * t.g.A + c);
          const float2 cb = *reinterpret_cast<const float2*>(at.cb + c);
          const float2 aw = *reinterpret_cast<const float2*>(at.aw + c);
          float du[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float th = tanhf(__fadd_rn(__fadd_rn(acc[i][nt][e], e & 1 ? cb.y : cb.x),
                                             e & 1 ? hv.y : hv.x));
            const float w = e & 1 ? aw.y : aw.x;
            du[e] = __fmul_rn(__fmul_rn(dd[e >> 1], w), __fsub_rn(1.f, __fmul_rn(th, th)));
            cdaw[nt][e & 1] = fmaf(dd[e >> 1], th, cdaw[nt][e & 1]);
          }
#pragma unroll
          for (int h = 0; h < 2; ++h)
            *reinterpret_cast<uint32_t*>(t.du + (size_t)(r0 - m0 + gq + 8 * h) * t.g.ldu + c) =
                bf16_pair(du[2 * h], du[2 * h + 1]);
          sdu[nt][0] = du[0] + du[2];
          sdu[nt][1] = du[1] + du[3];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float s = sdu[nt][k];
            s += __shfl_xor_sync(0xffffffffu, s, 4);
            s += __shfl_xor_sync(0xffffffffu, s, 8);
            s += __shfl_xor_sync(0xffffffffu, s, 16);
            cdu[nt][k] += s;
            if (gq == 0) dhvec[(size_t)qr * t.g.A + 16 * j + 8 * nt + 2 * tq + k] += s;
          }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        float s = cdaw[nt][k];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (gq == 0) {
          const int c = 16 * j + 8 * nt + 2 * tq + k;
          dcb[c] += cdu[nt][k];
          daw[c] += s;
        }
      }
  }
}

// K8-bf16's dtaps phase of one chunk: dtaps = wts dctx + bf16(du) . Wc^T
// on the tensor cores (A fragments from t.du, B fragments from the pack's
// second half), a warp per (16 columns of Dh, m-tiles islot, islot + MS,
// ..., at most MTD of them); on the accumulators dpos's terms dtaps .
// (v[hi] - v[lo]) (unrounded dtaps; the value pairs fetched ahead of the
// products), summed into part, and the lerp-scatter of bf16(dtaps) into
// dvalue_b (float2 atomics).  No barrier.
template <int MTD, bool kRes>
__device__ __forceinline__ void attend16_dtaps(const AttendArgs& at, const Attend16& t, int m0,
                                               int nmt, int q0, const float* dctx, float* part,
                                               float* dvalue_b) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gq = lane >> 2, tq = lane & 3;
  const int np = t.g.kd, nw = min(np, kWarps), MS = kWarps / nw;
  const int jp0 = warp % nw, islot = warp / nw, Dh = at.Dh, LP = at.LP, S = at.S;
  if (islot >= MS || islot >= nmt) return;
  float dp[MTD][2] = {};
  for (int jp = jp0; jp < np; jp += nw) {
    uint32_t vl[MTD][2][2], vh[MTD][2][2];  // [m-tile][row half][n8 tile]
#pragma unroll
    for (int ii = 0; ii < MTD; ++ii)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * (islot + ii * MS) + gq + 8 * h;
        int q = 0, hh = 0, p = 0;
        const bool on = islot + ii * MS < nmt && t.unpad(row, q, hh, p, LP);
        const __nv_bfloat16* v = t.value + (size_t)hh * S * Dh + 16 * jp + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          vl[ii][h][nt] = on ? __ldg(reinterpret_cast<const unsigned int*>(
                                   v + (size_t)t.sm.lo[row] * Dh + 8 * nt)) : 0u;
          vh[ii][h][nt] = on ? __ldg(reinterpret_cast<const unsigned int*>(
                                   v + (size_t)t.sm.hi[row] * Dh + 8 * nt)) : 0u;
        }
      }
    float acc[MTD][2][4] = {};
    const uint4* bp = t.pack + t.g.off2 + (size_t)jp * t.g.pk2 * 32 + lane;
    const __nv_bfloat16* ap = t.du + (size_t)(16 * islot + (lane & 15)) * t.g.ldu + (lane >> 4) * 8;
    constexpr int KB = kRes ? 1 : 4;           // from L2: four k-tiles' loads in flight
    for (int k0 = 0; k0 < t.g.ka; k0 += KB) {
      uint4 bb[KB];
#pragma unroll
      for (int k = 0; k < KB; ++k)
        if (k0 + k < t.g.ka) bb[k] = ld_frag<kRes>(bp + (k0 + k) * 32);
#pragma unroll
      for (int k = 0; k < KB; ++k) {
        if (k0 + k >= t.g.ka) break;
        uint4 a[MTD];   // a tile past nmt reads the first one's rows
#pragma unroll
        for (int ii = 0; ii < MTD; ++ii)
          a[ii] = ldsm4<false>(ap + (size_t)16 * (islot + ii * MS < nmt ? ii * MS : 0) *
                                        t.g.ldu + (k0 + k) * 16);
#pragma unroll
        for (int ii = 0; ii < MTD; ++ii) {
          mma_bf16_16816(acc[ii][0], a[ii], bb[k].x, bb[k].y);
          mma_bf16_16816(acc[ii][1], a[ii], bb[k].z, bb[k].w);
        }
      }
    }
    // the epilogue; a lane and its neighbour (tq ^ 1) trade halves so that
    // each adds four consecutive columns of bf16(dtaps) with one float4
    // atomic a row and tap (the even lane the n8 tile 2jp's, the odd one
    // 2jp + 1's)
    const bool odd = tq & 1;
#pragma unroll
    for (int ii = 0; ii < MTD; ++ii) {
      if (islot + ii * MS >= nmt) break;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + 16 * (islot + ii * MS) + gq + 8 * h;
        int q, hh, p;
        const bool on = t.unpad(row, q, hh, p, LP) && q0 + q < at.Q;   // uniform in a lane pair
        float tb[2][2] = {};   // [nt][column]: bf16(dtaps)
        if (on) {
          const float wt = t.d[row];
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int c = 16 * jp + 8 * nt + 2 * tq;
            const float2 dc = *reinterpret_cast<const float2*>(dctx + (size_t)q * at.H * Dh + hh * Dh + c);
            const float d0 = __fadd_rn(__fmul_rn(wt, dc.x), acc[ii][nt][2 * h]);
            const float d1 = __fadd_rn(__fmul_rn(wt, dc.y), acc[ii][nt][2 * h + 1]);
            const uint32_t l = vl[ii][h][nt], u = vh[ii][h][nt];
            dp[ii][h] = fmaf(d0, bf_lo(u) - bf_lo(l), dp[ii][h]);
            dp[ii][h] = fmaf(d1, bf_hi(u) - bf_hi(l), dp[ii][h]);
            tb[nt][0] = __uint_as_float(bf16_bits(d0));
            tb[nt][1] = __uint_as_float(bf16_bits(d1));
          }
        }
        const float s0 = __shfl_xor_sync(0xffffffffu, odd ? tb[0][0] : tb[1][0], 1);
        const float s1 = __shfl_xor_sync(0xffffffffu, odd ? tb[0][1] : tb[1][1], 1);
        if (!on) continue;
        const float4 v4 = odd ? make_float4(s0, s1, tb[1][0], tb[1][1])
                              : make_float4(tb[0][0], tb[0][1], s0, s1);
        const float wl = t.sm.wlo[row], wh = t.sm.whi[row];
        float* dv = dvalue_b + (size_t)hh * S * Dh + 16 * jp + (odd ? 8 + 2 * (tq - 1) : 2 * tq);
        atomic_add4(dv + (size_t)t.sm.lo[row] * Dh, mul4(wl, v4));
        if (wh != 0.f) atomic_add4(dv + (size_t)t.sm.hi[row] * Dh, mul4(wh, v4));
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < MTD; ++ii)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float s = dp[ii][h];
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (tq == 0 && islot + ii * MS < nmt)
        part[warp * kChunk + 16 * (islot + ii * MS) + gq + 8 * h] = s;
    }
}

// K8-bf16's dcw = bf16(taps)^T bf16(du) of one staged chunk on the tensor
// cores, into the block's accumulators: a warp owns the 16-column chunks j
// = warp and warp + 16 of A (as attend16_du) and every m-tile of Dh <= 64
// (ldmatrix's transposed loads: taps^T the A operand, du the B operand)
__device__ __forceinline__ void attend16_dcw(const Attend16& t, int m0, int nmt,
                                             float (&dcw)[4][2][2][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rsel = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int j = warp + kWarps * jj;
    if (j >= t.g.ka) break;
    for (int kt = 0; kt < nmt; ++kt) {
      const uint4 bq = ldsm4<true>(t.du + (size_t)(16 * kt + rsel) * t.g.ldu + 16 * j +
                                   (lane >> 4) * 8);
      const __nv_bfloat16* ap = t.taps + (size_t)(m0 + 16 * kt + (lane >> 4) * 8 + (lane & 7)) *
                                             t.g.ldt + ((lane >> 3) & 1) * 8;
#pragma unroll
      for (int dm = 0; dm < 4; ++dm) {
        if (dm >= t.g.kd) break;
        const uint4 a = ldsm4<true>(ap + 16 * dm);
        mma_bf16_16816(dcw[dm][jj][0], a, bq.x, bq.y);
        mma_bf16_16816(dcw[dm][jj][1], a, bq.z, bq.w);
      }
    }
  }
}

// K8-bf16: K8 in the TPU kernel's product form (see the top of this file),
// a block per SM looping over the (video, query tile) tiles.  kSmall (Dh <=
// 64, A <= 512): the Wc pack in shared memory and dcw summed in the
// block's registers (atomics once a block), else the pack from L2 and the
// chunks' bf16 taps and du rows written out for the GEMM's outer sum
template <bool kSmall>
__global__ void __launch_bounds__(kThreads, 1)
step_bwd16_kernel(StepArgs a, StepGrads o, int B, int QT, int RC) {
  // m-tiles a pass of the scores and of du: one where dcw's accumulators
  // hold 64 registers a thread across the tiles
  constexpr int MT = kSmall ? 1 : 4;
  constexpr int MTD = kSmall ? 1 : 4;   // m-tiles of a warp in the dtaps phase
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, LP = at.LP, HD = H * Dh;
  const int nq = (Q + QT - 1) / QT;
  Attend16 t(at, QT, RC, true, kSmall);
  attend16_pack<kSmall>(t, a.wpack, t.g.pack2());
  const int NR = t.g.NR;
  float *dctx = s + t.L.dctx, *ddot = s + t.L.ddot, *dpos = s + t.L.dpos;
  float *dhvec = s + t.L.dhvec, *dcb = s + t.L.dcb, *daw = s + t.L.daw, *dab = s + t.L.dab;
  const __nv_bfloat16* value16 = static_cast<const __nv_bfloat16*>(a.value16);
  for (int i = tid; i < A; i += kThreads) dcb[i] = daw[i] = 0.f;
  if (tid == 0) dab[0] = 0.f;
  float dcw[4][2][2][4] = {};

  for (int tile = blockIdx.x; tile < B * nq; tile += gridDim.x) {
    const int b = tile / nq, q0 = tile % nq * QT;
    t.value = value16 + (size_t)b * H * S * Dh;
    float* dvalue_b = o.dvalue + (size_t)b * H * S * Dh;
    // d ctx of the tile (zero past Q, so such a query adds exactly 0
    // everywhere)
    for (int i = tid; i < QT * HD; i += kThreads) {
      const int q = i / HD, hd = i % HD;
      dctx[i] = q0 + q < Q ? o.g[(((size_t)b * H + hd / Dh) * Q + q0 + q) * Dh + hd % Dh] : 0.f;
    }
    for (int i = tid; i < QT * A; i += kThreads) dhvec[i] = 0.f;
    attend16_taps(at, t, b, q0, a.pos, a.hvec);
    attend16_softmax<MT, kSmall>(at, t, __ldg(a.ab));

    // d wts = taps . dctx (unrounded taps): lanes along a row's 8-column
    // groups (lpr of them a row, 32 / lpr rows a warp at a time); then
    // ddot = wts (dwts - sum_p wts dwts) per (query, head), d alpha_b its sum
    {
      const int c8 = Dh / 8;
      int lpr = 1;
      while (lpr * 2 <= min(c8, 32)) lpr *= 2;
      const int sub = lane / lpr, cl = lane % lpr, rpw = 32 / lpr;
      for (int r0 = warp * rpw; r0 < NR; r0 += kWarps * rpw) {
        const int row = r0 + sub;
        int q = 0, hh = 0, p = 0;
        float acc = 0.f;
        if (row < NR && t.unpad(row, q, hh, p, LP)) {
          const __nv_bfloat16* v = t.value + (size_t)hh * S * Dh;
          const uint4* vl = reinterpret_cast<const uint4*>(v + (size_t)t.sm.lo[row] * Dh);
          const uint4* vh = reinterpret_cast<const uint4*>(v + (size_t)t.sm.hi[row] * Dh);
          const float* dc = dctx + (size_t)q * HD + hh * Dh;
          const float wl = t.sm.wlo[row], wh = t.sm.whi[row];
          for (int c0 = cl; c0 < c8; c0 += 2 * lpr) {
            uint4 l[2], h[2];
#pragma unroll
            for (int k = 0; k < 2; ++k)
              if (c0 + k * lpr < c8) {
                l[k] = __ldg(vl + c0 + k * lpr);
                h[k] = __ldg(vh + c0 + k * lpr);
              }
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              if (c0 + k * lpr >= c8) break;
              const uint32_t lw[4] = {l[k].x, l[k].y, l[k].z, l[k].w};
              const uint32_t hw[4] = {h[k].x, h[k].y, h[k].z, h[k].w};
              const float* d8 = dc + 8 * (c0 + k * lpr);
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc = fmaf(lerp_tap(wl, bf_lo(lw[e]), wh, bf_lo(hw[e])), d8[2 * e], acc);
                acc = fmaf(lerp_tap(wl, bf_hi(lw[e]), wh, bf_hi(hw[e])), d8[2 * e + 1], acc);
              }
            }
          }
        }
        for (int off = lpr / 2; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (row < NR && cl == 0) ddot[row] = acc;
      }
    }
    __syncthreads();
    for (int gi = tid; gi < QT * H; gi += kThreads) {
      const int r0 = gi / H * t.g.RQ + gi % H * LP;
      float sum = 0.f;
      for (int p = 0; p < LP; ++p) sum += t.d[r0 + p] * ddot[r0 + p];
      float tot = 0.f;
      for (int p = 0; p < LP; ++p) {
        const float dd = t.d[r0 + p] * (ddot[r0 + p] - sum);
        ddot[r0 + p] = dd;
        tot += dd;
      }
      atomicAdd(dab, tot);
    }
    for (int row = tid; row < NR; row += kThreads)
      if (row % t.g.RQ >= t.g.HLP) ddot[row] = 0.f;
    __syncthreads();

    // the chunks: du (and its sums), then dtaps (dpos's terms, dvalue) and
    // dcw's products; dpos of a chunk is reduced in the next one
    int prev = -1;
    for (int m0 = 0; m0 < NR; m0 += RC) {
      const int rows = min(RC, NR - m0), nmt = rows / 16;
      float* part = t.part + (m0 / RC % 2) * kWarps * kChunk;
      for (int i = tid; i < kWarps * kChunk; i += kThreads) part[i] = 0.f;
      if (prev >= 0)
        reduce_part(t.part + (prev / RC % 2) * kWarps * kChunk, kChunk, dpos, prev,
                    min(RC, NR - prev), 0.f);
      __syncthreads();
      attend16_du<MT, kSmall>(at, t, m0, nmt, ddot, dhvec, dcb, daw);
      __syncthreads();
      attend16_dtaps<MTD, kSmall>(at, t, m0, nmt, q0, dctx, part, dvalue_b);
      if constexpr (kSmall) {
        attend16_dcw(t, m0, nmt, dcw);
      } else {
        // the chunk's rows of bf16(taps) and bf16(du) for the outer sum
        const int ct = Dh / 8, cu = A / 8;
        for (int i = tid; i < rows * (ct + cu); i += kThreads) {
          const int r = i / (ct + cu), c = i % (ct + cu);
          int q, hh, p;
          if (!t.unpad(m0 + r, q, hh, p, LP) || q0 + q >= Q) continue;
          const size_t grow = (((size_t)b * Q + q0 + q) * H + hh) * LP + p;
          if (c < ct)
            reinterpret_cast<uint4*>(o.rows_t)[grow * ct + c] =
                *reinterpret_cast<const uint4*>(t.taps + (size_t)(m0 + r) * t.g.ldt + 8 * c);
          else
            reinterpret_cast<uint4*>(o.rows_u)[grow * cu + c - ct] =
                *reinterpret_cast<const uint4*>(t.du + (size_t)r * t.g.ldu + 8 * (c - ct));
        }
      }
      __syncthreads();
      prev = m0;
    }
    reduce_part(t.part + (prev / RC % 2) * kWarps * kChunk, kChunk, dpos, prev,
                min(RC, NR - prev), 0.f);
    __syncthreads();

    // the tile's dpos and dhvec (unrounded)
    for (int row = tid; row < NR; row += kThreads) {
      int q, hh, p;
      if (t.unpad(row, q, hh, p, LP) && q0 + q < Q)
        o.dpos[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] = dpos[row];
    }
    for (int i = tid; i < QT * A; i += kThreads)
      if (q0 + i / A < Q) o.dhvec[((size_t)b * Q + q0) * A + i] = dhvec[i];
    __syncthreads();   // before the next tile's dctx, dhvec and table
  }

  // the block's dcb, d alpha_w, d alpha_b and dcw, added with atomics
  for (int c = 4 * tid; c < A; c += 4 * kThreads) {
    atomic_add4(o.dcb + c, ld4(dcb + c));
    atomic_add4(o.daw + c, ld4(daw + c));
  }
  if (tid == 0) atomicAdd(o.dab, dab[0]);
  if constexpr (kSmall) {
    const int gq = lane >> 2, tq = lane & 3;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int j = warp + kWarps * jj;
      if (j >= t.g.ka) break;
#pragma unroll
      for (int dm = 0; dm < 4; ++dm) {
        if (dm >= t.g.kd) break;
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            atomicAdd(reinterpret_cast<float2*>(o.dcw + (size_t)(16 * dm + gq + 8 * h) * A +
                                                16 * j + 8 * nt + 2 * tq),
                      make_float2(dcw[dm][jj][nt][2 * h], dcw[dm][jj][nt][2 * h + 1]));
      }
    }
  }
}

// shared memory of K10: h, hvec, ctx (then dhvec) and dctx of the tile (QT
// rows each), its staged dz (QT, 4R; in K10-bf16 (b16) x = [h | ctx], then
// dz, in bf16: QT rows of GateGeom::ldx and lddz), tap table, softmax
// weights, d wts and dpos
struct LstmBwdLayout {
  int h, hvec, cx, dctx, dz, wlo, whi, d, ddot, dpos, dab;  // float offsets
  int lo, hi;                                              // int offsets
  int floats, ints;
  __host__ __device__ LstmBwdLayout(int QT, int R, int A, int HD, int NR, bool b16) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    const GateGeom gg(R, HD);
    int o = 0;
    h = o;    o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    cx = o;   o += QT * CX;
    dctx = o; o += QT * pad4(HD);
    dz = o;   o += b16 ? pad4((QT * (gg.ldx + gg.lddz) + 1) / 2) : QT * 4 * R;
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
// and incoming (gh, gc), with the scores and du from the table VW.  B16:
// K10-bf16's body, its gates on the tensor cores (gates_bwd_bf16: the
// recompute from the packed P^T, the cell backward on the accumulators, [dh
// | dctx] = dz P from P's half); the f32 body compiles none of that
template <int QT, bool B16>
__device__ __forceinline__ void lstm_bwd_step(const StepArgs& a, const StepGrads& o,
                                              const float* __restrict__ vw) {
  static_assert(kWarps % QT == 0, "warps per query");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * QT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, R = at.R;
  const int HD = H * Dh, R4 = 4 * R, ldHD = pad4(HD);
  const LstmBwdLayout L(QT, R, A, HD, QT * H * at.LP, B16);
  const GateGeom gg(R, HD);
  float* cx_s = smem + L.cx;
  float* dz_s = smem + L.dz;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(dz_s);  // K10-bf16's staged x
  __nv_bfloat16* dzb = xb + QT * gg.ldx;                       // and dz
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
    if (q0 + q < Q)
      store_row(o.ctx_all, ((size_t)b * Q + q0 + q) * HD + hd, cx_s[q * ldHD + hd], at.bf16);
  }

  // ---- gates and the LSTM cell backward with the given (gh, gc): a query
  //      past Q gets zero cotangents, so its dz (hence its d ctx and every
  //      gradient it adds) is exactly 0; dz is written out and staged as
  //      (QT, 4R).  K10-bf16: all of it and dz W^T below on the tensor
  //      cores, dh written out and d ctx into gs.dctx
  if constexpr (B16)
    gates_bwd_bf16<QT>(
        a.wpack, gg, sm.h, pad4(R), cx_s, ldHD, xb, dzb,
        [&](int qi, int u, int gate) {
          return a.z0[((size_t)b * Q + min(q0 + qi, Q - 1)) * R4 + gate * R + u];
        },
        [&](int qi, int u, float& c_prev, float& gh, float& gc) {
          const bool valid = q0 + qi < Q;
          const size_t row = (size_t)b * Q + min(q0 + qi, Q - 1);
          c_prev = a.c[row * R + u];
          gh = valid ? o.gh[row * R + u] : 0.f;
          gc = valid ? o.gc[row * R + u] : 0.f;
        },
        [&](int qi, int u, float dc_prev, const float (&dz)[4]) {
          if (q0 + qi >= Q) return;
          const size_t row = (size_t)b * Q + q0 + qi;
#pragma unroll
          for (int gt = 0; gt < 4; ++gt) o.dz0[row * R4 + gt * R + u] = dz[gt];
          o.dc[row * R + u] = dc_prev;
        },
        [&](int qi, int k, float v) {
          if (k >= R) gs.dctx[qi * ldHD + k - R] = v;
          else if (q0 + qi < Q) o.dh[((size_t)b * Q + q0 + qi) * R + k] = v;
        });
  for (int r = tid; !B16 && r < R; r += kThreads) {
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
        dz_s[q * R4 + g * R + r] = dzg[g];
        if (valid) o.dz0[row * R4 + g * R + r] = dzg[g];
      }
      if (valid) o.dc[row * R + r] = dc_prev;
    }
  }
  __syncthreads();

  // ---- dh = dz W_hh^T (the kernel's h input; the h -> hvec, pos chain is
  //      outside) and d ctx = dz ctx_w3^T
  if (!B16) {
    gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
      if (u >= R) gs.dctx[q * ldHD + u - R] = v;
      else if (q0 + q < Q) o.dh[((size_t)b * Q + q0 + q) * R + u] = v;
    });
    __syncthreads();
  }

  // ---- attention and sampling backward with g = d ctx, from the table
  attend_backward_table<QT>(at, sm, gs, value_b, vw_b, o.dvalue + (size_t)b * H * S * Dh,
                            o.G + (size_t)b * H * S * A, cols, dcb, daw);
  store_table_grads<QT>(at, gs, cols, dcb, daw, b, q0, o);
}

template <int QT>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(StepArgs a, StepGrads o, const float* __restrict__ vw) {
  lstm_bwd_step<QT, false>(a, o, vw);
}

// K10-bf16: one block an SM, as K9-bf16
template <int QT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd16_kernel(StepArgs a, StepGrads o, const float* __restrict__ vw) {
  lstm_bwd_step<QT, true>(a, o, vw);
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

// the limits of K7-bf16 and K8-bf16: value16 and the Wc pack given and
// 16-byte aligned, no VW, A and Dh whole k-tiles of 16, cb and aw 8-byte
// aligned (read as float2)
bool attend16_limits(const void* value16, const float* vw, const void* wpack, int A, int Dh,
                     const float* cb, const float* aw) {
  return packed_operand(value16) && packed_operand(wpack) && vw == nullptr && A % 16 == 0 &&
         Dh % 16 == 0 && A > 0 && Dh > 0 && reinterpret_cast<size_t>(cb) % 8 == 0 &&
         reinterpret_cast<size_t>(aw) % 8 == 0;
}

// Dh <= 64 and A <= 512 (cap_nheads 8 at A = 512): K7-bf16 and K8-bf16 keep
// the Wc pack in shared memory and K8-bf16 sums dcw in its registers
bool attend16_small(int Dh, int A) { return Dh <= 64 && A <= 512; }

// the launch of K7-bf16 or K8-bf16: its query tile (a whole 64-row chunk
// of tap rows, at least 2 queries; halved while the tiles would not fill
// the SMs (B = 1) or the block's shared memory, smem bytes, would not
// fit), its chunk (K8-bf16 with the pack resident: 32 rows, else 64), and
// a grid of at most one block an SM, each looping over tiles
struct Attend16Plan {
  int QT, RC, grid;
  size_t smem;
};

Attend16Plan attend16_plan(int B, int Q, int H, int LP, int Dh, int A, bool bwd) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const bool small = attend16_small(Dh, A);
  Attend16Plan p;
  p.RC = bwd && small ? 32 : kChunk;
  const int RQ = (H * LP + 15) / 16 * 16;
  int QT = std::max(2, (kChunk + RQ - 1) / RQ);
  while (QT > 1 && (size_t)B * ((Q + QT - 1) / QT) < (size_t)sms) QT /= 2;
  for (;;) {
    p.smem = Attend16Layout(Attend16Geom(QT, p.RC, H, LP, Dh, A), H * Dh, bwd, small).bytes;
    if (QT == 1 || p.smem <= (size_t)optin) break;
    QT /= 2;
  }
  p.QT = QT;
  p.grid = (int)std::min((size_t)B * ((Q + QT - 1) / QT), (size_t)sms);
  return p;
}

}  // namespace

// Shapes as in the JAX kernels' operands (dvc_tpu/ops/dsa_step.py): value_t
// (B, H, S, Dh), pos (B, H, Q, LP) level-relative, hvec (B, Q, A), cb (A),
// aw (A), ab one float in device memory, and in place of the JAX kernels' cw
// (Dh, A) the table vw (B, H, S, A) = value_t . cw.  All f32, contiguous, on
// the current device; shapes is a host array of the L level lengths.  bf16
// != 0: the bf16-operand mode (K7-K10-bf16, see the top of this file): K7
// and K8 take value_t in bf16 (value16), no vw and in its place wpack, the
// Wc pack (ops/dsa_step.py::pack_attend_weights); K9 and K10 value_t, ctx_w3
// and w_hh given rounded to bf16 and vw the table of the bf16 mode
// (dvc_dsa_table_gemm's bf16).  Each entry point returns cudaGetLastError()
// of its launches, or cudaErrorInvalidValue for shapes it does not take.
//
// K7: ctx (B, H, Q, Dh) is written.  f32: A <= 512, A and Dh multiples of 4;
// vw, cb and aw 16-byte aligned (read as float4); wpack null.  bf16
// (K7-bf16): value_t the bf16 value16 and wpack, both 16-byte aligned, vw
// null, A and Dh multiples of 16, cb and aw 8-byte aligned.
extern "C" int dvc_dsa_step_fwd(
    const void* value_t, const float* vw, const void* wpack, const float* pos,
    const float* hvec, const float* cb, const float* aw, const float* ab, const int* shapes,
    float* ctx, int B, int H, int S, int Dh, int Q, int LP, int L, int A,
    int bf16, void* stream) {
  StepArgs a;
  const bool b16 = bf16 != 0;
  const float* value32 = b16 ? nullptr : static_cast<const float*>(value_t);
  if (!fill_step(&a, value32, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L, A, 0, bf16) ||
      (b16 ? !attend16_limits(value_t, vw, wpack, A, Dh, cb, aw)
           : !table_limits(A, Dh, {vw, cb, aw}) || wpack != nullptr))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (b16) {
    a.value16 = value_t;
    a.wpack = static_cast<const uint4*>(wpack);
    const Attend16Plan p = attend16_plan(B, Q, H, LP, Dh, A, false);
    const auto kernel = attend16_small(Dh, A) ? step_fwd16_kernel<true>
                                              : step_fwd16_kernel<false>;
    const cudaError_t e = set_smem(kernel, p.smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<p.grid, kThreads, p.smem, st>>>(a, B, p.QT, p.RC, ctx);
    return (int)cudaGetLastError();
  }
  // no weight product to share, so the most blocks: 2 or 4 queries where
  // that grid fits half the SMs (B = 1), 4 where 8-query tiles would take
  // more than a wave (B = 16), else 8
  const int QT = query_tile(B, Q, 2, 4);
  const size_t smem = ForwardLayout(QT, 0, A, H * Dh, QT * H * LP).bytes();
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
// its operands.  f32 (K8): dvalue (B, H, S, Dh), the context's term only (the
// scores' reach value through vw), and G (B, H, S, A) = dL/dvw, both zeroed
// by the caller with dcb (A), daw (A) and dab (1) (atomics); dpos (B, H, Q,
// LP) and dhvec (B, Q, A) fully written; A <= 512, A and Dh multiples of 4,
// value_t, vw, cb and aw 16-byte aligned (read as float4); wpack, dcw,
// rows_t, rows_u and work null.  bf16 (K8-bf16, operands as K7-bf16's): the
// JAX kernel's seven gradients, the whole dvalue and dcw (Dh, A) in place of
// G (null), dvalue, dcw, dcb, daw and dab zeroed by the caller.  dcw is
// summed in the blocks (atomics) where Dh <= 64 and A <= 512 and rows_t is
// null; else rows_t and rows_u take the bf16 rows of the taps and of du
// (B*Q*H*LP rows of Dh and A) and the GEMM's outer sum dcw = rows_t^T rows_u
// runs on work (work_floats floats, its split-K partial tiles) after the
// kernel.
extern "C" int dvc_dsa_step_bwd(
    const void* value_t, const float* vw, const void* wpack, const float* pos,
    const float* hvec, const float* cb, const float* aw, const float* ab, const float* g,
    const int* shapes, float* dvalue, float* G, float* dpos, float* dhvec, float* dcw,
    float* dcb, float* daw, float* dab, void* rows_t, void* rows_u, float* work, int B,
    int H, int S, int Dh, int Q, int LP, int L, int A, int work_floats, int bf16,
    void* stream) {
  StepArgs a;
  const bool b16 = bf16 != 0, gemm = rows_t != nullptr;
  const float* value32 = b16 ? nullptr : static_cast<const float*>(value_t);
  if (!fill_step(&a, value32, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L, A, 0, bf16) ||
      (b16 ? !attend16_limits(value_t, vw, wpack, A, Dh, cb, aw) || G != nullptr ||
                 dcw == nullptr ||
                 gemm == attend16_small(Dh, A) || (gemm && (rows_u == nullptr || work == nullptr))
           : !table_limits(A, Dh, {value32, vw, cb, aw}) || wpack != nullptr ||
                 dcw != nullptr || gemm))
    return (int)cudaErrorInvalidValue;
  if (B == 0 || Q == 0) return 0;
  StepGrads o{};
  o.g = g; o.dvalue = dvalue; o.G = G; o.dpos = dpos; o.dhvec = dhvec;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  o.dcw = dcw; o.rows_t = rows_t; o.rows_u = rows_u;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = cudaSuccess;
  if (b16) {
    a.value16 = value_t;
    a.wpack = static_cast<const uint4*>(wpack);
    const Attend16Plan p = attend16_plan(B, Q, H, LP, Dh, A, true);
    const auto kernel = gemm ? step_bwd16_kernel<false> : step_bwd16_kernel<true>;
    if ((e = set_smem(kernel, p.smem)) != cudaSuccess) return (int)e;
    kernel<<<p.grid, kThreads, p.smem, st>>>(a, o, B, p.QT, p.RC);
    if ((e = cudaGetLastError()) != cudaSuccess || !gemm) return (int)e;
    return (int)outer_sum16(op16(rows_t, Dh), op16(rows_u, A), B * Q * H * LP, Dh, A, dcw, st,
                            work, work_floats > 0 ? (size_t)work_floats : 0);
  }
  // at most 8 queries a tile: a warp of the score backward owns a (query,
  // column part), and A <= 512 needs two parts
  const int QT = query_tile(B, Q, 2, kQT);
  const size_t smem = TableBwdLayout(QT, A, H * Dh, QT * H * LP).bytes();
  e = QT == 2 ? set_smem(step_bwd_kernel<2>, smem)
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

// 1 where K8-bf16 sums dcw through bf16 rows of the taps and of du and the
// GEMM's outer sum (dvc_dsa_step_bwd's rows_t, rows_u and work given),
// else 0 (dcw summed in its blocks): its rule's one home
extern "C" int dvc_dsa_step_dcw_rows(int Dh, int A) { return attend16_small(Dh, A) ? 0 : 1; }

// K9: as dvc_dsa_step_fwd, plus z0 (B, Q, 4R), h and c (B, Q, R), ctx_w3 (H*Dh, 4R)
// and w_hh (R, 4R); h_new and c_new (B, Q, R) are written.  A <= 512; A,
// Dh and R multiples of 4.  bf16: K9-bf16, with wpack the gate weights
// packed in bf16 (ops/dsa_scan.py::pack_gate_weights, of which it reads P^T's
// half; 16-byte aligned) and ctx_w3 and w_hh unread (may be null); in f32
// wpack must be null.
extern "C" int dvc_dsa_lstm_fwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* z0, const float* h, const float* c, const float* ctx_w3,
    const float* w_hh, const void* wpack, const float* cb, const float* aw,
    const float* ab, const int* shapes, float* h_new, float* c_new, int B, int H,
    int S, int Dh, int Q, int LP, int L, int A, int R, int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, R, bf16) ||
      !table_limits(A, Dh, {}) || R % 4 != 0 ||
      (a.at.bf16 ? !packed_operand(wpack) : wpack != nullptr))
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  a.wpack = static_cast<const uint4*>(wpack);
  if (B == 0 || Q == 0) return 0;
  // as K4: 4 queries at least, 16 where 8-query tiles would take more than
  // a wave
  const int QT = query_tile(B, Q, 4, 16);
  const bool b16 = a.at.bf16;
  const size_t smem = ForwardLayout(QT, R, A, H * Dh, QT * H * LP, b16).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  const auto kernel = b16 ? (QT == 4    ? lstm_fwd16_kernel<4>
                             : QT == 16 ? lstm_fwd16_kernel<16>
                                        : lstm_fwd16_kernel<kQT>)
                          : (QT == 4    ? lstm_fwd_kernel<4>
                             : QT == 16 ? lstm_fwd_kernel<16>
                                        : lstm_fwd_kernel<kQT>);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((Q + QT - 1) / QT, B), kThreads, smem, st>>>(a, vw, h_new, c_new);
  return (int)cudaGetLastError();
}

// K9's gradients for the cotangents gh, gc (B, Q, R) of (h_new, c_new),
// with respect to its operands: dvalue (B, H, S, Dh), the context's term
// only (the scores' reach value through vw), and G (B, H, S, A) = dL/dvw,
// both zeroed by the caller with dcb, daw and dab; dpos, dhvec, dz0
// (B, Q, 4R), dh, dc (B, Q, R), dctx_w3 (H*Dh, 4R) and dwhh (R, 4R) fully
// written; scratch ctx_all (B, Q, H*Dh; bf16 in the bf16 mode) and work (work_floats floats, the
// outer sums' split-K partial tiles).  A <= 512; A, Dh and R multiples of
// 4; value_t, vw, cb, aw, ctx_w3 and w_hh 16-byte aligned (read as float4).
// bf16: K10-bf16, with wpack as for dvc_dsa_lstm_fwd (both halves read)
// and ctx_w3 and w_hh unread (may be null); in f32 wpack must be null.
extern "C" int dvc_dsa_lstm_bwd(
    const float* value_t, const float* vw, const float* pos, const float* hvec,
    const float* z0, const float* h, const float* c, const float* ctx_w3,
    const float* w_hh, const void* wpack, const float* cb, const float* aw,
    const float* ab, const float* gh, const float* gc, const int* shapes, float* dvalue,
    float* G, float* dpos, float* dhvec, float* dz0, float* dh, float* dc,
    float* dctx_w3, float* dwhh, float* dcb, float* daw, float* dab,
    void* ctx_all, float* work, int B, int H, int S, int Dh, int Q, int LP,
    int L, int A, int R, int work_floats, int bf16, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cb, aw, ab, shapes, H, S, Dh, Q, LP, L,
                 A, R, bf16) ||
      !table_limits(A, Dh, {value_t, vw, cb, aw, ctx_w3, w_hh}) || R % 4 != 0 ||
      (a.at.bf16 ? !packed_operand(wpack) : wpack != nullptr))
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  a.wpack = static_cast<const uint4*>(wpack);
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
    // (query, column part)), 2 or 4 on a small grid; the layout's bytes
    // (K10-bf16's staged x and dz included) checked by set_smem
    const int QT = query_tile(B, Q, 2, kQT);
    const bool b16 = a.at.bf16;
    const size_t smem = LstmBwdLayout(QT, R, A, HD, QT * H * LP, b16).bytes();
    const auto kernel = b16 ? (QT == 2   ? lstm_bwd16_kernel<2>
                               : QT == 4 ? lstm_bwd16_kernel<4>
                                         : lstm_bwd16_kernel<kQT>)
                            : (QT == 2   ? lstm_bwd_kernel<2>
                               : QT == 4 ? lstm_bwd_kernel<4>
                                         : lstm_bwd_kernel<kQT>);
    if ((e = set_smem(kernel, smem)) != cudaSuccess) return (int)e;
    kernel<<<dim3((Q + QT - 1) / QT, B), kThreads, smem, st>>>(a, o, vw);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  if (a.at.bf16) {
    // h and dz0 f32, rounded by the GEMM's producer; ctx_all written in bf16
    if ((e = outer_sum16(op16(h, R, true), op16(dz0, 4 * R, true), N, R, 4 * R, dwhh, st,
                         work, wf)) != cudaSuccess)
      return (int)e;
    return (int)outer_sum16(op16(ctx_all, HD), op16(dz0, 4 * R, true), N, HD, 4 * R,
                            dctx_w3, st, work, wf);
  }
  const float* cx = static_cast<const float*>(ctx_all);
  if ((e = outer_sum(h, R, dz0, 4 * R, N, R, 4 * R, dwhh, st, work, wf)) != cudaSuccess)
    return (int)e;
  return (int)outer_sum(cx, HD, dz0, 4 * R, N, HD, 4 * R, dctx_w3, st, work, wf);
}
