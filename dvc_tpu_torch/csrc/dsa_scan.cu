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
// (b, a tile of QT queries) and loops over the K steps with h, c, hvec, ctx
// and the tap table in shared memory, as the greedy kernel does.  The launch
// first builds the per-video table VW = value_t Wc (B, H, S, A) (see below),
// so a step's scores cost 2A loads and A tanh per tap row
// (attend_scores_table) and no Dh x A product.  The host picks the tile from
// B, Q and the SM count (query_tile): 4 queries where that grid fits half
// the SMs (a B = 1 step: 23 blocks), 16 where 8-query tiles would take more
// than a wave (B = 16: 96 blocks), else 8.
//
// Backward replaces `_make_scan_bwd_kernel` (same file), the reverse-time
// scan.  One block per (b, query tile) walks k from K-1 down to 0 (8
// queries a tile where that grid fills the card; on a small grid, such as
// a B=1 step's, tiles of 2 or 4 queries spread the scan over more SMs): it
// recomputes step k's attention and gates from (h_{k-1}, c_{k-1}) (the
// caller passes hs and cs shifted by one step, zeros first), carries dh and
// dc in shared memory, and writes dz.  The launch first builds the per-video
// table VW = value_t Wc (B, H, S, A) with the 3xTF32 GEMM of dsa_gemm.cuh:
// a tap is a lerp of two value rows, so taps Wc is the same lerp of two VW
// rows, and the scores are recomputed from it (attend_scores_table, then
// again per (query, column half) in attend_backward_table to form
// du = ddot * alpha_w * (1 - tanh^2)), with no Dh x A product per tap.  What
// a block cannot own is scattered with float4 atomics: dvalue's context
// term (the lerp-scatter of wts * dctx; shared by every query tile of a
// video) and G = the lerp-scatter of du onto the value rows.  The scores'
// term of dvalue, du Wc^T scattered the same way, equals G Wc^T: one GEMM
// per launch after the scan, and dpos takes it as (VW[hi] - VW[lo]) . du.
// dbase and dscale belong to one block.  The per-step rows that the weight
// gradients need (h_{k-1}, dz, ctx, dhvec, doff) are written out, and the
// same GEMM reduces them (split along the rows into fixed chunks added in
// order, so deterministic):
//
//   dW_hh = h_prev^T dz    dctx_w3 = ctx^T dz    dh2att_w = h_prev^T dhvec
//   doff_w = h_prev^T doff    dWc = value^T G     (sums over rows b, k, q)
//
// dcb = dh2att_b and daw are per-lane partial sums kept in registers for the
// whole scan, dab a per-block one, each added with atomics at the end.
//
// Bound on this card: the per-step products (the gates' recompute h W_hh,
// ctx ctx_w3 and their transposes dz W_hh^T, dz ctx_w3^T; in f32 a thread
// per two output units with the activations broadcast from shared memory)
// read their weights (4 MB each at R = 512 in f32) from L2, so L2
// bandwidth and (f32) the FP32 issue rate bound them.  dvalue, G (so dWc) and the atomically summed
// vectors vary by a few ulps from run to run; the GEMMs are deterministic.
// The same products bound the forward, once per step.  The cell backward
// lives in dsa_common.cuh, shared with the word-step backward K10 of
// dsa_step.cu.
//
// K4-bf16 and K5-bf16 (bf16 != 0, --tpu_compute_dtype bfloat16) are the
// kernels in the bf16-operand mode of dsa_common.cuh (K4-bf16 the forward's
// bf16 instantiation, B16): the TPU kernels' bf16 variants round both
// operands of every product of the step and of its backward (the
// transposed products and the weight gradients' outer sums included) to
// bf16 and accumulate in f32 (_make_dot('bfloat16')).  The wrapper passes
// value rounded (f32 for the attention, bf16 for the GEMMs) and the step's
// other weights rounded; every GEMM here runs dsa::gemm's bf16 mode on
// bf16 operands (value, cw, and in the backward h_{k-1} (hs_prev, made in
// bf16 by the wrapper), the rows that K5-bf16 writes in bf16 for the outer
// sums (dz16, ctx_all, dhvec_all, doff_all) and G, summed in f32 and
// rounded once after the scan into the table's storage); the activations
// that the step's products read are stored rounded (h, ctx; in the
// backward dz, dhvec and doff); hs, cs and dz are written in f32.
//
// Both run the step's large products on the tensor cores (the layout in
// dsa_common.cuh, GateGeom, HiddenGeom) as mma.sync.m16n8k16 (bf16 in, f32
// accumulate) with the tile's queries the n side and the weights the
// 16-row A operand, packed once a launch in bf16 in fragment order: P =
// [W_hh; ctx_w3] (ops/dsa_scan.py::pack_gate_weights, 8 MB at R = H*Dh =
// 512: P^T's tiles, then P's) and W_h2att^T (pack_hidden_weights, 0.5 MB).
// DSATeacherScanFunction packs both once in the forward and hands the same
// tensors to the backward.  K4-bf16 (gates_fwd_bf16): hvec = h W_h2att
// (attend_hvec_mma) and z = z_all + [h | ctx] P from P^T's half, with the
// LSTM cell on the accumulators; at 16 queries (B = 16) each A fragment
// feeds two n8 tiles, so a block reads 4.5 MB of weights a step where the
// f32 mode reads 9 MB through FMAs on the CUDA cores.  x = [h | ctx] is
// staged in bf16 in the next h's room (the cell writes the new h in
// place): 205,056 bytes at 16 queries and H=8.  K5-bf16 (gates_bwd_bf16,
// shared with the word step's K10-bf16):
// the same hvec and recompute, so its recompute sums the same products in
// the same order as K4-bf16's forward and reproduces it bit for bit; the
// cell backward on the accumulators; [dh | dctx] = dz P^T from P's half.
// Its tiles hold at most 8 queries (at B = 1, 2 or 4: 75% or 50% of the n8
// columns are padding); x and dz are staged in bf16 in place of the f32
// dz tile (49,408 bytes for 65,536 at QT = 8, R = A = H*Dh = 512).  A
// 16-query tile would halve its weight reads but does not fit: the score
// backward's warps own a (query, column part), 8 queries at A = 512.
//
// The table form moves rounding points:
// the scores are a lerp of two rows of bf16(v) . bf16(Wc) where the TPU
// kernel rounds the lerped taps before its product with Wc, and the
// backward forms dvalue's scores term as bf16(G) . bf16(Wc)^T and dWc as
// bf16(value)^T bf16(G), G the lerp-scatter of bf16(du), where the TPU
// kernel rounds the taps and their gradients (measured in
// tests/test_torch_bf16_kernels.py and chip_smoke.py --bf16).  Shared
// memory at R = A = 512, LP = 16: the backward's block of 8 queries
// 167,440 bytes at cap_nheads 1 and 192,528 at cap_nheads 8 in f32 (16,128
// fewer in bf16), the forward's of 16 queries 168,960 and 204,800 (256
// more in bf16; the card allows 232,448).  Limits of the backward: A <= 512
// (two float4 column groups per lane and column half), A, Dh and R
// multiples of 4; of both, the shared memory of a block (checked at
// launch).

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
  const uint4* wpack;   // K4/K5-bf16: [W_hh; ctx_w3] packed in bf16 (GateGeom)
  const float* ab;      // (1)
  int B, K;
};

// ----------------------------------------------------------------------------
// forward
// ----------------------------------------------------------------------------

// shared memory of the forward: h, the next h, c, hvec and ctx of the tile
// (QT rows each) and its tap table; in the bf16 mode (b16) the next h's
// room holds the staged x = [h | ctx] in bf16 instead (QT rows of
// GateGeom::ldx), since the cell writes the new h in place
struct ForwardLayout {
  int h, hn, c, hvec, ctx, wlo, whi, d;  // float offsets
  int lo, hi;                            // int offsets
  int floats, ints;
  __host__ __device__ ForwardLayout(int QT, int R, int A, int HD, int NR, bool b16) {
    int o = 0;
    h = o;    o += QT * pad4(R);
    hn = o;   o += b16 ? pad4(QT * GateGeom(R, HD).ldx / 2) : QT * pad4(R);
    c = o;    o += QT * pad4(R);
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

// B16: K4-bf16's instantiation (the bf16-operand mode with its products on
// the tensor cores); the f32 one compiles none of that in.  One block an
// SM, as its shared memory allows: without that minimum ptxas gives the
// bf16 instantiations 64-116 registers (spilling at 8 queries), too few to
// keep the mma loops' A fragments in flight (1.35x slower at B = 16)
template <int QT, bool B16>
__global__ void __launch_bounds__(kThreads, 1)
scan_fwd_kernel(ScanArgs a, const float* __restrict__ vw, float* __restrict__ hs,
                float* __restrict__ cs) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh, Q = at.Q;
  const int HD = H * Dh, R4 = 4 * R, NR = QT * H * at.LP;
  const int ldR = pad4(R), ldHD = pad4(HD);
  const ForwardLayout L(QT, R, A, HD, NR, B16);
  const GateGeom gg(R, HD);
  float* hn_s = smem + L.hn;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(hn_s);  // the bf16 mode's x
  float* c_s = smem + L.c;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = smem + L.ctx;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;

  // queries past the end of the ragged last tile compute on a copy of the
  // last query and write nothing
  int qg[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) qg[q] = min(q0 + q, Q - 1);

  for (int i = tid; i < QT * ldR; i += kThreads) { sm.h[i] = 0.f; c_s[i] = 0.f; }
  __syncthreads();

  const float* value_b = at.value + (size_t)b * H * at.S * Dh;
  const float* vw_b = vw + (size_t)b * H * at.S * A;
  const float ab = __ldg(a.ab);

  for (int k = 0; k < a.K; ++k) {
    // ---- hvec (K4-bf16: on the tensor cores) and the tap table from
    //      h_{k-1}; the scores from the table, the softmax over the LP taps
    //      and ctx
    if (B16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);
    attend_hvec_taps<QT>(at, sm, b, q0);
    __syncthreads();
    attend_scores_table<QT>(at, sm, vw_b, ab);
    attend_softmax_ctx<QT>(at, sm, value_b);

    // ---- z = z_all[b, k] + h W_hh + ctx ctx_w3, then the LSTM cell; a
    //      thread owns hidden unit r (its 4 gate columns).  K4-bf16: the
    //      products on the tensor cores and the cell on their accumulators
    //      (gates_fwd_bf16), the new h written in place
    const size_t bk = (size_t)b * a.K + k;
    if (B16)
      gates_fwd_bf16<QT>(
          a.wpack, gg, sm.h, ldR, sm.ctx, ldHD, xb,
          [&](int qi, int u, int gate) {
            return a.z_all[(bk * Q + min(q0 + qi, Q - 1)) * R4 + gate * R + u];
          },
          [&](int qi, int u) { return c_s[qi * ldR + u]; },
          [&](int qi, int u, float h, float c) {
            c_s[qi * ldR + u] = c;
            sm.h[qi * ldR + u] = round_if(true, h);
            if (q0 + qi >= Q) return;
            const size_t o = (bk * Q + q0 + qi) * R + u;
            hs[o] = h;
            cs[o] = c;
          });
    for (int r = tid; !B16 && r < R; r += kThreads) {
      float z[4][QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float* zk = a.z_all + (((size_t)b * a.K + k) * Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = zk[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(sm.ctx, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float c = sigmoidf_(z[1][q]) * c_s[q * ldR + r]
                        + sigmoidf_(z[0][q]) * tanhf(z[2][q]);
        const float h = sigmoidf_(z[3][q]) * tanhf(c);
        c_s[q * ldR + r] = c;
        hn_s[q * ldR + r] = round_if(at.bf16, h);
        if (q0 + q < Q) {
          const size_t o = (((size_t)b * a.K + k) * Q + q0 + q) * R + r;
          hs[o] = h;
          cs[o] = c;
        }
      }
    }
    __syncthreads();
    if (!B16) { float* t = sm.h; sm.h = hn_s; hn_s = t; }
  }
}

// ----------------------------------------------------------------------------
// backward
// ----------------------------------------------------------------------------

// the rows that K5 writes for the outer sums (ctx_all, dhvec_all,
// doff_all; in the bf16 mode also dz16) are bf16 in the bf16 mode, else
// f32, as hs_prev is read
struct BwdOut {
  const void* hs_prev;   // (B, K, Q, R) h_{k-1}, zeros at k = 0
  const float* cs_prev;  // (B, K, Q, R)
  const float* g;        // (B, K, Q, R) cotangent of hs
  const float* vw;       // (B, H, S, A)    the table value . Wc
  float* dvalue;         // (B, H, S, Dh)   zeroed; atomics
  float* G;              // (B, H, S, A)    zeroed; atomics
  float* dbase;          // (B, H, Q, LP)   zeroed; block-owned
  float* dscale;         // (B, Q, LP)      zeroed; block-owned
  float* dz;             // (B, K, Q, 4R)
  void* dz16;            // (B, K, Q, 4R)   bf16 copy of dz (the bf16 mode)
  void* ctx_all;         // (B, K, Q, H*Dh) rows for dctx_w3
  void* dhvec_all;       // (B, K, Q, A)    rows for dh2att_w
  void* doff_all;        // (B, K, Q, H*LP) rows for doff_w
  float* dcb;            // (A)             zeroed; atomics
  float* daw;            // (A)             zeroed; atomics
  float* dab;            // (1)             zeroed; atomics
};

struct BwdLayout {
  int h, dh, dc, hvec, cx, dctx, dz;          // float offsets
  int wlo, whi, d, ddot, dpos, dab;
  int lo, hi;                                 // int offsets
  int floats, ints;
  __host__ __device__ BwdLayout(int QT, int R, int A, int HD, int NR, bool b16) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    const GateGeom gg(R, HD);
    int o = 0;
    h = o;    o += QT * pad4(R);
    dh = o;   o += QT * pad4(R);
    dc = o;   o += QT * pad4(R);
    hvec = o; o += QT * pad4(A);
    cx = o;   o += QT * CX;          // ctx, then dhvec
    dctx = o; o += QT * pad4(HD);
    dz = o;                          // staged dz (QT, 4R) f32; bf16 mode:
    o += b16 ? pad4((QT * (gg.ldx + gg.lddz) + 1) / 2)  // x, then dz, bf16
             : QT * 4 * R;
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);          // softmax weights, then dpos * offset
    ddot = o; o += pad4(NR);          // dwts, then ddot, then doff
    dpos = o; o += pad4(NR);
    dab = o;  o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

template <int QT>
__global__ void __launch_bounds__(kThreads)
scan_bwd_kernel(ScanArgs a, BwdOut o) {
  static_assert(kWarps % QT == 0, "warps per query");
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x;
  const int b = blockIdx.y, q0 = blockIdx.x * QT;
  const int R = at.R, A = at.A, H = at.H, Dh = at.Dh, Q = at.Q, LP = at.LP;
  const int S = at.S, K = a.K;
  const int HD = H * Dh, R4 = 4 * R, HLP = H * LP, NR = QT * HLP;
  const int ldR = pad4(R), ldA = pad4(A), ldHD = pad4(HD);
  const BwdLayout L(QT, R, A, HD, NR, at.bf16);
  const GateGeom gg(R, HD);
  float* dh_s = smem + L.dh;
  float* dc_s = smem + L.dc;
  float* cx_s = smem + L.cx;
  float* dz_s = smem + L.dz;
  __nv_bfloat16* xb = reinterpret_cast<__nv_bfloat16*>(dz_s);  // the bf16 mode's staged
  __nv_bfloat16* dzb = xb + QT * gg.ldx;                       // x and dz
  float* ddot_s = smem + L.ddot;
  float* dpos_s = smem + L.dpos;
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm{};
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = cx_s;
  sm.wlo = smem + L.wlo; sm.whi = smem + L.whi; sm.d = smem + L.d;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  TableGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = cx_s; gs.ddot = ddot_s; gs.dpos = dpos_s;
  gs.dab = smem + L.dab;
  const ColGroups cols(A, kWarps / QT);
  float4 dcb[kColGroups], daw[kColGroups];
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) { dcb[j] = f4(0.f); daw[j] = f4(0.f); }

  // a query past the end of the ragged last tile runs on a copy of the
  // last query with a zero cotangent: every gradient it adds is exactly 0,
  // and it writes no row
  int qg[QT];
#pragma unroll
  for (int q = 0; q < QT; ++q) qg[q] = min(q0 + q, Q - 1);

  for (int i = tid; i < QT * ldR; i += kThreads) { dh_s[i] = 0.f; dc_s[i] = 0.f; }
  if (tid == 0) gs.dab[0] = 0.f;

  const float* value_b = at.value + (size_t)b * H * S * Dh;
  const float* vw_b = o.vw + (size_t)b * H * S * A;
  const float ab = __ldg(a.ab);

  for (int k = K - 1; k >= 0; --k) {
    const size_t bk = (size_t)b * K + k;
    // ---- h_{k-1} of the tile
    for (int i = tid; i < QT * R; i += kThreads) {
      const int q = i / R, r = i % R;
      const size_t src = (bk * Q + qg[q]) * R + r;
      sm.h[q * ldR + r] = at.bf16
          ? __bfloat162float(static_cast<const __nv_bfloat16*>(o.hs_prev)[src])
          : static_cast<const float*>(o.hs_prev)[src];
    }
    __syncthreads();

    // ---- recompute the step's attention: hvec (K5-bf16: on the tensor
    //      cores, as K4-bf16), taps, the scores from the table, softmax
    //      weights, ctx
    if (at.bf16) attend_hvec_mma<QT>(at, sm, xb, gg.ldx);
    attend_hvec_taps<QT>(at, sm, b, q0);
    __syncthreads();
    attend_scores_table<QT>(at, sm, vw_b, ab);
    attend_softmax_ctx<QT>(at, sm, value_b);
    for (int i = tid; i < QT * HD; i += kThreads) {
      const int q = i / HD, hd = i % HD;
      if (q0 + q < Q) store_row(o.ctx_all, (bk * Q + q0 + q) * HD + hd, cx_s[q * ldHD + hd], at.bf16);
    }

    // ---- gates from (h_{k-1}, c_{k-1}) and the LSTM cell backward; dz is
    //      written out and staged in dz_s as (QT, 4R) (K5-bf16: all of it
    //      and dz W^T below on the tensor cores, gates_bwd_bf16)
    if (at.bf16) {
      __nv_bfloat16* dz16 = static_cast<__nv_bfloat16*>(o.dz16);
      gates_bwd_bf16<QT>(
          a.wpack, gg, sm.h, ldR, cx_s, ldHD, xb, dzb,
          [&](int qi, int u, int gate) {
            return a.z_all[(bk * Q + min(q0 + qi, Q - 1)) * R4 + gate * R + u];
          },
          [&](int qi, int u, float& c_prev, float& gh, float& gc) {
            const bool valid = q0 + qi < Q;
            const size_t row = bk * Q + min(q0 + qi, Q - 1);
            c_prev = o.cs_prev[row * R + u];
            gh = valid ? o.g[row * R + u] + dh_s[qi * ldR + u] : 0.f;
            gc = valid ? dc_s[qi * ldR + u] : 0.f;
          },
          [&](int qi, int u, float dc_prev, const float (&dz)[4]) {
            dc_s[qi * ldR + u] = dc_prev;
            if (q0 + qi >= Q) return;
            const size_t row = bk * Q + q0 + qi;
#pragma unroll
            for (int gt = 0; gt < 4; ++gt) {
              o.dz[row * R4 + gt * R + u] = dz[gt];
              dz16[row * R4 + gt * R + u] = __float2bfloat16_rn(dz[gt]);
            }
          },
          [&](int qi, int k, float v) {
            if (k < R) dh_s[qi * ldR + k] = v;
            else gs.dctx[qi * ldHD + k - R] = v;
          });
    }
    for (int r = tid; !at.bf16 && r < R; r += kThreads) {
      float z[4][QT];
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const float* zk = a.z_all + (bk * Q + qg[q]) * R4 + r;
#pragma unroll
        for (int g = 0; g < 4; ++g) z[g][q] = zk[g * R];
      }
      add_gates(sm.h, ldR, R, a.w_hh, r, R, z);
      add_gates(cx_s, ldHD, HD, a.ctx_w3, r, R, z);
#pragma unroll
      for (int q = 0; q < QT; ++q) {
        const bool valid = q0 + q < Q;
        const size_t row = bk * Q + qg[q];
        const float c_prev = o.cs_prev[row * R + r];
        const float gh = valid ? o.g[row * R + r] + dh_s[q * ldR + r] : 0.f;
        const float gc = valid ? dc_s[q * ldR + r] : 0.f;
        float dzg[4];
        const float dc_prev = cell_bwd(z[0][q], z[1][q], z[2][q], z[3][q],
                                       c_prev, gh, gc, dzg);
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          dz_s[q * R4 + g * R + r] = round_if(at.bf16, dzg[g]);
          if (valid) o.dz[row * R4 + g * R + r] = dzg[g];
        }
        dc_s[q * ldR + r] = dc_prev;
      }
    }
    __syncthreads();

    // ---- dh_{k-1} = dz W_hh^T and dctx = dz ctx_w3^T
    if (!at.bf16)
    gates_backprop_rows<QT>(dz_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
      if (u < R) dh_s[q * ldR + u] = v;
      else gs.dctx[q * ldHD + u - R] = v;
    });
    __syncthreads();

    // ---- attention and sampling backward of the step from the table;
    //      dpos_s then holds dpos and cx_s dhvec
    attend_backward_table<QT>(at, sm, gs, value_b, vw_b, o.dvalue + (size_t)b * H * S * Dh,
                          o.G + (size_t)b * H * S * A, cols, dcb, daw);

    // ---- sampling backward: dbase += dpos, doff = dpos * scale (ddot_s is
    //      free now and holds doff), dscale += sum_hh dpos * off with the
    //      offsets h_{k-1} . off_w recomputed rather than kept
    for (int row = tid; row < NR; row += kThreads) {
      const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
      const float dp = dpos_s[row];
      const float sc = at.scale[((size_t)b * Q + qg[q]) * LP + p];
      ddot_s[row] = round_if(at.bf16, dp * sc);
      if (q0 + q < Q) {
        o.dbase[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] += dp;
        store_row(o.doff_all, (bk * Q + q0 + q) * HLP + hh * LP + p, dp * sc, at.bf16);
      }
      sm.d[row] = dp * row_offset(at, sm.h, row);
    }
    for (int i = tid; i < QT * A; i += kThreads) {
      const int q = i / A, col = i % A;
      if (q0 + q < Q) store_row(o.dhvec_all, (bk * Q + q0 + q) * A + col, cx_s[q * ldA + col], at.bf16);
    }
    __syncthreads();
    for (int i = tid; i < QT * LP; i += kThreads) {
      const int q = i / LP, p = i % LP;
      if (q0 + q >= Q) continue;
      float acc = 0.f;
      for (int hh = 0; hh < H; ++hh) acc += sm.d[(q * H + hh) * LP + p];
      o.dscale[((size_t)b * Q + q0 + q) * LP + p] += acc;
    }

    // ---- dh_{k-1} += dhvec W_h2att^T + doff off_w^T (a thread per two
    //      units r)
    for (int r0 = tid * 2; r0 < R; r0 += kThreads * 2) {
      float acc[2][QT] = {};
      rows_dot_rows<2, QT>(cx_s, ldA, A, at.h2att_w, A, r0, R, acc);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + i;
        if (r >= R) continue;
        for (int m = 0; m < HLP; ++m) {
          const float wo = at.off_w[((size_t)(m / LP) * R + r) * LP + m % LP];
#pragma unroll
          for (int q = 0; q < QT; ++q) acc[i][q] = fmaf(ddot_s[q * HLP + m], wo, acc[i][q]);
        }
#pragma unroll
        for (int q = 0; q < QT; ++q) dh_s[q * ldR + r] += acc[i][q];
      }
    }
    __syncthreads();
  }

  // the lane's column sums of dcb and daw (zero for queries past Q)
#pragma unroll
  for (int j = 0; j < kColGroups; ++j) {
    if (!cols.ok[j]) continue;
    atomic_add4(o.dcb + cols.c[j], dcb[j]);
    atomic_add4(o.daw + cols.c[j], daw[j]);
  }
  if (tid == 0) atomicAdd(o.dab, gs.dab[0]);
}

// the forward kernel of query tile QT (4, 8 or 16) in the mode b16
static void (*scan_fwd_variant(int QT, bool b16))(ScanArgs, const float*, float*, float*) {
  if (b16)
    return QT == 4 ? scan_fwd_kernel<4, true> : QT == 16 ? scan_fwd_kernel<16, true>
                                              : scan_fwd_kernel<kQT, true>;
  return QT == 4 ? scan_fwd_kernel<4, false> : QT == 16 ? scan_fwd_kernel<16, false>
                                             : scan_fwd_kernel<kQT, false>;
}

// dsa::fill_attend plus the operands of a step that starts from h
bool fill_hidden_attend(AttendArgs* at, const float* value_t, const float* base_pos,
                        const float* scale_t, const float* off_w_h, const float* h2att_w,
                        const float* h2att_b, const float* cb,
                        const float* aw, const int* shapes, int H, int S, int Dh, int Q,
                        int LP, int L, int A, int R) {
  if (!fill_attend(at, value_t, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return false;
  at->base_pos = base_pos; at->scale = scale_t; at->off_w = off_w_h;
  at->h2att_w = h2att_w; at->h2att_b = h2att_b;
  return true;
}

}  // namespace

// Shapes as in dsa_teacher_scan_ref (dvc_tpu/ops/dsa_scan.py): value_t
// (B, H, S, Dh), base_pos (B, H, Q, LP), scale_t (B, Q, LP), z_all
// (B, K, Q, 4R), off_w_h (H, R, LP), h2att_w (R, A), h2att_b (A), cw
// (Dh, A), cb (A), aw (A), ab one float in device memory, ctx_w3
// (H*Dh, 4R), w_hh (R, 4R); hs and cs (B, K, Q, R) are written.  Scratch:
// vw (B, H, S, A), the table value . Wc built here first, and work
// (work_floats floats) for its split-K partial tiles (see dsa::gemm_as).  All f32,
// contiguous, on the current device; shapes is a host array of the L level
// lengths.  bf16: K4-bf16, with value_t and off_w_h given rounded to bf16,
// value16 and cw in bf16 (torch.bfloat16) for the table, wpack the packed
// gate weights (pack_gate_weights; K5-bf16's, of which it reads P^T's
// half) and hpack the packed h2att_w^T (pack_hidden_weights), each 16-byte
// aligned; ctx_w3, w_hh and h2att_w are then unread.
// Returns cudaGetLastError() of the launches, or cudaErrorInvalidValue for
// shapes the kernel does not take.
extern "C" int dvc_dsa_scan_fwd(
    const float* value_t, const void* value16, const float* base_pos, const float* scale_t,
    const float* z_all, const float* off_w_h, const float* h2att_w,
    const float* h2att_b, const void* cw, const float* cb, const float* aw,
    const float* ab, const float* ctx_w3, const float* w_hh, const void* wpack,
    const void* hpack, const int* shapes, float* hs, float* cs, float* vw, float* work,
    int B, int H, int S, int Dh, int Q, int LP, int L, int A, int R, int K,
    int work_floats, int bf16, void* stream) {
  ScanArgs a;
  if (!fill_hidden_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  a.at.bf16 = bf16 != 0;
  if (a.at.bf16 && !(packed_operand(wpack) && packed_operand(hpack)))
    return (int)cudaErrorInvalidValue;
  if (a.at.bf16) a.at.h2att_pack = static_cast<const uint4*>(hpack);
  a.z_all = z_all; a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab;
  a.wpack = static_cast<const uint4*>(wpack);
  a.B = B; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  // 4 queries at least: on a B = 1 grid 2-query tiles (45 blocks) lose to
  // 4-query ones (23), whose gate products read the weights half as often
  const int QT = query_tile(B, Q, 4, 16);
  const size_t smem = ForwardLayout(QT, R, A, H * Dh, QT * H * LP, a.at.bf16).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  const auto kernel = scan_fwd_variant(QT, a.at.bf16);
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // the table value . Wc, once per launch
  if (a.at.bf16)
    e = row_table16(op16(value16, Dh), op16(cw, A), B * H * S, Dh, A, vw, st, work,
                    work_floats);
  else
    e = row_table(value_t, static_cast<const float*>(cw), B * H * S, Dh, A, vw, st, work,
                  work_floats);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  kernel<<<grid, kThreads, smem, st>>>(a, vw, hs, cs);
  return (int)cudaGetLastError();
}

// Gradients of dvc_dsa_scan_fwd for the cotangent g (B, K, Q, R) of hs.
// hs_prev / cs_prev are hs / cs shifted one step later (zeros at k = 0).
// Outputs: dvalue (B, H, S, Dh), dbase (B, H, Q, LP), dscale (B, Q, LP),
// dcb (A), daw (A), dab (1) zeroed by the caller; dz (B, K, Q, 4R),
// doffw (R, H*LP) [(r, hh*LP + p)], dh2w (R, A), dcw (Dh, A),
// dctx_w3 (H*Dh, 4R), dwhh (R, 4R) fully written.  Scratch: G (B, H, S, A)
// zeroed by the caller, ctx_all (B, K, Q, H*Dh), dhvec_all (B, K, Q, A),
// doff_all (B, K, Q, H*LP), vw (B, H, S, A) for the table value . Wc, and
// work (work_floats floats: dsa::gemm_plan's splits times the output of
// each GEMM here, the largest of them) for split-K partial tiles.  dh2att_b equals
// dcb.  A, Dh, R multiples of 4, A <= 512; every operand 16-byte aligned.
// bf16: K5-bf16, operands as for dvc_dsa_scan_fwd (h2att_w rounded: the
// backprop dhvec W_h2att^T reads it in f32).
extern "C" int dvc_dsa_scan_bwd(
    const float* value_t, const void* value16, const float* base_pos, const float* scale_t,
    const float* z_all, const float* off_w_h, const float* h2att_w,
    const float* h2att_b, const void* cw, const float* cb, const float* aw,
    const float* ab, const float* ctx_w3, const float* w_hh, const void* wpack,
    const void* hpack, const void* hs_prev, const float* cs_prev, const float* g,
    const int* shapes, float* dvalue, float* dbase, float* dscale, float* dz, void* dz16,
    float* doffw, float* dh2w, float* dcw, float* dcb, float* daw, float* dab,
    float* dctx_w3, float* dwhh, float* G, void* ctx_all, void* dhvec_all,
    void* doff_all, float* vw, float* work, int B, int H, int S, int Dh, int Q,
    int LP, int L, int A, int R, int K, int work_floats, int bf16, void* stream) {
  ScanArgs a;
  if (!fill_hidden_attend(&a.at, value_t, base_pos, scale_t, off_w_h, h2att_w,
                          h2att_b, cb, aw, shapes, H, S, Dh, Q, LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  const bool rb = bf16 != 0;
  a.at.bf16 = rb;
  if (A > 256 * kColGroups || A % 4 != 0 || Dh % 4 != 0 || R % 4 != 0 ||
      reinterpret_cast<size_t>(value_t) % 16 != 0 ||
      reinterpret_cast<size_t>(w_hh) % 16 != 0 || reinterpret_cast<size_t>(ctx_w3) % 16 != 0 ||
      reinterpret_cast<size_t>(h2att_w) % 16 != 0 || reinterpret_cast<size_t>(cb) % 16 != 0 ||
      reinterpret_cast<size_t>(aw) % 16 != 0 ||
      (rb && !(packed_operand(wpack) && packed_operand(hpack))))
    return (int)cudaErrorInvalidValue;
  if (rb) a.at.h2att_pack = static_cast<const uint4*>(hpack);
  a.z_all = z_all; a.ctx_w3 = ctx_w3; a.w_hh = w_hh; a.ab = ab;
  a.wpack = static_cast<const uint4*>(wpack);
  a.B = B; a.K = K;
  if (B == 0 || Q == 0 || K == 0) return 0;
  BwdOut o;
  o.hs_prev = hs_prev; o.cs_prev = cs_prev; o.g = g; o.vw = vw;
  o.dvalue = dvalue; o.G = G; o.dbase = dbase; o.dscale = dscale; o.dz = dz; o.dz16 = dz16;
  o.ctx_all = ctx_all; o.dhvec_all = dhvec_all; o.doff_all = doff_all;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  // 8 queries a tile at most: a warp of the score backward owns a
  // (query, column part), and A <= 512 needs two parts
  const int QT = query_tile(B, Q, 2, kQT);
  const size_t smem = BwdLayout(QT, R, A, H * Dh, QT * H * LP, rb).bytes();
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = QT == 2 ? set_smem(scan_bwd_kernel<2>, smem)
                  : QT == 4 ? set_smem(scan_bwd_kernel<4>, smem)
                            : set_smem(scan_bwd_kernel<kQT>, smem);
  if (e != cudaSuccess) return (int)e;
  const int BHS = B * H * S;
  // the table value . Wc, once per launch
  const size_t wf = work_floats > 0 ? (size_t)work_floats : 0;
  const float* cwf = static_cast<const float*>(cw);
  e = rb ? row_table16(op16(value16, Dh), op16(cw, A), BHS, Dh, A, vw, st, work, wf)
         : row_table(value_t, cwf, BHS, Dh, A, vw, st, work, wf);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Q + QT - 1) / QT, B);
  if (QT == 2)
    scan_bwd_kernel<2><<<grid, kThreads, smem, st>>>(a, o);
  else if (QT == 4)
    scan_bwd_kernel<4><<<grid, kThreads, smem, st>>>(a, o);
  else
    scan_bwd_kernel<kQT><<<grid, kThreads, smem, st>>>(a, o);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int N = B * K * Q, HD = H * Dh, HLP = H * LP;
  if (rb) {
    // the bf16 mode: hs_prev, the rows and dz16 in bf16, and G, summed in
    // f32 by the scan, rounded once into vw's storage (the table is read
    // no more); first the scores' share of dvalue, G . Wc^T
    const Operand16 hp = op16(hs_prev, R), dzo = op16(dz16, 4 * R), G16 = op16(vw, A);
    if ((e = round_bf16(G, vw, (size_t)BHS * A, st)) != cudaSuccess ||
        (e = gemm16(G16, op16(cw, A), B * H * S, Dh, A, true, dvalue, work, wf, st)) !=
            cudaSuccess ||
        (e = outer_sum16(hp, dzo, N, R, 4 * R, dwhh, st, work, wf)) != cudaSuccess ||
        (e = outer_sum16(op16(ctx_all, HD), dzo, N, HD, 4 * R, dctx_w3, st, work, wf)) !=
            cudaSuccess ||
        (e = outer_sum16(hp, op16(dhvec_all, A), N, R, A, dh2w, st, work, wf)) != cudaSuccess ||
        (e = outer_sum16(hp, op16(doff_all, HLP), N, R, HLP, doffw, st, work, wf)) !=
            cudaSuccess ||
        (e = outer_sum16(op16(value16, Dh), G16, BHS, Dh, A, dcw, st, work, wf)) != cudaSuccess)
      return (int)e;
    return 0;
  }
  // the scores' share of dvalue, once per launch: dvalue += G . Wc^T
  const float* hpf = static_cast<const float*>(hs_prev);
  if ((e = gemm(Operand{G, A, false}, Operand{cwf, A, false}, BHS, Dh, A, true,
                dvalue, work, wf, st)) != cudaSuccess)
    return (int)e;
  if ((e = outer_sum(hpf, R, dz, 4 * R, N, R, 4 * R, dwhh, st, work, wf)) != cudaSuccess ||
      (e = outer_sum(static_cast<const float*>(ctx_all), HD, dz, 4 * R, N, HD, 4 * R, dctx_w3,
                     st, work, wf)) != cudaSuccess ||
      (e = outer_sum(hpf, R, static_cast<const float*>(dhvec_all), A, N, R, A, dh2w, st, work,
                     wf)) != cudaSuccess ||
      (e = outer_sum(hpf, R, static_cast<const float*>(doff_all), HLP, N, R, HLP, doffw, st,
                     work, wf)) != cudaSuccess ||
      (e = outer_sum(value_t, Dh, G, A, BHS, Dh, A, dcw, st, work, wf)) != cudaSuccess)
    return (int)e;
  return 0;
}
