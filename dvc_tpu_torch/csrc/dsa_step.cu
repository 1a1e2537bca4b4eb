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
// one VMEM block; here a block owns (video b, a tile of kQT queries), so a
// step at B = 1, Q = 90 runs 12 blocks instead of one.  The attention phases
// are those of the fused scan and greedy kernels (dsa_common.cuh), entered
// through attend_given; K9's gate products and cell are K4's (add_gates), and
// the backwards are one reverse step of K5 with the incoming (dh, dc) given:
// cell_bwd, gates_backprop and attend_backward.  On the TPU the weight
// gradients accumulate in revisited blocks over the sequential grid; here
// blocks run in parallel, so (as in K5) dvalue and G, the lerp-weighted
// scatter of du onto the value rows, take atomics, dWc = sum_b value^T G,
// dW_hh = h^T dz and dctx_w3 = ctx^T dz are reduced by the tiled outer_sum
// kernel, and dcb, d alpha_w, d alpha_b are per-block partial sums added with
// one atomic per column.
//
// Bound on this card: f32 operations (the scores' taps . Wc, H*LP*Dh*A MACs
// per query, and in K9/K10 h W_hh and ctx ctx_w3, 4R*(R + H*Dh) per query);
// as in the scan kernels the products read activations from shared memory
// and weights from L2, so shared-load issue and L2 bandwidth limit them.
// Limits: A <= 512 in the backwards, R <= 512 in K10 (a du tile row and the
// staged dz of a tile fit one kBM x kBN buffer), and the shared memory of a
// block (checked at launch).

#include <cuda_runtime.h>
#include <math.h>

#include "dsa_common.cuh"

namespace {

using namespace dsa;

struct StepArgs {
  AttendArgs at;        // value, cw, cb, aw and the shapes
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

// shared memory of the forwards; h only in K9 (R = 0 for K7)
struct FwdLayout {
  int h, hvec, ctx, taps, wc, wlo, whi, d, red;  // float offsets
  int lo, hi;                                    // int offsets
  int floats, ints;
  __host__ __device__ FwdLayout(int R, int A, int HD, int NR) {
    int o = 0;
    h = o;    o += kQT * pad4(R);
    hvec = o; o += kQT * pad4(A);
    ctx = o;  o += kQT * pad4(HD);
    taps = o; o += kBK * kBM;
    wc = o;   o += kBK * kBN;
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);
    red = o;  o += kWarps * kRed;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

// shared memory of the backwards; h only in K10
struct BwdLayout {
  int h, hvec, cx, dctx, taps, wc, big, wlo, whi, d, ddot, red, dcb, daw, dab;
  int lo, hi;
  int floats, ints;
  __host__ __device__ BwdLayout(int R, int A, int HD, int NR) {
    const int CX = pad4(HD) > pad4(A) ? pad4(HD) : pad4(A);
    int o = 0;
    h = o;    o += kQT * pad4(R);
    hvec = o; o += kQT * pad4(A);
    cx = o;   o += kQT * CX;          // ctx, then dhvec
    dctx = o; o += kQT * pad4(HD);
    taps = o; o += kBK * kBM;
    wc = o;   o += kBK * kBN;
    big = o;  o += kBM * kBN;         // staged dz (kQT, 4R), then du tiles
    wlo = o;  o += pad4(NR);
    whi = o;  o += pad4(NR);
    d = o;    o += pad4(NR);          // softmax weights, then dpos
    ddot = o; o += pad4(NR);
    red = o;  o += kWarps * kRed;
    dcb = o;  o += pad4(A);
    daw = o;  o += pad4(A);
    dab = o;  o += 4;
    floats = o;
    lo = 0;
    hi = NR;
    ints = 2 * NR;
  }
  size_t bytes() const { return sizeof(float) * (size_t)floats + sizeof(int) * (size_t)ints; }
};

template <typename Layout>
__device__ __forceinline__ AttendSmem bind_smem(float* smem, const Layout& L,
                                                float* ctx) {
  int* ints = reinterpret_cast<int*>(smem + L.floats);
  AttendSmem sm;
  sm.h = smem + L.h; sm.hvec = smem + L.hvec; sm.ctx = ctx;
  sm.taps = smem + L.taps; sm.wc = smem + L.wc; sm.wlo = smem + L.wlo;
  sm.whi = smem + L.whi; sm.d = smem + L.d; sm.red = smem + L.red;
  sm.lo = ints + L.lo; sm.hi = ints + L.hi;
  return sm;
}

// the tile's hidden states h (B, Q, R) into sm.h; a query past Q reads the
// last one.  No barrier.
__device__ __forceinline__ void load_h(const StepArgs& a, const AttendSmem& sm,
                                       int b, int q0) {
  const int R = a.at.R, Q = a.at.Q, ldR = pad4(R);
  for (int i = threadIdx.x; i < kQT * R; i += kThreads) {
    const int q = i / R, r = i % R;
    sm.h[q * ldR + r] = a.h[((size_t)b * Q + min(q0 + q, Q - 1)) * R + r];
  }
}

// z[g][q] = z0 + h W_hh + ctx ctx_w3 for hidden unit r's 4 gates (K4's
// products)
__device__ __forceinline__ void gate_preact(const StepArgs& a,
                                            const AttendSmem& sm, int b, int q0,
                                            int r, float (&z)[4][kQT]) {
  const int R = a.at.R, Q = a.at.Q, HD = a.at.H * a.at.Dh;
#pragma unroll
  for (int q = 0; q < kQT; ++q) {
    const float* zq = a.z0 + ((size_t)b * Q + min(q0 + q, Q - 1)) * 4 * R + r;
#pragma unroll
    for (int g = 0; g < 4; ++g) z[g][q] = zq[g * R];
  }
  add_gates(sm.h, pad4(R), R, a.w_hh, r, R, z);
  add_gates(sm.ctx, pad4(HD), HD, a.ctx_w3, r, R, z);
}

// after attend_backward: the tile's dpos (in sm.d) and dhvec rows, and the
// block's partial sums of dcb, d alpha_w, d alpha_b
__device__ __forceinline__ void store_attend_grads(const AttendArgs& at,
                                                   const AttendSmem& sm,
                                                   const AttendGradSmem& gs,
                                                   int b, int q0,
                                                   const StepGrads& o) {
  const int tid = threadIdx.x, H = at.H, LP = at.LP, Q = at.Q, A = at.A;
  const int HLP = H * LP, NR = kQT * HLP, ldA = pad4(A);
  for (int row = tid; row < NR; row += kThreads) {
    const int q = row / HLP, hh = (row / LP) % H, p = row % LP;
    if (q0 + q < Q) o.dpos[(((size_t)b * H + hh) * Q + q0 + q) * LP + p] = sm.d[row];
  }
  for (int i = tid; i < kQT * A; i += kThreads) {
    const int q = i / A, col = i % A;
    if (q0 + q < Q) o.dhvec[((size_t)b * Q + q0 + q) * A + col] = gs.dhvec[q * ldA + col];
  }
  for (int col = tid; col < A; col += kThreads) {
    atomicAdd(o.dcb + col, gs.dcb[col]);
    atomicAdd(o.daw + col, gs.daw[col]);
  }
  if (tid == 0) atomicAdd(o.dab, gs.dab[0]);
}

// ----------------------------------------------------------------------------
// forwards
// ----------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
step_fwd_kernel(StepArgs a, float* __restrict__ ctx_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, HD = H * Dh, ldHD = pad4(HD);
  const FwdLayout L(0, at.A, HD, kQT * H * at.LP);
  const AttendSmem sm = bind_smem(smem, L, smem + L.ctx);
  const float* value_b = at.value + (size_t)b * H * at.S * Dh;

  attend_given(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores(at, sm, value_b, __ldg(a.ab));
  attend_softmax_ctx(at, sm, value_b);
  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
    if (q0 + q < Q)
      ctx_out[(((size_t)b * H + hh) * Q + q0 + q) * Dh + dh] = sm.ctx[q * ldHD + hd];
  }
}

__global__ void __launch_bounds__(kThreads)
lstm_fwd_kernel(StepArgs a, float* __restrict__ h_out, float* __restrict__ c_out) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, R = at.R, HD = H * Dh;
  const FwdLayout L(R, at.A, HD, kQT * H * at.LP);
  const AttendSmem sm = bind_smem(smem, L, smem + L.ctx);
  const float* value_b = at.value + (size_t)b * H * at.S * Dh;

  load_h(a, sm, b, q0);
  attend_given(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores(at, sm, value_b, __ldg(a.ab));
  attend_softmax_ctx(at, sm, value_b);

  // a thread owns hidden unit r (its 4 gate columns), as in K4
  for (int r = tid; r < R; r += kThreads) {
    float z[4][kQT];
    gate_preact(a, sm, b, q0, r, z);
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
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

__global__ void __launch_bounds__(kThreads)
step_bwd_kernel(StepArgs a, StepGrads o) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, HD = H * Dh;
  const int ldHD = pad4(HD);
  const BwdLayout L(0, A, HD, kQT * H * at.LP);
  const AttendSmem sm = bind_smem(smem, L, smem + L.cx);
  AttendGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = smem + L.cx; gs.ddot = smem + L.ddot;
  gs.du = smem + L.big; gs.dcb = smem + L.dcb; gs.daw = smem + L.daw;
  gs.dab = smem + L.dab;
  const float* value_b = at.value + (size_t)b * H * S * Dh;

  for (int i = tid; i < pad4(A); i += kThreads) { gs.dcb[i] = 0.f; gs.daw[i] = 0.f; }
  if (tid == 0) gs.dab[0] = 0.f;
  attend_given(at, sm, b, q0, a.pos, a.hvec);
  // d ctx of the tile; a query past Q gets a zero cotangent, so every
  // gradient it adds is exactly 0
  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD, hh = hd / Dh, dh = hd % Dh;
    gs.dctx[q * ldHD + hd] =
        q0 + q < Q ? o.g[(((size_t)b * H + hh) * Q + q0 + q) * Dh + dh] : 0.f;
  }
  __syncthreads();
  attend_scores(at, sm, value_b, __ldg(a.ab));
  attend_softmax(at, sm);
  attend_backward(at, sm, gs, value_b, o.dvalue + (size_t)b * H * S * Dh,
                  o.G + (size_t)b * H * S * A);
  store_attend_grads(at, sm, gs, b, q0, o);
}

__global__ void __launch_bounds__(kThreads)
lstm_bwd_kernel(StepArgs a, StepGrads o) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const AttendArgs& at = a.at;
  const int tid = threadIdx.x, b = blockIdx.y, q0 = blockIdx.x * kQT;
  const int H = at.H, Dh = at.Dh, Q = at.Q, S = at.S, A = at.A, R = at.R;
  const int HD = H * Dh, R4 = 4 * R, ldHD = pad4(HD);
  const BwdLayout L(R, A, HD, kQT * H * at.LP);
  const AttendSmem sm = bind_smem(smem, L, smem + L.cx);
  AttendGradSmem gs;
  gs.dctx = smem + L.dctx; gs.dhvec = smem + L.cx; gs.ddot = smem + L.ddot;
  gs.du = smem + L.big; gs.dcb = smem + L.dcb; gs.daw = smem + L.daw;
  gs.dab = smem + L.dab;
  float* dz_s = smem + L.big;
  const float* value_b = at.value + (size_t)b * H * S * Dh;

  for (int i = tid; i < pad4(A); i += kThreads) { gs.dcb[i] = 0.f; gs.daw[i] = 0.f; }
  if (tid == 0) gs.dab[0] = 0.f;

  // ---- recompute the step: attention, ctx (rows kept for dctx_w3), gates
  load_h(a, sm, b, q0);
  attend_given(at, sm, b, q0, a.pos, a.hvec);
  __syncthreads();
  attend_scores(at, sm, value_b, __ldg(a.ab));
  attend_softmax_ctx(at, sm, value_b);
  for (int i = tid; i < kQT * HD; i += kThreads) {
    const int q = i / HD, hd = i % HD;
    if (q0 + q < Q) o.ctx_all[((size_t)b * Q + q0 + q) * HD + hd] = sm.ctx[q * ldHD + hd];
  }

  // ---- the LSTM cell backward with the given (gh, gc): a query past Q gets
  //      zero cotangents, so its dz is exactly 0; dz is written out and
  //      staged as (kQT, 4R)
  for (int r = tid; r < R; r += kThreads) {
    float z[4][kQT];
    gate_preact(a, sm, b, q0, r, z);
#pragma unroll
    for (int q = 0; q < kQT; ++q) {
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
  gates_backprop(dz_s, R, HD, a.w_hh, a.ctx_w3, [&](int q, int u, float v) {
    if (u >= R) gs.dctx[q * ldHD + u - R] = v;
    else if (q0 + q < Q) o.dh[((size_t)b * Q + q0 + q) * R + u] = v;
  });
  __syncthreads();

  // ---- attention and sampling backward with g = d ctx
  attend_backward(at, sm, gs, value_b, o.dvalue + (size_t)b * H * S * Dh,
                  o.G + (size_t)b * H * S * A);
  store_attend_grads(at, sm, gs, b, q0, o);
}

bool fill_step(StepArgs* a, const float* value_t, const float* pos,
               const float* hvec, const float* cw, const float* cb,
               const float* aw, const float* ab, const int* shapes, int H,
               int S, int Dh, int Q, int LP, int L, int A, int R) {
  *a = StepArgs{};
  a->pos = pos; a->hvec = hvec; a->ab = ab;
  return fill_attend(&a->at, value_t, cw, cb, aw, shapes, H, S, Dh, Q, LP, L,
                     A, R);
}

template <typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, size_t smem, int B, int Q, cudaStream_t st,
                   Args... args) {
  if (B == 0 || Q == 0) return cudaSuccess;
  cudaError_t e = set_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Q + kQT - 1) / kQT, B);
  kernel<<<grid, kThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// Shapes as in the JAX kernels' operands (dvc_tpu/ops/dsa_step.py): value_t
// (B, H, S, Dh), pos (B, H, Q, LP) level-relative, hvec (B, Q, A), cw
// (Dh, A), cb (A), aw (A), ab one float in device memory; ctx (B, H, Q, Dh)
// is written.  All f32, contiguous, on the current device; shapes is a host
// array of the L level lengths.  Each entry point returns cudaGetLastError()
// of its launches, or cudaErrorInvalidValue for shapes it does not take.
extern "C" int dvc_dsa_step_fwd(
    const float* value_t, const float* pos, const float* hvec, const float* cw,
    const float* cb, const float* aw, const float* ab, const int* shapes,
    float* ctx, int B, int H, int S, int Dh, int Q, int LP, int L, int A,
    void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cw, cb, aw, ab, shapes, H, S, Dh, Q,
                 LP, L, A, 0))
    return (int)cudaErrorInvalidValue;
  const size_t smem = FwdLayout(0, A, H * Dh, kQT * H * LP).bytes();
  return (int)launch(step_fwd_kernel, smem, B, Q, (cudaStream_t)stream, a, ctx);
}

// K7's gradients for the cotangent g (B, H, Q, Dh) of ctx.  dvalue
// (B, H, S, Dh), dcb (A), daw (A), dab (1) and the scratch G (B, H, S, A)
// zeroed by the caller; dpos (B, H, Q, LP), dhvec (B, Q, A), dcw (Dh, A)
// fully written.  work (work_floats floats) holds the outer sum's split-K
// partial tiles (see dsa::gemm).
extern "C" int dvc_dsa_step_bwd(
    const float* value_t, const float* pos, const float* hvec, const float* cw,
    const float* cb, const float* aw, const float* ab, const float* g,
    const int* shapes, float* dvalue, float* dpos, float* dhvec, float* dcw,
    float* dcb, float* daw, float* dab, float* G, float* work, int B, int H,
    int S, int Dh, int Q, int LP, int L, int A, int work_floats, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cw, cb, aw, ab, shapes, H, S, Dh, Q,
                 LP, L, A, 0) || A > kBN)
    return (int)cudaErrorInvalidValue;
  StepGrads o{};
  o.g = g; o.dvalue = dvalue; o.G = G; o.dpos = dpos; o.dhvec = dhvec;
  o.dcb = dcb; o.daw = daw; o.dab = dab;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = BwdLayout(0, A, H * Dh, kQT * H * LP).bytes();
  cudaError_t e = launch(step_bwd_kernel, smem, B, Q, st, a, o);
  if (e == cudaSuccess)
    e = outer_sum(value_t, Dh, G, A, B * H * S, Dh, A, dcw, st, work, work_floats);
  return (int)e;
}

// K9: as dvc_dsa_step_fwd plus z0 (B, Q, 4R), h and c (B, Q, R), ctx_w3
// (H*Dh, 4R) and w_hh (R, 4R); h_new and c_new (B, Q, R) are written.
extern "C" int dvc_dsa_lstm_fwd(
    const float* value_t, const float* pos, const float* hvec, const float* z0,
    const float* h, const float* c, const float* ctx_w3, const float* w_hh,
    const float* cw, const float* cb, const float* aw, const float* ab,
    const int* shapes, float* h_new, float* c_new, int B, int H, int S, int Dh,
    int Q, int LP, int L, int A, int R, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cw, cb, aw, ab, shapes, H, S, Dh, Q,
                 LP, L, A, R))
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  const size_t smem = FwdLayout(R, A, H * Dh, kQT * H * LP).bytes();
  return (int)launch(lstm_fwd_kernel, smem, B, Q, (cudaStream_t)stream, a,
                     h_new, c_new);
}

// K9's gradients for the cotangents gh, gc (B, Q, R) of (h_new, c_new).
// dvalue, dcb, daw, dab and the scratch G zeroed by the caller; dpos, dhvec,
// dz0 (B, Q, 4R), dh, dc (B, Q, R), dctx_w3 (H*Dh, 4R), dwhh (R, 4R) and
// dcw fully written; scratch ctx_all (B, Q, H*Dh) and work (work_floats
// floats, the outer sums' split-K partial tiles).
extern "C" int dvc_dsa_lstm_bwd(
    const float* value_t, const float* pos, const float* hvec, const float* z0,
    const float* h, const float* c, const float* ctx_w3, const float* w_hh,
    const float* cw, const float* cb, const float* aw, const float* ab,
    const float* gh, const float* gc, const int* shapes, float* dvalue,
    float* dpos, float* dhvec, float* dz0, float* dh, float* dc,
    float* dctx_w3, float* dwhh, float* dcw, float* dcb, float* daw,
    float* dab, float* G, float* ctx_all, float* work, int B, int H, int S,
    int Dh, int Q, int LP, int L, int A, int R, int work_floats, void* stream) {
  StepArgs a;
  if (!fill_step(&a, value_t, pos, hvec, cw, cb, aw, ab, shapes, H, S, Dh, Q,
                 LP, L, A, R) || A > kBN || kQT * 4 * R > kBM * kBN)
    return (int)cudaErrorInvalidValue;
  a.z0 = z0; a.h = h; a.c = c; a.ctx_w3 = ctx_w3; a.w_hh = w_hh;
  StepGrads o{};
  o.gh = gh; o.gc = gc; o.dvalue = dvalue; o.G = G; o.dpos = dpos;
  o.dhvec = dhvec; o.dcb = dcb; o.daw = daw; o.dab = dab; o.dz0 = dz0;
  o.dh = dh; o.dc = dc; o.ctx_all = ctx_all;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = BwdLayout(R, A, H * Dh, kQT * H * LP).bytes();
  const int N = B * Q, HD = H * Dh;
  cudaError_t e = launch(lstm_bwd_kernel, smem, B, Q, st, a, o);
  const size_t wf = work_floats;
  if (e == cudaSuccess) e = outer_sum(h, R, dz0, 4 * R, N, R, 4 * R, dwhh, st, work, wf);
  if (e == cudaSuccess)
    e = outer_sum(ctx_all, HD, dz0, 4 * R, N, HD, 4 * R, dctx_w3, st, work, wf);
  if (e == cudaSuccess)
    e = outer_sum(value_t, Dh, G, A, B * H * S, Dh, A, dcw, st, work, wf);
  return (int)e;
}
