// Trunk multi-scale deformable attention, forward and backward, zeros-mode
// boundaries.
//
// Forward: replaces the Pallas TPU kernels `_msda_ls_kernel` and
// `_msda_kernel` (dvc_tpu/ops/ms_deform_attn.py), which build a dense (Q, S)
// one-hot interpolation matrix per (batch, head) and contract it with the
// head's (S, D) value slice, held in VMEM, on the MXU.  That one-hot form is
// a TPU idiom; on Hopper the op is a gather: each output element reads 2
// taps for each of the L*P sampling points.
//
//   out[b, q, h*D + d] = sum_{l,p} attn[b,q,h,l,p]
//        * (w_lo * value[b, s0_l + i_lo, h, d] + w_hi * value[b, s0_l + i_lo + 1, h, d])
//   pos = loc * T_l - 0.5,  i_lo = floor(pos),  w_hi = pos - i_lo,  w_lo = 1 - w_hi
//   a tap outside [0, T_l - 1] contributes 0 (zeros mode).
//
// The counterpart of the TPU kernel's VMEM slice is shared memory: a block
// owns (video b, head h, a tile of queries) and first stages the head's
// value slice value[b, :, h, :] (S rows of D floats at stride H*D; 96 KB at
// S = 375, D = 64) with cp.async copies, 16 bytes where D and the base
// allow, else 8 or 4.  Then a warp owns a query: lane p reads point p's loc
// and attn (one coalesced read of the query's rows) and computes its two
// tap rows (packed in one int) and w_lo, w_hi (0 for a tap outside its
// level) once; __shfl_sync hands them and attn to the other lanes, which
// gather their columns of D from shared memory in float2 or float4
// vectors, four points' loads in flight before their FMAs.  A lane sums in
// the plain version's association, s = w_lo v_lo + w_hi v_hi, lvl += s *
// attn per level, out = the sum of the levels: a train step's Hungarian
// matching near a tie flips on a few ulps of the trunk's outputs.  The query tile (msda_query_tile)
// makes the grid of B*H*tiles blocks fill the card's block slots once, so
// at B = 1 (8 (b, h) pairs) the slice is staged again for each of ~32
// tiles.  Bound on this card: the bytes of value, loc, attn and out at the
// HBM rate, and far above it the issue rate of the shuffles, shared loads
// and FMAs (about 14 warp instructions per point); the slice's copies come
// from L2 after its first reader.  The slice must fit the card's opt-in
// shared memory of a block (S*D*4 bytes, checked at launch).
//
// Backward: replaces `_msda_bwd_kernel` (same file), which rebuilds the
// (Q, L*P, S) one-hot pair per (batch, head) and emits the three gradients
// as MXU contractions.  Here it is a gather plus a scatter: one warp per
// sampling point (b, q, h, l, p), d across the lanes,
//
//   dattn = sum_d g * (w_lo v_lo + w_hi v_hi)          (warp reduction)
//   dloc  = T_l * attn * sum_d g * (v_hi - v_lo)       (warp reduction)
//   dvalue[tap] += attn * w_tap * g                    (atomicAdd, 2 rows)
//
// where a tap outside its level contributes neither a value nor a
// pos-derivative (the `ok_lo`/`ok_hi` masks of the TPU kernel).  Bound on
// this card: the atomics into dvalue (2*D per point) and the gathers, both
// L2 traffic; the arithmetic is ~6 FLOPs per loaded value.  dvalue is
// summed in no fixed order, so it varies by a few ulps from run to run.
//
// pos is computed with __fmul_rn then __fsub_rn in both passes: an
// FMA-contracted loc*T - 0.5 rounds differently from the CPU/TPU reference,
// and floor(pos) would then pick another tap at exact boundaries.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;      // the backward's block
constexpr int kFwdWarps = 16;      // the forward's block: a warp per query
constexpr int kFwdThreads = 32 * kFwdWarps;

struct Levels {
  int n;
  int T[kMaxLevels];
  int start[kMaxLevels];
};

// one asynchronous copy of BYTES (4, 8 or 16) from global to shared memory
template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d), "l"(src),
                 "n"(BYTES));
}

// the S rows of D floats at src (row stride ld) into sv (S, D), packed; no
// wait
template <int BYTES>
__device__ __forceinline__ void stage_rows(float* sv, const float* src, int S, int D,
                                           int ld) {
  constexpr int F = BYTES / 4;
  const int per_row = D / F;
  for (int i = threadIdx.x; i < S * per_row; i += kFwdThreads) {
    const int s = i / per_row, c = (i - s * per_row) * F;
    cp_async<BYTES>(sv + (size_t)s * D + c, src + (size_t)s * ld + c);
  }
}

template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
  } else if constexpr (V == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    x[0] = t.x; x[1] = t.y;
  } else {
    x[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&x)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else if constexpr (V == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *p = x[0];
}

// sampling point p (level p / P) at the normalised location x: its lerp
// weights w_lo, w_hi, where a tap outside the level has weight 0 and row
// 0, and its two tap rows of the slice, lo | hi << 16 (S < 2^16: the slice
// fits a block's shared memory)
__device__ __forceinline__ void point_taps(const Levels& lv, int P, int p, float x,
                                           float& wl, float& wh, unsigned& rows) {
  const int l = p / P;
  const float Tf = (float)lv.T[l];
  const float pos = __fsub_rn(__fmul_rn(x, Tf), 0.5f);
  const float f_lo = floorf(pos);
  const float w_hi = __fsub_rn(pos, f_lo);
  const float w_lo = __fsub_rn(1.f, w_hi);
  const bool ok_lo = f_lo >= 0.f && f_lo <= Tf - 1.f;
  const bool ok_hi = f_lo + 1.f >= 0.f && f_lo + 1.f <= Tf - 1.f;
  wl = ok_lo ? w_lo : 0.f;
  wh = ok_hi ? w_hi : 0.f;
  const unsigned lo = ok_lo ? lv.start[l] + (int)f_lo : 0;
  const unsigned hi = ok_hi ? lv.start[l] + (int)f_lo + 1 : 0;
  rows = lo | hi << 16;
}

// the N points j..j+N-1 of the warp (their weights, attn and tap rows held
// by those lanes) on the lane's V columns col of the staged slice (row
// stride D): all 2N loads are issued before the FMAs; lvl sums a level's
// points, and each level's sum goes to acc at its last point (left counts
// the points left in the current level, P at its start)
template <int V, int N>
__device__ __forceinline__ void gather_points(const float* col, int D, int P, float wl,
                                              float wh, float at, unsigned rows, int j,
                                              int& left, float (&lvl)[V],
                                              float (&acc)[V]) {
  float a[N], c[N], w[N], xl[N][V], xh[N][V];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    a[u] = __shfl_sync(0xffffffffu, wl, j + u);
    c[u] = __shfl_sync(0xffffffffu, wh, j + u);
    w[u] = __shfl_sync(0xffffffffu, at, j + u);
    const unsigned r = __shfl_sync(0xffffffffu, rows, j + u);
    load_v<V>(col + (size_t)(r & 0xffffu) * D, xl[u]);
    load_v<V>(col + (size_t)(r >> 16) * D, xh[u]);
  }
#pragma unroll
  for (int u = 0; u < N; ++u) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float s = fmaf(c[u], xh[u][k], a[u] * xl[u][k]);
      lvl[k] = fmaf(s, w[u], lvl[k]);
    }
    if (--left == 0) {
#pragma unroll
      for (int k = 0; k < V; ++k) { acc[k] += lvl[k]; lvl[k] = 0.f; }
      left = P;
    }
  }
}

// a block per (query tile, head h, video b); sv holds value[b, :, h, :]
template <int V>
__global__ void __launch_bounds__(kFwdThreads)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, float* __restrict__ out, int S,
                int Q, int H, int D, int P, int QT, int copy, Levels lv) {
  extern __shared__ float4 smem4[];
  float* sv = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * QT;
  const int q_end = min(q0 + QT, Q), LP = lv.n * P, HD = H * D;

  // ---- the head's value slice into shared memory
  const float* src = value + (size_t)b * S * HD + (size_t)h * D;
  if (copy == 16) stage_rows<16>(sv, src, S, D, HD);
  else if (copy == 8) stage_rows<8>(sv, src, S, D, HD);
  else stage_rows<4>(sv, src, S, D, HD);
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- a warp per query, lanes along D (V floats each), points shuffled
  for (int q = q0 + warp; q < q_end; q += kFwdWarps) {
    const size_t row = (((size_t)b * Q + q) * H + h) * LP;
    float* o = out + ((size_t)b * Q + q) * HD + (size_t)h * D;
    for (int c0 = 0; c0 < D; c0 += 32 * V) {
      const int c = c0 + lane * V;
      const float* col = sv + (c < D ? c : 0);
      float acc[V] = {}, lvl[V] = {};
      int left = P;
      for (int p0 = 0; p0 < LP; p0 += 32) {
        float wl = 0.f, wh = 0.f, at = 0.f;
        unsigned rows = 0;
        if (p0 + lane < LP) {
          point_taps(lv, P, p0 + lane, __ldg(loc + row + p0 + lane), wl, wh, rows);
          at = __ldg(attn + row + p0 + lane);
        }
        const int n = min(32, LP - p0);
        int j = 0;
        for (; j + 4 <= n; j += 4)
          gather_points<V, 4>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);
        for (; j < n; ++j)
          gather_points<V, 1>(col, D, P, wl, wh, at, rows, j, left, lvl, acc);
      }
      if (c < D) store_v<V>(o + c, acc);
    }
  }
}

// The forward's query tile, its one home: the largest tile whose grid of
// B*H*ceil(Q/QT) blocks still gives every block slot of the card (slots =
// SMs x the blocks of this shared-memory size that an SM holds) a block in
// one wave; each tile stages the head's slice once.
int msda_query_tile(int B, int H, int Q, int slots) {
  const long long pairs = (long long)B * H;
  const long long tiles = slots > pairs ? slots / pairs : 1;
  return (int)((Q + tiles - 1) / tiles);
}

template <int V>
cudaError_t launch_fwd(const float* value, const float* loc, const float* attn,
                       float* out, int B, int S, int Q, int H, int D, int P,
                       int copy, const Levels& lv, size_t smem, int dev, int sms,
                       int optin, cudaStream_t st) {
  static int opted = -1;   // the device whose opt-in limit the kernel has
  cudaError_t e;
  if (opted != dev) {
    e = cudaFuncSetAttribute(msda_fwd_kernel<V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    opted = dev;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, msda_fwd_kernel<V>,
                                                    kFwdThreads, smem);
  if (e != cudaSuccess) return e;
  const int QT = msda_query_tile(B, H, Q, sms * (per_sm > 0 ? per_sm : 1));
  const dim3 grid((Q + QT - 1) / QT, H, B);
  msda_fwd_kernel<V><<<grid, kFwdThreads, smem, st>>>(value, loc, attn, out, S, Q, H,
                                                      D, P, QT, copy, lv);
  return cudaGetLastError();
}

// one warp per sampling point n = ((b*Q + q)*H + h)*L*P + l*P + p
__global__ void __launch_bounds__(kThreads)
msda_bwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, const float* __restrict__ g,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattn, int B, int S, int Q, int H, int D,
                int P, Levels lv) {
  const int LP = lv.n * P;
  const long long n_pts = (long long)B * Q * H * LP;
  const long long n = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (n >= n_pts) return;  // whole warps exit together
  const int lp = (int)(n % LP);
  long long t = n / LP;
  const int h = (int)(t % H);
  t /= H;
  const int q = (int)(t % Q);
  const int b = (int)(t / Q);
  const int l = lp / P;
  const int T = lv.T[l];
  const float Tf = (float)T;

  const float pos = __fsub_rn(__fmul_rn(loc[n], Tf), 0.5f);
  const float f_lo = floorf(pos);
  const float w_hi = __fsub_rn(pos, f_lo);
  const float w_lo = __fsub_rn(1.f, w_hi);
  const bool ok_lo = f_lo >= 0.f && f_lo <= Tf - 1.f;
  const bool ok_hi = f_lo + 1.f >= 0.f && f_lo + 1.f <= Tf - 1.f;
  const int i_lo = (int)f_lo + lv.start[l];
  const float a = attn[n];
  const long long row = (long long)H * D;  // stride between time steps
  const long long vb = (long long)b * S * row + (long long)h * D;
  const float* gq = g + (((long long)b * Q + q) * H + h) * D;

  float s_samp = 0.f, s_diff = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float gd = gq[d];
    const float v_lo = ok_lo ? value[vb + (long long)i_lo * row + d] : 0.f;
    const float v_hi = ok_hi ? value[vb + (long long)(i_lo + 1) * row + d] : 0.f;
    s_samp += gd * (w_lo * v_lo + w_hi * v_hi);
    s_diff += gd * (v_hi - v_lo);
    if (ok_lo) atomicAdd(dvalue + vb + (long long)i_lo * row + d, a * w_lo * gd);
    if (ok_hi) atomicAdd(dvalue + vb + (long long)(i_lo + 1) * row + d, a * w_hi * gd);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s_samp += __shfl_down_sync(0xffffffffu, s_samp, o);
    s_diff += __shfl_down_sync(0xffffffffu, s_diff, o);
  }
  if (lane == 0) {
    dattn[n] = s_samp;
    dloc[n] = a * s_diff * Tf;
  }
}

bool make_levels(int L, const int* shapes, int S, Levels* lv) {
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

}  // namespace

// value (B, S, H, D); loc, attn (B, Q, H, L, P); out (B, Q, H*D); all f32,
// contiguous, on the current device.  shapes: host array of the L level
// lengths (sum = S).  Returns cudaGetLastError() of the launch, or
// cudaErrorInvalidValue for level lengths that do not sum to S and for a
// head slice of S*D floats above the card's opt-in shared memory of a block.
extern "C" int dvc_msda_fwd(const float* value, const float* loc,
                            const float* attn, float* out, int B, int S,
                            int Q, int H, int D, int L, int P,
                            const int* shapes, void* stream) {
  Levels lv;
  if (!make_levels(L, shapes, S, &lv) || P < 1) return (int)cudaErrorInvalidValue;
  if ((long long)B * Q * H * D == 0) return 0;
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = (size_t)S * D * sizeof(float);
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  // the copies: 16 bytes where every row start is 16-byte aligned (D a
  // multiple of 4 and value aligned), else 8 or 4
  const size_t base = reinterpret_cast<size_t>(value);
  const int copy = D % 4 == 0 && base % 16 == 0 ? 16 : D % 2 == 0 && base % 8 == 0 ? 8 : 4;
  // the lanes' vector: the narrowest that covers D with one warp, else the
  // widest that divides D
  const int V = D % 2 != 0 ? 1 : D <= 32 ? 1 : (D <= 64 || D % 4 != 0) ? 2 : 4;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      V == 4 ? launch_fwd<4>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st)
      : V == 2 ? launch_fwd<2>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st)
               : launch_fwd<1>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st);
  return (int)e;
}

// Gradients of dvc_msda_fwd for the output cotangent g (B, Q, H*D):
// dvalue (B, S, H, D), which the caller zeroes (it is accumulated with
// atomics), dloc and dattn (B, Q, H, L, P), fully written.  Same layouts,
// types and return code as dvc_msda_fwd.
extern "C" int dvc_msda_bwd(const float* value, const float* loc,
                            const float* attn, const float* g, float* dvalue,
                            float* dloc, float* dattn, int B, int S, int Q,
                            int H, int D, int L, int P, const int* shapes,
                            void* stream) {
  Levels lv;
  if (!make_levels(L, shapes, S, &lv)) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)B * Q * H * L * P * 32;
  if (threads == 0) return 0;
  const int blocks = (int)((threads + kThreads - 1) / kThreads);
  msda_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      value, loc, attn, g, dvalue, dloc, dattn, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
}
