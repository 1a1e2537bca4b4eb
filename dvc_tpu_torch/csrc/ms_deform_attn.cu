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
// Backward: replaces `_msda_bwd_kernel` (same file), one grid cell per
// (video, head) that holds the head's (S, D) slice, rebuilds the (Q, L*P,
// S) one-hot pair and writes dvalue once.  Here the cell is a block per
// (query tile, head h, video b), as in the forward, and its dvalue slice
// dvalue[b, :, h, :] (S*D floats, 96 KB at the recipe) lives in shared
// memory, zeroed at the start; where the value slice fits beside it (2*S*D*4
// bytes within the opt-in limit; 192 KB at the recipe) it is staged as the
// forward stages it, else its rows are read through L2 (slower at the
// recipe, one or two blocks an SM).  A warp owns a run of the tile's
// queries, a half-warp a tap: for a chunk of 16 points lane u of either
// half computes a point's taps, weights and attn once (point_taps), and
// __shfl_sync hands its row and attn * w to the lanes of its half, the lo
// tap to the lower half, the hi tap to the upper; a lane holds V = 4 (2, 1
// where D is not a multiple of 4) columns of the tap row and of g[b, q, h,
// :].  Per point a lane then
//
//   x[p] += sum over its columns of g v_tap          (one vector load)
//   dvalue_slice[tap row, its columns] += attn * w_tap * g
//
// and after the chunk a reduce-scatter within each half-warp (15 shuffles
// for the 16 sums, and one to meet the hi half) leaves lane p with the
// point's sum_lo and sum_hi, and it writes
//
//   dattn = w_lo sum_lo + w_hi sum_hi
//   dloc  = T_l * attn * (sum_hi - sum_lo)
//
// with the sum of a tap outside its level taken as 0 (it contributes
// neither a value nor a pos-derivative: the `ok_lo`/`ok_hi` masks of the
// TPU kernel).  This card has no f32 add on shared memory: atomicAdd is a
// compare-and-swap loop of one float, each waiting for the last, several
// times slower here (chip_smoke.py's K3 split).  So the adds are compare-and-swaps of a lane's V
// floats (128 bits, one instruction a point and warp for both taps), four
// points' loads and compare-and-swaps in flight before the retries of
// those that lost a race; the four points of a group lie on different
// levels (distinct rows) and the warps that run at once on runs of queries
// far apart, since neighbouring encoder queries sample the same rows.  At
// the end the slice goes to dvalue once: a coalesced store where one tile
// covers the (b, h) pair's queries (B = 16: 128 pairs for 132 SMs), else
// (B = 1: 8 pairs, Q split to fill the card) a vector red.global.add of 4
// (or 2) floats per non-zero piece into dvalue, which the library then
// zeroes first; the tile rule is the forward's (msda_query_tile), its one
// home.  Bound on this card: the bytes of value, loc, attn, g and the three
// gradients at the HBM rate; far above it the shared-memory compare-and-
// swaps (about half the time at (B, Q) = (16, 375)), then the gathers and
// shuffles.  dvalue is summed in no fixed order (the adds of the warps), so
// it varies by a few ulps from run to run.  The limit is the forward's: the
// dvalue slice, S*D*4 bytes, must fit the card's opt-in shared memory of a
// block (checked at launch).
//
// pos is computed with __fmul_rn then __fsub_rn in both passes: an
// FMA-contracted loc*T - 0.5 rounds differently from the CPU/TPU reference,
// and floor(pos) would then pick another tap at exact boundaries.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 16;         // a block of either pass: a warp per query
constexpr int kThreads = 32 * kWarps;

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
  for (int i = threadIdx.x; i < S * per_row; i += kThreads) {
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
// fits a block's shared memory); returns which taps lie inside the level,
// ok_lo | ok_hi << 1
__device__ __forceinline__ unsigned point_taps(const Levels& lv, int P, int p, float x,
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
  return (unsigned)ok_lo | (unsigned)ok_hi << 1;
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
__global__ void __launch_bounds__(kThreads)
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
  for (int q = q0 + warp; q < q_end; q += kWarps) {
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

// The query tile of either pass, its one home: the largest tile whose grid
// of B*H*ceil(Q/QT) blocks still gives every block slot of the card (slots
// = SMs x the blocks of this shared-memory size that an SM holds) a block
// in one wave; each tile stages the head's slice once.
int msda_query_tile(int B, int H, int Q, int slots) {
  const long long pairs = (long long)B * H;
  const long long tiles = slots > pairs ? slots / pairs : 1;
  return (int)((Q + tiles - 1) / tiles);
}

// the forward's floats a lane per column chunk of D: the narrowest that
// covers D with one warp, else the widest that divides D
int lane_floats(int D) {
  return D % 2 != 0 ? 1 : D <= 32 ? 1 : (D <= 64 || D % 4 != 0) ? 2 : 4;
}

// the widest copy (16, 8 or 4 bytes) at which every row start of a head
// slice of D floats at p is aligned
int row_bytes(int D, const void* p) {
  const size_t base = reinterpret_cast<size_t>(p);
  return D % 4 == 0 && base % 16 == 0 ? 16 : D % 2 == 0 && base % 8 == 0 ? 8 : 4;
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
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  const int QT = msda_query_tile(B, H, Q, sms * (per_sm > 0 ? per_sm : 1));
  const dim3 grid((Q + QT - 1) / QT, H, B);
  msda_fwd_kernel<V><<<grid, kThreads, smem, st>>>(value, loc, attn, out, S, Q, H,
                                                   D, P, QT, copy, lv);
  return cudaGetLastError();
}

constexpr int kChunk = 16;   // the backward's points per reduce-scatter

// the backward's floats a lane: a half-warp covers 16V columns of a tap row
int tap_floats(int D) { return D % 4 == 0 ? 4 : D % 2 == 0 ? 2 : 1; }

// one halving step of the reduce-scatter: lanes whose bit N is set keep the
// upper N of their first 2N sums, the others the lower N, each adding its
// partner's (lane ^ N) copy of the half it keeps
template <int N, int M>
__device__ __forceinline__ void halve(float (&x)[M], int lane) {
  const bool up = lane & N;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float send = up ? x[i] : x[i + N];
    const float keep = up ? x[i + N] : x[i];
    x[i] = keep + __shfl_xor_sync(0xffffffffu, send, N);
  }
}

// the total of x[lane & 15] over the lane's half-warp (15 shuffles)
__device__ __forceinline__ float reduce_halves(float (&x)[kChunk], int lane) {
  halve<8>(x, lane);
  halve<4>(x, lane);
  halve<2>(x, lane);
  halve<1>(x, lane);
  return x[0];
}

// a tap row's V floats at p: the staged slice (vector loads), else value in
// device memory through L2 (scalar loads: its rows may sit off a vector
// boundary); 0 for a lane past D
template <int V, bool STAGED>
__device__ __forceinline__ void load_tap(const float* p, bool in, float (&x)[V]) {
  if (!in) {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = 0.f;
  } else if constexpr (STAGED) {
    load_v<V>(p, x);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) x[k] = __ldg(p + k);
  }
}

__device__ __forceinline__ unsigned long long pack2(float a, float b) {
  return (unsigned long long)__float_as_uint(b) << 32 | __float_as_uint(a);
}

__device__ __forceinline__ void unpack2(unsigned long long v, float& a, float& b) {
  a = __uint_as_float((unsigned)v);
  b = __uint_as_float((unsigned)(v >> 32));
}

// one compare-and-swap of the V floats at p (shared memory, 4V-byte
// aligned; 128 bits wide for V = 4, sm_90): want where p holds expect
// bitwise; seen gets what p held; returns whether it swapped.  (A float
// atomicAdd on shared memory is itself a compare-and-swap loop on this
// card, one float at a time, each waiting for the last.)
template <int V>
__device__ __forceinline__ bool cas_v(float* p, const float (&expect)[V], const float (&want)[V],
                                      float (&seen)[V]) {
  if constexpr (V == 1) {
    const unsigned e = __float_as_uint(expect[0]);
    const unsigned r = atomicCAS(reinterpret_cast<unsigned*>(p), e, __float_as_uint(want[0]));
    seen[0] = __uint_as_float(r);
    return r == e;
  } else if constexpr (V == 2) {
    const unsigned long long e = pack2(expect[0], expect[1]);
    const unsigned long long r =
        atomicCAS(reinterpret_cast<unsigned long long*>(p), e, pack2(want[0], want[1]));
    unpack2(r, seen[0], seen[1]);
    return r == e;
  } else {
    const unsigned long long el = pack2(expect[0], expect[1]), eh = pack2(expect[2], expect[3]);
    unsigned long long rl, rh;
    asm volatile(
        "{\n\t.reg .b128 d, e, w;\n\t"
        "mov.b128 e, {%2, %3};\n\t"
        "mov.b128 w, {%4, %5};\n\t"
        "atom.shared.cas.b128 d, [%6], e, w;\n\t"
        "mov.b128 {%0, %1}, d;\n\t}\n"
        : "=l"(rl), "=l"(rh)
        : "l"(el), "l"(eh), "l"(pack2(want[0], want[1])), "l"(pack2(want[2], want[3])),
          "r"((unsigned)__cvta_generic_to_shared(p))
        : "memory");
    unpack2(rl, seen[0], seen[1]);
    unpack2(rh, seen[2], seen[3]);
    return rl == el && rh == eh;
  }
}

// each target u with on[u] takes add[u] (V floats at p[u], shared memory):
// the G current values loaded, then G compare-and-swaps issued back to back
// (their latencies overlap), then a retry of each that lost a race (to
// another warp, or to an earlier target of the group at the same address)
template <int V, int G>
__device__ __forceinline__ void add_shared(float* const (&p)[G], const float (&add)[G][V],
                                           const bool (&on)[G]) {
  float old[G][V], nw[G][V];
  bool done[G];
#pragma unroll
  for (int u = 0; u < G; ++u)
    if (on[u]) load_v<V>(p[u], old[u]);
#pragma unroll
  for (int u = 0; u < G; ++u) {
    done[u] = !on[u];
    if (on[u]) {
#pragma unroll
      for (int k = 0; k < V; ++k) nw[u][k] = old[u][k] + add[u][k];
      done[u] = cas_v<V>(p[u], old[u], nw[u], old[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
    while (!done[u]) {
#pragma unroll
      for (int k = 0; k < V; ++k) nw[u][k] = old[u][k] + add[u][k];
      done[u] = cas_v<V>(p[u], old[u], nw[u], old[u]);
    }
  }
}

// the G points j..j+G-1 of a chunk, a half-warp a tap: the lower half of
// the warp takes each point's lo tap, the upper half its hi tap (the tap's
// row and attn * w held by lane j + u of the same half), each lane its V
// columns c of the value rows vrows (row stride ld) and of the dvalue slice
// sdv (row stride D).  All G row loads are issued before the FMAs; x[j + u]
// gathers the lane's share of sum g v over point j + u's tap, and the tap's
// dvalue row takes attn * w * g (nothing from a lane past D, or for a tap
// of weight 0: outside its level, or w_hi = 0)
template <int V, int G, bool STAGED>
__device__ __forceinline__ void scatter_points(const float* vrows, int ld, float* sdv, int D,
                                               int c, bool in, const float (&gv)[V],
                                               unsigned row, float aw, int j, int lane,
                                               float (&x)[kChunk]) {
  float* p[G];
  float v[G][V], add[G][V];
  bool on[G];
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int src = j + u + (lane & 16);
    const unsigned r = __shfl_sync(0xffffffffu, row, src);
    const float w = __shfl_sync(0xffffffffu, aw, src);
    load_tap<V, STAGED>(vrows + (size_t)r * ld + c, in, v[u]);
    p[u] = sdv + (size_t)r * D + c;
    on[u] = in && w != 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) add[u][k] = w * gv[k];
  }
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int k = 0; k < V; ++k) x[j + u] = fmaf(gv[k], v[u][k], x[j + u]);
  }
  add_shared<V, G>(p, add, on);
}

// n floats of shared memory at p (16-byte aligned) set to 0
__device__ __forceinline__ void zero_floats(float* p, int n) {
  float4* p4 = reinterpret_cast<float4*>(p);
  for (int i = threadIdx.x; i < n / 4; i += kThreads) p4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = n / 4 * 4 + threadIdx.x; i < n; i += kThreads) p[i] = 0.f;
}

// the S rows of D floats of the slice sdv (packed) into dst (row stride
// ld), BYTES at a time: stored, or with add, added (vector red of the
// non-zero pieces)
template <int BYTES>
__device__ __forceinline__ void flush_rows(float* dst, const float* sdv, int S, int D,
                                           int ld, bool add) {
  constexpr int F = BYTES / 4;
  const int per_row = D / F;
  for (int i = threadIdx.x; i < S * per_row; i += kThreads) {
    const int s = i / per_row, c = (i - s * per_row) * F;
    const float* src = sdv + (size_t)s * D + c;
    float* out = dst + (size_t)s * ld + c;
    if constexpr (F == 4) {
      const float4 t = *reinterpret_cast<const float4*>(src);
      if (!add) *reinterpret_cast<float4*>(out) = t;
      else if (t.x != 0.f || t.y != 0.f || t.z != 0.f || t.w != 0.f)
        atomicAdd(reinterpret_cast<float4*>(out), t);
    } else if constexpr (F == 2) {
      const float2 t = *reinterpret_cast<const float2*>(src);
      if (!add) *reinterpret_cast<float2*>(out) = t;
      else if (t.x != 0.f || t.y != 0.f) atomicAdd(reinterpret_cast<float2*>(out), t);
    } else {
      if (!add) *out = *src;
      else if (*src != 0.f) atomicAdd(out, *src);
    }
  }
}

struct BwdArgs {
  const float* value;
  const float* loc;
  const float* attn;
  const float* g;
  float* dvalue;
  float* dloc;
  float* dattn;
  int S, Q, H, D, P;
  int QT;      // queries a block
  int copy;    // bytes a cp.async of the staged value rows
  int flush;   // bytes a store (or red) of the dvalue rows
  int add;     // several tiles a (b, h) pair: add the slice into dvalue
  Levels lv;
};

// a block per (query tile, head h, video b); sdv holds dvalue[b, :, h, :],
// and with STAGED sdv + S*D holds value[b, :, h, :]
template <int V, bool STAGED>
__global__ void __launch_bounds__(kThreads, 1)
msda_bwd_kernel(BwdArgs a) {
  constexpr int G = 4;   // points whose loads and compare-and-swaps are in flight together
  extern __shared__ float4 smem4[];
  float* sdv = reinterpret_cast<float*>(smem4);
  const int S = a.S, D = a.D, HD = a.H * a.D, P = a.P, LP = a.lv.n * a.P;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * a.QT;
  const int q_end = min(q0 + a.QT, a.Q);
  const size_t head = (size_t)b * S * HD + (size_t)h * D;

  // ---- the head's dvalue slice zeroed, its value slice staged beside it
  const float* vrows = a.value + head;
  int ld = HD;
  if constexpr (STAGED) {
    float* sv = sdv + (size_t)S * D;
    if (a.copy == 16) stage_rows<16>(sv, vrows, S, D, HD);
    else if (a.copy == 8) stage_rows<8>(sv, vrows, S, D, HD);
    else stage_rows<4>(sv, vrows, S, D, HD);
    asm volatile("cp.async.commit_group;\n" ::);
    vrows = sv;
    ld = D;
  }
  zero_floats(sdv, S * D);
  if constexpr (STAGED) asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();

  // ---- a warp per query (a run of the tile's queries: warps that run at
  // once sample far apart, where neighbouring queries' taps collide), a
  // half-warp per tap, lanes along D; chunks of kChunk points, lane u of
  // each half holding point pu's taps, so that a group of G points spans
  // the levels (distinct rows: no race between the group's own adds)
  static_assert(kChunk % G == 0, "a chunk is whole groups");
  const int u = lane & 15, pu = (u % G) * (kChunk / G) + u / G;
  const bool upper = lane & 16;   // the hi taps
  const int per = (a.QT + kWarps - 1) / kWarps;
  const int q_first = q0 + warp * per, q_last = min(q_first + per, q_end);
  for (int q = q_first; q < q_last; ++q) {
    const size_t row = (((size_t)b * a.Q + q) * a.H + h) * LP;
    const float* gq = a.g + ((size_t)b * a.Q + q) * HD + (size_t)h * D;
    for (int p0 = 0; p0 < LP; p0 += kChunk) {
      const int n = min(kChunk, LP - p0);
      float wl = 0.f, wh = 0.f, at = 0.f, Tl = 0.f;
      unsigned rows = 0, ok = 0;
      if (pu < n) {
        const int p = p0 + pu;
        ok = point_taps(a.lv, P, p, __ldg(a.loc + row + p), wl, wh, rows);
        at = __ldg(a.attn + row + p);
        Tl = (float)a.lv.T[p / P];
      }
      const unsigned tap = upper ? rows >> 16 : rows & 0xffffu;
      const float aw = at * (upper ? wh : wl);
      float x[kChunk] = {};
      for (int c0 = 0; c0 < D; c0 += 16 * V) {
        const int c = c0 + u * V;
        const bool in = c < D;
        float gv[V];
#pragma unroll
        for (int k = 0; k < V; ++k) gv[k] = in ? __ldg(gq + c + k) : 0.f;
#pragma unroll
        for (int j = 0; j < kChunk; j += G)
          if (j / G < n)   // the group's first point
            scatter_points<V, G, STAGED>(vrows, ld, sdv, D, c, in, gv, tap, aw, j, lane, x);
      }
      // lane u: sum g v_lo of point pu; lane u + 16: its sum g v_hi
      const float lo = reduce_halves(x, lane);
      const float hi = __shfl_down_sync(0xffffffffu, lo, 16);
      if (!upper && pu < n) {
        const float sl = (ok & 1u) ? lo : 0.f, sh = (ok & 2u) ? hi : 0.f;
        a.dattn[row + p0 + pu] = fmaf(wh, sh, wl * sl);
        a.dloc[row + p0 + pu] = at * (sh - sl) * Tl;
      }
    }
  }

  // ---- the slice into dvalue, once
  __syncthreads();
  float* dst = a.dvalue + head;
  if (a.flush == 16) flush_rows<16>(dst, sdv, S, D, HD, a.add);
  else if (a.flush == 8) flush_rows<8>(dst, sdv, S, D, HD, a.add);
  else flush_rows<4>(dst, sdv, S, D, HD, a.add);
}

template <int V, bool STAGED>
cudaError_t launch_bwd(BwdArgs a, int B, size_t smem, int dev, int sms, int optin,
                       cudaStream_t st) {
  static int opted = -1;   // the device whose opt-in limit the kernel has
  cudaError_t e;
  if (opted != dev) {
    e = cudaFuncSetAttribute(msda_bwd_kernel<V, STAGED>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return e;
    opted = dev;
  }
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, msda_bwd_kernel<V, STAGED>,
                                                    kThreads, smem);
  if (e != cudaSuccess) return e;
  a.QT = msda_query_tile(B, a.H, a.Q, sms * (per_sm > 0 ? per_sm : 1));
  const int tiles = (a.Q + a.QT - 1) / a.QT;
  a.add = tiles > 1;
  if (a.add) {   // the tiles' slices are added into dvalue
    e = cudaMemsetAsync(a.dvalue, 0, (size_t)B * a.S * a.H * a.D * sizeof(float), st);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid(tiles, a.H, B);
  msda_bwd_kernel<V, STAGED><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
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
  const int copy = row_bytes(D, value), V = lane_floats(D);
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e =
      V == 4 ? launch_fwd<4>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st)
      : V == 2 ? launch_fwd<2>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st)
               : launch_fwd<1>(value, loc, attn, out, B, S, Q, H, D, P, copy, lv, smem, dev, sms, optin, st);
  return (int)e;
}

// Gradients of dvc_msda_fwd for the output cotangent g (B, Q, H*D): dvalue
// (B, S, H, D), dloc and dattn (B, Q, H, L, P), all fully written (the
// library zeroes dvalue itself where it adds tiles into it).  Same
// layouts, types, limit and return code as dvc_msda_fwd.
extern "C" int dvc_msda_bwd(const float* value, const float* loc,
                            const float* attn, const float* g, float* dvalue,
                            float* dloc, float* dattn, int B, int S, int Q,
                            int H, int D, int L, int P, const int* shapes,
                            void* stream) {
  BwdArgs a{value, loc, attn, g, dvalue, dloc, dattn, S, Q, H, D, P, 0, 0, 0, 0, {}};
  if (!make_levels(L, shapes, S, &a.lv) || P < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if ((long long)B * Q * H == 0)   // no query: dvalue is 0
    return (int)cudaMemsetAsync(dvalue, 0, (size_t)B * S * H * D * sizeof(float), st);
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t slice = (size_t)S * D * sizeof(float);
  if (slice > (size_t)optin) return (int)cudaErrorInvalidValue;
  // the value slice is staged where it fits beside the dvalue slice
  const bool stage = 2 * slice <= (size_t)optin;
  const size_t smem = stage ? 2 * slice : slice;
  a.copy = row_bytes(D, value);
  a.flush = row_bytes(D, dvalue);
  const int V = tap_floats(D);
  const cudaError_t e =
      stage ? (V == 4 ? launch_bwd<4, true>(a, B, smem, dev, sms, optin, st)
               : V == 2 ? launch_bwd<2, true>(a, B, smem, dev, sms, optin, st)
                        : launch_bwd<1, true>(a, B, smem, dev, sms, optin, st))
            : (V == 4 ? launch_bwd<4, false>(a, B, smem, dev, sms, optin, st)
               : V == 2 ? launch_bwd<2, false>(a, B, smem, dev, sms, optin, st)
                        : launch_bwd<1, false>(a, B, smem, dev, sms, optin, st));
  return (int)e;
}
