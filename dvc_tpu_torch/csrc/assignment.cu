// The on-device assignment solver: every (decoder layer, video) Hungarian
// matching of a train or eval step in one launch, so the criterion's
// indices never leave the card.  It replaces no pl.pallas_call: the JAX
// package runs the same Jonker-Volgenant shortest augmenting path
// (dvc_tpu/ops/assignment.py:31-105, linear_sum_assignment, reached through
// masked_assignment by dvc_tpu/models/criterion.py:159-165's vmap over
// layers x batch) as XLA while loops inside the jitted step.  Its trip
// counts depend on the data, so in torch ops it would need a host read per
// Dijkstra step or R(R+1)/2 masked iterations of ~15 launches each; here one
// warp runs one problem's loops and the launch takes all of them.
//
// Design: one warp a problem, kWarps problems a block.  A problem's
// columns are strided across the lanes: lane l relaxes columns l, l + 32,
// ... of the current row (read from global memory, where the rows stay in
// L2 after the first pass), and the argmin is a warp butterfly on (value,
// index) that picks as jnp.argmin does (a NaN first, then the least value,
// then the lowest index).  The duals, shortest, path, the assignment and
// the real rows' list live in the warp's slice of shared memory; the
// augmentation walks the path on lane 0.  The arithmetic is JAX's, in its
// order and in f32 with no fast math (adds and subtractions only, so no
// contraction either): reduced = ((minVal + cost[i]) - u[i]) - v, kept
// where reduced < shortest strictly, so col4row is JAX's bit for bit, ties
// included.
//
// Bound: bytes (the costs read once, 576 KB at the flagship's 48 problems
// of 30 x 100: 0.2 us at 3.35 TB/s), but the kernel is a serial chain of
// Dijkstra steps per problem (at least R, at most R(R+1)/2): each step is
// a row read, a relaxation and two 5-level shuffles, so the launch takes
// about the longest problem's steps times a step's latency.  A video with
// no events is the longest: JAX's rule solves its R zero rows too, in
// R(R+1)/2 steps (465 at G = 30; about 1.1 us a step on an H100, PERF.md).
// The 48 chains run on 48 warps.  What the kernel removes is the host's
// wait for the forward to drain and the scipy solves of the host route.
//
// Semantics of a problem: cost (R, C) and a row mask (the real gt slots).
//  * R <= C: JAX's masked_assignment.  Padded rows read as 0, nan as 1e9,
//    +inf as 1e9, -inf as -1e9, and all R rows are solved in order: every
//    row, padded ones too, gets a distinct column.
//  * R > C (more gt slots than queries; JAX refuses it), the port's rule,
//    decided per problem from its n real rows:
//    - n <= C: the n real rows are solved in slot order, then the padded
//      slots take the unused columns in ascending order while any are
//      left, then -1;
//    - n > C: the transposed C x n problem (rows the columns, columns the
//      real slots) is solved; each chosen slot gets its column, every
//      other slot -1.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 4;                 // problems a block
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kSmem = 48 * 1024;       // a block's default dynamic limit

// Shared bytes of one warp's problem: u, v, shortest (f32), path, row4col,
// col4row (int) over max(R, C), the real and then padded slots (int, R),
// remaining and sr (bytes, max(R, C)); 16-byte aligned.
size_t warp_bytes(int R, int C) {
  const size_t K = (size_t)(R > C ? R : C);
  return (K * 6 * 4 + (size_t)R * 4 + K * 2 + 15) / 16 * 16;
}

__device__ __forceinline__ float sanitize(float x) {   // jnp.nan_to_num
  if (isnan(x)) return 1e9f;
  if (isinf(x)) return x > 0.f ? 1e9f : -1e9f;
  return x;
}

// (a, ia) before (b, ib) in jnp.argmin's order: a NaN wins, then the
// smaller value, then the lower index
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  const bool na = isnan(a), nb = isnan(b);
  if (na != nb) return na;
  if (a < b) return true;
  if (b < a) return false;
  return ia < ib;
}

__global__ void __launch_bounds__(kWarps * 32)
assignment_kernel(const float* __restrict__ cost, const unsigned char* __restrict__ mask,
                  int P, int R, int C, size_t per_warp, long long* __restrict__ out,
                  int* __restrict__ steps_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int p = blockIdx.x * (blockDim.x >> 5) + warp;
  if (p >= P) return;                     // warp-uniform; no block barrier below
  const int K = R > C ? R : C;
  unsigned char* base = smem + (size_t)warp * per_warp;
  float* u = reinterpret_cast<float*>(base);
  float* v = u + K;
  float* shortest = v + K;
  int* path = reinterpret_cast<int*>(shortest + K);
  int* row4col = path + K;
  int* col4row = row4col + K;
  int* slots = col4row + K;               // real slots in order, then padded
  unsigned char* remaining = reinterpret_cast<unsigned char*>(slots + R);
  unsigned char* sr = remaining + K;

  const float* cp = cost + (size_t)p * R * C;
  const unsigned char* mp = mask + (size_t)p * R;
  int n = 0;
  for (int b = 0; b < R; b += 32) {
    const int r = b + lane;
    const bool real = r < R && mp[r] != 0;
    const unsigned bal = __ballot_sync(kFull, real);
    if (real) slots[n + __popc(bal & ((1u << lane) - 1))] = r;
    n += __popc(bal);
  }
  int m = n;
  for (int b = 0; b < R; b += 32) {
    const int r = b + lane;
    const bool pad = r < R && mp[r] == 0;
    const unsigned bal = __ballot_sync(kFull, pad);
    if (pad) slots[m + __popc(bal & ((1u << lane) - 1))] = r;
    m += __popc(bal);
  }
  // 0: all R rows (R <= C); 1: the n real rows (n <= C < R); 2: transposed
  const int mode = R <= C ? 0 : (n <= C ? 1 : 2);
  const int Rw = mode == 0 ? R : (mode == 1 ? n : C);
  const int Cw = mode == 2 ? n : C;

  for (int k = lane; k < K; k += 32) {
    u[k] = 0.f;
    v[k] = 0.f;
    col4row[k] = -1;
    row4col[k] = -1;
  }
  __syncwarp();
  int steps = 0;
  for (int cur = 0; cur < Rw; ++cur) {
    for (int j = lane; j < Cw; j += 32) {
      remaining[j] = 1;
      shortest[j] = CUDART_INF_F;
      path[j] = 0;
    }
    for (int r = lane; r < Rw; r += 32) sr[r] = 0;
    __syncwarp();
    int i = cur, sink = -1;
    float min_val = 0.f;
    while (sink < 0) {                    // Dijkstra from cur to a free column
      const float ui = u[i];
      const bool zero_row = mode == 0 && mp[i] == 0;
      const float* row = mode == 2 ? cp + i : cp + (size_t)(mode == 0 ? i : slots[i]) * C;
      float best = CUDART_INF_F;
      int best_j = INT_MAX;
      for (int j = lane; j < Cw; j += 32) {
        float val = CUDART_INF_F;
        if (remaining[j]) {
          const float x = zero_row ? 0.f
                                   : sanitize(__ldg(mode == 2 ? row + (size_t)slots[j] * C
                                                              : row + j));
          const float reduced = ((min_val + x) - ui) - v[j];
          if (reduced < shortest[j]) {
            shortest[j] = reduced;
            path[j] = i;
          }
          val = shortest[j];
        }
        if (before(val, j, best, best_j)) {
          best = val;
          best_j = j;
        }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, best, off);
        const int oj = __shfl_xor_sync(kFull, best_j, off);
        if (before(ov, oj, best, best_j)) {
          best = ov;
          best_j = oj;
        }
      }
      min_val = best;
      ++steps;
      __syncwarp();                       // this step's reads before lane 0 writes
      if (lane == 0) {
        sr[i] = 1;
        remaining[best_j] = 0;
      }
      const int owner = row4col[best_j];  // unchanged until the augmentation
      if (owner < 0) sink = best_j;
      else i = owner;
      __syncwarp();
    }
    // the duals, as JAX's update (scipy's update_dual_vectors)
    for (int r = lane; r < Rw; r += 32) {
      float ur = u[r];
      if (r == cur) ur = ur + min_val;
      const bool other = sr[r] && r != cur;
      ur = ur + (other ? min_val - shortest[col4row[r]] : 0.f);
      u[r] = ur;
    }
    for (int j = lane; j < Cw; j += 32) {
      const bool visited = !remaining[j] && j != sink && shortest[j] < CUDART_INF_F;
      v[j] = v[j] - (visited ? min_val - shortest[j] : 0.f);
    }
    __syncwarp();
    if (lane == 0) {                      // augment along the path to sink
      int j = sink;
      while (true) {
        const int r = path[j];
        row4col[j] = r;
        const int prev = col4row[r];
        col4row[r] = j;
        if (r == cur) break;
        j = prev;
      }
    }
    __syncwarp();
  }

  long long* op = out + (size_t)p * R;
  if (mode == 0) {
    for (int r = lane; r < R; r += 32) op[r] = col4row[r];
  } else if (mode == 1) {
    for (int k = lane; k < n; k += 32) op[slots[k]] = col4row[k];
    if (lane == 0) {                      // padded slots: unused columns, ascending
      int q = 0;
      for (int k = n; k < R; ++k) {
        while (q < C && row4col[q] >= 0) ++q;
        op[slots[k]] = q < C ? q++ : -1;
      }
    }
  } else {
    for (int r = lane; r < R; r += 32) op[r] = -1;
    __syncwarp();
    for (int q = lane; q < C; q += 32) op[slots[col4row[q]]] = q;
  }
  if (steps_out != nullptr && lane == 0) steps_out[p] = steps;
}

}  // namespace

// cost (P, R, C) f32 and mask (P, R) bytes (0 a padded row), contiguous on
// the current device; out (P, R) int64: each row's column, or -1 (the rules
// above); steps (P,) int32 or null: the Dijkstra steps each problem ran.
// Returns cudaGetLastError() of the launch (cudaErrorInvalidValue where a
// problem's state does not fit in 48 KB: max(R, C) above ~1,800).
extern "C" int dvc_assignment(const float* cost, const unsigned char* mask, int P, int R,
                              int C, long long* out, int* steps, void* stream) {
  if (P < 0 || R < 0 || C < 0) return (int)cudaErrorInvalidValue;
  if (P == 0 || R == 0) return (int)cudaSuccess;
  const size_t per = warp_bytes(R, C);
  if (per > kSmem) return (int)cudaErrorInvalidValue;
  const int warps = (int)(kSmem / per) < kWarps ? (int)(kSmem / per) : kWarps;
  const int blocks = (P + warps - 1) / warps;
  assignment_kernel<<<blocks, warps * 32, per * warps, (cudaStream_t)stream>>>(
      cost, mask, P, R, C, per, out, steps);
  return (int)cudaGetLastError();
}
