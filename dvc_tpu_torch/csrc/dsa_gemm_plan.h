// The plan of dsa::gemm (dsa_gemm.cuh): its slice depth, its least split-K
// chunk, and the tile and the split that it picks from the shape.  Plain
// C++ with no CUDA, so that one rule serves the kernel, the wrappers'
// workspace (through dsa_gemm_plan.cc) and the host's C++ compiler in the
// CPU tests.
#pragma once

#include <stddef.h>

#include <algorithm>

namespace dsa {

constexpr int kGemmBK = 32;         // terms per slice
constexpr int kGemmMinSlices = 4;   // least slices of a split-K chunk
constexpr int kGemmMaxSlices = 64;  // most slices of a chunk, given a workspace

struct GemmPlan {
  bool large;  // 128 x 128 tiles, else 64 x 64
  int splits;  // chunks of the terms (1: no workspace used)
  int chunk;   // terms a chunk, a multiple of kGemmBK
};

// The tile and the split of out (M, N) over T terms on `sms` SMs: 128 x 128
// tiles where both sides exceed 64 and they fill the SMs with the splits
// allowed, else 64 x 64; then as many chunks of at least kGemmMinSlices
// slices as keep the grid within two blocks an SM (none without a
// workspace), and more, in whole multiples of that many (whole waves),
// where a chunk would exceed kGemmMaxSlices slices.  The cap is for
// accuracy: wgmma's f32 accumulation errs as if it truncated at each add,
// so within a chunk the error grows with its length, not its square root
// (on an H100, K5's hs_prev^T dz over 10,464-term chunks erred by 3.5e-4
// of its products' root-sum-square, one-pass TF32 by 1.4e-3); the chunks'
// partial tiles are added in f32 with rounding.
static inline GemmPlan gemm_plan(int M, int N, int T, int sms, bool may_split) {
  const int slices = (T + kGemmBK - 1) / kGemmBK;
  const int most = may_split ? std::max(1, slices / kGemmMinSlices) : 1;
  const int tiles_l = ((M + 127) / 128) * ((N + 127) / 128);
  const bool large = M > 64 && N > 64 &&
                     tiles_l * std::min(most, std::max(1, 2 * sms / tiles_l)) >= sms;
  const int tiles = large ? tiles_l : ((M + 63) / 64) * ((N + 63) / 64);
  const int fill = std::min(most, std::max(1, 2 * sms / tiles));
  const int need = std::max(1, (slices + kGemmMaxSlices - 1) / kGemmMaxSlices);
  const int splits = std::min(most, fill * ((need + fill - 1) / fill));
  const int per = std::max(1, (slices + splits - 1) / splits);
  return GemmPlan{large, std::max(1, (slices + per - 1) / per), per * kGemmBK};
}

// floats of split-K partial tiles that out (M, N) over T terms takes with a
// workspace: splits * M * N where the plan splits, else 0
static inline size_t gemm_work_floats(int M, int N, int T, int sms) {
  if (M <= 0 || N <= 0 || T < 0) return 0;
  const GemmPlan plan = gemm_plan(M, N, T, sms, true);
  return plan.splits > 1 ? (size_t)plan.splits * M * N : 0;
}

}  // namespace dsa
