// The per-video tables on their own: table (N, n) = x (N, k) w (k, n), by
// the tiled f32 GEMM of dsa_common.cuh (row_table) that dvc_dsa_greedy,
// dvc_dsa_scan_fwd/_bwd and dvc_dsa_step_bwd run first in every launch
// (value_t Wc, embed token_w), and its backward.  The word-step kernels K9
// and K10 (dsa_step.cu) take VW = value_t Wc as an operand: the caption head
// builds it here once per forward pass, and its backward runs here once per
// backward pass on the cotangent G summed over the word steps.  These
// products lie inside the TPU kernels' bodies (`_make_lstm_fwd_kernel` and
// `_make_lstm_bwd_kernel`, dvc_tpu/ops/dsa_step.py).  Bound: f32 operations
// (2 N k n each product) at the shapes of the word steps.  dw = x^T g has
// few 128 x 128 output tiles (Dh x A: 4 at cap_nheads 8) over many terms
// (B*H*S rows: 48,000), so its terms are cut into up to kTableSplits chunks,
// as many as fill two blocks an SM, where the weight gradients' outer sums
// of the backward kernels stop at kGSplitMax (8).

#include <cuda_runtime.h>

#include "dsa_common.cuh"

constexpr int kTableSplits = 64;

// x (N, k), w (k, n), table (N, n): f32, row-major, contiguous, on the
// current device.  Returns cudaGetLastError() of the launch.
extern "C" int dvc_dsa_table_gemm(const float* x, const float* w, float* table,
                                  int N, int k, int n, void* stream) {
  if (N < 0 || k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  return (int)dsa::row_table(x, w, N, k, n, table, (cudaStream_t)stream);
}

// The gradients of table = x w for its cotangent g (N, n): dx (N, k) =
// g w^T and dw (k, n) = x^T g, both fully written (dw deterministic: its
// split-K partial tiles, in work (work_floats floats; up to kTableSplits
// times k n are used), are added in chunk order).  Shapes and layout as
// dvc_dsa_table_gemm.  Returns cudaGetLastError() of the launches.
extern "C" int dvc_dsa_table_gemm_bwd(const float* x, const float* w,
                                      const float* g, float* dx, float* dw,
                                      float* work, int N, int k, int n,
                                      int work_floats, void* stream) {
  using dsa::Operand;
  if (N < 0 || k < 0 || n < 0 || work_floats < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dsa::gemm(Operand{g, n, false}, Operand{w, n, false}, N, k, n,
                            false, dx, nullptr, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)dsa::outer_sum(x, k, g, n, N, k, n, dw, st, work, (size_t)work_floats,
                             kTableSplits);
}
