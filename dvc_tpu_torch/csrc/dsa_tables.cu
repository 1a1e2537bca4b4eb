// The per-video tables of the greedy decode and the scan backward on their
// own: table (N, n) = x (N, k) w (k, n), by the tiled f32 GEMM of
// dsa_common.cuh (row_table) that dvc_dsa_greedy and dvc_dsa_scan_bwd run
// first in every launch (value_t Wc, embed token_w).  This entry point lets
// the GEMM be checked and timed alone.

#include <cuda_runtime.h>

#include "dsa_common.cuh"

// x (N, k), w (k, n), table (N, n): f32, row-major, contiguous, on the
// current device.  Returns cudaGetLastError() of the launch.
extern "C" int dvc_dsa_table_gemm(const float* x, const float* w, float* table,
                                  int N, int k, int n, void* stream) {
  if (N < 0 || k < 0 || n < 0) return (int)cudaErrorInvalidValue;
  return (int)dsa::row_table(x, w, N, k, n, table, (cudaStream_t)stream);
}
