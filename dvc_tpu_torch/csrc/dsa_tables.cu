// The per-video tables on their own: table (N, n) = x (N, k) w (k, n) and
// its backward, by dsa::gemm (dsa_gemm.cuh), the GEMM that dvc_dsa_greedy
// and dvc_dsa_scan_fwd/_bwd also run inside every launch (value_t Wc, embed
// token_w, G Wc^T and the weight gradients' outer sums).  The word-step
// kernels K7-K10 (dsa_step.cu) take VW = value_t Wc as an operand: the
// caption head builds it here once per forward pass, and its backward runs
// here once per backward pass on the cotangent G summed over the word
// steps.  These products lie inside the TPU kernels' bodies
// (`_make_fwd_kernel`, `_make_bwd_kernel`, `_make_lstm_fwd_kernel` and
// `_make_lstm_bwd_kernel`, dvc_tpu/ops/dsa_step.py), which multiply in f32.  Bound: f32 operations
// (2 N k n each product; 3xTF32 on the tensor cores does three TF32 ones)
// at B = 16, H = 1, and the bytes of x (N, 64) w and the table at H = 8.
// At B = 1 (375 rows) the 64 x 64 tiles and their split-K chunks fill the
// SMs; dw = x^T g has few output tiles (Dh x A: 8 at cap_nheads 8) over
// many terms (B*H*S rows: 48,000), so gemm_plan cuts its terms into chunks
// until the grid fills two blocks an SM.

#include <cuda_runtime.h>

#include "dsa_common.cuh"

// x (N, k), w (k, n), table (N, n): f32, row-major, contiguous, on the
// current device; work (work_floats floats) for split-K partial tiles
// (gemm_plan's splits times N n; a shorter workspace is refused).  Returns
// cudaGetLastError() of the launches.
extern "C" int dvc_dsa_table_gemm(const float* x, const float* w, float* table,
                                  float* work, int N, int k, int n, int work_floats,
                                  void* stream) {
  if (N < 0 || k < 0 || n < 0 || work_floats < 0) return (int)cudaErrorInvalidValue;
  return (int)dsa::row_table(x, w, N, k, n, table, (cudaStream_t)stream, work,
                             (size_t)work_floats);
}

// The gradients of table = x w for its cotangent g (N, n): dx (N, k) =
// g w^T and dw (k, n) = x^T g, both fully written and deterministic (split-K
// partial tiles, in work (work_floats floats: gemm_plan's splits times the
// larger of N k and k n), are added in chunk order).  Shapes and layout as
// dvc_dsa_table_gemm.  Returns cudaGetLastError() of the launches.
extern "C" int dvc_dsa_table_gemm_bwd(const float* x, const float* w,
                                      const float* g, float* dx, float* dw,
                                      float* work, int N, int k, int n,
                                      int work_floats, void* stream) {
  using dsa::Operand;
  if (N < 0 || k < 0 || n < 0 || work_floats < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e = dsa::gemm(Operand{g, n, false}, Operand{w, n, false}, N, k, n,
                            false, dx, work, (size_t)work_floats, st);
  if (e != cudaSuccess) return (int)e;
  return (int)dsa::outer_sum(x, k, g, n, N, k, n, dw, st, work, (size_t)work_floats);
}

// dsa::gemm itself: out (M, N) (+)= X' Y' over T terms, X' (M, T) and Y'
// (T, N) each stored along its output axis or along the terms (by_term; X
// along the terms goes with Y along the terms) with leading dimension ld,
// as the kernels' outer sums (both along the terms) and G . Wc^T (both
// along their rows) run it inside their launches; work as
// dvc_dsa_table_gemm (dvc_dsa_gemm_work_floats of the shape); bf16 != 0:
// the bf16-operand mode (both operands rounded to bf16, one pass, f32
// accumulation), as the bf16 variants of K4-K6 run it.  Returns
// cudaGetLastError() of the launches.
extern "C" int dvc_dsa_gemm(const float* x, int ldx, int x_by_term, const float* y, int ldy,
                            int y_by_term, int M, int N, int T, int accumulate, float* out,
                            float* work, long long work_floats, int bf16, void* stream) {
  if (work_floats < 0) return (int)cudaErrorInvalidValue;
  return (int)dsa::gemm(dsa::Operand{x, ldx, x_by_term != 0},
                        dsa::Operand{y, ldy, y_by_term != 0}, M, N, T, accumulate != 0,
                        out, work, (size_t)work_floats, (cudaStream_t)stream, bf16 != 0);
}

