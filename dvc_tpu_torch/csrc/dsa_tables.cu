// The per-video tables on their own: table (N, n) = x (N, k) w (k, n) and
// its backward, by dsa::gemm (dsa_gemm.cuh), the GEMM that dvc_dsa_greedy
// and dvc_dsa_scan_fwd/_bwd also run inside every launch (value_t Wc, embed
// token_w, G Wc^T and the weight gradients' outer sums).  The word-step
// kernels K7-K10 (dsa_step.cu) take VW = value_t Wc as an operand: the
// caption head builds it here once per forward pass, and its backward runs
// here once per backward pass on the cotangent G summed over the word
// steps.  These products lie inside the TPU kernels' bodies
// (`_make_fwd_kernel`, `_make_bwd_kernel`, `_make_lstm_fwd_kernel` and
// `_make_lstm_bwd_kernel`, dvc_tpu/ops/dsa_step.py), which multiply in f32,
// or at precision='bfloat16' on bf16-rounded operands with f32 accumulation:
// the bf16 argument runs dsa::gemm's bf16-operand mode, so VW = bf16(x)
// bf16(w), and the backward bf16(g) bf16(w)^T and bf16(x)^T bf16(g) (the
// word steps' G summed over the steps is rounded once), on operands stored
// in bf16 or in f32 (rounded by the GEMM's producer warp).  Bound: f32 operations
// (2 N k n each product; 3xTF32 on the tensor cores does three TF32 ones)
// at B = 16, H = 1, and the bytes of x (N, 64) w and the table at H = 8.
// At B = 1 (375 rows) the 64 x 64 tiles and their split-K chunks fill the
// SMs; dw = x^T g has few output tiles (Dh x A: 8 at cap_nheads 8) over
// many terms (B*H*S rows: 48,000), so gemm_plan cuts its terms into chunks
// until the grid fills two blocks an SM.

#include <cuda_runtime.h>

#include "dsa_common.cuh"

// the bf16-mode operand whose storage bit `bit` of the flags names: bf16
// where set, else f32
static dsa::Operand16 flagged(const void* p, int ld, int flags, int bit) {
  return dsa::op16(p, ld, (flags >> bit & 1) == 0);
}

// x (N, k), w (k, n), table (N, n): row-major, contiguous, on the current
// device; work (work_floats floats) for split-K partial tiles (gemm_plan's
// splits times N n; a shorter workspace is refused).  bf16: 0 the f32 mode
// (3xTF32, x and w f32); else bit 0 set, the bf16-operand mode, with x
// stored in bf16 where bit 1 is set (else f32, rounded by the GEMM's
// producer) and w where bit 2 is.  Returns cudaGetLastError() of the
// launches.
extern "C" int dvc_dsa_table_gemm(const void* x, const void* w, float* table,
                                  float* work, int N, int k, int n, int work_floats,
                                  int bf16, void* stream) {
  if (N < 0 || k < 0 || n < 0 || work_floats < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 != 0)
    return (int)dsa::row_table16(flagged(x, k, bf16, 1), flagged(w, n, bf16, 2), N, k, n,
                                 table, st, work, (size_t)work_floats);
  return (int)dsa::row_table(static_cast<const float*>(x), static_cast<const float*>(w), N,
                             k, n, table, st, work, (size_t)work_floats);
}

// The gradients of table = x w for its cotangent g (N, n): dx (N, k) =
// g w^T and dw (k, n) = x^T g, both fully written and deterministic (split-K
// partial tiles, in work (work_floats floats: gemm_plan's splits times the
// larger of N k and k n), are added in chunk order).  Shapes and layout as
// dvc_dsa_table_gemm, bf16 as there, with g stored in bf16 where bit 3 is
// set.  Returns cudaGetLastError() of the launches.
extern "C" int dvc_dsa_table_gemm_bwd(const void* x, const void* w, const void* g,
                                      float* dx, float* dw, float* work, int N, int k,
                                      int n, int work_floats, int bf16, void* stream) {
  using dsa::Operand;
  if (N < 0 || k < 0 || n < 0 || work_floats < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t wf = (size_t)work_floats;
  cudaError_t e;
  if (bf16 != 0) {
    e = dsa::gemm16(flagged(g, n, bf16, 3), flagged(w, n, bf16, 2), N, k, n, false, dx,
                    work, wf, st);
    if (e != cudaSuccess) return (int)e;
    return (int)dsa::outer_sum16(flagged(x, k, bf16, 1), flagged(g, n, bf16, 3), N, k, n,
                                 dw, st, work, wf);
  }
  const float* xf = static_cast<const float*>(x);
  const float* wf32 = static_cast<const float*>(w);
  const float* gf = static_cast<const float*>(g);
  e = dsa::gemm(Operand{gf, n, false}, Operand{wf32, n, false}, N, k, n, false, dx, work,
                wf, st);
  if (e != cudaSuccess) return (int)e;
  return (int)dsa::outer_sum(xf, k, gf, n, N, k, n, dw, st, work, wf);
}

// dsa::gemm itself: out (M, N) (+)= X' Y' over T terms, X' (M, T) and Y'
// (T, N) each stored along its output axis or along the terms (by_term; X
// along the terms goes with Y along the terms) with leading dimension ld,
// as the kernels' outer sums (both along the terms) and G . Wc^T (both
// along their rows) run it inside their launches; work as
// dvc_dsa_table_gemm (dvc_dsa_gemm_work_floats of the shape); bf16: 0 the
// f32 mode (3xTF32, x and y f32), else bit 0 set, the bf16-operand mode
// (one pass, f32 accumulation), with x stored in bf16 where bit 1 is set
// and y where bit 2 is (else f32, rounded to bf16 by the GEMM's producer).
// Returns cudaGetLastError() of the launches.
extern "C" int dvc_dsa_gemm(const void* x, int ldx, int x_by_term, const void* y, int ldy,
                            int y_by_term, int M, int N, int T, int accumulate, float* out,
                            float* work, long long work_floats, int bf16, void* stream) {
  if (work_floats < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (bf16 != 0) {
    dsa::Operand16 xo = flagged(x, ldx, bf16, 1), yo = flagged(y, ldy, bf16, 2);
    xo.by_term = x_by_term != 0;
    yo.by_term = y_by_term != 0;
    return (int)dsa::gemm16(xo, yo, M, N, T, accumulate != 0, out, work, (size_t)work_floats,
                            st);
  }
  return (int)dsa::gemm(dsa::Operand{static_cast<const float*>(x), ldx, x_by_term != 0},
                        dsa::Operand{static_cast<const float*>(y), ldy, y_by_term != 0}, M,
                        N, T, accumulate != 0, out, work, (size_t)work_floats, st);
}
