// dsa::gemm's plan (dsa_gemm_plan.h) for the host: the wrappers size their
// launches' split-K workspace with dvc_dsa_gemm_work_floats
// (dvc_tpu_torch/ops/_cuda.py::gemm_work).  Plain C++: nvcc builds it into
// the kernel library, and tests/test_torch_gemm.py builds it alone with the
// host's C++ compiler to check the rule on the CPU.

#include "dsa_gemm_plan.h"

// floats of split-K partial tiles that out (M, N) over T terms takes on
// `sms` SMs (0: not split); a launch given fewer is refused
extern "C" long long dvc_dsa_gemm_work_floats(int M, int N, int T, int sms) {
  return (long long)dsa::gemm_work_floats(M, N, T, sms);
}

// the plan with a workspace, into plan[3]: 128 x 128 tiles (1) or 64 x 64
// (0), the chunks of the terms, the terms a chunk
extern "C" void dvc_dsa_gemm_plan(int M, int N, int T, int sms, int* plan) {
  const dsa::GemmPlan p = dsa::gemm_plan(M, N, T, sms, true);
  plan[0] = p.large ? 1 : 0;
  plan[1] = p.splits;
  plan[2] = p.chunk;
}
