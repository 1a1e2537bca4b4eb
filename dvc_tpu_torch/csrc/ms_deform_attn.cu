// Trunk multi-scale deformable attention, forward, zeros-mode boundaries.
//
// Replaces the Pallas TPU kernels `_msda_ls_kernel` and `_msda_kernel`
// (dvc_tpu/ops/ms_deform_attn.py), which build a dense (Q, S) one-hot
// interpolation matrix per (batch, head) and contract it with the value on
// the MXU.  That one-hot form is a TPU idiom; on Hopper the op is a gather:
// each output element reads 2 taps for each of the L*P sampling points.
//
//   out[b, q, h*D + d] = sum_{l,p} attn[b,q,h,l,p]
//        * (w_lo * value[b, s0_l + i_lo, h, d] + w_hi * value[b, s0_l + i_lo + 1, h, d])
//   pos = loc * T_l - 0.5,  i_lo = floor(pos),  w_hi = pos - i_lo,  w_lo = 1 - w_hi
//   a tap outside [0, T_l - 1] contributes 0 (zeros mode).
//
// One thread per (b, q, h, d) output element; d is the fastest index, so a
// warp reads contiguous value rows.  Bound on this card: memory latency of
// the gathers (2*L*P loads a thread, ~1.5 MB of value per batch row that
// stays in L2), not arithmetic.  The location and weight of a point are the
// same for all D threads of a head and are served by L1.
//
// pos is computed with __fmul_rn then __fsub_rn: an FMA-contracted
// loc*T - 0.5 rounds differently from the CPU/TPU reference, and floor(pos)
// would then pick another tap at exact boundaries.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;

struct Levels {
  int n;
  int T[kMaxLevels];
  int start[kMaxLevels];
};

__global__ void __launch_bounds__(kThreads)
msda_fwd_kernel(const float* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, float* __restrict__ out,
                int B, int S, int Q, int H, int D, int P, Levels lv) {
  const long long n = (long long)B * Q * H * D;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int d = (int)(i % D);
  long long t = i / D;
  const int h = (int)(t % H);
  t /= H;
  const int q = (int)(t % Q);
  const int b = (int)(t / Q);

  const int LP = lv.n * P;
  const float* lp_loc = loc + (((long long)b * Q + q) * H + h) * LP;
  const float* lp_att = attn + (((long long)b * Q + q) * H + h) * LP;
  const float* v = value + (long long)b * S * H * D + (long long)h * D + d;
  const long long row = (long long)H * D;  // stride between time steps

  float acc = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int T = lv.T[l];
    const float Tf = (float)T;
    const float* vl = v + (long long)lv.start[l] * row;
    float lvl = 0.f;
    for (int p = 0; p < P; ++p) {
      const float pos = __fsub_rn(__fmul_rn(lp_loc[l * P + p], Tf), 0.5f);
      const float f_lo = floorf(pos);
      const float w_hi = __fsub_rn(pos, f_lo);
      const float w_lo = __fsub_rn(1.f, w_hi);
      const int i_lo = (int)f_lo;
      float s = 0.f;
      if (f_lo >= 0.f && f_lo <= Tf - 1.f) s += w_lo * vl[(long long)i_lo * row];
      if (f_lo + 1.f >= 0.f && f_lo + 1.f <= Tf - 1.f)
        s += w_hi * vl[(long long)(i_lo + 1) * row];
      lvl += s * lp_att[l * P + p];
    }
    acc += lvl;
  }
  out[i] = acc;
}

}  // namespace

// value (B, S, H, D); loc, attn (B, Q, H, L, P); out (B, Q, H*D); all f32,
// contiguous, on the current device.  shapes: host array of the L level
// lengths (sum = S).  Returns cudaGetLastError() of the launch.
extern "C" int dvc_msda_fwd(const float* value, const float* loc,
                            const float* attn, float* out, int B, int S,
                            int Q, int H, int D, int L, int P,
                            const int* shapes, void* stream) {
  if (L < 1 || L > kMaxLevels) return (int)cudaErrorInvalidValue;
  Levels lv;
  lv.n = L;
  int acc = 0;
  for (int l = 0; l < L; ++l) {
    lv.T[l] = shapes[l];
    lv.start[l] = acc;
    acc += shapes[l];
  }
  if (acc != S) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Q * H * D;
  if (n == 0) return 0;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  msda_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      value, loc, attn, out, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
}
