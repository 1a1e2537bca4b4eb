// Trunk multi-scale deformable attention, forward and backward, zeros-mode
// boundaries.
//
// Forward: replaces the Pallas TPU kernels `_msda_ls_kernel` and
// `_msda_kernel` (dvc_tpu/ops/ms_deform_attn.py), which build a dense (Q, S)
// one-hot interpolation matrix per (batch, head) and contract it with the
// value on the MXU.  That one-hot form is a TPU idiom; on Hopper the op is a
// gather: each output element reads 2 taps for each of the L*P sampling
// points.
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
// lengths (sum = S).  Returns cudaGetLastError() of the launch.
extern "C" int dvc_msda_fwd(const float* value, const float* loc,
                            const float* attn, float* out, int B, int S,
                            int Q, int H, int D, int L, int P,
                            const int* shapes, void* stream) {
  Levels lv;
  if (!make_levels(L, shapes, S, &lv)) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * Q * H * D;
  if (n == 0) return 0;
  const int blocks = (int)((n + kThreads - 1) / kThreads);
  msda_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      value, loc, attn, out, B, S, Q, H, D, P, lv);
  return (int)cudaGetLastError();
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
