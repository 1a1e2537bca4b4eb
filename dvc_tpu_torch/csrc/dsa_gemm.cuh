// dsa::gemm, the f32 GEMM under every per-video table, table backward and
// weight gradient's outer sum of the port:
//
//   out (M, N) (+)= X' Y' summed over T terms,   X' (M, T), Y' (T, N)
//
// An operand is stored either along its output axis (X (M, T) or Y (N, T):
// element (i, t) at p[i*ld + t], "K-major") or along the terms (X (T, M) or
// Y (T, N): element (t, i) at p[t*ld + i]).  The callers use three of the
// four pairs: the tables value . Wc and embed . token_w (row_table: X along
// its rows, Y along the terms), dvalue's G . Wc^T and the table backward's
// g . w^T (both along their rows), and the outer sums X^T Y over (video,
// step, query) rows (outer_sum: both along the terms).  These products lie
// inside the TPU kernels' bodies: K4-K10 in dvc_tpu/ops/dsa_scan.py,
// dsa_greedy.py and dsa_step.py, which multiply in f32.
//
// What bounds it on the H100: f32 operations at the outer sums' and the
// tables' widths (512 x 2048 over 41,760 rows in the scan backward), output
// tiles too few for 132 SMs where the tables are small (B = 1: 375 rows),
// and the bytes of the tables with few terms (H = 8: 64).  So:
// * the tensor cores at f32 accuracy (3xTF32): each element splits into a
//   TF32 high part and a TF32 remainder, big = tf32(a), small =
//   tf32(a - big), and wgmma.mma_async (TF32 in, f32 accumulate) sums
//   small.big + big.small + big.big (the dropped small.small is below f32's
//   rounding); no one-pass TF32 anywhere.  TF32 wgmma takes B only K-major
//   from shared memory, so each slice of Y is split once into big and small
//   tiles, K-major with 128-byte swizzled rows, whatever Y's layout in
//   device memory; X's fragments are split in registers (A from registers);
// * the bf16-operand mode (Bf16: the caption kernels' bf16 variants K4-K6,
//   whose TPU kernels round both operands of every product to bf16 and
//   accumulate in f32, dsa_step.py::_make_dot('bfloat16')): each element is
//   rounded to bf16 (to nearest even), and each 16 terms are one bf16
//   wgmma (k16, f32 accumulate); Y's slice is rounded once into
//   one tile, K-major with 64-byte swizzled rows (kGemmBK bf16), X's
//   fragments are rounded and paired in registers;
// * a ring of kGemmStages shared-memory slices of kGemmBK terms of both raw
//   operands, filled by cp.async (16 bytes a thread where every row is
//   16-byte aligned, else 4) with zero fill past the edges, so that the
//   next slices load while one is split and multiplied; two barriers a
//   slice;
// * the tile and the split from the shape (gemm_plan): 128 x 128 tiles of
//   two warpgroups (64 x 128 each, m64n128k8) where they alone can fill the
//   SMs, else 64 x 64 of one (m64n64k8); with a workspace the terms are cut
//   into chunks of at least kGemmMinSlices slices until the grid fills two
//   blocks an SM, and of at most kGemmMaxSlices (wgmma's accumulation
//   error grows with a chunk's length), and a second
//   kernel adds the partial tiles in chunk order, with rounding, so two
//   runs on the same inputs are bitwise equal.
// Shared-memory rows of the raw tiles are padded (+4 floats along the
// terms, +8 along an output axis) so that the fragment loads and the split
// hit 32 distinct banks.  The kernels and the host helpers are static: one
// copy per translation unit (nvcc's stubs do not tell a nested anonymous
// namespace from the file's own).  The plan (kGemmBK, the chunks' bounds,
// gemm_plan) lives in dsa_gemm_plan.h, which the wrappers' workspace size
// also reads (dvc_dsa_gemm_work_floats).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "dsa_gemm_plan.h"

namespace dsa {

constexpr int kGemmStages = 2;  // raw slices in the shared-memory ring

struct Operand {
  const float* p;
  int ld;
  bool by_term;  // element (t, i) at p[t*ld + i]; else (i, t) at p[i*ld + t]
};

// opt a kernel into `smem` bytes of dynamic shared memory, or refuse
template <typename Kernel>
static cudaError_t set_smem(Kernel kernel, size_t smem) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)max_smem) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = big + small: big is x rounded to TF32 (to nearest, ties away: the
// carry of the 13 dropped bits, two integer operations), small = x - big
// is exact in f32 and |small| <= 2^-11 |x|; the tensor core reads small's
// top 19 bits (TF32), so the pair keeps x to within 2^-21 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// x rounded to bf16 (to nearest even) as f32 bits
__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return __float_as_uint(__bfloat162float(__float2bfloat16_rn(x)));
}

// lo and hi rounded to bf16 (to nearest even), packed: lo in the low half
__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// A stage's tile of one operand: Rows output-axis rows x kGemmBK terms,
// stored as in device memory (along the terms: rows of Rows + 8 floats;
// else rows of kGemmBK + 4)
template <bool ByTerm, int Rows>
struct GemmTile {
  static constexpr int kStride = ByTerm ? Rows + 8 : kGemmBK + 4;
  static constexpr int kFloats = ByTerm ? kGemmBK * kStride : Rows * kStride;
  static __device__ __forceinline__ int at(int i, int t) {
    return ByTerm ? t * kStride + i : i * kStride + t;
  }
};

// queue the copy of terms [t0, t0 + kGemmBK) of rows [i0, i0 + Rows) of an
// operand into its tile s; what lies past rows or t_end reads as zeros
template <bool ByTerm, int Rows, int Threads>
__device__ __forceinline__ void gemm_load(float* s, const float* __restrict__ p, int ld,
                                          bool vec, int i0, int rows, int t0,
                                          int t_end) {
  using L = GemmTile<ByTerm, Rows>;
  constexpr int kChunks = Rows * kGemmBK / 4, kPerRow = (ByTerm ? Rows : kGemmBK) / 4;
  static_assert(kChunks % Threads == 0, "whole chunks a thread");
  if (vec) {
#pragma unroll
    for (int u = 0; u < kChunks / Threads; ++u) {
      const int c = threadIdx.x + u * Threads;
      const int major = c / kPerRow, minor = (c % kPerRow) * 4;
      const int i = ByTerm ? minor : major, t = ByTerm ? major : minor;
      const int n = ByTerm ? (t0 + t < t_end ? rows - i0 - i : 0)
                           : (i0 + i < rows ? t_end - t0 - t : 0);
      const int take = max(0, min(4, n));
      const float* src = take > 0 ? p + (ByTerm ? (size_t)(t0 + t) * ld + i0 + i
                                                : (size_t)(i0 + i) * ld + t0 + t)
                                  : p;
      cp_async16(s + L::at(i, t), src, 4 * take);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < 4 * kChunks / Threads; ++u) {
      const int e = threadIdx.x + u * Threads;
      const int i = ByTerm ? e % Rows : e / kGemmBK, t = ByTerm ? e / Rows : e % kGemmBK;
      const bool in = i0 + i < rows && t0 + t < t_end;
      const float* src = in ? p + (ByTerm ? (size_t)(t0 + t) * ld + i0 + i
                                          : (size_t)(i0 + i) * ld + t0 + t)
                            : p;
      cp_async4(s + L::at(i, t), src, in ? 4 : 0);
    }
  }
}

// ---- wgmma -----------------------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// generic-proxy stores to shared memory, seen by the async proxy (wgmma)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// keep the compiler from moving an accumulator across the async wgmma
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }

// K-major operand of 8-row groups of 128-byte rows, 128-byte swizzle, at
// shared address saddr (1024-byte aligned, plus 32 bytes a k8 step)
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d (64 x 128, this warpgroup) += a (64 x 8, registers) b (8 x 128, desc)
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64, this warpgroup) += a (64 x 8, registers) b (8 x 64, desc)
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32], const uint32_t (&a)[4],
                                               uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// K-major operand of 8-row groups of 64-byte rows, 64-byte swizzle, at
// shared address saddr (512-byte aligned, plus 32 bytes a k16 step)
__device__ __forceinline__ uint64_t sw64_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(512 >> 4) << 32) | ((uint64_t)2 << 62);
}

// d (64 x 128, this warpgroup) += a (64 x 16 bf16, registers) b (16 x 128
// bf16, desc, K-major)
__device__ __forceinline__ void wgmma_m64n128k16_bf16(float (&d)[64], const uint32_t (&a)[4],
                                                      uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// d (64 x 64, this warpgroup) += a (64 x 16 bf16, registers) b (16 x 64
// bf16, desc, K-major)
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32], const uint32_t (&a)[4],
                                                     uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_bf16(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BN == 128)
    wgmma_m64n128k16_bf16(d, a, desc);
  else
    wgmma_m64n64k16_bf16(d, a, desc);
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2], const uint32_t (&a)[4],
                                           uint64_t desc) {
  if constexpr (BN == 128)
    wgmma_m64n128k8(d, a, desc);
  else
    wgmma_m64n64k8(d, a, desc);
}

// One (BM x BN output tile, chunk of terms) a block of BM / 64 warpgroups,
// each owning 64 rows x BN columns: its X fragments in registers, Y's split
// tiles (BN rows x kGemmBK terms, 16-byte chunk c of row j at c ^ (j % 8))
// by descriptor.  chunk: terms per blockIdx.z; out is the tile's
// destination, at blockIdx.z * M * N for split-K partial tiles.  Bf16: the
// bf16-operand mode, Y's one bf16 tile (BN rows x kGemmBK terms, 16-byte
// chunk c of row j at c ^ (j / 2 % 4)) in place of the split tiles.
template <int BM, int BN, bool XByTerm, bool YByTerm, bool Bf16>
static __global__ void __launch_bounds__(2 * BM, BM == 128 ? 2 : 4)
gemm_kernel(const float* __restrict__ X, int ldx, const float* __restrict__ Y, int ldy,
            int vec, int M, int N, int T, int chunk, int accumulate,
            float* __restrict__ out) {
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128), "wgmma tiles");
  constexpr int kThr = 2 * BM, kAcc = BN / 2;
  using LX = GemmTile<XByTerm, BM>;
  using LY = GemmTile<YByTerm, BN>;
  extern __shared__ __align__(16) float gemm_smem[];
  // the split tiles first, at the next 1024-byte boundary (the swizzle's)
  const uint32_t base = (uint32_t)__cvta_generic_to_shared(gemm_smem);
  float* bbig = gemm_smem + ((1024 - base % 1024) % 1024) / 4;
  float* bsmall = bbig + BN * kGemmBK;
  float* xs = bsmall + BN * kGemmBK;
  float* ys = xs + kGemmStages * LX::kFloats;
  const uint32_t big_addr = (uint32_t)__cvta_generic_to_shared(bbig);
  const uint32_t small_addr = (uint32_t)__cvta_generic_to_shared(bsmall);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, q = lane % 4;
  const int row0 = (warp / 4) * 64 + (warp % 4) * 16 + g;  // this thread's rows: + 0, 8
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int t_begin = blockIdx.z * chunk, t_end = min(T, t_begin + chunk);
  const int slices = t_end > t_begin ? (t_end - t_begin + kGemmBK - 1) / kGemmBK : 0;
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;

  auto load = [&](int slice) {
    const int st = slice % kGemmStages, t0 = t_begin + slice * kGemmBK;
    gemm_load<XByTerm, BM, kThr>(xs + st * LX::kFloats, X, ldx, vec, i0, M, t0, t_end);
    gemm_load<YByTerm, BN, kThr>(ys + st * LY::kFloats, Y, ldy, vec, j0, N, t0, t_end);
  };
#pragma unroll
  for (int s = 0; s < kGemmStages; ++s) {
    if (s < slices) load(s);
    cp_async_commit();
  }
  for (int k = 0; k < slices; ++k) {
    cp_async_wait<kGemmStages - 1>();
    // slice k has landed for every thread, and every thread (and its
    // wgmma) is done with the split tiles of slice k - 1
    __syncthreads();
    const float* xt = xs + (k % kGemmStages) * LX::kFloats;
    const float* yt = ys + (k % kGemmStages) * LY::kFloats;
    // Y's slice into the big and small tiles: (row j, 4 terms from 4c); in
    // the bf16-operand mode into the bf16 tile: (row j, 8 terms from 8c)
    constexpr int kTerms = Bf16 ? 8 : 4;
#pragma unroll
    for (int u = 0; u < BN * kGemmBK / kTerms / kThr; ++u) {
      const int p = threadIdx.x + u * kThr, j = p % BN, c = p / BN;
      float v[kTerms];
      if (YByTerm) {
#pragma unroll
        for (int e = 0; e < kTerms; ++e) v[e] = yt[LY::at(j, kTerms * c + e)];
      } else {
#pragma unroll
        for (int e = 0; e < kTerms; e += 4) {
          const float4 f = *reinterpret_cast<const float4*>(yt + LY::at(j, kTerms * c + e));
          v[e] = f.x; v[e + 1] = f.y; v[e + 2] = f.z; v[e + 3] = f.w;
        }
      }
      if constexpr (Bf16) {
        const uint4 w = make_uint4(bf16_pair(v[0], v[1]), bf16_pair(v[2], v[3]),
                                   bf16_pair(v[4], v[5]), bf16_pair(v[6], v[7]));
        *reinterpret_cast<uint4*>(bbig + j * (kGemmBK / 2) + ((c ^ ((j >> 1) & 3)) * 4)) = w;
      } else {
        uint4 hi, lo;
        split_tf32(v[0], hi.x, lo.x);
        split_tf32(v[1], hi.y, lo.y);
        split_tf32(v[2], hi.z, lo.z);
        split_tf32(v[3], hi.w, lo.w);
        const int at = j * kGemmBK + ((c ^ (j & 7)) * 4);
        *reinterpret_cast<uint4*>(bbig + at) = hi;
        *reinterpret_cast<uint4*>(bsmall + at) = lo;
      }
    }
    // X's fragments: TF32 k8 (row, term) (g, q), (g + 8, q), (g, q + 4),
    // (g + 8, q + 4); bf16 k16 the pairs of terms (2q, 2q + 1) and
    // (2q + 8, 2q + 9) of the same rows
    uint32_t ab[kGemmBK / 8][4], as[kGemmBK / 8][4];
    if constexpr (Bf16) {
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = row0 + 8 * (r & 1), t = 16 * kk + 2 * q + 8 * (r >> 1);
          ab[kk][r] = bf16_pair(xt[LX::at(i, t)], xt[LX::at(i, t + 1)]);
        }
    } else {
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 8; ++kk) {
        split_tf32(xt[LX::at(row0, 8 * kk + q)], ab[kk][0], as[kk][0]);
        split_tf32(xt[LX::at(row0 + 8, 8 * kk + q)], ab[kk][1], as[kk][1]);
        split_tf32(xt[LX::at(row0, 8 * kk + q + 4)], ab[kk][2], as[kk][2]);
        split_tf32(xt[LX::at(row0 + 8, 8 * kk + q + 4)], ab[kk][3], as[kk][3]);
      }
    }
    // the split tiles are complete, and every thread has read slice k's
    // raw stage: refill it
    fence_async_shared();
    __syncthreads();
    if (k + kGemmStages < slices) load(k + kGemmStages);
    cp_async_commit();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) pin(acc[r]);
    wgmma_fence();
    if constexpr (Bf16) {
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 16; ++kk)
        wgmma_bf16<BN>(acc, ab[kk], sw64_desc(big_addr + 32 * kk));
    } else {
#pragma unroll
      for (int kk = 0; kk < kGemmBK / 8; ++kk) {
        const uint64_t db = sw128_desc(big_addr + 32 * kk), ds = sw128_desc(small_addr + 32 * kk);
        wgmma_tf32<BN>(acc, as[kk], db);
        wgmma_tf32<BN>(acc, ab[kk], ds);
        wgmma_tf32<BN>(acc, ab[kk], db);
      }
    }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < kAcc; ++r) pin(acc[r]);
  }
  cp_async_wait<0>();
  float* o = out + (size_t)blockIdx.z * M * N;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i0 + row0 + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = j0 + 8 * n + 2 * q + u;
        if (c >= N) continue;
        const size_t at = (size_t)r * N + c;
        const float v = acc[4 * n + 2 * h + u];
        o[at] = accumulate ? o[at] + v : v;
      }
  }
}

// out[i] (+)= sum_z part[z][i] in chunk order
static __global__ void split_sum_kernel(const float* __restrict__ part, int splits,
                                        size_t n, int accumulate,
                                        float* __restrict__ out) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = accumulate ? out[i] : 0.f;
    for (int z = 0; z < splits; ++z) s += part[(size_t)z * n + i];
    out[i] = s;
  }
}

// the SM count of device dev, asked once
static int device_sms(int dev) {
  static int sms[64] = {};
  if (dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  return sms[dev];
}

template <int BM, int BN, bool XByTerm, bool YByTerm, bool Bf16>
static cudaError_t launch_gemm(Operand x, Operand y, bool vec, int M, int N, int T,
                               int chunk, int splits, int accumulate, float* dst,
                               int dev, cudaStream_t stream) {
  // alignment slack, the split tiles, the raw ring
  const size_t smem = 1024 + sizeof(float) * (2 * BN * kGemmBK +
                                              kGemmStages * (GemmTile<XByTerm, BM>::kFloats +
                                                             GemmTile<YByTerm, BN>::kFloats));
  static int opted_on = -1;  // the device this kernel was opted in on
  if (opted_on != dev) {
    cudaError_t e = set_smem(gemm_kernel<BM, BN, XByTerm, YByTerm, Bf16>, smem);
    if (e != cudaSuccess) return e;
    opted_on = dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_kernel<BM, BN, XByTerm, YByTerm, Bf16><<<grid, 2 * BM, smem, stream>>>(
      x.p, x.ld, y.p, y.ld, (int)vec, M, N, T, chunk, accumulate, dst);
  return cudaGetLastError();
}

// out (M, N) row-major (+)= X' Y' over T terms with the operands' layouts
// fixed at compile time.  work, if not null, holds work_floats floats for
// split-K partial tiles: gemm_plan's splits need splits * M * N of them,
// and a shorter workspace is refused (cudaErrorInvalidValue).  bf16: the
// bf16-operand mode (see the top of this file).
template <bool XByTerm, bool YByTerm>
static cudaError_t gemm_as(Operand x, Operand y, int M, int N, int T, bool accumulate,
                           float* out, float* work, size_t work_floats,
                           cudaStream_t stream, bool bf16 = false) {
  static_assert(!XByTerm || YByTerm, "X along the terms goes with Y along the terms");
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (T < 0 || x.by_term != XByTerm || y.by_term != YByTerm) return cudaErrorInvalidValue;
  int dev = 0;
  cudaGetDevice(&dev);
  const int sms = device_sms(dev);
  const GemmPlan plan = gemm_plan(M, N, T, sms, work != nullptr);
  if (plan.splits > 1 && work_floats < gemm_work_floats(M, N, T, sms))
    return cudaErrorInvalidValue;
  const bool vec = x.ld % 4 == 0 && y.ld % 4 == 0 &&
                   reinterpret_cast<size_t>(x.p) % 16 == 0 &&
                   reinterpret_cast<size_t>(y.p) % 16 == 0;
  float* dst = plan.splits > 1 ? work : out;
  const int acc = plan.splits > 1 ? 0 : (int)accumulate;
  cudaError_t e;
  if (bf16)
    e = plan.large ? launch_gemm<128, 128, XByTerm, YByTerm, true>(
                         x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream)
                   : launch_gemm<64, 64, XByTerm, YByTerm, true>(
                         x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream);
  else
    e = plan.large ? launch_gemm<128, 128, XByTerm, YByTerm, false>(
                         x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream)
                   : launch_gemm<64, 64, XByTerm, YByTerm, false>(
                         x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream);
  if (e != cudaSuccess || plan.splits == 1) return e;
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min((n + 255) / 256, (size_t)4096);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(work, plan.splits, n, (int)accumulate, out);
  return cudaGetLastError();
}

// gemm_as with the layouts given at run time
static cudaError_t gemm(Operand x, Operand y, int M, int N, int T, bool accumulate,
                        float* out, float* work, size_t work_floats,
                        cudaStream_t stream, bool bf16 = false) {
  if (x.by_term && !y.by_term) return cudaErrorInvalidValue;  // no caller
  if (x.by_term)
    return gemm_as<true, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream,
                               bf16);
  if (y.by_term)
    return gemm_as<false, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream,
                                bf16);
  return gemm_as<false, false>(x, y, M, N, T, accumulate, out, work, work_floats, stream,
                               bf16);
}

// out (m, n) = X^T Y over N rows: X (N, m), Y (N, n), row-major with leading
// dimensions ldx, ldy (the weight gradients' reductions over (video, step,
// query) rows); deterministic
static cudaError_t outer_sum(const float* X, int ldx, const float* Y, int ldy,
                             int N, int m, int n, float* out,
                             cudaStream_t stream, float* work, size_t work_floats,
                             bool bf16 = false) {
  return gemm_as<true, true>(Operand{X, ldx, true}, Operand{Y, ldy, true}, m, n, N,
                             false, out, work, work_floats, stream, bf16);
}

// table (N, n) = X (N, k) W (k, n), both row-major: the per-video table
// value . Wc (N = B*H*S rows) and the vocabulary's embed . token_w
static cudaError_t row_table(const float* X, const float* W, int N, int k, int n,
                             float* table, cudaStream_t stream, float* work,
                             size_t work_floats, bool bf16 = false) {
  return gemm_as<false, true>(Operand{X, k, false}, Operand{W, n, true}, N, n, k,
                              false, table, work, work_floats, stream, bf16);
}

}  // namespace dsa
