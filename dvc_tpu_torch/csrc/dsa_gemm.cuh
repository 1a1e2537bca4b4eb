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
// * the bf16-operand mode (gemm16 and its kin, Operand16: the caption
//   kernels' bf16 variants, whose TPU kernels round both operands of every
//   product to bf16 and accumulate in f32, dsa_step.py::_make_dot('bfloat16'))
//   is a kernel of its own, gemm16_kernel, on 2-byte operands: bf16 in
//   device memory, or f32 that its producer rounds (to nearest even) in
//   registers.  Both wgmma operands come from shared memory by descriptor
//   (m64nNk16, f32 accumulate), in either major, so no layout needs a
//   transposing pass: an operand stored along the terms sits K-major in
//   64-byte swizzled rows, one stored along its rows MN-major in 128-byte
//   swizzled term lines (Tile16).  A ring of kGemm16Stages slices with
//   mbarriers: kGemm16ProducerWarps producer warps fill it (TMA boxes where
//   a bf16 operand's rows are whole 16-byte chunks, else through
//   registers), the consumer warpgroups keep one wgmma group in flight
//   (wgmma.wait_group 1) and hand a stage back once its group is done.
//   The tile and the split are the f32 mode's (gemm_plan).  What bounds it (NVIDIA H100, K5's hs_prev^T dz at 512 x 2048 over
//   41,760 terms): the operand bytes that the output tiles re-read from L2
//   (16 and 4 times with 128 x 128 tiles), not the 214 MB it must move
//   (0.064 ms) nor its 88 GFLOP (0.089 ms at 989 TFLOP/s);
// * in the f32 mode a ring of kGemmStages shared-memory slices of kGemmBK
//   terms of both raw operands, filled by cp.async (16 bytes a thread where
//   every row is 16-byte aligned, else 4) with zero fill past the edges, so
//   that the next slices load while one is split and multiplied; two
//   barriers a slice;
// * the tile and the split from the shape (gemm_plan): 128 x 128 tiles of
//   two warpgroups (64 x 128 each, m64n128k8) where they alone can fill the
//   SMs, else 64 x 64 of one (m64n64k8); with a workspace the terms are cut
//   into chunks of at least kGemmMinSlices slices until the grid fills two
//   blocks an SM, and of at most kGemmMaxSlices (wgmma's accumulation
//   error grows with a chunk's length), and a second
//   kernel adds the partial tiles in chunk order, with rounding, so two
//   runs on the same inputs are bitwise equal (both modes: a chunk ends at
//   a slice boundary or at T).
// Shared-memory rows of the raw tiles are padded (+4 floats along the
// terms, +8 along an output axis) so that the fragment loads and the split
// hit 32 distinct banks.  The kernels and the host helpers are static: one
// copy per translation unit (nvcc's stubs do not tell a nested anonymous
// namespace from the file's own).  The plan (kGemmBK, the chunks' bounds,
// gemm_plan) lives in dsa_gemm_plan.h, which the wrappers' workspace size
// also reads (dvc_dsa_gemm_work_floats).
#pragma once

#include <cuda.h>  // CUtensorMap and its encoder's types (the driver is asked at run time)
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
// destination, at blockIdx.z * M * N for split-K partial tiles.
template <int BM, int BN, bool XByTerm, bool YByTerm>
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
    // Y's slice into the big and small tiles: (row j, 4 terms from 4c)
#pragma unroll
    for (int u = 0; u < BN * kGemmBK / 4 / kThr; ++u) {
      const int p = threadIdx.x + u * kThr, j = p % BN, c = p / BN;
      float v[4];
      if (YByTerm) {
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = yt[LY::at(j, 4 * c + e)];
      } else {
        const float4 f = *reinterpret_cast<const float4*>(yt + LY::at(j, 4 * c));
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
      }
      uint4 hi, lo;
      split_tf32(v[0], hi.x, lo.x);
      split_tf32(v[1], hi.y, lo.y);
      split_tf32(v[2], hi.z, lo.z);
      split_tf32(v[3], hi.w, lo.w);
      const int at = j * kGemmBK + ((c ^ (j & 7)) * 4);
      *reinterpret_cast<uint4*>(bbig + at) = hi;
      *reinterpret_cast<uint4*>(bsmall + at) = lo;
    }
    // X's fragments: TF32 k8 (row, term) (g, q), (g + 8, q), (g, q + 4),
    // (g + 8, q + 4)
    uint32_t ab[kGemmBK / 8][4], as[kGemmBK / 8][4];
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 8; ++kk) {
      split_tf32(xt[LX::at(row0, 8 * kk + q)], ab[kk][0], as[kk][0]);
      split_tf32(xt[LX::at(row0 + 8, 8 * kk + q)], ab[kk][1], as[kk][1]);
      split_tf32(xt[LX::at(row0, 8 * kk + q + 4)], ab[kk][2], as[kk][2]);
      split_tf32(xt[LX::at(row0 + 8, 8 * kk + q + 4)], ab[kk][3], as[kk][3]);
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
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 8; ++kk) {
      const uint64_t db = sw128_desc(big_addr + 32 * kk), ds = sw128_desc(small_addr + 32 * kk);
      wgmma_tf32<BN>(acc, as[kk], db);
      wgmma_tf32<BN>(acc, ab[kk], ds);
      wgmma_tf32<BN>(acc, ab[kk], db);
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

template <int BM, int BN, bool XByTerm, bool YByTerm>
static cudaError_t launch_gemm(Operand x, Operand y, bool vec, int M, int N, int T,
                               int chunk, int splits, int accumulate, float* dst,
                               int dev, cudaStream_t stream) {
  // alignment slack, the split tiles, the raw ring
  const size_t smem = 1024 + sizeof(float) * (2 * BN * kGemmBK +
                                              kGemmStages * (GemmTile<XByTerm, BM>::kFloats +
                                                             GemmTile<YByTerm, BN>::kFloats));
  static int opted_on = -1;  // the device this kernel was opted in on
  if (opted_on != dev) {
    cudaError_t e = set_smem(gemm_kernel<BM, BN, XByTerm, YByTerm>, smem);
    if (e != cudaSuccess) return e;
    opted_on = dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  gemm_kernel<BM, BN, XByTerm, YByTerm><<<grid, 2 * BM, smem, stream>>>(
      x.p, x.ld, y.p, y.ld, (int)vec, M, N, T, chunk, accumulate, dst);
  return cudaGetLastError();
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

// the plan of out (M, N) over T terms on the current device, or an error
// where it would split and the workspace is short
static cudaError_t plan_of(int M, int N, int T, const float* work, size_t work_floats,
                           int* dev, GemmPlan* plan) {
  cudaGetDevice(dev);
  const int sms = device_sms(*dev);
  *plan = gemm_plan(M, N, T, sms, work != nullptr);
  if (plan->splits > 1 && work_floats < gemm_work_floats(M, N, T, sms))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// add the split-K partial tiles in work to out, in chunk order
static cudaError_t split_sum(const float* work, int splits, int M, int N, bool accumulate,
                             float* out, cudaStream_t stream) {
  const size_t n = (size_t)M * N;
  const int blocks = (int)std::min((n + 255) / 256, (size_t)4096);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(work, splits, n, (int)accumulate, out);
  return cudaGetLastError();
}

// out (M, N) row-major (+)= X' Y' over T terms with the operands' layouts
// fixed at compile time.  work, if not null, holds work_floats floats for
// split-K partial tiles: gemm_plan's splits need splits * M * N of them,
// and a shorter workspace is refused (cudaErrorInvalidValue).
template <bool XByTerm, bool YByTerm>
static cudaError_t gemm_as(Operand x, Operand y, int M, int N, int T, bool accumulate,
                           float* out, float* work, size_t work_floats,
                           cudaStream_t stream) {
  static_assert(!XByTerm || YByTerm, "X along the terms goes with Y along the terms");
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (T < 0 || x.by_term != XByTerm || y.by_term != YByTerm) return cudaErrorInvalidValue;
  int dev = 0;
  GemmPlan plan;
  cudaError_t e = plan_of(M, N, T, work, work_floats, &dev, &plan);
  if (e != cudaSuccess) return e;
  const bool vec = x.ld % 4 == 0 && y.ld % 4 == 0 &&
                   reinterpret_cast<size_t>(x.p) % 16 == 0 &&
                   reinterpret_cast<size_t>(y.p) % 16 == 0;
  float* dst = plan.splits > 1 ? work : out;
  const int acc = plan.splits > 1 ? 0 : (int)accumulate;
  e = plan.large ? launch_gemm<128, 128, XByTerm, YByTerm>(
                       x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream)
                 : launch_gemm<64, 64, XByTerm, YByTerm>(
                       x, y, vec, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream);
  if (e != cudaSuccess || plan.splits == 1) return e;
  return split_sum(work, plan.splits, M, N, accumulate, out, stream);
}

// gemm_as with the layouts given at run time
static cudaError_t gemm(Operand x, Operand y, int M, int N, int T, bool accumulate,
                        float* out, float* work, size_t work_floats,
                        cudaStream_t stream) {
  if (x.by_term && !y.by_term) return cudaErrorInvalidValue;  // no caller
  if (x.by_term)
    return gemm_as<true, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
  if (y.by_term)
    return gemm_as<false, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
  return gemm_as<false, false>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
}

// out (m, n) = X^T Y over N rows: X (N, m), Y (N, n), row-major with leading
// dimensions ldx, ldy (the weight gradients' reductions over (video, step,
// query) rows); deterministic
static cudaError_t outer_sum(const float* X, int ldx, const float* Y, int ldy,
                             int N, int m, int n, float* out,
                             cudaStream_t stream, float* work, size_t work_floats) {
  return gemm_as<true, true>(Operand{X, ldx, true}, Operand{Y, ldy, true}, m, n, N,
                             false, out, work, work_floats, stream);
}

// table (N, n) = X (N, k) W (k, n), both row-major: the per-video table
// value . Wc (N = B*H*S rows) and the vocabulary's embed . token_w
static cudaError_t row_table(const float* X, const float* W, int N, int k, int n,
                             float* table, cudaStream_t stream, float* work,
                             size_t work_floats) {
  return gemm_as<false, true>(Operand{X, k, false}, Operand{W, n, true}, N, n, k,
                              false, table, work, work_floats, stream);
}

// ---- the bf16-operand mode ---------------------------------------------------

constexpr int kGemm16Stages = 4;        // slices in the bf16 mode's ring
constexpr int kGemm16ProducerWarps = 2;  // warps that fill it
constexpr int kGemm16Producers = 32 * kGemm16ProducerWarps;

// an operand of the bf16 mode: bf16 in device memory, or f32 (f32 = true)
// that the producer rounds to bf16 (to nearest even) in registers
struct Operand16 {
  const void* p;
  int ld;
  bool by_term;  // element (t, i) at t*ld + i; else (i, t) at i*ld + t
  bool f32;
};

// how the producer fills an operand's tiles: bf16 rows of whole 16-byte
// chunks by TMA straight into the stage; else through registers, one
// element at a time (bf16, or f32 rounded to bf16)
enum Fill16 { kFillTma = 0, kFillBf16 = 1, kFillF32 = 2 };

// cuTensorMapEncodeTiled, asked of the driver once (null if it has none)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  static bool asked = false;
  if (!asked) {
    asked = true;
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = (EncodeTiledFn)p;
    else cudaGetLastError();
  }
  return fn;
}

// The TMA map of a bf16 operand whose rows are whole 16-byte chunks, for
// the stage tiles of Rows rows (Tile16's layout: along the terms, boxes
// of kGemmBK terms x Rows rows with the 64-byte swizzle; along its rows,
// boxes of 64 rows x kGemmBK terms with the 128-byte swizzle), what lies
// past `rows` rows or T terms read as zeros.  Returns false where the
// driver has no encoder or refuses the map.
static bool tma_map(CUtensorMap* map, const Operand16& o, int rows, int T, int Rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr || rows <= 0 || T <= 0 || o.ld % 8 != 0 ||
      reinterpret_cast<size_t>(o.p) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {(cuuint64_t)(o.by_term ? rows : T),
                              (cuuint64_t)(o.by_term ? T : rows)};
  const cuuint64_t strides[1] = {(cuuint64_t)o.ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)(o.by_term ? 64 : kGemmBK),
                             (cuuint32_t)(o.by_term ? kGemmBK : Rows)};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(o.p), dims,
                strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                o.by_term ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// one TMA copy of the box at (c0, c1) of map into shared dst, counted on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// this thread's arrival on bar, which also expects `bytes` more of TMA
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// the TMA copies of a slice's tile of an operand: terms from t0 of rows
// from i0, into the stage tile at s
template <bool ByTerm, int Rows>
__device__ __forceinline__ void tma16(uint32_t s, const CUtensorMap* map, uint32_t bar, int i0,
                                      int t0) {
  if (ByTerm) {
#pragma unroll
    for (int b = 0; b < Rows / 64; ++b) tma_load(s + 4096 * b, map, bar, i0 + 64 * b, t0);
  } else {
    tma_load(s, map, bar, t0, i0);
  }
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// A stage's bf16 tile of one operand, Rows output-axis rows x kGemmBK
// terms, in the layout wgmma reads by descriptor.  Along the terms
// (K-major): rows of 64 bytes, 16-byte chunk c of row i at c ^ (i / 2 % 4)
// (64-byte swizzle; 8-row groups 512 bytes apart).  Along its rows
// (MN-major): blocks of 64 rows, each kGemmBK term lines of 128 bytes,
// chunk c of line t at c ^ (t % 8) (128-byte swizzle; 8-line groups 1024
// bytes apart, blocks 4096).  Either way a device-memory line (a row
// along the terms, a term line along the rows) is whole 16-byte chunks.
template <bool ByTerm, int Rows>
struct Tile16 {
  static_assert(Rows % 64 == 0, "whole 64-row blocks");
  static constexpr int kBytes = Rows * kGemmBK * 2;
  static constexpr int kChunks = kBytes / 16;
  static constexpr int kPerLine = (ByTerm ? Rows : kGemmBK) / 8;  // chunks a line
  static constexpr int kStepK = ByTerm ? 16 * 128 : 32;  // bytes a k16 step
  static constexpr int kStep64 = 4096;                   // bytes a 64-row block
  // shared byte offset of chunk u (line u / kPerLine, chunk u % kPerLine)
  static __device__ __forceinline__ int offset(int u) {
    const int line = u / kPerLine, c = u % kPerLine;
    if (ByTerm) return (c / 8) * 4096 + line * 128 + (((c % 8) ^ (line % 8)) << 4);
    return line * 64 + ((c ^ ((line >> 1) & 3)) << 4);
  }
  // wgmma's descriptor of the 64 rows x 16 terms at saddr; MN-major: the
  // leading byte offset steps along M/N (64-row blocks, 4096 bytes), the
  // stride byte offset along K (8-line groups, 1024; the swapped reading
  // fails every MN-major layout on the card)
  static __device__ __forceinline__ uint64_t desc(uint32_t saddr) {
    if (!ByTerm) return sw64_desc(saddr);
    return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(4096 >> 4) << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
  }
  // chunk u's valid elements (0 to 8) and its first element's offset in
  // device memory, for terms [t0, t_end) of rows [i0, rows)
  static __device__ __forceinline__ int source(int u, int ld, int i0, int rows, int t0,
                                               int t_end, size_t& at) {
    const int line = u / kPerLine, c = (u % kPerLine) * 8;
    int n;
    if (ByTerm) {
      n = t0 + line < t_end ? rows - i0 - c : 0;
      at = (size_t)(t0 + line) * ld + i0 + c;
    } else {
      n = i0 + line < rows ? t_end - t0 - c : 0;
      at = (size_t)(i0 + line) * ld + t0 + c;
    }
    return max(0, min(8, n));
  }
};

// the producer thread pt's share of a slice, through registers: terms
// [t0, t_end) (at most kGemmBK) of rows [i0, i0 + Rows) of operand o (bf16
// or f32, rounded) into the stage tile at shared address s; what lies
// past rows or t_end is zero
template <bool ByTerm, int Rows>
__device__ __forceinline__ void load16(uint32_t s, const Operand16& o, int fill, int i0,
                                       int rows, int t0, int t_end, int pt) {
  using L = Tile16<ByTerm, Rows>;
  constexpr int kPer = L::kChunks / kGemm16Producers;  // chunks a producer thread
  constexpr int kBatch = kPer < 4 ? kPer : 4;
  static_assert(kPer % kBatch == 0, "whole batches of chunks");
  // kBatch chunks at a time with their loads issued together
  for (int v0 = 0; v0 < kPer; v0 += kBatch) {
    float x[kBatch][8];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      size_t at;
      const int take =
          L::source(pt + kGemm16Producers * (v0 + j), o.ld, i0, rows, t0, t_end, at);
      if (fill == kFillF32) {
        const float* p = static_cast<const float*>(o.p) + at;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[j][e] = e < take ? __ldg(p + e) : 0.f;
      } else {
        const __nv_bfloat16* p = static_cast<const __nv_bfloat16*>(o.p) + at;
#pragma unroll
        for (int e = 0; e < 8; ++e) x[j][e] = e < take ? __bfloat162float(p[e]) : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j)
      st_shared16(s + L::offset(pt + kGemm16Producers * (v0 + j)),
                  make_uint4(bf16_pair(x[j][0], x[j][1]), bf16_pair(x[j][2], x[j][3]),
                             bf16_pair(x[j][4], x[j][5]), bf16_pair(x[j][6], x[j][7])));
  }
}

// d (64 x 128, this warpgroup) += a (64 x 16) b (16 x 128), both bf16 by
// descriptor; TA / TB: A / B stored along M / N (MN-major), else along K
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// d (64 x 64, this warpgroup) += a (64 x 16) b (16 x 64), both bf16 by
// descriptor; TA / TB: A / B stored along M / N (MN-major), else along K
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, bool XByTerm, bool YByTerm>
__device__ __forceinline__ void wgmma16(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  if constexpr (BN == 128)
    wgmma_m64n128k16_ss<XByTerm ? 1 : 0, YByTerm ? 1 : 0>(d, da, db);
  else
    wgmma_m64n64k16_ss<XByTerm ? 1 : 0, YByTerm ? 1 : 0>(d, da, db);
}

// The bf16 mode: one (BM x BN output tile, chunk of terms) a block of BM /
// 64 consumer warpgroups (each 64 rows x BN columns, wgmma with both
// operands by descriptor) and kGemm16ProducerWarps producer warps, which
// fill a ring of kGemm16Stages slices (full[s] counts their threads and
// the TMA bytes; empty[s] the consumer warps, once their wgmma on the
// slice is done).  A
// consumer keeps one wgmma group in flight: slice k's is issued before
// slice k - 1's is waited for and its stage handed back.  chunk and out as
// gemm_kernel; xfill / yfill: fill16 of each operand.
template <int BM, int BN, bool XByTerm, bool YByTerm>
static __global__ void __launch_bounds__(2 * BM + kGemm16Producers, BM == 128 ? 2 : 4)
gemm16_kernel(Operand16 x, Operand16 y, int xfill, int yfill, int M, int N, int T,
              int chunk, int accumulate, float* __restrict__ out,
              const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap ymap) {
  static_assert((BM == 64 || BM == 128) && (BN == 64 || BN == 128), "wgmma tiles");
  constexpr int kAcc = BN / 2, kConsumerWarps = BM / 16, kS = kGemm16Stages;
  using LX = Tile16<XByTerm, BM>;
  using LY = Tile16<YByTerm, BN>;
  constexpr int kStage = LX::kBytes + LY::kBytes;
  extern __shared__ __align__(16) unsigned char gemm16_smem[];
  // the ring at the next 1024-byte boundary (the swizzle's), the barriers after it
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(gemm16_smem);
  const uint32_t ring = raw + (1024 - raw % 1024) % 1024;
  const uint32_t full = ring + kS * kStage, empty = full + 8 * kS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = blockIdx.y * BM, j0 = blockIdx.x * BN;
  const int t_begin = blockIdx.z * chunk, t_end = min(T, t_begin + chunk);
  const int slices = t_end > t_begin ? (t_end - t_begin + kGemmBK - 1) / kGemmBK : 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kS; ++s) {
      mbar_init(full + 8 * s, kGemm16Producers);
      mbar_init(empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {  // the producer
    const int pt = threadIdx.x - 2 * BM;
    const int tma_bytes = (xfill == kFillTma ? LX::kBytes : 0) + (yfill == kFillTma ? LY::kBytes : 0);
    for (int k = 0; k < slices; ++k) {
      const int s = k % kS, t0 = t_begin + k * kGemmBK;
      if (k >= kS) mbar_wait(empty + 8 * s, (k / kS - 1) & 1);
      const uint32_t st = ring + s * kStage;
      if (xfill != kFillTma)
        load16<XByTerm, BM>(st, x, xfill, i0, M, t0, min(t_end, t0 + kGemmBK), pt);
      if (yfill != kFillTma)
        load16<YByTerm, BN>(st + LX::kBytes, y, yfill, j0, N, t0, min(t_end, t0 + kGemmBK), pt);
      fence_async_shared();  // the register fills' stores, for wgmma
      if (pt == 0 && tma_bytes > 0) {
        // the TMA copies: whole boxes, zero past M, N or T (a chunk ends
        // at a slice boundary or at T)
        mbar_arrive_expect(full + 8 * s, tma_bytes);
        if (xfill == kFillTma) tma16<XByTerm, BM>(st, &xmap, full + 8 * s, i0, t0);
        if (yfill == kFillTma) tma16<YByTerm, BN>(st + LX::kBytes, &ymap, full + 8 * s, j0, t0);
      } else {
        mbar_arrive(full + 8 * s);
      }
    }
    return;
  }

  const int wg = warp / 4, g = lane / 4, q = lane % 4;
  const int row0 = wg * 64 + (warp % 4) * 16 + g;  // this thread's rows: + 0, 8
  float acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) acc[r] = 0.f;
  for (int k = 0; k < slices; ++k) {
    const int s = k % kS;
    mbar_wait(full + 8 * s, (k / kS) & 1);
    fence_async_shared();
    const uint32_t xa = ring + s * kStage + wg * LX::kStep64, ya = ring + s * kStage + LX::kBytes;
#pragma unroll
    for (int r = 0; r < kAcc; ++r) pin(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kGemmBK / 16; ++kk)
      wgmma16<BN, XByTerm, YByTerm>(acc, LX::desc(xa + kk * LX::kStepK),
                                    LY::desc(ya + kk * LY::kStepK));
    wgmma_commit();
    wgmma_wait<1>();  // slice k - 1's group is done: hand its stage back
#pragma unroll
    for (int r = 0; r < kAcc; ++r) pin(acc[r]);
    if (k > 0 && lane == 0) mbar_arrive(empty + 8 * ((k - 1) % kS));
  }
  wgmma_wait<0>();
#pragma unroll
  for (int r = 0; r < kAcc; ++r) pin(acc[r]);
  // the tile's (row, column pair) as one 8-byte store where N is even
  float* o = out + (size_t)blockIdx.z * M * N;
  const bool pairs = N % 2 == 0 && reinterpret_cast<size_t>(o) % 8 == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = i0 + row0 + 8 * h;
    if (r >= M) continue;
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
      const int c = j0 + 8 * n + 2 * q;
      const size_t at = (size_t)r * N + c;
      float2 v = make_float2(acc[4 * n + 2 * h], acc[4 * n + 2 * h + 1]);
      if (pairs && c + 1 < N) {
        float2* p = reinterpret_cast<float2*>(o + at);
        if (accumulate) {
          const float2 w = *p;
          v.x += w.x;
          v.y += w.y;
        }
        *p = v;
      } else {
        if (c < N) o[at] = accumulate ? o[at] + v.x : v.x;
        if (c + 1 < N) o[at + 1] = accumulate ? o[at + 1] + v.y : v.y;
      }
    }
  }
}

template <int BM, int BN, bool XByTerm, bool YByTerm>
static cudaError_t launch_gemm16(Operand16 x, Operand16 y, int M, int N, int T, int chunk,
                                 int splits, int accumulate, float* dst, int dev,
                                 cudaStream_t stream) {
  // alignment slack, the ring, its barriers
  const size_t smem = 1024 +
                      (size_t)kGemm16Stages * (Tile16<XByTerm, BM>::kBytes +
                                               Tile16<YByTerm, BN>::kBytes) +
                      16 * kGemm16Stages;
  static int opted_on = -1;  // the device this kernel was opted in on
  if (opted_on != dev) {
    cudaError_t e = set_smem(gemm16_kernel<BM, BN, XByTerm, YByTerm>, smem);
    if (e != cudaSuccess) return e;
    opted_on = dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  // TMA for the bf16 operands whose rows are whole 16-byte chunks, where
  // the driver encodes their maps; the rest through registers
  CUtensorMap xmap = {}, ymap = {};
  const int xfill = x.f32 ? kFillF32 : tma_map(&xmap, x, M, T, BM) ? kFillTma : kFillBf16;
  const int yfill = y.f32 ? kFillF32 : tma_map(&ymap, y, N, T, BN) ? kFillTma : kFillBf16;
  gemm16_kernel<BM, BN, XByTerm, YByTerm><<<grid, 2 * BM + kGemm16Producers, smem, stream>>>(
      x, y, xfill, yfill, M, N, T, chunk, accumulate, dst, xmap, ymap);
  return cudaGetLastError();
}

// gemm_as in the bf16 mode: the same plan, split and chunk-order sum
template <bool XByTerm, bool YByTerm>
static cudaError_t gemm16_as(Operand16 x, Operand16 y, int M, int N, int T, bool accumulate,
                             float* out, float* work, size_t work_floats,
                             cudaStream_t stream) {
  static_assert(!XByTerm || YByTerm, "X along the terms goes with Y along the terms");
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (T < 0 || x.by_term != XByTerm || y.by_term != YByTerm) return cudaErrorInvalidValue;
  int dev = 0;
  GemmPlan plan;
  cudaError_t e = plan_of(M, N, T, work, work_floats, &dev, &plan);
  if (e != cudaSuccess) return e;
  float* dst = plan.splits > 1 ? work : out;
  const int acc = plan.splits > 1 ? 0 : (int)accumulate;
  e = plan.large ? launch_gemm16<128, 128, XByTerm, YByTerm>(
                       x, y, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream)
                 : launch_gemm16<64, 64, XByTerm, YByTerm>(
                       x, y, M, N, T, plan.chunk, plan.splits, acc, dst, dev, stream);
  if (e != cudaSuccess || plan.splits == 1) return e;
  return split_sum(work, plan.splits, M, N, accumulate, out, stream);
}

// gemm16_as with the layouts given at run time
static cudaError_t gemm16(Operand16 x, Operand16 y, int M, int N, int T, bool accumulate,
                          float* out, float* work, size_t work_floats,
                          cudaStream_t stream) {
  if (x.by_term && !y.by_term) return cudaErrorInvalidValue;  // no caller
  if (x.by_term)
    return gemm16_as<true, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
  if (y.by_term)
    return gemm16_as<false, true>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
  return gemm16_as<false, false>(x, y, M, N, T, accumulate, out, work, work_floats, stream);
}

// outer_sum in the bf16 mode: out (m, n) = X^T Y over N rows, X (N, m) and
// Y (N, n) with leading dimensions X.ld, Y.ld (by_term is set here)
static cudaError_t outer_sum16(Operand16 X, Operand16 Y, int N, int m, int n, float* out,
                               cudaStream_t stream, float* work, size_t work_floats) {
  X.by_term = Y.by_term = true;
  return gemm16_as<true, true>(X, Y, m, n, N, false, out, work, work_floats, stream);
}

// row_table in the bf16 mode: table (N, n) = X (N, k) W (k, n), both
// row-major (leading dimensions k and n; by_term is set here)
static cudaError_t row_table16(Operand16 X, Operand16 W, int N, int k, int n, float* table,
                               cudaStream_t stream, float* work, size_t work_floats) {
  X.ld = k;
  X.by_term = false;
  W.ld = n;
  W.by_term = true;
  return gemm16_as<false, true>(X, W, N, n, k, false, table, work, work_floats, stream);
}

// y = x rounded to bf16 (to nearest even), n elements, 4 a thread (x and y
// 16- and 8-byte aligned)
static __global__ void round_bf16_kernel(const float* __restrict__ x,
                                         __nv_bfloat16* __restrict__ y, size_t n) {
  for (size_t i = 4 * ((size_t)blockIdx.x * blockDim.x + threadIdx.x); i < n;
       i += 4 * (size_t)gridDim.x * blockDim.x) {
    if (i + 4 <= n) {
      const float4 v = *reinterpret_cast<const float4*>(x + i);
      *reinterpret_cast<uint2*>(y + i) = make_uint2(bf16_pair(v.x, v.y), bf16_pair(v.z, v.w));
    } else {
      for (size_t j = i; j < n; ++j) y[j] = __float2bfloat16_rn(x[j]);
    }
  }
}

// a bf16 copy of n f32 values (one launch), for an operand that a kernel
// sums in f32 and the GEMM reads twice
static cudaError_t round_bf16(const float* x, void* y, size_t n, cudaStream_t stream) {
  if (n == 0) return cudaSuccess;
  if (reinterpret_cast<size_t>(x) % 16 != 0 || reinterpret_cast<size_t>(y) % 8 != 0)
    return cudaErrorInvalidValue;
  const int blocks = (int)std::min((n / 4 + 255) / 256 + 1, (size_t)4096);
  round_bf16_kernel<<<blocks, 256, 0, stream>>>(x, static_cast<__nv_bfloat16*>(y), n);
  return cudaGetLastError();
}

// a bf16 operand p with leading dimension ld, or f32 where f32
static inline Operand16 op16(const void* p, int ld, bool f32 = false) {
  return Operand16{p, ld, false, f32};
}

}  // namespace dsa
