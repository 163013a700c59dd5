// PTX helpers shared by the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu): tensor-core products through mma.sync (bf16, and fp32
// by the 3xTF32 split), ldmatrix, cp.async and the base-2 exponent.
// ops/cuda_build.py hashes every csrc/*.cuh into each library's name, so a
// change here rebuilds every source.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------- 3xTF32 ---

// cvt.rna.tf32.f32's rounding (to nearest, ties away from zero: add half of
// the 13 dropped bits to the magnitude, then clear them), done with integer
// ops: the same bits, and 5-7 % faster here than the conversion instruction.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (fp32 bit patterns with the low 13 bits 0).
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// D(16x8, fp32) += A(16x8, tf32, row) * B(8x8, tf32, col).  Fragments
// (g = lane / 4, t = lane % 4): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4],
// a3 = A[g+8][t+4]; b0 = B[t][g], b1 = B[t+4][g]; c0, c1 = C[g][2t, 2t+1],
// c2, c3 = C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b in 3xTF32, the small terms first.
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           float b0_big, float b1_big,
                                           float b0_small, float b1_small) {
  mma_tf32(c, a_small, __float_as_uint(b0_big), __float_as_uint(b1_big));
  mma_tf32(c, a_big, __float_as_uint(b0_small), __float_as_uint(b1_small));
  mma_tf32(c, a_big, __float_as_uint(b0_big), __float_as_uint(b1_big));
}

// acc += a * b in 3xTF32 with the sum into acc rounded to nearest.  The
// tensor cores truncate each accumulation; over a long contraction (a
// gradient sums all Nq or Nk columns) the truncations add up with one sign,
// to ~2e-5 of the result at N = 2240 on an H100.  So each 8-column step
// sums into a fresh register, which is added to acc on the CUDA cores.
__device__ __forceinline__ void mma_3xtf32_rn(float (&acc)[4],
                                              const uint32_t (&a_big)[4],
                                              const uint32_t (&a_small)[4],
                                              float b0_big, float b1_big,
                                              float b0_small, float b1_small) {
  float c[4] = {0.f, 0.f, 0.f, 0.f};
  mma_3xtf32(c, a_big, a_small, b0_big, b1_big, b0_small, b1_small);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += c[i];
}

// --------------------------------------------------------------- bf16 ---

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col): a0 =
// A[g][2t..2t+1], a1 = A[g+8][2t..], a2 = A[g][2t+8..], a3 = A[g+8][2t+8..];
// b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; C as for TF32.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

// ------------------------------------------------------ shared memory ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Two 8x8 bf16 matrices whose rows the lanes 0-7 and 8-15 point at: r0
// from the first, r1 from the second, lane (g, t) holding row g, columns
// 2t and 2t + 1 of each (with .trans: rows 2t and 2t + 1 of column g).
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1,
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r0), "=r"(r1)
      : "r"(smem_addr(p))
      : "memory");
}

// Four 8x8 matrices, the rows of matrix i pointed at by lanes 8i .. 8i + 7.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// Asynchronous copies to shared memory; with `in` false they read nothing
// and write zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kRows rows of a (rows, D) operand starting at `src` into a shared tile of
// row stride kStride elements, by kThreads threads; rows past `valid` are
// zeros.  vec16: src starts on 16 bytes (else 4-byte copies).
template <typename T, int D, int kStride, int kRows, int kThreads>
__device__ __forceinline__ void cp_async_rows(T* dst, const T* src,
                                              int valid, bool vec16,
                                              int tid) {
  constexpr int kRowBytes = D * (int)sizeof(T);
  const char* from = reinterpret_cast<const char*>(src);
  char* to = reinterpret_cast<char*>(dst);
  if (vec16) {
    constexpr int kVecs = kRowBytes / 16;
    for (int i = tid; i < kRows * kVecs; i += kThreads) {
      const int r = i / kVecs, c = 16 * (i % kVecs);
      const bool in = r < valid;
      cp_async16(to + r * kStride * (int)sizeof(T) + c,
                 in ? from + (size_t)r * kRowBytes + c : from, in);
    }
  } else {  // a base pointer off 16 bytes: 4-byte copies
    constexpr int kVecs = kRowBytes / 4;
    for (int i = tid; i < kRows * kVecs; i += kThreads) {
      const int r = i / kVecs, c = 4 * (i % kVecs);
      const bool in = r < valid;
      cp_async4(to + r * kStride * (int)sizeof(T) + c,
                in ? from + (size_t)r * kRowBytes + c : from, in);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* src) {
  static_assert(N % 2 == 0, "whole float2s");
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(src)[i];
      dst[4 * i] = x.x;
      dst[4 * i + 1] = x.y;
      dst[4 * i + 2] = x.z;
      dst[4 * i + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float2 x = reinterpret_cast<const float2*>(src)[i];
      dst[2 * i] = x.x;
      dst[2 * i + 1] = x.y;
    }
  }
}

// ----------------------------------------------------------- exponent ---

// 2^x by one ex2.approx.ftz.f32 (the MUFU unit; ~2 ulp, results below
// 2^-126 flushed to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
