// Masked flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Given the forward's q (BH, Nq, D), k, v (BH, Nk, D), bias (BH, Nk) fp32,
// the output cotangent dout (BH, Nq, D), the forward's per-row
// lse = m + log(l) (BH, Nq) fp32 and delta = rowsum(dout * out) (BH, Nq)
// fp32 (computed by the caller), two kernels recompute the probabilities
//   s = q k^T * scale + bias,  p = exp(s - lse),  ds = p * (dout v^T - delta)
// and accumulate
//   dkv: per key j over all queries: dv_j += p^T dout, dk_j += ds^T q * scale,
//        dbias_j += colsum(ds)
//   dq:  per query i over all keys:  dq_i += ds k * scale
// Replaces the TPU kernels regtr_tpu/ops/pallas/attention.py::_bwd_dkv_kernel
// and ::_bwd_dq_kernel (with _recompute_p_ds).  Roundings kept from them: p
// is rounded to dout's type before p^T dout, ds to q's type before ds^T q
// and ds k; every sum is fp32.  Keys past Nk and queries past Nq never
// enter a sum; a fully masked slice stays finite.
//
// What bounds it on an H100: at the training shape (BH 32, N 2240, D 32,
// fp32) dkv does 8 * BH * N^2 * D = 41 GFLOP (s, dout v^T, dv, dk) and dq
// 6 * BH * N^2 * D = 31 GFLOP (s, dout v^T, dq), with BH * N^2 = 161 M
// exponentials each, over ~4 MB of operands: bound by arithmetic.  On the
// CUDA cores' fp32 FMAs (67 TFLOP/s) that is 0.61 + 0.46 ms; on the tensor
// cores with the 3xTF32 split below (three TF32 products per product, 495
// TFLOP/s) 0.25 + 0.19 ms.  bf16 runs one bf16 product per product (989
// TFLOP/s).
//
// The design (one kernel body for both, templated on which side it owns):
//  * Tensor cores through mma.sync: bf16 operands as m16n8k16 bf16 with
//    fp32 accumulation; fp32 operands as m16n8k8 TF32 with the 3xTF32
//    split x = big + small, big = tf32_rna(x), small = tf32_rna(x - big),
//    a*b ~ small_a*big_b + big_a*small_b + big_a*big_b summed in fp32 in
//    that order.  Plain TF32 errs by ~5e-4 of the largest gradient, 3xTF32
//    by ~1e-6 (emulated on the CPU in tests/test_torch_attention_bwd.py,
//    which holds the one within the card tests' 2e-5 and shows the other
//    outside it).  The tensor cores truncate each accumulation, so the
//    gradient products add every 8-column step into their fp32 sums on the
//    CUDA cores (mma_3xtf32_rn).  Measured on an H100 by chip_smoke.py
//    (phase 3, (32, 2240, 2240, 32) with 20 % of keys masked), max |err| /
//    max |grad| against an fp64 backward: dq 2.6e-6, dk 2.4e-6, dv 2.2e-6,
//    dbias 1.2e-6, where the fp32 plain version gives 2.2e-6, 2.5e-6,
//    1.5e-6 and 7.4e-7; with the sums left in the tensor cores dq errs by
//    2.6e-5 (attention_bwd_variants.py).
//  * A block owns 64 rows, 16 per warp: keys (dkv) or queries (dq).  Those
//    rows (k and v, or q and dout) are loaded once into registers as A
//    fragments, split once for fp32.  The other side (q, dout, lse, delta,
//    or k, v, bias) streams through shared memory in 64-row tiles: cp.async
//    brings tile i + 1 while the warps compute on tile i.  For fp32 the
//    block splits each tile into big and small once, as it lands.
//  * p and ds never leave registers: the score accumulator of 16 x 8 is the
//    A operand of the next product.  The m16n8 C fragment holds columns 2t
//    and 2t + 1 where the m16n8k8 A fragment wants t and t + 4, so the fp32
//    path permutes the contraction index and reads the B rows 2t and 2t + 1
//    instead; bf16 uses the flash-attention-2 register layout and ldmatrix.
//  * fp32 fragments are laid out so that every thread reads D/4 contiguous
//    floats of a row (LDS.128) for the score products and D/8 for the
//    gradient products (the head-dim index is permuted in both, and undone
//    when the accumulators are stored); rows are padded to D + 4 floats, so
//    at D = 32 no shared-memory read conflicts.  bf16 rows are padded to
//    D + 8 halves for ldmatrix.
//  * dbias: each thread sums its ds over its columns in order, then the
//    four threads of a quad add theirs with shuffles in a fixed order.
//  * Deterministic: no atomics, every block writes only its own rows, and
//    dq stays a kernel of its own (fusing it into dkv, as flash-attention 2
//    does, needs atomic adds whose order changes from run to run).
//  * 128 threads and up to 56 KB of shared memory per block, at most 170
//    registers a thread: three blocks per SM, so the training shape's 1120
//    blocks run in 2.8 waves.  (fp32 dkv spills ~100 bytes a thread there;
//    with two blocks per SM and no spills it ran no faster.)
// What limits it now (attention_bwd_variants.py on an H100): the rate of
// the mma.sync TF32 instructions.  With one TF32 product in place of three
// the fp32 dkv takes ~0.54 ms instead of ~0.91, i.e. ~0.19 ms per pass,
// ~215 TFLOP/s of TF32; halving the shared-memory reads changes nothing,
// dropping the exp saves 4 %, skipping the split pass 10 %.
// wgmma (whose TF32 form takes only K-major shared-memory operands, which
// p^T dout and ds^T q have not) and TMA wait for a later design.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // rows a block owns, 16 per warp
constexpr int kCols = 64;           // rows of the other side per tile
constexpr int kChunk = 16;          // columns a warp takes at a time

// ------------------------------------------------------------------ PTX ---

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

// ------------------------------------------------------------- layout ---

// Shared memory of one block.  fp32: the staging tile that cp.async fills
// (the two streamed operands and their row scalars) and the split tile the
// warps read (big and small of each operand, the scalars).  bf16: two
// stages of the operands and scalars, filled and read in turn.
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStride = kF32 ? D + 4 : D + 8;  // row, elements
  static constexpr int kTile = kCols * kStride;         // one operand
  static constexpr int kOperands = kF32 ? 6 : 4;        // per block
  static constexpr size_t kBytes =
      kOperands * kTile * sizeof(T) + 4 * kCols * sizeof(float);
};

// The row scalars a tile's columns carry: lse (+inf past the edge) and
// delta (0) of queries for dkv, bias (-inf) of keys for dq.  Past the edge
// the scores become -inf and p and ds exactly 0.
template <bool kDkv>
__device__ __forceinline__ void stage_scalars(float* dst, const float* lse,
                                              const float* delta,
                                              const float* bias, int c0,
                                              int valid, int tid) {
  if (tid >= kCols) return;
  const bool in = tid < valid;
  if constexpr (kDkv) {
    if (in) {
      cp_async4(dst + tid, lse + c0 + tid, true);
      cp_async4(dst + kCols + tid, delta + c0 + tid, true);
    } else {
      dst[tid] = INFINITY;
      dst[kCols + tid] = 0.f;
    }
  } else {
    if (in)
      cp_async4(dst + tid, bias + c0 + tid, true);
    else
      dst[tid] = -INFINITY;
  }
}

// Rows [c0, c0 + kCols) of a (rows, D) operand into a tile of stride
// kStride; rows past `valid` are zeros.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int c0,
                                           int valid, bool vec16, int tid) {
  constexpr int kStride = Smem<T, D>::kStride;
  constexpr int kRowBytes = D * (int)sizeof(T);
  const char* from = reinterpret_cast<const char*>(src + (size_t)c0 * D);
  char* to = reinterpret_cast<char*>(dst);
  if (vec16) {
    constexpr int kVecs = kRowBytes / 16;
    for (int i = tid; i < kCols * kVecs; i += kThreads) {
      const int r = i / kVecs, c = 16 * (i % kVecs);
      const bool in = r < valid;
      cp_async16(to + r * kStride * (int)sizeof(T) + c,
                 in ? from + (size_t)r * kRowBytes + c : from, in);
    }
  } else {  // a base pointer off 16 bytes: 4-byte copies
    constexpr int kVecs = kRowBytes / 4;
    for (int i = tid; i < kCols * kVecs; i += kThreads) {
      const int r = i / kVecs, c = 4 * (i % kVecs);
      const bool in = r < valid;
      cp_async4(to + r * kStride * (int)sizeof(T) + c,
                in ? from + (size_t)r * kRowBytes + c : from, in);
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *bias, *lse, *delta;
  void *out1, *out2;  // dk and dv (dkv), dq and unused (dq)
  float* dbias;       // dkv only, may be null
  int nq, nk;
  float scale;
  bool vec16;  // q, k, v and dout all start on 16 bytes
};

// ------------------------------------------------------------- kernel ---

// kDkv: the block owns 64 keys and streams the queries (dk, dv, dbias);
// else it owns 64 queries and streams the keys (dq).  The two are one
// computation with the sides exchanged: with X1, X2 the owned rows (k, v or
// q, dout) and Y1, Y2 the streamed ones (q, dout or k, v),
//   s = X1 Y1^T,  dp = X2 Y2^T,  out1 += ds Y1 * scale,  out2 += p Y2 (dkv).
template <typename T, int D, bool kDkv>
__global__ void __launch_bounds__(kThreads, D >= 64 ? 2 : 3)
    flash_bwd_kernel(const BwdArgs a) {
  using L = Smem<T, D>;
  constexpr bool kF32 = L::kF32;
  constexpr int S = L::kStride;
  constexpr int kNd = D / 8;  // 8-wide blocks of the head dim
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  T* tiles = reinterpret_cast<T*>(smem);
  float* scal = reinterpret_cast<float*>(smem + L::kOperands * L::kTile *
                                                    sizeof(T));

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int n_own = kDkv ? a.nk : a.nq;
  const int n_str = kDkv ? a.nq : a.nk;
  const int warp_row = blockIdx.x * kRows + (tid / 32) * 16;
  const int r0 = warp_row + g;  // this thread's rows: r0 and r0 + 8
  const bool in0 = r0 < n_own, in1 = r0 + 8 < n_own;
  const bool warp_in = warp_row < n_own;
  const T* x1 =
      static_cast<const T*>(kDkv ? a.k : a.q) + (size_t)bh * n_own * D;
  const T* x2 =
      static_cast<const T*>(kDkv ? a.v : a.dout) + (size_t)bh * n_own * D;
  const T* y1 =
      static_cast<const T*>(kDkv ? a.q : a.k) + (size_t)bh * n_str * D;
  const T* y2 =
      static_cast<const T*>(kDkv ? a.dout : a.v) + (size_t)bh * n_str * D;
  const float* bias = a.bias + (size_t)bh * a.nk;
  const float* lse = a.lse + (size_t)bh * a.nq;
  const float* delta = a.delta + (size_t)bh * a.nq;

  // The owned rows' scalars: bias (-inf past the edge) for dkv, lse (+inf)
  // and delta for dq.
  float own_b[2] = {0.f, 0.f}, own_l[2] = {0.f, 0.f}, own_d[2] = {0.f, 0.f};
  if constexpr (kDkv) {
    own_b[0] = in0 ? bias[r0] : -INFINITY;
    own_b[1] = in1 ? bias[r0 + 8] : -INFINITY;
  } else {
    own_l[0] = in0 ? lse[r0] : INFINITY;
    own_l[1] = in1 ? lse[r0 + 8] : INFINITY;
    own_d[0] = in0 ? delta[r0] : 0.f;
    own_d[1] = in1 ? delta[r0 + 8] : 0.f;
  }

  // The owned rows as A fragments of s = X1 Y1^T and dp = X2 Y2^T.
  // fp32: step kk's contraction index t (t + 4) is head-dim column
  // t * D/4 + 2kk (+ 1), so that each thread holds D/4 contiguous columns.
  constexpr int kK1 = kF32 ? D / 8 : D / 16;  // k-steps over the head dim
  // x1s, x2s: the small parts, fp32 only
  uint32_t x1b[kK1][4], x1s[kK1][4], x2b[kK1][4], x2s[kK1][4];
  if constexpr (kF32) {
    const float* rows[2] = {
        reinterpret_cast<const float*>(x1) + (size_t)r0 * D,
        reinterpret_cast<const float*>(x2) + (size_t)r0 * D};
#pragma unroll
    for (int kk = 0; kk < kK1; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1;                        // row r0 or r0 + 8
        const int c = t * (D / 4) + 2 * kk + (i >> 1);
        const bool in = h ? in1 : in0;
        split(in ? rows[0][h * 8 * D + c] : 0.f, x1b[kk][i], x1s[kk][i]);
        split(in ? rows[1][h * 8 * D + c] : 0.f, x2b[kk][i], x2s[kk][i]);
      }
    }
  } else {
    const uint32_t* rows[2] = {
        reinterpret_cast<const uint32_t*>(x1 + (size_t)r0 * D),
        reinterpret_cast<const uint32_t*>(x2 + (size_t)r0 * D)};
#pragma unroll
    for (int kk = 0; kk < kK1; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1;
        const int c = (kk * 16 + 2 * t + 8 * (i >> 1)) / 2;  // in words
        const bool in = h ? in1 : in0;
        x1b[kk][i] = in ? rows[0][h * 4 * D + c] : 0u;
        x2b[kk][i] = in ? rows[1][h * 4 * D + c] : 0u;
      }
    }
  }

  float acc1[kNd][4], acc2[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc1[n][i] = acc2[n][i] = 0.f;
  float dbias_acc[2] = {0.f, 0.f};

  // Tile staging: fp32 into the staging area (operands 0-1, scalars 0-1),
  // bf16 into stage `st` (operands 2st, 2st+1; scalars 2st, 2st+1).
  auto stage = [&](int c0, int st) {
    const int valid = min(kCols, n_str - c0);
    T* dst = tiles + (kF32 ? 0 : 2 * st) * L::kTile;
    stage_rows<T, D>(dst, y1, c0, valid, a.vec16, tid);
    stage_rows<T, D>(dst + L::kTile, y2, c0, valid, a.vec16, tid);
    stage_scalars<kDkv>(scal + (kF32 ? 0 : 2 * st) * kCols, lse, delta, bias,
                        c0, valid, tid);
    cp_async_commit();
  };

  const int n_tiles = (n_str + kCols - 1) / kCols;
  stage(0, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int c0 = it * kCols;
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    const float* sc;  // the tile's column scalars (two arrays for dkv)
    const T* t1;      // Y1 (fp32: big; small at +2 tiles)
    const T* t2;      // Y2
    if constexpr (kF32) {
      // Split both staged operands into big (tiles 2, 3) and small (4, 5).
      constexpr int kVecs = D / 4;
      float* f = reinterpret_cast<float*>(tiles);
      for (int i = tid; i < 2 * kCols * kVecs; i += kThreads) {
        const int op = i / (kCols * kVecs), rem = i % (kCols * kVecs);
        const int at = op * L::kTile + (rem / kVecs) * S + 4 * (rem % kVecs);
        const float4 x = *reinterpret_cast<const float4*>(f + at);
        uint4 big, small;
        split(x.x, big.x, small.x);
        split(x.y, big.y, small.y);
        split(x.z, big.z, small.z);
        split(x.w, big.w, small.w);
        *reinterpret_cast<uint4*>(f + 2 * L::kTile + at) = big;
        *reinterpret_cast<uint4*>(f + 4 * L::kTile + at) = small;
      }
      if (tid < 2 * kCols) scal[2 * kCols + tid] = scal[tid];
      __syncthreads();  // the split tile is ready; the staging area is free
      sc = scal + 2 * kCols;
      t1 = tiles + 2 * L::kTile;
      t2 = tiles + 3 * L::kTile;
    } else {
      sc = scal + 2 * (it & 1) * kCols;
      t1 = tiles + 2 * (it & 1) * L::kTile;
      t2 = t1 + L::kTile;
    }
    if (it + 1 < n_tiles) stage(c0 + kCols, (it + 1) & 1);
    if (!warp_in) continue;

    const int valid = min(kCols, n_str - c0);
    for (int cc = 0; cc < valid; cc += kChunk) {
      // s and dp for this warp's 16 rows and 16 columns: two n-blocks.
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nb][i] = dp[nb][i] = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
        if constexpr (kF32) {
          const int row = cc + nb * 8 + g;  // the B operand's column g
          const float* b1 = reinterpret_cast<const float*>(t1) + row * S +
                            t * (D / 4);
          const float* b2 = reinterpret_cast<const float*>(t2) + row * S +
                            t * (D / 4);
          float v1b[D / 4], v1s[D / 4], v2b[D / 4], v2s[D / 4];
          load_vec(v1b, b1);
          load_vec(v1s, b1 + 2 * L::kTile);
          load_vec(v2b, b2);
          load_vec(v2s, b2 + 2 * L::kTile);
#pragma unroll
          for (int kk = 0; kk < kK1; ++kk) {
            mma_3xtf32(s[nb], x1b[kk], x1s[kk], v1b[2 * kk], v1b[2 * kk + 1],
                       v1s[2 * kk], v1s[2 * kk + 1]);
            mma_3xtf32(dp[nb], x2b[kk], x2s[kk], v2b[2 * kk],
                       v2b[2 * kk + 1], v2s[2 * kk], v2s[2 * kk + 1]);
          }
        } else {
          // lanes 0-7 point at the rows of head-dim columns [16kk, +8),
          // lanes 8-15 at [16kk + 8, +8)
          const int at = (cc + nb * 8 + (lane & 7)) * S + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int kk = 0; kk < kK1; ++kk) {
            uint32_t b0, b1;
            ldsm_x2(b0, b1, t1 + at + kk * 16);
            mma_bf16(s[nb], x1b[kk], b0, b1);
            ldsm_x2(b0, b1, t2 + at + kk * 16);
            mma_bf16(dp[nb], x2b[kk], b0, b1);
          }
        }
      }

      // p = exp(s * scale + bias - lse), ds = p * (dp - delta), in place.
      // __expf (ex2.approx): its error is below the products' (measured:
      // the gradients' errors against fp64 unchanged from expf's).
#pragma unroll
      for (int nb = 0; nb < 2; ++nb) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int col = cc + nb * 8 + 2 * t + (i & 1);
          const int h = i >> 1;  // row r0 or r0 + 8
          float p, ds;
          if constexpr (kDkv) {
            p = __expf(s[nb][i] * a.scale + own_b[h] - sc[col]);
            ds = p * (dp[nb][i] - sc[kCols + col]);
            dbias_acc[h] += ds;
          } else {
            p = __expf(s[nb][i] * a.scale + sc[col] - own_l[h]);
            ds = p * (dp[nb][i] - own_d[h]);
          }
          s[nb][i] = p;
          dp[nb][i] = ds;
        }
      }

      // out1 += ds Y1, out2 += p Y2 over these 16 columns.
      if constexpr (kF32) {
#pragma unroll
        for (int nb = 0; nb < 2; ++nb) {
          // The C fragment (columns 2t, 2t + 1) as the A fragment whose
          // contraction index t is column 2t and t + 4 column 2t + 1.
          uint32_t db_[4], ds_[4], pb[4], ps[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int from = ((i & 1) << 1) | (i >> 1);  // 0, 2, 1, 3
            split(dp[nb][from], db_[i], ds_[i]);
            if constexpr (kDkv) split(s[nb][from], pb[i], ps[i]);
          }
          // B[k][n]: rows 2t (b0) and 2t + 1 (b1); output column n of
          // n-block nd is head-dim column n * D/8 + nd.
          const int row = cc + nb * 8 + 2 * t;
          const float* y1r = reinterpret_cast<const float*>(t1) + row * S +
                             g * kNd;
          float u0b[kNd], u1b[kNd], u0s[kNd], u1s[kNd];
          load_vec(u0b, y1r);
          load_vec(u1b, y1r + S);
          load_vec(u0s, y1r + 2 * L::kTile);
          load_vec(u1s, y1r + 2 * L::kTile + S);
#pragma unroll
          for (int nd = 0; nd < kNd; ++nd)
            mma_3xtf32_rn(acc1[nd], db_, ds_, u0b[nd], u1b[nd], u0s[nd],
                          u1s[nd]);
          if constexpr (kDkv) {
            const float* y2r = reinterpret_cast<const float*>(t2) + row * S +
                               g * kNd;
            load_vec(u0b, y2r);
            load_vec(u1b, y2r + S);
            load_vec(u0s, y2r + 2 * L::kTile);
            load_vec(u1s, y2r + 2 * L::kTile + S);
#pragma unroll
            for (int nd = 0; nd < kNd; ++nd)
              mma_3xtf32_rn(acc2[nd], pb, ps, u0b[nd], u1b[nd], u0s[nd],
                            u1s[nd]);
          }
        }
      } else {
        // The two n-blocks' C fragments are one 16-column A fragment, with
        // p and ds rounded to bf16.
        const uint32_t dsa[4] = {pack_bf16(dp[0][0], dp[0][1]),
                                 pack_bf16(dp[0][2], dp[0][3]),
                                 pack_bf16(dp[1][0], dp[1][1]),
                                 pack_bf16(dp[1][2], dp[1][3])};
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
        // lanes 0-15 point at the rows cc .. cc + 15 of head-dim columns
        // [8nd, 8nd + 8)
        const int at = (cc + (lane & 15)) * S;
#pragma unroll
        for (int nd = 0; nd < kNd; ++nd) {
          uint32_t b0, b1;
          ldsm_x2_trans(b0, b1, t1 + at + nd * 8);
          mma_bf16(acc1[nd], dsa, b0, b1);
          if constexpr (kDkv) {
            ldsm_x2_trans(b0, b1, t2 + at + nd * 8);
            mma_bf16(acc2[nd], pa, b0, b1);
          }
        }
      }
    }
  }

  // Store this warp's rows: out1 * scale (dk or dq), out2 (dv), dbias.
  if (kDkv && a.dbias) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      dbias_acc[h] += __shfl_xor_sync(0xffffffffu, dbias_acc[h], 1);
      dbias_acc[h] += __shfl_xor_sync(0xffffffffu, dbias_acc[h], 2);
    }
    if (t == 0) {
      if (in0) a.dbias[(size_t)bh * a.nk + r0] = dbias_acc[0];
      if (in1) a.dbias[(size_t)bh * a.nk + r0 + 8] = dbias_acc[1];
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? in1 : in0)) continue;
    const size_t at = ((size_t)bh * n_own + r0 + 8 * h) * D;
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // fp32: C column n = 2t + j of n-block nd is head-dim column
        // n * D/8 + nd; bf16: column 8nd + 2t + j.
        const int c = kF32 ? (2 * t + j) * kNd + nd : nd * 8 + 2 * t + j;
        const float o1 = acc1[nd][2 * h + j] * a.scale;
        const float o2 = acc2[nd][2 * h + j];
        if constexpr (kF32) {
          static_cast<float*>(a.out1)[at + c] = o1;
          if constexpr (kDkv) static_cast<float*>(a.out2)[at + c] = o2;
        } else {
          static_cast<__nv_bfloat16*>(a.out1)[at + c] = __float2bfloat16(o1);
          if constexpr (kDkv)
            static_cast<__nv_bfloat16*>(a.out2)[at + c] = __float2bfloat16(o2);
        }
      }
    }
  }
}

template <typename T, int D, bool kDkv>
int launch(const BwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<T, D>::kBytes;
  auto kernel = flash_bwd_kernel<T, D, kDkv>;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int n_own = kDkv ? a.nk : a.nq;
  const dim3 grid((n_own + kRows - 1) / kRows, bh);
  kernel<<<grid, kThreads, kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <bool kDkv>
int dispatch(const BwdArgs& a, int bh, int d, int is_bf16, cudaStream_t s) {
  if (is_bf16) {
    switch (d) {
      case 16: return launch<__nv_bfloat16, 16, kDkv>(a, bh, s);
      case 32: return launch<__nv_bfloat16, 32, kDkv>(a, bh, s);
      case 64: return launch<__nv_bfloat16, 64, kDkv>(a, bh, s);
    }
  } else {
    switch (d) {
      case 16: return launch<float, 16, kDkv>(a, bh, s);
      case 32: return launch<float, 32, kDkv>(a, bh, s);
      case 64: return launch<float, 64, kDkv>(a, bh, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Both launch on `stream` and return the CUDA error of the launch (0 when
// it was accepted).  is_bf16: 1 for bf16 q/k/v/dout and outputs, 0 for
// fp32.  dbias may be null (no bias gradient wanted).  Shapes, contiguity
// and 4-byte alignment are checked by the caller
// (regtr_tpu_torch/ops/attention.py).
int regtr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, void* dbias, int bh, int nq, int nk,
                             int d, int is_bf16, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout,
                  static_cast<const float*>(bias),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dk, dv,
                  static_cast<float*>(dbias), nq, nk, scale,
                  on16(q) && on16(k) && on16(v) && on16(dout)};
  return dispatch<true>(a, bh, d, is_bf16, static_cast<cudaStream_t>(stream));
}

int regtr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int bh, int nq, int nk, int d, int is_bf16,
                            float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  const BwdArgs a{q, k, v, dout,
                  static_cast<const float*>(bias),
                  static_cast<const float*>(lse),
                  static_cast<const float*>(delta), dq, nullptr, nullptr,
                  nq, nk, scale,
                  on16(q) && on16(k) && on16(v) && on16(dout)};
  return dispatch<false>(a, bh, d, is_bf16, static_cast<cudaStream_t>(stream));
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
