// GeoTransformer's geometric structure embedding for Hopper (sm_90a), plain
// C interface.
//
//   out[c, i, j] = proj_d(code(d_ij / sigma_d))
//                  + max over x of proj_a(code(angle(p_x - p_i, p_j - p_i)
//                                               * factor_a))
//
// per cloud c, query row i and key j < counts[c]; zeros at j >= counts[c].
// code(v) is the d-wide sinusoidal code (sin and cos of v * div[f]
// interleaved), proj_* fp32 linears of d x d with bias, x runs over the
// angle_k (3) angle neighbours of i that the caller chose (knn).
//
// It replaces no TPU kernel: the JAX package has no GeoTransformer.  Its
// plain version (ops/geo_embedding.py) writes each of the four codes to
// device memory (C x M x M x d fp32: 2 GiB at the 3DMatch cell's (8, 512,
// 512, 256)), reads each back into a cuBLAS fp32 GEMM on the FMA units,
// writes each product and then the max and the sum.  Here the codes live
// only in registers and the products in registers; the one store is the
// result.
//
// What bounds it on an H100: the products, 4 codes x 2 d^2 FLOP a (i, j)
// pair, as 3xTF32 (three TF32 products for each fp32 one) at 495 TFLOP/s:
// 3.3 TFLOP at the cell's full grid, ~6.7 ms, ~5.2 over the key tiles that
// hold a valid key.  The store (2 GiB at 3.35 TB/s: 0.64 ms) and the
// sinusoids (M^2 C x 4 x d/2 sincosf, each computed by two blocks) are
// below that.
//
// The design:
//  * A block owns 2 query rows x 64 keys of one cloud and 128 of the d
//    output columns: two warpgroups, one a query row, each a 64 x 128 tile
//    of wgmma m64n128k8 (tf32, A from registers, B from shared memory).
//    A thread keeps T, the code being contracted, and M, the running max
//    of the angle terms, 64 fp32 registers each.
//  * The codes are contracted in chunks of 32 frequencies (64 columns).
//    Each warp makes its 16 rows' A fragments in registers: sincosf of the
//    row's value (full precision: the plain CUDA path's sin and cos), split
//    into TF32 big + small.  The contraction index is permuted so that a
//    thread's fragment holds the sin and the cos of one frequency (columns
//    t and t + 4 of an 8-wide k-step are code columns 2f and 2f + 1, f = 4
//    s + t): one sincosf feeds both.  The next k-step's sinusoids are made
//    while the tensor cores run this one's products.
//  * The weights, split once per weight version by the wrapper into TF32
//    big and small parts in the k-major core-matrix layout (no swizzle),
//    arrive a chunk ahead by cp.async into a double buffer.
//  * 3xTF32: each k-step runs A_small B_big, A_big B_small, A_big B_big
//    into F, a fresh accumulator for the chunk (the first product with
//    scale-d 0), which is added to T on the CUDA cores: the tensor cores'
//    truncating accumulation stays within one chunk (64 products of a
//    sum of 256; a chunk of 32 errs less, 0.90e-6 against 1.49e-6 at the
//    card test's case, but takes 10.4 ms against 9.3).
//  * Epilogue of each code, in the plain version's order: M = T + b_a
//    (first angle), M = max(M, T + b_a) (the others); last the distance,
//    out = (T + b_d) + M.  The angles go first so that two register sets
//    suffice.
//  * Key tiles at or past the cloud's valid count (valid keys are a
//    prefix) compute nothing: their blocks store zeros.  The plain version
//    zeros the same entries, so the two agree everywhere; no reader uses
//    them (the self-attention masks padded keys).
//  * Per (i, j) the row values follow the module's formulas with their
//    roundings: p_j - p_i, ((dx dx + dy dy) + dz dz), sqrt, times the fp32
//    reciprocal of sigma_d (PyTorch's CUDA division by a scalar), and
//    atan2(|r x v|, r . v) times factor_a, r . v never -0 (at j = i).
//  * Deterministic: no atomics, each block writes only its own entries.
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "sm90_ptx.cuh"

namespace {

constexpr int kThreads = 256;              // two warpgroups
constexpr int kQueries = 2;                // query rows a block, one a WG
constexpr int kKeys = 64;                  // keys a tile
constexpr int kRows = kQueries * kKeys;    // GEMM rows a block
constexpr int kCols = 128;                 // output columns a block
constexpr int kAngles = 3;                 // angle neighbours
constexpr int kCodes = kAngles + 1;        // the angles, then the distance
constexpr int kSteps = 8;                  // 8-wide k-steps a chunk
constexpr int kChunkCols = 8 * kSteps;     // code columns a chunk
// One part (big or small) of a weight chunk: [k-step][8-column group][k
// half][8 columns][4 k] floats, core matrices of 8 x 16 bytes
constexpr int kPartFloats = kSteps * (kCols / 8) * 2 * 8 * 4;
constexpr int kBFloats = 2 * kPartFloats;  // big, then small
constexpr int kMaxD = 1024;

struct Args {
  const float* points;  // (C, M, 3)
  const int* knn;       // (C, M, kAngles)
  const int* counts;    // (C,) valid keys a cloud (a prefix)
  const float* div;     // (D / 2,) frequencies
  const float* wd;      // proj_d's weight split (ops/geo_embedding.py)
  const float* bd;      // (D,)
  const float* wa;      // proj_a's weight split
  const float* ba;      // (D,)
  float* out;           // (C, M, M, D)
  int m, d;
  float inv_sigma_d, factor_a;
};

struct __align__(128) Smem {
  float b[2][kBFloats];
  float x[kCodes][kRows];  // the codes' values of each row
  float div[kMaxD / 2];
};

// ------------------------------------------------------------- wgmma ---

// A k-major weight slice of 8 k x 128 columns without swizzle: core
// matrices 128 bytes apart along k (LBO), 256 bytes along the columns
// (SBO).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// d(64 x 128, fp32) (+)= a(64 x 8, tf32, registers) * b(8 x 128, tf32,
// shared memory); a's fragment per warp is mma.m16n8k8's, d's per 8
// columns j: d[4j .. 4j + 3] = rows g, g, g + 8, g + 8, columns 8j + 2t,
// + 1.  accumulate 0: d = a * b.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pins a register across the asynchronous products that read or write it:
// the compiler may neither reuse it nor move its other uses past this.
__device__ __forceinline__ void keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// cp.async's writes to shared memory, visible to wgmma's reads
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ----------------------------------------------------------- the rows ---

__device__ __forceinline__ float3 load_point(const float* p, int i) {
  return make_float3(p[3 * i], p[3 * i + 1], p[3 * i + 2]);
}

__device__ __forceinline__ float3 sub_rn(float3 a, float3 b) {
  return make_float3(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z));
}

// The values each code takes at the block's rows: the three angles, then
// the distance.  Rows past the extent get 0 (computed, never stored).
__device__ void row_values(Smem& s, const Args& a, int c, int i0, int j0,
                           int tid) {
  for (int r = tid; r < kRows; r += kThreads) {
    const int i = i0 + r / kKeys, j = j0 + r % kKeys;
    float v[kCodes] = {0.f, 0.f, 0.f, 0.f};
    if (i < a.m && j < a.m) {
      const float* pc = a.points + (size_t)c * a.m * 3;
      const float3 pi = load_point(pc, i);
      const float3 e = sub_rn(load_point(pc, j), pi);
      const float sq = __fadd_rn(__fadd_rn(__fmul_rn(e.x, e.x),
                                           __fmul_rn(e.y, e.y)),
                                 __fmul_rn(e.z, e.z));
      v[kAngles] = __fmul_rn(sqrtf(sq), a.inv_sigma_d);
      const int* nb = a.knn + ((size_t)c * a.m + i) * kAngles;
#pragma unroll
      for (int x = 0; x < kAngles; ++x) {
        const float3 r = sub_rn(load_point(pc, nb[x]), pi);
        const float cx = r.y * e.z - r.z * e.y;
        const float cy = r.z * e.x - r.x * e.z;
        const float cz = r.x * e.y - r.y * e.x;
        const float sn = sqrtf((cx * cx + cy * cy) + cz * cz);
        // + 0: the sum's -0 (every product -0) is +0, as PyTorch's sum
        // starts from +0; atan2(0, -0) would be pi
        const float cs = __fadd_rn(
            __fadd_rn(__fadd_rn(__fmul_rn(r.x, e.x), __fmul_rn(r.y, e.y)),
                      __fmul_rn(r.z, e.z)),
            0.f);
        v[x] = __fmul_rn(atan2f(sn, cs), a.factor_a);
      }
    }
#pragma unroll
    for (int x = 0; x < kCodes; ++x) s.x[x][r] = v[x];
  }
}

// A lane's A fragments of one k-step: sin and cos of its rows g and g + 8
// (values x0, x1) at frequency w, split into TF32 big and small parts.
__device__ __forceinline__ void code_step(uint32_t (&big)[4],
                                          uint32_t (&small)[4], float x0,
                                          float x1, float w) {
  float s0, c0, s1, c1;
  sincosf(__fmul_rn(x0, w), &s0, &c0);
  sincosf(__fmul_rn(x1, w), &s1, &c1);
  split(s0, big[0], small[0]);  // a0 = A[g][t]
  split(s1, big[1], small[1]);  // a1 = A[g + 8][t]
  split(c0, big[2], small[2]);  // a2 = A[g][t + 4]
  split(c1, big[3], small[3]);  // a3 = A[g + 8][t + 4]
}

__device__ __forceinline__ void stage_weights(float* dst, const float* src,
                                              int tid) {
  for (int i = tid; i < kBFloats / 4; i += kThreads)
    cp_async16(dst + 4 * i, src + 4 * i, true);
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 1)
    geo_embedding_kernel(const Args a) {
  extern __shared__ float4 smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int pairs = (a.m + kQueries - 1) / kQueries;
  const int c = blockIdx.z / pairs, i0 = kQueries * (blockIdx.z % pairs);
  const int j0 = blockIdx.y * kKeys, col0 = blockIdx.x * kCols;
  const int valid = min(a.counts[c], a.m);
  float* out = a.out + (size_t)c * a.m * a.m * a.d;

  if (j0 >= valid) {  // a tile of padded keys: zeros
    constexpr int kVecs = kCols / 4;
    for (int e = tid; e < kRows * kVecs; e += kThreads) {
      const int r = e / kVecs, i = i0 + r / kKeys, j = j0 + r % kKeys;
      if (i < a.m && j < a.m)
        reinterpret_cast<float4*>(out + ((size_t)i * a.m + j) * a.d +
                                  col0)[e % kVecs] =
            make_float4(0.f, 0.f, 0.f, 0.f);
    }
    return;
  }

  const int chunks = a.d / kChunkCols;  // a code's chunks
  const int iters = kCodes * chunks;
  const size_t w_tile = (size_t)blockIdx.x * chunks * kBFloats;
  for (int f = tid; f < a.d / 2; f += kThreads) s.div[f] = a.div[f];
  stage_weights(s.b[0], a.wa + w_tile, tid);
  row_values(s, a, c, i0, j0, tid);
  cp_async_wait_all();
  fence_proxy_async();
  __syncthreads();

  // warpgroup wg: query i0 + wg; its warp wq: keys j0 + 16 wq + g (+ 8)
  const int wg = warp >> 2, wq = warp & 3;
  const int r0 = wg * kKeys + 16 * wq + g;  // the lane's rows r0, r0 + 8
  float acc[64], best[64], fresh[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = best[e] = fresh[e] = 0.f;
  uint32_t big[2][4], small[2][4];

#pragma unroll 1
  for (int it = 0; it < iters; ++it) {
    const int cur = it & 1, code = it / chunks, q = it % chunks;
    if (it + 1 < iters) {
      const int next_code = (it + 1) / chunks;
      stage_weights(s.b[cur ^ 1],
                    (next_code == kAngles ? a.wd : a.wa) + w_tile +
                        (size_t)((it + 1) % chunks) * kBFloats,
                    tid);
    }
    const float x0 = s.x[code][r0], x1 = s.x[code][r0 + 8];
    const float* wbig = s.b[cur];
    const float* wsmall = s.b[cur] + kPartFloats;
#pragma unroll
    for (int step = 0; step < kSteps; ++step) {
      const int u = step & 1;
      if (step >= 2) {  // the products that read this buffer are done
        wgmma_wait<1>();
#pragma unroll
        for (int e = 0; e < 4; ++e) keep(big[u][e]), keep(small[u][e]);
      }
      code_step(big[u], small[u], x0, x1,
                s.div[q * (kChunkCols / 2) + 4 * step + t]);
      const int off = step * (kPartFloats / kSteps);
      wgmma_fence();
      wgmma_tf32(fresh, small[u], b_desc(wbig + off), step);
      wgmma_tf32(fresh, big[u], b_desc(wsmall + off), 1);
      wgmma_tf32(fresh, big[u], b_desc(wbig + off), 1);
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) keep(big[u][e]), keep(small[u][e]);
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      keep(fresh[e]);
      acc[e] += fresh[e];
    }

    if (q == chunks - 1) {  // the code is complete
      const float* bias = code == kAngles ? a.bd : a.ba;
      const int i = i0 + wg, j = j0 + 16 * wq + g;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int col = col0 + 8 * n + 2 * t;
        const float2 bv = *reinterpret_cast<const float2*>(bias + col);
        float y[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[e] = __fadd_rn(acc[4 * n + e], e & 1 ? bv.y : bv.x);
          acc[4 * n + e] = 0.f;
        }
        if (code < kAngles) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            best[4 * n + e] = code == 0 ? y[e] : fmaxf(best[4 * n + e], y[e]);
          continue;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (i >= a.m || j + 8 * h >= a.m) continue;
          *reinterpret_cast<float2*>(out + ((size_t)i * a.m + j + 8 * h) *
                                               a.d + col) =
              j + 8 * h < valid
                  ? make_float2(__fadd_rn(y[2 * h], best[4 * n + 2 * h]),
                                __fadd_rn(y[2 * h + 1],
                                          best[4 * n + 2 * h + 1]))
                  : make_float2(0.f, 0.f);
        }
      }
    }
    cp_async_wait_all();
    fence_proxy_async();
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error of the launch (0 when it was
// accepted).  d a multiple of 128 up to 1024; knn (C, M, 3) int32 indices
// below M; wd / wa proj_d's and proj_a's weights split into TF32 big and
// small parts in the kernel's layout (ops/geo_embedding.py `split_weight`).
// Shapes, dtypes, contiguity and alignment are checked by the caller
// (regtr_tpu_torch/ops/geo_embedding.py).
int regtr_geo_embedding(const void* points, const void* knn,
                        const void* counts, const void* div, const void* wd,
                        const void* bd, const void* wa, const void* ba,
                        void* out, int c, int m, int d, float inv_sigma_d,
                        float factor_a, void* stream) {
  if (c <= 0 || m <= 0 || d <= 0 || d % kCols || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  const int pairs = (m + kQueries - 1) / kQueries;
  if ((long long)c * pairs > 65535 || (m + kKeys - 1) / kKeys > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{static_cast<const float*>(points),
               static_cast<const int*>(knn),
               static_cast<const int*>(counts),
               static_cast<const float*>(div),
               static_cast<const float*>(wd),
               static_cast<const float*>(bd),
               static_cast<const float*>(wa),
               static_cast<const float*>(ba),
               static_cast<float*>(out),
               m,
               d,
               inv_sigma_d,
               factor_a};
  const cudaError_t err =
      cudaFuncSetAttribute(geo_embedding_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(d / kCols, (m + kKeys - 1) / kKeys, c * pairs);
  geo_embedding_kernel<<<grid, kThreads, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
