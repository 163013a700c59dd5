// The brute radius-neighbor search for Hopper (sm_90a), plain C interface.
//
// For each query of each cloud: the k supports nearest to it within the
// radius, nearest first, as int64 ids into the cloud's supports; the slots
// left over, and every slot of a masked query, hold Ns (the shadow id).
// The function is ops/neighbors.py `brute_radius_neighbors_plain`, bit for
// bit:
//   * distances in fp32 by the expansion, each sum in one fixed order:
//     |q|^2 = (x*x + y*y) + z*z, the same for |s|^2, q.s = (qx*sx + qy*sy)
//     + qz*sz, d = (|q|^2 - 2*(q.s)) + |s|^2, with __fmul_rn / __fadd_rn so
//     that nvcc contracts nothing into an FMA;
//   * the selection key is d rounded to bf16 (to nearest, ties to even)
//     when Ns >= 4k, and d itself otherwise (the plain version's
//     `use_exact`);
//   * a support is taken when its key <= thr, the fp32 threshold r^2 *
//     1.004 that the wrapper computes as the plain version does;
//   * order: by key, then by support id (jax.lax.top_k's rule for ties).
//     Keys are compared as their order-preserving 32-bit images (the sign
//     bit flipped for a positive float, every bit for a negative one), so
//     -0 sorts below +0, as in the plain version's int64 keys;
//   * a masked support never enters a table (the plain version moves it
//     10^6 away, where no key can pass the threshold).
//
// Replaces the TPU's own partial reduction: regtr_tpu/ops/neighbors.py:215
// `brute_radius_neighbors`, whose selection is `jax.lax.approx_min_k`
// (:267) over bf16 keys of an MXU distance matrix.  That is a primitive of
// the TPU, not a Pallas kernel.  The plain PyTorch version materialises each
// query chunk's (B, 4096, Ns) distances and keys and runs torch.topk over
// them: memory-bound and several kernels per search.
//
// What bounds it on an H100: arithmetic.  Each candidate (query, support)
// costs 8 fp32 operations (the 3-term dot, the doubling, two adds, the
// compare) on the CUDA cores (67 TFLOP/s): 7.96e9 candidates per 3DMatch
// inference forward at bucket 20480 (4 pairs, 10 searches), about 0.95 ms.
// Bytes are far below that: each block reads its cloud's supports once
// from L2, and the output is 8 bytes a slot.
//
// Design: one thread per query, grid (query blocks, clouds), 128 queries
// a block, or 64 or 32 where 128 would give fewer than two blocks per SM
// (the coarse levels, ModelNet's clouds: more, smaller blocks spread the
// work over more SMs).  The supports stream through shared memory in
// tiles of kTile points, each as float4 (x, y, z, |s|^2) (a masked
// support as (0, 0, 0, inf): its distance is inf and no test passes it),
// read by every thread of the block at once (a broadcast).  A tile whose
// supports are all masked is skipped, and so is a block whose queries are
// all masked.  Each thread keeps its sorted list of at most k (key, id)
// pairs as 64-bit words (key image << 32 | id) in a local array: within
// the radius lie ~25-35 of the 2k-20k supports scanned, so an insertion
// is rare and the list stays in L1.  The hot loop, unrolled 8 times, is
// the distance and one compare of it against `lim`, a bound that every
// accepted support's distance lies below (the threshold, or the list's
// worst key once the list is full, widened by one bf16 step where the key
// is rounded); only a support that passes it computes its exact key and
// is inserted.  Supports arrive in increasing id, so an insertion placed
// after every equal key keeps the (key, id) order, and a full list takes
// a support only with a key below its worst.  No atomics and no order
// between threads: the table is the same bits on every run.
//
// Measured on an H100 (kernel_variants.py --neighbors, the ten searches of
// a 3DMatch forward): the first design (128 queries a block everywhere,
// the scan unrolled 4 times, tiles of 2048) took 15.0 ms, this one with
// tiles of 2048 12.4 ms and with tiles of 1024 11.2 ms.  Keeping the lists
// takes most of it: a variant that keeps nothing scans the same supports
// in 4.5 ms.  Appending until a list fills, then sorting, was slower
// (17.3 ms).  Not done yet (ROADMAP B2.1): the lists' cost, culling
// support tiles by their bounds (level 0 is spatially sorted), and
// staging the tiles with cp.async.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // the most queries a block
constexpr int kTile = 1024;  // supports per shared-memory tile (16 KB)

// The order-preserving 32-bit image of a float's bits.
__device__ __forceinline__ uint32_t ordered(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

__device__ __forceinline__ float sq3(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)),
                   __fmul_rn(z, z));
}

template <bool kBf16>
__device__ __forceinline__ float key_of(float d) {
  if (kBf16) return __bfloat162float(__float2bfloat16_rn(d));
  return d;
}

// The hot loop's bound for a key limit t: every d whose key is <= t is <=
// it.  A bf16 key is within half a bf16 step (2^-8 relative, or half the
// smallest subnormal step near 0) of d, so t widened by 2^-7 of |t| and by
// 1e-37 bounds it; an fp32 key is d itself.
template <bool kBf16>
__device__ __forceinline__ float hot_bound(float t) {
  if (kBf16) return __fadd_rn(__fadd_rn(t, fabsf(t) * 0.0078125f), 1e-37f);
  return t;
}

template <int kMaxK, bool kBf16>
__global__ void __launch_bounds__(kThreads)
    brute_neighbors_kernel(const float* __restrict__ queries,
                           const uint8_t* __restrict__ q_mask,
                           const float* __restrict__ supports,
                           const uint8_t* __restrict__ s_mask, int nq, int ns,
                           int k, float thr, long long* __restrict__ out) {
  __shared__ float4 tile[kTile];
  const int b = blockIdx.y;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const size_t qrow = (size_t)b * nq + i;
  const bool active = i < nq && q_mask[qrow] != 0;
  long long* row = out + qrow * k;
  if (!__syncthreads_or(active)) {
    if (i < nq)
      for (int j = 0; j < k; ++j) row[j] = ns;
    return;
  }
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[qrow * 3];
    qy = queries[qrow * 3 + 1];
    qz = queries[qrow * 3 + 2];
  }
  const float qsq = sq3(qx, qy, qz);
  const uint32_t thr_key = ordered(thr);
  uint64_t list[kMaxK];
  int count = 0;
  float lim = hot_bound<kBf16>(thr);
  const float* sb = supports + (size_t)b * ns * 3;
  const uint8_t* smb = s_mask + (size_t)b * ns;

  for (int base = 0; base < ns; base += kTile) {
    const int n = min(kTile, ns - base);
    int any = 0;
    for (int t = threadIdx.x; t < n; t += blockDim.x) {
      const int j = base + t;
      float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
      if (smb[j]) {
        v.x = sb[(size_t)j * 3];
        v.y = sb[(size_t)j * 3 + 1];
        v.z = sb[(size_t)j * 3 + 2];
        v.w = sq3(v.x, v.y, v.z);
        any = 1;
      }
      tile[t] = v;
    }
    if (__syncthreads_or(any) && active) {
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const float4 s = tile[t];
        const float dot = __fadd_rn(
            __fadd_rn(__fmul_rn(qx, s.x), __fmul_rn(qy, s.y)),
            __fmul_rn(qz, s.z));
        const float d = __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.0f, dot)), s.w);
        if (d <= lim) {  // rare: the exact test and the insertion
          const uint32_t key = ordered(key_of<kBf16>(d));
          const bool take = count < k
                                ? key <= thr_key
                                : key < (uint32_t)(list[k - 1] >> 32);
          if (take) {
            const uint64_t c = ((uint64_t)key << 32) | (uint32_t)(base + t);
            int pos = count < k ? count : k - 1;
            while (pos > 0 && list[pos - 1] > c) {
              list[pos] = list[pos - 1];
              --pos;
            }
            list[pos] = c;
            if (count < k) ++count;
            if (count == k)
              lim = hot_bound<kBf16>(unordered((uint32_t)(list[k - 1] >> 32)));
          }
        }
      }
    }
    __syncthreads();
  }
  if (i < nq)
    for (int j = 0; j < k; ++j)
      row[j] = j < count ? (long long)(uint32_t)list[j] : (long long)ns;
}

template <int kMaxK>
int launch(const float* q, const uint8_t* qm, const float* s,
           const uint8_t* sm, int batch, int nq, int ns, int k, float thr,
           int bf16_key, long long* out, cudaStream_t stream) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int threads = kThreads;
  while (threads > 32 &&
         (long long)batch * ((nq + threads - 1) / threads) < 2LL * sms)
    threads /= 2;
  const dim3 grid((unsigned)((nq + threads - 1) / threads), (unsigned)batch);
  if (bf16_key)
    brute_neighbors_kernel<kMaxK, true>
        <<<grid, threads, 0, stream>>>(q, qm, s, sm, nq, ns, k, thr, out);
  else
    brute_neighbors_kernel<kMaxK, false>
        <<<grid, threads, 0, stream>>>(q, qm, s, sm, nq, ns, k, thr, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest k the kernels take.
int regtr_neighbors_max_k() { return 256; }

// Launches on `stream`; returns cudaGetLastError() after the launch.
// queries: (batch, nq, 3) fp32, q_mask: (batch, nq) bool, supports:
// (batch, ns, 3) fp32, s_mask: (batch, ns) bool, all contiguous; thr: the
// acceptance threshold; bf16_key: 1 to select on bf16-rounded distances,
// 0 on the fp32 ones; out: (batch, nq, k) int64, every slot written.
// Checked by the caller (regtr_tpu_torch/ops/neighbors.py).
int regtr_brute_neighbors(const void* queries, const void* q_mask,
                          const void* supports, const void* s_mask,
                          long long batch, long long nq, long long ns,
                          int k, float thr, int bf16_key, void* out,
                          void* stream) {
  if (batch <= 0 || batch > 65535 || nq <= 0 || ns <= 0 || k <= 0 ||
      nq >= (1LL << 31) || ns >= (1LL << 31) ||
      k > regtr_neighbors_max_k())
    return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(queries);
  const auto* qm = static_cast<const uint8_t*>(q_mask);
  const auto* s = static_cast<const float*>(supports);
  const auto* sm = static_cast<const uint8_t*>(s_mask);
  auto* o = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= 64)
    return launch<64>(q, qm, s, sm, (int)batch, (int)nq, (int)ns, k, thr,
                      bf16_key, o, st);
  return launch<256>(q, qm, s, sm, (int)batch, (int)nq, (int)ns, k, thr,
                     bf16_key, o, st);
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
