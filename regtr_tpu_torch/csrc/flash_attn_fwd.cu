// Masked flash-attention forward for Hopper (sm_90a), plain C interface.
//
//   out = softmax(q k^T * scale + bias) v      per (bh) slice
//   q: (BH, Nq, D), k, v: (BH, Nk, D) in fp32 or bf16, bias: (BH, Nk) fp32,
//   an additive per-key bias (0 for valid keys, -1e9 for masked ones).
//
// Replaces the TPU kernel regtr_tpu/ops/pallas/attention.py::_kernel (the
// forward behind flash_masked_attention), with its optional lse output:
// lse = m + log(l) per query row, fp32, natural-log units, written when the
// caller passes a pointer (the training forward; the backward recomputes p
// from it).  Semantics kept: fp32 scores, running max, running sum and
// accumulator; the bias added per key; p rounded to the operand type before
// the p*v product, as the TPU kernel does; a fully masked row is the
// bias-weighted mean, not zeros.  Keys beyond Nk (the ragged edge of the last
// tile) are left out of the softmax entirely.  Launched on the caller's
// stream; it allocates nothing and does not synchronise.
//
// Key extents (optional, (BH,) int32 on the device): one past the index of
// each slice's last valid key.  A block then runs only the key tiles up to
// its slice's extent, not all ceil(Nk / 64): the coarse level of a 3DMatch
// batch holds ~350 points in slots of 2240, so 6 of 35 tiles.  The caller
// vouches that every key at or past the extent has the masking bias.  Once
// a row has met a valid key its running max is finite, a masked key's
// 2^(x - m) is exactly 0 and alpha exactly 1, so the tiles left out would
// have changed neither out nor lse in a single bit.  An extent of 0 (a slice
// with no valid key) runs every tile, so such a slice's bias-weighted mean
// stays as it was.  The grid is sized from the shapes alone: no host sync.
//
// What bounds it on an H100: the largest of
//  * bytes: q, k, v, bias read once and out written once, over 3.35 TB/s;
//  * products: 4 * BH * Nq * Nk * D FLOP at the rate of the instruction the
//    design runs: 989 TFLOP/s bf16, 495 / 3 TFLOP/s for fp32 as 3xTF32;
//  * exponentials: BH * Nq * Nk of them at 16 per SM per clock (ex2 on the
//    MUFU units; 132 SMs at 1.98 GHz: 4.18e12 per second).
// At d = 32 a score costs 2d = 64 product FLOPs per exponential, so this
// design's bf16 is bound by its exponentials (64 x 1872^2: 0.054 ms against
// 0.029 ms of products), fp32 by its three TF32 products (32 x 2240^2: 0.125
// ms against 0.038 ms of exponentials).  The exponent term assumes every
// 2^x on the MUFU units, as this kernel computes it: it bounds this design,
// not the function (a kernel that evaluates part of the 2^x as a polynomial
// on the FMA pipe could go below it, down to the products' 0.029 ms).  Everything quadratic stays out of device
// memory: scores and p live in registers.
//
// The design: a block owns 64 query rows, 16 per warp, held in registers as
// the A fragments of s = q k^T.  k, v and the bias stream through shared
// memory in 64-key tiles by cp.async: the next tile lands while the warps
// compute on the current one.  Per tile each warp computes its 16 x 64
// scores on the tensor cores, the online softmax on the CUDA cores, and p v
// on the tensor cores with p taken from the score registers as the A
// operand (the flash-attention-2 register layout).
//  * bf16: mma.sync m16n8k16 with fp32 accumulation; a ring of three stages
//    of k, v and bias; k's fragments by ldmatrix and v's by ldmatrix.trans
//    from row-major v (no transposition in shared memory); rows padded to
//    D + 8 halves so that the ldmatrix rows hit distinct banks.
//  * fp32: mma.sync m16n8k8 TF32 with the backward's 3xTF32 split
//    (x = big + small, a*b ~ small_a*big_b + big_a*small_b + big_a*big_b):
//    q is split once into big and small A fragments, each k and v tile once
//    as it lands (a staging tile that cp.async fills and a split tile the
//    warps read: the two stages of the ring).  The contraction index is
//    permuted so that each thread reads D/4 (scores) or D/8 (p v)
//    contiguous floats of a row, padded to D + 4 (conflict-free LDS.128),
//    and p's C fragment is the A fragment of p v with its columns 2t, 2t + 1
//    read as contraction indices t, t + 4.  The tensor cores truncate each
//    accumulation, so p v over a tile sums into fresh registers that are
//    added on the CUDA cores to the fp32 accumulator rescaled by alpha; s
//    (D long) stays in the tensor cores.  No plain-TF32 path: one TF32 pass
//    errs ~1e-3 and fails the 2e-5 tolerance.
//  * Fewer CUDA-core operations per score: scores are kept in base 2, the
//    scale * log2(e) folded into one FMA with the bias pre-multiplied by
//    log2(e) (once per tile element, in shared memory), and the exponent is
//    one ex2.approx.  lse is converted back once per row: (m2 + log2 l) ln 2.
//    In the last bits this changes: scale * log2(e) and bias * log2(e) are
//    rounded once each (relative 6e-8 of a score), ex2.approx errs ~2 ulp
//    and flushes p below 2^-126 to 0, and the lse's conversion adds ~1 ulp.
//    Measured against the plain version on an H100 (chip_smoke.py phase 3)
//    and emulated on the CPU (tests/test_torch_attention.py) the result
//    stays inside bf16 2e-2, fp32 2e-5 and lse 1e-4 + 1e-6 relative.  A fully
//    masked row's scores sit at -1e9 * log2(e) and its lse rounds to the
//    bias, as the TPU kernel's does; it stays finite: the running max starts
//    at -1e30, never -inf, so no inf - inf arises.
//  * Deterministic: no atomics, each block writes only its own rows.
//
// Measured on an H100 (kernel_variants.py --forward, in turns with
// the earlier design, whose fp32 ran on FMAs and whose bf16 copied tiles
// synchronously): fp32 (32, 2240, 2240, 32) ~0.50 ms against ~1.11, bf16
// (64, 1872, 1872, 32) ~0.20 ms against ~0.33.  What limits them now:
//  * fp32: the three TF32 passes (with one pass, wrong on purpose, ~0.31 ms)
//    and the split pass (~16 %); 168 registers, 64 bytes spilled.
//  * bf16: not the exponent (without it, wrong on purpose, no faster) but
//    the latency of each warp's chain of dependent steps at 4 blocks per SM
//    (128 registers; capped at 102 or 85 it spills and runs slower).  A
//    wgmma form of bf16 (one warpgroup per block, A from registers, no
//    overlap of one tile's softmax with the next tile's products) gave the
//    same results at ~0.29 ms and is not kept; PERF.md records it.
// With key extents, at the inference benchmark's coarse level (fp32 (64,
// 2240, 2240, 32), 280-420 valid keys a slice, 17 % of the key tiles run):
// ~0.18 ms back to back against ~0.95 without them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_ptx.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlockQ = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBlockK = 64;           // keys per tile
constexpr int kNb = kBlockK / 8;      // 8-key blocks of a tile's scores
constexpr int kStagesBf16 = 3;        // bf16 ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdArgs {
  const void *q, *k, *v;
  const float* bias;
  void* out;
  float* lse;            // may be null
  const int* kv_extent;  // (BH,) key extents, or null: every slice's is nk
  int nq, nk;
  float scale_log2;  // scale * log2(e)
  bool vec16;        // q, k and v all start on 16 bytes
};

// Shared memory of one block.  fp32: the staging tile cp.async fills (k, v,
// bias) and the split tile the warps read (k big, v big, k small, v small,
// bias * log2 e).  bf16: kStagesBf16 stages of k, v and bias.
template <typename T, int D>
struct Smem {
  static constexpr bool kF32 = std::is_same<T, float>::value;
  static constexpr int kStride = kF32 ? D + 4 : D + 8;  // row, elements
  static constexpr int kTile = kBlockK * kStride;       // one operand
  static constexpr int kTiles = kF32 ? 6 : 2 * kStagesBf16;
  static constexpr int kScalars = kF32 ? 2 : kStagesBf16;  // bias tiles
  static constexpr size_t kBytes =
      kTiles * kTile * sizeof(T) + kScalars * kBlockK * sizeof(float);
};

// ------------------------------------------------------------ staging ---

// Key tiles of slice bh that a block runs: those that start before the
// slice's key extent, or all of them without extents or at an extent of 0.
__device__ __forceinline__ int key_tiles(const FwdArgs& a, int bh) {
  int n = a.nk;
  if (a.kv_extent) {
    const int e = a.kv_extent[bh];
    if (e > 0) n = min(e, a.nk);
  }
  return (n + kBlockK - 1) / kBlockK;
}

// One tile of k, v and bias into a stage: keys past `valid` are zero rows
// with bias -inf, so their scores are -inf and p exactly 0.
template <typename T, int D>
__device__ __forceinline__ void stage_tile(T* kv, float* bs, const FwdArgs& a,
                                           const T* kb, const T* vb,
                                           const float* bb, int k0, int tid) {
  using L = Smem<T, D>;
  const int valid = min(kBlockK, a.nk - k0);
  cp_async_rows<T, D, L::kStride, kBlockK, kThreads>(
      kv, kb + (size_t)k0 * D, valid, a.vec16, tid);
  cp_async_rows<T, D, L::kStride, kBlockK, kThreads>(
      kv + L::kTile, vb + (size_t)k0 * D, valid, a.vec16, tid);
  if (tid < kBlockK) {
    if (tid < valid)
      cp_async4(bs + tid, bb + k0 + tid, true);
    else
      bs[tid] = -INFINITY;
  }
  cp_async_commit();
}

// Scores in base 2 from the raw products of one thread's C fragments: x =
// s * scale * log2 e + bias * log2 e (b2 already holds the latter), and the
// two rows' maxima over this thread's columns.
__device__ __forceinline__ void base2_scores(float (&s)[kNb][4],
                                             const float* b2, float scale_log2,
                                             int t, float (&mx)[2]) {
  mx[0] = mx[1] = -INFINITY;
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
    const float2 b = *reinterpret_cast<const float2*>(b2 + nb * 8 + 2 * t);
    s[nb][0] = fmaf(s[nb][0], scale_log2, b.x);
    s[nb][1] = fmaf(s[nb][1], scale_log2, b.y);
    s[nb][2] = fmaf(s[nb][2], scale_log2, b.x);
    s[nb][3] = fmaf(s[nb][3], scale_log2, b.y);
    mx[0] = fmaxf(mx[0], fmaxf(s[nb][0], s[nb][1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[nb][2], s[nb][3]));
  }
}

// The online softmax step of one tile for rows g and g + 8: the new running
// max, alpha = 2^(m - m_new) (returned), p = 2^(x - m_new) in place of the
// scores, and l = l * alpha + this thread's share of the row sums.
__device__ __forceinline__ void online_softmax(float (&s)[kNb][4],
                                               float (&mx)[2], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // the four threads of a quad share a row
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = exp2_approx(m[h] - m_new);
    m[h] = m_new;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[nb][i] = exp2_approx(s[nb][i] - m[i >> 1]);
      l[i >> 1] += s[nb][i];
    }
  }
}

// lse in natural-log units, and 1 / l, after the quads' sums.  l >= 1: the
// row max contributes 2^0.  A fully masked row has m ~ -1e9 log2 e, and its
// lse rounds to the bias, as the TPU kernel's does.
__device__ __forceinline__ void finish_rows(float (&l)[2], const float (&m)[2],
                                            const FwdArgs& a, int bh, int r0,
                                            bool in0, bool in1, int t,
                                            float (&inv)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    inv[h] = l[h] == 0.f ? 0.f : 1.f / l[h];
  }
  if (a.lse && t == 0) {  // one thread of the quad writes the row's lse
    if (in0)
      a.lse[(size_t)bh * a.nq + r0] =
          (m[0] + log2f(fmaxf(l[0], 1e-30f))) * kLn2;
    if (in1)
      a.lse[(size_t)bh * a.nq + r0 + 8] =
          (m[1] + log2f(fmaxf(l[1], 1e-30f))) * kLn2;
  }
}

// ---------------------------------------------------------------- fp32 ---

template <int D>
__global__ void __launch_bounds__(kThreads, D >= 64 ? 2 : 3)
    flash_fwd_f32_kernel(const FwdArgs a) {
  using L = Smem<float, D>;
  constexpr int S = L::kStride;
  constexpr int kK = D / 8;   // k-steps of s = q k^T over the head dim
  constexpr int kNd = D / 8;  // 8-wide blocks of the output
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  float* tiles = reinterpret_cast<float*>(smem);
  float* scal = tiles + L::kTiles * L::kTile;  // raw bias, then bias log2 e

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp_row = blockIdx.x * kBlockQ + (tid / 32) * 16;
  const int r0 = warp_row + g;  // this thread's rows: r0 and r0 + 8
  const bool in0 = r0 < a.nq, in1 = r0 + 8 < a.nq;
  const float* kb = static_cast<const float*>(a.k) + (size_t)bh * a.nk * D;
  const float* vb = static_cast<const float*>(a.v) + (size_t)bh * a.nk * D;
  const float* bb = a.bias + (size_t)bh * a.nk;

  // q as split A fragments: step kk's contraction index t (t + 4) is
  // head-dim column t * D/4 + 2kk (+ 1), so each thread holds D/4
  // contiguous columns of its rows.
  uint32_t qb[kK][4], qs[kK][4];
  {
    const float* qr =
        static_cast<const float*>(a.q) + ((size_t)bh * a.nq + r0) * D;
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i & 1;  // row r0 or r0 + 8
        const int c = t * (D / 4) + 2 * kk + (i >> 1);
        split((h ? in1 : in0) ? qr[h * 8 * D + c] : 0.f, qb[kk][i],
              qs[kk][i]);
      }
    }
  }

  float acc[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max, base 2 (the TPU's start)
  float l[2] = {0.f, 0.f};        // this thread's share of the running sums

  const int n_tiles = key_tiles(a, bh);
  stage_tile<float, D>(tiles, scal, a, kb, vb, bb, 0, tid);
  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();
    __syncthreads();  // tile `it` has landed; every warp is done with it - 1
    // Split k and v into big (tiles 2, 3) and small (4, 5); bias * log2 e.
    {
      constexpr int kVecs = D / 4;
      for (int i = tid; i < 2 * kBlockK * kVecs; i += kThreads) {
        const int op = i / (kBlockK * kVecs), rem = i % (kBlockK * kVecs);
        const int at = op * L::kTile + (rem / kVecs) * S + 4 * (rem % kVecs);
        const float4 x = *reinterpret_cast<const float4*>(tiles + at);
        uint4 big, small;
        split(x.x, big.x, small.x);
        split(x.y, big.y, small.y);
        split(x.z, big.z, small.z);
        split(x.w, big.w, small.w);
        *reinterpret_cast<uint4*>(tiles + 2 * L::kTile + at) = big;
        *reinterpret_cast<uint4*>(tiles + 4 * L::kTile + at) = small;
      }
      if (tid < kBlockK) scal[kBlockK + tid] = scal[tid] * kLog2e;
    }
    __syncthreads();  // the split tile is ready; the staging tile is free
    if (it + 1 < n_tiles)
      stage_tile<float, D>(tiles, scal, a, kb, vb, bb, (it + 1) * kBlockK,
                           tid);
    if (warp_row >= a.nq) continue;

    const float* kbig = tiles + 2 * L::kTile;
    const float* vbig = tiles + 3 * L::kTile;  // small parts at +2 tiles
    // s = q k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      // B[k][n] = k[key n][column]: key nb * 8 + g, the columns of t
      const float* kr = kbig + (nb * 8 + g) * S + t * (D / 4);
      float kbv[D / 4], ksv[D / 4];
      load_vec(kbv, kr);
      load_vec(ksv, kr + 2 * L::kTile);
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        mma_3xtf32(s[nb], qb[kk], qs[kk], kbv[2 * kk], kbv[2 * kk + 1],
                   ksv[2 * kk], ksv[2 * kk + 1]);
    }
    float mx[2], alpha[2];
    base2_scores(s, scal + kBlockK, a.scale_log2, t, mx);
    online_softmax(s, mx, m, l, alpha);

    // p v over the tile, summed in fresh registers.
    float c[kNd][4];
#pragma unroll
    for (int n = 0; n < kNd; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      // The C fragment (keys 2t, 2t + 1) as the A fragment whose
      // contraction index t is key 2t and t + 4 key 2t + 1.
      uint32_t pb[4], ps[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        split(s[nb][((i & 1) << 1) | (i >> 1)], pb[i], ps[i]);
      // B[k][n]: keys 2t (b0) and 2t + 1 (b1); output column n of n-block
      // nd is head-dim column n * D/8 + nd.
      const float* vr = vbig + (nb * 8 + 2 * t) * S + g * kNd;
      float u0b[kNd], u1b[kNd], u0s[kNd], u1s[kNd];
      load_vec(u0b, vr);
      load_vec(u1b, vr + S);
      load_vec(u0s, vr + 2 * L::kTile);
      load_vec(u1s, vr + 2 * L::kTile + S);
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd)
        mma_3xtf32(c[nd], pb, ps, u0b[nd], u1b[nd], u0s[nd], u1s[nd]);
    }
#pragma unroll
    for (int nd = 0; nd < kNd; ++nd)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[nd][i] = fmaf(acc[nd][i], alpha[i >> 1], c[nd][i]);
  }

  float inv[2];
  finish_rows(l, m, a, bh, r0, in0, in1, t, inv);
  // C column n = 2t + j of n-block nd is head-dim column n * D/8 + nd: the
  // kNd values of one (row, j) are contiguous.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!(h ? in1 : in0)) continue;
    float* o =
        static_cast<float*>(a.out) + ((size_t)bh * a.nq + r0 + 8 * h) * D;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float vals[kNd];
#pragma unroll
      for (int nd = 0; nd < kNd; ++nd) vals[nd] = acc[nd][2 * h + j] * inv[h];
      float* dst = o + (2 * t + j) * kNd;
      if constexpr (kNd % 4 == 0) {
#pragma unroll
        for (int i = 0; i < kNd / 4; ++i)
          reinterpret_cast<float4*>(dst)[i] = make_float4(
              vals[4 * i], vals[4 * i + 1], vals[4 * i + 2], vals[4 * i + 3]);
      } else {
#pragma unroll
        for (int i = 0; i < kNd / 2; ++i)
          reinterpret_cast<float2*>(dst)[i] =
              make_float2(vals[2 * i], vals[2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 ---

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_bf16_kernel(const FwdArgs a) {
  using L = Smem<__nv_bfloat16, D>;
  constexpr int S = L::kStride;
  constexpr int kKs = D / 16;  // 16-wide steps over the head dim
  constexpr int kNd = D / 8;   // 8-wide column blocks of the output
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  float* scal = reinterpret_cast<float*>(smem + L::kTiles * L::kTile *
                                                    sizeof(__nv_bfloat16));

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int warp_row = blockIdx.x * kBlockQ + (tid / 32) * 16;
  const int r0 = warp_row + g;  // and r0 + 8
  const bool in0 = r0 < a.nq, in1 = r0 + 8 < a.nq;
  const __nv_bfloat16* kb =
      static_cast<const __nv_bfloat16*>(a.k) + (size_t)bh * a.nk * D;
  const __nv_bfloat16* vb =
      static_cast<const __nv_bfloat16*>(a.v) + (size_t)bh * a.nk * D;
  const float* bb = a.bias + (size_t)bh * a.nk;

  // q as A fragments, one set of four registers per 16 head-dim columns.
  uint32_t qa[kKs][4];
  {
    const uint32_t* q0 = reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(a.q) + ((size_t)bh * a.nq + r0) * D);
#pragma unroll
    for (int st = 0; st < kKs; ++st) {
      const int c = st * 8 + t;  // in words
      qa[st][0] = in0 ? q0[c] : 0u;
      qa[st][1] = in1 ? q0[4 * D + c] : 0u;
      qa[st][2] = in0 ? q0[c + 4] : 0u;
      qa[st][3] = in1 ? q0[4 * D + c + 4] : 0u;
    }
  }

  float o[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-1e30f, -1e30f};  // running max of rows g and g+8, base 2
  float l[2] = {0.f, 0.f};        // this thread's share of the running sums

  // The ring: tile i lives in stage i % kStagesBf16; one commit group per
  // tile (empty past the last, also in the prologue when the extent leaves
  // fewer tiles than it stages), so waiting for all but kStagesBf16 - 2
  // groups means tile `it` has landed.
  const int n_tiles = key_tiles(a, bh);
  auto stage = [&](int i) {
    if (i < n_tiles) {
      const int st = i % kStagesBf16;
      stage_tile<__nv_bfloat16, D>(tiles + 2 * st * L::kTile,
                                   scal + st * kBlockK, a, kb, vb, bb,
                                   i * kBlockK, tid);
    } else {
      cp_async_commit();
    }
  };
#pragma unroll
  for (int i = 0; i < kStagesBf16 - 1; ++i) stage(i);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStagesBf16;
    cp_async_wait<kStagesBf16 - 2>();
    // This thread's own copy of the bias element has landed: fold log2 e
    // into it before the barrier publishes the tile.
    if (tid < kBlockK) scal[st * kBlockK + tid] *= kLog2e;
    __syncthreads();  // tile `it` is visible; every warp is done with it - 1
    stage(it + kStagesBf16 - 1);  // into the stage tile it - 1 used
    if (warp_row >= a.nq) continue;

    const __nv_bfloat16* kt = tiles + 2 * st * L::kTile;
    const __nv_bfloat16* vt = kt + L::kTile;
    // Scores s = q k^T for this warp's 16 rows and the tile's 64 keys; k's
    // B fragments by ldmatrix: lanes 8j .. 8j + 7 point at keys nb * 8 + 0..7,
    // head-dim columns 8j .. 8j + 7 of each 32-wide step.
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* kr = kt + (nb * 8 + (lane & 7)) * S;
      if constexpr (kKs % 2 == 0) {
#pragma unroll
        for (int k2 = 0; k2 < kKs / 2; ++k2) {
          uint32_t r[4];
          ldsm_x4(r, kr + k2 * 32 + (lane >> 3) * 8);
          mma_bf16(s[nb], qa[2 * k2], r[0], r[1]);
          mma_bf16(s[nb], qa[2 * k2 + 1], r[2], r[3]);
        }
      } else {
        uint32_t b0, b1;
        ldsm_x2(b0, b1, kr + ((lane >> 3) & 1) * 8);
        mma_bf16(s[nb], qa[0], b0, b1);
      }
    }
    float mx[2], alpha[2];
    base2_scores(s, scal + st * kBlockK, a.scale_log2, t, mx);
    online_softmax(s, mx, m, l, alpha);
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // o += p v: the score fragments of two 8-key blocks are the A fragment
    // of one 16-key step, with p rounded to bf16.  v's B fragments by
    // ldmatrix.trans from row-major v: lanes 0-15 point at keys
    // kk * 16 + 0..15 of head-dim columns 8nd .., lanes 16-31 of 8(nd + 1).
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vr =
          vt + (kk * 16 + (lane & 15)) * S + (lane >> 4) * 8;
#pragma unroll
      for (int n2 = 0; n2 < kNd / 2; ++n2) {
        uint32_t r[4];
        ldsm_x4_trans(r, vr + n2 * 16);
        mma_bf16(o[2 * n2], pa, r[0], r[1]);
        mma_bf16(o[2 * n2 + 1], pa, r[2], r[3]);
      }
    }
  }

  float inv[2];
  finish_rows(l, m, a, bh, r0, in0, in1, t, inv);
  __nv_bfloat16* o0 =
      static_cast<__nv_bfloat16*>(a.out) + ((size_t)bh * a.nq + r0) * D;
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
    const int c = n * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(o[n][0] * inv[0], o[n][1] * inv[0]);
    if (in1)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * D + c) =
          __floats2bfloat162_rn(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
}

template <typename T, int D>
int launch(const FwdArgs& a, int bh, cudaStream_t stream) {
  constexpr size_t kBytes = Smem<T, D>::kBytes;
  auto kernel = std::is_same<T, float>::value
                    ? flash_fwd_f32_kernel<D>
                    : flash_fwd_bf16_kernel<D>;
  if (kBytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((a.nq + kBlockQ - 1) / kBlockQ, bh);
  kernel<<<grid, kThreads, kBytes, stream>>>(a);
  return (int)cudaGetLastError();
}

bool on16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error of the launch (0 when it was
// accepted).  is_bf16: 1 for bf16 q/k/v/out, 0 for fp32.  lse: (BH, Nq)
// fp32, or null when the caller needs no backward.  kv_extent: (BH,) int32
// key extents, or null for every slice's nk.  Shapes, dtypes, contiguity
// and 4-byte alignment are checked by the caller
// (regtr_tpu_torch/ops/attention.py).
int regtr_flash_attn_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse,
                         const void* kv_extent, int bh, int nq, int nk, int d,
                         int is_bf16, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const FwdArgs a{q, k, v, static_cast<const float*>(bias), out,
                  static_cast<float*>(lse),
                  static_cast<const int*>(kv_extent), nq, nk, scale * kLog2e,
                  on16(q) && on16(k) && on16(v)};
  if (is_bf16) {
    switch (d) {
      case 16: return launch<__nv_bfloat16, 16>(a, bh, s);
      case 32: return launch<__nv_bfloat16, 32>(a, bh, s);
      case 64: return launch<__nv_bfloat16, 64>(a, bh, s);
    }
  } else {
    switch (d) {
      case 16: return launch<float, 16>(a, bh, s);
      case 32: return launch<float, 32>(a, bh, s);
      case 64: return launch<float, 64>(a, bh, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
