// Masked flash-attention forward for Hopper (sm_90a), plain C interface.
//
//   out = softmax(q k^T * scale + bias) v      per (bh) slice
//   q: (BH, Nq, D), k, v: (BH, Nk, D) in fp32 or bf16, bias: (BH, Nk) fp32,
//   an additive per-key bias (0 for valid keys, -1e9 for masked ones).
//
// Replaces the TPU kernel regtr_tpu/ops/pallas/attention.py::_kernel (the
// forward behind flash_masked_attention), with its optional lse output:
// lse = m + log(l) per query row, fp32, written when the caller passes a
// pointer (the training forward; the backward recomputes p from it).
// Semantics kept exactly: fp32 scores, running max,
// running sum and accumulator; the bias added per key; p rounded to the
// operand type before the p*v product, as the TPU kernel does; a fully
// masked row is the bias-weighted mean, not zeros.  Keys beyond Nk (the
// ragged edge of the last tile) are left out of the softmax entirely.
//
// What bounds it on an H100: at the main-path shape (BH 64, N 1872, D 32) one
// call is 4*BH*N^2*D ~ 29 GFLOP and ~230 M exponentials over ~23 MB of bf16
// q/k/v, so it is bound by arithmetic and the exp, not by memory.  Both
// kernels keep everything quadratic out of device memory (scores and p live
// in registers) and stage 64-key tiles of k and v in shared memory:
//  * bf16 (the main path): the two products run on the tensor cores with
//    mma.sync m16n8k16 (bf16 in, fp32 accumulate), one warp per 16 query
//    rows, 4 warps per block; the scores' accumulator fragments are reused,
//    rounded to bf16, as the A operand of p*v (the flash-attention-2
//    register layout).  The exp runs on the CUDA cores.
//  * fp32: the tensor cores would round the operands (TF32), so the fp32
//    kernel does fp32 FMAs on the CUDA cores, one thread per query row, 64
//    rows per block, the online softmax rescaling once per 16 keys.
// wgmma and TMA (Hopper's asynchronous paths) are the next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;  // query rows per block
constexpr int kBlockK = 64;  // key rows per shared-memory tile
constexpr int kChunk = 16;   // fp32 kernel: keys per online-softmax rescale

// ---------------------------------------------------------------- fp32 ---

template <int D>
__global__ void __launch_bounds__(kBlockQ)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ bias,
                         float* __restrict__ out, float* __restrict__ lse,
                         int nq, int nk, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  static_assert(kBlockK % kChunk == 0, "tile must hold whole chunks");
  __shared__ __align__(16) float ks[kBlockK * D];
  __shared__ __align__(16) float vs[kBlockK * D];
  __shared__ float bs[kBlockK];

  const int bh = blockIdx.y;
  const int t = threadIdx.x;
  const int qi = blockIdx.x * kBlockQ + t;
  const bool active = qi < nq;
  const float* kb = k + (size_t)bh * nk * D;
  const float* vb = v + (size_t)bh * nk * D;
  const float* bb = bias + (size_t)bh * nk;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? q[((size_t)bh * nq + qi) * D + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -1e30f;  // running max (same start value as the TPU kernel)
  float l = 0.f;     // running sum

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    const int kn = min(kBlockK, nk - k0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = t; i < kBlockK * D; i += kBlockQ) {
      const bool in = i / D < kn;
      ks[i] = in ? kb[(size_t)k0 * D + i] : 0.f;
      vs[i] = in ? vb[(size_t)k0 * D + i] : 0.f;
    }
    if (t < kBlockK) bs[t] = t < kn ? bb[k0 + t] : 0.f;
    __syncthreads();

    for (int j0 = 0; j0 < kn; j0 += kChunk) {
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float4* kr = reinterpret_cast<const float4*>(ks + (j0 + jj) * D);
        float a = 0.f;
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 kk = kr[c4];
          a = fmaf(qr[4 * c4 + 0], kk.x, a);
          a = fmaf(qr[4 * c4 + 1], kk.y, a);
          a = fmaf(qr[4 * c4 + 2], kk.z, a);
          a = fmaf(qr[4 * c4 + 3], kk.w, a);
        }
        // Keys past the ragged edge get -inf: exp gives exactly 0, so they
        // never enter the max, the sum or the accumulator.
        s[jj] = (j0 + jj < kn) ? a * scale + bs[j0 + jj] : -INFINITY;
        cmax = fmaxf(cmax, s[jj]);
      }
      const float m_new = fmaxf(m, cmax);
      const float alpha = expf(m - m_new);
      l *= alpha;
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] *= alpha;
#pragma unroll
      for (int jj = 0; jj < kChunk; ++jj) {
        const float p = expf(s[jj] - m_new);
        l += p;
        const float4* vr = reinterpret_cast<const float4*>(vs + (j0 + jj) * D);
#pragma unroll
        for (int c4 = 0; c4 < D / 4; ++c4) {
          const float4 vv = vr[c4];
          acc[4 * c4 + 0] = fmaf(p, vv.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, vv.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, vv.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, vv.w, acc[4 * c4 + 3]);
        }
      }
      m = m_new;
    }
  }

  if (active) {
    const float inv = l == 0.f ? 0.f : 1.f / l;
    float* o = out + ((size_t)bh * nq + qi) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) o[c] = acc[c] * inv;
    // l >= 1: the row max contributes exp(0).  A fully masked row has
    // m ~ -1e9, and its lse rounds to m, as the TPU kernel's does.
    if (lse) lse[(size_t)bh * nq + qi] = m + logf(fmaxf(l, 1e-30f));
  }
}

// ---------------------------------------------------------------- bf16 ---

constexpr int kWarps = kBlockQ / 16;  // one warp per 16 query rows

// D(16x8, fp32) += A(16x16, bf16, row) * B(16x8, bf16, col).  Fragments
// (g = lane / 4, t = lane % 4): a0 = A[g][2t..2t+1], a1 = A[g+8][2t..],
// a2 = A[g][2t+8..], a3 = A[g+8][2t+8..]; b0 = B[2t..2t+1][g],
// b1 = B[2t+8..2t+9][g]; c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // .x = lo
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out,
                          float* __restrict__ lse, int nq, int nk,
                          float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int kNb = kBlockK / 8;  // 8-key column blocks of the scores
  constexpr int kKs = D / 16;       // 16-wide steps over the head dim
  constexpr int kNd = D / 8;        // 8-wide column blocks of the output
  // Rows padded by 8 halves: the fragment loads of one warp then hit 32
  // distinct banks.
  constexpr int kStrideK = D + 8;
  constexpr int kStrideV = kBlockK + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK * kStrideK];
  __shared__ __align__(16) __nv_bfloat16 vt[D * kStrideV];  // v transposed
  __shared__ float bs[kBlockK];

  const int bh = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int row0 = blockIdx.x * kBlockQ + (tid / 32) * 16 + g;  // and +8
  const bool in0 = row0 < nq;
  const bool in1 = row0 + 8 < nq;
  const __nv_bfloat16* kb = k + (size_t)bh * nk * D;
  const __nv_bfloat16* vb = v + (size_t)bh * nk * D;
  const float* bb = bias + (size_t)bh * nk;

  // q as A fragments, one set of four registers per 16 head-dim columns.
  uint32_t qa[kKs][4];
  const __nv_bfloat16* q0 = q + ((size_t)bh * nq + row0) * D;
  const __nv_bfloat16* q1 = q0 + 8 * D;
#pragma unroll
  for (int s = 0; s < kKs; ++s) {
    const int c = s * 16 + 2 * t;
    qa[s][0] = in0 ? ld32(q0 + c) : 0u;
    qa[s][1] = in1 ? ld32(q1 + c) : 0u;
    qa[s][2] = in0 ? ld32(q0 + c + 8) : 0u;
    qa[s][3] = in1 ? ld32(q1 + c + 8) : 0u;
  }

  float o[kNd][4];
#pragma unroll
  for (int n = 0; n < kNd; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = -1e30f, m1 = -1e30f;  // running max of rows g and g+8
  float l0 = 0.f, l1 = 0.f;        // this thread's share of the running sums

  for (int k0 = 0; k0 < nk; k0 += kBlockK) {
    const int kn = min(kBlockK, nk - k0);
    __syncthreads();  // every warp is done with the previous tile
    for (int w = tid; w < kBlockK * D / 2; w += kWarps * 32) {
      const int r = w / (D / 2);
      const int c = 2 * (w % (D / 2));
      uint32_t kw = 0u, vw = 0u;
      if (r < kn) {
        kw = ld32(kb + (size_t)(k0 + r) * D + c);
        vw = ld32(vb + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint32_t*>(ks + r * kStrideK + c) = kw;
      const __nv_bfloat162 vv = *reinterpret_cast<const __nv_bfloat162*>(&vw);
      vt[c * kStrideV + r] = vv.x;
      vt[(c + 1) * kStrideV + r] = vv.y;
    }
    if (tid < kBlockK) bs[tid] = tid < kn ? bb[k0 + tid] : 0.f;
    __syncthreads();

    // Scores s = q k^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNb][4];
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
      const __nv_bfloat16* kr = ks + (nb * 8 + g) * kStrideK + 2 * t;
#pragma unroll
      for (int st = 0; st < kKs; ++st)
        mma_bf16(s[nb], qa[st], ld32(kr + st * 16), ld32(kr + st * 16 + 8));
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nb * 8 + 2 * t + (i & 1);
        // Keys past the ragged edge get -inf: exp gives exactly 0.
        s[nb][i] = col < kn ? s[nb][i] * scale + bs[col] : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nb][0], s[nb][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nb][2], s[nb][3]));
    }
    // The four threads of a quad share a row.
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
#pragma unroll
    for (int nb = 0; nb < kNb; ++nb) {
      s[nb][0] = __expf(s[nb][0] - mn0);
      s[nb][1] = __expf(s[nb][1] - mn0);
      s[nb][2] = __expf(s[nb][2] - mn1);
      s[nb][3] = __expf(s[nb][3] - mn1);
      l0 += s[nb][0] + s[nb][1];
      l1 += s[nb][2] + s[nb][3];
    }
    // o += p v: the score fragments of two 8-key blocks are the A fragment
    // of one 16-key step, with p rounded to bf16.
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < kNd; ++n) {
        const __nv_bfloat16* vr = vt + (n * 8 + g) * kStrideV + kk * 16 + 2 * t;
        mma_bf16(o[n], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  if (lse && t == 0) {  // one thread of the quad writes the row's lse
    if (in0) lse[(size_t)bh * nq + row0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (in1) lse[(size_t)bh * nq + row0 + 8] = m1 + logf(fmaxf(l1, 1e-30f));
  }
  const float inv0 = l0 == 0.f ? 0.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 0.f : 1.f / l1;
  __nv_bfloat16* o0 = out + ((size_t)bh * nq + row0) * D;
#pragma unroll
  for (int n = 0; n < kNd; ++n) {
    const int c = n * 8 + 2 * t;
    if (in0)
      *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
          __floats2bfloat162_rn(o[n][0] * inv0, o[n][1] * inv0);
    if (in1)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * D + c) =
          __floats2bfloat162_rn(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int D>
void launch_d(const void* q, const void* k, const void* v, const float* bias,
              void* out, float* lse, int bh, int nq, int nk, int is_bf16,
              float scale, cudaStream_t stream) {
  const dim3 grid((nq + kBlockQ - 1) / kBlockQ, bh);
  if (is_bf16) {
    flash_fwd_bf16_kernel<D><<<grid, kWarps * 32, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), bias,
        static_cast<__nv_bfloat16*>(out), lse, nq, nk, scale);
  } else {
    flash_fwd_f32_kernel<D><<<grid, kBlockQ, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), bias, static_cast<float*>(out), lse,
        nq, nk, scale);
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// is_bf16: 1 for bf16 q/k/v/out, 0 for fp32.  lse: (BH, Nq) fp32, or null
// when the caller needs no backward.  Shapes, contiguity and alignment are
// checked by the caller (regtr_tpu_torch/ops/attention.py).
int regtr_flash_attn_fwd(const void* q, const void* k, const void* v,
                         const void* bias, void* out, void* lse, int bh,
                         int nq, int nk, int d, int is_bf16, float scale,
                         void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  float* l = static_cast<float*>(lse);
  switch (d) {
    case 16:
      launch_d<16>(q, k, v, b, out, l, bh, nq, nk, is_bf16, scale, s);
      break;
    case 32:
      launch_d<32>(q, k, v, b, out, l, bh, nq, nk, is_bf16, scale, s);
      break;
    case 64:
      launch_d<64>(q, k, v, b, out, l, bh, nq, nk, is_bf16, scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
