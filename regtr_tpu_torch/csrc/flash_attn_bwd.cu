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
// enter a sum.
//
// What bounds it on an H100: at the training shape (BH 32, N ~2240, D 32,
// fp32) the two kernels do 14 * BH * N^2 * D ~ 72 GFLOP (dkv recomputes s
// and dout v^T and forms dv, dk: 8 N^2 D per slice; dq recomputes both and
// forms dq: 6 N^2 D) and 2 * BH * N^2 exponentials over ~4 MB of operands:
// bound by arithmetic.  The shipped training runs fp32, and the tensor
// cores would round fp32 operands to TF32, so this first design runs fp32
// FMAs on the CUDA cores for both types (67 TFLOP/s peak), like the forward's
// fp32 kernel: one thread per key (dkv) or per query (dq) row, holding its
// row and its fp32 accumulators in registers, and the other side staged in
// 64-row tiles of shared memory that every thread of the block reads as
// broadcasts.  Nothing quadratic touches device memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;  // rows per block, one thread each
constexpr int kTile = 64;  // rows of the other side per shared-memory tile

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // The plain version's casts: p.to(bf16), ds.to(bf16).
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16(x);
  }
};

template <int D>
__device__ __forceinline__ void dot2(const float* __restrict__ a,
                                     const float* __restrict__ b,
                                     const float* __restrict__ x,
                                     const float* __restrict__ y, float& ab,
                                     float& xy) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  const float4* y4 = reinterpret_cast<const float4*>(y);
#pragma unroll
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 bb = b4[c4];
    const float4 yy = y4[c4];
    ab = fmaf(a[4 * c4 + 0], bb.x, ab);
    ab = fmaf(a[4 * c4 + 1], bb.y, ab);
    ab = fmaf(a[4 * c4 + 2], bb.z, ab);
    ab = fmaf(a[4 * c4 + 3], bb.w, ab);
    xy = fmaf(x[4 * c4 + 0], yy.x, xy);
    xy = fmaf(x[4 * c4 + 1], yy.y, xy);
    xy = fmaf(x[4 * c4 + 2], yy.z, xy);
    xy = fmaf(x[4 * c4 + 3], yy.w, xy);
  }
}

template <int D>
__device__ __forceinline__ void axpy(float a, const float* __restrict__ x,
                                     float* __restrict__ acc) {
  const float4* x4 = reinterpret_cast<const float4*>(x);
#pragma unroll
  for (int c4 = 0; c4 < D / 4; ++c4) {
    const float4 xx = x4[c4];
    acc[4 * c4 + 0] = fmaf(a, xx.x, acc[4 * c4 + 0]);
    acc[4 * c4 + 1] = fmaf(a, xx.y, acc[4 * c4 + 1]);
    acc[4 * c4 + 2] = fmaf(a, xx.z, acc[4 * c4 + 2]);
    acc[4 * c4 + 3] = fmaf(a, xx.w, acc[4 * c4 + 3]);
  }
}

// One block per (bh, 64 keys); loops over all queries in tiles of 64.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const float* __restrict__ bias,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dk,
                         T* __restrict__ dv, float* __restrict__ dbias, int nq,
                         int nk, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float qs[kTile * D];
  __shared__ __align__(16) float dos[kTile * D];
  __shared__ float ls[kTile];
  __shared__ float dl[kTile];

  const int bh = blockIdx.y;
  const int t = threadIdx.x;
  const int kj = blockIdx.x * kRows + t;
  const bool active = kj < nk;
  const T* qb = q + (size_t)bh * nq * D;
  const T* dob = dout + (size_t)bh * nq * D;

  float kr[D], vr[D], dka[D], dva[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const size_t at = ((size_t)bh * nk + kj) * D + c;
    kr[c] = active ? Num<T>::load(k + at) : 0.f;
    vr[c] = active ? Num<T>::load(v + at) : 0.f;
    dka[c] = 0.f;
    dva[c] = 0.f;
  }
  const float b = active ? bias[(size_t)bh * nk + kj] : 0.f;
  float dba = 0.f;

  for (int q0 = 0; q0 < nq; q0 += kTile) {
    const int qn = min(kTile, nq - q0);
    __syncthreads();  // every thread is done with the previous tile
    for (int i = t; i < kTile * D; i += kRows) {
      const bool in = i / D < qn;
      qs[i] = in ? Num<T>::load(qb + (size_t)q0 * D + i) : 0.f;
      dos[i] = in ? Num<T>::load(dob + (size_t)q0 * D + i) : 0.f;
    }
    if (t < kTile) {
      ls[t] = t < qn ? lse[(size_t)bh * nq + q0 + t] : 0.f;
      dl[t] = t < qn ? delta[(size_t)bh * nq + q0 + t] : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < qn; ++j) {
      float s = 0.f, dp = 0.f;
      dot2<D>(kr, qs + j * D, vr, dos + j * D, s, dp);
      const float p = expf(s * scale + b - ls[j]);
      const float ds = p * (dp - dl[j]);
      dba += ds;
      axpy<D>(Num<T>::round(p), dos + j * D, dva);
      axpy<D>(Num<T>::round(ds), qs + j * D, dka);
    }
  }
  if (active) {
    const size_t at = ((size_t)bh * nk + kj) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) {
      Num<T>::store(dk + at + c, dka[c] * scale);
      Num<T>::store(dv + at + c, dva[c]);
    }
    if (dbias) dbias[(size_t)bh * nk + kj] = dba;
  }
}

// One block per (bh, 64 queries); loops over all keys in tiles of 64.
template <typename T, int D>
__global__ void __launch_bounds__(kRows)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v,
                        const float* __restrict__ bias,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int nq, int nk, float scale) {
  static_assert(D % 4 == 0, "head dim must be a multiple of 4");
  __shared__ __align__(16) float ks[kTile * D];
  __shared__ __align__(16) float vs[kTile * D];
  __shared__ float bs[kTile];

  const int bh = blockIdx.y;
  const int t = threadIdx.x;
  const int qi = blockIdx.x * kRows + t;
  const bool active = qi < nq;
  const T* kb = k + (size_t)bh * nk * D;
  const T* vb = v + (size_t)bh * nk * D;

  float qr[D], dor[D], dqa[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const size_t at = ((size_t)bh * nq + qi) * D + c;
    qr[c] = active ? Num<T>::load(q + at) : 0.f;
    dor[c] = active ? Num<T>::load(dout + at) : 0.f;
    dqa[c] = 0.f;
  }
  const float li = active ? lse[(size_t)bh * nq + qi] : 0.f;
  const float di = active ? delta[(size_t)bh * nq + qi] : 0.f;

  for (int k0 = 0; k0 < nk; k0 += kTile) {
    const int kn = min(kTile, nk - k0);
    __syncthreads();
    for (int i = t; i < kTile * D; i += kRows) {
      const bool in = i / D < kn;
      ks[i] = in ? Num<T>::load(kb + (size_t)k0 * D + i) : 0.f;
      vs[i] = in ? Num<T>::load(vb + (size_t)k0 * D + i) : 0.f;
    }
    if (t < kTile) bs[t] = t < kn ? bias[(size_t)bh * nk + k0 + t] : 0.f;
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < kn; ++j) {
      float s = 0.f, dp = 0.f;
      dot2<D>(qr, ks + j * D, dor, vs + j * D, s, dp);
      const float p = expf(s * scale + bs[j] - li);
      axpy<D>(Num<T>::round(p * (dp - di)), ks + j * D, dqa);
    }
  }
  if (active) {
    const size_t at = ((size_t)bh * nq + qi) * D;
#pragma unroll
    for (int c = 0; c < D; ++c) Num<T>::store(dq + at + c, dqa[c] * scale);
  }
}

template <typename T, int D>
void launch_dkv(const void* q, const void* k, const void* v, const float* bias,
                const void* dout, const float* lse, const float* delta,
                void* dk, void* dv, float* dbias, int bh, int nq, int nk,
                float scale, cudaStream_t stream) {
  const dim3 grid((nk + kRows - 1) / kRows, bh);
  flash_bwd_dkv_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), dbias, nq, nk, scale);
}

template <typename T, int D>
void launch_dq(const void* q, const void* k, const void* v, const float* bias,
               const void* dout, const float* lse, const float* delta,
               void* dq, int bh, int nq, int nk, float scale,
               cudaStream_t stream) {
  const dim3 grid((nq + kRows - 1) / kRows, bh);
  flash_bwd_dq_kernel<T, D><<<grid, kRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), nq, nk, scale);
}

template <typename T>
int dispatch_dkv(int d, const void* q, const void* k, const void* v,
                 const float* bias, const void* dout, const float* lse,
                 const float* delta, void* dk, void* dv, float* dbias, int bh,
                 int nq, int nk, float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      launch_dkv<T, 16>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, bh,
                        nq, nk, scale, s);
      return 0;
    case 32:
      launch_dkv<T, 32>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, bh,
                        nq, nk, scale, s);
      return 0;
    case 64:
      launch_dkv<T, 64>(q, k, v, bias, dout, lse, delta, dk, dv, dbias, bh,
                        nq, nk, scale, s);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_dq(int d, const void* q, const void* k, const void* v,
                const float* bias, const void* dout, const float* lse,
                const float* delta, void* dq, int bh, int nq, int nk,
                float scale, cudaStream_t s) {
  switch (d) {
    case 16:
      launch_dq<T, 16>(q, k, v, bias, dout, lse, delta, dq, bh, nq, nk, scale,
                       s);
      return 0;
    case 32:
      launch_dq<T, 32>(q, k, v, bias, dout, lse, delta, dq, bh, nq, nk, scale,
                       s);
      return 0;
    case 64:
      launch_dq<T, 64>(q, k, v, bias, dout, lse, delta, dq, bh, nq, nk, scale,
                       s);
      return 0;
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Both launch on `stream` and return cudaGetLastError() after the launch.
// is_bf16: 1 for bf16 q/k/v/dout and outputs, 0 for fp32.  dbias may be
// null (no bias gradient wanted).  Shapes, contiguity and alignment are
// checked by the caller (regtr_tpu_torch/ops/attention.py).
int regtr_flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                             const void* bias, const void* dout,
                             const void* lse, const void* delta, void* dk,
                             void* dv, void* dbias, int bh, int nq, int nk,
                             int d, int is_bf16, float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  float* db = static_cast<float*>(dbias);
  const int bad =
      is_bf16 ? dispatch_dkv<__nv_bfloat16>(d, q, k, v, b, dout, l, dl, dk,
                                            dv, db, bh, nq, nk, scale, s)
              : dispatch_dkv<float>(d, q, k, v, b, dout, l, dl, dk, dv, db,
                                    bh, nq, nk, scale, s);
  return bad ? bad : (int)cudaGetLastError();
}

int regtr_flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                            const void* bias, const void* dout,
                            const void* lse, const void* delta, void* dq,
                            int bh, int nq, int nk, int d, int is_bf16,
                            float scale, void* stream) {
  if (bh <= 0 || nq <= 0 || nk <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* b = static_cast<const float*>(bias);
  const float* l = static_cast<const float*>(lse);
  const float* dl = static_cast<const float*>(delta);
  const int bad =
      is_bf16 ? dispatch_dq<__nv_bfloat16>(d, q, k, v, b, dout, l, dl, dq, bh,
                                           nq, nk, scale, s)
              : dispatch_dq<float>(d, q, k, v, b, dout, l, dl, dq, bh, nq, nk,
                                   scale, s);
  return bad ? bad : (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
