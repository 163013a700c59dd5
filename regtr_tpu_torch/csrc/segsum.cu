// Sorted padded segment sum for Hopper (sm_90a), plain C interface: the
// gather transpose behind every padded neighbor gather of the backbone.
//
//   out[s, :] = sum of g[r, :] over the rows r with id[r] == s   (fp32)
//   out[s, :] = 0 when s % seg_stride == seg_stride - 1 (a per-cloud pad
//               row, whose gradient the callers discard) or s has no rows
//
// The caller sorts the ids (a stable sort, so rows of one segment keep
// their order) and passes the sort's permutation and each segment's start
// in it (CSR offsets, num_segments + 1 of them).  One warp per segment,
// lanes over channels, adds that segment's rows in sorted order in fp32:
// no atomics, so the result is bitwise the same on every run.
//
// Replaces the TPU kernel regtr_tpu/ops/pallas/segsum.py::_kernel (entry
// sorted_padded_segment_sum).  The TPU kernel's one-hot MXU matmul, lane
// packing and int32 loop carriers work around the TPU and are not ported.
//
// What bounds it on an H100: it reads each cotangent row once (at level 0
// of the 3DMatch training step ~3.1 M rows of 32 to 128 fp32 channels, 0.4
// to 1.6 GB) and does one add per element: bound by memory (3.35 TB/s).
// Rows are read in permuted order, but each row is one contiguous run of
// 128 bytes or more.  A warp loads 32 row indices at once and broadcasts
// them with shuffles.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // segments per block
constexpr int kVec = 4;    // channels per lane per pass: 128 per warp

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_kernel(const T* __restrict__ g, const int64_t* __restrict__ perm,
                  const int64_t* __restrict__ starts, float* __restrict__ out,
                  int64_t num_segments, int c, int64_t seg_stride) {
  const int64_t seg = (int64_t)blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= num_segments) return;
  const bool pad = seg % seg_stride == seg_stride - 1;
  const int64_t r0 = starts[seg];
  const int64_t r1 = pad ? r0 : starts[seg + 1];
  float* o = out + seg * c;
  for (int c0 = 0; c0 < c; c0 += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int64_t rb = r0; rb < r1; rb += 32) {
      const int64_t left = r1 - rb;
      const int n = left < 32 ? (int)left : 32;
      const int64_t mine = lane < n ? perm[rb + lane] : 0;
      for (int j = 0; j < n; ++j) {
        const T* row = g + __shfl_sync(0xffffffffu, mine, j) * c;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          const int cc = c0 + i * 32 + lane;
          if (cc < c) acc[i] += to_float(row[cc]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      const int cc = c0 + i * 32 + lane;
      if (cc < c) o[cc] = acc[i];
    }
  }
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// g: (rows, c) fp32 (is_bf16 0) or bf16 (1); perm, starts: int64; out:
// (num_segments, c) fp32, every element written.  Checked by the caller
// (regtr_tpu_torch/ops/kpconv.py).
int regtr_segsum(const void* g, const void* perm, const void* starts,
                 void* out, long long num_segments, int c,
                 long long seg_stride, int is_bf16, void* stream) {
  if (num_segments <= 0 || c <= 0 || seg_stride <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (num_segments + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* p = static_cast<const int64_t*>(perm);
  const int64_t* st = static_cast<const int64_t*>(starts);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    segsum_kernel<__nv_bfloat16><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), p, st, o, num_segments, c,
        seg_stride);
  } else {
    segsum_kernel<float><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(g), p, st, o, num_segments, c, seg_stride);
  }
  return (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
