// Row and element gathers for Hopper (sm_90a), plain C interface.
//
// Row gather: out[r, :] = table[idx[r], :] for a contiguous (rows_table,
// row_bytes) table and int64 indices.  It is the forward of every neighbor
// gather of the backbone: the feature rows (fp32 or bf16, width 32 to 256)
// and the fp32 coordinate rows (width 3, 12 bytes), over the clouds' tables
// flattened with one pad (shadow) row per cloud.  The indices are in range
// by construction and are not clamped.
//
// Element gather: out[b, i, j] = src[b, idx[b, i, j], j] (axis 0) or
// src[b, i, idx[b, i, j]] (axis 1), torch.gather's function over the last
// two dimensions, with a batch dimension of any stride.
//
// Replaces the TPU kernels of tools/exp_pallas_gather*.py: the row gathers
// (exp_pallas_gather.py take_kernel and onehot_kernel, exp_pallas_gather2.py
// k_taa, k_take2d, k_gather and k_loop, exp_pallas_gather3.py k_taa) and
// the per-element take_along_axis probes (exp_pallas_gather3.py k_taa2,
// exp_pallas_gather4.py k, exp_pallas_gather5.py k and k3).  The one-hot
// MXU product and the VMEM-resident source tile work around the TPU's lack
// of a vector gather and are not ported: Hopper loads any address.
//
// What bounds it on an H100: a gather is a copy.  It reads each index once,
// each gathered row once and writes each output row once, with no
// arithmetic: memory (3.35 TB/s).  The output is written in order and the
// indices are read in order; only the table rows are read at random, each
// a contiguous run of row_bytes.  Rows move as vectors of the widest size
// (16, 8, 4 or 2 bytes) that divides the row and the pointers' alignment.
// Wide rows (a multiple of 16 bytes, e.g. a bf16 width-32 row of 64 B, four
// vectors): one vector per thread, neighbouring threads on neighbouring
// vectors of one output row, then of the next, so a warp's index loads and
// output stores are coalesced.  Narrow rows of at most kNarrowVecs vectors
// (the fp32 coordinate rows: 12 B, three 4-byte vectors): one row per
// thread, so each index is read once and no thread divides.  No shared
// memory, no atomics: every output element is written by one thread, so
// the result is the table's bits, bitwise equal to index_select.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // the rest by a grid-stride loop
constexpr int kNarrowVecs = 4;

// I: the type of the flat vector counter, 32-bit when the count allows (a
// 32-bit division per vector instead of a 64-bit one).
template <typename V, typename I>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ table,
                      const int64_t* __restrict__ idx, V* __restrict__ out,
                      I total, I vecs_per_row) {
  const I step = (I)gridDim.x * kThreads;
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < total; t += step) {
    const I r = t / vecs_per_row;
    const I v = t - r * vecs_per_row;
    out[t] = table[idx[r] * (int64_t)vecs_per_row + v];
  }
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
    row_gather_narrow_kernel(const V* __restrict__ table,
                             const int64_t* __restrict__ idx,
                             V* __restrict__ out, int64_t rows, int vecs) {
  const int64_t step = (int64_t)gridDim.x * kThreads;
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < rows;
       r += step) {
    const V* src = table + idx[r] * vecs;
    V* dst = out + r * vecs;
    V v[kNarrowVecs];
#pragma unroll
    for (int i = 0; i < kNarrowVecs; ++i)
      if (i < vecs) v[i] = src[i];
#pragma unroll
    for (int i = 0; i < kNarrowVecs; ++i)
      if (i < vecs) dst[i] = v[i];
  }
}

template <typename V>
int launch_rows(const void* table, const int64_t* idx, void* out,
                long long rows, long long vecs_per_row, cudaStream_t s) {
  const V* t = static_cast<const V*>(table);
  V* o = static_cast<V*>(out);
  if (sizeof(V) < 16 && vecs_per_row <= kNarrowVecs) {
    long long blocks = (rows + kThreads - 1) / kThreads;
    if (blocks > kMaxBlocks) blocks = kMaxBlocks;
    row_gather_narrow_kernel<V><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, idx, o, rows, (int)vecs_per_row);
    return (int)cudaGetLastError();
  }
  const long long total = rows * vecs_per_row;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (total < (1LL << 31)) {
    row_gather_kernel<V, uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, idx, o, (uint32_t)total, (uint32_t)vecs_per_row);
  } else {
    row_gather_kernel<V, int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, idx, o, (int64_t)total, (int64_t)vecs_per_row);
  }
  return (int)cudaGetLastError();
}

// One thread per output element; the output and the indices are read and
// written in order, the source at the gathered positions.
template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    element_gather_kernel(const T* __restrict__ src,
                          const int64_t* __restrict__ idx,
                          T* __restrict__ out, I total, I rows, I cols,
                          int64_t src_cols, int axis, int64_t src_bstride,
                          int64_t idx_bstride, int64_t out_bstride) {
  const I per_batch = rows * cols;
  const I step = (I)gridDim.x * kThreads;
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < total; t += step) {
    const I b = t / per_batch;
    const I e = t - b * per_batch;
    const I i = e / cols;
    const I j = e - i * cols;
    const int64_t k = idx[b * idx_bstride + e];
    const int64_t at = axis == 0 ? k * src_cols + j : i * src_cols + k;
    out[b * out_bstride + e] = src[b * src_bstride + at];
  }
}

template <typename T>
int launch_elements(const void* src, const int64_t* idx, void* out,
                    long long batch, long long rows, long long cols,
                    long long src_cols, int axis, long long src_bstride,
                    long long idx_bstride, long long out_bstride,
                    cudaStream_t s) {
  const long long total = batch * rows * cols;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const T* in = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  if (total < (1LL << 31)) {
    element_gather_kernel<T, uint32_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, idx, o, (uint32_t)total, (uint32_t)rows, (uint32_t)cols,
        src_cols, axis, src_bstride, idx_bstride, out_bstride);
  } else {
    element_gather_kernel<T, int64_t><<<(unsigned)blocks, kThreads, 0, s>>>(
        in, idx, o, (int64_t)total, (int64_t)rows, (int64_t)cols, src_cols,
        axis, src_bstride, idx_bstride, out_bstride);
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// table: (rows_table, row_bytes) contiguous, row_bytes even; idx: (rows,)
// int64, each in [0, rows_table); out: (rows, row_bytes), every byte
// written.  Checked by the caller (regtr_tpu_torch/ops/gather.py).
int regtr_row_gather(const void* table, const void* idx, void* out,
                     long long rows, long long row_bytes, void* stream) {
  if (rows <= 0 || row_bytes <= 0 || row_bytes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  // The widest vector that divides the row and both pointers' alignment.
  const size_t widths[] = {16, 8, 4, 2};
  for (size_t width : widths) {
    if (row_bytes % width != 0 || !aligned(table, width) ||
        !aligned(out, width))
      continue;
    const long long vecs = row_bytes / (long long)width;
    switch (width) {
      case 16: return launch_rows<uint4>(table, ix, out, rows, vecs, s);
      case 8: return launch_rows<uint2>(table, ix, out, rows, vecs, s);
      case 4: return launch_rows<uint32_t>(table, ix, out, rows, vecs, s);
      default: return launch_rows<uint16_t>(table, ix, out, rows, vecs, s);
    }
  }
  return (int)cudaErrorMisalignedAddress;
}

// src: (batch, src_rows, src_cols) with the last two dimensions contiguous
// and batch stride src_bstride (elements); idx: (batch, rows, cols) int64,
// batch stride idx_bstride, last two dimensions contiguous; out likewise
// with out_bstride.  axis 0 gathers along src's rows (cols <= src_cols),
// axis 1 along its columns (rows <= src_rows).  elem_bytes 2 or 4: the
// elements are copied as bits.
int regtr_element_gather(const void* src, const void* idx, void* out,
                         long long batch, long long rows, long long cols,
                         long long src_cols, int axis, long long src_bstride,
                         long long idx_bstride, long long out_bstride,
                         int elem_bytes, void* stream) {
  if (batch <= 0 || rows <= 0 || cols <= 0 || src_cols <= 0 ||
      (axis != 0 && axis != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* ix = static_cast<const int64_t*>(idx);
  if (elem_bytes == 4)
    return launch_elements<uint32_t>(src, ix, out, batch, rows, cols,
                                     src_cols, axis, src_bstride,
                                     idx_bstride, out_bstride, s);
  if (elem_bytes == 2)
    return launch_elements<uint16_t>(src, ix, out, batch, rows, cols,
                                     src_cols, axis, src_bstride,
                                     idx_bstride, out_bstride, s);
  return (int)cudaErrorInvalidValue;
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
