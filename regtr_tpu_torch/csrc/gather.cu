// Row and element gathers for Hopper (sm_90a), plain C interface.
//
// Row gather: out[r, :] = table[idx[r], :] for a contiguous (rows_table,
// row_bytes) table and int32 or int64 indices.  It is the forward of every
// neighbor gather of the backbone: the feature rows (fp32 or bf16, width 32
// to 256) and the fp32 coordinate rows (width 3, 12 bytes), over the
// clouds' tables flattened with one pad (shadow) row per cloud, by the
// table's int32 flat ids.  The indices are in range by construction and are
// not clamped.
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
// output stores are coalesced.  Narrow rows of one to four vectors under
// 16 bytes (the fp32 coordinate rows: 12 B, three 4-byte vectors): a block
// gathers kDirectRows rows per thread into shared memory, each thread the
// rows of two 16-byte vectors of int32 indices (four of int64), and then
// writes the block's output span, which is contiguous, as 16-byte vectors
// with neighbouring threads on neighbouring vectors (the first design, one
// row per thread stored as three 4-byte vectors at a 12-byte stride, made
// each warp store touch the same sectors three times).  No atomics: every output
// element is written by one thread, so the result is the table's bits,
// bitwise equal to index_select.
//
// The element gather moves the int64 indices (8 bytes per output) and the
// outputs in order, and along axis 1 each source row once: at the probes'
// shape (160, 32, 5120) fp32 that is 420 MB, 0.125 ms at 3.35 TB/s.  The
// TPU probe (exp_pallas_gather5.py k3) gathers each window from VMEM; here
// each source row goes through shared memory, Hopper's counterpart (see
// element_gather_kernel).  Copies of bits again: bitwise torch.gather.
// Measured on an H100 (chip_smoke.py phase 3b, kernel_variants.py
// --gather): 0.162-0.186 ms at that shape, 67-77 % of the bound, 1.09-1.19x
// torch.gather's speed in turns; the first design (one thread per element,
// two divisions each, the source read from device memory at every gathered
// position) took 0.205-0.226 ms.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <algorithm>

#include "sm90_ptx.cuh"

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 20;  // the rest by a grid-stride loop
constexpr int kDirectRows = 8;  // rows per thread (4: 14 % slower)
constexpr int kDirectBlockRows = kThreads * kDirectRows;
constexpr bool kVectorIds = true;  // indices as 16-byte loads when aligned
constexpr bool kStageVectors = true;  // a thread's rows staged as 16 bytes
// I: the type of the flat vector counter, 32-bit when the count allows (a
// 32-bit division per vector instead of a 64-bit one); Ix: the indices'.
template <typename V, typename I, typename Ix>
__global__ void __launch_bounds__(kThreads)
    row_gather_kernel(const V* __restrict__ table, const Ix* __restrict__ idx,
                      V* __restrict__ out, I total, I vecs_per_row) {
  const I step = (I)gridDim.x * kThreads;
  for (I t = (I)blockIdx.x * kThreads + threadIdx.x; t < total; t += step) {
    const I r = t / vecs_per_row;
    const I v = t - r * vecs_per_row;
    out[t] = table[(int64_t)idx[r] * (int64_t)vecs_per_row + v];
  }
}

// kDirectRows consecutive indices from idx[0..n) (n may be short at the
// span's end): 16-byte loads when `vec` (idx on 16 bytes, n full) and the
// indices fill whole 16-byte vectors.
template <typename Ix>
__device__ __forceinline__ void load_ids(const Ix* idx, int n, bool vec,
                                         Ix (&id)[kDirectRows]) {
  constexpr int kPer16 = 16 / sizeof(Ix);
  if constexpr (kDirectRows % kPer16 == 0) {
    if (vec && n >= kDirectRows) {
#pragma unroll
      for (int h = 0; h < kDirectRows / kPer16; ++h) {
        union {
          uint4 v;
          Ix e[kPer16];
        } pack;
        pack.v = reinterpret_cast<const uint4*>(idx)[h];
#pragma unroll
        for (int e = 0; e < kPer16; ++e) id[h * kPer16 + e] = pack.e[e];
      }
      return;
    }
  }
#pragma unroll
  for (int k = 0; k < kDirectRows; ++k) id[k] = k < n ? idx[k] : Ix(0);
}

// One block per kDirectBlockRows rows: gather into shared memory (the rows
// at their output offsets), then copy the block's contiguous output span.
// A thread's kDirectRows rows are contiguous in the stage: it writes them
// as 16-byte vectors when they fill whole ones (the 12-byte rows: three
// vectors, without bank conflicts, where twelve 4-byte stores at a 48-byte
// stride would conflict four ways).  `out16`: out on 16 bytes, so the span
// (kDirectBlockRows * row bytes after out, a multiple of 2048 bytes)
// starts on 16 bytes too.
template <typename V, typename Ix, int kVecs>
__global__ void __launch_bounds__(kThreads)
    row_gather_narrow_kernel(const V* __restrict__ table,
                             const Ix* __restrict__ idx,
                             unsigned char* __restrict__ out, long long rows,
                             bool ids16, bool out16) {
  constexpr int kRowBytes = kVecs * (int)sizeof(V);
  constexpr int kThreadVecs = kDirectRows * kVecs;
  constexpr bool kStage16 = kStageVectors &&
                            kThreadVecs * sizeof(V) % 16 == 0;
  extern __shared__ __align__(16) unsigned char stage[];
  const long long base = (long long)blockIdx.x * kDirectBlockRows;
  const int n = (int)min((long long)kDirectBlockRows, rows - base);
  const int r0 = threadIdx.x * kDirectRows;
  Ix id[kDirectRows];
  load_ids(idx + base + r0, n - r0, kVectorIds && ids16, id);
  union {
    V v[kThreadVecs];
    uint4 q[kStage16 ? kThreadVecs * sizeof(V) / 16 : 1];
  } mine;
#pragma unroll
  for (int k = 0; k < kDirectRows; ++k) {
    const V* src = table + (int64_t)id[k] * kVecs;
#pragma unroll
    for (int i = 0; i < kVecs; ++i)
      if (r0 + k < n) mine.v[k * kVecs + i] = src[i];
  }
  if (kStage16 && r0 + kDirectRows <= n) {
    uint4* s = reinterpret_cast<uint4*>(stage + r0 * kRowBytes);
#pragma unroll
    for (int c = 0; c < (kStage16 ? kThreadVecs * sizeof(V) / 16 : 0); ++c)
      s[c] = mine.q[c];
  } else {
    V* s = reinterpret_cast<V*>(stage + r0 * kRowBytes);
#pragma unroll
    for (int j = 0; j < kThreadVecs; ++j)
      if (r0 + j / kVecs < n) s[j] = mine.v[j];
  }
  __syncthreads();
  const int span = n * kRowBytes;
  unsigned char* o = out + base * kRowBytes;
  int done = 0;
  if (out16) {
    done = span / 16 * 16;
    for (int b = threadIdx.x * 16; b < done; b += kThreads * 16)
      *reinterpret_cast<uint4*>(o + b) =
          *reinterpret_cast<const uint4*>(stage + b);
  }
  for (int b = done + threadIdx.x * (int)sizeof(V); b < span;
       b += kThreads * (int)sizeof(V))
    *reinterpret_cast<V*>(o + b) = *reinterpret_cast<const V*>(stage + b);
}

template <typename V, typename Ix, int kVecs>
int launch_narrow(const V* table, const Ix* idx, void* out, long long rows,
                  cudaStream_t s) {
  const long long blocks = (rows + kDirectBlockRows - 1) / kDirectBlockRows;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  const size_t smem = (size_t)kDirectBlockRows * kVecs * sizeof(V);
  auto kernel = row_gather_narrow_kernel<V, Ix, kVecs>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const bool ids16 = reinterpret_cast<uintptr_t>(idx) % 16 == 0;
  const bool out16 = reinterpret_cast<uintptr_t>(out) % 16 == 0;
  kernel<<<(unsigned)blocks, kThreads, smem, s>>>(
      table, idx, static_cast<unsigned char*>(out), rows, ids16, out16);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, size_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename V, typename Ix>
int launch_rows(const void* table, const Ix* idx, void* out, long long rows,
                long long vecs_per_row, cudaStream_t s) {
  const V* t = static_cast<const V*>(table);
  if constexpr (sizeof(V) < 16) {
    switch (vecs_per_row) {
      case 1: return launch_narrow<V, Ix, 1>(t, idx, out, rows, s);
      case 2: return launch_narrow<V, Ix, 2>(t, idx, out, rows, s);
      case 3: return launch_narrow<V, Ix, 3>(t, idx, out, rows, s);
      case 4: return launch_narrow<V, Ix, 4>(t, idx, out, rows, s);
      default: break;  // wider rows: one vector per thread, below
    }
  }
  V* o = static_cast<V*>(out);
  const long long total = rows * vecs_per_row;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  if (total < (1LL << 31)) {
    row_gather_kernel<V, uint32_t, Ix><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, idx, o, (uint32_t)total, (uint32_t)vecs_per_row);
  } else {
    row_gather_kernel<V, int64_t, Ix><<<(unsigned)blocks, kThreads, 0, s>>>(
        t, idx, o, (int64_t)total, (int64_t)vecs_per_row);
  }
  return (int)cudaGetLastError();
}

template <typename Ix>
int launch_rows_any(const void* table, const Ix* idx, void* out,
                    long long rows, long long row_bytes, cudaStream_t s) {
  // The widest vector that divides the row and both pointers' alignment.
  const size_t widths[] = {16, 8, 4, 2};
  for (size_t width : widths) {
    if (row_bytes % width != 0 || !aligned(table, width) ||
        !aligned(out, width))
      continue;
    const long long vecs = row_bytes / (long long)width;
    switch (width) {
      case 16: return launch_rows<uint4>(table, idx, out, rows, vecs, s);
      case 8: return launch_rows<uint2>(table, idx, out, rows, vecs, s);
      case 4: return launch_rows<uint32_t>(table, idx, out, rows, vecs, s);
      default: return launch_rows<uint16_t>(table, idx, out, rows, vecs, s);
    }
  }
  return (int)cudaErrorMisalignedAddress;
}

// The element gather.  One block per output row (b, i) and column chunk:
// a 2-D grid, so no thread divides.  Each thread takes kVec consecutive
// outputs (16 bytes: 4 fp32 or 8 bf16) at a time, kUnroll such vectors per
// batch: their indices as 16-byte loads of two int64 each (all of a batch's
// loads in flight together), their values gathered, one 16-byte store per
// vector.  The row's head and tail off those 16 bytes go element by element.
//   kShared (axis 1; this kernel's only axis-1 form): the block copies
//   source row (b, i), which every output of the row reads, into shared
//   memory by cp.async, keeping the row's offset modulo 16 bytes; the
//   first batch of indices loads while the row lands; then it gathers from
//   shared memory: the row is read from device memory once instead of once
//   per output.
//   Otherwise, on axis 0, the values come from device memory.  An axis-1
//   gather that is not staged (a row wider than a block's shared memory,
//   or one whose outputs are few beside its width) goes to
//   element_gather_direct_kernel, one thread per output.
struct ElementArgs {
  const void* src;
  const int64_t* idx;
  void* out;
  long long rows, cols, src_cols;
  long long src_bstride, idx_bstride, out_bstride;  // in elements
};

constexpr int kUnroll = 4;  // vectors per batch

template <typename T>
struct Vec16 {
  static constexpr int kVec = 16 / sizeof(T);
};

template <typename T, bool kShared>
__global__ void __launch_bounds__(kThreads)
    element_gather_kernel(const ElementArgs a, int chunk) {
  constexpr int kVec = Vec16<T>::kVec;
  extern __shared__ __align__(16) unsigned char smem[];
  const long long b = blockIdx.x / a.rows;  // once per block
  const long long i = blockIdx.x - b * a.rows;
  const T* src = static_cast<const T*>(a.src) + b * a.src_bstride;
  const int64_t* idx = a.idx + b * a.idx_bstride + i * a.cols;
  T* out = static_cast<T*>(a.out) + b * a.out_bstride + i * a.cols;

  const long long j0 = (long long)blockIdx.y * chunk;
  const long long j1 = min(a.cols, j0 + chunk);
  // Outputs [j0, head) up to the first 16-byte boundary of out, and
  // [body_end, j1) after the last whole vector, go one by one.
  const long long to16 =
      ((16 - (reinterpret_cast<uintptr_t>(out + j0) & 15)) & 15) / sizeof(T);
  const long long head = min(j1, j0 + to16);
  const long long body_end = head + (j1 - head) / kVec * kVec;
  // Index vectors need idx[head] on 16 bytes; else 8-byte loads.
  const bool idx16 = (reinterpret_cast<uintptr_t>(idx + head) & 15) == 0;
  const long long step = (long long)blockDim.x * kVec;

  int64_t k[kUnroll][kVec];
  auto load_batch = [&](long long j) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + u * step;
      if (jj >= body_end) continue;
      if (idx16) {
#pragma unroll
        for (int w = 0; w < kVec / 2; ++w) {
          const longlong2 kk =
              __ldcs(reinterpret_cast<const longlong2*>(idx + jj) + w);
          k[u][2 * w] = kk.x;
          k[u][2 * w + 1] = kk.y;
        }
      } else {
#pragma unroll
        for (int w = 0; w < kVec; ++w)
          k[u][w] = __ldcs(reinterpret_cast<const long long*>(idx + jj + w));
      }
    }
  };

  // Source row i (axis 1) or the whole (src_rows, src_cols) slice (axis 0):
  // the value of index k in column j is row[k] or row[k * src_cols + j].
  const T* row = kShared ? src + i * a.src_cols : src;
  long long j = head + (long long)threadIdx.x * kVec;
  if constexpr (kShared) {
    // The row's bytes at the same offset modulo 16 in shared memory.
    const uintptr_t start = reinterpret_cast<uintptr_t>(row);
    const uintptr_t first = start & ~uintptr_t(15);
    const uintptr_t end = start + a.src_cols * sizeof(T);
    const long long n16 = (long long)((end + 15 - first) >> 4);
    for (long long v = threadIdx.x; v < n16; v += blockDim.x) {
      const uintptr_t at = first + 16 * v;
      if (at >= start && at + 16 <= end) {
        cp_async16(smem + 16 * v, reinterpret_cast<const void*>(at), true);
      } else {  // the 16-byte words that hold the row's head or tail
        for (int e = 0; e < 16; e += (int)sizeof(T))
          if (at + e >= start && at + e < end)
            *reinterpret_cast<T*>(smem + 16 * v + e) =
                *reinterpret_cast<const T*>(at + e);
      }
    }
    cp_async_commit();
    load_batch(j);
    cp_async_wait_all();
    __syncthreads();
    row = reinterpret_cast<const T*>(smem + (start - first));
  } else {
    load_batch(j);
  }
  auto value = [&](int64_t kk, long long jj) -> T {
    return kShared ? row[kk] : row[kk * a.src_cols + jj];
  };

  for (; j < body_end; j += kUnroll * step) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long jj = j + u * step;
      if (jj >= body_end) continue;
      union {
        uint4 v;
        T e[kVec];
      } pack;
#pragma unroll
      for (int w = 0; w < kVec; ++w) pack.e[w] = value(k[u][w], jj + w);
      __stcs(reinterpret_cast<uint4*>(out + jj), pack.v);
    }
    load_batch(j + kUnroll * step);
  }
  for (long long jj = j0 + threadIdx.x; jj < head; jj += blockDim.x)
    out[jj] = value(idx[jj], jj);
  for (long long jj = body_end + threadIdx.x; jj < j1; jj += blockDim.x)
    out[jj] = value(idx[jj], jj);
}

// Axis 1, unstaged: one thread per output, over all (b, i, j) at once,
// so that a block spans many short rows instead of idling most of its
// threads on one, and a wide row spreads over many blocks.  A block takes
// kThreads * kDirect consecutive outputs, each thread kDirect of them
// kThreads apart (their index loads all in flight before their gathers):
// a warp's loads and stores are coalesced and a block's rows adjacent.  I
// numbers the outputs, 32-bit when they fit (its divisions are a few
// instructions where 64-bit ones are a long emulated sequence).
constexpr int kDirect = 4;

template <typename T, typename I>
__global__ void __launch_bounds__(kThreads)
    element_gather_direct_kernel(const ElementArgs a, I total) {
  const I cols = (I)a.cols, rows = (I)a.rows;
  const I e0 = (I)blockIdx.x * (kThreads * kDirect) + threadIdx.x;
  long long k[kDirect], at[kDirect], src_row[kDirect];
#pragma unroll
  for (int u = 0; u < kDirect; ++u) {
    const I e = e0 + u * kThreads;
    if (e >= total) continue;
    const I r = e / cols;  // (b, i) as one row number
    const I j = e - r * cols;
    const I b = r / rows;
    const I i = r - b * rows;
    at[u] = (long long)b * a.out_bstride + (long long)i * a.cols + j;
    src_row[u] = (long long)b * a.src_bstride + (long long)i * a.src_cols;
    k[u] = __ldcs(reinterpret_cast<const long long*>(
        a.idx + (long long)b * a.idx_bstride + (long long)i * a.cols + j));
  }
#pragma unroll
  for (int u = 0; u < kDirect; ++u) {
    if (e0 + u * kThreads >= total) continue;
    __stcs(static_cast<T*>(a.out) + at[u],
           static_cast<const T*>(a.src)[src_row[u] + k[u]]);
  }
}

int max_shared_bytes() {
  static int bytes = -1;
  if (bytes < 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev) != cudaSuccess)
      bytes = 48 * 1024;
  }
  return bytes;
}

template <typename T, bool kShared>
int launch_elements_as(const ElementArgs& a, long long batch,
                       size_t smem_bytes, cudaStream_t s) {
  constexpr int kVec = Vec16<T>::kVec;
  auto kernel = element_gather_kernel<T, kShared>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  // kShared: one block per row reads the row once; else (axis 0) chunks of
  // at most kThreads vectors, so that a wide row spreads over several
  // blocks.
  const long long chunk =
      kShared ? a.cols : (long long)kThreads * kVec * kUnroll;
  const long long chunks = (a.cols + chunk - 1) / chunk;
  // As many threads as the row has vectors, in whole warps, up to kThreads.
  long long threads = (std::min(a.cols, chunk) + kVec - 1) / kVec;
  threads = std::min((long long)kThreads, (threads + 31) / 32 * 32);
  const long long blocks = batch * a.rows;
  if (blocks >= (1LL << 31) || chunks > 65535 || chunk > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  kernel<<<dim3((unsigned)blocks, (unsigned)chunks), (unsigned)threads,
           smem_bytes, s>>>(a, (int)chunk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_elements(const ElementArgs& a, long long batch, int axis,
                    cudaStream_t s) {
  if (axis == 0) return launch_elements_as<T, false>(a, batch, 0, s);
  // The source row in shared memory, with up to 16 bytes of alignment slack,
  // when it fits and the row's outputs would read as many bytes from device
  // memory one by one (a 32-byte sector each, at worst) as the row holds: a
  // neighbor search's merge takes 32 of 1056 candidates a row, and staging
  // its rows would read 4x the bytes of the direct gather.
  const size_t row_bytes = (size_t)a.src_cols * sizeof(T) + 32;
  if (row_bytes <= (size_t)max_shared_bytes() &&
      (size_t)a.cols * 32 >= (size_t)a.src_cols * sizeof(T))
    return launch_elements_as<T, true>(a, batch, row_bytes, s);
  const long long total = batch * a.rows * a.cols;
  const long long per_block = (long long)kThreads * kDirect;
  const long long blocks = (total + per_block - 1) / per_block;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidConfiguration;
  // 32-bit numbering while every block's outputs stay below 2^32
  if (blocks * per_block < (1LL << 32))
    element_gather_direct_kernel<T, uint32_t>
        <<<(unsigned)blocks, kThreads, 0, s>>>(a, (uint32_t)total);
  else
    element_gather_direct_kernel<T, unsigned long long>
        <<<(unsigned)blocks, kThreads, 0, s>>>(a,
                                               (unsigned long long)total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns cudaGetLastError() after the launch.
// table: (rows_table, row_bytes) contiguous, row_bytes even; idx: (rows,)
// int32 (idx_int64 0) or int64 (1), each in [0, rows_table); out: (rows,
// row_bytes), every byte written.  Checked by the caller
// (regtr_tpu_torch/ops/gather.py).
int regtr_row_gather(const void* table, const void* idx, int idx_int64,
                     void* out, long long rows, long long row_bytes,
                     void* stream) {
  if (rows <= 0 || row_bytes <= 0 || row_bytes % 2 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_int64)
    return launch_rows_any(table, static_cast<const int64_t*>(idx), out, rows,
                           row_bytes, s);
  return launch_rows_any(table, static_cast<const int32_t*>(idx), out, rows,
                         row_bytes, s);
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
  const ElementArgs a{src, static_cast<const int64_t*>(idx), out, rows,
                      cols, src_cols, src_bstride, idx_bstride, out_bstride};
  if (elem_bytes == 4) return launch_elements<uint32_t>(a, batch, axis, s);
  if (elem_bytes == 2) return launch_elements<uint16_t>(a, batch, axis, s);
  return (int)cudaErrorInvalidValue;
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
