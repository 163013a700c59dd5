// The gather transpose for Hopper (sm_90a), plain C interface: the backward
// of every padded neighbor gather of the backbone, as a transpose of the
// gather's table of flat row ids, built once per table, and a segment sum
// over it.
//
// Transpose (entry regtr_segment_transpose).  For ids (rows,) int32 or
// int64 in [0, num_segments):
//   perm[starts[s] .. starts[s+1]) = the rows r with id[r] == s, in
//                                    increasing order (int32)
//   starts (num_segments + 1, int32), CSR offsets; starts[0] = 0
// with the pad rows dropped: a row whose id % seg_stride == seg_stride - 1
// names a per-cloud pad row, whose gradient the callers discard, and lands
// in no segment.  perm[starts[num_segments]:] is not written.  The result
// is bit for bit a stable sort of the ids with the pad rows dropped (the
// plain version, regtr_tpu_torch/ops/kpconv.py segment_transpose_reference).
// Seven kernels, launched together:
//   count: one thread per row: rank[r] = atomicAdd(&starts[1 + id], 1),
//          the row's place among its segment's rows in the order the
//          atomics happened to run;
//   scan:  starts[1:] summed in place (chunk sums, a one-block scan of
//          them, each chunk scanned with its offset): the CSR offsets; the
//          last of the three also lists the segments of more than
//          kLongSegment rows;
//   fill:  one thread per row: tmp[starts[id] + rank[r]] = r;
//   order: one thread per non-pad row of a segment of at most kLongSegment
//          rows puts it at its place in increasing order: its segment's
//          start plus the number of the segment's rows below it, so the
//          result does not depend on the atomics' order.  A segment of n
//          rows costs n^2 compares spread over its n threads (the main
//          paths' tables hold at most a few dozen rows per segment: 47 at
//          the training step's level 0);
//   long:  the listed segments, each over kLongChunks chunks of the rows,
//          a block per (chunk, segment): one kernel counts the chunk's rows
//          that name the segment, the next scans the chunk again in row
//          order and writes those rows from the segment's start plus the
//          earlier chunks' counts, a block-wide scan giving each its place.
//          O(rows) reads per long segment, where the compares would cost
//          n^2.  Such segments arise where a stride past the last segment
//          keeps each cloud's shadow row (batched_row_gather's backward:
//          ~350 000 rows in one segment per cloud at the training step's
//          level 0).  At most rows / kLongSegment segments are long, so a
//          transpose reads O(rows^2 / kLongSegment) ids at worst.
// What bounds it on an H100: bytes.  At the training step's level-0 table
// (3 145 728 int32 ids, 98 308 segments) the function reads the ids and
// writes perm's non-pad rows and starts: ~20 MB, 0.006 ms at 3.35 TB/s.
// The design moves ~5x that (the ids twice, rank, tmp and perm about twice
// each, all but the ids' first read within the 50 MB L2), and the count's
// atomics go to 98 308 counters in L2, few rows on one counter.  With each
// cloud's shadow row kept (4 segments of ~350 000 rows at that table) the
// transpose takes ~1 ms on an H100 (kernel_variants.py --segsum), likely
// paced by the count's atomics on 4 counters (not timed alone); the long
// pass on one block per segment took 2.4 ms.  kLongSegment 1024 put the
// ~1400-row segments on the long pass: 1.35x slower than their compares.
//
// Sum (entry regtr_segsum):
//   out[s, :] = sum of g[r, :] over perm[starts[s] .. starts[s+1])   (fp32)
// and 0 for an empty segment (a pad row's among them).  One warp per
// segment, lanes over channels, adds the segment's rows in perm's order in
// fp32: no atomics, so the result is bitwise the same on every run, and
// rows in increasing order, as the stable sort of the first design gave
// them.  It reads each cotangent row of a non-pad segment once (at level 0
// of the 3DMatch training step ~1.8 M of 3.1 M rows of 32 to 128 fp32
// channels) and does one add per element: bound by memory (3.35 TB/s).
// Rows are read in permuted order, but each row is one contiguous run of
// 64 bytes or more.  A warp loads 32 row indices at once, broadcasts them
// with shuffles and keeps kRows rows' loads in flight before it adds them,
// in order (one dependent load per row took 15 % longer at level 0 and
// 2.2x as long on ~1400-row segments).  One warp owns a segment however
// long, so a segment of ~350 000 rows (the shadow rows kept) takes ~45 ms.
//
// Replaces the TPU kernel regtr_tpu/ops/pallas/segsum.py::_kernel (entry
// sorted_padded_segment_sum, whose argsort runs outside the kernel).  The
// TPU kernel's one-hot MXU matmul, lane packing and int32 loop carriers work
// around the TPU and are not ported.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 1LL << 16;  // the rest by a grid-stride loop
constexpr int kWarps = 2;  // segments per block (8: 13 % slower)
constexpr int kVec = 4;    // channels per lane per pass: 128 per warp
constexpr int kRows = 8;   // rows whose loads a warp keeps in flight

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Longer segments are ordered by the long pass: each over kLongChunks
// chunks of the rows, at most kLongSlots segments at once.
constexpr int kLongSegment = 4096;
constexpr int kLongChunks = 64;
constexpr int kLongSlots = 8;
constexpr int kLongItems = 16;  // consecutive ids per thread per pass

// Ids are < num_segments < 2^31, so the pad test runs in 32 bits.
template <typename I>
__device__ __forceinline__ bool is_pad(I id, int stride) {
  return (int)id % stride == stride - 1;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    transpose_count_kernel(const I* __restrict__ ids, long long rows,
                           int stride, int* __restrict__ counts,
                           int* __restrict__ rank) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < rows; r += step) {
    const I id = ids[r];
    if (!is_pad(id, stride)) rank[r] = atomicAdd(counts + id, 1);
  }
}

// Exclusive scan of one int per thread over the block; *total gets the
// block's sum.  Every thread of the block calls it.
__device__ __forceinline__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kThreads / 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kThreads / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < kThreads / 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const int before = (warp > 0 ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before;
}

constexpr int kScanItems = 16;  // consecutive counts per thread
constexpr int kScanChunk = kThreads * kScanItems;

// Scan, 1 of 3: sums[b] = the sum of chunk b of counts (n of them).
__global__ void __launch_bounds__(kThreads)
    scan_reduce_kernel(const int* __restrict__ counts, int n,
                       int* __restrict__ sums) {
  const long long first =
      (long long)blockIdx.x * kScanChunk + threadIdx.x * kScanItems;
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i)
    if (first + i < n) mine += counts[first + i];
  int total;
  block_exclusive_scan(mine, &total);
  if (threadIdx.x == 0) sums[blockIdx.x] = total;
}

// Scan, 2 of 3 (one block): the chunk sums (m of them) to their exclusive
// prefix sums, kThreads at a time; the list of long segments emptied.
__global__ void __launch_bounds__(kThreads)
    scan_sums_kernel(int* __restrict__ sums, int m,
                     int* __restrict__ long_segs) {
  if (threadIdx.x == 0) long_segs[0] = 0;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int i = base + threadIdx.x;
    int total;
    const int before = block_exclusive_scan(i < m ? sums[i] : 0, &total);
    if (i < m) sums[i] = carry + before;
    carry += total;
  }
}

// Scan, 3 of 3: counts to their inclusive prefix sums, each chunk from its
// offset; the segments of more than kLongSegment rows to long_segs[1:] (in
// any order), their number to long_segs[0] (zeroed by scan_sums_kernel).
__global__ void __launch_bounds__(kThreads)
    scan_apply_kernel(int* __restrict__ counts, int n,
                      const int* __restrict__ sums,
                      int* __restrict__ long_segs) {
  const long long first =
      (long long)blockIdx.x * kScanChunk + threadIdx.x * kScanItems;
  int v[kScanItems];
  int mine = 0;
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    v[i] = first + i < n ? counts[first + i] : 0;
    mine += v[i];
  }
  int total;
  int run = sums[blockIdx.x] + block_exclusive_scan(mine, &total);
#pragma unroll
  for (int i = 0; i < kScanItems; ++i) {
    run += v[i];
    if (first + i < n) counts[first + i] = run;
    if (v[i] > kLongSegment)
      long_segs[1 + atomicAdd(long_segs, 1)] = (int)(first + i);
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    transpose_fill_kernel(const I* __restrict__ ids, long long rows,
                          int stride, const int* __restrict__ starts,
                          const int* __restrict__ rank,
                          int* __restrict__ tmp) {
  const long long step = (long long)gridDim.x * kThreads;
  for (long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
       r < rows; r += step) {
    const I id = ids[r];
    if (!is_pad(id, stride)) tmp[starts[id] + rank[r]] = (int)r;
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    transpose_order_kernel(const I* __restrict__ ids,
                           const int* __restrict__ starts,
                           const int* __restrict__ tmp,
                           int* __restrict__ perm, int num_segments) {
  const int placed = starts[num_segments];  // the non-pad rows
  const int step = gridDim.x * kThreads;
  for (int p = blockIdx.x * kThreads + threadIdx.x; p < placed; p += step) {
    const int r = tmp[p];
    const int seg = (int)ids[r];
    const int lo = starts[seg], hi = starts[seg + 1];
    if (hi - lo > kLongSegment) continue;  // the long pass's
    int below = 0;
#pragma unroll 4
    for (int q = lo; q < hi; ++q) below += tmp[q] < r;
    perm[lo + below] = r;
  }
}

// The long pass over long_segs[1 : 1 + long_segs[0]]: block (c, y) takes
// chunk c of the rows for the segments y, y + gridDim.y, ...  The count
// kernel writes each chunk's number of the segment's rows to
// chunk_counts[i * kLongChunks + c] (i: the segment's place in the list);
// the place kernel writes those rows, in increasing order, to perm from
// the segment's start plus the earlier chunks' counts.
__device__ __forceinline__ void long_chunk(long long rows, long long* lo,
                                           long long* hi) {
  const long long len = (rows + kLongChunks - 1) / kLongChunks;
  *lo = blockIdx.x * len;
  *hi = *lo + len < rows ? *lo + len : rows;
}

// The rows' hits on segment seg among kLongItems consecutive ids from first
// (bit j: row first + j).
template <typename I>
__device__ __forceinline__ unsigned long_hits(const I* __restrict__ ids,
                                              long long first, long long hi,
                                              int seg) {
  unsigned hits = 0;
#pragma unroll
  for (int j = 0; j < kLongItems; ++j)
    if (first + j < hi && ids[first + j] == (I)seg) hits |= 1u << j;
  return hits;
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    transpose_long_count_kernel(const I* __restrict__ ids, long long rows,
                                const int* __restrict__ long_segs,
                                int* __restrict__ chunk_counts) {
  constexpr long long kTile = (long long)kThreads * kLongItems;
  long long lo, hi;
  long_chunk(rows, &lo, &hi);
  const int n_long = long_segs[0];
  for (int i = blockIdx.y; i < n_long; i += gridDim.y) {
    const int seg = long_segs[1 + i];
    int mine = 0;
    for (long long base = lo; base < hi; base += kTile)
      mine += __popc(long_hits(
          ids, base + (long long)threadIdx.x * kLongItems, hi, seg));
    int total;
    block_exclusive_scan(mine, &total);
    if (threadIdx.x == 0) chunk_counts[i * kLongChunks + blockIdx.x] = total;
  }
}

template <typename I>
__global__ void __launch_bounds__(kThreads)
    transpose_long_place_kernel(const I* __restrict__ ids, long long rows,
                                const int* __restrict__ starts,
                                const int* __restrict__ long_segs,
                                const int* __restrict__ chunk_counts,
                                int* __restrict__ perm) {
  constexpr long long kTile = (long long)kThreads * kLongItems;
  long long lo, hi;
  long_chunk(rows, &lo, &hi);
  const int n_long = long_segs[0];
  for (int i = blockIdx.y; i < n_long; i += gridDim.y) {
    const int seg = long_segs[1 + i];
    int at = starts[seg];
    for (int c = 0; c < (int)blockIdx.x; ++c)
      at += chunk_counts[i * kLongChunks + c];
    for (long long base = lo; base < hi; base += kTile) {
      const long long first = base + (long long)threadIdx.x * kLongItems;
      unsigned hits = long_hits(ids, first, hi, seg);
      int total;
      int out = at + block_exclusive_scan(__popc(hits), &total);
      for (; hits; hits &= hits - 1)
        perm[out++] = (int)(first + __ffs(hits) - 1);
      at += total;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
    segsum_kernel(const T* __restrict__ g, const int* __restrict__ perm,
                  const int* __restrict__ starts, float* __restrict__ out,
                  int num_segments, int c) {
  const int seg = blockIdx.x * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (seg >= num_segments) return;
  const int r0 = starts[seg];
  const int r1 = starts[seg + 1];
  float* o = out + (long long)seg * c;
  for (int c0 = 0; c0 < c; c0 += 32 * kVec) {
    float acc[kVec];
#pragma unroll
    for (int i = 0; i < kVec; ++i) acc[i] = 0.f;
    for (int rb = r0; rb < r1; rb += 32) {
      const int n = min(32, r1 - rb);
      const int mine = lane < n ? perm[rb + lane] : 0;
      int j = 0;
      // kRows rows' loads issued together, then added in order
      for (; j + kRows <= n; j += kRows) {
        float v[kRows][kVec];
#pragma unroll
        for (int u = 0; u < kRows; ++u) {
          const T* row =
              g + (long long)__shfl_sync(0xffffffffu, mine, j + u) * c;
#pragma unroll
          for (int i = 0; i < kVec; ++i) {
            const int cc = c0 + i * 32 + lane;
            v[u][i] = cc < c ? to_float(row[cc]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kRows; ++u)
#pragma unroll
          for (int i = 0; i < kVec; ++i) acc[i] += v[u][i];
      }
      for (; j < n; ++j) {
        const T* row = g + (long long)__shfl_sync(0xffffffffu, mine, j) * c;
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

unsigned row_blocks(long long rows) {
  const long long blocks = (rows + kThreads - 1) / kThreads;
  return (unsigned)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool bad_sizes(long long rows, long long num_segments, long long stride) {
  return rows <= 0 || rows >= INT32_MAX || num_segments <= 0 ||
         num_segments >= INT32_MAX || stride <= 0 ||
         stride > num_segments + 1;
}

}  // namespace

extern "C" {

// Every entry launches on `stream` and returns the first CUDA error of its
// launches.  Checked by the caller (regtr_tpu_torch/ops/kpconv.py).

// The number of ints of scratch regtr_segment_transpose needs in `tmp`:
// the filled rows (or the scan's chunk sums, before them), then the list
// of long segments and their chunks' counts.
long long regtr_segment_transpose_scratch(long long rows,
                                          long long num_segments) {
  const long long chunks = (num_segments + kScanChunk - 1) / kScanChunk;
  const long long max_long = rows / (kLongSegment + 1);
  return (rows > chunks ? rows : chunks) + 1 + max_long * (1 + kLongChunks);
}

// ids: (rows,) int32 (ids_int64 0) or int64 (1), each in [0,
// num_segments); stride <= num_segments + 1 (a stride past the last
// segment drops no row); starts: (num_segments + 1,) int32 and perm:
// (rows,) int32, written; tmp: int32 scratch of
// regtr_segment_transpose_scratch(rows, num_segments).
int regtr_segment_transpose(const void* ids, int ids_int64, long long rows,
                            long long num_segments, long long stride,
                            void* starts, void* perm, void* tmp,
                            void* stream) {
  if (bad_sizes(rows, num_segments, stride))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* st = static_cast<int*>(starts);
  int* pm = static_cast<int*>(perm);  // each row's rank until the order pass
  int* t = static_cast<int*>(tmp);
  const int n = (int)num_segments;
  const unsigned blocks = row_blocks(rows);
  cudaError_t err = cudaMemsetAsync(st, 0, (num_segments + 1) * sizeof(int),
                                    s);
  if (err != cudaSuccess) return (int)err;
  if (ids_int64) {
    transpose_count_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int64_t*>(ids), rows, (int)stride, st + 1, pm);
  } else {
    transpose_count_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        static_cast<const int32_t*>(ids), rows, (int)stride, st + 1, pm);
  }
  // the chunk sums live in tmp until the fill, the long segments' list
  // and their chunks' counts past the rows
  const int chunks = (int)((num_segments + kScanChunk - 1) / kScanChunk);
  int* long_segs = t + (rows > chunks ? rows : chunks);
  const long long max_long = rows / (kLongSegment + 1);
  int* chunk_counts = long_segs + 1 + max_long;
  const dim3 long_grid(kLongChunks, (unsigned)(max_long < kLongSlots
                                                   ? max_long : kLongSlots));
  scan_reduce_kernel<<<chunks, kThreads, 0, s>>>(st + 1, n, t);
  scan_sums_kernel<<<1, kThreads, 0, s>>>(t, chunks, long_segs);
  scan_apply_kernel<<<chunks, kThreads, 0, s>>>(st + 1, n, t, long_segs);
  if (ids_int64) {
    const int64_t* ix = static_cast<const int64_t*>(ids);
    transpose_fill_kernel<int64_t><<<blocks, kThreads, 0, s>>>(
        ix, rows, (int)stride, st, pm, t);
    transpose_order_kernel<int64_t><<<blocks, kThreads, 0, s>>>(ix, st, t,
                                                                pm, n);
    if (max_long) {
      transpose_long_count_kernel<int64_t><<<long_grid, kThreads, 0, s>>>(
          ix, rows, long_segs, chunk_counts);
      transpose_long_place_kernel<int64_t><<<long_grid, kThreads, 0, s>>>(
          ix, rows, st, long_segs, chunk_counts, pm);
    }
  } else {
    const int32_t* ix = static_cast<const int32_t*>(ids);
    transpose_fill_kernel<int32_t><<<blocks, kThreads, 0, s>>>(
        ix, rows, (int)stride, st, pm, t);
    transpose_order_kernel<int32_t><<<blocks, kThreads, 0, s>>>(ix, st, t,
                                                                pm, n);
    if (max_long) {
      transpose_long_count_kernel<int32_t><<<long_grid, kThreads, 0, s>>>(
          ix, rows, long_segs, chunk_counts);
      transpose_long_place_kernel<int32_t><<<long_grid, kThreads, 0, s>>>(
          ix, rows, st, long_segs, chunk_counts, pm);
    }
  }
  return (int)cudaGetLastError();
}

// g: (rows, c) fp32 (is_bf16 0) or bf16 (1); perm, starts: int32, a
// transpose of g's rows as above; out: (num_segments, c) fp32, every
// element written.
int regtr_segsum(const void* g, const void* perm, const void* starts,
                 void* out, long long num_segments, int c, int is_bf16,
                 void* stream) {
  if (num_segments <= 0 || num_segments >= INT32_MAX || c <= 0)
    return (int)cudaErrorInvalidValue;
  const long long blocks = (num_segments + kWarps - 1) / kWarps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(perm);
  const int* st = static_cast<const int*>(starts);
  float* o = static_cast<float*>(out);
  if (is_bf16) {
    segsum_kernel<__nv_bfloat16><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        static_cast<const __nv_bfloat16*>(g), p, st, o, (int)num_segments, c);
  } else {
    segsum_kernel<float><<<(unsigned)blocks, kWarps * 32, 0, s>>>(
        static_cast<const float*>(g), p, st, o, (int)num_segments, c);
  }
  return (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
