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
// What bounds it on an H100: arithmetic on the CUDA cores, 8 fp32
// operations a candidate (query, support) at 67 TFLOP/s, over the
// candidates that cannot be ruled out from bounding boxes (the clouds are
// spatially sorted, so most of the brute product can), and the bytes of
// the inputs read once and the int64 table written once, which weigh
// about as much: chip_smoke.py phase 3c counts all three.
//
// Design (the first design, one thread a query, is timed below).
//  1. A pre-pass (`pack_kernel`, one block per tile of kTile supports)
//     packs each support as a float4 (x, y, z, |s|^2), a masked one and the
//     tail as (0, 0, 0, inf), so its distance is inf and no test passes it,
//     and writes each tile's box: the min and max corner of its valid
//     supports and a bound on their |s|^2 (the box's farthest corner,
//     rounded up), or an empty mark.  Both go to scratch the wrapper
//     allocates.
//  2. The search: a warp (a team of T = kTeam = 32 lanes) shares one
//     query.  Each warp takes the box of its query, tests 32 tiles at a
//     time against it (one tile a lane) and scans only the tiles it
//     keeps, straight from the packed supports through L1: lane l reads
//     every 32nd support of a tile from l on.  No shared memory, no block
//     barrier: warps run apart.  T stays a template parameter, so that
//     kernel_variants.py --neighbors can time smaller teams (several
//     queries a warp, one box over them).
//  3. Culling.  A tile is skipped when the squared gap between the boxes,
//     computed rounding down (so it is at most the true gap^2), exceeds
//     lim + margin, computed rounding up, where lim is the hot loop's bound
//     (below) largest over the warp's teams.  Margin: the expansion's
//     computed d differs from the true |q - s|^2 by at most
//       g3 (|q|^2 + 2|q||s| + |s|^2)              (the three sums, each of
//                                                  three products: Higham's
//                                                  gamma_3 = 3u / (1 - 3u))
//       + u (1 + u)(1 + g3)(|q| + |s|)^2         (|q|^2 - 2 q.s, rounded)
//       + u (1 + g3)(|q| + |s|)^2                 (+ |s|^2, rounded)
//     <= 5u (1 + O(u)) (|q| + |s|)^2 <= 10u (1 + O(u)) (|q|^2 + |s|^2),
//     u = 2^-24 (the doubling is exact).  The margin is 2^-20 (= 16u) times
//     (Q + S), Q and S the boxes' |.|^2 bounds, plus 1e-36 for products
//     that fall below fp32's normal range (each errs by at most 2^-150).
//     So a support whose computed d passes lim lies in a kept tile, and
//     the table is the plain version's.  Far from the origin the margin
//     grows as |q|^2 (100 m away it is ~0.06 m^2, above level 0's r^2):
//     then little is culled, and nothing is lost.
//     ops/neighbors.py `tile_may_accept` mirrors the test (in float64,
//     which keeps no more than this one); tests/test_torch_neighbors_
//     kernel.py holds it to the plain version on room clouds, the same
//     100 m away, clusters at the key grid's corners and shells at the
//     threshold across tile edges.
//  4. The lists live in registers, spread over the team: lane l holds
//     slots l, l + T, l + 2T, ... of its query's sorted list, as one word
//     per slot: (ordered key << 32 | id) in 64 bits, or, for a bf16 key
//     with Ns < 65536 (every shipped bucket), (the ordered key's top 16
//     bits << 16 | id) in 32 bits, whose order is the same (a bf16 key's
//     low 16 bits are fixed by its sign).  Words are unique (ids are), and
//     the table is the k smallest words, whatever order they arrive in.
//     The hot loop is the distance and one compare of it against `lim`, a
//     bound every accepted support's distance lies below (the threshold,
//     or the list's worst key once the list is full, widened by one bf16
//     step where the key is rounded).  A warp leaves it only when one of
//     its lanes passes; each team then inserts its passing words one at a
//     time, lowest lane first: every lane compares its slots with the word
//     and takes its predecessor's old slot through one __shfl_sync per
//     register, so an insertion costs O(k / T) steps on every lane, not
//     O(k) serial moves in local memory.
//  5. A warp a query at every shape: it culls finest (a box of one
//     query) and fills the card where the clouds are small (level 3,
//     ModelNet's pairs).  Half a warp a query at levels 0-2 measured within
//     the spread of one call (below), so the launch makes no choice and
//     reads no mask: the host never waits.  A lane holds 2 slots of a list
//     of 64 words (k <= 64) or 8 of 256.
//  No atomics and no order between lanes decides a result: the table is
//  the same bits on every run and for every T.
//
// Measured on an H100 (kernel_variants.py --neighbors, single launches in
// turns, the host's launch latency in, NVIDIA H100 80GB HBM3, 700.00 W),
// the ten searches of a 3DMatch forward at bucket 20480, in one call:
//   the first design (one thread a query, a sorted list in local
//   memory, every tile scanned)                            11.466 ms
//   this design without culling (tiles without a valid
//   support skipped, as in the first design)                4.240
//   this design (a warp a query, lists of 64)               1.752
//   teams of 16 where k <= 64 (two queries a warp)          1.629
//   teams of 1 where k <= 64                                9.363
//   64-bit words only                                       2.150
//   diagnostic: nothing inserted (the bound never
//   tightens)                                               1.109
// and a ModelNet pair's four searches: 1.301 (the first design), 0.239
// (this design), 0.289 (teams of 16).  An earlier call, with teams of 16 at
// levels 0-2 and 32 below (chosen by the launch's size) and lists of 32
// words for k <= 32, read 1.569 against 1.590 for this design's teams of
// 32 with those lists and 1.615 with lists of 64 everywhere; teams of 4
// and 8 2.284 and 1.712; tiles of 64 / 256 supports 1.555 / 1.728; no
// register cap (64 now: 8 blocks an SM) 1.617.  Teams of 16 win ~7 % at
// levels 0-2 (~0.1 ms a forward) and lose on the small clouds: not worth a
// launch plan that picks between two kernels.  So the lists cost ~35 % of
// the time and the scan the rest; both are far from the bound of the kept
// candidates (chip_smoke.py phase 3c), and the smallest searches (levels
// 2-3, ModelNet) sit at the ~0.05 ms a launch of the pre-pass and the
// search costs from the host.  Not done: staging the tiles in shared
// memory with cp.async (warps read their own kept tiles through L1; a
// block shares no tile list), and the first design's append-then-sort
// variant (17.268 ms there: the shifts it saved are O(k / T) here).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;       // supports per tile (one box each)
constexpr int kWarps = 4;        // warps per block of the search
constexpr int kUnroll = 8;       // supports in flight per lane
constexpr int kTeam = 32;        // lanes a query: one warp
constexpr int kMinBlocks = 8;    // blocks an SM: at most 64 registers
constexpr unsigned kFull = 0xffffffffu;
constexpr float kMarginScale = 9.5367431640625e-07f;  // 2^-20
constexpr float kMarginFloor = 1e-36f;

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

// d by the expansion, for a packed support (x, y, z, |s|^2).
__device__ __forceinline__ float distance(float qx, float qy, float qz,
                                          float qsq, float4 s) {
  const float dot = __fadd_rn(
      __fadd_rn(__fmul_rn(qx, s.x), __fmul_rn(qy, s.y)), __fmul_rn(qz, s.z));
  return __fadd_rn(__fsub_rn(qsq, __fmul_rn(2.0f, dot)), s.w);
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

// A list word: (ordered key, id) in 64 bits, or the key's top 16 bits and
// a 16-bit id in 32 bits (bf16 keys, Ns < 65536).
template <typename W>
struct Word;

template <>
struct Word<unsigned long long> {
  static constexpr unsigned long long kNone = ~0ull;
  __device__ static unsigned long long make(uint32_t key, int id) {
    return ((unsigned long long)key << 32) | (uint32_t)id;
  }
  __device__ static int id(unsigned long long w) { return (int)(uint32_t)w; }
  __device__ static uint32_t key(unsigned long long w) {
    return (uint32_t)(w >> 32);
  }
};

template <>
struct Word<uint32_t> {
  static constexpr uint32_t kNone = ~0u;
  __device__ static uint32_t make(uint32_t key, int id) {
    return (key & 0xffff0000u) | (uint32_t)id;
  }
  __device__ static int id(uint32_t w) { return (int)(w & 0xffffu); }
  // the full ordered image of the bf16 key: its low half is 0 for a
  // positive key and all ones for a negative one
  __device__ static uint32_t key(uint32_t w) {
    return (w & 0xffff0000u) | ((w & 0x80000000u) ? 0u : 0xffffu);
  }
};

// Min and max over the warp of a float (through its ordered image).
__device__ __forceinline__ float warp_min(float v) {
  return unordered(__reduce_min_sync(kFull, ordered(v)));
}

__device__ __forceinline__ float warp_max(float v) {
  return unordered(__reduce_max_sync(kFull, ordered(v)));
}

// An upper bound of |p|^2 over a box (its farthest corner), rounded up.
__device__ __forceinline__ float box_norm2(float3 lo, float3 hi) {
  const float ax = fmaxf(fabsf(lo.x), fabsf(hi.x));
  const float ay = fmaxf(fabsf(lo.y), fabsf(hi.y));
  const float az = fmaxf(fabsf(lo.z), fabsf(hi.z));
  return __fadd_ru(__fadd_ru(__fmul_ru(ax, ax), __fmul_ru(ay, ay)),
                   __fmul_ru(az, az));
}

// The pre-pass: grid (tiles, batch), kTile threads.  packed: (batch,
// tiles * kTile) float4; boxes: (batch, tiles, 2) float4, (lo, |s|^2
// bound or -1 when the tile holds no valid support) and (hi, 0).
__global__ void __launch_bounds__(kTile)
    pack_kernel(const float* __restrict__ supports,
                const uint8_t* __restrict__ s_mask, int ns, int tiles,
                float4* __restrict__ packed, float4* __restrict__ boxes) {
  __shared__ float part[6][kTile / 32];
  const int b = blockIdx.y;
  const int j = blockIdx.x * kTile + threadIdx.x;
  const size_t row = (size_t)b * ns + j;
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  if (j < ns && s_mask[row]) {
    v.x = supports[row * 3];
    v.y = supports[row * 3 + 1];
    v.z = supports[row * 3 + 2];
    v.w = sq3(v.x, v.y, v.z);
    lo[0] = hi[0] = v.x;
    lo[1] = hi[1] = v.y;
    lo[2] = hi[2] = v.z;
  }
  packed[(size_t)b * tiles * kTile + j] = v;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int a = 0; a < 3; ++a) {
    lo[a] = warp_min(lo[a]);
    hi[a] = warp_max(hi[a]);
    if (lane == 0) {
      part[a][warp] = lo[a];
      part[3 + a][warp] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kTile / 32; ++w)
      for (int a = 0; a < 3; ++a) {
        lo[a] = fminf(lo[a], part[a][w]);
        hi[a] = fmaxf(hi[a], part[3 + a][w]);
      }
    const bool empty = !(lo[0] <= hi[0]);
    const float3 l3 = make_float3(lo[0], lo[1], lo[2]);
    const float3 h3 = make_float3(hi[0], hi[1], hi[2]);
    float4* box = boxes + ((size_t)b * tiles + blockIdx.x) * 2;
    box[0] = make_float4(lo[0], lo[1], lo[2],
                         empty ? -1.f : box_norm2(l3, h3));
    box[1] = make_float4(hi[0], hi[1], hi[2], 0.f);
  }
}

// Whether a tile's supports may hold one whose computed d is <= lim for a
// query in [qlo, qhi] (|q|^2 <= qn2): the squared gap rounded down against
// lim + margin rounded up (the head comment derives the margin).
__device__ __forceinline__ bool tile_may_accept(float3 qlo, float3 qhi,
                                                float qn2, float4 slo,
                                                float4 shi, float lim) {
  if (!(slo.w >= 0.f)) return false;  // no valid support
  const float gx = fmaxf(0.f, fmaxf(__fsub_rd(qlo.x, shi.x),
                                    __fsub_rd(slo.x, qhi.x)));
  const float gy = fmaxf(0.f, fmaxf(__fsub_rd(qlo.y, shi.y),
                                    __fsub_rd(slo.y, qhi.y)));
  const float gz = fmaxf(0.f, fmaxf(__fsub_rd(qlo.z, shi.z),
                                    __fsub_rd(slo.z, qhi.z)));
  const float gap2 = __fadd_rd(__fadd_rd(__fmul_rd(gx, gx), __fmul_rd(gy, gy)),
                               __fmul_rd(gz, gz));
  const float margin = __fadd_ru(
      __fmul_ru(kMarginScale, __fadd_ru(qn2, slo.w)), kMarginFloor);
  return gap2 <= __fadd_ru(lim, margin);
}

// The search: kWarps warps a block, each 32 / T queries of one cloud
// (grid (query groups, batch)); S slots a lane hold a list of T * S >= k.
template <int T, int S, typename W, bool kBf16>
__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
    search_kernel(const float* __restrict__ queries,
                  const uint8_t* __restrict__ q_mask,
                  const float4* __restrict__ packed,
                  const float4* __restrict__ boxes, int nq, int ns, int tiles,
                  int k, float thr, long long* __restrict__ out) {
  using Wd = Word<W>;
  constexpr int kSteps = kTile / T;  // supports a lane reads from a tile
  constexpr int kU = kSteps < kUnroll ? kSteps : kUnroll;
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int tl = lane & (T - 1);                  // lane within the team
  const int team_base = lane & ~(T - 1);
  const unsigned team_bits = (T == 32) ? kFull : ((1u << T) - 1u);
  const int i = (blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / T) +
                lane / T;
  const size_t qrow = (size_t)b * nq + i;
  const bool active = i < nq && q_mask[qrow] != 0;
  const int nregs = (k + T - 1) / T;
  W list[S];
#pragma unroll
  for (int r = 0; r < S; ++r) list[r] = Wd::kNone;

  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (active) {
    qx = queries[qrow * 3];
    qy = queries[qrow * 3 + 1];
    qz = queries[qrow * 3 + 2];
  }
  const float3 qlo = make_float3(warp_min(active ? qx : INFINITY),
                                 warp_min(active ? qy : INFINITY),
                                 warp_min(active ? qz : INFINITY));
  const float3 qhi = make_float3(warp_max(active ? qx : -INFINITY),
                                 warp_max(active ? qy : -INFINITY),
                                 warp_max(active ? qz : -INFINITY));
  if (qlo.x <= qhi.x) {  // the warp holds a valid query
    const float qn2 = box_norm2(qlo, qhi);
    const float qsq = sq3(qx, qy, qz);
    const uint32_t thr_key = ordered(thr);
    float lim = active ? hot_bound<kBf16>(thr) : -INFINITY;
    W worst = Wd::kNone;  // the list's slot k - 1
    const float4* pb = packed + (size_t)b * tiles * kTile;
    const float4* bb = boxes + (size_t)b * tiles * 2;

    for (int c0 = 0; c0 < tiles; c0 += 32) {
      const float wlim = warp_max(lim);
      const int ct = c0 + lane;
      const bool keep =
          ct < tiles && tile_may_accept(qlo, qhi, qn2, __ldg(bb + 2 * ct),
                                        __ldg(bb + 2 * ct + 1), wlim);
      unsigned kept = __ballot_sync(kFull, keep);
      while (kept) {
        const int t = c0 + __ffs(kept) - 1;
        kept &= kept - 1;
        const float4* tp = pb + t * kTile + tl;
#pragma unroll 1
        for (int s0 = 0; s0 < kSteps; s0 += kU) {
          unsigned pass = 0;  // bit u: support (s0 + u) * T + tl passed lim
#pragma unroll
          for (int u = 0; u < kU; ++u) {
            const float d =
                distance(qx, qy, qz, qsq, __ldg(tp + (s0 + u) * T));
            pass |= (unsigned)(d <= lim) << u;
          }
          // the rare path: each team inserts its passing words, one at a
          // time, lowest lane first
          while (__any_sync(kFull, pass != 0)) {
            W w = Wd::kNone;
            if (pass) {
              const int u = __ffs(pass) - 1;
              pass &= pass - 1;
              const float d =
                  distance(qx, qy, qz, qsq, __ldg(tp + (s0 + u) * T));
              const uint32_t key = ordered(key_of<kBf16>(d));
              if (key <= thr_key)
                w = Wd::make(key, t * kTile + (s0 + u) * T + tl);
            }
            unsigned want =
                (__ballot_sync(kFull, w < worst) >> team_base) & team_bits;
            while (__any_sync(kFull, want != 0)) {
              const int src = want ? __ffs(want) - 1 : 0;
              const bool ins = want != 0;
              want &= want - 1;
              const W c = __shfl_sync(kFull, w, src, T);
              // slot r * T + tl takes c where its predecessor is below c
              // and its own word above, its predecessor's where both are
              // above: descending r, so each read is of an old slot
#pragma unroll
              for (int r = S - 1; r >= 0; --r) {
                if (r < nregs) {
                  const W give =
                      tl == T - 1 ? (r > 0 ? list[r - 1] : Wd::kNone)
                                  : list[r];
                  W prev =
                      __shfl_sync(kFull, give, (tl + T - 1) & (T - 1), T);
                  if (r == 0 && tl == 0) prev = 0;
                  const W cur = list[r];
                  if (ins && cur > c) list[r] = prev > c ? prev : c;
                }
              }
              W last = Wd::kNone;
#pragma unroll
              for (int r = 0; r < S; ++r)
                if (r == (k - 1) / T) last = list[r];
              worst = __shfl_sync(kFull, last, (k - 1) % T, T);
              if (worst != Wd::kNone)
                lim = hot_bound<kBf16>(unordered(Wd::key(worst)));
            }
          }
        }
      }
    }
  }
  if (i < nq) {
    long long* row = out + qrow * k;
#pragma unroll
    for (int r = 0; r < S; ++r) {
      const int slot = r * T + tl;
      if (r < nregs && slot < k)
        row[slot] = list[r] == Wd::kNone ? (long long)ns
                                         : (long long)Wd::id(list[r]);
    }
  }
}

// The slots a lane of a team of `team` holds for lists of max_k words.
constexpr int slots_for(int team, int max_k) {
  return (max_k + team - 1) / team;
}

template <int T, int S, typename W, bool kBf16>
void launch_search(const float* q, const uint8_t* qm, const float4* packed,
                   const float4* boxes, int batch, int nq, int ns, int tiles,
                   int k, float thr, long long* out, cudaStream_t stream) {
  constexpr int kPerBlock = kWarps * (32 / T);
  const dim3 grid((unsigned)((nq + kPerBlock - 1) / kPerBlock),
                  (unsigned)batch);
  search_kernel<T, S, W, kBf16><<<grid, kWarps * 32, 0, stream>>>(
      q, qm, packed, boxes, nq, ns, tiles, k, thr, out);
}

// A warp a query, its list of 64 words (k <= 64) or of 256.
template <typename W, bool kBf16>
void launch(const float* q, const uint8_t* qm, const float4* packed,
            const float4* boxes, int batch, int nq, int ns, int tiles, int k,
            float thr, long long* out, cudaStream_t stream) {
  if (k <= 64)
    launch_search<kTeam, slots_for(kTeam, 64), W, kBf16>(
        q, qm, packed, boxes, batch, nq, ns, tiles, k, thr, out, stream);
  else
    launch_search<kTeam, slots_for(kTeam, 256), W, kBf16>(
        q, qm, packed, boxes, batch, nq, ns, tiles, k, thr, out, stream);
}

// 32-bit words for a bf16 key whose ids fit 16 bits, else 64-bit ones.
bool short_words(long long ns, int bf16_key) {
  return bf16_key && ns < 65536;
}

long long tiles_of(long long ns) { return (ns + kTile - 1) / kTile; }

}  // namespace

extern "C" {

// The largest k the kernels take.
int regtr_neighbors_max_k() { return 256; }

// Bytes of scratch a search over (batch, ns) supports needs: the packed
// supports and the tiles' boxes.
long long regtr_neighbors_scratch_bytes(long long batch, long long ns) {
  return batch * tiles_of(ns) * (kTile + 2) * (long long)sizeof(float4);
}

// Launches on `stream`; returns cudaGetLastError() after the launches.
// queries: (batch, nq, 3) fp32, q_mask: (batch, nq) bool, supports:
// (batch, ns, 3) fp32, s_mask: (batch, ns) bool, all contiguous; thr: the
// acceptance threshold; bf16_key: 1 to select on bf16-rounded distances,
// 0 on the fp32 ones; out: (batch, nq, k) int64, every slot written;
// scratch: regtr_neighbors_scratch_bytes(batch, ns) bytes, 16-aligned.
// Checked by the caller (regtr_tpu_torch/ops/neighbors.py).
int regtr_brute_neighbors(const void* queries, const void* q_mask,
                          const void* supports, const void* s_mask,
                          long long batch, long long nq, long long ns,
                          int k, float thr, int bf16_key, void* out,
                          void* scratch, void* stream) {
  if (batch <= 0 || batch > 65535 || nq <= 0 || ns <= 0 || k <= 0 ||
      nq >= (1LL << 31) || ns >= (1LL << 31) - kTile ||
      k > regtr_neighbors_max_k() || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const auto* q = static_cast<const float*>(queries);
  const auto* qm = static_cast<const uint8_t*>(q_mask);
  auto* o = static_cast<long long*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = (int)tiles_of(ns);
  auto* packed = static_cast<float4*>(scratch);
  float4* boxes = packed + (size_t)batch * tiles * kTile;
  pack_kernel<<<dim3((unsigned)tiles, (unsigned)batch), kTile, 0, st>>>(
      static_cast<const float*>(supports), static_cast<const uint8_t*>(s_mask),
      (int)ns, tiles, packed, boxes);
  if (!bf16_key)
    launch<unsigned long long, false>(q, qm, packed, boxes, (int)batch,
                                      (int)nq, (int)ns, tiles, k, thr, o, st);
  else if (short_words(ns, bf16_key))
    launch<uint32_t, true>(q, qm, packed, boxes, (int)batch, (int)nq,
                           (int)ns, tiles, k, thr, o, st);
  else
    launch<unsigned long long, true>(q, qm, packed, boxes, (int)batch,
                                     (int)nq, (int)ns, tiles, k, thr, o, st);
  return (int)cudaGetLastError();
}

const char* regtr_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
