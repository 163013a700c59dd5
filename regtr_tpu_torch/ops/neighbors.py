"""Fixed-K radius neighbor searches (counterparts of regtr_tpu/ops/
neighbors.py), batched over a leading cloud axis.

Contract: an (B, Nq, K) index table into the support cloud; entries equal
to Ns are "shadow" neighbors pointing at an appended pad row; only supports
within the radius are returned, nearest first.

Three searches, as in the JAX package (`neighbor_method`):
  * 'brute' (the default): fp32 distances by the |q|^2 - 2 q.s + |s|^2
    expansion, selection on their bf16 rounding (on the fp32 values when
    Ns < 4K).  The JAX version selects with `jax.lax.approx_min_k`, the
    TPU's own partial reduction; here a CUDA tensor launches the K6 kernel
    (csrc/neighbors.cu: tiles of supports culled by bounding boxes, each
    query's list spread over the registers of a warp; `tile_may_accept`
    below mirrors its culling test for the tests) and a CPU tensor takes
    the plain version
    (`brute_radius_neighbors_plain`), which computes the same bits: the
    K nearest by (key, support id), so that equal keys go lowest id
    first (`jax.lax.top_k`'s rule).  Ties in bf16 at the K-th slot may
    resolve to a different (equally near) point than in JAX, whose
    approximate reduction has no fixed rule for them.
  * 'scan': the streaming exact merge over support chunks, on fp32
    distances.
  * 'grid': candidates from the 27 cells of edge `radius` around each
    query, from per-cloud cell tables (sort and scatter).
'scan' and 'grid' select the K nearest with `jax.lax.top_k`'s order: by
distance, ties lowest candidate position first.  Here that is a stable
sort of the fp32 distances, and the selected candidates' ids are taken by
the element gather (ops/gather.py `element_gather`, the K5b kernel on CUDA
tensors, which moves the int32 ids' bits).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from .cuda_build import CudaLibrary
from .gather import element_gather, row_gather

_INF = 3.0e38
_BITS = 10
_MAXC = (1 << _BITS) - 1
_KEY_SENTINEL = 2 ** 31 - 1
MAX_K = 256      # csrc/neighbors.cu regtr_neighbors_max_k


def _declare(lib):
    lib.regtr_brute_neighbors.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 3)
    lib.regtr_brute_neighbors.restype = ctypes.c_int
    lib.regtr_neighbors_scratch_bytes.argtypes = [ctypes.c_longlong] * 2
    lib.regtr_neighbors_scratch_bytes.restype = ctypes.c_longlong
    lib.regtr_neighbors_max_k.argtypes = []
    lib.regtr_neighbors_max_k.restype = ctypes.c_int


NEIGHBORS_LIBRARY = CudaLibrary("neighbors.cu", _declare)


def _sq3(x, y, z):
    """(x*x + y*y) + z*z elementwise, in that order."""
    return (x * x + y * y) + z * z


def _sortable(key: torch.Tensor) -> torch.Tensor:
    """fp32 (or its bits as int32) -> int64 in the order of the floats
    (-0 below +0): the bits as int32 with the magnitude bits of a negative
    float flipped.  On int32 the map is its own inverse."""
    bits = key.view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()


def brute_radius_neighbors_plain(queries: torch.Tensor, q_mask: torch.Tensor,
                                 supports: torch.Tensor,
                                 s_mask: torch.Tensor, radius: float, k: int,
                                 query_chunk: int = 4096) -> torch.Tensor:
    """K-nearest-within-radius table, distances by the expansion: the plain
    version of the K6 kernel, and its specification.

    queries (B, Nq, 3), q_mask (B, Nq), supports (B, Ns, 3), s_mask (B, Ns)
    -> (B, Nq, k) int64, shadow entries = Ns.

    Each sum is taken elementwise in one fixed order (`_sq3`, and q.s as
    (qx*sx + qy*sy) + qz*sz), with no matrix product, so that the kernel
    can repeat it bit for bit.  The selection key is the bf16 rounding of
    the fp32 distance (the fp32 distance when Ns < 4k); the k smallest
    keys are taken, equal keys lowest support id first (a top-k of int64
    (key, id) words), and kept where key <= r^2 * 1.004.
    """
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    sx, sy, sz = supports.unbind(-1)
    s_sq = _sq3(sx, sy, sz)
    s_masked = torch.where(s_mask[..., None], supports,
                           torch.full_like(supports, 1e6))
    s_sq_masked = torch.where(s_mask, s_sq, torch.full_like(s_sq, 1e13))
    sx, sy, sz = (c[:, None, :] for c in s_masked.unbind(-1))
    s_sq_masked = s_sq_masked[:, None, :]
    ids = torch.arange(ns, dtype=torch.int64, device=queries.device)
    r_sq = torch.full((), radius * radius, dtype=torch.float32,
                      device=queries.device)
    k_eff = min(k, ns)
    use_exact = ns < 4 * k   # tiny support sets: selection on fp32 values

    out = torch.empty((b, nq, k), dtype=torch.int64, device=queries.device)
    for q0 in range(0, nq, query_chunk):
        qx, qy, qz = (c[..., None] for c in
                      queries[:, q0:q0 + query_chunk].unbind(-1))
        dot = (qx * sx + qy * sy) + qz * sz
        d = (_sq3(qx, qy, qz) - 2.0 * dot) + s_sq_masked
        # fp32 distances, selection on their bf16 rounding: in-radius
        # values are small (<= r^2), where bf16's 0.4% relative error only
        # moves the effective radius, hence the 1.004 margin below.
        key = d if use_exact else d.to(torch.bfloat16).to(torch.float32)
        words = torch.topk((_sortable(key) << 32) | ids, k_eff, dim=-1,
                           largest=False).values
        idx = words & 0xFFFFFFFF
        vals = _sortable((words >> 32).int()).int().view(torch.float32)
        ok = (vals <= r_sq * 1.004) & q_mask[:, q0:q0 + query_chunk, None]
        sel = torch.where(ok, idx, torch.full_like(idx, ns))
        out[:, q0:q0 + query_chunk, :k_eff] = sel
    out[..., k_eff:] = ns
    return out


def acceptance_threshold(radius: float) -> float:
    """The fp32 threshold the kernel takes, computed in numpy: the bits of
    the plain version's `r_sq * 1.004` (the fp32 square of the radius, times
    1.004 rounded to fp32)."""
    return float(np.float32(radius * radius) * np.float32(1.004))


# The kernel's tile culling (csrc/neighbors.cu), mirrored for the tests
# and for chip_smoke.py's culled bound: no path runs these.
TILE = 128                  # kTile: supports a tile, one bounding box each
MARGIN_SCALE = 2.0 ** -20   # kMarginScale: the rounding margin's factor
MARGIN_FLOOR = 1e-36        # kMarginFloor


def hot_bound(t: float, bf16_key: bool) -> float:
    """The kernel's bound on the distance of a support whose key is <= t:
    t widened by a bf16 step (2^-7 |t|, and 1e-37) for a bf16 key, in fp32
    as the kernel rounds it."""
    t = np.float32(t)
    if not bf16_key:
        return float(t)
    return float((t + np.float32(abs(t)) * np.float32(0.0078125))
                 + np.float32(1e-37))


def run_boxes(points: torch.Tensor, mask: torch.Tensor, size: int):
    """The boxes of runs of `size` consecutive points of each cloud:
    (B, N, 3), (B, N) -> lo, hi (B, ceil(N / size), 3) float64, the min and
    max corner of each run's valid points (+inf / -inf where it has none):
    the kernel's tile boxes (size TILE), and its warps' query boxes (size
    1: a warp a query; 32 / T for kernel_variants.py's teams of T)."""
    b, n, _ = points.shape
    pad = -n % size
    p = torch.cat([points.double(), points.new_zeros(b, pad, 3).double()], 1)
    m = torch.cat([mask, mask.new_zeros(b, pad)], 1)[..., None]
    p, m = p.reshape(b, -1, size, 3), m.reshape(b, -1, size, 1)
    inf = torch.tensor(float("inf"), dtype=torch.float64, device=p.device)
    return (torch.where(m, p, inf).amin(2), torch.where(m, p, -inf).amax(2))


def tile_may_accept(q_lo, q_hi, s_lo, s_hi, lim: float) -> torch.Tensor:
    """The kernel's culling test in float64 (`tile_may_accept` of
    csrc/neighbors.cu): whether a support in the box [s_lo, s_hi] may have a
    computed distance <= lim from a query in [q_lo, q_hi], i.e. the squared
    gap between the boxes is <= lim + 2^-20 (|q|^2 + |s|^2) + 1e-36, the
    norms bounded by the boxes' farthest corners.  Boxes broadcast over
    leading axes (..., 3); an empty box (lo > hi) accepts nothing.  The
    kernel rounds the gap down and the right side up, so it keeps every
    pair this keeps."""
    gap = torch.maximum(q_lo - s_hi, s_lo - q_hi).clamp_min(0.0)
    gap2 = (gap * gap).sum(-1)

    def norm2(lo, hi):
        return (torch.maximum(lo.abs(), hi.abs()) ** 2).sum(-1)

    margin = MARGIN_SCALE * (norm2(q_lo, q_hi) + norm2(s_lo, s_hi))
    full = (q_lo[..., 0] <= q_hi[..., 0]) & (s_lo[..., 0] <= s_hi[..., 0])
    return full & (gap2 <= lim + margin + MARGIN_FLOOR)


def check_kernel_inputs(queries, q_mask, supports, s_mask, k: int) -> None:
    """Raise ValueError unless the kernel takes these inputs: queries (B,
    Nq, 3) and supports (B, Ns, 3) fp32, q_mask (B, Nq) and s_mask (B, Ns)
    bool, all contiguous and on one device, and 1 <= k <= MAX_K."""
    b, nq, ns = queries.shape[0], queries.shape[1], supports.shape[1]
    for name, x, shape, dtype in (
            ("queries", queries, (b, nq, 3), torch.float32),
            ("q_mask", q_mask, (b, nq), torch.bool),
            ("supports", supports, (b, ns, 3), torch.float32),
            ("s_mask", s_mask, (b, ns), torch.bool)):
        if (tuple(x.shape) != shape or x.dtype != dtype
                or x.device != queries.device or not x.is_contiguous()):
            raise ValueError(
                f"brute neighbor search: {name} must be a contiguous "
                f"{dtype} {shape} on {queries.device}, got "
                f"{'a non-contiguous ' if not x.is_contiguous() else ''}"
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"brute neighbor search: k {k} not in [1, {MAX_K}]")


def brute_radius_neighbors(queries: torch.Tensor, q_mask: torch.Tensor,
                           supports: torch.Tensor, s_mask: torch.Tensor,
                           radius: float, k: int,
                           query_chunk: int = 4096) -> torch.Tensor:
    """The brute search: on CUDA tensors the K6 kernel (one search over
    the whole batch, its tile pre-pass and scan on the current stream,
    scratch from torch.empty; `.launches` counts one a search), on CPU
    tensors the plain version (which alone reads `query_chunk`); any other
    device raises.

    Shapes as `brute_radius_neighbors_plain`; the kernel's inputs as
    `check_kernel_inputs` says -> (B, Nq, k) int64, shadow entries = Ns.
    """
    if queries.device.type == "cpu":
        return brute_radius_neighbors_plain(queries, q_mask, supports,
                                            s_mask, radius, k, query_chunk)
    if queries.device.type != "cuda":
        raise ValueError(f"no brute neighbor search for device "
                         f"{queries.device}")
    check_kernel_inputs(queries, q_mask, supports, s_mask, k)
    b, nq, ns = queries.shape[0], queries.shape[1], supports.shape[1]
    out = torch.empty((b, nq, k), dtype=torch.int64, device=queries.device)
    if ns == 0:
        return out.fill_(0)
    if out.numel() == 0:
        return out
    lib = NEIGHBORS_LIBRARY.load()
    scratch = torch.empty(lib.regtr_neighbors_scratch_bytes(b, ns),
                          dtype=torch.uint8, device=queries.device)
    with torch.cuda.device(queries.device):
        err = lib.regtr_brute_neighbors(
            queries.data_ptr(), q_mask.data_ptr(), supports.data_ptr(),
            s_mask.data_ptr(), b, nq, ns, k, acceptance_threshold(radius),
            int(ns >= 4 * k), out.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(queries.device).cuda_stream)
    NEIGHBORS_LIBRARY.check(err, "brute neighbor search")
    brute_radius_neighbors.launches += 1
    return out


brute_radius_neighbors.launches = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _nearest(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of d (..., C) fp32, ties lowest position first (as
    jax.lax.top_k of -d), and the int32 ids at their positions ->
    (distances, ids) (..., k)."""
    vals, pos = torch.sort(d, dim=-1, stable=True)
    return vals[..., :k], element_gather(ids, pos[..., :k].contiguous(), 1)


def _radius_sq(radius: float, device) -> torch.Tensor:
    """The fp32 square of the fp32 radius, as the JAX searches compute it
    from their traced radius."""
    r = torch.tensor(radius, dtype=torch.float32, device=device)
    return r * r


def scan_radius_neighbors(queries: torch.Tensor, q_mask: torch.Tensor,
                          supports: torch.Tensor, s_mask: torch.Tensor,
                          radius: float, k: int, chunk: int = 1024
                          ) -> torch.Tensor:
    """K-nearest-within-radius table by a streaming merge over support
    chunks (`radius_neighbors` of the JAX package, its oracle path).

    queries (B, Nq, 3), q_mask (B, Nq), supports (B, Ns, 3), s_mask (B, Ns)
    -> (B, Nq, k) int64, shadow entries = Ns.  Each chunk's fp32 distances
    are merged into the running k best by `_nearest`.
    """
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    dev = queries.device
    chunk = min(chunk, _round_up(ns, 8))
    pad = _round_up(ns, chunk) - ns
    supports_p = torch.cat([supports, supports.new_zeros(b, pad, 3)], dim=1)
    s_mask_p = torch.cat([s_mask, s_mask.new_zeros(b, pad)], dim=1)
    q_sq = (queries * queries).sum(dim=-1, keepdim=True)     # (B, Nq, 1)
    best_d = torch.full((b, nq, k), _INF, dtype=torch.float32, device=dev)
    best_i = torch.full((b, nq, k), ns, dtype=torch.int32, device=dev)
    for base in range(0, ns + pad, chunk):
        s_pts = supports_p[:, base:base + chunk]
        d = (q_sq - 2.0 * (queries @ s_pts.transpose(1, 2))
             + (s_pts * s_pts).sum(dim=-1)[:, None, :]).clamp_min(0.0)
        d = torch.where(s_mask_p[:, None, base:base + chunk], d, _INF)
        cand_i = torch.arange(base, base + chunk, dtype=torch.int32,
                              device=dev).expand(b, nq, chunk)
        best_d, best_i = _nearest(torch.cat([best_d, d], dim=-1),
                                  torch.cat([best_i, cand_i], dim=-1), k)
    in_range = (best_d <= _radius_sq(radius, dev)) & q_mask[..., None]
    return torch.where(in_range, best_i, ns).long()


def _pack_cells(ijk: torch.Tensor) -> torch.Tensor:
    """(..., 3) int32 cell coordinates in [0, 1023] -> int32 key."""
    return ijk[..., 0] | (ijk[..., 1] << _BITS) | (ijk[..., 2] << (2 * _BITS))


_CELL_OFFSETS = [(i, j, l) for i in (-1, 0, 1) for j in (-1, 0, 1)
                 for l in (-1, 0, 1)]


def _grid_one(queries, q_mask, supports, s_mask, cell, r_sq, k, cell_cap):
    """One cloud of `grid_radius_neighbors`: (Nq, 3), (Nq,), (Ns, 3), (Ns,)
    -> (Nq, k) int32."""
    nq, ns = queries.shape[0], supports.shape[0]
    dev = queries.device
    masked_s = torch.where(s_mask[:, None], supports, 1e9)
    # a margin of one cell keeps the query cells at the boundary in range
    origin = torch.floor(masked_s.amin(dim=0) / cell) - 1.0
    ijk_s = (torch.floor(supports / cell) - origin).to(torch.int32).clamp(
        0, _MAXC)
    key_s = torch.where(s_mask, _pack_cells(ijk_s), _KEY_SENTINEL)

    order = torch.argsort(key_s, stable=True)
    key_sorted = key_s[order]
    valid_sorted = key_sorted != _KEY_SENTINEL
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         key_sorted[1:] != key_sorted[:-1]]) & valid_sorted
    cell_id = torch.cumsum(new_run.int(), 0) - 1              # (Ns,)
    arange = torch.arange(ns, device=dev)
    first_of_run = torch.cummax(torch.where(new_run, arange, -1), 0).values
    rank = arange - first_of_run
    # the sorted cell keys (sentinel-padded) and each cell's members, the
    # first cell_cap in sorted order: an overflowing cell drops its highest
    # sorted indices
    uniq_keys = torch.full((ns,), _KEY_SENTINEL, dtype=torch.int32,
                           device=dev)
    uniq_keys[cell_id[new_run]] = key_sorted[new_run]
    table = torch.full((ns, cell_cap), ns, dtype=torch.int32, device=dev)
    kept = valid_sorted & (rank < cell_cap)
    table[cell_id[kept], rank[kept]] = order[kept].int()

    ijk_q = (torch.floor(queries / cell) - origin).to(torch.int32).clamp(
        0, _MAXC)
    offs = torch.tensor(_CELL_OFFSETS, dtype=torch.int32, device=dev)
    cand_cells = ijk_q[:, None, :] + offs                     # (Nq, 27, 3)
    in_range = ((cand_cells >= 0) & (cand_cells <= _MAXC)).all(dim=-1)
    cand_keys = _pack_cells(cand_cells.clamp(0, _MAXC)).reshape(-1)
    rows = torch.searchsorted(uniq_keys, cand_keys).clamp(0, ns - 1)
    found = (uniq_keys[rows] == cand_keys) & in_range.reshape(-1)
    cand = torch.where(found[:, None], table[rows], ns).reshape(
        nq, 27 * cell_cap)

    s_pad = torch.cat([supports.float(), supports.new_full((1, 3), 1e6)])
    cand_pts = row_gather(s_pad.contiguous(), cand.reshape(-1)).reshape(
        nq, 27 * cell_cap, 3)
    d = ((cand_pts - queries[:, None, :]) ** 2).sum(dim=-1)
    ok = (cand < ns) & (d <= r_sq) & q_mask[:, None]
    vals, idx = _nearest(torch.where(ok, d, _INF), cand, k)
    return torch.where(vals <= r_sq, idx, ns)


def grid_radius_neighbors(queries: torch.Tensor, q_mask: torch.Tensor,
                          supports: torch.Tensor, s_mask: torch.Tensor,
                          radius: float, k: int, cell_cap: int = 32
                          ) -> torch.Tensor:
    """K-nearest-within-radius table from grid cells of edge `radius`
    (`grid_radius_neighbors` of the JAX package): each cloud's supports are
    sorted into cells, each query takes the members of the 27 cells around
    its own (at most `cell_cap` per cell) as candidates and keeps the k
    nearest within the radius.  Shapes as `scan_radius_neighbors`."""
    if supports.shape[1] == 0:
        raise ValueError("grid search over an empty support cloud")
    dev = queries.device
    cell = torch.tensor(radius, dtype=torch.float32, device=dev)
    r_sq = _radius_sq(radius, dev)
    out = [_grid_one(queries[i], q_mask[i], supports[i], s_mask[i], cell,
                     r_sq, k, cell_cap) for i in range(queries.shape[0])]
    return torch.stack(out).long()


def radius_neighbors_batch(queries, q_mask, supports, s_mask, radius: float,
                           k: int, method: str = "brute", chunk: int = 1024,
                           cell_cap: int = 32) -> torch.Tensor:
    """The search `method` names ('brute', 'scan' or 'grid'), as the JAX
    package's `radius_neighbors_batch` dispatches it."""
    if method == "brute":
        return brute_radius_neighbors(queries, q_mask, supports, s_mask,
                                      radius, k)
    if method == "grid":
        return grid_radius_neighbors(queries, q_mask, supports, s_mask,
                                     radius, k, cell_cap)
    if method == "scan":
        return scan_radius_neighbors(queries, q_mask, supports, s_mask,
                                     radius, k, chunk)
    raise ValueError(f"unknown neighbor method {method!r}")
