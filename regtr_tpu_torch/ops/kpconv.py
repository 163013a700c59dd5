"""Kernel-point convolution (counterpart of regtr_tpu/ops/kpconv.py, rigid
path), with the gather transpose of its feature gathers as a CUDA kernel.

Math per query q with neighbors n (shadow neighbors point at an appended
pad row with coordinates SHADOW_COORD and zero features):
    d[n, p]   = || (x_n - x_q) - kernel_p ||
    w[n, p]   = influence(d)              (linear: relu(1 - d / extent))
    f[p, c]   = sum_n w[n, p] * feat[n, c]
    out[c']   = sum_{p, c} f[p, c] * W[p, c, c']   / n_valid_neighbors

Precision follows the JAX version's bf16 config: coordinates stay fp32 up to
the neighbor-minus-query subtraction, then `rel`, the influence tensor, the
gathered features and the weights are rounded to the compute dtype, and
every contraction accumulates in fp32.  A product of two bf16 values is
exact in fp32, so "bf16 operands, fp32 accumulation" is computed here as an
fp32 product of the bf16-rounded operands.

Row layout: the JAX version bit-splits fp32 coordinates into bf16 halves so
features and coordinates ride in one gathered row, a TPU trick.  Here the
coordinates (fp32) and the features (compute dtype) are two gathers with one
flat index; only the feature gather carries a gradient.

Gathers: every neighbor gather is one flat row gather over the clouds'
tables, `row_gather` (ops/gather.py): on a CUDA tensor it launches
csrc/gather.cu, on a CPU tensor it runs `index_select`.  A neighbor table
is named by its `GatherIndex`: the table and its flat ids (int32), made
once and shared by the gathers over that table (its coordinate gather and
its feature gathers).  The backward is the gather transpose: an fp32
segment sum of the cotangent rows by flat index.  It runs in two parts,
both in csrc/segsum.cu on CUDA tensors: the table's transpose
(`segment_transpose`: for each segment its rows in increasing order, pad
rows dropped), built by the `GatherIndex` at the first backward that needs
it and kept for the table's other gathers, and the sum over it
(`segment_sum`, one warp per segment adding its rows in that order).  CPU
tensors take their plain versions (`segment_transpose_reference`, a stable
sort; `segment_sum_reference`).  Every feature gather goes through
`batched_row_gather_padded`, whose backward drops the rows of each cloud's
pad (shadow) row; `batched_row_gather` drops none, so its backward builds
a transpose of its own each time (no main path runs it: the coordinates
take no gradient).  The sums are added in a fixed order, so the backward
is bitwise repeatable; `index_add_` on CUDA adds with atomics in a
run-dependent order.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary
from .gather import row_gather

SHADOW_COORD = 1e6


def _declare_segsum(lib):
    lib.regtr_segment_transpose.argtypes = (
        [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_longlong] * 3
        + [ctypes.c_void_p] * 4)
    lib.regtr_segment_transpose.restype = ctypes.c_int
    lib.regtr_segment_transpose_scratch.argtypes = [ctypes.c_longlong] * 2
    lib.regtr_segment_transpose_scratch.restype = ctypes.c_longlong
    lib.regtr_segsum.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p])
    lib.regtr_segsum.restype = ctypes.c_int


SEGSUM_LIBRARY = CudaLibrary("segsum.cu", _declare_segsum)
INT32_MAX = 2 ** 31 - 1


class SegmentTranspose(NamedTuple):
    """The transpose of a table of flat ids (CSR): the rows of segment s
    are perm[starts[s]:starts[s + 1]] in increasing order, pad rows in no
    segment.  perm (R,) int32, starts (num_segments + 1,) int32;
    perm[starts[-1]:] holds no segment's rows (the plain version puts the
    pad rows there, the kernel leaves it unwritten)."""
    perm: torch.Tensor
    starts: torch.Tensor


def _segment_args(flat_ids, num_segments, seg_stride):
    if flat_ids.dim() != 1 or flat_ids.dtype not in (torch.int32,
                                                     torch.int64):
        raise ValueError(f"flat ids must be (R,) int32/int64, got "
                         f"{tuple(flat_ids.shape)} {flat_ids.dtype}")
    if not 0 < num_segments < INT32_MAX or seg_stride < 1:
        raise ValueError(f"num_segments {num_segments}, seg_stride "
                         f"{seg_stride}")
    if flat_ids.shape[0] >= INT32_MAX:
        raise ValueError(f"{flat_ids.shape[0]} rows: perm is int32")
    # A segment stride past the last segment drops no row.
    return min(seg_stride, num_segments + 1)


def segment_transpose_reference(flat_ids: torch.Tensor, num_segments: int,
                                seg_stride: int) -> SegmentTranspose:
    """Plain version: a stable sort of the ids with the pad rows (id %
    seg_stride == seg_stride - 1) sorted past every segment, and each
    segment's start in it."""
    seg_stride = _segment_args(flat_ids, num_segments, seg_stride)
    ids = flat_ids.long()
    keys = torch.where(ids % seg_stride == seg_stride - 1, num_segments, ids)
    sorted_keys, perm = torch.sort(keys, stable=True)
    starts = torch.searchsorted(
        sorted_keys, torch.arange(num_segments + 1, device=ids.device))
    return SegmentTranspose(perm.int(), starts.int())


def segment_transpose(flat_ids: torch.Tensor, num_segments: int,
                      seg_stride: int) -> SegmentTranspose:
    """`segment_transpose_reference`'s function by the transpose kernels
    (csrc/segsum.cu: count, scan, fill, order and, for segments of
    thousands of rows, the long pass; one call) on CUDA tensors, bitwise
    equal on perm[:starts[-1]] and starts; CPU tensors take the plain
    version."""
    if flat_ids.device.type == "cpu":
        return segment_transpose_reference(flat_ids, num_segments,
                                           seg_stride)
    if flat_ids.device.type != "cuda":
        raise ValueError(f"no segment transpose for device "
                         f"{flat_ids.device}")
    seg_stride = _segment_args(flat_ids, num_segments, seg_stride)
    flat_ids = flat_ids.contiguous()
    rows, dev = flat_ids.shape[0], flat_ids.device
    perm = torch.empty(rows, dtype=torch.int32, device=dev)
    if rows == 0:
        return SegmentTranspose(perm, torch.zeros(
            num_segments + 1, dtype=torch.int32, device=dev))
    starts = torch.empty(num_segments + 1, dtype=torch.int32, device=dev)
    lib = SEGSUM_LIBRARY.load()
    tmp = torch.empty(lib.regtr_segment_transpose_scratch(
        rows, num_segments), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.regtr_segment_transpose(
            flat_ids.data_ptr(), int(flat_ids.dtype == torch.int64), rows,
            num_segments, seg_stride, starts.data_ptr(), perm.data_ptr(),
            tmp.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    SEGSUM_LIBRARY.check(err, "segment transpose")
    segment_transpose.launches += 1
    return SegmentTranspose(perm, starts)


segment_transpose.launches = 0


def padded_segment_sum_reference(g: torch.Tensor, flat_ids: torch.Tensor,
                                 num_segments: int, seg_stride: int
                                 ) -> torch.Tensor:
    """Plain version of the whole gather transpose: fp32 sums of the rows of
    g (R, C) by flat_ids (R,) into (num_segments, C), zero at pad-row
    segments (id % seg_stride == seg_stride - 1)."""
    out = torch.zeros((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, flat_ids, g.float())
    seg = torch.arange(num_segments, device=g.device)
    return out * (seg % seg_stride != seg_stride - 1)[:, None]


def segment_sum_reference(g: torch.Tensor, t: SegmentTranspose
                          ) -> torch.Tensor:
    """Plain version of the sum over a transpose: fp32 sums of the rows of
    g (R, C) listed for each segment, in their order -> (S, C)."""
    num_segments = t.starts.shape[0] - 1
    lengths = t.starts.diff().long()
    seg = torch.repeat_interleave(
        torch.arange(num_segments, device=g.device), lengths)
    out = torch.zeros((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    return out.index_add_(0, seg, g.float()[t.perm[:seg.shape[0]].long()])


def segment_sum(g: torch.Tensor, t: SegmentTranspose) -> torch.Tensor:
    """`segment_sum_reference`'s function by the segsum kernel on CUDA
    tensors: one warp per segment adds its rows in the transpose's order,
    so the sums are bitwise repeatable.  CPU tensors take the plain
    version.  g (R, C) fp32 or bf16 -> (S, C) fp32."""
    if g.device.type == "cpu":
        return segment_sum_reference(g, t)
    if g.device.type != "cuda":
        raise ValueError(f"no segment sum for device {g.device}")
    perm, starts = t
    if g.dim() != 2 or perm.shape != g.shape[:1]:
        raise ValueError(f"expected g (R, C) and perm (R,), got "
                         f"{tuple(g.shape)} and {tuple(perm.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cotangent dtype {g.dtype} not fp32/bf16")
    if (perm.dtype != torch.int32 or starts.dtype != torch.int32
            or perm.device != g.device or starts.device != g.device):
        raise ValueError("perm and starts must be int32 on the cotangent's "
                         "device")
    num_segments = starts.shape[0] - 1
    g, perm, starts = g.contiguous(), perm.contiguous(), starts.contiguous()
    out = torch.empty((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    with torch.cuda.device(g.device):
        err = SEGSUM_LIBRARY.load().regtr_segsum(
            g.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(),
            num_segments, g.shape[1], int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream(g.device).cuda_stream)
    SEGSUM_LIBRARY.check(err, "segment sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0


class GatherIndex:
    """A table of row indices `inds` (B, ...) in [0, n) into B clouds of n
    rows each, the last a pad (shadow) row, as the flat ids (int32) of one
    row gather over the (B * n, C) rows.  The gathers over one neighbor
    table share one GatherIndex, and with it the table's transpose (the pad
    rows dropped), built at the first backward that asks for it."""

    builds = 0      # transposes built, on any device (kernel or plain)

    def __init__(self, inds: torch.Tensor, n: int):
        b = inds.shape[0]
        if b * n >= INT32_MAX:
            raise ValueError(f"{b} clouds of {n} rows: flat ids are int32")
        offs = torch.arange(b, device=inds.device,
                            dtype=torch.int32)[:, None] * n
        self.inds, self.n = inds, n
        self.flat = (inds.reshape(b, -1).int() + offs).reshape(-1)
        self.num_segments = b * n
        self._transpose = None

    def transpose(self) -> SegmentTranspose:
        if self._transpose is None:
            self._transpose = segment_transpose(self.flat, self.num_segments,
                                                self.n)
            GatherIndex.builds += 1
        return self._transpose


def _transposed_sum(g, index: GatherIndex):
    return segment_sum(g, index.transpose())


def _unpadded_sum(g, index: GatherIndex):
    # a segment stride past the last segment drops no row
    return segment_sum(g, segment_transpose(
        index.flat, index.num_segments, index.num_segments + 1))


def _plain_sum(g, index: GatherIndex):
    return padded_segment_sum_reference(g, index.flat, index.num_segments,
                                        index.n)


class _RowGather(torch.autograd.Function):
    """Flat row gather (`row_gather`) by a GatherIndex whose backward is
    the fp32 gather transpose `segsum(g, index)`."""

    @staticmethod
    def forward(ctx, x, index, segsum):
        b, n, c = x.shape
        if index.num_segments != b * n:
            raise ValueError(f"index over {index.num_segments} rows for x "
                             f"{tuple(x.shape)}")
        ctx.shape, ctx.index, ctx.segsum = x.shape, index, segsum
        return row_gather(x.reshape(b * n, c).contiguous(),
                          index.flat).reshape(b, -1, c)

    @staticmethod
    def backward(ctx, g):
        b, n, c = ctx.shape
        dx = ctx.segsum(g.reshape(-1, c), ctx.index)
        return dx.to(g.dtype).reshape(b, n, c), None, None


def batched_row_gather(x: torch.Tensor, index: GatherIndex) -> torch.Tensor:
    """x (B, N, C), index over B clouds of N rows -> (B, R, C), one flat
    row gather.  The backward is the fp32 gather transpose (the transpose
    and segsum kernels on CUDA tensors) over every row, cast back to the
    cotangent's dtype."""
    return _RowGather.apply(x, index, _unpadded_sum)


def batched_row_gather_padded(x: torch.Tensor, index: GatherIndex
                              ) -> torch.Tensor:
    """`batched_row_gather` for operands whose LAST row per cloud is a pad
    (shadow) row whose gradient the caller discards: the backward drops the
    pad rows' cotangents, over the index's kept transpose."""
    return _RowGather.apply(x, index, _transposed_sum)


def batched_row_gather_padded_plain(x: torch.Tensor, index: GatherIndex
                                    ) -> torch.Tensor:
    """The same gather with the plain gather transpose on any device: what
    a kernel run is compared with."""
    return _RowGather.apply(x, index, _plain_sum)


def _pad_row(x: torch.Tensor, value: float) -> torch.Tensor:
    """Append the shadow row (index N) to each cloud of (B, N, C)."""
    pad = torch.full((x.shape[0], 1, x.shape[2]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def _neighbor_offsets(q_pts, s_pts, index: GatherIndex) -> torch.Tensor:
    """(B, Nq, K, 3) neighbor-minus-query offsets in fp32, the neighbors'
    coordinates by one row gather over the table of `index` (shadow rows
    at SHADOW_COORD).  Coordinates are data: no gradient flows to them."""
    b, nq, k = index.inds.shape
    neighbors = batched_row_gather(
        _pad_row(s_pts.to(torch.float32), SHADOW_COORD), index
    ).reshape(b, nq, k, 3)
    return (neighbors - q_pts.to(torch.float32)[:, :, None, :]).detach()


def _influence_from_rel(rel, neighb_inds, ns, kernel_pts, kp_extent,
                        influence="linear", aggregation="sum",
                        compute_dtype=None):
    """rel (B, Nq, K, 3) neighbor-minus-query offsets (fp32) ->
    (infl (B, Nq, K, P), inv_n_valid (B, Nq) fp32)."""
    p = kernel_pts.shape[0]
    if compute_dtype is not None:
        rel = rel.to(compute_dtype)
        kernel_pts = kernel_pts.to(compute_dtype)
    rel_sq = (rel * rel).sum(dim=-1)
    dots = rel @ kernel_pts.t()                                # (B,Nq,K,P)
    kp_sq = (kernel_pts * kernel_pts).sum(dim=-1)
    sq_d = (rel_sq[..., None] - 2.0 * dots + kp_sq).clamp_min(0.0)

    if influence == "linear":
        infl = (1.0 - torch.sqrt(sq_d) / kp_extent).clamp_min(0.0)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        infl = torch.exp(-sq_d / (2.0 * sigma * sigma + 1e-9))
    elif influence == "constant":
        infl = torch.ones_like(sq_d)
    else:
        raise ValueError(f"unknown influence {influence}")

    if aggregation == "closest":
        closest = sq_d.argmin(dim=-1)
        infl = infl * F.one_hot(closest, p).to(infl.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation {aggregation}")

    n_valid = (neighb_inds < ns).sum(dim=-1)
    inv_n_valid = 1.0 / n_valid.clamp_min(1).to(torch.float32)
    return infl, inv_n_valid


def _apply_from_gathered(infl, inv_n_valid, neighb_x, weights, compute_dtype,
                         norm: str = "valid"):
    """KPConv contraction given gathered neighbor features (B, Nq, K, C)."""
    b, nq, k, cin = neighb_x.shape
    p = infl.shape[-1]
    if norm == "legacy":
        # Reference quirk: count gathered rows whose channel sum is > 0.
        n = (neighb_x.to(torch.float32).sum(dim=-1) > 0.0).sum(dim=-1)
        inv_n_valid = 1.0 / n.clamp_min(1).to(torch.float32)
    elif norm != "valid":
        raise ValueError(f"unknown kpconv norm {norm}")
    if compute_dtype is not None:
        infl = infl.to(compute_dtype)
        neighb_x = neighb_x.to(compute_dtype)
        weights = weights.to(compute_dtype)
    weighted = torch.einsum("bqkp,bqkc->bqpc", infl.float(), neighb_x.float())
    out = weighted.reshape(b, nq, p * cin) @ weights.float().reshape(p * cin,
                                                                     -1)
    return out * inv_n_valid[..., None]


def kpconv_geometry(q_pts, s_pts, index: GatherIndex, kernel_pts,
                    kp_extent: float, influence: str = "linear",
                    aggregation: str = "sum", compute_dtype=None):
    """The neighborhood geometry that every KPConv block at one table
    shares: q_pts (B, Nq, 3), s_pts (B, Ns, 3), `index` the (B, Nq, K)
    table over Ns + 1 rows per cloud (shadow = Ns), kernel_pts (P, 3) ->
    (infl (B, Nq, K, P), inv_n_valid (B, Nq) fp32).  The coordinate
    gather is the row-gather kernel on CUDA tensors."""
    return _influence_from_rel(_neighbor_offsets(q_pts, s_pts, index),
                               index.inds, s_pts.shape[1], kernel_pts,
                               kp_extent, influence, aggregation,
                               compute_dtype)


def kpconv_apply(infl, inv_n_valid, index: GatherIndex, x, weights,
                 compute_dtype=None, norm: str = "valid"):
    """Feature path of KPConv given precomputed geometry -> (B, Nq, Cout).
    `index`: the neighbor table (B, Nq, K) over Ns + 1 rows per cloud."""
    b, ns, cin = x.shape
    neighb_inds = index.inds
    _, nq, k = neighb_inds.shape
    p = infl.shape[-1]

    if cin == 1:
        # Input features are a constant 1 per valid point, so the gather and
        # contraction reduce to a masked sum of influences.
        valid = (neighb_inds < ns).to(infl.dtype)
        weighted = torch.einsum("bqkp,bqk->bqp", infl.float(), valid.float())
        if compute_dtype is not None:
            weighted = weighted.to(compute_dtype)
            weights = weights.to(compute_dtype)
        out = weighted.float() @ weights.float().reshape(p, -1)
        return out * inv_n_valid[..., None]

    if compute_dtype is not None:
        x = x.to(compute_dtype)
    neighb_x = batched_row_gather_padded(_pad_row(x, 0.0), index).reshape(
        b, nq, k, cin)
    return _apply_from_gathered(infl, inv_n_valid, neighb_x, weights,
                                compute_dtype, norm)


def kpconv(q_pts, s_pts, index: GatherIndex, x, kernel_pts, weights,
           kp_extent: float, influence: str = "linear",
           aggregation: str = "sum", compute_dtype=None,
           norm: str = "valid"):
    """KPConv in two steps, `kpconv_geometry` then `kpconv_apply` ->
    (B, Nq, Cout).  The blocks take `kpconv_fused_gather`, which gathers
    a table's features once for the convolution and the shortcut."""
    infl, inv_n = kpconv_geometry(q_pts, s_pts, index, kernel_pts,
                                  kp_extent, influence, aggregation,
                                  compute_dtype)
    return kpconv_apply(infl, inv_n, index, x, weights, compute_dtype, norm)


def kpconv_fused_gather(q_pts, s_pts, index: GatherIndex, x, x_extra,
                        kernel_pts, weights, kp_extent: float,
                        influence: str = "linear", aggregation: str = "sum",
                        compute_dtype=None, norm: str = "valid"):
    """KPConv that computes its own geometry from the gathered neighbors.

    index: the neighbor table (B, Nq, K) over Ns + 1 rows per cloud, shared
    by the feature and coordinate gathers; x: (B, Ns, Cin) conv features;
    x_extra: optional (B, Ns, Ce) features max-pooled over the same table
    (the strided resnet shortcut).

    Returns (conv_out (B, Nq, Cout), maxpool_out (B, Nq, Ce) or None,
             (infl, inv_n_valid) for reuse by later blocks at this level).
    """
    b, nq, k = index.inds.shape
    cin = x.shape[-1]
    gdtype = compute_dtype if compute_dtype is not None else x.dtype

    feats = x.to(gdtype)
    if x_extra is not None:
        feats = torch.cat([feats, x_extra.to(gdtype)], dim=-1)
    g = batched_row_gather_padded(_pad_row(feats, 0.0), index)
    g = g.reshape(b, nq, k, feats.shape[-1])
    infl, inv_n = kpconv_geometry(q_pts, s_pts, index, kernel_pts,
                                  kp_extent, influence, aggregation,
                                  compute_dtype)
    out = _apply_from_gathered(infl, inv_n, g[..., :cin], weights,
                               compute_dtype, norm)
    # Shadow rows gathered zeros, matching max_pool's zero pad row.
    pooled = None if x_extra is None else g[..., cin:].amax(dim=2)
    return out, pooled, (infl, inv_n)


def max_pool(x, index: GatherIndex, compute_dtype=None):
    """Max-pool (B, Ns, C) over the (B, Nq, K) table of `index` (shadow =
    Ns, a zero row)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    b, ns, c = x.shape
    _, nq, k = index.inds.shape
    gathered = batched_row_gather_padded(_pad_row(x, 0.0), index)
    return gathered.reshape(b, nq, k, c).amax(dim=2)


class _MaxZero(torch.autograd.Function):
    """max(x, 0) with the gradient of `jnp.maximum(x, 0.0)`: the cotangent
    times 1 above 0, 0.5 at 0 and 0 below, as a product, so that an
    infinite cotangent (sqrt's at 0) gives NaN below 0 and inf at 0, as in
    JAX (torch.maximum's backward fills 0 below instead)."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clamp_min(0.0)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        ones = torch.ones_like(g)
        return g * torch.where(x > 0, ones, torch.where(x == 0, 0.5 * ones,
                                                        0.0 * ones))


def kpconv_deformable(q_pts, s_pts, index: GatherIndex, x, kernel_pts,
                      weights, offset_weights, offset_bias, kp_extent: float,
                      influence: str = "linear", aggregation: str = "sum",
                      modulated: bool = False, compute_dtype=None,
                      norm: str = "valid"):
    """Deformable (optionally modulated) KPConv -> (B, Nq, Cout).

    A rigid KPConv over the same table (`kpconv_fused_gather` with
    `offset_weights` (P, Cin, 3P [+P]) plus `offset_bias`) predicts each
    query's kernel-point offsets, in units of the extent, and with
    `modulated` a gain 2 * sigmoid(.) per kernel point; the convolution
    then measures its neighbors against the deformed kernel points.  The
    neighbors' coordinates come by `batched_row_gather` and carry no
    gradient; the offsets' gradient flows through the deformed points'
    dot products and squared norms, with JAX's gradients of max and sqrt
    at 0 (`_MaxZero`).  The features come by `batched_row_gather_padded`.
    """
    b, ns, _ = s_pts.shape
    neighb_inds = index.inds
    _, nq, k = neighb_inds.shape
    p = kernel_pts.shape[0]

    off, _, _ = kpconv_fused_gather(
        q_pts, s_pts, index, x, None, kernel_pts, offset_weights, kp_extent,
        influence, aggregation, compute_dtype=compute_dtype, norm=norm)
    off = off + offset_bias
    offsets = off[..., :3 * p].reshape(b, nq, p, 3).float() * kp_extent
    modulations = 2.0 * torch.sigmoid(off[..., 3 * p:]) if modulated else None
    deformed_kp = kernel_pts.float() + offsets                # (B,Nq,P,3)

    rel = _neighbor_offsets(q_pts, s_pts, index)
    if compute_dtype is not None:
        rel = rel.to(compute_dtype)
        deformed_kp = deformed_kp.to(compute_dtype)
    rel_sq = (rel * rel).sum(dim=-1)                           # (B,Nq,K)
    dots = rel @ deformed_kp.transpose(-1, -2)                 # (B,Nq,K,P)
    kp_sq = (deformed_kp * deformed_kp).sum(dim=-1)            # (B,Nq,P)
    sq_d = _MaxZero.apply(rel_sq[..., None] - 2.0 * dots
                          + kp_sq[:, :, None, :])
    if influence == "linear":
        infl = _MaxZero.apply(1.0 - torch.sqrt(sq_d) / kp_extent)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        infl = torch.exp(-sq_d / (2.0 * sigma * sigma + 1e-9))
    elif influence == "constant":
        infl = torch.ones_like(sq_d)
    else:
        raise ValueError(f"unknown influence {influence}")
    if aggregation == "closest":
        infl = infl * F.one_hot(sq_d.argmin(dim=-1), p).to(infl.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation {aggregation}")

    inv_n = 1.0 / (neighb_inds < ns).sum(dim=-1).clamp_min(1).to(
        torch.float32)
    cin = x.shape[-1]
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    neighb_x = batched_row_gather_padded(_pad_row(x, 0.0), index).reshape(
        b, nq, k, cin)
    if norm == "legacy":
        n = (neighb_x.to(torch.float32).sum(dim=-1) > 0.0).sum(dim=-1)
        inv_n = 1.0 / n.clamp_min(1).to(torch.float32)
    elif norm != "valid":
        raise ValueError(f"unknown kpconv norm {norm}")
    if compute_dtype is not None:
        infl = infl.to(compute_dtype)
        weights = weights.to(compute_dtype)
    weighted = torch.einsum("bqkp,bqkc->bqpc", infl.float(), neighb_x.float())
    if modulations is not None:
        weighted = weighted * modulations[..., None]
    out = weighted.reshape(b, nq, p * cin) @ weights.float().reshape(p * cin,
                                                                     -1)
    return out * inv_n[..., None]


def closest_pool(x, inds):
    """Features of each query's first (nearest) neighbor: x (B, Ns, C),
    inds (B, Nq, K) with shadow = Ns (a zero row) -> (B, Nq, C)."""
    index = GatherIndex(inds[:, :, 0], x.shape[1] + 1)
    return batched_row_gather_padded(_pad_row(x, 0.0), index)


def global_average(x, mask):
    """Masked mean over the points: (B, N, C), (B, N) -> (B, C)."""
    m = mask[..., None].to(x.dtype)
    return (x * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
