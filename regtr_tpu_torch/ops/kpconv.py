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
csrc/gather.cu, on a CPU tensor it runs `index_select`.  Its backward is the
gather transpose: an fp32 segment sum of the cotangent rows by flat index.
On a CUDA tensor it launches csrc/segsum.cu (`sorted_padded_segment_sum`,
counted in its `.launches`), on a CPU tensor it runs the plain version
(`padded_segment_sum_reference`).  Every feature gather goes through
`batched_row_gather_padded`, whose backward drops the rows of each cloud's
pad (shadow) row; `batched_row_gather` drops none.  The segment-sum kernel
adds in a fixed order, so the backward is bitwise repeatable; `index_add_`
on CUDA adds with atomics in a run-dependent order.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .cuda_build import CudaLibrary
from .gather import row_gather

SHADOW_COORD = 1e6


def _declare_segsum(lib):
    lib.regtr_segsum.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_void_p])
    lib.regtr_segsum.restype = ctypes.c_int


SEGSUM_LIBRARY = CudaLibrary("segsum.cu", _declare_segsum)


def padded_segment_sum_reference(g: torch.Tensor, flat_ids: torch.Tensor,
                                 num_segments: int, seg_stride: int
                                 ) -> torch.Tensor:
    """Plain version: fp32 sums of the rows of g (R, C) by flat_ids (R,)
    into (num_segments, C), zero at pad-row segments
    (id % seg_stride == seg_stride - 1)."""
    out = torch.zeros((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    out.index_add_(0, flat_ids, g.float())
    seg = torch.arange(num_segments, device=g.device)
    return out * (seg % seg_stride != seg_stride - 1)[:, None]


def sorted_padded_segment_sum(g: torch.Tensor, flat_ids: torch.Tensor,
                              num_segments: int, seg_stride: int
                              ) -> torch.Tensor:
    """`padded_segment_sum_reference`'s function by the segsum kernel on
    CUDA tensors: a stable sort of the ids and each segment's start in it
    (PyTorch, as the JAX package sorts outside its kernel), then one warp
    per segment adds its rows in sorted order.  CPU tensors take the plain
    version.  Returns (num_segments, C) fp32."""
    if g.device.type == "cpu":
        return padded_segment_sum_reference(g, flat_ids, num_segments,
                                            seg_stride)
    if g.device.type != "cuda":
        raise ValueError(f"no segment sum for device {g.device}")
    if g.dim() != 2 or flat_ids.shape != g.shape[:1]:
        raise ValueError(f"expected g (R, C) and ids (R,), got "
                         f"{tuple(g.shape)} and {tuple(flat_ids.shape)}")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cotangent dtype {g.dtype} not fp32/bf16")
    if flat_ids.dtype != torch.int64 or flat_ids.device != g.device:
        raise ValueError("ids must be int64 on the cotangent's device")
    if num_segments < 1 or seg_stride < 1:
        raise ValueError(f"num_segments {num_segments}, seg_stride "
                         f"{seg_stride}")
    g = g.contiguous()
    sorted_ids, perm = torch.sort(flat_ids, stable=True)
    starts = torch.searchsorted(
        sorted_ids, torch.arange(num_segments + 1, device=g.device))
    out = torch.empty((num_segments, g.shape[1]), dtype=torch.float32,
                      device=g.device)
    with torch.cuda.device(g.device):
        err = SEGSUM_LIBRARY.load().regtr_segsum(
            g.data_ptr(), perm.data_ptr(), starts.data_ptr(), out.data_ptr(),
            num_segments, g.shape[1], seg_stride,
            int(g.dtype == torch.bfloat16),
            torch.cuda.current_stream(g.device).cuda_stream)
    SEGSUM_LIBRARY.check(err, "segment sum")
    sorted_padded_segment_sum.launches += 1
    return out


sorted_padded_segment_sum.launches = 0


class _RowGather(torch.autograd.Function):
    """Flat row gather (`row_gather`) whose backward is the fp32 gather
    transpose `segsum`; with `padded`, the cotangents of each cloud's last
    (pad) row are dropped."""

    @staticmethod
    def forward(ctx, x, inds, segsum, padded):
        b, n, c = x.shape
        offs = torch.arange(b, device=inds.device, dtype=inds.dtype)[:, None]
        flat = (inds + offs * n).reshape(-1)
        ctx.save_for_backward(flat)
        ctx.shape, ctx.segsum, ctx.padded = x.shape, segsum, padded
        return row_gather(x.reshape(b * n, c).contiguous(),
                          flat).reshape(b, -1, c)

    @staticmethod
    def backward(ctx, g):
        (flat,) = ctx.saved_tensors
        b, n, c = ctx.shape
        # A segment stride past the last segment drops no row.
        stride = n if ctx.padded else b * n + 1
        dx = ctx.segsum(g.reshape(-1, c), flat, b * n, stride)
        return dx.to(g.dtype).reshape(b, n, c), None, None, None


def batched_row_gather(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), inds (B, R) in [0, N) -> (B, R, C), one flat row gather.
    The backward is the fp32 gather transpose (the segsum kernel on CUDA
    tensors) over every row, cast back to the cotangent's dtype."""
    return _RowGather.apply(x, inds, sorted_padded_segment_sum, False)


def batched_row_gather_padded(x: torch.Tensor, inds: torch.Tensor
                              ) -> torch.Tensor:
    """`batched_row_gather` for operands whose LAST row per cloud is a pad
    (shadow) row whose gradient the caller discards: the backward drops the
    pad rows' cotangents."""
    return _RowGather.apply(x, inds, sorted_padded_segment_sum, True)


def batched_row_gather_padded_plain(x: torch.Tensor, inds: torch.Tensor
                                    ) -> torch.Tensor:
    """The same gather with the plain gather transpose on any device: what
    a kernel run is compared with."""
    return _RowGather.apply(x, inds, padded_segment_sum_reference, True)


def _pad_row(x: torch.Tensor, value: float) -> torch.Tensor:
    """Append the shadow row (index N) to each cloud of (B, N, C)."""
    pad = torch.full((x.shape[0], 1, x.shape[2]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


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


def kpconv_apply(infl, inv_n_valid, neighb_inds, x, weights,
                 compute_dtype=None, norm: str = "valid"):
    """Feature path of KPConv given precomputed geometry -> (B, Nq, Cout)."""
    b, ns, cin = x.shape
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
    neighb_x = batched_row_gather_padded(
        _pad_row(x, 0.0), neighb_inds.reshape(b, nq * k)
    ).reshape(b, nq, k, cin)
    return _apply_from_gathered(infl, inv_n_valid, neighb_x, weights,
                                compute_dtype, norm)


def kpconv_fused_gather(q_pts, s_pts, neighb_inds, x, x_extra, kernel_pts,
                        weights, kp_extent: float, influence: str = "linear",
                        aggregation: str = "sum", compute_dtype=None,
                        norm: str = "valid"):
    """KPConv that computes its own geometry from the gathered neighbors.

    x: (B, Ns, Cin) conv features; x_extra: optional (B, Ns, Ce) features
    max-pooled over the same table (the strided resnet shortcut).

    Returns (conv_out (B, Nq, Cout), maxpool_out (B, Nq, Ce) or None,
             (infl, inv_n_valid) for reuse by later blocks at this level).
    """
    b, ns, _ = s_pts.shape
    _, nq, k = neighb_inds.shape
    cin = x.shape[-1]
    gdtype = compute_dtype if compute_dtype is not None else x.dtype

    feats = x.to(gdtype)
    if x_extra is not None:
        feats = torch.cat([feats, x_extra.to(gdtype)], dim=-1)
    flat_inds = neighb_inds.reshape(b, nq * k)
    g = batched_row_gather_padded(_pad_row(feats, 0.0), flat_inds)
    g = g.reshape(b, nq, k, feats.shape[-1])
    neighbors = batched_row_gather(
        _pad_row(s_pts.to(torch.float32), SHADOW_COORD), flat_inds
    ).reshape(b, nq, k, 3)

    rel = neighbors - q_pts.to(torch.float32)[:, :, None, :]
    infl, inv_n = _influence_from_rel(rel, neighb_inds, ns, kernel_pts,
                                      kp_extent, influence, aggregation,
                                      compute_dtype)
    out = _apply_from_gathered(infl, inv_n, g[..., :cin], weights,
                               compute_dtype, norm)
    # Shadow rows gathered zeros, matching max_pool's zero pad row.
    pooled = None if x_extra is None else g[..., cin:].amax(dim=2)
    return out, pooled, (infl, inv_n)


def max_pool(x, pool_inds, compute_dtype=None):
    """Max-pool (B, Ns, C) over (B, Nq, K) tables (shadow = Ns, a zero row)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    b, ns, c = x.shape
    _, nq, k = pool_inds.shape
    gathered = batched_row_gather_padded(_pad_row(x, 0.0),
                                         pool_inds.reshape(b, nq * k))
    return gathered.reshape(b, nq, k, c).amax(dim=2)
