"""Deterministic voxel-grid barycenter subsampling (counterpart of
regtr_tpu/ops/subsample.py), batched over a leading cloud axis.

Semantics match the JAX version exactly:
  * grid origin  = floor(min_valid_point / dl) * dl
  * voxel key    = int32, 10 bits per axis, INT32_MAX for masked points
  * output       = per-voxel barycenter, ordered by key, fixed capacity
                   (voxels beyond it dropped) plus a validity mask.

Determinism: the per-voxel sums run over the key-sorted points with
`torch.segment_reduce`, one sequential sum per segment, so the same input
gives a bitwise-same result on every run.  A scatter-add (`index_add_`)
would add with atomics on CUDA, in an order that changes from run to run.
"""
from __future__ import annotations

import torch

_AXIS_BITS = 10
_AXIS_MAX = (1 << _AXIS_BITS) - 1
SENTINEL = 2 ** 31 - 1


def _full_like_scalar(value: float, ref: torch.Tensor) -> torch.Tensor:
    # A 0-dim tensor on ref's device, not a Python scalar: CUDA divides by a
    # host scalar as a multiplication by its reciprocal, which rounds
    # differently from the true division the JAX version does.
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def voxel_keys(points: torch.Tensor, mask: torch.Tensor,
               voxel_size: float) -> torch.Tensor:
    """(B, N, 3), (B, N) bool -> (B, N) int32 voxel keys."""
    vs = _full_like_scalar(voxel_size, points)
    masked = torch.where(mask[..., None], points,
                         _full_like_scalar(1e9, points))
    min_corner = masked.amin(dim=-2, keepdim=True)
    origin = torch.floor(min_corner / vs) * vs
    ijk = torch.floor((points - origin) / vs).to(torch.int32)
    ijk = ijk.clamp(0, _AXIS_MAX)
    key = (ijk[..., 0] | (ijk[..., 1] << _AXIS_BITS)
           | (ijk[..., 2] << (2 * _AXIS_BITS)))
    return torch.where(mask, key, torch.full_like(key, SENTINEL))


def grid_subsample(points: torch.Tensor, mask: torch.Tensor,
                   voxel_size: float, capacity: int):
    """Voxel-grid barycenter subsample of a batch of masked clouds.

    points (B, N, 3), mask (B, N) ->
    (sub_points (B, capacity, 3), sub_mask (B, capacity), num_voxels (B,))
    """
    b, n, _ = points.shape
    key = voxel_keys(points, mask, voxel_size)
    order = torch.argsort(key, dim=1, stable=True)
    key_s = key.gather(1, order)
    pts_s = points.gather(1, order[..., None].expand(-1, -1, 3))
    valid_s = key_s != SENTINEL

    first = torch.ones_like(valid_s)
    first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    voxel_id = (first & valid_s).to(torch.int64).cumsum(dim=1) - 1
    num_voxels = (voxel_id[:, -1] + 1).clamp_min(0) * valid_s.any(dim=1)

    # Slot of each sorted point: its voxel, or `capacity` for masked points
    # and voxels beyond capacity.  Non-decreasing along each row, so each
    # slot is one contiguous run, found by a binary search.
    slot = torch.where(valid_s, voxel_id, capacity).clamp_max(capacity)
    starts = torch.searchsorted(
        slot, torch.arange(capacity + 1, device=points.device)
        .expand(b, -1).contiguous())
    ends = torch.cat(
        [starts[:, 1:], torch.full((b, 1), n, device=points.device,
                                   dtype=starts.dtype)], dim=1)
    lengths = ends - starts                                  # (B, cap+1)
    sums = torch.segment_reduce(pts_s, "sum", lengths=lengths, axis=1)
    counts = lengths[:, :capacity].to(points.dtype)
    sub_points = sums[:, :capacity] / counts.clamp_min(1.0)[..., None]
    return sub_points, counts > 0, num_voxels.clamp_max(n)
