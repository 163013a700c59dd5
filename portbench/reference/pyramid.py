"""The plain reference's input pyramid: spatial sort, voxel-grid barycenter
subsampling and the brute radius-neighbor search, in plain PyTorch.

A frozen copy of the semantics the measured package states for its
pyramid (a sort by voxel key, barycenters ordered by key at a fixed
capacity, the k nearest supports within the radius chosen on the bf16
rounding of the expanded fp32 distance, ties lowest support id first),
written out once here so that later changes to the package cannot move
the yardstick.  Every tensor is computed again from the points alone.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

_AXIS_BITS = 10
_AXIS_MAX = (1 << _AXIS_BITS) - 1
SENTINEL = 2 ** 31 - 1


@dataclasses.dataclass(frozen=True)
class Spec:
    radii: tuple
    voxel_sizes: tuple
    capacities: tuple
    ks: tuple


@dataclasses.dataclass
class Level:
    points: torch.Tensor                       # (B, N_l, 3)
    mask: torch.Tensor                         # (B, N_l) bool
    neighbors: torch.Tensor                    # (B, N_l, K_l); shadow = N_l
    pools: Optional[torch.Tensor] = None       # (B, N_{l+1}, K_l)
    perm: Optional[torch.Tensor] = None        # (B, N_0) input -> sorted


def num_levels(architecture) -> int:
    return 1 + sum(1 for b in architecture if "pool" in b or "strided" in b)


def make_spec(cfg, n0: int) -> Spec:
    """The static schedule of levels: radii, voxel sizes, capacities (each
    the previous times capacity_factor, rounded up to 8) and neighbor
    limits."""
    levels = num_levels(cfg["architecture"])
    dl = float(cfg["first_subsampling_dl"])
    r = dl * float(cfg["conv_radius"])
    radii, voxels = [], [dl]
    for _ in range(levels):
        radii.append(r)
        voxels.append(2.0 * r / float(cfg["conv_radius"]))
        r *= 2.0
    caps = [n0]
    for _ in range(levels - 1):
        caps.append(max(16, int(-(-caps[-1] * float(cfg["capacity_factor"])
                                  // 1))))
    caps = [((c + 7) // 8) * 8 for c in caps]
    caps[0] = n0
    ks = list(cfg["neighborhood_limits"])
    ks += [ks[-1]] * (levels - len(ks))
    return Spec(tuple(radii), tuple(voxels[:levels]), tuple(caps),
                tuple(int(k) for k in ks[:levels]))


def _scalar(value: float, ref: torch.Tensor) -> torch.Tensor:
    # a device tensor: a true division, not a product with a reciprocal
    return torch.full((), value, dtype=ref.dtype, device=ref.device)


def voxel_keys(points, mask, voxel):
    vs = _scalar(voxel, points)
    masked = torch.where(mask[..., None], points, _scalar(1e9, points))
    origin = torch.floor(masked.amin(dim=-2, keepdim=True) / vs) * vs
    ijk = torch.floor((points - origin) / vs).to(torch.int32)
    ijk = ijk.clamp(0, _AXIS_MAX)
    key = (ijk[..., 0] | (ijk[..., 1] << _AXIS_BITS)
           | (ijk[..., 2] << (2 * _AXIS_BITS)))
    return torch.where(mask, key, torch.full_like(key, SENTINEL))


def subsample(points, mask, voxel, capacity):
    """Per-voxel barycenters ordered by key, `capacity` slots: (points,
    mask).  Each voxel's sum runs over its points in sorted order."""
    b, n, _ = points.shape
    key = voxel_keys(points, mask, voxel)
    order = torch.argsort(key, dim=1, stable=True)
    key_s = key.gather(1, order)
    pts_s = points.gather(1, order[..., None].expand(-1, -1, 3))
    valid = key_s != SENTINEL
    first = torch.ones_like(valid)
    first[:, 1:] = key_s[:, 1:] != key_s[:, :-1]
    voxel_id = (first & valid).long().cumsum(dim=1) - 1
    slot = torch.where(valid, voxel_id, capacity).clamp_max(capacity)
    starts = torch.searchsorted(
        slot, torch.arange(capacity + 1, device=points.device)
        .expand(b, -1).contiguous())
    ends = torch.cat([starts[:, 1:], torch.full(
        (b, 1), n, device=points.device, dtype=starts.dtype)], dim=1)
    lengths = ends - starts
    sums = torch.segment_reduce(pts_s, "sum", lengths=lengths, axis=1)
    counts = lengths[:, :capacity].to(points.dtype)
    return sums[:, :capacity] / counts.clamp_min(1.0)[..., None], counts > 0


def _sq3(x, y, z):
    return (x * x + y * y) + z * z


def _sortable(key):
    bits = key.view(torch.int32)
    return (bits ^ ((bits >> 31) & 0x7FFFFFFF)).long()


def radius_neighbors(queries, q_mask, supports, s_mask, radius, k,
                     chunk: int = 1024):
    """(B, Nq, k) int64 ids of the k nearest valid supports within the
    radius, nearest first, shadow entries = Ns.  Distances by the
    expansion (|q|^2 - 2 q.s) + |s|^2, each sum elementwise in a fixed
    order; the selection key is the bf16 rounding of the fp32 distance
    (the fp32 value when Ns < 4k), equal keys lowest id first, kept where
    key <= r^2 * 1.004."""
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    sx, sy, sz = supports.unbind(-1)
    s_sq = torch.where(s_mask, _sq3(sx, sy, sz), 1e13)[:, None, :]
    s_far = torch.where(s_mask[..., None], supports, 1e6)
    sx, sy, sz = (c[:, None, :] for c in s_far.unbind(-1))
    ids = torch.arange(ns, dtype=torch.int64, device=queries.device)
    r_sq = torch.full((), radius * radius, dtype=torch.float32,
                      device=queries.device)
    k_eff = min(k, ns)
    exact = ns < 4 * k
    out = torch.full((b, nq, k), ns, dtype=torch.int64,
                     device=queries.device)
    for q0 in range(0, nq, chunk):
        qx, qy, qz = (c[..., None] for c in
                      queries[:, q0:q0 + chunk].unbind(-1))
        d = (_sq3(qx, qy, qz) - 2.0 * ((qx * sx + qy * sy) + qz * sz)) + s_sq
        key = d if exact else d.to(torch.bfloat16).to(torch.float32)
        words = torch.topk((_sortable(key) << 32) | ids, k_eff, dim=-1,
                           largest=False).values
        idx = words & 0xFFFFFFFF
        vals = _sortable((words >> 32).int()).int().view(torch.float32)
        ok = (vals <= r_sq * 1.004) & q_mask[:, q0:q0 + chunk, None]
        out[:, q0:q0 + chunk, :k_eff] = torch.where(ok, idx, ns)
    return out


def pairs_within(queries, q_mask, supports, s_mask, radius,
                 chunk: int = 1024) -> int:
    """How many (valid query, valid support) pairs lie within the radius,
    by the true fp32 distance: the work a radius search needs."""
    total = 0
    r_sq = radius * radius
    for q0 in range(0, queries.shape[1], chunk):
        d = torch.cdist(queries[:, q0:q0 + chunk], supports) ** 2
        ok = ((d <= r_sq) & q_mask[:, q0:q0 + chunk, None]
              & s_mask[:, None, :])
        total += int(ok.sum())
    return total


def build(points, mask, spec: Spec, chunk: int = 1024) -> List[Level]:
    """The pyramid: level 0 sorted by voxel key (`perm` kept), then per
    level its neighbor table, and below each but the last the subsampled
    level and the pool table into it."""
    perm = torch.argsort(voxel_keys(points, mask, spec.voxel_sizes[0]),
                         dim=1, stable=True)
    pts = points.gather(1, perm[..., None].expand(-1, -1, 3))
    msk = mask.gather(1, perm)
    levels = []
    for li, (r, k) in enumerate(zip(spec.radii, spec.ks)):
        level = Level(pts, msk, radius_neighbors(pts, msk, pts, msk, r, k,
                                                 chunk),
                      perm=perm if li == 0 else None)
        if li + 1 < len(spec.radii):
            nxt, nmask = subsample(pts, msk, spec.voxel_sizes[li + 1],
                                   spec.capacities[li + 1])
            level.pools = radius_neighbors(nxt, nmask, pts, msk, r, k, chunk)
            pts, msk = nxt, nmask
        levels.append(level)
    return levels


def overlap_pyramid(overlap0, levels: List[Level]) -> List[torch.Tensor]:
    """Per-point overlap labels carried down: a point's label is the mean
    of its valid pool neighbors' labels, clamped to [0, 1], 0 where
    masked."""
    out = [overlap0]
    cur = overlap0
    for li in range(len(levels) - 1):
        pools = levels[li].pools
        valid = pools < levels[li].points.shape[1]
        got = cur.gather(1, torch.where(valid, pools, 0).flatten(1))
        got = torch.where(valid, got.view(pools.shape), 0.0)
        nxt = torch.clamp(got.sum(-1) / valid.sum(-1).clamp_min(1).to(
            cur.dtype), 0.0, 1.0)
        cur = torch.where(levels[li + 1].mask, nxt, 0.0)
        out.append(cur)
    return out
