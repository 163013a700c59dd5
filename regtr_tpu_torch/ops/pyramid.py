"""KPConv pyramid preprocessing (counterpart of regtr_tpu/ops/pyramid.py).

Walks the architecture once: at each level, a radius-neighbor table among
the level's points; on a stride, the voxel-subsampled next level, the pool
table (next-level queries into this level) and the upsample table (this
level's queries into the next, at twice the radius).  Every array has a
leading cloud axis, a fixed capacity per level and a validity mask.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import torch

from .neighbors import brute_radius_neighbors
from .subsample import grid_subsample, voxel_keys


@dataclasses.dataclass(frozen=True)
class PyramidSpec:
    """Static shape/radius schedule, one entry per pyramid level."""
    radii: tuple
    voxel_sizes: tuple      # dl that produces each level (level 0: base dl)
    capacities: tuple
    neighbor_ks: tuple

    @property
    def num_levels(self) -> int:
        return len(self.radii)


def count_pyramid_levels(architecture: Sequence[str]) -> int:
    levels = 1
    for block in architecture:
        if "global" in block or "upsample" in block:
            break
        if "pool" in block or "strided" in block:
            levels += 1
    return levels


def make_pyramid_spec(cfg, n0_capacity: int) -> PyramidSpec:
    """Static pyramid schedule from a flat config (same rules as JAX)."""
    num_levels = count_pyramid_levels(cfg["architecture"])
    r = float(cfg["first_subsampling_dl"]) * float(cfg["conv_radius"])
    radii, voxels = [], [float(cfg["first_subsampling_dl"])]
    for _ in range(num_levels):
        radii.append(r)
        voxels.append(2.0 * r / float(cfg["conv_radius"]))
        r *= 2.0
    voxels = voxels[:num_levels]

    if cfg.get("level_capacities"):
        caps = list(cfg["level_capacities"])
        if len(caps) != num_levels:
            raise ValueError(
                f"level_capacities has {len(caps)} entries, need {num_levels}"
            )
        caps[0] = n0_capacity
    else:
        factor = float(cfg.get("capacity_factor", 0.5))
        caps = [n0_capacity]
        for _ in range(num_levels - 1):
            caps.append(max(16, int(-(-caps[-1] * factor // 1))))
    caps = [((c + 7) // 8) * 8 for c in caps]
    caps[0] = n0_capacity

    limits = list(cfg["neighborhood_limits"])
    if len(limits) < num_levels:
        limits = limits + [limits[-1]] * (num_levels - len(limits))

    return PyramidSpec(
        radii=tuple(radii),
        voxel_sizes=tuple(voxels),
        capacities=tuple(caps),
        neighbor_ks=tuple(int(k) for k in limits[:num_levels]),
    )


@dataclasses.dataclass
class PyramidLevel:
    points: torch.Tensor                       # (B, N_l, 3)
    mask: torch.Tensor                         # (B, N_l) bool
    neighbors: torch.Tensor                    # (B, N_l, K_l); shadow = N_l
    pools: Optional[torch.Tensor] = None       # (B, N_{l+1}, K_l); shadow N_l
    upsamples: Optional[torch.Tensor] = None   # (B, N_l, K_l); shadow N_{l+1}
    perm: Optional[torch.Tensor] = None        # (B, N_0) input->sorted order


def spatial_sort(points: torch.Tensor, mask: torch.Tensor, voxel_size: float):
    """Sort each cloud by voxel key (stable); masked points sort last."""
    perm = torch.argsort(voxel_keys(points, mask, voxel_size), dim=1,
                         stable=True)
    pts = points.gather(1, perm[..., None].expand(-1, -1, 3))
    return pts, mask.gather(1, perm), perm


def build_pyramid(points: torch.Tensor, mask: torch.Tensor,
                  spec: PyramidSpec, sort_input: bool = True
                  ) -> List[PyramidLevel]:
    """Full multi-level pyramid.  points (B, N0, 3), mask (B, N0).

    With sort_input, level 0 is spatially sorted first and the permutation
    is kept on level 0 as `perm`.
    """
    perm = None
    if sort_input:
        points, mask, perm = spatial_sort(points, mask, spec.voxel_sizes[0])
    levels: List[PyramidLevel] = []
    cur_pts, cur_mask = points, mask
    for li in range(spec.num_levels):
        r, k = spec.radii[li], spec.neighbor_ks[li]
        level = PyramidLevel(
            points=cur_pts, mask=cur_mask,
            neighbors=brute_radius_neighbors(cur_pts, cur_mask, cur_pts,
                                             cur_mask, r, k),
            perm=perm if li == 0 else None,
        )
        if li + 1 < spec.num_levels:
            nxt_pts, nxt_mask, _ = grid_subsample(
                cur_pts, cur_mask, spec.voxel_sizes[li + 1],
                spec.capacities[li + 1])
            level.pools = brute_radius_neighbors(
                nxt_pts, nxt_mask, cur_pts, cur_mask, r, k)
            level.upsamples = brute_radius_neighbors(
                cur_pts, cur_mask, nxt_pts, nxt_mask, 2.0 * r, k)
            cur_pts, cur_mask = nxt_pts, nxt_mask
        levels.append(level)
    return levels
