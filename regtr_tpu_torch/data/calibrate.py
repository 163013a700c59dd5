"""Offline calibration of the static shape schedule (the port's counterpart
of regtr_tpu/data/calibrate.py; a CPU test holds the results equal).

Over the first dataset samples, both clouds, level by level of the voxel
pyramid:
  * neighborhood_limits: per-level K covering keep_ratio of all neighbors;
  * level_capacities: the most points a level held, times a safety factor;
  * cell_capacity: the most points in one grid cell of the level's search
    radius, times the safety factor.

The JAX version counts on the host through the native C++ library; this
one counts on the device it is given, with that library's semantics so
that the result is the same: exact neighborhoods (fp32 squared distances
`dx*dx + dy*dy + dz*dz` against the fp32 square of the fp32 radius, each
count capped at HIST_MAX - 1), and each next level the voxel barycenters
of the last (origin floor(min / cell) * cell, sums in float64 in the
points' order, then rounded to fp32).  This is not the pyramid's selection
(bf16 roundings against r^2 * 1.004): calibration counts whole
neighborhoods.  (Built with -march=native, the C++ library may contract
the distance into fused multiply-adds, so a distance within one rounding
of the radius may count differently there.)
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..ops.pyramid import count_pyramid_levels
from ..ops.subsample import _full_like_scalar

_logger = logging.getLogger(__name__)

HIST_MAX = 512
# Query rows per distance chunk: 2048 rows against a 30 000-point cloud are
# ~0.25 GB per fp32 temporary.
QUERY_CHUNK = 2048


def neighbor_counts(pts: torch.Tensor, radius: float) -> torch.Tensor:
    """(N,) int64: the points of `pts` within `radius` of each point (itself
    included), capped at HIST_MAX - 1."""
    r = _full_like_scalar(radius, pts)
    r2 = r * r
    out = []
    for start in range(0, len(pts), QUERY_CHUNK):
        q = pts[start:start + QUERY_CHUNK]
        dx = q[:, None, 0] - pts[None, :, 0]
        dy = q[:, None, 1] - pts[None, :, 1]
        dz = q[:, None, 2] - pts[None, :, 2]
        d2 = dx * dx + dy * dy + dz * dz
        out.append((d2 <= r2).sum(dim=1))
    return torch.cat(out).clamp_max(HIST_MAX - 1)


def grid_subsample(pts: torch.Tensor, cell: float) -> torch.Tensor:
    """(N, 3) fp32 -> (M, 3) fp32 voxel barycenters (in no set order)."""
    c = _full_like_scalar(cell, pts)
    origin = torch.floor(pts.amin(dim=0) / c) * c
    ijk = torch.floor((pts - origin) / c).to(torch.int64)
    _, voxel = torch.unique(ijk, dim=0, return_inverse=True)
    # each voxel's points in their order, summed one after another
    order = torch.argsort(voxel, stable=True)
    lengths = torch.bincount(voxel)
    sums = torch.segment_reduce(pts[order].double(), "sum", lengths=lengths,
                                axis=0)
    return (sums / lengths[:, None].double()).float()


def max_cell_count(pts: torch.Tensor, radius: float) -> int:
    """The most points in one cell of the grid of side `radius`."""
    cells = torch.floor(pts / _full_like_scalar(radius, pts)).to(torch.int64)
    _, counts = torch.unique(cells, dim=0, return_counts=True)
    return int(counts.max())


def calibrate(dataset, cfg, num_samples: int = 50, keep_ratio: float = 0.8,
              safety: float = 1.15, device="cuda"):
    """Measure shape statistics over dataset samples on `device`.

    Returns a dict with suggested neighborhood_limits, level_capacities
    (level 0 included, at the safety factor), cell_capacity and the
    number of samples measured.
    """
    device = torch.device(device)
    num_levels = count_pyramid_levels(cfg["architecture"])
    r0 = float(cfg["first_subsampling_dl"]) * float(cfg["conv_radius"])

    neighb_hists = torch.zeros((num_levels, HIST_MAX), dtype=torch.int64,
                               device=device)
    level_counts = [[] for _ in range(num_levels)]
    cell_max = 0

    n = min(len(dataset), num_samples)
    for i in range(n):
        sample = dataset[i]
        for cloud in (sample["src_xyz"], sample["tgt_xyz"]):
            pts = torch.from_numpy(np.asarray(cloud, np.float32)).to(device)
            r = r0
            for lvl in range(num_levels):
                level_counts[lvl].append(len(pts))
                neighb_hists[lvl] += torch.bincount(
                    neighbor_counts(pts, r), minlength=HIST_MAX)
                cell_max = max(cell_max, max_cell_count(pts, r))
                if lvl + 1 < num_levels:
                    pts = grid_subsample(pts, 2.0 * r / cfg["conv_radius"])
                r *= 2.0

    cum = np.cumsum(neighb_hists.cpu().numpy(), axis=1)
    totals = cum[:, -1]
    limits = [
        int(np.searchsorted(cum[lvl], keep_ratio * totals[lvl]) + 1)
        for lvl in range(num_levels)
    ]
    caps = [
        int(np.ceil(max(level_counts[lvl]) * safety))
        for lvl in range(num_levels)
    ]
    result = {
        "neighborhood_limits": limits,
        "level_capacities": caps,
        "cell_capacity": int(np.ceil(cell_max * safety)),
        "num_samples": n,
    }
    _logger.info("calibration: %s", result)
    return result
