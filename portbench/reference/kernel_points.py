"""Kernel-point dispositions for the reference's KPConv: the seeded
spherical Lloyd iteration the configurations name (`fixed_kernel_points:
center`, the default `kernel_point_method: lloyd`), in numpy, worked out
here again from the seed."""
from __future__ import annotations

from functools import lru_cache

import numpy as np


def _sample_ball(rng, n, dim):
    x = rng.randn(n, dim)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x * rng.rand(n, 1) ** (1.0 / dim)


@lru_cache(maxsize=8)
def unit_dispositions(num_points: int, seed: int = 0) -> np.ndarray:
    """(P, 3) layout in the unit ball, point 0 pinned at the center."""
    rng = np.random.RandomState(seed + 1000 * num_points)
    samples = _sample_ball(rng, 20000, 3)
    centers = _sample_ball(rng, num_points, 3)
    centers[0] = 0.0
    for _ in range(60):
        d = np.linalg.norm(samples[:, None] - centers[None], axis=-1)
        assign = np.argmin(d, axis=1)
        for k in range(num_points):
            pts = samples[assign == k]
            if len(pts) > 0:
                centers[k] = pts.mean(0)
        centers[0] = 0.0
    centers = centers + rng.randn(*centers.shape) * 0.01
    centers[0] = 0.0
    return centers.astype(np.float32)


def kernel_points(radius: float, num_points: int, seed: int = 0):
    """The layout scaled to the convolution's radius, (P, 3) float32."""
    return unit_dispositions(num_points, seed) * np.float32(radius)
