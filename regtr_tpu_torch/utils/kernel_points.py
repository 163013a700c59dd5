"""Deterministic kernel-point dispositions (the port's own copy of
regtr_tpu/utils/kernel_points.py, numpy only; a CPU test holds the two
bitwise equal).

Dispositions come from a seeded spherical Lloyd iteration (k-means over
points sampled uniformly in the unit ball) or a seeded repulsion
optimization, so the layout is bitwise-reproducible.  `fixed='center'` pins
kernel point 0 at the origin, as the shipped configs ask
(`fixed_kernel_points: center`).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from .ply import read_ply_xyz, write_ply


def _sample_ball(rng, n, dim):
    """Uniform samples in the unit ball."""
    x = rng.randn(n, dim)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    r = rng.rand(n, 1) ** (1.0 / dim)
    return x * r


@lru_cache(maxsize=16)
def repulsion_dispositions(num_points: int, dim: int = 3,
                           fixed: str = "center", seed: int = 0,
                           ratio: float = 0.66,
                           max_iters: int = 5000,
                           num_candidates: int = 30) -> np.ndarray:
    """(K, dim) layout by potential/repulsion optimization, seeded.

    Points repel each other (inverse-square potential) inside an attractive
    radial well; `num_candidates` layouts are optimized in a batch and the
    one with the lowest final gradient norm wins; the winner is rescaled so
    the mean radius of the free points is `ratio`.
    """
    rng = np.random.RandomState(seed + 7000 * num_points)
    radius0 = 1.0
    clip = 0.05
    moving_factor, decay = 1e-2, 0.9995
    c, k = num_candidates, num_points

    # init: uniform in the ball of squared radius 0.5 * radius0^2
    pts = np.zeros((0, dim))
    while len(pts) < c * k:
        cand = rng.rand(2 * c * k + 8, dim) * 2 * radius0 - radius0
        cand = cand[np.sum(cand ** 2, axis=1) < 0.5 * radius0 ** 2]
        pts = np.vstack([pts, cand])
    pts = pts[: c * k].reshape(c, k, dim).copy()

    n_frozen = 0   # fully pinned points (only the center one)
    n_sel = 0      # points excluded from the best-candidate criterion
    if fixed == "center":
        pts[:, 0] = 0.0
        n_frozen = n_sel = 1
    elif fixed == "verticals":
        pts[:, :3] = 0.0
        pts[:, 1, -1] = 2 * radius0 / 3
        pts[:, 2, -1] = -2 * radius0 / 3
        n_frozen, n_sel = 1, 3  # points 1-2 may still slide vertically

    norms = np.zeros((c, k))
    for _ in range(max_iters):
        diff = pts[:, :, None, :] - pts[:, None, :, :]       # (C, K, K, dim)
        d2 = np.sum(diff ** 2, axis=-1)
        # potential gradient for point i: sum_j (x_j - x_i) / d^3
        inter = -np.sum(diff / (d2[..., None] ** 1.5 + 1e-6), axis=2)
        grads = inter + 10.0 * pts                            # radial well
        if fixed == "verticals":
            grads[:, 1:3, :-1] = 0.0
        norms = np.linalg.norm(grads, axis=-1)                # (C, K)
        moves = np.minimum(moving_factor * norms, clip)
        moves[:, :n_frozen] = 0.0
        pts -= moves[..., None] * grads / (norms[..., None] + 1e-6)
        moving_factor *= decay

    best = int(np.argmin(norms[:, n_sel:].max(axis=1)))
    out = pts[best]
    r = np.linalg.norm(out, axis=-1)
    out = out * (ratio / np.mean(r[1:]))
    if fixed in ("center", "verticals"):
        out[0] = 0.0
    return out.astype(np.float32)


@lru_cache(maxsize=16)
def kernel_dispositions(num_points: int, dim: int = 3, fixed: str = "center",
                        seed: int = 0) -> np.ndarray:
    """(K, dim) unit-sphere kernel point layout, deterministic in `seed`."""
    rng = np.random.RandomState(seed + 1000 * num_points)
    samples = _sample_ball(rng, 20000, dim)

    centers = _sample_ball(rng, num_points, dim)
    if fixed == "center":
        centers[0] = 0.0
    elif fixed == "verticals":
        centers[0] = 0.0
        if num_points > 1:
            centers[1] = np.eye(dim)[-1] * 0.66
        if num_points > 2:
            centers[2] = -np.eye(dim)[-1] * 0.66

    for _ in range(60):
        d = np.linalg.norm(samples[:, None] - centers[None], axis=-1)
        assign = np.argmin(d, axis=1)
        for k in range(num_points):
            pts = samples[assign == k]
            if len(pts) > 0:
                centers[k] = pts.mean(0)
        if fixed == "center":
            centers[0] = 0.0
        elif fixed == "verticals":
            centers[0] = 0.0

    # Small deterministic jitter to break any residual symmetry.
    centers = centers + rng.randn(*centers.shape) * 0.01
    if fixed == "center":
        centers[0] = 0.0
    return centers.astype(np.float32)


def load_kernel_points(radius: float, num_points: int, dim: int = 3,
                       fixed: str = "center", seed: int = 0,
                       method: str = "lloyd") -> np.ndarray:
    """Kernel points scaled to the given conv radius (K, dim).

    method: 'lloyd' (seeded spherical Lloyd) or 'repulsion' (seeded
    potential optimization); config key `kernel_point_method`.
    """
    if method == "repulsion":
        disp = repulsion_dispositions(num_points, dim, fixed, seed)
    elif method == "lloyd":
        disp = kernel_dispositions(num_points, dim, fixed, seed)
    else:
        raise ValueError(f"unknown kernel point method {method}")
    return disp * np.float32(radius)


def write_dispositions_ply(path, dispositions: np.ndarray):
    """Write a (K, 3) disposition in the reference's cache format
    (kernels/dispositions/k_XXX_<fixed>_3D.ply)."""
    write_ply(path, [np.asarray(dispositions, np.float32)], ["x", "y", "z"])


def read_dispositions_ply(path) -> np.ndarray:
    """A disposition cached by the reference, or written above: (K, 3)
    float32."""
    return np.asarray(read_ply_xyz(path), np.float32)


@lru_cache(maxsize=4)
def _load_disposition_npz(path: str):
    """Per-block kernel dispositions exported from a reference (PyTorch)
    checkpoint by `python -m regtr_tpu_torch.convert_checkpoint
    --kernel_points` (keys like 'kpf_encoder.encoder_blocks.3.KPConv.
    kernel_points'), stored already scaled by each block's radius."""
    with np.load(path) as data:
        return {k: np.asarray(data[k], np.float32) for k in data.files}


def lookup_block_dispositions(path: str, block_index: int):
    """The disposition of encoder block `block_index` in an exported npz,
    or None if the file has no entry for it (config key
    `kernel_dispositions_file`: bit-exact converted checkpoints, since the
    reference draws each block's disposition at random and stores it in
    the checkpoint)."""
    table = _load_disposition_npz(str(path))
    for key, val in table.items():
        if f"encoder_blocks.{block_index}.KPConv.kernel_points" in key:
            return val
    return None
