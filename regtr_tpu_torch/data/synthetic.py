"""Synthetic shape dataset with the ModelNet sample contract (the port's
own copy of regtr_tpu/data/synthetic.py; a CPU test holds the samples
bitwise equal).

Point clouds sampled from parametric surfaces with normals, shaped exactly
like ModelNetHdf samples, so the whole transform / collate / train stack
runs on data that needs no download:

  * seven part families (box, sphere, cylinder, ellipsoid, torus,
    cone/frustum, sine-displaced plane patch), each randomly oriented;
  * two scene modes: free "object" compositions of 1..6 parts, and
    "room" scenes (floor + 1-2 walls + furniture-like parts) with the
    large planar regions and clutter of indoor scans;
  * the base resolution follows the pipeline's num_points, so a
    16384-point config samples 16384 distinct surface points.

Item i of a split seeds its cloud from seed * 100003 + i and its pipeline
from seed * 7919 + i: no epoch enters, and the loader's threads cannot
change a sample.
"""
from __future__ import annotations

import numpy as np

from .modelnet import modelnet_sample_to_pair


def _sample_box(rng, n, half):
    face_areas = np.array([
        half[1] * half[2], half[1] * half[2],
        half[0] * half[2], half[0] * half[2],
        half[0] * half[1], half[0] * half[1],
    ])
    faces = rng.choice(6, n, p=face_areas / face_areas.sum())
    pts = rng.uniform(-1, 1, (n, 3)) * half
    normals = np.zeros((n, 3))
    for f in range(6):
        axis, sign = f // 2, 1.0 if f % 2 == 0 else -1.0
        m = faces == f
        pts[m, axis] = sign * half[axis]
        normals[m, axis] = sign
    return pts, normals


def _sample_sphere(rng, n, radius):
    d = rng.randn(n, 3)
    d /= np.maximum(np.linalg.norm(d, axis=1, keepdims=True), 1e-9)
    return d * radius, d


def _sample_ellipsoid(rng, n, radii):
    d, _ = _sample_sphere(rng, n, 1.0)
    pts = d * radii
    normals = d / radii  # gradient of the implicit surface
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                          1e-9)
    return pts, normals


def _sample_cylinder(rng, n, radius, half_h):
    side = rng.rand(n) < 0.7
    theta = rng.uniform(0, 2 * np.pi, n)
    pts = np.zeros((n, 3))
    normals = np.zeros((n, 3))
    pts[:, 0] = np.cos(theta) * radius
    pts[:, 1] = np.sin(theta) * radius
    pts[:, 2] = rng.uniform(-half_h, half_h, n)
    normals[:, 0] = np.cos(theta)
    normals[:, 1] = np.sin(theta)
    cap = ~side
    r_cap = radius * np.sqrt(rng.rand(cap.sum()))
    th_cap = theta[cap]
    sign = np.where(rng.rand(cap.sum()) < 0.5, 1.0, -1.0)
    pts[cap, 0] = np.cos(th_cap) * r_cap
    pts[cap, 1] = np.sin(th_cap) * r_cap
    pts[cap, 2] = sign * half_h
    normals[cap] = 0.0
    normals[cap, 2] = sign
    return pts, normals


def _sample_cone(rng, n, r_bottom, r_top, half_h):
    """Frustum: radius interpolates r_bottom -> r_top along z, plus caps."""
    side = rng.rand(n) < 0.75
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-half_h, half_h, n)
    t = (z + half_h) / (2 * half_h)
    r = r_bottom + (r_top - r_bottom) * t
    pts = np.stack([np.cos(theta) * r, np.sin(theta) * r, z], axis=1)
    slope = (r_top - r_bottom) / (2 * half_h)
    normals = np.stack([np.cos(theta), np.sin(theta),
                        np.full_like(theta, -slope)], axis=1)
    normals /= np.maximum(np.linalg.norm(normals, axis=1, keepdims=True),
                          1e-9)
    cap = ~side
    ncap = cap.sum()
    sign = np.where(rng.rand(ncap) < 0.5, 1.0, -1.0)
    r_at = np.where(sign > 0, r_top, r_bottom)
    rc = r_at * np.sqrt(rng.rand(ncap))
    pts[cap, 0] = np.cos(theta[cap]) * rc
    pts[cap, 1] = np.sin(theta[cap]) * rc
    pts[cap, 2] = sign * half_h
    normals[cap] = 0.0
    normals[cap, 2] = sign
    return pts, normals


def _sample_torus(rng, n, r_major, r_minor):
    u = rng.uniform(0, 2 * np.pi, n)   # around the tube center circle
    v = rng.uniform(0, 2 * np.pi, n)   # around the tube
    cx = np.stack([np.cos(u), np.sin(u), np.zeros(n)], axis=1)
    normals = (np.stack([np.cos(v) * np.cos(u), np.cos(v) * np.sin(u),
                         np.sin(v)], axis=1))
    pts = cx * r_major + normals * r_minor
    return pts, normals


def _sample_wavy_plane(rng, n, half_x, half_y, amp):
    """Plane patch z = sum of 1-3 random sine waves — terrain/wall panels."""
    x = rng.uniform(-half_x, half_x, n)
    y = rng.uniform(-half_y, half_y, n)
    z = np.zeros(n)
    dzdx = np.zeros(n)
    dzdy = np.zeros(n)
    for _ in range(rng.randint(1, 4)):
        kx, ky = rng.uniform(2.0, 9.0, 2) * rng.choice([-1.0, 1.0], 2)
        ph = rng.uniform(0, 2 * np.pi)
        a = amp * rng.uniform(0.3, 1.0)
        arg = kx * x + ky * y + ph
        z += a * np.sin(arg)
        dzdx += a * kx * np.cos(arg)
        dzdy += a * ky * np.cos(arg)
    pts = np.stack([x, y, z], axis=1)
    normals = np.stack([-dzdx, -dzdy, np.ones(n)], axis=1)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    return pts, normals


def _random_rotation(rng):
    q = rng.randn(4)
    q /= np.linalg.norm(q)
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _sample_part(rng, kind, n):
    if kind == 0:
        return _sample_box(rng, n, rng.uniform(0.2, 0.5, 3))
    if kind == 1:
        return _sample_sphere(rng, n, rng.uniform(0.2, 0.5))
    if kind == 2:
        return _sample_cylinder(
            rng, n, rng.uniform(0.15, 0.4), rng.uniform(0.2, 0.5))
    if kind == 3:
        return _sample_ellipsoid(rng, n, rng.uniform(0.15, 0.55, 3))
    if kind == 4:
        return _sample_torus(
            rng, n, rng.uniform(0.25, 0.45), rng.uniform(0.06, 0.18))
    if kind == 5:
        return _sample_cone(
            rng, n, rng.uniform(0.2, 0.45), rng.uniform(0.02, 0.3),
            rng.uniform(0.2, 0.5))
    return _sample_wavy_plane(
        rng, n, rng.uniform(0.3, 0.6), rng.uniform(0.3, 0.6),
        rng.uniform(0.02, 0.12))


N_PART_KINDS = 7


class SyntheticShapeDataset:
    """Deterministic (seeded) synthetic shapes, ModelNet-format samples."""

    def __init__(self, cfg, n_items=256, n_points=2048, transform=None,
                 seed=0):
        self.cfg = cfg
        self.n_items = n_items
        self.n_points = n_points
        self._transform = transform
        self.seed = seed

    def __len__(self):
        return self.n_items

    def _make_object_scene(self, rng):
        """1..6 randomly oriented parts at random offsets."""
        parts = rng.randint(1, 7)
        weights = rng.uniform(0.5, 1.5, parts)
        counts = np.maximum(
            (weights / weights.sum() * self.n_points).astype(int), 8)
        pts_all, nrm_all = [], []
        for p in range(parts):
            kind = rng.randint(N_PART_KINDS)
            pts, nrm = _sample_part(rng, kind, counts[p])
            rot = _random_rotation(rng)
            pts_all.append(pts @ rot.T + rng.uniform(-0.4, 0.4, 3))
            nrm_all.append(nrm @ rot.T)
        return np.concatenate(pts_all), np.concatenate(nrm_all)

    def _make_room_scene(self, rng):
        """Floor + 1-2 walls + furniture: indoor-scan-like statistics
        (large planar regions with clutter, as in 3DMatch scenes)."""
        n_walls = rng.randint(1, 3)
        n_objs = rng.randint(2, 6)
        weights = np.concatenate([
            rng.uniform(0.8, 1.4, 1 + n_walls),          # planes get area
            rng.uniform(0.3, 0.9, n_objs),
        ])
        counts = np.maximum(
            (weights / weights.sum() * self.n_points).astype(int), 8)
        pts_all, nrm_all = [], []
        # floor at z=0
        amp = rng.uniform(0.0, 0.03)
        pts, nrm = _sample_wavy_plane(rng, counts[0], 0.9, 0.9, max(amp, 1e-3))
        pts_all.append(pts)
        nrm_all.append(nrm)
        # walls: vertical planes along a room edge, slight rotation about z
        for w in range(n_walls):
            pts, nrm = _sample_wavy_plane(
                rng, counts[1 + w], 0.9, 0.5, rng.uniform(1e-3, 0.03))
            # rotate plane normal from +z to horizontal
            ax = rng.randint(2)
            rot90 = np.eye(3)[[2, 1, 0]] if ax == 0 else np.eye(3)[[0, 2, 1]]
            ang = rng.uniform(-0.3, 0.3)
            ca, sa = np.cos(ang), np.sin(ang)
            rz = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
            rot = rz @ rot90
            off = np.array([0.0, 0.0, 0.5])
            off[ax] = rng.choice([-0.9, 0.9])
            pts_all.append(pts @ rot.T + off)
            nrm_all.append(nrm @ rot.T)
        # furniture
        for o in range(n_objs):
            kind = rng.randint(N_PART_KINDS - 1)  # no plane furniture
            pts, nrm = _sample_part(rng, kind, counts[1 + n_walls + o])
            scale = rng.uniform(0.3, 0.8)
            rot = _random_rotation(rng)
            off = np.array([rng.uniform(-0.6, 0.6), rng.uniform(-0.6, 0.6),
                            rng.uniform(0.1, 0.5)])
            pts_all.append(pts * scale @ rot.T + off)
            nrm_all.append(nrm @ rot.T)
        return np.concatenate(pts_all), np.concatenate(nrm_all)

    def _make_cloud(self, item):
        rng = np.random.RandomState(self.seed * 100003 + item)
        if rng.rand() < 0.4:
            pts, nrm = self._make_room_scene(rng)
        else:
            pts, nrm = self._make_object_scene(rng)
        pts = pts[: self.n_points]
        nrm = nrm[: self.n_points]
        if pts.shape[0] < self.n_points:  # part-count rounding shortfall
            extra = rng.randint(0, pts.shape[0],
                                self.n_points - pts.shape[0])
            pts = np.concatenate([pts, pts[extra]])
            nrm = np.concatenate([nrm, nrm[extra]])
        center = (pts.min(0) + pts.max(0)) / 2
        pts = pts - center
        scale = np.abs(pts).max() or 1.0
        pts = pts / scale * 0.5  # unit-ish scale like ModelNet
        return np.concatenate([pts, nrm], axis=1).astype(np.float32)

    def __getitem__(self, item):
        rng = np.random.RandomState(
            self.seed * 7919 + item
        )
        sample = {
            "points": self._make_cloud(item),
            "label": np.int64(0),
            "idx": np.int32(item),
        }
        if self._transform is not None:
            sample = self._transform(sample, rng)
        return modelnet_sample_to_pair(sample)
