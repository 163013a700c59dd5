"""Deterministic synthetic indoor scans at 3DMatch fragment density, made
with numpy from a seed: a frozen copy of the measured package's
`data/rooms.py` (its draws kept, so one seed gives the same scans bit for
bit), so that later changes there cannot move the benchmark's traffic.

A room is a floor, four walls and 4-8 boxes of furniture at meter scale;
a scan is the n_points points of the room, voxel-downsampled once to
2.5 cm, nearest to its center, moved by its own rigid transform.

As a traffic source (generator.py), `pairs` makes a mix's pairs of scans
with their poses and overlap labels.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

VOXEL = 0.025     # the scans' grid (conf/3dmatch.yaml first_subsampling_dl)


def rotation(rng, max_deg):
    """Rotation about a random axis by an angle uniform in [0, max_deg]."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0.0, max_deg))
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * k @ k


def _wavy_plane(rng, n, half_x, half_y):
    """Points on a plane patch z = a sum of 1-3 sine waves (floor, wall)."""
    x = rng.uniform(-half_x, half_x, n)
    y = rng.uniform(-half_y, half_y, n)
    z = np.zeros(n)
    for _ in range(rng.randint(1, 4)):
        kx, ky = rng.uniform(2.0, 9.0, 2) * rng.choice([-1.0, 1.0], 2)
        z += rng.uniform(0.005, 0.04) * np.sin(
            kx * x + ky * y + rng.uniform(0.0, 2 * np.pi))
    return np.stack([x, y, z], 1)


def _box_surface(rng, n, half):
    """Points on the surface of a box with half-extents `half`."""
    areas = np.array([half[1] * half[2], half[0] * half[2],
                      half[0] * half[1]]).repeat(2)
    face = rng.choice(6, n, p=areas / areas.sum())
    pts = rng.uniform(-1.0, 1.0, (n, 3)) * half
    axis, sign = face // 2, np.where(face % 2 == 0, 1.0, -1.0)
    pts[np.arange(n), axis] = sign * half[axis]
    return pts


def make_room(rng, n_points):
    """One indoor scene at meter scale: a floor, four walls and 4-8 boxes
    of furniture, ~n_points points spread by area."""
    lx, ly, h = rng.uniform(3.5, 5.5), rng.uniform(3.5, 5.5), \
        rng.uniform(2.3, 2.8)
    halves = [rng.uniform(0.2, 0.5, 3) * rng.uniform(0.8, 2.0)
              for _ in range(rng.randint(4, 9))]
    areas = np.array([lx * ly, lx * h, lx * h, ly * h, ly * h]
                     + [8 * (a[0] * a[1] + a[0] * a[2] + a[1] * a[2])
                        for a in halves])
    counts = (areas / areas.sum() * n_points).astype(int)
    floor = _wavy_plane(rng, counts[0], lx / 2, ly / 2) + [lx / 2, ly / 2, 0]
    parts = [floor]
    for i, wall_y in ((1, 0.0), (2, ly)):      # walls along x
        q = _wavy_plane(rng, counts[i], lx / 2, h / 2)
        parts.append(np.stack([q[:, 0] + lx / 2, q[:, 2] + wall_y,
                               q[:, 1] + h / 2], 1))
    for i, wall_x in ((3, 0.0), (4, lx)):      # walls along y
        q = _wavy_plane(rng, counts[i], ly / 2, h / 2)
        parts.append(np.stack([q[:, 2] + wall_x, q[:, 0] + ly / 2,
                               q[:, 1] + h / 2], 1))
    for half, n in zip(halves, counts[5:]):
        offset = [rng.uniform(0.6, lx - 0.6), rng.uniform(0.6, ly - 0.6),
                  half[2]]
        parts.append(_box_surface(rng, n, half) @ rotation(rng, 180).T
                     + offset)
    return np.concatenate(parts).astype(np.float32), (lx, ly)


def voxel_room(rng):
    """A room of `make_room` (600 000 points) voxel-downsampled once to
    VOXEL, the first point of each voxel kept in order: (points, (lx,
    ly))."""
    room, extent = make_room(rng, 600000)
    _, first = np.unique(np.floor(room / VOXEL).astype(np.int64), axis=0,
                         return_index=True)
    return room[np.sort(first)], extent


def scans(n_pairs, n_points, seed):
    """Pairs of overlapping scans of synthetic rooms: a list of (cloud,
    rotation, translation), source then target of each pair, each cloud
    the room's points moved by its own random rigid transform (rotation up
    to 50 degrees).

    Like a 3DMatch fragment, a scan is a contiguous patch at the density of
    a 2.5 cm voxel grid: the room is voxel-downsampled once, and a scan is
    the n_points points nearest to its center.
    """
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n_pairs):
        room, (lx, ly) = voxel_room(rng)
        center = np.array([lx * 0.45, ly * 0.5, 1.1])
        for c in (center, center + [0.7, 0.3, 0.0]):
            dist = np.linalg.norm(room - c, axis=1)
            keep = np.argpartition(dist, n_points)[:n_points]
            rot = rotation(rng, 50.0)
            trans = rng.randn(3) * 0.3
            out.append(((room[keep] @ rot.T + trans).astype(np.float32),
                          rot, trans))
    return out


def overlap_labels(src, tgt, radius):
    """Whether each point has a point of the other cloud within the
    radius (both in the target's frame)."""
    d_s, _ = cKDTree(tgt).query(src, k=1, distance_upper_bound=radius)
    d_t, _ = cKDTree(src).query(tgt, k=1, distance_upper_bound=radius)
    return np.isfinite(d_s), np.isfinite(d_t)


def pairs(mix, seed):
    """The mix's pool of pairs: {src_xyz, tgt_xyz, pose (3, 4), and with
    labels_radius the ground-truth overlap labels src_overlap,
    tgt_overlap}.  Keys of the mix: points_per_scan; labels_radius (the
    labels' radius, or null for none)."""
    clouds = scans(mix["pool_pairs"], mix["points_per_scan"],
                   (seed + mix["seed_offset"]) % 2 ** 32)
    out = []
    for (src, rs, ts), (tgt, rt, tt) in zip(clouds[0::2], clouds[1::2]):
        rot = rt @ rs.T                       # src -> tgt
        pose = np.concatenate([rot, (tt - rot @ ts)[:, None]], 1)
        pair = {"src_xyz": src, "tgt_xyz": tgt,
                "pose": pose.astype(np.float32)}
        if mix.get("labels_radius"):
            warped = (src @ rot.T + pose[:, 3]).astype(np.float32)
            pair["src_overlap"], pair["tgt_overlap"] = overlap_labels(
                warped, tgt, mix["labels_radius"])
        out.append(pair)
    return out
