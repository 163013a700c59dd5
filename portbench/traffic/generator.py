"""The general traffic generator: a traffic mix is a file of parameters,
`portbench/traffic/mixes/<name>.json`, and this module turns it, with a
configuration and a seed, into the pool of batches a run cycles through.

A mix holds:
    entry            "forward" (the inference entry) or "train_step"
    source           "rooms" (rooms.py)
    pairs_per_batch  pairs in one batch
    pool_pairs       distinct pairs made in set-up, cycled in the window
    seed_offset      added to --seed before any draw
    rooms:  points_per_scan; labels_radius (ground-truth overlap labels
            at this radius, or null for none)
Each batch is padded to the bucket that the configuration's `buckets` pick
for its largest cloud (the smallest bucket that holds it), pairs
interleaved (slot 2i the source of pair i, 2i + 1 its target).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy.spatial import cKDTree

MIXES = Path(__file__).resolve().parent / "mixes"


def load_mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def pick_bucket(n: int, buckets) -> int:
    """The smallest bucket that holds n points; the largest if none."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    return int(max(buckets))


def overlap_labels(src, tgt, radius):
    """Whether each point has a point of the other cloud within the
    radius (both in the target's frame)."""
    d_s, _ = cKDTree(tgt).query(src, k=1, distance_upper_bound=radius)
    d_t, _ = cKDTree(src).query(tgt, k=1, distance_upper_bound=radius)
    return np.isfinite(d_s), np.isfinite(d_t)


def room_pairs(mix, seed):
    from .rooms import scans

    clouds = scans(mix["pool_pairs"], mix["points_per_scan"],
                   (seed + mix["seed_offset"]) % 2 ** 32)
    pairs = []
    for (src, rs, ts), (tgt, rt, tt) in zip(clouds[0::2], clouds[1::2]):
        rot = rt @ rs.T                       # src -> tgt
        pose = np.concatenate([rot, (tt - rot @ ts)[:, None]], 1)
        pair = {"src_xyz": src, "tgt_xyz": tgt,
                "pose": pose.astype(np.float32)}
        if mix.get("labels_radius"):
            warped = (src @ rot.T + pose[:, 3]).astype(np.float32)
            pair["src_overlap"], pair["tgt_overlap"] = overlap_labels(
                warped, tgt, mix["labels_radius"])
        pairs.append(pair)
    return pairs


def collate(pairs, buckets) -> dict:
    """Pairs -> one batch of numpy arrays: points (2B, N0, 3), mask (2B,
    N0), overlap0 (2B, N0) (zeros without labels), pose (B, 3, 4)."""
    n0 = pick_bucket(max(max(len(p["src_xyz"]), len(p["tgt_xyz"]))
                         for p in pairs), buckets)
    b = len(pairs)
    points = np.zeros((2 * b, n0, 3), np.float32)
    mask = np.zeros((2 * b, n0), bool)
    overlap0 = np.zeros((2 * b, n0), np.float32)
    for i, p in enumerate(pairs):
        for j, side in enumerate(("src", "tgt")):
            xyz = p[f"{side}_xyz"][:n0]
            points[2 * i + j, :len(xyz)] = xyz
            mask[2 * i + j, :len(xyz)] = True
            if f"{side}_overlap" in p:
                overlap0[2 * i + j, :len(xyz)] = p[f"{side}_overlap"][:n0]
    return {"points": points, "mask": mask, "overlap0": overlap0,
            "pose": np.stack([p["pose"] for p in pairs]).astype(np.float32)}


def make_pool(mix: dict, cfg: dict, seed: int) -> list:
    """The run's batches, in the order the window cycles them."""
    make = {"rooms": room_pairs}[mix["source"]]
    pairs = make(mix, seed)
    per = mix["pairs_per_batch"]
    if len(pairs) % per:
        raise ValueError(f"a pool of {len(pairs)} pairs in batches of {per}")
    return [collate(pairs[i:i + per], cfg["buckets"])
            for i in range(0, len(pairs), per)]
