"""Bucketed dense collate: ragged pair samples -> one fixed-shape batch
(the port's own copy of regtr_tpu/data/collate.py, numpy only; a CPU test
holds the two equal).

Clouds are padded to a bucket capacity chosen from a small static set and
pairs are interleaved: slot 2i is the source of pair i, slot 2i+1 its
target (core/pairs.py).
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n; clouds larger than the largest bucket are
    truncated to it."""
    bs = sorted(buckets)
    for b in bs:
        if n <= b:
            return int(b)
    return int(bs[-1])


def collate_pairs(samples: List[Dict], buckets: Sequence[int]) -> Dict:
    """Collate sample dicts (src_xyz/tgt_xyz/src_overlap/tgt_overlap/pose)
    into the dense interleaved batch the model takes.

    Returns (batch, meta): batch holds numpy arrays points (2B, N0, 3),
    mask (2B, N0), overlap0 (2B, N0), pose (B, 3, 4); meta the bookkeeping
    lists the samples carry (idx, paths, overlap_p, tgt_raw).
    """
    n_pairs = len(samples)
    max_pts = max(
        max(s["src_xyz"].shape[0], s["tgt_xyz"].shape[0]) for s in samples
    )
    n0 = pick_bucket(max_pts, buckets)

    points = np.zeros((2 * n_pairs, n0, 3), np.float32)
    mask = np.zeros((2 * n_pairs, n0), bool)
    overlap0 = np.zeros((2 * n_pairs, n0), np.float32)
    pose = np.zeros((n_pairs, 3, 4), np.float32)

    for i, s in enumerate(samples):
        for j, (xyz_key, ov_key) in enumerate(
            (("src_xyz", "src_overlap"), ("tgt_xyz", "tgt_overlap"))
        ):
            xyz = np.asarray(s[xyz_key], np.float32)
            n = min(xyz.shape[0], n0)
            slot = 2 * i + j
            points[slot, :n] = xyz[:n]
            mask[slot, :n] = True
            ov = np.asarray(s[ov_key])
            overlap0[slot, :n] = ov[:n].astype(np.float32)
        pose[i] = np.asarray(s["pose"], np.float32)

    batch = {
        "points": points,
        "mask": mask,
        "overlap0": overlap0,
        "pose": pose,
    }
    meta = {}
    for key in ("idx", "src_path", "tgt_path", "overlap_p"):
        if key in samples[0]:
            meta[key] = [s[key] for s in samples]
    if "tgt_raw" in samples[0]:
        meta["tgt_raw"] = [np.asarray(s["tgt_raw"]) for s in samples]
    return batch, meta
