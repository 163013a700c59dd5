"""The general traffic generator: a traffic mix is a file of parameters,
`portbench/traffic/mixes/<name>.json`, and this module turns it, with a
configuration and a seed, into the pool of batches a run cycles through.

A mix holds:
    entry            "forward" (the inference entry) or "train_step"
    source           the module portbench/traffic/<source>.py, whose
                     pairs(mix, seed) makes the pool's pairs from the
                     mix's own keys (e.g. "rooms": rooms.py)
    pairs_per_batch  pairs in one batch
    pool_pairs       distinct pairs made in set-up, cycled in the window
    seed_offset      added to --seed before any draw
Each batch is padded to the bucket that the configuration's `buckets` pick
for its largest cloud (the smallest bucket that holds it), pairs
interleaved (slot 2i the source of pair i, 2i + 1 its target).
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

MIXES = Path(__file__).resolve().parent / "mixes"


def load_mix(name: str) -> dict:
    return json.loads((MIXES / f"{name}.json").read_text())


def pick_bucket(n: int, buckets) -> int:
    """The smallest bucket that holds n points; the largest if none."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    return int(max(buckets))


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
    from ..manifest import traffic_source

    pairs = traffic_source(mix["source"]).pairs(mix, seed)
    per = mix["pairs_per_batch"]
    if len(pairs) % per:
        raise ValueError(f"a pool of {len(pairs)} pairs in batches of {per}")
    return [collate(pairs[i:i + per], cfg["buckets"])
            for i in range(0, len(pairs), per)]
