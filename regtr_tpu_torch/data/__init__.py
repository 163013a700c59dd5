"""Data-layer factory (the port's counterpart of regtr_tpu/data/__init__.py)
for the 3DMatch / 3DLoMatch val and test phases.

The train phase with its augmentation (RigidPerturb, Jitter, ShufflePoints,
RandomSwap) comes with the trainer (ROADMAP.md Queue A 11); the ModelNet and
synthetic datasets with their protocol (Queue A 12).
"""
from __future__ import annotations

from functools import partial

from .collate import collate_pairs, pick_bucket
from .prefetch import DataLoader
from .threedmatch import ThreeDMatchDataset


def _bucket_of(sample, buckets) -> int:
    n = max(sample["src_xyz"].shape[0], sample["tgt_xyz"].shape[0])
    return pick_bucket(n, buckets)


def get_dataset(cfg, phase: str):
    if phase not in ("train", "val", "test"):
        raise ValueError(f"unknown phase {phase!r}")
    name = cfg.get("dataset", "modelnet")
    if name == "3dmatch":
        if phase == "train":
            raise NotImplementedError(
                "the 3DMatch train phase and its augmentation come with the "
                "trainer (ROADMAP.md Queue A 11)")
        kwargs = {}
        if cfg.get("metadata_dir"):
            kwargs["metadata_dir"] = cfg["metadata_dir"]
        return ThreeDMatchDataset(cfg, phase, **kwargs)
    if name in ("modelnet", "synthetic"):
        raise NotImplementedError(
            f"dataset {name!r}: the ModelNet datasets and protocol are not "
            "ported yet (ROADMAP.md Queue A 12)")
    raise ValueError(f"unknown dataset {name!r}")


def get_dataloader(cfg, phase: str, num_workers: int = 4, shard=None):
    dataset = get_dataset(cfg, phase)
    batch_size = cfg.get(f"{phase}_batch_size", 1)
    # Size-grouped test batching: the bucketed collate pads every pair of a
    # batch to the batch's largest bucket, so one large cloud would drag a
    # whole batch of small pairs to it.  Test only: run_test keys its
    # ordered outputs on the sample, so the changed batch order is
    # invisible.
    group_key = None
    if (phase == "test" and batch_size > 1 and cfg.get("buckets")
            and cfg.get("bucket_grouped_test", True)):
        group_key = partial(_bucket_of, buckets=cfg["buckets"])
    return DataLoader(
        dataset,
        batch_size=batch_size,
        collate_fn=partial(collate_pairs, buckets=cfg.get("buckets")),
        shuffle=phase == "train",
        num_workers=num_workers,
        seed=int(cfg.get("seed", 0)),
        drop_last=phase == "train",
        shard=shard,
        # every val batch has the full batch shape; test pairs are never
        # duplicated
        pad_last_batch=phase == "val",
        group_key=group_key,
    )
