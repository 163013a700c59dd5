"""Data-layer factory (the port's counterpart of regtr_tpu/data/__init__.py).

3DMatch gets [RigidPerturb, Jitter, ShufflePoints, RandomSwap] at train
time; ModelNet and the synthetic shapes their noise_type pipelines; all
feed the bucketed dense collate.
"""
from __future__ import annotations

from functools import partial

from . import transforms as T
from .collate import collate_pairs, pick_bucket
from .modelnet import make_modelnet_datasets
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
        aug = None
        if phase == "train":
            aug = T.Compose([
                T.RigidPerturb(cfg.get("perturb_pose", "small")),
                T.Jitter(scale=cfg.get("augment_noise", 0.005)),
                T.ShufflePoints(),
                T.RandomSwap(),
            ])
        kwargs = {}
        if cfg.get("metadata_dir"):
            kwargs["metadata_dir"] = cfg["metadata_dir"]
        return ThreeDMatchDataset(cfg, phase, transforms=aug, **kwargs)
    if name in ("modelnet", "synthetic"):
        return make_modelnet_datasets(cfg, phase)
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
        # train and val run collectives on every batch, so every rank must
        # see as many batches; test pairs are never duplicated
        shard_pad=phase in ("train", "val"),
        # every val batch has the full batch shape
        pad_last_batch=phase == "val",
        group_key=group_key,
    )
