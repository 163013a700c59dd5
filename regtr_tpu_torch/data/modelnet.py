"""ModelNet40 paired-registration dataset (the port's own copy of
regtr_tpu/data/modelnet.py; a CPU test holds the samples bitwise equal).

PointNet-format HDF5 shards with normals, the half1/half2 category splits,
and the clean / jitter / crop pair pipelines.  Nothing is downloaded: when
the HDF5 data is absent, `SyntheticShapeDataset` (synthetic.py) gives
samples of the same form.  `h5py` is imported only where the HDF5 data is
read.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional

import numpy as np

from .modelnet_transforms import get_transforms


def load_categories(path) -> List[str]:
    with open(path) as f:
        cats = [line.strip() for line in f if line.strip()]
    cats.sort()
    return cats


class ModelNetHdf:
    def __init__(self, cfg, root: str, subset: str = "train",
                 categories: Optional[List[str]] = None, transform=None):
        import h5py   # only where the HDF5 shards are read

        self.cfg = cfg
        self.overlap_radius = cfg["overlap_radius"]
        self._transform = transform
        self.subset = subset

        with open(os.path.join(root, "shape_names.txt")) as f:
            self._classes = [line.strip() for line in f]
        cat2idx = {c: i for i, c in enumerate(self._classes)}

        with open(os.path.join(root, f"{subset}_files.txt")) as f:
            h5_files = [
                os.path.join(
                    root,
                    line.strip().replace("data/modelnet40_ply_hdf5_2048/", ""),
                )
                for line in f
            ]

        cat_idx = [cat2idx[c] for c in categories] if categories else None
        self._data, self._labels = self._read_h5(h5py, h5_files, cat_idx)

    @staticmethod
    def _read_h5(h5py, fnames, categories):
        all_data, all_labels = [], []
        for fname in fnames:
            with h5py.File(fname, "r") as f:
                data = np.concatenate(
                    [f["data"][:], f["normal"][:]], axis=-1
                ).astype(np.float32)
                labels = f["label"][:].flatten().astype(np.int64)
            if categories is not None:
                keep = np.isin(labels, categories)
                data, labels = data[keep], labels[keep]
            all_data.append(data)
            all_labels.append(labels)
        return np.concatenate(all_data), np.concatenate(all_labels)

    def __len__(self):
        return self._data.shape[0]

    def __getitem__(self, item):
        # numpy's global state seeds each sample, as in the JAX package
        rng = np.random.RandomState(np.random.randint(2 ** 31))
        sample = {
            "points": self._data[item].copy(),
            "label": self._labels[item],
            "idx": np.int32(item),
        }
        if self._transform is not None:
            sample = self._transform(sample, rng)
        return modelnet_sample_to_pair(sample)


def modelnet_sample_to_pair(sample):
    """The transform pipeline's output dict in the common pair format."""
    corr = sample["correspondences"]
    corr_xyz = np.concatenate(
        [sample["points_src"][corr[0], :3], sample["points_ref"][corr[1], :3]],
        axis=1,
    )
    return {
        "src_xyz": sample["points_src"][:, :3].astype(np.float32),
        "tgt_xyz": sample["points_ref"][:, :3].astype(np.float32),
        "tgt_raw": sample["points_raw"][:, :3].astype(np.float32),
        "src_overlap": sample["src_overlap"].astype(bool),
        "tgt_overlap": sample["ref_overlap"].astype(bool),
        "correspondences": corr,
        "pose": sample["transform_gt"].astype(np.float32),
        "idx": int(sample["idx"]),
        "corr_xyz": corr_xyz.astype(np.float32),
    }


def make_modelnet_datasets(cfg, phase: str):
    """The dataset with the phase's transform pipeline: ModelNetHdf where
    cfg['root'] holds the HDF5 data, else SyntheticShapeDataset."""
    # The upstream 717-point resample belongs to the real ModelNet
    # protocol; on the synthetic dataset it would shrink every cloud to 717
    # points whatever num_points says, so it defaults off there.
    synthetic = cfg.get("dataset") == "synthetic"
    train_t, test_t = get_transforms(
        cfg.get("noise_type", "crop"),
        cfg.get("rot_mag", 45.0), cfg.get("trans_mag", 0.5),
        cfg.get("num_points", 1024), cfg.get("partial"),
        predator_compat=cfg.get("predator_compat", not synthetic),
        partial_range=cfg.get("partial_range"),
    )
    transform = train_t if phase == "train" else test_t
    root = cfg.get("root", "")
    if root and os.path.exists(os.path.join(root, "shape_names.txt")):
        catfile = cfg.get(f"{phase}_categoryfile")
        cats = load_categories(catfile) if catfile and os.path.exists(catfile) \
            else None
        subset = "train" if phase == "train" else "test"
        return ModelNetHdf(cfg, root, subset, cats, transform)
    if cfg.get("dataset") == "modelnet":
        logging.getLogger("regtr_tpu_torch").warning(
            "ModelNet HDF5 data not found at root=%r (no shape_names.txt). "
            "Download modelnet40_ply_hdf5_2048, unzip it, and point "
            "dataset.root at it. Falling back to the synthetic "
            "parametric-shape dataset for this run.", root,
        )
    from .synthetic import SyntheticShapeDataset

    # The base cloud at the pipeline's resolution (the Resampler can only
    # duplicate points beyond it).
    base_points = cfg.get("synthetic_base_points",
                          max(2048, cfg.get("num_points", 1024)))
    n_items = cfg.get("synthetic_items", 256)
    if phase != "train":
        # validation walks its whole loader every validate_every steps: a
        # separately sized (still seeded) split keeps that affordable
        n_items = cfg.get("synthetic_val_items", min(n_items, 256))
    return SyntheticShapeDataset(
        cfg, n_items=n_items,
        n_points=base_points,
        transform=transform, seed=0 if phase == "train" else 1,
    )
