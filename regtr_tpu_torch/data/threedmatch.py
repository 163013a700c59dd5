"""3DMatch / 3DLoMatch dataset for the val and test phases (the port's own
copy of regtr_tpu/data/threedmatch.py; a CPU test holds the samples bitwise
equal).

Pair metadata comes from the bundled pkl files ({src, tgt, rot, trans,
overlap}), raw clouds from per-scene .pth files, and the groundtruth
overlap masks from the precomputed h5 file when it exists, else from
`compute_overlap`.  The train phase (with its augmentation) comes with the
trainer: ROADMAP.md Queue A 11.
"""
from __future__ import annotations

import logging
import os
import pickle

import numpy as np

from ..core import se3_np
from .overlap import compute_overlap

_logger = logging.getLogger(__name__)

# The metadata bundled with the upstream RegTR sources, relative to its
# src/ directory (the working directory of its scripts).
DEFAULT_METADATA_DIR = "datasets/3dmatch"


def _load_pth(path):
    import torch

    # The clouds are pickled numpy arrays: weights_only=True refuses them.
    return np.asarray(torch.load(path, weights_only=False), np.float32)


class ThreeDMatchDataset:
    def __init__(self, cfg, phase, transforms=None,
                 metadata_dir=DEFAULT_METADATA_DIR):
        if phase not in ("val", "test"):
            raise NotImplementedError(
                f"3DMatch phase {phase!r}: only val and test are ported; the "
                "train phase comes with the trainer (ROADMAP.md Queue A 11)")
        benchmark = cfg.get("benchmark", "3DMatch")
        if phase == "val":
            info_fname = os.path.join(metadata_dir, f"{phase}_info.pkl")
            pairs_fname = f"{phase}_pairs-overlapmask.h5"
        else:
            info_fname = os.path.join(metadata_dir,
                                      f"{phase}_{benchmark}_info.pkl")
            pairs_fname = f"{phase}_{benchmark}_pairs-overlapmask.h5"

        with open(info_fname, "rb") as f:
            self.infos = pickle.load(f)

        roots = cfg["root"] if isinstance(cfg["root"], (list, tuple)) \
            else [cfg["root"]]
        self.base_dir = None
        for r in roots:
            if os.path.exists(os.path.join(r, "train")) or \
                    os.path.exists(os.path.join(r, "test")):
                self.base_dir = r
                break
        if self.base_dir is None:
            raise FileNotFoundError(f"3DMatch data not found under {roots}")

        self.pairs_data = None
        h5_path = os.path.join(self.base_dir, pairs_fname)
        if os.path.exists(h5_path):
            import h5py   # only where the precomputed masks exist

            self.pairs_data = h5py.File(h5_path, "r")
        else:
            _logger.warning(
                "Overlap masks not precomputed (%s missing); computing on "
                "the fly.", pairs_fname)

        self.search_radius = cfg["overlap_radius"]
        self.transforms = transforms
        self.phase = phase

    def __len__(self):
        return len(self.infos["rot"])

    def __getitem__(self, item):
        rng = np.random.RandomState(item)
        pose = se3_np.se3_init(
            self.infos["rot"][item].astype(np.float32),
            self.infos["trans"][item].astype(np.float32),
        )
        src_path = self.infos["src"][item]
        tgt_path = self.infos["tgt"][item]
        src_xyz = _load_pth(os.path.join(self.base_dir, src_path))
        tgt_xyz = _load_pth(os.path.join(self.base_dir, tgt_path))

        if self.pairs_data is None:
            src_mask, tgt_mask, corr = compute_overlap(
                se3_np.se3_transform(pose, src_xyz), tgt_xyz,
                self.search_radius)
        else:
            grp = self.pairs_data[f"pair_{item:06d}"]
            src_mask = np.asarray(grp["src_mask"])
            tgt_mask = np.asarray(grp["tgt_mask"])
            corr = np.asarray(grp["src_tgt_corr"])

        data = {
            "src_xyz": src_xyz,
            "tgt_xyz": tgt_xyz,
            "src_overlap": src_mask,
            "tgt_overlap": tgt_mask,
            "correspondences": corr,
            "pose": pose,
            "idx": item,
            "src_path": src_path,
            "tgt_path": tgt_path,
            "overlap_p": float(self.infos["overlap"][item]),
        }
        if self.transforms is not None:
            data = self.transforms(data, rng)
        return data
