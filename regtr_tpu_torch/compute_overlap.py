"""Offline precompute of the 3DMatch groundtruth overlap masks (the port's
counterpart of the root compute_overlap_3dmatch.py; host only, it runs no
model).

    python -m regtr_tpu_torch.compute_overlap --root DATA_ROOT \\
        [--phase train|val] [--metadata_dir datasets/3dmatch] \\
        [--overlap_radius 0.0375]

Writes DATA_ROOT/{phase}_pairs-overlapmask.h5: for each pair of
{phase}_info.pkl a group pair_<i:06d> with src_mask, tgt_mask and
src_tgt_corr (the mutual nearest neighbors within the radius, source
warped by the groundtruth pose), which `ThreeDMatchDataset` then reads
instead of computing them per sample.  The masks come from the port's own
k-d tree search (data/overlap.py).  The default --metadata_dir is the
metadata's place in the upstream sources, relative to their src/
directory.  h5py is needed here only.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from .data.threedmatch import DEFAULT_METADATA_DIR


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--root", required=True, help="3DMatch data root")
    p.add_argument("--phase", default="train", choices=["train", "val"])
    p.add_argument("--metadata_dir", default=DEFAULT_METADATA_DIR)
    p.add_argument("--overlap_radius", type=float, default=0.0375)
    opt = p.parse_args(argv)

    import h5py
    import torch

    from .core import se3_np
    from .data.overlap import compute_overlap

    with open(os.path.join(opt.metadata_dir, f"{opt.phase}_info.pkl"),
              "rb") as f:
        infos = pickle.load(f)

    out_path = os.path.join(opt.root, f"{opt.phase}_pairs-overlapmask.h5")
    n = len(infos["rot"])
    with h5py.File(out_path, "w") as h5:
        for i in range(n):
            pose = se3_np.se3_init(infos["rot"][i].astype(np.float32),
                                   infos["trans"][i].astype(np.float32))
            src, tgt = (np.asarray(torch.load(
                os.path.join(opt.root, infos[key][i]), weights_only=False),
                np.float32) for key in ("src", "tgt"))
            src_mask, tgt_mask, corr = compute_overlap(
                se3_np.se3_transform(pose, src), tgt, opt.overlap_radius)
            grp = h5.create_group(f"pair_{i:06d}")
            grp.create_dataset("src_mask", data=src_mask)
            grp.create_dataset("tgt_mask", data=tgt_mask)
            # int32, as the JAX package's native search writes them
            grp.create_dataset("src_tgt_corr", data=corr.astype(np.int32))
            if i % 500 == 0:
                print(f"{i}/{n}", flush=True)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
