"""3DMatch training augmentation in numpy, one explicit RandomState per
sample (the port's own copy of regtr_tpu/data/transforms.py; a CPU test
holds the samples bitwise equal).

RigidPerturb (small or large, of the source or the target), Jitter,
ShufflePoints (a random permutation capped at max_pts, with the
correspondences reindexed) and RandomSwap (with the pose inverted).
"""
from __future__ import annotations

import numpy as np

from ..core import se3_np


def _uniform_sphere(rng):
    phi = rng.uniform(0.0, 2.0 * np.pi)
    cos_theta = rng.uniform(-1.0, 1.0)
    sin_theta = np.sqrt(max(1.0 - cos_theta ** 2, 0.0))
    return np.array(
        [np.cos(phi) * sin_theta, np.sin(phi) * sin_theta, cos_theta],
        np.float32,
    )


def sample_small_pose(rng, std=0.1):
    """Axis uniform on S2; angle ~ N(0, (std*pi/sqrt(3))^2);
    trans ~ N(0, (std/sqrt(3))^2) per axis."""
    axis = _uniform_sphere(rng)
    theta = rng.randn() * std * np.pi / np.sqrt(3.0)
    rot = se3_np.so3_exp((axis * theta).astype(np.float32))
    trans = rng.randn(3).astype(np.float32) * std / np.sqrt(3.0)
    return se3_np.se3_init(rot.astype(np.float32), trans)


def sample_large_pose(rng):
    """Uniform euler zyx rotation in [0, 2pi), zero translation (Predator's
    convention)."""
    from scipy.spatial.transform import Rotation

    euler = rng.rand(3) * 2.0 * np.pi
    rot = Rotation.from_euler("zyx", euler).as_matrix().astype(np.float32)
    return se3_np.se3_init(rot, np.zeros(3, np.float32))


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data, rng):
        for t in self.transforms:
            data = t(data, rng)
        return data


class RigidPerturb:
    """Random rigid perturbation of source OR target (50/50); 'small' mode is
    centroid-centered to avoid large induced translations."""

    def __init__(self, perturb_mode="small"):
        assert perturb_mode in ("none", "small", "large")
        self.mode = perturb_mode

    def __call__(self, data, rng):
        if self.mode == "none":
            return data
        perturb = (
            sample_small_pose(rng) if self.mode == "small"
            else sample_large_pose(rng)
        )
        perturb_source = rng.rand() > 0.5

        if self.mode == "small":
            key = "src_xyz" if perturb_source else "tgt_xyz"
            centroid = data[key].mean(axis=0)
            center = se3_np.se3_init(None, -centroid)
            uncenter = se3_np.se3_init(None, centroid)
            perturb = se3_np.se3_cat(uncenter, se3_np.se3_cat(perturb, center))

        if perturb_source:
            data["pose"] = se3_np.se3_cat(data["pose"], se3_np.se3_inv(perturb))
            data["src_xyz"] = se3_np.se3_transform(perturb, data["src_xyz"])
        else:
            data["pose"] = se3_np.se3_cat(perturb, data["pose"])
            data["tgt_xyz"] = se3_np.se3_transform(perturb, data["tgt_xyz"])
        return data


class Jitter:
    """Gaussian position noise, independently per axis."""

    def __init__(self, scale):
        self.scale = scale

    def __call__(self, data, rng):
        for key in ("src_xyz", "tgt_xyz"):
            data[key] = (
                data[key] + rng.randn(*data[key].shape).astype(np.float32)
                * self.scale
            )
        return data


class ShufflePoints:
    """Random permutation + cap at max_pts, with correspondence reindexing."""

    def __init__(self, max_pts=30000, shuffle=True):
        self.max_pts = max_pts
        self.shuffle = shuffle

    def __call__(self, data, rng):
        n_src = data["src_xyz"].shape[0]
        n_tgt = data["tgt_xyz"].shape[0]
        if self.shuffle:
            src_idx = rng.permutation(n_src)[: self.max_pts]
            tgt_idx = rng.permutation(n_tgt)[: self.max_pts]
        else:
            src_idx = np.arange(min(n_src, self.max_pts))
            tgt_idx = np.arange(min(n_tgt, self.max_pts))

        if "correspondences" in data:
            src_rev = np.full(n_src, -1)
            src_rev[src_idx] = np.arange(len(src_idx))
            tgt_rev = np.full(n_tgt, -1)
            tgt_rev[tgt_idx] = np.arange(len(tgt_idx))
            corr = np.stack([
                src_rev[data["correspondences"][0]],
                tgt_rev[data["correspondences"][1]],
            ])
            data["correspondences"] = corr[:, np.all(corr >= 0, axis=0)]

        data["src_xyz"] = data["src_xyz"][src_idx]
        data["src_overlap"] = data["src_overlap"][src_idx]
        data["tgt_xyz"] = data["tgt_xyz"][tgt_idx]
        data["tgt_overlap"] = data["tgt_overlap"][tgt_idx]
        return data


class RandomSwap:
    """Swap src/tgt with 50% probability, inverting the pose."""

    def __call__(self, data, rng):
        if rng.rand() > 0.5:
            data["src_xyz"], data["tgt_xyz"] = data["tgt_xyz"], data["src_xyz"]
            data["src_overlap"], data["tgt_overlap"] = (
                data["tgt_overlap"], data["src_overlap"],
            )
            if "src_path" in data:
                data["src_path"], data["tgt_path"] = (
                    data["tgt_path"], data["src_path"],
                )
            if "correspondences" in data:
                data["correspondences"] = np.stack([
                    data["correspondences"][1], data["correspondences"][0]
                ])
            data["pose"] = se3_np.se3_inv(data["pose"])
        return data
