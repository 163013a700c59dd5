"""ModelNet pair generation in numpy, one explicit RandomState per sample
(the port's own copy of regtr_tpu/data/modelnet_transforms.py; a CPU test
holds every pipeline's samples bitwise equal).

Split into source and reference -> crop -> random SE3 on the source ->
resample -> jitter -> shuffle, keeping the correspondences and overlap
flags throughout.  The upstream pipeline's quirks are kept:
  * the 717-point resample when both crop proportions are given
    (`predator_compat`, on by default);
  * RandomCrop crops the reference cloud with p_keep[0] as well.
Evaluation is deterministic: SetDeterministic makes every later transform
reseed from the sample's index.  The adapters to other methods' tuples
(Dict2DcpList, Dict2PointnetLKList) are not ported.
"""
from __future__ import annotations

import math
from typing import List, Optional

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


class ComposeMN:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, sample, rng):
        for t in self.transforms:
            sample = t(sample, rng)
        return sample


class SetDeterministic:
    def __call__(self, sample, rng):
        sample["deterministic"] = True
        return sample


def _maybe_reseed(sample, rng):
    """Deterministic eval: reseed from the sample index."""
    if sample.get("deterministic"):
        return np.random.RandomState(int(sample["idx"]))
    return rng


class SplitSourceRef:
    """Clone into source/reference with identity correspondences."""

    def __call__(self, sample, rng):
        sample["points_raw"] = sample.pop("points")
        sample["points_src"] = sample["points_raw"].copy()
        sample["points_ref"] = sample["points_raw"].copy()
        n = sample["points_raw"].shape[0]
        sample["correspondences"] = np.tile(np.arange(n), (2, 1))
        sample.setdefault("src_overlap", np.ones(n, bool))
        sample.setdefault("ref_overlap", np.ones(n, bool))
        return sample


def _resample_idx(rng, n, k):
    if k < n:
        return rng.choice(n, k, replace=False)
    if k == n:
        return np.arange(n)
    return np.concatenate(
        [rng.choice(n, n, replace=False), rng.choice(n, k - n, replace=True)]
    )


class Resampler:
    def __init__(self, num: int, predator_compat: bool = True):
        self.num = num
        self.predator_compat = predator_compat

    def __call__(self, sample, rng):
        rng = _maybe_reseed(sample, rng)
        if "points" in sample:
            idx = _resample_idx(rng, sample["points"].shape[0], self.num)
            sample["points"] = sample["points"][idx]
            return sample

        crop = sample.get("crop_proportion")
        if crop is None:
            src_size = ref_size = self.num
        elif len(crop) == 1:
            src_size = math.ceil(crop[0] * self.num)
            ref_size = self.num
        else:
            src_size = math.ceil(crop[0] * self.num)
            ref_size = math.ceil(crop[1] * self.num)
            if self.predator_compat:
                # Reference keeps a hardcoded 717 here for benchmark parity.
                src_size = ref_size = 717

        n_src = sample["points_src"].shape[0]
        n_ref = sample["points_ref"].shape[0]
        src_idx = _resample_idx(rng, n_src, src_size)
        ref_idx = _resample_idx(rng, n_ref, ref_size)

        src_map = np.full(n_src, -1)
        ref_map = np.full(n_ref, -1)
        src_map[src_idx] = np.arange(src_size)
        ref_map[ref_idx] = np.arange(ref_size)
        corr = np.stack([
            src_map[sample["correspondences"][0]],
            ref_map[sample["correspondences"][1]],
        ])
        sample["correspondences"] = corr[:, np.all(corr >= 0, axis=0)]
        sample["points_src"] = sample["points_src"][src_idx]
        sample["points_ref"] = sample["points_ref"][ref_idx]
        sample["src_overlap"] = sample["src_overlap"][src_idx]
        sample["ref_overlap"] = sample["ref_overlap"][ref_idx]
        return sample


class FixedResampler(Resampler):
    """Deterministic resample: tile + truncate to exactly num points."""

    def __call__(self, sample, rng):
        def fixed(points, k):
            mult, rem = divmod(k, points.shape[0])
            return np.concatenate(
                [np.tile(points, (mult, 1)), points[:rem]], axis=0
            )

        if "points" in sample:
            sample["points"] = fixed(sample["points"], self.num)
            return sample
        raise NotImplementedError(
            "FixedResampler runs before SplitSourceRef (clean pipeline only)"
        )


class RandomJitter:
    def __init__(self, scale=0.01, clip=0.05):
        self.scale = scale
        self.clip = clip

    def _jitter(self, pts, rng):
        noise = np.clip(
            rng.normal(0.0, self.scale, (pts.shape[0], 3)),
            -self.clip, self.clip,
        ).astype(np.float32)
        pts = pts.copy()
        pts[:, :3] += noise
        return pts

    def __call__(self, sample, rng):
        rng = _maybe_reseed(sample, rng)
        if "points" in sample:
            sample["points"] = self._jitter(sample["points"], rng)
        else:
            sample["points_src"] = self._jitter(sample["points_src"], rng)
            sample["points_ref"] = self._jitter(sample["points_ref"], rng)
        return sample


class RandomCrop:
    """Half-space crop of both clouds + overlap/correspondence recompute.

    `p_range=(lo, hi)` (used by the synthetic 3DMatch-scale training
    config) samples the keep fraction uniformly per sample instead of the
    fixed p_keep, so the training distribution covers varied crop and
    overlap statistics; the sampled value flows into `crop_proportion`,
    so the Resampler's cloud sizes vary with it too."""

    def __init__(self, p_keep: Optional[List] = None, p_range=None):
        self.p_keep = np.array(
            p_keep if p_keep is not None else [0.7, 0.7], np.float32
        )
        self.p_range = p_range

    @staticmethod
    def _crop(points, p_keep, rng):
        direction = _uniform_sphere(rng)
        centered = points[:, :3] - points[:, :3].mean(axis=0)
        dist = centered @ direction
        if p_keep == 0.5:
            mask = dist > 0
        else:
            mask = dist > np.percentile(dist, (1.0 - p_keep) * 100.0)
        return points[mask], mask

    def __call__(self, sample, rng):
        rng = _maybe_reseed(sample, rng)
        if self.p_range is not None:
            lo, hi = self.p_range
            p_keep = np.full(len(self.p_keep),
                             rng.uniform(lo, hi), np.float32)
        else:
            p_keep = self.p_keep

        sample["crop_proportion"] = p_keep
        if np.all(p_keep == 1.0):
            return sample

        if len(p_keep) == 1:
            src_pts, src_mask = self._crop(sample["points_src"],
                                           p_keep[0], rng)
            ref_pts = sample["points_ref"]
            ref_mask = np.ones(ref_pts.shape[0], bool)
        else:
            src_pts, src_mask = self._crop(sample["points_src"],
                                           p_keep[0], rng)
            # Reference quirk: ref also cropped with p_keep[0].
            ref_pts, ref_mask = self._crop(sample["points_ref"],
                                           p_keep[0], rng)

        corr = sample["correspondences"]
        src_overlap = np.zeros(sample["points_src"].shape[0], bool)
        src_overlap[corr[0][ref_mask[corr[1]]]] = True
        src_overlap = src_overlap[src_mask]
        ref_overlap = np.zeros(sample["points_ref"].shape[0], bool)
        ref_overlap[corr[1][src_mask[corr[0]]]] = True
        ref_overlap = ref_overlap[ref_mask]

        src_map = np.full(sample["points_src"].shape[0], -1)
        src_map[src_mask] = np.arange(src_mask.sum())
        ref_map = np.full(sample["points_ref"].shape[0], -1)
        ref_map[ref_mask] = np.arange(ref_mask.sum())
        corr = np.stack([src_map[corr[0]], ref_map[corr[1]]])
        sample["correspondences"] = corr[:, np.all(corr >= 0, axis=0)]

        sample["points_src"] = src_pts
        sample["points_ref"] = ref_pts
        sample["src_overlap"] = src_overlap
        sample["ref_overlap"] = ref_overlap
        return sample


class RandomTransformSE3:
    """Random rigid transform applied to the SOURCE; transform_gt maps the
    transformed source back onto the reference."""

    def __init__(self, rot_mag=180.0, trans_mag=1.0, random_mag=False):
        self.rot_mag = rot_mag
        self.trans_mag = trans_mag
        self.random_mag = random_mag

    def _magnitudes(self, rng):
        if self.random_mag:
            a = rng.random_sample()
            return a * self.rot_mag, a * self.trans_mag
        return self.rot_mag, self.trans_mag

    def generate_transform(self, rng):
        from scipy.stats import special_ortho_group
        from scipy.spatial.transform import Rotation

        rot_mag, trans_mag = self._magnitudes(rng)
        rand_rot = special_ortho_group.rvs(3, random_state=rng)
        axis_angle = Rotation.from_matrix(rand_rot).as_rotvec()
        axis_angle *= rot_mag / 180.0
        rot = Rotation.from_rotvec(axis_angle).as_matrix()
        trans = rng.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate(
            [rot, trans[:, None]], axis=1
        ).astype(np.float32)

    def __call__(self, sample, rng):
        rng = _maybe_reseed(sample, rng)
        igt = self.generate_transform(rng)
        if "points" in sample:
            sample["points"] = self._apply(sample["points"], igt)
            return sample
        sample["points_src"] = self._apply(sample["points_src"], igt)
        sample["transform_gt"] = se3_np.se3_inv(igt)  # src -> ref
        return sample

    @staticmethod
    def _apply(points, pose):
        out = points.copy()
        out[:, :3] = se3_np.se3_transform(pose, points[:, :3])
        if points.shape[1] >= 6:  # rotate normals too
            out[:, 3:6] = points[:, 3:6] @ pose[:3, :3].T
        return out


class RandomTransformSE3_euler(RandomTransformSE3):
    """DCP-convention rotation from independent uniform euler angles in
    [0, pi*rot_mag/180] about x, y, z (non-uniform over SO(3))."""

    def generate_transform(self, rng):
        rot_mag, trans_mag = self._magnitudes(rng)
        ax, ay, az = rng.uniform(size=3) * np.pi * rot_mag / 180.0

        cx, sx = np.cos(ax), np.sin(ax)
        cy, sy = np.cos(ay), np.sin(ay)
        cz, sz = np.cos(az), np.sin(az)
        rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
        ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
        rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
        rot = rx @ ry @ rz
        trans = rng.uniform(-trans_mag, trans_mag, 3)
        return np.concatenate(
            [rot, trans[:, None]], axis=1
        ).astype(np.float32)


class ShufflePoints:
    def __call__(self, sample, rng):
        rng = _maybe_reseed(sample, rng)
        if "points" in sample:
            sample["points"] = sample["points"][
                rng.permutation(sample["points"].shape[0])
            ]
            return sample
        n_src = sample["points_src"].shape[0]
        n_ref = sample["points_ref"].shape[0]
        src_perm = rng.permutation(n_src)
        ref_perm = rng.permutation(n_ref)
        sample["points_src"] = sample["points_src"][src_perm]
        sample["points_ref"] = sample["points_ref"][ref_perm]
        sample["src_overlap"] = sample["src_overlap"][src_perm]
        sample["ref_overlap"] = sample["ref_overlap"][ref_perm]
        src_map = np.full(n_src, -1)
        src_map[src_perm] = np.arange(n_src)
        ref_map = np.full(n_ref, -1)
        ref_map[ref_perm] = np.arange(n_ref)
        sample["correspondences"] = np.stack([
            src_map[sample["correspondences"][0]],
            ref_map[sample["correspondences"][1]],
        ])
        return sample


def get_transforms(noise_type: str, rot_mag=45.0, trans_mag=0.5,
                   num_points=1024, partial_p_keep=None,
                   predator_compat=True, partial_range=None):
    """(train, test) pipelines for a noise type: clean, jitter or crop.

    partial_range=(lo, hi), train only: the crop's keep fraction is drawn
    per sample instead of fixed, widening the overlap statistics the model
    sees (the test pipeline keeps the fixed fraction, so evaluation numbers
    stay comparable)."""
    partial = partial_p_keep if partial_p_keep is not None else [0.7, 0.7]
    if noise_type == "clean":
        train = [Resampler(num_points), SplitSourceRef(),
                 RandomTransformSE3_euler(rot_mag, trans_mag), ShufflePoints()]
        test = [SetDeterministic(), FixedResampler(num_points),
                SplitSourceRef(), RandomTransformSE3_euler(rot_mag, trans_mag),
                ShufflePoints()]
    elif noise_type == "jitter":
        rs = Resampler(num_points, predator_compat)
        train = [SplitSourceRef(), RandomTransformSE3_euler(rot_mag, trans_mag),
                 rs, RandomJitter(), ShufflePoints()]
        test = [SetDeterministic(), SplitSourceRef(),
                RandomTransformSE3_euler(rot_mag, trans_mag),
                rs, RandomJitter(), ShufflePoints()]
    elif noise_type == "crop":
        rs = Resampler(num_points, predator_compat)
        train = [SplitSourceRef(),
                 RandomCrop(partial, p_range=partial_range),
                 RandomTransformSE3_euler(rot_mag, trans_mag),
                 rs, RandomJitter(), ShufflePoints()]
        test = [SetDeterministic(), SplitSourceRef(), RandomCrop(partial),
                RandomTransformSE3_euler(rot_mag, trans_mag),
                rs, RandomJitter(), ShufflePoints()]
    else:
        raise ValueError(f"unknown noise_type {noise_type!r}")
    return ComposeMN(train), ComposeMN(test)
