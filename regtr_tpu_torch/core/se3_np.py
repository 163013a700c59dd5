"""NumPy SE(3) helpers for the host-side data pipeline, the training
augmentation and the test protocol (the port's own copy of
regtr_tpu/core/se3_np.py; CPU tests hold the two bitwise equal).  Poses are
(..., 3, 4): rotation | translation.
"""
from __future__ import annotations

import numpy as np


def se3_init(rot=None, trans=None):
    if rot is None:
        rot = np.eye(3, dtype=np.float32)
    if trans is None:
        trans = np.zeros((3, 1), dtype=np.float32)
    trans = np.asarray(trans, dtype=rot.dtype)
    if trans.ndim == rot.ndim - 1:
        trans = trans[..., None]
    return np.concatenate([rot, trans], axis=-1)


def se3_cat(a, b):
    rot_a, trans_a = a[..., :3, :3], a[..., :3, 3:4]
    rot_b, trans_b = b[..., :3, :3], b[..., :3, 3:4]
    rot = rot_a @ rot_b
    trans = rot_a @ trans_b + trans_a
    return np.concatenate([rot, trans], axis=-1)


def se3_inv(pose):
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    irot = np.swapaxes(rot, -1, -2)
    return np.concatenate([irot, -irot @ trans], axis=-1)


def se3_transform(pose, xyz):
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    return np.einsum("...ij,...nj->...ni", rot, xyz) + np.swapaxes(trans, -1,
                                                                   -2)


def se3_compare(a, b):
    """Rotation error in degrees and translation error of a against b."""
    combined = se3_cat(a, se3_inv(b))
    trace = combined[..., 0, 0] + combined[..., 1, 1] + combined[..., 2, 2]
    rot_err_deg = np.degrees(np.arccos(np.clip(0.5 * (trace - 1.0), -1.0,
                                               1.0)))
    trans_err = np.linalg.norm(combined[..., :, 3], axis=-1)
    return {"rot_deg": rot_err_deg, "trans": trans_err}


def so3_hat(omega):
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = np.zeros_like(wx)
    return np.stack(
        [
            np.stack([zeros, -wz, wy], axis=-1),
            np.stack([wz, zeros, -wx], axis=-1),
            np.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega):
    theta = np.linalg.norm(omega, axis=-1, keepdims=True)
    theta = np.maximum(theta, 1e-12)
    axis = omega / theta
    k = so3_hat(axis)
    theta = theta[..., None]
    eye = np.broadcast_to(np.eye(3, dtype=omega.dtype), k.shape)
    return eye + np.sin(theta) * k + (1.0 - np.cos(theta)) * (k @ k)


def sample_uniform_rotation(rng: np.random.RandomState, max_deg=None):
    """Random rotation; uniform over SO(3) (by quaternion) if max_deg is
    None, else a random axis with an angle uniform in [0, max_deg]."""
    axis = rng.randn(3)
    axis /= max(np.linalg.norm(axis), 1e-12)
    if max_deg is None:
        # Uniform over SO(3) via quaternion sampling.
        q = rng.randn(4)
        q /= max(np.linalg.norm(q), 1e-12)
        w, x, y, z = q
        return np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ],
            dtype=np.float32,
        )
    angle = np.deg2rad(rng.uniform(0.0, max_deg))
    return so3_exp((axis * angle).astype(np.float32)).astype(np.float32)


def sample_small_se3(rng: np.random.RandomState, rot_std=0.1, trans_std=0.01):
    """Small random perturbation: rotation vector and translation drawn from
    zero-mean gaussians."""
    omega = rng.randn(3).astype(np.float32) * rot_std
    trans = rng.randn(3).astype(np.float32) * trans_std
    return se3_init(so3_exp(omega).astype(np.float32), trans)
