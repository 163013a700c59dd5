"""NumPy SE(3) helpers for the host-side data pipeline and the test
protocol (the port's own copy of regtr_tpu/core/se3_np.py; a CPU test holds
the two bitwise equal).  Poses are (..., 3, 4): rotation | translation.

The so3 maps and the random pose samplers of the JAX module serve the
training augmentation, which comes with the trainer.
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
