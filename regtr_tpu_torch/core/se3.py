"""SE(3) helpers and the weighted Kabsch solver (counterpart of
regtr_tpu/core/se3.py).  Poses are (..., 3, 4) matrices (rotation | t)."""
from __future__ import annotations

import torch

_EPS = 1e-6


def se3_init(rot: torch.Tensor | None = None,
             trans: torch.Tensor | None = None) -> torch.Tensor:
    """A (..., 3, 4) pose from a rotation (..., 3, 3) and/or a translation
    (..., 3) or (..., 3, 1); the rotation defaults to the identity, the
    translation to zero."""
    if rot is None and trans is None:
        raise ValueError("need rotation and/or translation")
    if trans is not None and trans.shape[-1] != 1:
        trans = trans[..., None]
    if rot is not None and trans is not None:
        return torch.cat([rot, trans], dim=-1)
    if rot is None:
        eye = torch.eye(3, dtype=trans.dtype, device=trans.device)
        return torch.cat([eye.expand(trans.shape[:-2] + (3, 3)), trans],
                         dim=-1)
    return torch.cat([rot, rot.new_zeros(rot.shape[:-1] + (1,))], dim=-1)


def se3_identity(batch_shape=(), dtype=torch.float32,
                 device=None) -> torch.Tensor:
    """Identity poses, (*batch_shape, 3, 4)."""
    return torch.eye(3, 4, dtype=dtype, device=device).expand(
        tuple(batch_shape) + (3, 4))


def se3_rot_trans(pose: torch.Tensor):
    """-> (rotation (..., 3, 3), translation (..., 3))."""
    return pose[..., :3, :3], pose[..., :3, 3]


def se3_cat(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Compose two poses: the result applies b, then a."""
    rot_a, trans_a = a[..., :3, :3], a[..., :3, 3:4]
    rot_b, trans_b = b[..., :3, :3], b[..., :3, 3:4]
    return torch.cat([rot_a @ rot_b, rot_a @ trans_b + trans_a], dim=-1)


def se3_inv(pose: torch.Tensor) -> torch.Tensor:
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    irot = rot.transpose(-1, -2)
    return torch.cat([irot, -irot @ trans], dim=-1)


def se3_transform(pose: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply pose (..., 3, 4) to points (..., N, 3) -> (..., N, 3)."""
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    return xyz @ rot.transpose(-1, -2) + trans.transpose(-1, -2)


def se3_compare(a: torch.Tensor, b: torch.Tensor) -> dict:
    """Rotation error in degrees and translation error between two poses."""
    combined = se3_cat(a, se3_inv(b))
    trace = combined[..., 0, 0] + combined[..., 1, 1] + combined[..., 2, 2]
    rot_err_deg = torch.rad2deg(
        torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0, 1.0)))
    trans_err = torch.linalg.vector_norm(combined[..., :, 3], dim=-1)
    return {"rot_deg": rot_err_deg, "trans": trans_err}


def compute_rigid_transform(a: torch.Tensor, b: torch.Tensor,
                            weights: torch.Tensor | None = None,
                            add_eps: float | None = None) -> torch.Tensor:
    """Weighted Kabsch: find T = (R|t) with T*a ~= b.

    a, b: (*, N, 3); weights: (*, N) non-negative (zero for padded rows).
    The weight sum is clamped at 1e-6 and a reflection is fixed by flipping
    the sign of V's last column, chosen by det(V U^T).  Only the rotation is
    defined: LAPACK and cuSOLVER pick different signs for U and V.

    With `add_eps` (GeoTransformer's weighted Procrustes), negative weights
    count as 0 and the weights are divided by their sum plus add_eps.
    """
    if weights is None:
        weights = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    w = weights[..., None]
    if add_eps is None:
        w_norm = w / w.sum(dim=-2, keepdim=True).clamp_min(_EPS)
    else:
        w = torch.where(w > 0, w, 0.0)
        w_norm = w / (w.sum(dim=-2, keepdim=True) + add_eps)
    centroid_a = (a * w_norm).sum(dim=-2, keepdim=True)
    centroid_b = (b * w_norm).sum(dim=-2, keepdim=True)
    cov = (a - centroid_a).transpose(-2, -1) @ ((b - centroid_b) * w_norm)

    # A non-finite covariance gives a NaN pose, as in the JAX package; the
    # SVD itself refuses non-finite input, so it sees zeros there.
    finite = torch.isfinite(cov).all(dim=-1).all(dim=-1)[..., None, None]
    u, _, vh = torch.linalg.svd(torch.where(finite, cov, 0.0))
    v = vh.transpose(-2, -1)
    ut = u.transpose(-2, -1)
    rot_pos = v @ ut
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    rot_neg = (v * flip) @ ut
    det = torch.linalg.det(rot_pos)
    rot = torch.where((det > 0)[..., None, None], rot_pos, rot_neg)
    trans = -rot @ centroid_a.transpose(-2, -1) + centroid_b.transpose(-2, -1)
    return torch.where(finite, torch.cat([rot, trans], dim=-1), float("nan"))


# SO(3) exponential and logarithm maps (counterparts of so3_hat ... so3_log
# in regtr_tpu/core/se3.py).

def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrices."""
    wx, wy, wz = omega.unbind(-1)
    zeros = torch.zeros_like(wx)
    return torch.stack([torch.stack([zeros, -wz, wy], dim=-1),
                        torch.stack([wz, zeros, -wx], dim=-1),
                        torch.stack([-wy, wx, zeros], dim=-1)], dim=-2)


def so3_vee(mat: torch.Tensor) -> torch.Tensor:
    return torch.stack([mat[..., 2, 1], mat[..., 0, 2], mat[..., 1, 0]],
                       dim=-1)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) -> (..., 3, 3)."""
    theta = torch.linalg.vector_norm(omega, dim=-1,
                                     keepdim=True).clamp_min(1e-12)
    k = so3_hat(omega / theta)
    theta = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device).expand(
        k.shape)
    return eye + torch.sin(theta) * k + (1.0 - torch.cos(theta)) * (k @ k)


def so3_log(rot: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) rotation vector."""
    trace = rot[..., 0, 0] + rot[..., 1, 1] + rot[..., 2, 2]
    theta = torch.arccos(torch.clamp(0.5 * (trace - 1.0), -1.0 + 1e-7,
                                     1.0 - 1e-7))[..., None]
    vee = so3_vee(rot - rot.transpose(-1, -2))
    scale = torch.where(theta < 1e-6, 0.5, theta / (2.0 * torch.sin(theta)))
    return scale * vee
