"""SE(3) helpers and the weighted Kabsch solver (counterpart of
regtr_tpu/core/se3.py).  Poses are (..., 3, 4) matrices (rotation | t)."""
from __future__ import annotations

import torch

_EPS = 1e-6


def se3_inv(pose: torch.Tensor) -> torch.Tensor:
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    irot = rot.transpose(-1, -2)
    return torch.cat([irot, -irot @ trans], dim=-1)


def se3_transform(pose: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """Apply pose (..., 3, 4) to points (..., N, 3) -> (..., N, 3)."""
    rot, trans = pose[..., :3, :3], pose[..., :3, 3:4]
    return xyz @ rot.transpose(-1, -2) + trans.transpose(-1, -2)


def compute_rigid_transform(a: torch.Tensor, b: torch.Tensor,
                            weights: torch.Tensor | None = None
                            ) -> torch.Tensor:
    """Weighted Kabsch: find T = (R|t) with T*a ~= b.

    a, b: (*, N, 3); weights: (*, N) non-negative (zero for padded rows).
    The weight sum is clamped at 1e-6 and a reflection is fixed by flipping
    the sign of V's last column, chosen by det(V U^T).  Only the rotation is
    defined: LAPACK and cuSOLVER pick different signs for U and V.
    """
    if weights is None:
        weights = torch.ones(a.shape[:-1], dtype=a.dtype, device=a.device)
    w = weights[..., None]
    w_norm = w / w.sum(dim=-2, keepdim=True).clamp_min(_EPS)
    centroid_a = (a * w_norm).sum(dim=-2, keepdim=True)
    centroid_b = (b * w_norm).sum(dim=-2, keepdim=True)
    cov = (a - centroid_a).transpose(-2, -1) @ ((b - centroid_b) * w_norm)

    u, _, vh = torch.linalg.svd(cov)
    v = vh.transpose(-2, -1)
    ut = u.transpose(-2, -1)
    rot_pos = v @ ut
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    rot_neg = (v * flip) @ ut
    det = torch.linalg.det(rot_pos)
    rot = torch.where((det > 0)[..., None, None], rot_pos, rot_neg)
    trans = -rot @ centroid_a.transpose(-2, -1) + centroid_b.transpose(-2, -1)
    return torch.cat([rot, trans], dim=-1)
