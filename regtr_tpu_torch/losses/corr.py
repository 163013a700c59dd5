"""Correspondence loss (counterpart of regtr_tpu/losses/corr.py): the error
between predicted warped keypoints and the keypoints moved by the GT pose,
weighted by the GT overlap and normalized by the total weight (the global
batch's with several ranks: parallel/dist.py)."""
from __future__ import annotations

import torch

from ..core.se3 import se3_transform
from ..parallel.dist import all_reduce_sum

_EPS = 1e-6


def corr_loss(kp: torch.Tensor, kp_warped_pred: torch.Tensor,
              pose_gt: torch.Tensor, overlap_weights: torch.Tensor,
              metric: str = "mae") -> torch.Tensor:
    """kp (B, N, 3) in their own frame; kp_warped_pred (..., B, N, 3);
    pose_gt (B, 3, 4) from kp's frame to the partner's; overlap_weights
    (B, N) in [0, 1], 0 at padded points -> one loss per leading index."""
    err = kp_warped_pred - se3_transform(pose_gt, kp)
    if metric == "mae":
        err = err.abs().sum(dim=-1)
    elif metric == "mse":
        err = (err * err).sum(dim=-1)
    else:
        raise ValueError(metric)
    w = overlap_weights
    num = (w * err).sum(dim=(-2, -1))
    return num / all_reduce_sum(w.sum(dim=(-2, -1))).clamp_min(_EPS)
