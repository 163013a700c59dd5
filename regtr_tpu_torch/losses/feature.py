"""InfoNCE feature loss with a learned symmetric bilinear similarity
(counterpart of InfoNCELoss in regtr_tpu/losses/feature.py).  The circle
losses of the JAX package are not ported."""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.masking import masked_logsumexp

_INF = 1.0e9


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances >= 0."""
    a_sq = (a * a).sum(dim=-1)[..., :, None]
    b_sq = (b * b).sum(dim=-1)[..., None, :]
    return (a_sq - 2.0 * (a @ b.transpose(-1, -2)) + b_sq).clamp_min(0.0)


class InfoNCELoss(nn.Module):
    """Masked InfoNCE.  For each valid anchor whose nearest point of the
    positive cloud (under the GT alignment) lies within r_p, the positive is
    that point; every other point within r_n is left out of the denominator.

    `W` is a trained (d, d) parameter, drawn at init from a normal of
    stddev 0.1 (models/__init__.py), as flax draws it.
    """

    def __init__(self, d_embed: int, r_p: float, r_n: float):
        super().__init__()
        self.r_p = r_p
        self.r_n = r_n
        self.W = nn.Parameter(torch.empty(d_embed, d_embed))

    def forward(self, anchor_feat, positive_feat, anchor_xyz, positive_xyz,
                anchor_mask, positive_mask):
        """anchor_feat (B, Na, D), positive_feat (B, Np, D), anchor_xyz
        (B, Na, 3) already GT-aligned, positive_xyz (B, Np, 3), masks
        (B, Na) / (B, Np) -> scalar, the mean over pairs."""
        w_triu = torch.triu(self.W)
        w_sym = w_triu + w_triu.t()
        logits = (anchor_feat.float() @ w_sym) @ positive_feat.float(
        ).transpose(-1, -2)                                  # (B, Na, Np)

        sqd = pairwise_sqdist(anchor_xyz, positive_xyz)
        sqd = torch.where(positive_mask[:, None, :], sqd, _INF)
        idx1 = sqd.argmin(dim=-1)                           # (B, Na)
        d1 = sqd.gather(-1, idx1[..., None])[..., 0]
        match_mask = (d1 < self.r_p ** 2) & anchor_mask

        pos_onehot = (torch.arange(logits.shape[-1], device=logits.device)
                      == idx1[..., None])
        ignore = (sqd < self.r_n ** 2) & ~pos_onehot
        keep = ~ignore & positive_mask[:, None, :]

        pos_logit = logits.gather(-1, idx1[..., None])[..., 0]
        per_anchor = masked_logsumexp(logits, keep, dim=-1) - pos_logit
        m = match_mask.to(torch.float32)
        per_pair = (per_anchor * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)
        return per_pair.mean()
