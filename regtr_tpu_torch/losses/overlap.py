"""Overlap loss: binary cross-entropy with logits, the mean over every valid
point of both clouds (counterpart of regtr_tpu/losses/overlap.py).  With
several ranks, the count is the global batch's (parallel/dist.py)."""
from __future__ import annotations

import torch

from ..parallel.dist import all_reduce_sum


def bce_with_logits(logits: torch.Tensor, labels: torch.Tensor
                    ) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits."""
    return (logits.clamp_min(0.0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs())))


def overlap_loss(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """logits, labels in [0, 1] and mask, all (..., N) -> scalar masked mean."""
    elt = bce_with_logits(logits, labels)
    m = mask.to(elt.dtype)
    count = all_reduce_sum(m.sum())         # the global batch's
    return (elt * m).sum() / count.clamp_min(1.0)
