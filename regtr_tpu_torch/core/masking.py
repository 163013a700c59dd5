"""Masked-array utilities (counterpart of regtr_tpu/core/masking.py)."""
from __future__ import annotations

import torch

NEG_INF = -1e9  # large-but-finite; avoids NaN from (-inf) - (-inf)


def masked_instance_norm(x: torch.Tensor, mask: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Per-cloud, per-channel normalization over valid points.

    x: (B, N, C), mask: (B, N).  Two-pass biased variance, no affine
    parameters, masked rows set to zero.
    """
    m = mask[..., None].to(x.dtype)
    count = m.sum(dim=-2, keepdim=True).clamp_min(1e-12)
    mean = (x * m).sum(dim=-2, keepdim=True) / count
    var = ((x - mean) ** 2 * m).sum(dim=-2, keepdim=True) / count
    normed = (x - mean) * torch.rsqrt(var + eps)
    return torch.where(mask[..., None], normed, torch.zeros_like(normed))


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor,
                   dim: int = -1) -> torch.Tensor:
    """Softmax over the entries where `mask` is True; rows with no valid
    entry give all zeros, not NaN."""
    masked = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = masked.amax(dim=dim, keepdim=True)
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    return e / e.sum(dim=dim, keepdim=True).clamp_min(1e-20)


def masked_logsumexp(logits: torch.Tensor, mask: torch.Tensor,
                     dim: int = -1) -> torch.Tensor:
    """logsumexp over the entries where `mask` is True; rows with no valid
    entry give NEG_INF."""
    neg = torch.full_like(logits, NEG_INF)
    masked = torch.where(mask, logits, neg)
    m = masked.amax(dim=dim, keepdim=True).clamp_min(NEG_INF)
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    out = m.squeeze(dim) + torch.log(e.sum(dim=dim).clamp_min(1e-30))
    return torch.where(mask.any(dim=dim), out,
                       torch.full_like(out, NEG_INF))
