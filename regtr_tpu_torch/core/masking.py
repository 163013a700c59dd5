"""Masked-array utilities (counterpart of regtr_tpu/core/masking.py)."""
from __future__ import annotations

import torch

NEG_INF = -1e9  # large-but-finite; avoids NaN from (-inf) - (-inf)


def lengths_to_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) bool validity mask."""
    return (torch.arange(max_len, device=lengths.device)[None, :]
            < lengths[:, None])


def masked_mean(x: torch.Tensor, mask: torch.Tensor, dim,
                keepdim: bool = False, eps: float = 1e-12) -> torch.Tensor:
    """Mean of x over `dim` counting only the entries where `mask` (which
    broadcasts against x) is True."""
    mask = mask.to(x.dtype)
    total = (x * mask).sum(dim=dim, keepdim=keepdim)
    count = mask.sum(dim=dim, keepdim=keepdim)
    return total / count.clamp_min(eps)


def masked_var(x: torch.Tensor, mask: torch.Tensor, dim,
               keepdim: bool = False, eps: float = 1e-12) -> torch.Tensor:
    """Biased variance over the valid entries (torch InstanceNorm's)."""
    mean = masked_mean(x, mask, dim, keepdim=True, eps=eps)
    return masked_mean((x - mean) ** 2, mask, dim, keepdim=keepdim, eps=eps)


def masked_instance_norm(x: torch.Tensor, mask: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    """Per-cloud, per-channel normalization over valid points.

    x: (B, N, C), mask: (B, N).  Two-pass biased variance, no affine
    parameters, masked rows set to zero.
    """
    m = mask[..., None]
    mean = masked_mean(x, m, dim=-2, keepdim=True)
    var = masked_mean((x - mean) ** 2, m, dim=-2, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return torch.where(m, normed, torch.zeros_like(normed))


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


def masked_max(x: torch.Tensor, mask: torch.Tensor, dim: int,
               initial: float = 0.0) -> torch.Tensor:
    """Max over the valid entries; where none is valid, `initial`."""
    filled = torch.where(mask, x, torch.full_like(x, NEG_INF))
    return torch.where(mask.any(dim=dim), filled.amax(dim=dim),
                       torch.full((), initial, dtype=x.dtype,
                                  device=x.device))
