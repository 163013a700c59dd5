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
