"""Positional embeddings over 3-D coordinates (counterparts of
PositionEmbeddingCoordsSine and PositionEmbeddingLearned in
regtr_tpu/nn/pos_embed.py)."""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F


class PositionEmbeddingCoordsSine(nn.Module):
    def __init__(self, n_dim: int = 3, d_model: int = 256,
                 temperature: float = 10000.0, scale: float = 1.0):
        super().__init__()
        self.n_dim = n_dim
        self.d_model = d_model
        self.temperature = temperature
        self.scale = scale * 2.0 * math.pi

    def forward(self, xyz):
        """xyz (*, n_dim) -> (*, d_model); zero-padded remainder."""
        num_feats = self.d_model // self.n_dim // 2 * 2
        padding = self.d_model - num_feats * self.n_dim
        dim_t = torch.arange(num_feats, dtype=torch.float32, device=xyz.device)
        dim_t = self.temperature ** (2.0 * torch.floor(dim_t / 2.0)
                                     / num_feats)
        pos_divided = (xyz * self.scale)[..., None] / dim_t
        emb = torch.stack([torch.sin(pos_divided[..., 0::2]),
                           torch.cos(pos_divided[..., 1::2])], dim=-1)
        emb = emb.reshape(xyz.shape[:-1] + (-1,))
        return F.pad(emb, (0, padding)) if padding else emb


class PositionEmbeddingLearned(nn.Module):
    """An MLP of widths 32, 64, 128, 256 with ReLUs, then a linear layer to
    d_model.  The layers carry flax's automatic names, Dense_0 ... Dense_4,
    so that converted parameters load by name."""

    _WIDTHS = (32, 64, 128, 256)

    def __init__(self, n_dim: int = 3, d_model: int = 256):
        super().__init__()
        dims = (n_dim,) + self._WIDTHS + (d_model,)
        for i in range(len(dims) - 1):
            self.add_module(f"Dense_{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, xyz):
        h = xyz
        for i in range(len(self._WIDTHS)):
            h = F.relu(getattr(self, f"Dense_{i}")(h))
        return getattr(self, f"Dense_{len(self._WIDTHS)}")(h)
