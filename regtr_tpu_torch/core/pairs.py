"""Paired-cloud batch layout (counterpart of regtr_tpu/core/pairs.py).

A batch of B registration pairs is stored as 2B clouds INTERLEAVED:
slot 2i = source of pair i, slot 2i+1 = target of pair i.
"""
from __future__ import annotations

import torch


def interleave_pairs(src: torch.Tensor, tgt: torch.Tensor,
                     dim: int = 0) -> torch.Tensor:
    """(B, ...) x2 -> (2B, ...) with each pair's clouds adjacent."""
    stacked = torch.stack([src, tgt], dim=dim + 1)
    shape = list(stacked.shape)
    shape[dim:dim + 2] = [shape[dim] * 2]
    return stacked.reshape(shape)


def split_pairs(x: torch.Tensor, dim: int = 0):
    """(2B, ...) -> (src (B, ...), tgt (B, ...))."""
    shape = list(x.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    y = x.reshape(shape)
    return y.select(dim + 1, 0), y.select(dim + 1, 1)


def swap_pairs(x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """(2B, ...) -> (2B, ...) with each cloud replaced by its partner."""
    shape = list(x.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    return x.reshape(shape).flip(dim + 1).reshape(x.shape)
