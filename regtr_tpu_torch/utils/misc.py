"""Small host-side helpers (the port's counterpart of regtr_tpu/utils/misc.py,
itself after the upstream torch helpers): conversions of nested containers
of tensors, seeding, and metric formatting.

A nested container is any mix of dicts, lists and tuples; every other value
is a leaf.
"""
from __future__ import annotations

import random
from typing import Any, Callable

import numpy as np
import torch


def tree_map(fn: Callable, tree: Any):
    """fn applied to every leaf of a nested container, its structure
    kept."""
    if isinstance(tree, dict):
        return type(tree)((k, tree_map(fn, v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):   # namedtuple
        return type(tree)(*(tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a nested container, in its order."""
    leaves = []
    tree_map(leaves.append, tree)
    return leaves


def to_numpy(tree: Any):
    """Every tensor of a nested container as a numpy array on the host
    (bf16 as fp32, which numpy lacks); other leaves as they are."""
    def conv(x):
        if torch.is_tensor(x):
            x = x.detach()
            if x.dtype == torch.bfloat16:
                x = x.float()
            return x.cpu().numpy()
        return x

    return tree_map(conv, tree)


def all_to_device(tree: Any, device):
    """Every tensor and numpy array of a nested container as a tensor on
    `device`; other leaves as they are."""
    def move(x):
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return x.to(device) if torch.is_tensor(x) else x

    return tree_map(move, tree)


def all_isfinite(tree: Any) -> bool:
    """Whether every floating-point leaf (tensor, array or float) is
    finite everywhere."""
    for leaf in tree_leaves(tree):
        if torch.is_tensor(leaf):
            if leaf.is_floating_point() and not bool(
                    torch.isfinite(leaf).all()):
                return False
        elif np.asarray(leaf).dtype.kind == "f" and not np.all(
                np.isfinite(np.asarray(leaf))):
            return False
    return True


def setup_seed(seed: int, cudnn_deterministic: bool = True):
    """Seed the host's random generators and torch's global ones (the
    port's own randomness is explicit: seeded generators)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    if cudnn_deterministic:
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False


def metrics_to_string(metrics: dict, prefix: str = "") -> str:
    """'k: v | ...' over the scalar metrics, in sorted key order."""
    parts = []
    for k in sorted(metrics):
        arr = to_numpy(metrics[k])
        arr = np.asarray(arr)
        if arr.ndim == 0:
            parts.append(f"{k}: {float(arr):.4g}")
    return (prefix + " " if prefix else "") + " | ".join(parts)


def lengths_to_batch_indices(lengths):
    """[3, 2] -> [0, 0, 0, 1, 1]: a tensor for a tensor, else an array."""
    if torch.is_tensor(lengths):
        return torch.repeat_interleave(
            torch.arange(len(lengths), device=lengths.device), lengths)
    return np.repeat(np.arange(len(lengths)), np.asarray(lengths))
