"""Parameters in the flat .npz interchange format (the port's counterpart
of `save_params_npz` / `load_params_npz` in regtr_tpu/train/checkpoints.py).

The archive holds one array per parameter under JAX's 'a/b/c' keys (the
format tools/convert_torch_ckpt.py writes too), so the JAX package and the
port read each other's files.  The JAX package's orbax checkpoint
directories need orbax, and the port's own checkpoints (with optimizer
state) come with the trainer (ROADMAP.md Queue A 10).
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..convert import jax_params_from_state_dict, state_dict_from_jax

logger = logging.getLogger("regtr_tpu_torch")


def save_params_npz(path, model: torch.nn.Module) -> None:
    """Write the model's parameters in the JAX layout."""
    np.savez(path, **jax_params_from_state_dict(model))


def load_params_npz(path, model: torch.nn.Module) -> torch.nn.Module:
    """Load a flat .npz into the model, in place; returns the model.

    As in the JAX package, a parameter missing from the archive keeps the
    model's value with a warning (a converted reference checkpoint may lack
    the loss's parameters), and an archive missing more than half of them
    raises: it belongs to another configuration.  A key with no counterpart
    in the model raises too.
    """
    flat = jax_params_from_state_dict(model)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}
    missing = sorted(set(flat) - set(stored))
    if len(missing) > 0.5 * len(flat):
        raise ValueError(
            f"{path} matches only {len(flat) - len(missing)}/{len(flat)} "
            f"params of this model: wrong config or checkpoint? (first "
            f"missing: {missing[:3]})")
    if missing:
        logger.warning("%d params not in %s (kept init values): %s%s",
                       len(missing), path, ", ".join(missing[:5]),
                       "..." if len(missing) > 5 else "")
    flat.update(stored)
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model
