"""Carry the JAX package's parameters into the port.

Input: the flat {"a/b/c": np.ndarray} dict that
`regtr_tpu.train.checkpoints.save_params_npz` writes (np.load of the .npz
works as is).  The port's submodules carry the flax names, so the mapping is:
  * "/" becomes ".";
  * a Dense `kernel` (in, out) becomes a Linear `weight` (out, in);
  * a LayerNorm `scale` becomes `weight`;
  * `bias`, the KPConv `weights` (P, Cin, Cout) and the InfoNCE matrices
    `W` (`feature_criterion/W`, `feature_criterion_un/W`) keep name and
    shape.
Any leaf without a counterpart, and any parameter left unfilled, raises.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def state_dict_from_jax(flat: Mapping[str, np.ndarray],
                        model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """JAX params (flat slash keys) -> the model's state_dict (CPU tensors)."""
    expected = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    for key in flat:
        path, _, leaf = key.rpartition("/")
        value = np.asarray(flat[key])
        if leaf == "kernel":
            name, value = f"{path}.weight", value.T
        elif leaf == "scale":
            name = f"{path}.weight"
        elif leaf in ("bias", "weights", "W"):
            name = f"{path}.{leaf}"
        else:
            raise ValueError(f"unknown parameter leaf {key!r}")
        name = name.replace("/", ".")
        if name not in expected:
            raise KeyError(f"{key!r} has no counterpart {name!r} in the port")
        if tuple(value.shape) != tuple(expected[name].shape):
            raise ValueError(f"{key!r}: shape {value.shape} != "
                             f"{tuple(expected[name].shape)} for {name!r}")
        out[name] = torch.tensor(value, dtype=expected[name].dtype)
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"{len(missing)} parameters missing from the JAX "
                       f"params: {missing[:5]}")
    return out
