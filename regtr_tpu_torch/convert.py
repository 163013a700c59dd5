"""Carry parameters between the JAX package and the port.

Input: the flat {"a/b/c": np.ndarray} dict that
`regtr_tpu.train.checkpoints.save_params_npz` writes (np.load of the .npz
works as is).  The port's submodules carry the flax names, so the mapping is:
  * "/" becomes ".";
  * a Dense `kernel` (in, out) becomes a Linear `weight` (out, in);
  * a LayerNorm `scale` becomes `weight`;
  * `bias`, the KPConv `weights` (P, Cin, Cout), a deformable KPConv's
    `offset_weights` (P, Cin, (3 + modulated) P) and `offset_bias`, and the
    InfoNCE matrices `W` (`feature_criterion/W`, `feature_criterion_un/W`)
    keep name and shape.
Any leaf without a counterpart, and any parameter left unfilled, raises.
`jax_params_from_state_dict` is the inverse mapping.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

# leaves that keep their name and shape
_SAME = ("bias", "weights", "W", "offset_weights", "offset_bias")


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
        elif leaf in _SAME:
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


def jax_params_from_state_dict(model: torch.nn.Module
                               ) -> Dict[str, np.ndarray]:
    """The model's parameters in the JAX layout: the flat {"a/b/c": array}
    dict that `state_dict_from_jax` reads (Linear weights transposed back to
    Dense kernels, LayerNorm weights named `scale`)."""
    linear = {f"{n}.weight" for n, m in model.named_modules()
              if isinstance(m, torch.nn.Linear)}
    layer_norm = {f"{n}.weight" for n, m in model.named_modules()
                  if isinstance(m, torch.nn.LayerNorm)}
    flat: Dict[str, np.ndarray] = {}
    for name, t in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        value = t.detach().cpu().numpy()
        if name in linear:
            leaf, value = "kernel", value.T
        elif name in layer_norm:
            leaf = "scale"
        elif leaf not in _SAME:
            raise ValueError(f"no JAX counterpart for {name!r}")
        flat[f"{path.replace('.', '/')}/{leaf}"] = np.ascontiguousarray(value)
    return flat
