"""Carry parameters into the port: from the JAX package, and from an
upstream (reference) RegTR checkpoint.

The JAX package's parameters:

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

An upstream checkpoint's state_dict: `state_dict_from_reference` maps it
straight to the port's state_dict (the mapping of the JAX package's
tools/convert_torch_ckpt.py, with no flax tree between), and
`reference_kernel_points` takes its per-block kernel dispositions, which
`kernel_dispositions_file` reads (python -m
regtr_tpu_torch.convert_checkpoint writes both).
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .nn.backbone import encoder_plan

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


def _numpy(value) -> np.ndarray:
    if hasattr(value, "detach"):
        value = value.detach().cpu().numpy()
    return np.asarray(value)


def state_dict_from_reference(sd: Mapping, cfg) -> Dict[str, torch.Tensor]:
    """An upstream RegTR state_dict (the model of `cfg`) -> the port's
    state_dict entries it fills, fp32 CPU tensors.

    The mapping: the encoder's blocks by the port's `encoder_plan`
    (KPConv weights, the deformable `offset_conv` branch, the unary
    Linears); the transformer's packed `in_proj_weight` / `in_proj_bias`
    split into q, k and v, `out_proj`, `linear1`, `linear2`, `norm1..3`
    and the final norm; the head (`coor_mlp`, or the attention decoder's
    q / k projections) and `conf_logits`; the InfoNCE `W` of both criteria
    where the checkpoint has them.  Linear weights keep their (out, in)
    layout.  The checkpoint's kernel dispositions are not parameters of
    the port (`reference_kernel_points`); any other key the mapping does
    not know raises.  A parameter the checkpoint lacks (a loss's `W`) is
    left to the caller.
    """
    out: Dict[str, torch.Tensor] = {}
    used = set()

    def put(name, key, rows=slice(None)):
        used.add(key)
        out[name] = torch.tensor(np.asarray(_numpy(sd[key])[rows],
                                            np.float32))

    for i, (name, *_) in enumerate(encoder_plan(cfg)[0]):
        src = f"kpf_encoder.encoder_blocks.{i}"
        dst = f"kpf_encoder.block_{i}_{name}"
        if f"{src}.KPConv.offset_conv.weights" in sd:
            put(f"{dst}.kpconv.offset_weights",
                f"{src}.KPConv.offset_conv.weights")
            put(f"{dst}.kpconv.offset_bias", f"{src}.KPConv.offset_bias")
        if "simple" in name or "resnetb" in name:
            put(f"{dst}.kpconv.weights", f"{src}.KPConv.weights")
        if "resnetb" in name:
            for unary in ("unary1", "unary2", "unary_shortcut"):
                key = f"{src}.{unary}.mlp.weight"
                if unary == "unary2" or key in sd:
                    put(f"{dst}.{unary}.mlp.weight", key)

    for leaf in ("weight", "bias"):
        put(f"feat_proj.{leaf}", f"feat_proj.{leaf}")
    d = cfg["d_embed"]
    for layer in range(cfg["num_encoder_layers"]):
        src = f"transformer_encoder.layers.{layer}"
        dst = f"transformer_encoder.layer_{layer}"
        for attn, mine in (("self_attn", "self_attn"),
                           ("multihead_attn", "cross_attn")):
            for j, proj in enumerate(("q_proj", "k_proj", "v_proj")):
                rows = slice(j * d, (j + 1) * d)
                put(f"{dst}.{mine}.{proj}.weight",
                    f"{src}.{attn}.in_proj_weight", rows)
                put(f"{dst}.{mine}.{proj}.bias",
                    f"{src}.{attn}.in_proj_bias", rows)
            for leaf in ("weight", "bias"):
                put(f"{dst}.{mine}.out_proj.{leaf}",
                    f"{src}.{attn}.out_proj.{leaf}")
        for module in ("linear1", "linear2", "norm1", "norm2", "norm3"):
            for leaf in ("weight", "bias"):
                put(f"{dst}.{module}.{leaf}", f"{src}.{module}.{leaf}")
    if "transformer_encoder.norm.weight" in sd:
        for leaf in ("weight", "bias"):
            put(f"transformer_encoder.norm_final.{leaf}",
                f"transformer_encoder.norm.{leaf}")

    dec = "correspondence_decoder"
    if f"{dec}.coor_mlp.0.weight" in sd:
        heads = [(f"coor_mlp{n}", f"coor_mlp.{j}")
                 for n, j in enumerate((0, 2, 4))]
    else:       # the attention decoder
        heads = [("q_proj", "q_proj"), ("k_proj", "k_proj")]
    heads.append(("conf_logits", "conf_logits_decoder"))
    for mine, theirs in heads:
        for leaf in ("weight", "bias"):
            put(f"head.{mine}.{leaf}", f"{dec}.{theirs}.{leaf}")
    for crit in ("feature_criterion", "feature_criterion_un"):
        if f"{crit}.W" in sd:
            put(f"{crit}.W", f"{crit}.W")

    unknown = sorted(k for k in sd if k not in used
                     and not k.endswith("kernel_points"))
    if unknown:
        raise KeyError(f"{len(unknown)} checkpoint keys the mapping does "
                       f"not know: {unknown[:5]}")
    return out


def reference_kernel_points(sd: Mapping) -> Dict[str, np.ndarray]:
    """The checkpoint's per-block kernel dispositions (its keys ending in
    `kernel_points`, already scaled by each block's radius), for an .npz
    that `kernel_dispositions_file` reads."""
    return {k: _numpy(v) for k, v in sd.items()
            if k.endswith("kernel_points")}
