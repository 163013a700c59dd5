"""Model construction (counterpart of regtr_tpu/models/__init__.py).

`create_model` builds the model without drawing from torch's global random
state (the modules are made on the meta device, then materialized), and
fills its parameters from an explicit, seeded `torch.Generator`.  The draws
run on the CPU, so one seed gives the same parameters on any device.  They
are not the JAX package's parameters: to run those, convert them
(regtr_tpu_torch/convert.py) and load the result with `load_state_dict`.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..nn.blocks import KPConvLayer, NormBlock
from ..ops.pyramid import make_pyramid_spec
from .regtr import RegTR

_MODELS = {"regtr.RegTR": RegTR, "RegTR": RegTR}


def init_parameters(model: nn.Module, generator: torch.Generator):
    """Seeded init with flax's defaults: Dense kernels lecun-normal
    (truncated at 2 std), biases zero, LayerNorm scale one, KPConv weights
    U(+-1/sqrt(P*Cin)).  Modules are visited in registration order."""
    def fill(param, draw):
        with torch.no_grad():
            param.copy_(draw(torch.empty(param.shape, dtype=param.dtype)))

    for m in model.modules():
        if isinstance(m, nn.Linear):
            # truncated_normal's std correction for the [-2, 2] cut
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            fill(m.weight, lambda t: nn.init.trunc_normal_(
                t, std=std, a=-2 * std, b=2 * std, generator=generator))
            if m.bias is not None:
                fill(m.bias, torch.zeros_like)
        elif isinstance(m, nn.LayerNorm):
            fill(m.weight, torch.ones_like)
            fill(m.bias, torch.zeros_like)
        elif isinstance(m, KPConvLayer):
            p, cin, _ = m.weights.shape
            bound = 1.0 / math.sqrt(p * cin)
            fill(m.weights, lambda t: nn.init.uniform_(
                t, -bound, bound, generator=generator))
        elif isinstance(m, NormBlock) and not m.use_bn:
            fill(m.bias, torch.zeros_like)


def create_model(cfg, n0_capacity: int, device, seed: int = 0) -> RegTR:
    """Build the model named by cfg['model'] for `n0_capacity` input points
    per cloud, on `device`, with parameters drawn from `seed`."""
    name = cfg.get("model", "regtr.RegTR")
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_MODELS)}")
    spec = make_pyramid_spec(cfg, n0_capacity)
    # TF32 off, process-wide, for every route through the model: the
    # neighbor search expands |q|^2 - 2 q.s + |s|^2, which cancels badly and
    # needs true fp32, and KPConv's bf16-operand contractions run as fp32
    # products and need it too.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = _MODELS[name](cfg, spec)
    model.to_empty(device=torch.device(device))
    for m in model.modules():
        if isinstance(m, KPConvLayer):
            m.reset_kernel_points()
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
