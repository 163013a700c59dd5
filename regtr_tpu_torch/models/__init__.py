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

from ..losses.feature import InfoNCELoss
from ..nn.blocks import KPConvLayer, NormBlock
from ..nn.geotransformer import PairGroupNorm
from ..nn.matching import LogOptimalTransport
from ..ops.pyramid import make_pyramid_spec
from .geotransformer import GeoTransformer
from .regtr import RegTR

_MODELS = {"regtr.RegTR": RegTR, "RegTR": RegTR,
           "geotransformer.GeoTransformer": GeoTransformer}


def register_model(name: str, cls):
    """Make `cls` the model that cfg['model'] == name builds."""
    _MODELS[name] = cls


def get_model(name: str):
    """The model class registered under `name`."""
    if name not in _MODELS:
        raise ValueError(f"unknown model {name!r}; available: "
                         f"{sorted(_MODELS)}")
    return _MODELS[name]


def init_parameters(model: nn.Module, generator: torch.Generator):
    """Seeded init with flax's defaults: Dense kernels lecun-normal
    (truncated at 2 std), biases zero, LayerNorm scale one, KPConv weights
    and deformable offset weights U(+-1/sqrt(P*Cin)), offset biases zero,
    the InfoNCE W normal with stddev 0.1; GroupNorm's scale one and bias
    zero, the optimal transport's 0-D `alpha` one (torch's and upstream's
    initial values; neither draws).  Modules are visited in registration
    order."""
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
            if m.deformable:
                fill(m.offset_weights, lambda t: nn.init.uniform_(
                    t, -bound, bound, generator=generator))
                fill(m.offset_bias, torch.zeros_like)
        elif isinstance(m, NormBlock) and not m.use_bn:
            fill(m.bias, torch.zeros_like)
        elif isinstance(m, InfoNCELoss):
            fill(m.W, lambda t: nn.init.normal_(t, 0.0, 0.1,
                                                generator=generator))
        elif isinstance(m, PairGroupNorm):
            fill(m.weight, torch.ones_like)
            fill(m.bias, torch.zeros_like)
        elif isinstance(m, LogOptimalTransport):
            fill(m.alpha, torch.ones_like)


def create_model(cfg, n0_capacity: int, device, seed: int = 0) -> nn.Module:
    """Build the model registered under cfg['model'] (default RegTR:
    `regtr.RegTR`; also `geotransformer.GeoTransformer`) for `n0_capacity`
    input points per cloud, on `device`, with parameters drawn from
    `seed`."""
    cls = get_model(cfg.get("model", "regtr.RegTR"))
    spec = make_pyramid_spec(cfg, n0_capacity)
    # TF32 off, process-wide, for every route through the model: the
    # neighbor search expands |q|^2 - 2 q.s + |s|^2, which cancels badly and
    # needs true fp32, and KPConv's bf16-operand contractions run as fp32
    # products and need it too.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.device("meta"):
        model = cls(cfg, spec)
    model.to_empty(device=torch.device(device))
    for m in model.modules():
        if isinstance(m, KPConvLayer):
            m.reset_kernel_points()
    init_parameters(model, torch.Generator().manual_seed(seed))
    return model.eval()
