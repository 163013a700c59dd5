"""The weights a run hands to the program and to the reference alike, drawn
from --seed on the run's device in two large calls (a normal and a uniform
draw over every leaf), then cut and scaled leaf by leaf by the rule its
name and shape give:
  * a 2-D weight (out, in): normal with stddev 1 / sqrt(in) (lecun);
  * a KPConv weight (P, Cin, Cout): uniform in +-1 / sqrt(P Cin);
  * InfoNCE's W: normal with stddev 0.1;
  * a LayerNorm's scale: one; every bias: zero.
"""
from __future__ import annotations

import math

import torch


def _kind(name: str, shape) -> str:
    if name.endswith(".W"):
        return "infonce"
    if len(shape) == 3:
        return "kpconv"
    if len(shape) == 2:
        return "linear"
    if name.endswith(".bias"):
        return "zero"
    if len(shape) == 1 and "norm" in name.rsplit(".", 2)[-2]:
        return "one"
    raise ValueError(f"no weight rule for {name} {tuple(shape)}")


def draw(shapes: dict, seed: int, device) -> dict:
    """{name: shape} -> {name: fp32 tensor on device}."""
    kinds = {n: _kind(n, s) for n, s in shapes.items()}
    gen = torch.Generator(device=device).manual_seed(seed)
    numel = {n: math.prod(s) for n, s in shapes.items()}
    n_normal = sum(numel[n] for n, k in kinds.items()
                   if k in ("linear", "infonce"))
    n_uniform = sum(numel[n] for n, k in kinds.items() if k == "kpconv")
    normal = torch.randn(n_normal, generator=gen, device=device)
    uniform = torch.rand(n_uniform, generator=gen, device=device)
    out, at_n, at_u = {}, 0, 0
    for name, shape in shapes.items():
        k, size = kinds[name], numel[name]
        if k == "linear":
            out[name] = normal[at_n:at_n + size].view(shape) / math.sqrt(
                shape[1])
            at_n += size
        elif k == "infonce":
            out[name] = normal[at_n:at_n + size].view(shape) * 0.1
            at_n += size
        elif k == "kpconv":
            bound = 1.0 / math.sqrt(shape[0] * shape[1])
            out[name] = (uniform[at_u:at_u + size].view(shape) * 2.0
                         - 1.0) * bound
            at_u += size
        else:
            out[name] = torch.full(shape, 1.0 if k == "one" else 0.0,
                                   device=device)
    return out
