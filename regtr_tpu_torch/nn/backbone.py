"""KPConv encoder backbone (counterpart of KPFEncoder in
regtr_tpu/nn/backbone.py): walks `cfg.architecture` and stacks blocks."""
from __future__ import annotations

from typing import Tuple

import torch.nn as nn

from .blocks import ResnetBottleneckBlock, SimpleBlock


def encoder_plan(cfg) -> Tuple[list, list, list]:
    """Static walk of the architecture strings (same rules as JAX).

    Returns (blocks, skip_block_idxs, skip_dims); each entry of `blocks` is
    (name, in_dim, out_dim, radius, layer_ind).
    """
    r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
    in_dim = cfg["in_feats_dim"]
    out_dim = cfg["first_feats_dim"]
    layer_ind = 0

    blocks, skips, skip_dims = [], [], []
    for block_i, block in enumerate(cfg["architecture"]):
        if any(tag in block for tag in ("pool", "strided", "upsample",
                                        "global")):
            skips.append(block_i)
            skip_dims.append(in_dim)
        if "upsample" in block:
            break
        blocks.append((block, in_dim, out_dim, r, layer_ind))
        in_dim = out_dim // 2 if "simple" in block else out_dim
        if "pool" in block or "strided" in block:
            layer_ind += 1
            r *= 2.0
            out_dim *= 2
    else:
        block_i = len(cfg["architecture"]) - 1
    arch = cfg["architecture"]
    if "upsample" not in arch[min(block_i, len(arch) - 1)]:
        skips.append(block_i)
        skip_dims.append(in_dim)
    return blocks, skips, skip_dims


def encoder_out_dim(cfg) -> int:
    return encoder_plan(cfg)[2][-1]


class KPFEncoder(nn.Module):
    """Stacks Simple/Resnet blocks; returns final features + skip features.

    The first conv block at each (conv|pool, level) computes that table's
    influence geometry; later blocks at the same table reuse it.
    """

    def __init__(self, cfg):
        super().__init__()
        self.plan, self.skips, _ = encoder_plan(cfg)
        self.block_names = []
        for i, (name, in_dim, out_dim, r, li) in enumerate(self.plan):
            if "simple" in name:
                cls = SimpleBlock
            elif "resnetb" in name:
                cls = ResnetBottleneckBlock
            else:
                raise NotImplementedError(f"encoder block {name}: not ported")
            self.add_module(f"block_{i}_{name}",
                            cls(name, in_dim, out_dim, r, li, cfg))
            self.block_names.append(f"block_{i}_{name}")

    def forward(self, x, levels):
        geoms: dict = {}
        skip_x = []
        for i, (name, *_, li) in enumerate(self.plan):
            if i in self.skips:
                skip_x.append(x)
            x, geom = getattr(self, self.block_names[i])(x, levels, geoms)
            if geom is not None:
                geoms[("pool" if "strided" in name else "conv", li)] = geom
        return x, skip_x
