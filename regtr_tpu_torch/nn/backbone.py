"""KPConv encoder backbone and the nearest-upsample decoder (counterparts of
KPFEncoder and KPFDecoder in regtr_tpu/nn/backbone.py): walk
`cfg.architecture` and stack blocks.  RegTR uses the encoder only."""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.kpconv import closest_pool, global_average, max_pool
from .blocks import (ResnetBottleneckBlock, SimpleBlock, UnaryBlock,
                     UnaryBlock2, _tables)


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


def _block_kind(name: str) -> str:
    """The encoder's dispatch on a block name, in the JAX package's order."""
    if "simple" in name or "resnetb" in name:
        return "conv"
    if name in ("unary", "unary2", "global_average"):
        return name
    if "max_pool" in name:
        return "max_pool"
    raise ValueError(f"unsupported encoder block {name}")


class KPFEncoder(nn.Module):
    """Stacks the blocks of the plan (Simple / Resnet KPConv blocks, rigid
    or deformable; unary, unary2, max_pool, global_average); returns the
    final features and the skip features.

    The first rigid conv block at each (conv|pool, level) table computes
    that table's influence geometry and its flat gather ids; later blocks
    at the same table reuse both, and the table's gather transpose is built
    once, at the first backward that needs it (nn/blocks.py `TableState`).
    With `cfg['remat']` (default True) every conv block is recomputed in
    the backward (nn/blocks.py `_conv_block`).
    """

    def __init__(self, cfg):
        super().__init__()
        self.plan, self.skips, _ = encoder_plan(cfg)
        use_bn = cfg.get("use_batch_norm", True)
        self.block_names, self.kinds = [], []
        for i, (name, in_dim, out_dim, r, li) in enumerate(self.plan):
            kind = _block_kind(name)
            if kind == "conv":
                cls = SimpleBlock if "simple" in name else \
                    ResnetBottleneckBlock
                block = cls(name, in_dim, out_dim, r, li, cfg, block_index=i)
            elif kind == "unary":
                block = UnaryBlock(in_dim, out_dim, use_bn)
            elif kind == "unary2":
                block = UnaryBlock2(in_dim, out_dim)
            else:
                block = None        # max_pool, global_average: no parameters
            if block is not None:
                self.add_module(f"block_{i}_{name}", block)
            self.block_names.append(f"block_{i}_{name}")
            self.kinds.append(kind)

    def forward(self, x, levels):
        tables: dict = {}
        skip_x = []
        for i, (name, kind) in enumerate(zip(self.block_names, self.kinds)):
            if i in self.skips:
                skip_x.append(x)
            li = self.plan[i][4]
            if kind == "conv":
                x = getattr(self, name)(x, levels, tables)
            elif kind == "unary":
                x = getattr(self, name)(x, levels[li].mask)
            elif kind == "unary2":
                x = getattr(self, name)(x)
            elif kind == "max_pool":
                x = max_pool(x, _tables(levels, li, True, tables)[2].index)
            else:
                x = global_average(x, levels[li].mask)
        return x, skip_x


class KPFDecoder(nn.Module):
    """Nearest-upsample decoder with skip concatenation, over the blocks of
    `cfg.architecture` from its first `upsample` on: `unary` blocks, and
    `*upsample*` blocks that take each point's nearest coarser point
    (`closest_pool` over the finer level's upsample table).  `in_dim` is
    the encoder's output width and `skip_dims` the widths of its skip
    features, in the encoder's order."""

    def __init__(self, cfg, in_dim: int, skip_dims: Sequence[int]):
        super().__init__()
        arch = cfg["architecture"]
        start = next((i for i, b in enumerate(arch) if "upsample" in b),
                     len(arch))
        self.layer_ind = sum(1 for b in arch[:start]
                             if "pool" in b or "strided" in b)
        self.blocks = list(arch[start:])
        use_bn = cfg.get("use_batch_norm", True)
        dims = list(skip_dims)
        dim = out_dim = in_dim
        for j, block in enumerate(self.blocks):
            if j > 0 and "upsample" in self.blocks[j - 1]:
                dim += dims.pop()
            if block == "unary":
                self.add_module(f"dec_{j}_unary",
                                UnaryBlock(dim, out_dim, use_bn))
                dim = out_dim
            elif "upsample" in block:
                out_dim //= 2
            else:
                raise ValueError(f"unsupported decoder block {block}")

    def forward(self, x, skip_x, levels):
        skip_x = list(skip_x)
        layer_ind = self.layer_ind
        for j, block in enumerate(self.blocks):
            if j > 0 and "upsample" in self.blocks[j - 1]:
                x = torch.cat([x, skip_x.pop()], dim=-1)
            if block == "unary":
                x = getattr(self, f"dec_{j}_unary")(x, levels[layer_ind].mask)
            else:
                x = closest_pool(x, levels[layer_ind - 1].upsamples)
                layer_ind -= 1
        return x
