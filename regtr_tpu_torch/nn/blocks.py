"""KPConv blocks over the dense masked layout (counterpart of
regtr_tpu/nn/blocks.py): rigid and deformable (`*deformable*` block names,
`modulated`) KPConv, per-block kernel dispositions from
`kernel_dispositions_file`, and the unary blocks.

Submodule and parameter names follow the flax names, so that converted
JAX parameters load by name (regtr_tpu_torch/convert.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.masking import masked_instance_norm
from ..ops.kpconv import (GatherIndex, kpconv_apply, kpconv_deformable,
                          kpconv_fused_gather, max_pool)
from ..utils.kernel_points import (load_kernel_points,
                                   lookup_block_dispositions)

LEAKY_SLOPE = 0.1


def compute_dtype(cfg):
    """The one switch to bf16: cfg compute_dtype 'bfloat16' -> torch.bfloat16,
    anything else -> None (fp32 throughout)."""
    return torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


class NormBlock(nn.Module):
    """Masked per-cloud instance norm (use_bn) or a learned bias."""

    def __init__(self, dim: int, use_bn: bool = True):
        super().__init__()
        self.use_bn = use_bn
        if not use_bn:
            self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x, mask):
        if self.use_bn:
            return masked_instance_norm(x, mask)
        return x + self.bias


class UnaryBlock2(nn.Module):
    """Linear(in, in) -> ReLU -> Linear(in, out), both with biases."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.mlp0 = nn.Linear(in_dim, in_dim)
        self.mlp1 = nn.Linear(in_dim, out_dim)

    def forward(self, x, mask=None):
        return self.mlp1(F.relu(self.mlp0(x)))


class UnaryBlock(nn.Module):
    """Linear (no bias) -> norm -> LeakyReLU(0.1)."""

    def __init__(self, in_dim: int, out_dim: int, use_bn: bool = True,
                 no_relu: bool = False):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.norm = NormBlock(out_dim, use_bn)
        self.no_relu = no_relu

    def forward(self, x, mask):
        x = self.norm(self.mlp(x), mask)
        return x if self.no_relu else leaky_relu(x)


class KPConvLayer(nn.Module):
    """The KPConv op with trainable (P, Cin, Cout) weights and fixed,
    deterministic kernel points (a non-persistent buffer).

    Deformable: also `offset_weights` (P, Cin, (3 + modulated) * P) and
    `offset_bias`, the rigid KPConv that predicts the kernel points'
    offsets (ops/kpconv.py `kpconv_deformable`).  The kernel points are
    block `block_index`'s entry of `kernel_file` when it has one (already
    scaled), else the seeded generator's.
    """

    def __init__(self, num_kernel_points: int, in_dim: int, out_dim: int,
                 extent: float, radius: float, influence: str = "linear",
                 aggregation: str = "sum", fixed: str = "center",
                 kernel_seed: int = 0, compute_dtype=None,
                 norm: str = "valid", kernel_method: str = "lloyd",
                 deformable: bool = False, modulated: bool = False,
                 kernel_file: Optional[str] = None,
                 block_index: Optional[int] = None):
        super().__init__()
        self.extent = extent
        self.radius = radius
        self.influence = influence
        self.aggregation = aggregation
        self.fixed = fixed
        self.kernel_seed = kernel_seed
        self.compute_dtype = compute_dtype
        self.norm = norm
        self.kernel_method = kernel_method
        self.deformable = deformable
        self.modulated = modulated
        self.kernel_file = kernel_file
        self.block_index = block_index
        self.weights = nn.Parameter(
            torch.empty(num_kernel_points, in_dim, out_dim))
        if deformable:
            offset_dim = (3 + int(modulated)) * num_kernel_points
            self.offset_weights = nn.Parameter(
                torch.empty(num_kernel_points, in_dim, offset_dim))
            self.offset_bias = nn.Parameter(torch.zeros(offset_dim))
        self.register_buffer("kernel_points", self._dispositions(),
                             persistent=False)

    def _dispositions(self):
        if self.kernel_file and self.block_index is not None:
            disp = lookup_block_dispositions(self.kernel_file,
                                             self.block_index)
            if disp is not None:
                return torch.from_numpy(disp)
        return torch.from_numpy(load_kernel_points(
            self.radius, self.weights.shape[0], 3, self.fixed,
            self.kernel_seed, self.kernel_method))

    def reset_kernel_points(self):
        """Refill the buffer, e.g. after `to_empty` (create_model)."""
        with torch.no_grad():
            self.kernel_points.copy_(self._dispositions())

    def forward(self, q_pts, s_pts, index, x, geom=None, x_extra=None):
        """-> (out, max-pool of x_extra or None, geometry or None).

        `index`: the neighbor table's GatherIndex, shared with the other
        blocks at that table.  With `geom`, reuses the table's influence
        tensor (feature gather only); without it, computes the geometry
        from the gathered neighbors and returns it for those blocks.  A
        deformable layer's kernel points move per query, so it neither
        reuses nor returns a geometry.
        """
        if self.deformable:
            out = kpconv_deformable(
                q_pts, s_pts, index, x, self.kernel_points, self.weights,
                self.offset_weights, self.offset_bias, self.extent,
                influence=self.influence, aggregation=self.aggregation,
                modulated=self.modulated, compute_dtype=self.compute_dtype,
                norm=self.norm)
            pooled = (max_pool(x_extra, index, self.compute_dtype)
                      if x_extra is not None else None)
            return out, pooled, None
        if geom is not None:
            infl, inv_n = geom
            out = kpconv_apply(infl, inv_n, index, x, self.weights,
                               compute_dtype=self.compute_dtype,
                               norm=self.norm)
            pooled = (max_pool(x_extra, index, self.compute_dtype)
                      if x_extra is not None else None)
            return out, pooled, None
        return kpconv_fused_gather(
            q_pts, s_pts, index, x, x_extra, self.kernel_points,
            self.weights, self.extent, influence=self.influence,
            aggregation=self.aggregation, compute_dtype=self.compute_dtype,
            norm=self.norm,
        )


def _kpconv_layer(cfg, in_dim, out_dim, radius, block_name, block_index):
    return KPConvLayer(
        cfg["num_kernel_points"], in_dim, out_dim,
        radius * cfg["KP_extent"] / cfg["conv_radius"], radius,
        influence=cfg.get("KP_influence", "linear"),
        aggregation=cfg.get("aggregation_mode", "sum"),
        fixed=cfg.get("fixed_kernel_points", "center"),
        kernel_seed=cfg.get("kernel_seed", 0),
        compute_dtype=compute_dtype(cfg),
        norm=cfg.get("kpconv_norm", "valid"),
        kernel_method=cfg.get("kernel_point_method", "lloyd"),
        deformable="deform" in block_name,
        modulated=bool(cfg.get("modulated", False)),
        kernel_file=cfg.get("kernel_dispositions_file"),
        block_index=block_index,
    )


@dataclasses.dataclass
class TableState:
    """What the blocks at one (conv | pool, level) neighbor table share: its
    GatherIndex (the table, its flat ids, and its gather transpose, built
    at the first backward that needs it) and its influence geometry, once
    the first block at the table has computed it."""
    index: GatherIndex
    geom: Optional[tuple] = None


def _tables(levels, layer_ind, strided, tables):
    """(query points, output mask, TableState), the state made at the
    table's first block and kept in `tables`."""
    lvl = levels[layer_ind]
    if strided:
        q_lvl = levels[layer_ind + 1]
        q_pts, neigh, mask = q_lvl.points, lvl.pools, q_lvl.mask
    else:
        q_pts, neigh, mask = lvl.points, lvl.neighbors, lvl.mask
    key = ("pool" if strided else "conv", layer_ind)
    if key not in tables:
        tables[key] = TableState(GatherIndex(neigh, lvl.points.shape[1] + 1))
    return q_pts, mask, tables[key]


def _conv_block(block, x, levels, tables):
    """A conv block on its table's shared state: `block.block` on the
    table's GatherIndex and geometry, which the first block at the table
    computes and hands back.  With `block.remat`, under autograd, the block
    runs under a non-reentrant `torch.utils.checkpoint` (the JAX package's
    `nn.remat`): its activations are recomputed in the backward instead of
    kept.  The table's state stays outside the checkpoint, so the
    recompute sees the same inputs: the geometry leaves the block as an
    output instead of being stored by it (a stored one would send the
    recompute down the other path), and the GatherIndex is the same
    object, whose transpose is built once."""
    q_pts, out_mask, table = _tables(levels, block.layer_ind, block.strided,
                                     tables)
    args = (x, q_pts, levels[block.layer_ind].points,
            levels[block.layer_ind].mask, out_mask, table.index, table.geom)
    if block.remat and torch.is_grad_enabled():
        out, geom = checkpoint(block.block, *args, use_reentrant=False)
    else:
        out, geom = block.block(*args)
    table.geom = table.geom or geom
    return out


class SimpleBlock(nn.Module):
    """KPConv(out/2) -> norm -> LeakyReLU.  `cfg['remat']` (default True,
    as the JAX package reads it) recomputes it in the backward."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg,
                 block_index=None):
        super().__init__()
        self.strided = "strided" in block_name
        self.layer_ind = layer_ind
        self.remat = bool(cfg.get("remat", True))
        self.kpconv = _kpconv_layer(cfg, in_dim, out_dim // 2, radius,
                                    block_name, block_index)
        self.norm = NormBlock(out_dim // 2, cfg.get("use_batch_norm", True))

    def forward(self, x, levels, tables):
        return _conv_block(self, x, levels, tables)

    def block(self, x, q_pts, s_pts, in_mask, out_mask, index, geom):
        """-> (output, the table's geometry when this block computed it)."""
        out, _, geom = self.kpconv(q_pts, s_pts, index, x, geom=geom)
        return leaky_relu(self.norm(out, out_mask)), geom


class ResnetBottleneckBlock(nn.Module):
    """unary(out/4) -> KPConv -> norm/relu -> unary(out) + shortcut;
    recomputed in the backward with `cfg['remat']`, as SimpleBlock."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg,
                 block_index=None):
        super().__init__()
        use_bn = cfg.get("use_batch_norm", True)
        self.strided = "strided" in block_name
        self.layer_ind = layer_ind
        self.remat = bool(cfg.get("remat", True))
        mid = out_dim // 4
        self.unary1 = (UnaryBlock(in_dim, mid, use_bn) if in_dim != mid
                       else None)
        self.kpconv = _kpconv_layer(cfg, mid, mid, radius, block_name,
                                    block_index)
        self.norm_conv = NormBlock(mid, use_bn)
        self.unary2 = UnaryBlock(mid, out_dim, use_bn, no_relu=True)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, use_bn,
                                          no_relu=True)
                               if in_dim != out_dim else None)

    def forward(self, x, levels, tables):
        return _conv_block(self, x, levels, tables)

    def block(self, x, q_pts, s_pts, in_mask, out_mask, index, geom):
        """-> (output, the table's geometry when this block computed it)."""
        h = self.unary1(x, in_mask) if self.unary1 is not None else x
        # Strided blocks max-pool the shortcut over the conv's own table.
        h, pooled, geom = self.kpconv(
            q_pts, s_pts, index, h, geom=geom,
            x_extra=x if self.strided else None)
        h = leaky_relu(self.norm_conv(h, out_mask))
        h = self.unary2(h, out_mask)
        # The pooled shortcut is in the compute dtype; a bf16 -> fp32 cast is
        # exact, and the JAX version promotes it to fp32 at the same point.
        shortcut = pooled.float() if self.strided else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return leaky_relu(h + shortcut), geom
