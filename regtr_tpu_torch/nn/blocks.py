"""KPConv blocks over the dense masked layout (counterpart of
regtr_tpu/nn/blocks.py, rigid path).

Submodule and parameter names follow the flax names, so that converted
JAX parameters load by name (regtr_tpu_torch/convert.py).
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from regtr_tpu.utils.kernel_points import load_kernel_points

from ..core.masking import masked_instance_norm
from ..ops.kpconv import kpconv_apply, kpconv_fused_gather, max_pool

LEAKY_SLOPE = 0.1


def compute_dtype(cfg):
    """The one switch to bf16: cfg compute_dtype 'bfloat16' -> torch.bfloat16,
    anything else -> None (fp32 throughout)."""
    return torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def _unsupported(cfg, block_name):
    if "deform" in block_name:
        raise NotImplementedError(f"deformable block {block_name}: not ported")
    if cfg.get("kernel_dispositions_file"):
        raise NotImplementedError("kernel_dispositions_file: not ported")


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
    deterministic kernel points (a non-persistent buffer)."""

    def __init__(self, num_kernel_points: int, in_dim: int, out_dim: int,
                 extent: float, radius: float, influence: str = "linear",
                 aggregation: str = "sum", fixed: str = "center",
                 kernel_seed: int = 0, compute_dtype=None,
                 norm: str = "valid", kernel_method: str = "lloyd"):
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
        self.weights = nn.Parameter(
            torch.empty(num_kernel_points, in_dim, out_dim))
        self.register_buffer("kernel_points", self._dispositions(),
                             persistent=False)

    def _dispositions(self):
        return torch.from_numpy(load_kernel_points(
            self.radius, self.weights.shape[0], 3, self.fixed,
            self.kernel_seed, self.kernel_method))

    def reset_kernel_points(self):
        """Refill the buffer, e.g. after `to_empty` (create_model)."""
        with torch.no_grad():
            self.kernel_points.copy_(self._dispositions())

    def forward(self, q_pts, s_pts, neighb_inds, x, geom=None, x_extra=None):
        """-> (out, max-pool of x_extra or None, geometry or None).

        With `geom`, reuses a level's influence tensor (feature gather
        only); without it, computes the geometry from the gathered
        neighbors and returns it for later blocks at the same level.
        """
        if geom is not None:
            infl, inv_n = geom
            out = kpconv_apply(infl, inv_n, neighb_inds, x, self.weights,
                               compute_dtype=self.compute_dtype,
                               norm=self.norm)
            pooled = (max_pool(x_extra, neighb_inds, self.compute_dtype)
                      if x_extra is not None else None)
            return out, pooled, None
        return kpconv_fused_gather(
            q_pts, s_pts, neighb_inds, x, x_extra, self.kernel_points,
            self.weights, self.extent, influence=self.influence,
            aggregation=self.aggregation, compute_dtype=self.compute_dtype,
            norm=self.norm,
        )


def _kpconv_layer(cfg, in_dim, out_dim, radius):
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
    )


def _tables(levels, layer_ind, strided):
    """(query points, neighbor table, output mask, geometry key)."""
    lvl = levels[layer_ind]
    if strided:
        q_lvl = levels[layer_ind + 1]
        return q_lvl.points, lvl.pools, q_lvl.mask, ("pool", layer_ind)
    return lvl.points, lvl.neighbors, lvl.mask, ("conv", layer_ind)


class SimpleBlock(nn.Module):
    """KPConv(out/2) -> norm -> LeakyReLU."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg):
        super().__init__()
        _unsupported(cfg, block_name)
        self.strided = "strided" in block_name
        self.layer_ind = layer_ind
        self.kpconv = _kpconv_layer(cfg, in_dim, out_dim // 2, radius)
        self.norm = NormBlock(out_dim // 2, cfg.get("use_batch_norm", True))

    def forward(self, x, levels, geoms):
        q_pts, neigh, out_mask, key = _tables(levels, self.layer_ind,
                                              self.strided)
        out, _, new_geom = self.kpconv(q_pts, levels[self.layer_ind].points,
                                       neigh, x, geom=geoms.get(key))
        return leaky_relu(self.norm(out, out_mask)), new_geom


class ResnetBottleneckBlock(nn.Module):
    """unary(out/4) -> KPConv -> norm/relu -> unary(out) + shortcut."""

    def __init__(self, block_name, in_dim, out_dim, radius, layer_ind, cfg):
        super().__init__()
        _unsupported(cfg, block_name)
        use_bn = cfg.get("use_batch_norm", True)
        self.strided = "strided" in block_name
        self.layer_ind = layer_ind
        mid = out_dim // 4
        self.unary1 = (UnaryBlock(in_dim, mid, use_bn) if in_dim != mid
                       else None)
        self.kpconv = _kpconv_layer(cfg, mid, mid, radius)
        self.norm_conv = NormBlock(mid, use_bn)
        self.unary2 = UnaryBlock(mid, out_dim, use_bn, no_relu=True)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, use_bn,
                                          no_relu=True)
                               if in_dim != out_dim else None)

    def forward(self, x, levels, geoms):
        q_pts, neigh, out_mask, key = _tables(levels, self.layer_ind,
                                              self.strided)
        in_mask = levels[self.layer_ind].mask
        h = self.unary1(x, in_mask) if self.unary1 is not None else x
        # Strided blocks max-pool the shortcut over the conv's own table.
        h, pooled, new_geom = self.kpconv(
            q_pts, levels[self.layer_ind].points, neigh, h,
            geom=geoms.get(key), x_extra=x if self.strided else None)
        h = leaky_relu(self.norm_conv(h, out_mask))
        h = self.unary2(h, out_mask)
        # The pooled shortcut is in the compute dtype; a bf16 -> fp32 cast is
        # exact, and the JAX version promotes it to fp32 at the same point.
        shortcut = pooled.float() if self.strided else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return leaky_relu(h + shortcut), new_geom
