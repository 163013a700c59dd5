"""GeoTransformer's networks (Qin et al., "Geometric Transformer for Fast
and Robust Point Cloud Registration", CVPR 2022) over the port's pyramid:
the KPConv-FPN backbone with group norm over each pair, the geometric
structure embedding and the geometric transformer.

Layout as RegTR's: 2B clouds, pairs interleaved (slot 2i the source of
pair i, upstream's `src`; slot 2i + 1 its target, upstream's `ref`).

* The backbone runs on the pyramid's tables (ops/pyramid.py) through the
  rigid KPConv of nn/blocks.py (K5a's gathers), with `kpconv_norm:
  legacy`: the summed output over the count of neighbours whose feature
  sum is positive.  Its group norm takes its statistics over the valid
  points of both clouds of a pair, as upstream's stack mode (the pair's
  points in one tensor) gives.
* The embedding and the self-attention run at an extent M of the coarse
  level that holds the batch's valid superpoints (models/geotransformer.py
  `embed`), never at the level's capacity: an (M, M, 256) tensor a cloud.
  Valid superpoints are a prefix of each cloud, so this is exact: padded
  keys are masked.
* The cross-attention is nn/transformer.py's MultiHeadAttention (K1 at
  d_head 64 with key extents).  A cross block updates the target
  (upstream's cloud 0, `ref`) first, then the source from the updated
  target (upstream's `parallel=False`).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..core.masking import NEG_INF
from ..ops.geo_embedding import geo_embedding, pair_offsets
from ..ops.kpconv import closest_pool
from .blocks import _conv_block, _kpconv_layer, leaky_relu
from .matching import nearest_first
from .transformer import MultiHeadAttention

GN_EPS = 1e-5       # torch.nn.GroupNorm's, as upstream
LN_EPS = 1e-5       # torch.nn.LayerNorm's, as upstream


class PairGroupNorm(nn.Module):
    """GroupNorm with statistics over the valid points of both clouds of a
    pair (adjacent slots), biased variance, an affine per channel; zero at
    masked points.  x (2B, N, C), mask (2B, N)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.empty(num_channels))
        self.bias = nn.Parameter(torch.empty(num_channels))

    def forward(self, x, mask):
        b2, n, c = x.shape
        g = self.num_groups
        xs = x.reshape(b2 // 2, 2 * n, g, c // g)
        m = mask.reshape(b2 // 2, 2 * n, 1, 1).to(x.dtype)
        count = (m.sum(dim=1, keepdim=True) * (c // g)).clamp_min(1.0)
        mean = (xs * m).sum(dim=(1, 3), keepdim=True) / count
        var = (((xs - mean) ** 2) * m).sum(dim=(1, 3), keepdim=True) / count
        normed = ((xs - mean) * torch.rsqrt(var + GN_EPS)).reshape(b2, n, c)
        return torch.where(mask[..., None], normed * self.weight + self.bias,
                           0.0)


class UnaryBlock(nn.Module):
    """Linear (with bias) -> pair group norm -> LeakyReLU(0.1), the last
    optional."""

    def __init__(self, in_dim: int, out_dim: int, groups: int,
                 relu: bool = True):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim)
        self.norm = PairGroupNorm(groups, out_dim)
        self.relu = relu

    def forward(self, x, mask):
        x = self.norm(self.mlp(x), mask)
        return leaky_relu(x) if self.relu else x


class ConvBlock(nn.Module):
    """KPConv (no bias) -> pair group norm -> LeakyReLU, at level
    `layer_ind`'s neighbour table."""

    strided = False

    def __init__(self, cfg, in_dim, out_dim, radius, layer_ind):
        super().__init__()
        self.layer_ind = layer_ind
        self.remat = bool(cfg.get("remat", False))
        self.KPConv = _kpconv_layer(cfg, in_dim, out_dim, radius, "simple",
                                    None)
        self.norm = PairGroupNorm(cfg["group_norm"], out_dim)

    def forward(self, x, levels, tables):
        return _conv_block(self, x, levels, tables)

    def block(self, x, q_pts, s_pts, in_mask, out_mask, index, geom):
        out, _, geom = self.KPConv(q_pts, s_pts, index, x, geom=geom)
        return leaky_relu(self.norm(out, out_mask)), geom


class ResidualBlock(nn.Module):
    """unary1 (to out/4, unless the width is already that) -> KPConv (no
    bias) -> norm -> LeakyReLU -> unary2 (to out, no ReLU), plus the
    shortcut (max over the pool table's neighbours, zero row as padding,
    when strided; then a unary without ReLU where the widths differ);
    LeakyReLU of the sum."""

    def __init__(self, cfg, in_dim, out_dim, radius, layer_ind,
                 strided=False):
        super().__init__()
        groups = cfg["group_norm"]
        mid = out_dim // 4
        self.strided = strided
        self.layer_ind = layer_ind
        self.remat = bool(cfg.get("remat", False))
        self.unary1 = (UnaryBlock(in_dim, mid, groups) if in_dim != mid
                       else None)
        self.KPConv = _kpconv_layer(cfg, mid, mid, radius, "resnetb", None)
        self.norm_conv = PairGroupNorm(groups, mid)
        self.unary2 = UnaryBlock(mid, out_dim, groups, relu=False)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, groups,
                                          relu=False)
                               if in_dim != out_dim else None)

    def forward(self, x, levels, tables):
        return _conv_block(self, x, levels, tables)

    def block(self, x, q_pts, s_pts, in_mask, out_mask, index, geom):
        h = self.unary1(x, in_mask) if self.unary1 is not None else x
        h, pooled, geom = self.KPConv(q_pts, s_pts, index, h, geom=geom,
                                      x_extra=x if self.strided else None)
        h = self.unary2(leaky_relu(self.norm_conv(h, out_mask)), out_mask)
        shortcut = pooled if self.strided else x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return leaky_relu(h + shortcut), geom


class KPConvFPN(nn.Module):
    """Four levels of KPConv blocks (init_dim d: 1 -> d -> 2d at level 0,
    then 4d, 8d, 16d, each level opened by a strided block at the finer
    level's radius), and the decoder back to level 1: nearest upsampling
    (the first entry of the upsample table) and concatenation, a unary to
    8d at level 2, a linear to `output_dim` at level 1.  -> (level 3's
    16d features, level 1's output features)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg["init_dim"]
        r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
        self.encoder1_1 = ConvBlock(cfg, cfg["in_feats_dim"], d, r, 0)
        self.encoder1_2 = ResidualBlock(cfg, d, 2 * d, r, 0)
        self.encoder2_1 = ResidualBlock(cfg, 2 * d, 2 * d, r, 0, True)
        self.encoder2_2 = ResidualBlock(cfg, 2 * d, 4 * d, 2 * r, 1)
        self.encoder2_3 = ResidualBlock(cfg, 4 * d, 4 * d, 2 * r, 1)
        self.encoder3_1 = ResidualBlock(cfg, 4 * d, 4 * d, 2 * r, 1, True)
        self.encoder3_2 = ResidualBlock(cfg, 4 * d, 8 * d, 4 * r, 2)
        self.encoder3_3 = ResidualBlock(cfg, 8 * d, 8 * d, 4 * r, 2)
        self.encoder4_1 = ResidualBlock(cfg, 8 * d, 8 * d, 4 * r, 2, True)
        self.encoder4_2 = ResidualBlock(cfg, 8 * d, 16 * d, 8 * r, 3)
        self.encoder4_3 = ResidualBlock(cfg, 16 * d, 16 * d, 8 * r, 3)
        self.decoder3 = UnaryBlock(24 * d, 8 * d, cfg["group_norm"])
        self.decoder2 = nn.Linear(12 * d, cfg["output_dim"])

    def forward(self, feats, levels):
        tables: dict = {}

        def run(x, *names):
            for name in names:
                x = getattr(self, name)(x, levels, tables)
            return x

        x1 = run(feats, "encoder1_1", "encoder1_2")
        x2 = run(x1, "encoder2_1", "encoder2_2", "encoder2_3")
        x3 = run(x2, "encoder3_1", "encoder3_2", "encoder3_3")
        x4 = run(x3, "encoder4_1", "encoder4_2", "encoder4_3")
        up = closest_pool(x4, levels[2].upsamples)
        lat3 = self.decoder3(torch.cat([up, x3], dim=-1), levels[2].mask)
        up = closest_pool(lat3, levels[1].upsamples)
        lat2 = self.decoder2(torch.cat([up, x2], dim=-1))
        return x4, torch.where(levels[1].mask[..., None], lat2, 0.0)


class GeometricStructureEmbedding(nn.Module):
    """r_ij = proj_d(emb(d_ij / sigma_d)) + max over the angle_k nearest
    other superpoints x of p_i of proj_a(emb(angle(p_x - p_i, p_j - p_i) *
    180 / (sigma_a pi))).  points (C, M, 3), mask (C, M) -> (C, M, M, d),
    zeros at padded keys.  The angle neighbours are chosen here (squared
    distances to valid points, ties lowest index first); the rest is
    ops/geo_embedding.py, a kernel on CUDA tensors."""

    def __init__(self, d_model, sigma_d, sigma_a, angle_k):
        super().__init__()
        self.d_model = d_model
        self.sigma_d = sigma_d
        self.factor_a = 180.0 / (sigma_a * math.pi)
        self.angle_k = angle_k
        self.proj_d = nn.Linear(d_model, d_model)
        self.proj_a = nn.Linear(d_model, d_model)
        self._splits: dict = {}   # the kernel's split weights (ops)

    def forward(self, points, mask):
        _, sq = pair_offsets(points)
        far = torch.where(mask[:, None, :], sq, float("inf"))
        knn = nearest_first(far, self.angle_k + 1)[1][..., 1:]
        return geo_embedding(points, mask, knn, self.proj_d.weight,
                             self.proj_d.bias, self.proj_a.weight,
                             self.proj_a.bias, self.sigma_d, self.factor_a,
                             self._splits)


class FeedForward(nn.Module):
    """Upstream's AttentionOutput: LayerNorm(x + squeeze(ReLU(expand(x))))."""

    def __init__(self, d_model):
        super().__init__()
        self.expand = nn.Linear(d_model, 2 * d_model)
        self.squeeze = nn.Linear(2 * d_model, d_model)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class RPESelfAttentionLayer(nn.Module):
    """Self-attention with the geometric term: scores (q_i.k_j + q_i.p_ij)
    / sqrt(d_head) with p = p_proj(r) per head, padded keys masked;
    softmax; out_proj; LayerNorm(x + .); then the feed-forward."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        for name in ("q_proj", "k_proj", "v_proj", "p_proj", "out_proj"):
            setattr(self, name, nn.Linear(d_model, d_model))
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.output = FeedForward(d_model)

    def forward(self, x, emb, mask):
        c, m, d = x.shape
        h = self.nhead
        dh = d // h
        q, k, v = (p(x).reshape(c, m, h, dh).transpose(1, 2)
                   for p in (self.q_proj, self.k_proj, self.v_proj))
        p = self.p_proj(emb).reshape(c, m, m, h, dh)
        s = q @ k.transpose(-1, -2) + torch.einsum("chnd,cnmhd->chnm", q, p)
        s = torch.where(mask[:, None, None, :], s / math.sqrt(dh), NEG_INF)
        o = (torch.softmax(s, dim=-1) @ v).transpose(1, 2).reshape(c, m, d)
        return self.output(self.norm(x + self.out_proj(o)))


class CrossAttentionLayer(nn.Module):
    """Attention into the other cloud (K1, key extents), out_proj,
    LayerNorm(x + .), then the feed-forward."""

    def __init__(self, d_model, nhead):
        super().__init__()
        self.attn = MultiHeadAttention(d_model, nhead)
        self.norm = nn.LayerNorm(d_model, eps=LN_EPS)
        self.output = FeedForward(d_model)

    def forward(self, x, memory, memory_mask):
        return self.output(self.norm(x + self.attn(x, memory, memory,
                                                   memory_mask)))


class GeometricTransformer(nn.Module):
    """in_proj, the blocks (`geo_blocks`: 'self' or 'cross'), out_proj.
    The embedding is a submodule; the model calls it apart (a stage of
    its own) and hands its output to every self block."""

    def __init__(self, cfg):
        super().__init__()
        d, heads = cfg["geo_hidden_dim"], cfg["geo_num_heads"]
        self.blocks = list(cfg["geo_blocks"])
        self.embedding = GeometricStructureEmbedding(
            d, cfg["geo_sigma_d"], cfg["geo_sigma_a"], cfg["geo_angle_k"])
        self.in_proj = nn.Linear(cfg["geo_input_dim"], d)
        self.layers = nn.ModuleList(
            RPESelfAttentionLayer(d, heads) if b == "self"
            else CrossAttentionLayer(d, heads) for b in self.blocks)
        self.out_proj = nn.Linear(d, cfg["geo_output_dim"])

    def forward(self, feats, emb, mask):
        """feats (2B, M, Cin), emb (2B, M, M, d), mask (2B, M)."""
        x = self.in_proj(feats)
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                x = layer(x, emb, mask)
                continue
            src, ref = x[0::2], x[1::2]
            ref = layer(ref, src, mask[0::2])
            src = layer(src, ref, mask[1::2])
            x = torch.stack([src, ref], dim=1).reshape(x.shape)
        return self.out_proj(x)
