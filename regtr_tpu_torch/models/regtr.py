"""RegTR inference forward (counterpart of RegTR.__call__ in
regtr_tpu/models/regtr.py).

    points (2B, N0, 3), mask (2B, N0), pairs interleaved: slot 2i = source
    of pair i, slot 2i+1 = target.

The forward is four stages, each a method so a caller can time them:
`preprocess` (the pyramid), `encode` (KPConv backbone, feature projection
and positional embedding), `condition` (cross-attention transformer) and
`head_and_pose` (correspondence head and the weighted Kabsch solve over all
layers and pairs).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..core.pairs import split_pairs
from ..core.se3 import compute_rigid_transform
from ..nn.backbone import KPFEncoder, encoder_out_dim
from ..nn.blocks import compute_dtype
from ..nn.heads import CorrespondenceRegressor
from ..nn.pos_embed import PositionEmbeddingCoordsSine
from ..nn.transformer import TransformerCrossEncoder
from ..ops.pyramid import PyramidSpec, build_pyramid


class RegTR(nn.Module):
    def __init__(self, cfg, spec: PyramidSpec):
        super().__init__()
        if cfg.get("neighbor_method", "brute") != "brute":
            raise NotImplementedError("only the brute neighbor search is "
                                      "ported")
        if cfg.get("pos_emb_type", "sine") != "sine":
            raise NotImplementedError("only the sine embedding is ported")
        if not cfg.get("direct_regress_coor", False):
            raise NotImplementedError("only direct_regress_coor is ported")
        self.cfg = cfg
        self.spec = spec
        d_embed = cfg["d_embed"]
        self.kpf_encoder = KPFEncoder(cfg)
        self.feat_proj = nn.Linear(encoder_out_dim(cfg), d_embed)
        self.pos_embed = PositionEmbeddingCoordsSine(
            3, d_embed, scale=cfg.get("pos_emb_scaling", 1.0))
        self.transformer_encoder = TransformerCrossEncoder(
            d_model=d_embed,
            nhead=cfg["nhead"],
            num_layers=cfg["num_encoder_layers"],
            d_feedforward=cfg["d_feedforward"],
            activation=cfg.get("transformer_act", "relu"),
            pre_norm=cfg.get("pre_norm", True),
            sa_val_has_pos_emb=cfg.get("sa_val_has_pos_emb", True),
            ca_val_has_pos_emb=cfg.get("ca_val_has_pos_emb", True),
            compute_dtype=compute_dtype(cfg),
        )
        self.head = CorrespondenceRegressor(d_embed)

    def preprocess(self, points, mask):
        return build_pyramid(points, mask, self.spec,
                             sort_input=bool(self.cfg.get("sort_input", True)))

    def encode(self, levels):
        """-> (feats_un (2B, Nc, D), positional embedding (2B, Nc, D))."""
        mask = levels[0].mask
        feats0 = mask[..., None].to(levels[0].points.dtype).expand(
            -1, -1, self.cfg.get("in_feats_dim", 1))
        feats_enc, _ = self.kpf_encoder(feats0, levels)
        return self.feat_proj(feats_enc), self.pos_embed(levels[-1].points)

    def condition(self, feats_un, pe, coarse_mask):
        pos = pe if self.cfg.get("transformer_encoder_has_pos_emb",
                                 True) else None
        return self.transformer_encoder(feats_un, pos, coarse_mask)

    def head_and_pose(self, feats_cond, coarse_points, coarse_mask):
        corr, overlap_logits = self.head(feats_cond)
        src_xyz, tgt_xyz = split_pairs(coarse_points)
        src_mask, tgt_mask = split_pairs(coarse_mask)
        src_corr, tgt_corr = split_pairs(corr, dim=1)
        src_ovl, tgt_ovl = split_pairs(overlap_logits[..., 0], dim=1)
        src_ov = torch.sigmoid(src_ovl) * src_mask
        tgt_ov = torch.sigmoid(tgt_ovl) * tgt_mask
        thresh = float(self.cfg.get("overlap_threshold", 0.0))
        if thresh > 0.0:
            src_ov = torch.where(src_ov > thresh, src_ov, 0.0)
            tgt_ov = torch.where(tgt_ov > thresh, tgt_ov, 0.0)
        num_pred = corr.shape[0]
        a = torch.cat([src_xyz[None].expand(num_pred, -1, -1, -1), tgt_corr],
                      dim=2)                                 # (L, B, 2Nc, 3)
        bb = torch.cat([src_corr, tgt_xyz[None].expand(num_pred, -1, -1, -1)],
                       dim=2)
        w = torch.cat([src_ov, tgt_ov], dim=2)               # (L, B, 2Nc)
        pose = compute_rigid_transform(a, bb, w)             # (L, B, 3, 4)
        return corr, overlap_logits[..., 0], pose

    def forward(self, points, mask) -> Dict[str, Any]:
        """points (2B, N0, 3) fp32; mask (2B, N0) bool."""
        levels = self.preprocess(points, mask)
        coarse = levels[-1]
        feats_un, pe = self.encode(levels)
        feats_cond = self.condition(feats_un, pe, coarse.mask)
        corr, overlap_logits, pose = self.head_and_pose(
            feats_cond, coarse.points, coarse.mask)
        return {
            "levels": levels,
            "feats_un": feats_un,              # (2B, Nc, D)
            "feats_cond": feats_cond,          # (L, 2B, Nc, D)
            "kp": coarse.points,               # (2B, Nc, 3)
            "kp_mask": coarse.mask,            # (2B, Nc)
            "corr": corr,                      # (L, 2B, Nc, 3)
            "overlap_logits": overlap_logits,  # (L, 2B, Nc)
            "pose": pose,                      # (L, B, 3, 4)
        }
