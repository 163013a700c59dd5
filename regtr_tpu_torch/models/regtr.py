"""RegTR forward and training losses (counterpart of RegTR.__call__ and
RegTR.compute_loss in regtr_tpu/models/regtr.py).

    points (2B, N0, 3), mask (2B, N0), pairs interleaved: slot 2i = source
    of pair i, slot 2i+1 = target.

The forward is four stages, each a method so a caller can time them:
`preprocess` (the pyramid), `encode` (KPConv backbone, feature projection
and positional embedding), `condition` (cross-attention transformer) and
`head_and_pose` (correspondence head and the weighted Kabsch solve over all
layers and pairs).  `compute_loss` adds the training losses on top of the
forward.  Each stage, the forward and the losses open a profiler span
(utils/profiling.py `span`: `regtr.pyramid`, ... `regtr.losses`), which
costs one flag check with no profiler running.

Randomness is explicit, as in the JAX package's `apply(..., rngs=...)`: a
call that is not deterministic with `dropout` > 0 needs a
`torch.Generator` on the model's device for its dropout masks, and raises
without one (JAX raises for a missing 'dropout' rng).  The sampled circle
loss seeds one generator per pair from that pair's points
(losses/feature.py `pair_generators`), as JAX derives its key from the
batch, so that a pair draws the same samples on any rank.

With several ranks (parallel/dist.py) `compute_loss` is a collective: its
losses are this rank's share of the global batch's, each over the global
batch's denominator, and every rank must call it.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn

from ..core.pairs import split_pairs
from ..core.se3 import compute_rigid_transform, se3_inv, se3_transform
from ..losses.corr import corr_loss
from ..losses.feature import (InfoNCELoss, circle_loss, circle_loss_sampled,
                              pair_generators)
from ..losses.overlap import overlap_loss
from ..nn.backbone import KPFEncoder, encoder_out_dim
from ..nn.blocks import compute_dtype
from ..nn.heads import CorrespondenceDecoder, CorrespondenceRegressor
from ..nn.pos_embed import (PositionEmbeddingCoordsSine,
                             PositionEmbeddingLearned)
from ..nn.transformer import TransformerCrossEncoder
from ..ops.pyramid import PyramidSpec, build_pyramid, compute_overlap_pyramid
from ..utils.profiling import span


class RegTR(nn.Module):
    def __init__(self, cfg, spec: PyramidSpec):
        super().__init__()
        self.cfg = cfg
        self.spec = spec
        d_embed = cfg["d_embed"]
        self.kpf_encoder = KPFEncoder(cfg)
        self.feat_proj = nn.Linear(encoder_out_dim(cfg), d_embed)
        if cfg.get("pos_emb_type", "sine") == "sine":
            self.pos_embed = PositionEmbeddingCoordsSine(
                3, d_embed, scale=cfg.get("pos_emb_scaling", 1.0))
        else:
            self.pos_embed = PositionEmbeddingLearned(3, d_embed)
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
            dropout=float(cfg.get("dropout", 0.0)),
            # the backbone's blocks read cfg['remat'] themselves
            remat=bool(cfg.get("remat_transformer", False)),
        )
        if cfg.get("direct_regress_coor", False):
            self.head = CorrespondenceRegressor(d_embed)
        else:
            self.head = CorrespondenceDecoder(
                d_embed, cfg.get("corr_decoder_has_pos_emb", True),
                num_neighbors=int(cfg.get("corr_decoder_num_neighbors", 0)))
        # The InfoNCE criteria hold trained parameters (W), so they are
        # submodules although only the loss uses them.  Registered last, so
        # the seeded init draws the forward's parameters as before.  The
        # circle losses have no parameters.
        if cfg.get("feature_loss_type", "infonce") == "infonce":
            self.feature_criterion = InfoNCELoss(d_embed, cfg["r_p"],
                                                 cfg["r_n"])
            self.feature_criterion_un = InfoNCELoss(d_embed, cfg["r_p"],
                                                    cfg["r_n"])

    def preprocess(self, points, mask):
        cfg = self.cfg
        # tables and coordinates: data, not trained
        with span("regtr.pyramid"), torch.no_grad():
            return build_pyramid(
                points, mask, self.spec,
                sort_input=bool(cfg.get("sort_input", True)),
                method=cfg.get("neighbor_method", "brute"),
                chunk=int(cfg.get("neighbor_chunk", 1024)),
                cell_cap=int(cfg.get("cell_capacity", 32)))

    def encode(self, levels):
        """-> (feats_un (2B, Nc, D), positional embedding (2B, Nc, D))."""
        with span("regtr.backbone"):
            mask = levels[0].mask
            feats0 = mask[..., None].to(levels[0].points.dtype).expand(
                -1, -1, self.cfg.get("in_feats_dim", 1))
            feats_enc, _ = self.kpf_encoder(feats0, levels)
            return (self.feat_proj(feats_enc),
                    self.pos_embed(levels[-1].points))

    def condition(self, feats_un, pe, coarse_mask, generator=None):
        """The transformer; with a generator, its dropout is on."""
        pos = pe if self.cfg.get("transformer_encoder_has_pos_emb",
                                 True) else None
        with span("regtr.transformer"):
            return self.transformer_encoder(feats_un, pos, coarse_mask,
                                            generator)

    def head_and_pose(self, feats_cond, coarse_points, coarse_mask, pe):
        """The head (the decoder reads the positional embedding `pe`) and
        the pose solve."""
        with span("regtr.head_pose"):
            return self._head_and_pose(feats_cond, coarse_points,
                                       coarse_mask, pe)

    def _head_and_pose(self, feats_cond, coarse_points, coarse_mask, pe):
        corr, overlap_logits = self.head(feats_cond, coarse_points, pe,
                                         coarse_mask)
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
        with torch.no_grad():   # no loss reads the predicted pose
            pose = compute_rigid_transform(a, bb, w)         # (L, B, 3, 4)
        return corr, overlap_logits[..., 0], pose

    def _dropout_generator(self, deterministic, generator):
        """The generator the transformer's dropout draws from, or None when
        dropout is off (deterministic, or a rate of 0)."""
        if deterministic or float(self.cfg.get("dropout", 0.0)) == 0.0:
            return None
        if generator is None:
            raise ValueError("dropout > 0 and deterministic=False need a "
                             "torch.Generator for the dropout masks")
        return generator

    def forward(self, points, mask, deterministic: bool = True,
                generator=None) -> Dict[str, Any]:
        """points (2B, N0, 3) fp32; mask (2B, N0) bool."""
        with span("regtr.forward"):
            return self.forward_levels(self.preprocess(points, mask),
                                       deterministic, generator)

    def forward_levels(self, levels, deterministic: bool = True,
                       generator=None) -> Dict[str, Any]:
        """The forward after the pyramid, on `preprocess`'s levels."""
        coarse = levels[-1]
        feats_un, pe = self.encode(levels)
        feats_cond = self.condition(
            feats_un, pe, coarse.mask,
            self._dropout_generator(deterministic, generator))
        corr, overlap_logits, pose = self.head_and_pose(
            feats_cond, coarse.points, coarse.mask, pe)
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

    def compute_loss(self, points, mask, pose_gt, overlap0,
                     deterministic: bool = False, generator=None):
        """Forward + all training losses -> (losses incl. 'total', outputs).

        pose_gt (B, 3, 4) src->tgt; overlap0 (2B, N0) GT overlap labels at
        the input level, in the input's order.  Not deterministic by
        default, as in the JAX package: with `dropout` > 0 it then needs
        `generator`.
        """
        return self.loss_levels(self.preprocess(points, mask), pose_gt,
                                overlap0, deterministic, generator)

    def loss_levels(self, levels, pose_gt, overlap0,
                    deterministic: bool = False, generator=None):
        """`compute_loss` on `preprocess`'s levels: BCE overlap loss, the
        feature loss (InfoNCE, circle or sampled circle) on conditioned and
        unconditioned features, and the bidirectional overlap-weighted
        correspondence loss."""
        out = self.forward_levels(levels, deterministic, generator)
        with span("regtr.losses"):
            return self._losses(levels, out, pose_gt, overlap0), out

    def _losses(self, levels, out, pose_gt, overlap0):
        cfg = self.cfg
        num_layers = cfg["num_encoder_layers"]
        losses: Dict[str, torch.Tensor] = {}
        weights: Dict[str, float] = {}

        if levels[0].perm is not None:
            # Level 0 was spatially sorted: realign the per-point labels.
            overlap0 = overlap0.gather(1, levels[0].perm)
        ov_c = compute_overlap_pyramid(overlap0, levels)[-1]   # (2B, Nc)
        src_ov_gt, tgt_ov_gt = split_pairs(ov_c)
        kp_mask = out["kp_mask"]
        src_kp, tgt_kp = split_pairs(out["kp"])
        src_mask, tgt_mask = split_pairs(kp_mask)

        for i in cfg.get("overlap_loss_on", [num_layers - 1]):
            losses[f"overlap_{i}"] = overlap_loss(
                out["overlap_logits"][i], ov_c, kp_mask)
            weights[f"overlap_{i}"] = cfg.get("wt_overlap", 1.0)

        src_kp_gt_warped = se3_transform(pose_gt, src_kp)
        feat_type = cfg.get("feature_loss_type", "infonce")

        def feature_loss(criterion, f_src, f_tgt, salt):
            args = (f_src, f_tgt, src_kp_gt_warped, tgt_kp, src_mask,
                    tgt_mask)
            if feat_type == "infonce":
                return criterion(*args)
            if feat_type == "circle_sampled":
                return circle_loss_sampled(
                    *args, cfg["r_p"], cfg["r_n"],
                    pair_generators(src_kp_gt_warped, salt),
                    n_sample=int(cfg.get("circle_n_sample", 256)))
            return circle_loss(*args, cfg["r_p"], cfg["r_n"])

        for i in cfg.get("feature_loss_on", [num_layers - 1]):
            f_src, f_tgt = split_pairs(out["feats_cond"][i])
            losses[f"feature_{i}"] = feature_loss(
                getattr(self, "feature_criterion", None), f_src, f_tgt, i)
            weights[f"feature_{i}"] = cfg.get("wt_feature", 0.1)
        fu_src, fu_tgt = split_pairs(out["feats_un"])
        losses["feature_un"] = feature_loss(
            getattr(self, "feature_criterion_un", None), fu_src, fu_tgt,
            num_layers)
        weights["feature_un"] = cfg.get("wt_feature_un", 0.0)

        pose_gt_inv = se3_inv(pose_gt)
        metric = cfg.get("corr_metric", "mae")
        for i in cfg.get("corr_loss_on", [num_layers - 1]):
            corr_src, corr_tgt = split_pairs(out["corr"][i])
            losses[f"corr_{i}"] = (
                corr_loss(src_kp, corr_src, pose_gt, src_ov_gt, metric)
                + corr_loss(tgt_kp, corr_tgt, pose_gt_inv, tgt_ov_gt, metric))
            weights[f"corr_{i}"] = cfg.get("wt_corr", 1.0)

        losses["total"] = sum(losses[k] * weights[k] for k in weights)
        return losses
