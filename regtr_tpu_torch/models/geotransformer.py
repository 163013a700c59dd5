"""GeoTransformer (Qin et al., "Geometric Transformer for Fast and Robust
Point Cloud Registration", CVPR 2022; github.com/qinzheng93/GeoTransformer,
the 3DMatch experiment), inference, on the port's pyramid, KPConv and
attention.

    points (2B, N0, 3), mask (2B, N0), pairs interleaved: slot 2i the
    source of pair i (upstream's `src`), slot 2i+1 its target (`ref`).

The forward is seven stages, each a method that opens a profiler span
(utils/profiling.py `span`), so that a caller can time them:
`preprocess` (the pyramid, `geotr.pyramid`), `encode` (the KPConv-FPN,
`geotr.backbone`), `embed` (the geometric structure embedding at an
extent that holds the coarse level's valid superpoints,
`geotr.embedding`), `condition` (the
geometric transformer, `geotr.transformer`), `match_coarse` (the
point-to-node partition and superpoint matching, `geotr.coarse_matching`),
`transport` (patch scores and the log-domain Sinkhorn,
`geotr.optimal_transport`) and `register` (the local-to-global
registration, `geotr.registration`), all inside `geotr.forward`.

`embed` reads the largest count of valid superpoints of the batch's clouds
on the host (one sync) and rounds it up to a multiple of EXTENT_GRAIN (at
most the level's capacity): the extent of the embedding and the
self-attention.  Rounded, a batch's shapes, work and memory do not follow
its count of superpoints (~350-450 at 3DMatch density: one extent, 512),
as the input's bucket does not follow its count of points; valid
superpoints are a prefix, so the padding is masked.  Every later shape is
fixed (nn/matching.py).

While a profiler runs, COUNTERS sums on the device, with no host sync:
  geotr.embedding_pairs       (valid pairs embedded, pairs of the grid
                              embedded: clouds x extent^2), int64 (2,)
  geotr.fine_correspondences  correspondences kept, int64 (1,)
  geotr.hypotheses            patch pairs that reached the threshold and
                              gave a hypothesis, int64 (1,)
(None until then; set an entry to None to start again).
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..nn.geotransformer import GeometricTransformer, KPConvFPN
from ..nn.matching import (LogOptimalTransport, local_global_registration,
                           point_to_node_partition, superpoint_matching)
from ..ops.gather import row_gather
from ..ops.pyramid import PyramidSpec, build_pyramid
from ..utils.profiling import profiler_running, span

EXTENT_GRAIN = 256
COUNTERS: Dict[str, Any] = {"geotr.embedding_pairs": None,
                            "geotr.fine_correspondences": None,
                            "geotr.hypotheses": None}


def _count(name, value, size):
    # normal tensors, even under inference_mode: a later call outside it
    # may add to them in place
    with torch.inference_mode(False):
        total = COUNTERS[name]
        if total is None or total.device != value.device:
            total = torch.zeros(size, dtype=torch.int64, device=value.device)
            COUNTERS[name] = total
        total.add_(value)


# upstream's 3DMatch settings of the options this port implements one way
FIXED = {"geo_reduction_a": "max", "fine_mutual": True,
         "fine_use_dustbin": False, "fine_use_global_score": False,
         "fine_correspondence_limit": None, "compute_dtype": "float32"}


class GeoTransformer(nn.Module):
    def __init__(self, cfg, spec: PyramidSpec):
        super().__init__()
        if spec.num_levels != 4:
            raise ValueError(f"GeoTransformer runs 4 levels, the "
                             f"architecture gives {spec.num_levels}")
        for key, want in FIXED.items():
            if cfg.get(key, want) != want:
                raise ValueError(f"GeoTransformer runs {key}={want!r} only")
        self.cfg = cfg
        self.spec = spec
        self.backbone = KPConvFPN(cfg)
        self.transformer = GeometricTransformer(cfg)
        self.optimal_transport = LogOptimalTransport(
            int(cfg["num_sinkhorn_iterations"]))

    def preprocess(self, points, mask):
        cfg = self.cfg
        with span("geotr.pyramid"), torch.no_grad():
            return build_pyramid(
                points, mask, self.spec,
                sort_input=bool(cfg.get("sort_input", True)),
                method=cfg.get("neighbor_method", "brute"),
                chunk=int(cfg.get("neighbor_chunk", 1024)),
                cell_cap=int(cfg.get("cell_capacity", 32)))

    def encode(self, levels):
        """-> (coarse features (2B, Nc, 16 d), level 1's (2B, N1, out))."""
        with span("geotr.backbone"):
            feats0 = levels[0].mask[..., None].to(levels[0].points.dtype)
            feats0 = feats0.expand(-1, -1, self.cfg.get("in_feats_dim", 1))
            return self.backbone(feats0, levels)

    def embed(self, coarse):
        """-> (the extent M, the embedding (2B, M, M, d))."""
        with span("geotr.embedding"):
            counts = coarse.mask.sum(1)
            grains = -(-max(int(counts.max()), 1) // EXTENT_GRAIN)
            m = min(grains * EXTENT_GRAIN, coarse.mask.shape[1])
            mask = coarse.mask[:, :m]
            emb = self.transformer.embedding(coarse.points[:, :m], mask)
            if profiler_running():
                _count("geotr.embedding_pairs", torch.stack([
                    (counts.long() ** 2).sum(),
                    torch.full((), emb.shape[0] * m * m, dtype=torch.long,
                               device=emb.device)]), 2)
            return m, emb

    def condition(self, feats_c, emb, coarse, m):
        """-> the transformer's L2-normalised features (2B, M, d)."""
        with span("geotr.transformer"):
            out = self.transformer(feats_c[:, :m], emb, coarse.mask[:, :m])
            return F.normalize(out, p=2, dim=-1)

    def match_coarse(self, feats, fine, coarse, m):
        """The partition of level 1 into patches of level 3's nodes, and
        the top node pairs -> dict."""
        with span("geotr.coarse_matching"):
            patches, patch_mask, node_mask = point_to_node_partition(
                fine.points, fine.mask, coarse.points[:, :m],
                coarse.mask[:, :m], int(self.cfg["num_points_in_patch"]))
            ref, src, scores, valid = superpoint_matching(
                feats[1::2], feats[0::2], node_mask[1::2], node_mask[0::2],
                int(self.cfg["num_correspondences"]),
                bool(self.cfg.get("dual_normalization", True)))
            return {"patches": patches, "patch_mask": patch_mask,
                    "node_mask": node_mask, "node_ref": ref,
                    "node_src": src, "node_scores": scores,
                    "node_valid": valid}

    def _patch_rows(self, rows, nodes, match, side):
        """Rows (2B, N1, C) of each chosen node pair's patch on `side`
        (0: source, 1: target) -> (B, P, K, C), zero at empty slots, by one
        row gather over the clouds' rows and a zero row."""
        b2, n1, c = rows.shape
        table = torch.cat([rows, rows.new_zeros(b2, 1, c)], 1)
        patches = match["patches"][side::2]                   # (B, M, K)
        idx = patches.gather(1, nodes[..., None].expand(
            -1, -1, patches.shape[-1]))                       # (B, P, K)
        cloud = torch.arange(side, b2, 2, device=rows.device)
        flat = (idx + (cloud * (n1 + 1))[:, None, None]).reshape(-1)
        return row_gather(table.reshape(-1, c), flat).reshape(
            idx.shape + (c,))

    def _patch_mask(self, match, nodes, side):
        mask = match["patch_mask"][side::2]
        return mask.gather(1, nodes[..., None].expand(-1, -1,
                                                      mask.shape[-1]))

    def transport(self, feats_f, match):
        """Patch scores f_i.f_j / sqrt(C) of each chosen node pair, through
        the optimal transport -> (B, P, K + 1, K + 1) log scores."""
        with span("geotr.optimal_transport"):
            ref = self._patch_rows(feats_f, match["node_ref"], match, 1)
            src = self._patch_rows(feats_f, match["node_src"], match, 0)
            b, p, k, c = ref.shape
            scores = torch.einsum("bpic,bpjc->bpij", ref, src) / c ** 0.5
            valid = match["node_valid"][..., None]
            out = self.optimal_transport(
                scores.reshape(b * p, k, k),
                (self._patch_mask(match, match["node_ref"], 1)
                 & valid).reshape(b * p, k),
                (self._patch_mask(match, match["node_src"], 0)
                 & valid).reshape(b * p, k))
            return out.reshape(b, p, k + 1, k + 1)

    def register(self, fine, match, log_scores):
        """The local-to-global registration on the patches' points ->
        dict (nn/matching.py), with 'pose' (B, 3, 4) source to target."""
        with span("geotr.registration"):
            k = log_scores.shape[-1] - 1
            out = local_global_registration(
                self._patch_rows(fine.points, match["node_ref"], match, 1),
                self._patch_rows(fine.points, match["node_src"], match, 0),
                self._patch_mask(match, match["node_ref"], 1),
                self._patch_mask(match, match["node_src"], 0),
                log_scores[:, :, :k, :k], match["node_valid"], self.cfg)
            if profiler_running():
                _count("geotr.fine_correspondences",
                       out["valid"].sum().reshape(1), 1)
                _count("geotr.hypotheses",
                       (out["hyp_counts"] >= 0).sum().reshape(1), 1)
            return out

    def forward(self, points, mask) -> Dict[str, Any]:
        """points (2B, N0, 3) fp32; mask (2B, N0) bool."""
        with span("geotr.forward"):
            return self.forward_levels(self.preprocess(points, mask))

    def forward_levels(self, levels) -> Dict[str, Any]:
        """The forward after the pyramid, on `preprocess`'s levels."""
        coarse, fine = levels[-1], levels[1]
        feats_c, feats_f = self.encode(levels)
        m, emb = self.embed(coarse)
        feats = self.condition(feats_c, emb, coarse, m)
        del emb
        match = self.match_coarse(feats, fine, coarse, m)
        log_scores = self.transport(feats_f, match)
        reg = self.register(fine, match, log_scores)
        k = log_scores.shape[-1] - 1
        return {"levels": levels, "kp": coarse.points, "kp_mask": coarse.mask,
                "fine_points": fine.points, "fine_mask": fine.mask,
                "feats_c": feats, "feats_f": feats_f, **match,
                "ot": log_scores[:, :, :k, :k], **reg}
