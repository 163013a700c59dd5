"""The plain reference of RegTR's forward and training losses, in plain
PyTorch and float32, for the configurations the benchmark runs (rigid
KPConv blocks, the sine position embedding, the pre-norm cross-encoder,
the coordinate regressor, InfoNCE): the same mathematics as the measured
package states it, with none of its kernels, written out once here.

The parameter names are those of the measured model's state_dict, so the
weights the benchmark draws load into both by name.  The pyramid, the
neighbor tables, the kernel points and every derived tensor are worked out
here again from the points (pyramid.py, kernel_points.py).

Layout: points (2B, N0, 3) and mask (2B, N0), pairs interleaved (slot 2i
the source of pair i, 2i + 1 its target).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import pyramid
from .kernel_points import kernel_points

NEG_INF = -1e9
LN_EPS = 1e-6
LEAKY_SLOPE = 0.1
SHADOW_COORD = 1e6


def split_pairs(x, dim=0):
    shape = list(x.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    y = x.reshape(shape)
    return y.select(dim + 1, 0), y.select(dim + 1, 1)


def swap_pairs(x, dim=0):
    shape = list(x.shape)
    shape[dim:dim + 1] = [shape[dim] // 2, 2]
    return x.reshape(shape).flip(dim + 1).reshape(x.shape)


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=LEAKY_SLOPE)


def masked_mean(x, mask, dim, keepdim=False):
    mask = mask.to(x.dtype)
    return ((x * mask).sum(dim=dim, keepdim=keepdim)
            / mask.sum(dim=dim, keepdim=keepdim).clamp_min(1e-12))


def instance_norm(x, mask, eps=1e-5):
    """Per-cloud, per-channel normalisation over the valid points, no
    affine parameters, zero at masked points."""
    m = mask[..., None]
    mean = masked_mean(x, m, dim=-2, keepdim=True)
    var = masked_mean((x - mean) ** 2, m, dim=-2, keepdim=True)
    normed = (x - mean) * torch.rsqrt(var + eps)
    return torch.where(m, normed, torch.zeros_like(normed))


def _pad_row(x, value):
    pad = torch.full((x.shape[0], 1, x.shape[2]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def gather_rows(x, inds):
    """x (B, N, C) with a pad row appended per cloud, rows at inds
    (B, Nq, K) in [0, N] -> (B, Nq, K, C)."""
    b, nq, k = inds.shape
    flat = inds.reshape(b, nq * k)
    out = torch.gather(x, 1, flat[..., None].expand(-1, -1, x.shape[-1]))
    return out.reshape(b, nq, k, x.shape[-1])


def geometry(q_pts, s_pts, inds, kpts, extent):
    """The influence of each neighbor on each kernel point (linear:
    relu(1 - d / extent)) and 1 / (valid neighbors) per query."""
    ns = s_pts.shape[1]
    rel = gather_rows(_pad_row(s_pts, SHADOW_COORD), inds) - q_pts[:, :, None]
    sq_d = ((rel * rel).sum(-1)[..., None] - 2.0 * (rel @ kpts.t())
            + (kpts * kpts).sum(-1)).clamp_min(0.0)
    infl = (1.0 - torch.sqrt(sq_d) / extent).clamp_min(0.0)
    n_valid = (inds < ns).sum(-1).clamp_min(1).to(torch.float32)
    return infl, 1.0 / n_valid


def kpconv(infl, inv_n, neighb_x, weights):
    """sum over neighbors of influence x features per kernel point, then
    the (P * Cin) x Cout product, over the valid neighbor count."""
    b, nq, k, cin = neighb_x.shape
    p = infl.shape[-1]
    weighted = torch.einsum("bqkp,bqkc->bqpc", infl, neighb_x)
    out = weighted.reshape(b, nq, p * cin) @ weights.reshape(p * cin, -1)
    return out * inv_n[..., None]


class KPConvLayer(nn.Module):
    def __init__(self, cfg, in_dim, out_dim, radius):
        super().__init__()
        p = cfg["num_kernel_points"]
        self.extent = radius * cfg["KP_extent"] / cfg["conv_radius"]
        self.weights = nn.Parameter(torch.empty(p, in_dim, out_dim))
        self.register_buffer("kernel_points", torch.from_numpy(kernel_points(
            radius, p, cfg.get("kernel_seed", 0))), persistent=False)


class UnaryBlock(nn.Module):
    def __init__(self, in_dim, out_dim, no_relu=False):
        super().__init__()
        self.mlp = nn.Linear(in_dim, out_dim, bias=False)
        self.no_relu = no_relu

    def forward(self, x, mask):
        x = instance_norm(self.mlp(x), mask)
        return x if self.no_relu else leaky_relu(x)


class ConvBlock(nn.Module):
    """`simple` (KPConv to out/2, norm, leaky ReLU) or `resnetb[_strided]`
    (unary to out/4, KPConv, norm, leaky ReLU, unary to out, plus the
    shortcut: max-pooled over the conv's table when strided, then a unary
    where the widths differ)."""

    def __init__(self, name, in_dim, out_dim, radius, layer_ind, cfg):
        super().__init__()
        self.simple = "simple" in name
        self.strided = "strided" in name
        self.layer_ind = layer_ind
        if self.simple:
            self.kpconv = KPConvLayer(cfg, in_dim, out_dim // 2, radius)
            return
        mid = out_dim // 4
        self.unary1 = UnaryBlock(in_dim, mid) if in_dim != mid else None
        self.kpconv = KPConvLayer(cfg, mid, mid, radius)
        self.unary2 = UnaryBlock(mid, out_dim, no_relu=True)
        self.unary_shortcut = (UnaryBlock(in_dim, out_dim, no_relu=True)
                               if in_dim != out_dim else None)

    def forward(self, x, levels, geoms):
        lvl = levels[self.layer_ind]
        if self.strided:
            q_lvl = levels[self.layer_ind + 1]
            q_pts, inds, out_mask = q_lvl.points, lvl.pools, q_lvl.mask
        else:
            q_pts, inds, out_mask = lvl.points, lvl.neighbors, lvl.mask
        key = (self.strided, self.layer_ind)
        if key not in geoms:
            geoms[key] = geometry(q_pts, lvl.points, inds,
                                  self.kpconv.kernel_points,
                                  self.kpconv.extent)
        infl, inv_n = geoms[key]
        if self.simple:
            h = gather_rows(_pad_row(x, 0.0), inds)
            h = kpconv(infl, inv_n, h, self.kpconv.weights)
            return leaky_relu(instance_norm(h, out_mask))
        h = self.unary1(x, lvl.mask) if self.unary1 is not None else x
        h = kpconv(infl, inv_n, gather_rows(_pad_row(h, 0.0), inds),
                   self.kpconv.weights)
        h = self.unary2(leaky_relu(instance_norm(h, out_mask)), out_mask)
        shortcut = (gather_rows(_pad_row(x, 0.0), inds).amax(dim=2)
                    if self.strided else x)
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut, out_mask)
        return leaky_relu(h + shortcut)


def encoder_plan(cfg):
    """(name, in_dim, out_dim, radius, level) of each encoder block, and
    the encoder's output width."""
    r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
    in_dim, out_dim, layer = cfg["in_feats_dim"], cfg["first_feats_dim"], 0
    plan = []
    for name in cfg["architecture"]:
        if not ("simple" in name or "resnetb" in name):
            raise ValueError(f"the reference has no block {name!r}")
        plan.append((name, in_dim, out_dim, r, layer))
        in_dim = out_dim // 2 if "simple" in name else out_dim
        if "strided" in name:
            layer += 1
            r *= 2.0
            out_dim *= 2
    return plan, in_dim


class KPFEncoder(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.plan, _ = encoder_plan(cfg)
        self.names = []
        for i, (name, cin, cout, r, li) in enumerate(self.plan):
            self.add_module(f"block_{i}_{name}",
                            ConvBlock(name, cin, cout, r, li, cfg))
            self.names.append(f"block_{i}_{name}")

    def forward(self, x, levels):
        geoms = {}
        for name in self.names:
            x = getattr(self, name)(x, levels, geoms)
        return x


def sine_embedding(xyz, d_model, scale=1.0, temperature=10000.0):
    num_feats = d_model // 3 // 2 * 2
    padding = d_model - num_feats * 3
    dim_t = torch.arange(num_feats, dtype=torch.float32, device=xyz.device)
    dim_t = temperature ** (2.0 * torch.floor(dim_t / 2.0) / num_feats)
    pos = (xyz * scale * 2.0 * math.pi)[..., None] / dim_t
    emb = torch.stack([torch.sin(pos[..., 0::2]), torch.cos(pos[..., 1::2])],
                      dim=-1).reshape(xyz.shape[:-1] + (-1,))
    return F.pad(emb, (0, padding)) if padding else emb


class MultiHeadAttention(nn.Module):
    def __init__(self, d_model, nhead):
        super().__init__()
        self.nhead = nhead
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q, k, v, key_mask):
        b, nq, d = q.shape
        h = self.nhead
        qh, kh, vh = (proj(x).reshape(b, -1, h, d // h).transpose(1, 2)
                      for x, proj in ((q, self.q_proj), (k, self.k_proj),
                                      (v, self.v_proj)))
        s = (qh @ kh.transpose(-1, -2)) * (1.0 / float(d // h) ** 0.5)
        s = s + torch.where(key_mask, 0.0, NEG_INF)[:, None, None, :]
        o = torch.softmax(s, dim=-1) @ vh
        return self.out_proj(o.transpose(1, 2).reshape(b, nq, d))


class CrossEncoderLayer(nn.Module):
    """Pre-norm: self-attention, cross-attention into the partner cloud
    (positions on queries, keys and values), ReLU feed-forward."""

    def __init__(self, d_model, nhead, d_ff):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, nhead)
        self.cross_attn = MultiHeadAttention(d_model, nhead)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm3 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.linear1 = nn.Linear(d_model, d_ff)
        self.linear2 = nn.Linear(d_ff, d_model)

    def forward(self, x, pos, mask):
        qk = self.norm1(x) + pos
        x = x + self.self_attn(qk, qk, qk, mask)
        q = self.norm2(x) + pos
        kv = swap_pairs(q)
        x = x + self.cross_attn(q, kv, kv, swap_pairs(mask))
        return x + self.linear2(F.relu(self.linear1(self.norm3(x))))


class TransformerCrossEncoder(nn.Module):
    def __init__(self, d_model, nhead, num_layers, d_ff):
        super().__init__()
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"layer_{i}",
                            CrossEncoderLayer(d_model, nhead, d_ff))
        self.norm_final = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, pos, mask):
        out = []
        for i in range(self.num_layers):
            x = getattr(self, f"layer_{i}")(x, pos, mask)
            out.append(self.norm_final(x))
        return torch.stack(out)


class CorrespondenceRegressor(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.coor_mlp0 = nn.Linear(d, d)
        self.coor_mlp1 = nn.Linear(d, d)
        self.coor_mlp2 = nn.Linear(d, 3)
        self.conf_logits = nn.Linear(d, 1)

    def forward(self, feats):
        h = F.relu(self.coor_mlp1(F.relu(self.coor_mlp0(feats))))
        return self.coor_mlp2(h), self.conf_logits(feats)[..., 0]


class InfoNCE(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.W = nn.Parameter(torch.empty(d, d))


def rigid_transform(a, b, w):
    """Weighted Kabsch, T = (R | t) with T a ~= b; weights clamped at
    1e-6 in sum, reflections fixed by det(V U^T)."""
    w = w[..., None]
    w = w / w.sum(dim=-2, keepdim=True).clamp_min(1e-6)
    ca = (a * w).sum(dim=-2, keepdim=True)
    cb = (b * w).sum(dim=-2, keepdim=True)
    cov = (a - ca).transpose(-2, -1) @ ((b - cb) * w)
    u, _, vh = torch.linalg.svd(cov)
    v, ut = vh.transpose(-2, -1), u.transpose(-2, -1)
    flip = torch.tensor([1.0, 1.0, -1.0], dtype=v.dtype, device=v.device)
    pos, neg = v @ ut, (v * flip) @ ut
    rot = torch.where((torch.linalg.det(pos) > 0)[..., None, None], pos, neg)
    trans = cb.transpose(-2, -1) - rot @ ca.transpose(-2, -1)
    return torch.cat([rot, trans], dim=-1)


def se3_transform(pose, xyz):
    return xyz @ pose[..., :3, :3].transpose(-1, -2) + pose[..., :3, 3][
        ..., None, :]


def se3_inv(pose):
    irot = pose[..., :3, :3].transpose(-1, -2)
    return torch.cat([irot, -irot @ pose[..., :3, 3:4]], dim=-1)


class RegTR(nn.Module):
    def __init__(self, cfg, n0: int):
        super().__init__()
        for key, want in (("direct_regress_coor", True), ("pre_norm", True),
                          ("pos_emb_type", "sine"),
                          ("feature_loss_type", "infonce"),
                          ("transformer_act", "relu"),
                          ("KP_influence", "linear"),
                          ("aggregation_mode", "sum")):
            if cfg.get(key, want) != want:
                raise ValueError(f"the reference runs {key}={want!r} only")
        if float(cfg.get("dropout", 0.0)) or cfg.get(
                "compute_dtype", "float32") != "float32":
            raise ValueError("the reference runs fp32 without dropout")
        self.cfg = cfg
        self.spec = pyramid.make_spec(cfg, n0)
        d = cfg["d_embed"]
        self.kpf_encoder = KPFEncoder(cfg)
        self.feat_proj = nn.Linear(encoder_plan(cfg)[1], d)
        self.transformer_encoder = TransformerCrossEncoder(
            d, cfg["nhead"], cfg["num_encoder_layers"], cfg["d_feedforward"])
        self.head = CorrespondenceRegressor(d)
        self.feature_criterion = InfoNCE(d)
        self.feature_criterion_un = InfoNCE(d)

    def pyramid(self, points, mask):
        return pyramid.build(points, mask, self.spec)

    def forward_levels(self, levels):
        cfg = self.cfg
        coarse = levels[-1]
        feats0 = levels[0].mask[..., None].float().expand(
            -1, -1, cfg["in_feats_dim"])
        feats_un = self.feat_proj(self.kpf_encoder(feats0, levels))
        pe = sine_embedding(coarse.points, cfg["d_embed"],
                            cfg.get("pos_emb_scaling", 1.0))
        feats = self.transformer_encoder(feats_un, pe, coarse.mask)
        corr, logits = self.head(feats)
        src_xyz, tgt_xyz = split_pairs(coarse.points)
        src_m, tgt_m = split_pairs(coarse.mask)
        src_corr, tgt_corr = split_pairs(corr, dim=1)
        src_l, tgt_l = split_pairs(logits, dim=1)
        w = torch.cat([torch.sigmoid(src_l) * src_m,
                       torch.sigmoid(tgt_l) * tgt_m], dim=2)
        n = corr.shape[0]
        a = torch.cat([src_xyz[None].expand(n, -1, -1, -1), tgt_corr], dim=2)
        b = torch.cat([src_corr, tgt_xyz[None].expand(n, -1, -1, -1)], dim=2)
        with torch.no_grad():
            pose = rigid_transform(a, b, w)
        return {"feats_un": feats_un, "feats_cond": feats, "kp":
                coarse.points, "kp_mask": coarse.mask, "corr": corr,
                "overlap_logits": logits, "pose": pose}

    def forward(self, points, mask):
        return self.forward_levels(self.pyramid(points, mask))

    def losses(self, levels, pose_gt, overlap0):
        """The weighted training losses of the configuration ('total' and
        each term) on the forward of `levels`."""
        cfg = self.cfg
        out = self.forward_levels(levels)
        last = cfg["num_encoder_layers"] - 1
        ov_c = pyramid.overlap_pyramid(overlap0.gather(1, levels[0].perm),
                                       levels)[-1]
        kp, kp_mask = out["kp"], out["kp_mask"]
        src_kp, tgt_kp = split_pairs(kp)
        src_m, tgt_m = split_pairs(kp_mask)
        src_ov, tgt_ov = split_pairs(ov_c)
        warped = se3_transform(pose_gt, src_kp)
        losses, weights = {}, {}
        for i in cfg["overlap_loss_on"]:
            losses[f"overlap_{i}"] = overlap_loss(out["overlap_logits"][i],
                                                  ov_c, kp_mask)
            weights[f"overlap_{i}"] = cfg.get("wt_overlap", 1.0)
        for i in cfg["feature_loss_on"]:
            f_src, f_tgt = split_pairs(out["feats_cond"][i])
            losses[f"feature_{i}"] = infonce(
                self.feature_criterion.W, f_src, f_tgt, warped, tgt_kp,
                src_m, tgt_m, cfg["r_p"], cfg["r_n"])
            weights[f"feature_{i}"] = cfg.get("wt_feature", 0.1)
        fu_src, fu_tgt = split_pairs(out["feats_un"])
        losses["feature_un"] = infonce(
            self.feature_criterion_un.W, fu_src, fu_tgt, warped, tgt_kp,
            src_m, tgt_m, cfg["r_p"], cfg["r_n"])
        weights["feature_un"] = cfg.get("wt_feature_un", 0.0)
        inv = se3_inv(pose_gt)
        for i in cfg["corr_loss_on"]:
            c_src, c_tgt = split_pairs(out["corr"][i])
            losses[f"corr_{i}"] = (corr_loss(src_kp, c_src, pose_gt, src_ov)
                                   + corr_loss(tgt_kp, c_tgt, inv, tgt_ov))
            weights[f"corr_{i}"] = cfg.get("wt_corr", 1.0)
        losses["total"] = sum(losses[k] * weights[k] for k in weights)
        return losses, out


def overlap_loss(logits, labels, mask):
    """Binary cross-entropy with logits, the mean over valid points."""
    elt = (logits.clamp_min(0.0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    m = mask.to(elt.dtype)
    return (elt * m).sum() / m.sum().clamp_min(1.0)


def masked_logsumexp(logits, mask, dim=-1):
    masked = torch.where(mask, logits, NEG_INF)
    m = masked.amax(dim=dim, keepdim=True).clamp_min(NEG_INF)
    e = torch.exp(masked - m) * mask.to(logits.dtype)
    out = m.squeeze(dim) + torch.log(e.sum(dim=dim).clamp_min(1e-30))
    return torch.where(mask.any(dim=dim), out, NEG_INF)


def infonce(w, anchor, positive, anchor_xyz, positive_xyz, a_mask, p_mask,
            r_p, r_n):
    """InfoNCE with the bilinear similarity of the symmetric part of W's
    upper triangle; the positive is the anchor's nearest aligned point
    within r_p, points within r_n besides it leave the denominator."""
    w_triu = torch.triu(w)
    logits = (anchor @ (w_triu + w_triu.t())) @ positive.transpose(-1, -2)
    a_sq = (anchor_xyz * anchor_xyz).sum(-1)[..., :, None]
    p_sq = (positive_xyz * positive_xyz).sum(-1)[..., None, :]
    sqd = (a_sq - 2.0 * (anchor_xyz @ positive_xyz.transpose(-1, -2))
           + p_sq).clamp_min(0.0)
    sqd = torch.where(p_mask[:, None, :], sqd, 1.0e9)
    idx = sqd.argmin(dim=-1)
    d1 = sqd.gather(-1, idx[..., None])[..., 0]
    match = ((d1 < r_p ** 2) & a_mask).float()
    pos = torch.arange(logits.shape[-1],
                       device=logits.device) == idx[..., None]
    keep = ~((sqd < r_n ** 2) & ~pos) & p_mask[:, None, :]
    per_anchor = (masked_logsumexp(logits, keep)
                  - logits.gather(-1, idx[..., None])[..., 0])
    per_pair = (per_anchor * match).sum(-1) / match.sum(-1).clamp_min(1.0)
    return per_pair.mean()


def corr_loss(kp, kp_warped_pred, pose_gt, weights):
    """Overlap-weighted L1 error of the predicted warped keypoints."""
    err = (kp_warped_pred - se3_transform(pose_gt, kp)).abs().sum(-1)
    return (weights * err).sum(dim=(-2, -1)) / weights.sum(
        dim=(-2, -1)).clamp_min(1e-6)
