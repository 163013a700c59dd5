"""The plain reference of GeoTransformer's inference (Qin et al., CVPR
2022; github.com/qinzheng93/GeoTransformer, experiment
geotransformer.3dmatch.stage4.gse.k3.max.oacl.stage2.sinkhorn: config.py,
backbone.py, model.py and geotransformer/modules/), in plain PyTorch and
float32, one pair at a time in upstream's stack mode: the pair's valid
points in one tensor (target, upstream's `ref`, first), no padding, so
that its group norm's statistics and its padding are its own.  It imports
nothing of the measured package.

The parameter names are those of the measured model's state_dict, so the
weights the benchmark draws load into both by name.

Departures from upstream, each in rounding or in what a benchmark run
needs:
  * the pyramid, the neighbour tables and the kernel points are the
    shared yardstick's (pyramid.py, kernel_points.py: the measured
    package's stated semantics, a bf16-rounded selection key), built on
    the padded batch and cut to each cloud's valid points; the upsampling
    table is the first entry of a radius-2r search of the same kind;
  * squared distances between points are computed elementwise,
    ((dx dx + dy dy) + dz dz), where upstream expands |x|^2 - 2 x.y +
    |y|^2: for the embedding's distances and nearest neighbours and for
    the point-to-node partition, so that the discrete choices are made on
    the same bits as the measured package's;
  * the 3x3 SVD of the weighted Procrustes runs on the tensors' device
    (upstream moves it to the CPU), by torch.linalg.svd;
  * the inputs are ones at every valid point, as in upstream's test
    path; there is no ground truth, and the training branches are absent.

Besides the outputs in the form the harness keeps the program's, each
batch's result carries what the check needs to judge the program's
discrete choices under the reference's own numbers: the dual-normalised
node scores, the transport's `alpha` and the settings.

Layout of the batch: points (2B, N0, 3) and mask (2B, N0), pairs
interleaved (slot 2i the source of pair i, 2i + 1 its target).
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import pyramid
from .kernel_points import kernel_points

SHADOW_COORD = 1e6
OT_INF = 1e12


def leaky_relu(x):
    return F.leaky_relu(x, negative_slope=0.1)


def sq_dist(a, b):
    """(..., N, 3), (..., M, 3) -> (..., N, M) squared distances,
    elementwise."""
    d = a[..., :, None, :] - b[..., None, :, :]
    dx, dy, dz = d.unbind(-1)
    return (dx * dx + dy * dy) + dz * dz


def nearest_first(sq, k, dim=-1):
    """The k smallest non-negative fp32 values along `dim`, equal values
    lowest index first (the int64 key of the value's bits, then the index)
    -> (values, indices)."""
    n = sq.shape[dim]
    idx = torch.arange(n, device=sq.device).reshape(
        (n,) + (1,) * (sq.dim() - 1 - dim % sq.dim()))
    key = (sq.contiguous().view(torch.int32).long() << 32) | idx
    top = key.topk(k, dim=dim, largest=False).values
    return (top >> 32).int().view(torch.float32), top & 0xFFFFFFFF


class GroupNorm(nn.Module):
    """Upstream's GroupNorm of (N, C) points: torch's over (1, C, N)."""

    def __init__(self, groups, channels):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return F.group_norm(x.t()[None], self.groups, self.weight, self.bias,
                            1e-5)[0].t()


class KPConv(nn.Module):
    """Rigid KPConv, linear influence max(0, 1 - |x - k| / sigma), the
    padding neighbour at 1e6 with zero features; the sum over kernel
    points divided by the count of neighbours whose feature sum is > 0."""

    def __init__(self, cfg, cin, cout, radius):
        super().__init__()
        self.sigma = radius * cfg["KP_extent"] / cfg["conv_radius"]
        p = cfg["num_kernel_points"]
        self.weights = nn.Parameter(torch.zeros(p, cin, cout))
        self.register_buffer("kernel_points", torch.from_numpy(kernel_points(
            radius, p, cfg.get("kernel_seed", 0))), persistent=False)

    def forward(self, x, q_pts, s_pts, nbr):
        s_pad = torch.cat([s_pts, torch.full_like(s_pts[:1], SHADOW_COORD)])
        x_pad = torch.cat([x, torch.zeros_like(x[:1])])
        rel = s_pad[nbr] - q_pts[:, None]                      # (Nq, K, 3)
        diff = rel[:, :, None, :] - self.kernel_points         # (Nq, K, P, 3)
        sq = (diff * diff).sum(-1)
        infl = (1.0 - torch.sqrt(sq) / self.sigma).clamp_min(0.0)
        feats = x_pad[nbr]                                     # (Nq, K, C)
        weighted = infl.transpose(1, 2) @ feats                # (Nq, P, C)
        out = (weighted.transpose(0, 1) @ self.weights).sum(0)
        count = (feats.sum(-1) > 0.0).sum(-1).clamp_min(1)
        return out / count[:, None]


class UnaryBlock(nn.Module):
    def __init__(self, cin, cout, groups, relu=True):
        super().__init__()
        self.mlp = nn.Linear(cin, cout)
        self.norm = GroupNorm(groups, cout)
        self.relu = relu

    def forward(self, x):
        x = self.norm(self.mlp(x))
        return leaky_relu(x) if self.relu else x


class ConvBlock(nn.Module):
    def __init__(self, cfg, cin, cout, radius):
        super().__init__()
        self.KPConv = KPConv(cfg, cin, cout, radius)
        self.norm = GroupNorm(cfg["group_norm"], cout)

    def forward(self, x, q_pts, s_pts, nbr):
        return leaky_relu(self.norm(self.KPConv(x, q_pts, s_pts, nbr)))


class ResidualBlock(nn.Module):
    def __init__(self, cfg, cin, cout, radius, strided=False):
        super().__init__()
        g, mid = cfg["group_norm"], cout // 4
        self.strided = strided
        self.unary1 = UnaryBlock(cin, mid, g) if cin != mid else None
        self.KPConv = KPConv(cfg, mid, mid, radius)
        self.norm_conv = GroupNorm(g, mid)
        self.unary2 = UnaryBlock(mid, cout, g, relu=False)
        self.unary_shortcut = (UnaryBlock(cin, cout, g, relu=False)
                               if cin != cout else None)

    def forward(self, x, q_pts, s_pts, nbr):
        h = self.unary1(x) if self.unary1 is not None else x
        h = leaky_relu(self.norm_conv(self.KPConv(h, q_pts, s_pts, nbr)))
        h = self.unary2(h)
        if self.strided:
            shortcut = torch.cat([x, torch.zeros_like(x[:1])])[nbr].amax(1)
        else:
            shortcut = x
        if self.unary_shortcut is not None:
            shortcut = self.unary_shortcut(shortcut)
        return leaky_relu(h + shortcut)


class Backbone(nn.Module):
    """Upstream's KPConvFPN."""

    PLAN = (("encoder1_1", 1, 1, 0, False), ("encoder1_2", 1, 2, 0, False),
            ("encoder2_1", 2, 2, 0, True), ("encoder2_2", 2, 4, 1, False),
            ("encoder2_3", 4, 4, 1, False), ("encoder3_1", 4, 4, 1, True),
            ("encoder3_2", 4, 8, 2, False), ("encoder3_3", 8, 8, 2, False),
            ("encoder4_1", 8, 8, 2, True), ("encoder4_2", 8, 16, 3, False),
            ("encoder4_3", 16, 16, 3, False))

    def __init__(self, cfg):
        super().__init__()
        d = cfg["init_dim"]
        r = cfg["first_subsampling_dl"] * cfg["conv_radius"]
        for name, cin, cout, level, strided in self.PLAN:
            if name == "encoder1_1":
                block = ConvBlock(cfg, cfg["in_feats_dim"], d, r)
            else:
                block = ResidualBlock(cfg, cin * d, cout * d,
                                      r * 2 ** level, strided)
            self.add_module(name, block)
        self.decoder3 = UnaryBlock(24 * d, 8 * d, cfg["group_norm"])
        self.decoder2 = nn.Linear(12 * d, cfg["output_dim"])

    def forward(self, feats, pts, nbrs, subs, ups):
        """Stack-mode tables of each level: points, neighbours,
        subsampling (to the next level) and upsampling (from it)."""
        feats_by_level = {}
        x = feats
        for name, _, _, level, strided in self.PLAN:
            if strided:
                x = getattr(self, name)(x, pts[level + 1], pts[level],
                                        subs[level])
            else:
                x = getattr(self, name)(x, pts[level], pts[level],
                                        nbrs[level])
            feats_by_level[level + int(strided)] = x

        def up(x, level):
            return torch.cat([x, torch.zeros_like(x[:1])])[ups[level][:, 0]]

        lat3 = self.decoder3(torch.cat([up(feats_by_level[3], 2),
                                        feats_by_level[2]], 1))
        lat2 = self.decoder2(torch.cat([up(lat3, 1), feats_by_level[1]], 1))
        return feats_by_level[3], lat2


def sinusoidal_embedding(x, d_model):
    div = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                 device=x.device)
                    * (-math.log(10000.0) / d_model))
    omegas = x.reshape(-1, 1, 1) * div.reshape(1, -1, 1)
    emb = torch.cat([torch.sin(omegas), torch.cos(omegas)], dim=2)
    return emb.reshape(x.shape + (d_model,))


class Embedding(nn.Module):
    """Upstream's GeometricStructureEmbedding of one cloud (N, 3)."""

    def __init__(self, cfg):
        super().__init__()
        d = cfg["geo_hidden_dim"]
        self.d = d
        self.sigma_d = cfg["geo_sigma_d"]
        self.factor_a = 180.0 / (cfg["geo_sigma_a"] * math.pi)
        self.k = cfg["geo_angle_k"]
        self.proj_d = nn.Linear(d, d)
        self.proj_a = nn.Linear(d, d)

    def forward(self, points):
        n = points.shape[0]
        sq = sq_dist(points, points)
        d_idx = torch.sqrt(sq) / self.sigma_d
        knn = nearest_first(sq, self.k + 1)[1][:, 1:]
        ref = (points[knn] - points[:, None])[:, None].expand(
            n, n, self.k, 3)                                   # (N, N, k, 3)
        anc = (points[None] - points[:, None])[:, :, None].expand(
            n, n, self.k, 3)
        sin = torch.linalg.norm(torch.cross(ref, anc, dim=-1), dim=-1)
        cos = (ref * anc).sum(-1)
        a_idx = torch.atan2(sin, cos) * self.factor_a
        emb_d = self.proj_d(sinusoidal_embedding(d_idx, self.d))
        emb_a = self.proj_a(sinusoidal_embedding(a_idx, self.d)).amax(2)
        return emb_d + emb_a


class FeedForward(nn.Module):
    def __init__(self, d):
        super().__init__()
        self.expand = nn.Linear(d, 2 * d)
        self.squeeze = nn.Linear(2 * d, d)
        self.norm = nn.LayerNorm(d)

    def forward(self, x):
        return self.norm(x + self.squeeze(F.relu(self.expand(x))))


class Attention(nn.Module):
    def __init__(self, d):
        super().__init__()
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            setattr(self, name, nn.Linear(d, d))


def heads(x, h):
    return x.reshape(x.shape[0], h, -1).transpose(0, 1)       # (h, N, c)


class SelfLayer(nn.Module):
    """RPETransformerLayer: scores (q.k + q.p) / sqrt(d_head)."""

    def __init__(self, d, h):
        super().__init__()
        self.h = h
        for name in ("q_proj", "k_proj", "v_proj", "p_proj", "out_proj"):
            setattr(self, name, nn.Linear(d, d))
        self.norm = nn.LayerNorm(d)
        self.output = FeedForward(d)

    def forward(self, x, emb):
        n, d = x.shape
        q, k, v = (heads(p(x), self.h) for p in (self.q_proj, self.k_proj,
                                                self.v_proj))
        p = self.p_proj(emb).reshape(n, n, self.h, -1).permute(2, 0, 1, 3)
        s = (torch.einsum("hnc,hmc->hnm", q, k)
             + torch.einsum("hnc,hnmc->hnm", q, p)) / math.sqrt(d // self.h)
        o = (torch.softmax(s, -1) @ v).transpose(0, 1).reshape(n, d)
        return self.output(self.norm(self.out_proj(o) + x))


class CrossLayer(nn.Module):
    def __init__(self, d, h):
        super().__init__()
        self.h = h
        self.attn = Attention(d)
        self.norm = nn.LayerNorm(d)
        self.output = FeedForward(d)

    def forward(self, x, memory):
        a = self.attn
        n, d = x.shape
        q = heads(a.q_proj(x), self.h)
        k, v = heads(a.k_proj(memory), self.h), heads(a.v_proj(memory), self.h)
        s = torch.einsum("hnc,hmc->hnm", q, k) / math.sqrt(d // self.h)
        o = (torch.softmax(s, -1) @ v).transpose(0, 1).reshape(n, d)
        return self.output(self.norm(a.out_proj(o) + x))


class Transformer(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        d, h = cfg["geo_hidden_dim"], cfg["geo_num_heads"]
        self.blocks = list(cfg["geo_blocks"])
        self.embedding = Embedding(cfg)
        self.in_proj = nn.Linear(cfg["geo_input_dim"], d)
        self.layers = nn.ModuleList(SelfLayer(d, h) if b == "self"
                                    else CrossLayer(d, h)
                                    for b in self.blocks)
        self.out_proj = nn.Linear(d, cfg["geo_output_dim"])

    def forward(self, ref_pts, src_pts, ref_feats, src_feats):
        ref_emb, src_emb = self.embedding(ref_pts), self.embedding(src_pts)
        ref, src = self.in_proj(ref_feats), self.in_proj(src_feats)
        for block, layer in zip(self.blocks, self.layers):
            if block == "self":
                ref, src = layer(ref, ref_emb), layer(src, src_emb)
            else:
                ref = layer(ref, src)
                src = layer(src, ref)
        return self.out_proj(ref), self.out_proj(src)


def point_to_node_partition(points, nodes, limit):
    """Upstream's, on elementwise squared distances -> (node_knn (M, K),
    its mask, node_mask (M,))."""
    sq = sq_dist(nodes, points)                                # (M, N)
    nearest = nearest_first(sq, 1, dim=0)[1][0]
    node_mask = torch.zeros(nodes.shape[0], dtype=torch.bool,
                            device=points.device)
    node_mask.index_fill_(0, nearest, True)
    own = torch.zeros_like(sq, dtype=torch.bool)
    own[nearest, torch.arange(points.shape[0], device=points.device)] = True
    sq = sq.masked_fill(~own, float("inf"))
    k = min(limit, points.shape[0])
    idx = nearest_first(sq, k)[1]
    knn_mask = nearest[idx] == torch.arange(
        nodes.shape[0], device=points.device)[:, None]
    if k < limit:
        idx = torch.cat([idx, idx.new_zeros(idx.shape[0], limit - k)], 1)
        knn_mask = torch.cat([knn_mask, knn_mask.new_zeros(
            idx.shape[0], limit - k)], 1)
    return idx.masked_fill(~knn_mask, points.shape[0]), knn_mask, node_mask


def dual_scores(ref_feats, src_feats, ref_mask, src_mask, dual=True):
    """The dual-normalised node scores over the valid nodes: (M_r, M_s),
    -1 where either node has an empty patch."""
    r_idx = torch.nonzero(ref_mask, as_tuple=True)[0]
    s_idx = torch.nonzero(src_mask, as_tuple=True)[0]
    sq = (2.0 - 2.0 * ref_feats[r_idx] @ src_feats[s_idx].t()).clamp_min(0.0)
    s = torch.exp(-sq)
    if dual:
        s = (s / s.sum(1, keepdim=True)) * (s / s.sum(0, keepdim=True))
    out = torch.full((ref_feats.shape[0], src_feats.shape[0]), -1.0,
                     device=s.device)
    out[r_idx[:, None], s_idx[None, :]] = s
    return out


def superpoint_matching(scores, k):
    """Top-k of the valid entries of `dual_scores` -> (ref, src, score)."""
    flat = scores.reshape(-1)
    valid = torch.nonzero(flat >= 0.0, as_tuple=True)[0]
    vals, sel = flat[valid].topk(min(k, valid.shape[0]))
    idx = valid[sel]
    m = scores.shape[1]
    return idx // m, idx % m, vals


def log_optimal_transport(scores, row_masks, col_masks, alpha, iterations):
    """Upstream's LearnableLogOptimalTransport.forward: (P, R, C) ->
    (P, R + 1, C + 1)."""
    b, nr, nc = scores.shape
    pad_r = torch.zeros(b, nr + 1, dtype=torch.bool, device=scores.device)
    pad_r[:, :nr] = ~row_masks
    pad_c = torch.zeros(b, nc + 1, dtype=torch.bool, device=scores.device)
    pad_c[:, :nc] = ~col_masks
    padded = torch.cat([torch.cat([scores, alpha.expand(b, nr, 1)], -1),
                        alpha.expand(b, 1, nc + 1)], 1)
    padded = padded.masked_fill(pad_r[:, :, None] | pad_c[:, None, :],
                                -OT_INF)
    n_r, n_c = row_masks.float().sum(1), col_masks.float().sum(1)
    norm = -torch.log(n_r + n_c)
    log_mu = torch.empty(b, nr + 1, device=scores.device)
    log_mu[:, :nr] = norm[:, None]
    log_mu[:, nr] = torch.log(n_c) + norm
    log_mu[pad_r] = -OT_INF
    log_nu = torch.empty(b, nc + 1, device=scores.device)
    log_nu[:, :nc] = norm[:, None]
    log_nu[:, nc] = torch.log(n_r) + norm
    log_nu[pad_c] = -OT_INF
    u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
    for _ in range(iterations):
        u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
        v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
    return padded + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def correspondence_matrix(score_mat, ref_masks, src_masks, k, threshold):
    """Upstream's compute_correspondence_matrix (mutual)."""
    b, r, c = score_mat.shape
    bi = torch.arange(b, device=score_mat.device)
    rv, ri = score_mat.topk(k=k, dim=2)
    ref_sm = torch.zeros_like(score_mat)
    ref_sm[bi[:, None, None], torch.arange(r, device=ri.device)[
        None, :, None], ri] = rv
    cv, ci = score_mat.topk(k=k, dim=1)
    src_sm = torch.zeros_like(score_mat)
    src_sm[bi[:, None, None], ci, torch.arange(c, device=ci.device)[
        None, None, :]] = cv
    corr = (ref_sm > threshold) & (src_sm > threshold)
    return corr & ref_masks[:, :, None] & src_masks[:, None, :]


def weighted_procrustes(src, ref, weights, eps=1e-5):
    """Upstream's weighted_procrustes (weight_thresh 0): (B, N, 3) x2,
    (B, N) -> (B, 3, 4) mapping src onto ref."""
    w = torch.where(weights < 0.0, torch.zeros_like(weights), weights)
    w = (w / (w.sum(1, keepdim=True) + eps))[..., None]
    cs = (src * w).sum(1, keepdim=True)
    cr = (ref * w).sum(1, keepdim=True)
    h = (src - cs).transpose(1, 2) @ (w * (ref - cr))
    u, _, vh = torch.linalg.svd(h)
    v, ut = vh.transpose(1, 2), u.transpose(1, 2)
    eye = torch.eye(3, device=src.device).repeat(src.shape[0], 1, 1)
    eye[:, -1, -1] = torch.sign(torch.linalg.det(v @ ut))
    rot = v @ eye @ ut
    t = cr.transpose(1, 2) - rot @ cs.transpose(1, 2)
    return torch.cat([rot, t], dim=2)


def apply_transform(pose, points):
    rot, trans = pose[..., :3, :3], pose[..., None, :3, 3]
    return points @ rot.transpose(-1, -2) + trans


def residuals(pose, src, ref):
    return torch.linalg.norm(ref - apply_transform(pose, src), dim=-1)


def local_to_global(ref_pts, src_pts, score_mat, corr, s):
    """Upstream's local_to_global_registration -> (best patch pair, -1 in
    the degenerate branch; the inlier masks before each refinement solve
    (steps, N); the pose)."""
    radius, steps = s["radius"], s["steps"]
    b_idx, r_idx, c_idx = torch.nonzero(corr, as_tuple=True)
    ref_c, src_c = ref_pts[b_idx, r_idx], src_pts[b_idx, c_idx]
    scores = score_mat[b_idx, r_idx, c_idx]
    n = b_idx.shape[0]
    pairs, counts = torch.unique_consecutive(b_idx, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    chunks = [(int(p), int(a), int(a + c)) for p, a, c in zip(
        pairs.tolist(), starts.tolist(), counts.tolist())
        if c >= s["corr_threshold"]]
    best = -1
    if chunks:
        hyps = torch.stack([weighted_procrustes(
            src_c[None, a:e], ref_c[None, a:e], scores[None, a:e])[0]
            for _, a, e in chunks])
        inliers = residuals(hyps, src_c, ref_c) < radius
        pick = int(inliers.sum(1).argmax())
        best = chunks[pick][0]
        mask = inliers[pick]
    else:
        first = weighted_procrustes(src_c[None], ref_c[None], scores[None])
        mask = residuals(first, src_c[None], ref_c[None])[0] < radius
    masks = [mask]
    for step in range(steps):
        pose = weighted_procrustes(src_c[None], ref_c[None],
                                   (scores * masks[-1])[None])
        if step + 1 < steps:
            masks.append(residuals(pose, src_c[None], ref_c[None])[0]
                         < radius)
    return best, torch.stack(masks) if n else torch.zeros(
        steps, 0, dtype=torch.bool, device=corr.device), pose[0]


def settings(cfg) -> dict:
    return {"iterations": int(cfg["num_sinkhorn_iterations"]),
            "topk": int(cfg["fine_topk"]),
            "threshold": float(cfg["fine_confidence_threshold"]),
            "radius": float(cfg["fine_acceptance_radius"]),
            "corr_threshold": int(cfg["fine_correspondence_threshold"]),
            "steps": int(cfg["fine_num_refinement_steps"]),
            "correspondences": int(cfg["num_correspondences"]),
            "patch": int(cfg["num_points_in_patch"])}


class GeoTransformer(nn.Module):
    def __init__(self, cfg, n0: int):
        super().__init__()
        if float(cfg.get("dropout", 0.0)) or cfg.get(
                "compute_dtype", "float32") != "float32":
            raise ValueError("the reference runs fp32 without dropout")
        self.cfg = cfg
        self.spec = pyramid.make_spec(cfg, n0)
        self.settings = settings(cfg)
        self.backbone = Backbone(cfg)
        self.transformer = Transformer(cfg)
        self.optimal_transport = nn.Module()
        self.optimal_transport.alpha = nn.Parameter(torch.tensor(1.0))

    def pyramid(self, points, mask):
        """The shared pyramid with each level's upsampling table (the
        finer level's queries into the next at twice the radius)."""
        levels = pyramid.build(points, mask, self.spec)
        ups = []
        for li in range(len(levels) - 1):
            a, b = levels[li], levels[li + 1]
            ups.append(pyramid.radius_neighbors(
                a.points, a.mask, b.points, b.mask, 2.0 * self.spec.radii[li],
                self.spec.ks[li + 1]))
        return levels, ups

    def stack(self, levels, ups, i):
        """Pair i's stack-mode tables (target first): per level its valid
        points, counts and tables with the stack's pad row."""
        out = {"pts": [], "lens": [], "nbrs": [], "subs": [], "ups": []}

        def remap(table, level, rows):
            """Rows `rows` of a table of cloud slot `c` into level's
            stack (ids of the pad slot -> the stack's pad row)."""
            parts = []
            for c, n in rows:
                t = table[c, :n]
                shadow = levels[level].points.shape[1]
                off = 0 if c == 2 * i + 1 else out["lens"][level][0]
                total = sum(out["lens"][level])
                parts.append(torch.where(t < shadow, t + off, total))
            return torch.cat(parts)

        for li, lvl in enumerate(levels):
            n = [int(lvl.mask[2 * i + 1].sum()), int(lvl.mask[2 * i].sum())]
            out["lens"].append(n)
            out["pts"].append(torch.cat([lvl.points[2 * i + 1, :n[0]],
                                         lvl.points[2 * i, :n[1]]]))
        for li, lvl in enumerate(levels):
            rows = list(zip((2 * i + 1, 2 * i), out["lens"][li]))
            out["nbrs"].append(remap(lvl.neighbors, li, rows))
            if li + 1 < len(levels):
                nxt = list(zip((2 * i + 1, 2 * i), out["lens"][li + 1]))
                out["subs"].append(remap(lvl.pools, li, nxt))
                out["ups"].append(remap(ups[li], li + 1, rows))
        return out

    def pair(self, st):
        """One pair in stack mode -> dict of its per-cloud results."""
        s = self.settings
        pts, lens = st["pts"], st["lens"]
        feats = torch.ones(pts[0].shape[0], self.cfg["in_feats_dim"],
                           device=pts[0].device)
        feats_c, feats_f = self.backbone(feats, pts, st["nbrs"], st["subs"],
                                         st["ups"])
        (nr_c, ns_c), (nr_f, ns_f) = lens[3], lens[1]
        ref_c, src_c = self.transformer(pts[3][:nr_c], pts[3][nr_c:],
                                        feats_c[:nr_c], feats_c[nr_c:])
        ref_c, src_c = F.normalize(ref_c, dim=1), F.normalize(src_c, dim=1)
        ref_f, src_f = feats_f[:nr_f], feats_f[nr_f:]
        ref_pf, src_pf = pts[1][:nr_f], pts[1][nr_f:]
        ref_knn, ref_km, ref_nm = point_to_node_partition(
            ref_pf, pts[3][:nr_c], s["patch"])
        src_knn, src_km, src_nm = point_to_node_partition(
            src_pf, pts[3][nr_c:], s["patch"])
        dual = dual_scores(ref_c, src_c, ref_nm, src_nm)
        node_ref, node_src, _ = superpoint_matching(dual, s["correspondences"])
        ot = transport(ref_f, src_f, ref_knn, src_knn, ref_km, src_km,
                       node_ref, node_src, self.optimal_transport.alpha, s)
        k = s["patch"]
        ot = ot[:, :k, :k]
        ref_kp = torch.cat([ref_pf, torch.zeros_like(ref_pf[:1])])[
            ref_knn[node_ref]]
        src_kp = torch.cat([src_pf, torch.zeros_like(src_pf[:1])])[
            src_knn[node_src]]
        p = torch.exp(ot)
        corr = correspondence_matrix(p, ref_km[node_ref], src_km[node_src],
                                     s["topk"], s["threshold"])
        best, masks, pose = local_to_global(ref_kp, src_kp, p * corr, corr,
                                            s)
        return {"ref_c": ref_c, "src_c": src_c, "ref_f": ref_f,
                "src_f": src_f, "ref_knn": ref_knn.masked_fill(~ref_km, -1),
                "src_knn": src_knn.masked_fill(~src_km, -1), "dual": dual,
                "node_ref": node_ref, "node_src": node_src, "ot": ot,
                "corr": corr, "best": best, "inliers": masks, "pose": pose}

    def forward(self, points, mask):
        """The batch, pair by pair -> keep's form on the host, with the
        extras (`dual`, `alpha`, `settings`)."""
        s = self.settings
        levels, ups = self.pyramid(points, mask)
        coarse, fine = levels[-1], levels[1]
        b2 = points.shape[0]
        m = max(int(coarse.mask.sum(1).max()), 1)
        n1 = fine.points.shape[1]
        d_c = self.cfg["geo_output_dim"]
        d_f = self.cfg["output_dim"]
        p, k = s["correspondences"], s["patch"]
        cap = p * k * s["topk"]
        b = b2 // 2
        out = {"pose": torch.zeros(b, 3, 4), "kp": coarse.points.cpu(),
               "kp_mask": coarse.mask.cpu(), "fine_points": fine.points.cpu(),
               "fine_mask": fine.mask.cpu(),
               "feats_c": torch.zeros(b2, m, d_c),
               "feats_f": torch.zeros(b2, n1, d_f),
               "patches": torch.full((b2, m, k), -1, dtype=torch.long),
               "node_ref": torch.zeros(b, p, dtype=torch.long),
               "node_src": torch.zeros(b, p, dtype=torch.long),
               "node_valid": torch.zeros(b, p, dtype=torch.bool),
               "ot": torch.zeros(b, p, k, k),
               "corr": torch.zeros(b, p, k, k, dtype=torch.bool),
               "best": torch.full((b,), -1, dtype=torch.long),
               "inliers": torch.zeros(b, s["steps"], cap, dtype=torch.bool),
               "dual": torch.full((b, m, m), -1.0),
               "alpha": self.optimal_transport.alpha.detach().cpu(),
               "settings": dict(s)}
        for i in range(b):
            r = {key: (v.cpu() if torch.is_tensor(v) else v) for key, v in
                 self.pair(self.stack(levels, ups, i)).items()}
            for side, slot in (("ref", 2 * i + 1), ("src", 2 * i)):
                c, f = r[side + "_c"], r[side + "_f"]
                out["feats_c"][slot, :c.shape[0]] = c
                out["feats_f"][slot, :f.shape[0]] = f
                knn = r[side + "_knn"]
                out["patches"][slot, :knn.shape[0]] = knn
            n = r["node_ref"].shape[0]
            out["node_ref"][i, :n] = r["node_ref"]
            out["node_src"][i, :n] = r["node_src"]
            out["node_valid"][i, :n] = True
            out["ot"][i, :n] = r["ot"]
            out["corr"][i, :n] = r["corr"]
            out["best"][i] = r["best"]
            out["inliers"][i, :, :r["inliers"].shape[1]] = r["inliers"]
            out["pose"][i] = r["pose"]
            dual = r["dual"]
            out["dual"][i, :dual.shape[0], :dual.shape[1]] = dual
        return out


def transport(ref_f, src_f, ref_knn, src_knn, ref_km, src_km, node_ref,
              node_src, alpha, s):
    """The transport's log scores of the node pairs (node_ref, node_src)
    on the patches (knn, with their masks) of the fine features."""
    ref_pad = torch.cat([ref_f, torch.zeros_like(ref_f[:1])])
    src_pad = torch.cat([src_f, torch.zeros_like(src_f[:1])])
    rf = ref_pad[ref_knn[node_ref]]
    sf = src_pad[src_knn[node_src]]
    scores = torch.einsum("bnd,bmd->bnm", rf, sf) / ref_f.shape[1] ** 0.5
    return log_optimal_transport(scores, ref_km[node_ref], src_km[node_src],
                                 alpha, s["iterations"])
