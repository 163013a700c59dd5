"""GeoTransformer's matching and registration at fixed shapes: the
point-to-node partition, superpoint matching, the learnable log-domain
optimal transport and the local-to-global registration.

Every shape is fixed by the configuration and the batch's capacities, so
that the forward does not wait on the host before its poses: the
correspondences are compacted into a capacity of (node pairs x patch
size x top-k) a pair, in `torch.nonzero`'s row-major order, with a mask,
and a pair with no patch pair of `correspondence_threshold` or more
correspondences takes upstream's degenerate branch by a select.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..core.se3 import compute_rigid_transform, se3_transform

OT_INF = 1e12        # upstream's `inf` of the transport's masked entries
PROCRUSTES_EPS = 1e-5


def nearest_first(sq, k: int, dim: int = -1):
    """The k smallest of non-negative fp32 `sq` along `dim`, smallest
    first, equal values lowest index first (one int64 key: the value's
    bits, then the index) -> (values, indices).  The order is the same on
    every device and at every batch shape."""
    n = sq.shape[dim]
    idx = torch.arange(n, device=sq.device).reshape(
        (n,) + (1,) * (sq.dim() - 1 - dim % sq.dim()))
    key = (sq.contiguous().view(torch.int32).long() << 32) | idx
    top = key.topk(k, dim=dim, largest=False).values
    return (top >> 32).int().view(torch.float32), top & 0xFFFFFFFF


def point_to_node_partition(points, p_mask, nodes, n_mask, limit: int):
    """Each valid point goes to its nearest valid node; each node keeps up
    to `limit` of its own points, nearest first (ties: lowest index
    first).  points (C, N, 3), nodes (C, M, 3) -> (indices (C, M, limit)
    into the N points, N where empty; their mask; node_mask (C, M): nodes
    with a point).  Squared distances elementwise, ((dx dx + dy dy) + dz
    dz), so that a reference that does the same chooses the same points."""
    n = points.shape[1]
    d = nodes[:, :, None, :] - points[:, None, :, :]
    dx, dy, dz = d.unbind(-1)
    sq = (dx * dx + dy * dy) + dz * dz                       # (C, M, N)
    sq = torch.where(n_mask[:, :, None] & p_mask[:, None, :], sq,
                     float("inf"))
    nearest = nearest_first(sq, 1, dim=1)[1][:, 0]            # (C, N)
    own = (nearest[:, None, :] == torch.arange(
        nodes.shape[1], device=points.device)[None, :, None]) \
        & p_mask[:, None, :]
    vals, idx = nearest_first(torch.where(own, sq, float("inf")),
                              min(limit, n))
    knn_mask = torch.isfinite(vals)
    if limit > n:
        pad = limit - n
        idx = torch.cat([idx, idx.new_full(idx.shape[:2] + (pad,), n)], 2)
        knn_mask = torch.cat([knn_mask, knn_mask.new_zeros(
            knn_mask.shape[:2] + (pad,))], 2)
    return torch.where(knn_mask, idx, n), knn_mask, knn_mask.any(-1)


def superpoint_matching(ref_feats, src_feats, ref_mask, src_mask, k: int,
                        dual: bool = True):
    """Top-k node pairs of s_ij = exp(-(2 - 2 f_i.f_j)) (L2-normalised
    features), dual-normalised (s / row sum * s / column sum) over the
    valid nodes.  feats (B, M, d), masks (B, M) -> (ref index, src index,
    score, valid), each (B, k), by score, highest first."""
    m = ref_feats.shape[1]
    valid = ref_mask[:, :, None] & src_mask[:, None, :]
    sq = (2.0 - 2.0 * (ref_feats @ src_feats.transpose(1, 2))).clamp_min(0.0)
    s = torch.where(valid, torch.exp(-sq), 0.0)
    if dual:
        s = (s / s.sum(2, keepdim=True).clamp_min(1e-30)) * (
            s / s.sum(1, keepdim=True).clamp_min(1e-30))
    flat = torch.where(valid, s, -1.0).flatten(1)
    scores, idx = flat.topk(min(k, flat.shape[1]), dim=1)
    return (idx.div(m, rounding_mode="floor"), idx.remainder(m), scores,
            scores >= 0.0)


class LogOptimalTransport(nn.Module):
    """Upstream's LearnableLogOptimalTransport: a dustbin row and column
    filled with the learnt 0-D `alpha`, masked entries at -1e12, and
    `iterations` log-domain Sinkhorn steps to the marginals (norm on
    every valid row, log(valid columns) + norm on the dustbin; likewise
    the columns; norm = -log(valid rows + valid columns)).  scores (P, R,
    C), masks (P, R), (P, C) -> (P, R + 1, C + 1) log scores plus -norm."""

    def __init__(self, iterations: int):
        super().__init__()
        self.iterations = iterations
        self.alpha = nn.Parameter(torch.empty(()))

    def forward(self, scores, row_mask, col_mask):
        p, r, c = scores.shape
        pad_r = torch.cat([~row_mask, row_mask.new_zeros(p, 1)], dim=1)
        pad_c = torch.cat([~col_mask, col_mask.new_zeros(p, 1)], dim=1)
        alpha = self.alpha.to(scores.dtype)
        padded = torch.cat([torch.cat([scores, alpha.expand(p, r, 1)], -1),
                            alpha.expand(p, 1, c + 1)], dim=1)
        padded = padded.masked_fill(pad_r[:, :, None] | pad_c[:, None, :],
                                    -OT_INF)
        n_r = row_mask.sum(1).to(scores.dtype)
        n_c = col_mask.sum(1).to(scores.dtype)
        # a pair with no valid row and column (an invalid node pair) reads
        # as one of a single entry, so that it stays finite
        norm = -torch.log((n_r + n_c).clamp_min(1.0))
        log_mu = torch.cat([norm[:, None].expand(p, r), (torch.log(
            n_c.clamp_min(1.0)) + norm)[:, None]], 1).masked_fill(pad_r,
                                                                  -OT_INF)
        log_nu = torch.cat([norm[:, None].expand(p, c), (torch.log(
            n_r.clamp_min(1.0)) + norm)[:, None]], 1).masked_fill(pad_c,
                                                                  -OT_INF)
        u, v = torch.zeros_like(log_mu), torch.zeros_like(log_nu)
        for _ in range(self.iterations):
            u = log_mu - torch.logsumexp(padded + v[:, None, :], dim=2)
            v = log_nu - torch.logsumexp(padded + u[:, :, None], dim=1)
        return padded + u[:, :, None] + v[:, None, :] - norm[:, None, None]


def mutual_topk(scores, k: int, threshold: float):
    """Entries among the k largest of their row and of their column, each
    above `threshold`: scores (..., R, C) -> bool (..., R, C)."""
    def top(dim):
        vals, idx = scores.topk(k, dim=dim)
        kept = torch.zeros_like(scores).scatter_(dim, idx, vals)
        return kept > threshold

    return top(-1) & top(-2)


def compact(flags, capacity: int):
    """The flat indices of each row's True entries in row-major order, at a
    fixed capacity: flags (B, L) -> (indices (B, capacity), valid (B,
    capacity)); `torch.nonzero`'s order without its host sync."""
    b, length = flags.shape
    pos = flags.long().cumsum(1) - 1
    dest = torch.where(flags, pos, capacity).clamp_max(capacity)
    out = torch.zeros(b, capacity + 1, dtype=torch.long, device=flags.device)
    out.scatter_(1, dest, torch.arange(length, device=flags.device)
                 .expand(b, -1))
    count = flags.sum(1, keepdim=True)
    valid = torch.arange(capacity, device=flags.device)[None] < count
    return torch.where(valid, out[:, :capacity], 0), valid


def residuals(pose, src, ref):
    """|T src - ref| for poses (..., 3, 4) and points (..., N, 3)."""
    return torch.linalg.vector_norm(se3_transform(pose, src) - ref, dim=-1)


def local_global_registration(ref_pts, src_pts, ref_mask, src_mask, log_scores,
                              pair_valid, cfg):
    """Upstream's LocalGlobalRegistration on fixed shapes.

    ref_pts, src_pts (B, P, K, 3) the patches' points; masks (B, P, K);
    log_scores (B, P, K, K) the transport's, dustbin dropped; pair_valid
    (B, P) -> {'corr' (B, P, K, K), 'best' (B,) the patch pair of the
    hypothesis kept (-1: the degenerate branch), 'hyp_counts' (B, P) each
    hypothesis's inliers (-1: below the threshold), 'inliers' (B, steps,
    capacity) the masks before each refinement solve, 'valid' (B,
    capacity), 'pose' (B, 3, 4) mapping the source onto the target}.
    """
    b, p, k, _ = log_scores.shape
    radius = float(cfg["fine_acceptance_radius"])
    steps = int(cfg["fine_num_refinement_steps"])
    s = torch.exp(log_scores)
    corr = (mutual_topk(s, int(cfg["fine_topk"]),
                        float(cfg["fine_confidence_threshold"]))
            & ref_mask[..., :, None] & src_mask[..., None, :]
            & pair_valid[..., None, None])
    w = s * corr

    # one hypothesis a patch pair of enough correspondences: entry (i, j)
    # pairs source point j with target point i
    a = src_pts[:, :, None].expand(b, p, k, k, 3).reshape(b, p, k * k, 3)
    t = ref_pts[:, :, :, None].expand(b, p, k, k, 3).reshape(b, p, k * k, 3)
    hyps = compute_rigid_transform(a, t, w.reshape(b, p, k * k),
                                   add_eps=PROCRUSTES_EPS)
    has = corr.sum((2, 3)) >= int(cfg["fine_correspondence_threshold"])

    capacity = p * k * int(cfg["fine_topk"])
    idx, valid = compact(corr.reshape(b, -1), capacity)
    pair, row, col = idx // (k * k), idx // k % k, idx % k
    c_ref = ref_pts.reshape(b, p * k, 3).gather(
        1, (pair * k + row)[..., None].expand(-1, -1, 3))
    c_src = src_pts.reshape(b, p * k, 3).gather(
        1, (pair * k + col)[..., None].expand(-1, -1, 3))
    c_w = torch.where(valid, w.reshape(b, -1).gather(1, idx), 0.0)

    inl = (residuals(hyps, c_src[:, None], c_ref[:, None]) < radius) \
        & valid[:, None]
    counts = torch.where(has, inl.sum(-1), -1)
    best = counts.argmax(dim=1)
    any_hyp = has.any(dim=1)
    first = compute_rigid_transform(c_src, c_ref, c_w,
                                    add_eps=PROCRUSTES_EPS)
    start = torch.where(
        any_hyp[:, None],
        inl.gather(1, best[:, None, None].expand(-1, 1, capacity))[:, 0],
        (residuals(first, c_src, c_ref) < radius) & valid)
    masks = [start]
    for step in range(steps):
        pose = compute_rigid_transform(c_src, c_ref, c_w * masks[-1],
                                       add_eps=PROCRUSTES_EPS)
        if step + 1 < steps:
            masks.append((residuals(pose, c_src, c_ref) < radius) & valid)
    return {"corr": corr, "best": torch.where(any_hyp, best, -1),
            "hyp_counts": counts, "inliers": torch.stack(masks, dim=1),
            "valid": valid, "pose": pose}
