"""Feature losses (counterparts of regtr_tpu/losses/feature.py): InfoNCE
with a learned symmetric bilinear similarity, and the circle losses, over
all descriptor pairs (`circle`) or over sampled groundtruth
correspondences (`circle_sampled`).

With several ranks each loss is this rank's numerator over the global
batch's denominator (parallel/dist.py): InfoNCE's count of pairs, the
circle losses' counts of selected rows and columns."""
from __future__ import annotations

import struct

import torch
import torch.nn as nn

from ..core.masking import masked_logsumexp
from ..ops.kpconv import GatherIndex, batched_row_gather
from ..parallel.dist import all_reduce_sum, global_mean

_INF = 1.0e9


def pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., N, 3) x (..., M, 3) -> (..., N, M) squared distances >= 0."""
    a_sq = (a * a).sum(dim=-1)[..., :, None]
    b_sq = (b * b).sum(dim=-1)[..., None, :]
    return (a_sq - 2.0 * (a @ b.transpose(-1, -2)) + b_sq).clamp_min(0.0)


class InfoNCELoss(nn.Module):
    """Masked InfoNCE.  For each valid anchor whose nearest point of the
    positive cloud (under the GT alignment) lies within r_p, the positive is
    that point; every other point within r_n is left out of the denominator.

    `W` is a trained (d, d) parameter, drawn at init from a normal of
    stddev 0.1 (models/__init__.py), as flax draws it.
    """

    def __init__(self, d_embed: int, r_p: float, r_n: float):
        super().__init__()
        self.r_p = r_p
        self.r_n = r_n
        self.W = nn.Parameter(torch.empty(d_embed, d_embed))

    def forward(self, anchor_feat, positive_feat, anchor_xyz, positive_xyz,
                anchor_mask, positive_mask):
        """anchor_feat (B, Na, D), positive_feat (B, Np, D), anchor_xyz
        (B, Na, 3) already GT-aligned, positive_xyz (B, Np, 3), masks
        (B, Na) / (B, Np) -> scalar, the mean over the (global) batch's
        pairs."""
        w_triu = torch.triu(self.W)
        w_sym = w_triu + w_triu.t()
        logits = (anchor_feat.float() @ w_sym) @ positive_feat.float(
        ).transpose(-1, -2)                                  # (B, Na, Np)

        sqd = pairwise_sqdist(anchor_xyz, positive_xyz)
        sqd = torch.where(positive_mask[:, None, :], sqd, _INF)
        idx1 = sqd.argmin(dim=-1)                           # (B, Na)
        d1 = sqd.gather(-1, idx1[..., None])[..., 0]
        match_mask = (d1 < self.r_p ** 2) & anchor_mask

        pos_onehot = (torch.arange(logits.shape[-1], device=logits.device)
                      == idx1[..., None])
        ignore = (sqd < self.r_n ** 2) & ~pos_onehot
        keep = ~ignore & positive_mask[:, None, :]

        pos_logit = logits.gather(-1, idx1[..., None])[..., 0]
        per_anchor = masked_logsumexp(logits, keep, dim=-1) - pos_logit
        m = match_mask.to(torch.float32)
        per_pair = (per_anchor * m).sum(dim=-1) / m.sum(dim=-1).clamp_min(1.0)
        return global_mean(per_pair)


def _feature_dist(feats_a, feats_b, dist_type):
    """(B, Na, D) x (B, Nb, D) -> (B, Na, Nb) descriptor distances."""
    if dist_type == "euclidean":
        return torch.sqrt(pairwise_sqdist(feats_a, feats_b) + 1e-12)
    if dist_type == "cosine":
        num = feats_a @ feats_b.transpose(-1, -2)
        den = (torch.linalg.vector_norm(feats_a, dim=-1)[..., :, None]
               * torch.linalg.vector_norm(feats_b, dim=-1)[..., None, :])
        return 1.0 - num / den.clamp_min(1e-8)
    raise ValueError(dist_type)


def _circle_core(coords_dist, fd, valid, r_p, r_n, log_scale, pos_margin,
                 neg_margin):
    """Circle loss on distance matrices coords_dist, fd, valid (B, Na, Nb):
    the mean of the row-wise and column-wise losses over the rows and
    columns that have both a positive and a negative."""
    pos_mask = (coords_dist < r_p) & valid
    neg_mask = (coords_dist > r_n) & valid
    row_sel = pos_mask.any(-1) & neg_mask.any(-1)            # (B, Na)
    col_sel = pos_mask.any(-2) & neg_mask.any(-2)            # (B, Nb)

    pos = fd - 1e5 * (~pos_mask).to(fd.dtype)
    pos_w = (pos - pos_margin).clamp_min(0.0).detach()
    pos_logits = log_scale * (pos - pos_margin) * pos_w
    neg = fd + 1e5 * (~neg_mask).to(fd.dtype)
    neg_w = (neg_margin - neg).clamp_min(0.0).detach()
    neg_logits = log_scale * (neg_margin - neg) * neg_w

    def softplus(x):        # jax.nn.softplus: log(1 + e^x), no cut-off
        return torch.logaddexp(x, torch.zeros_like(x))

    loss_row = softplus(torch.logsumexp(pos_logits, dim=-1)
                        + torch.logsumexp(neg_logits, dim=-1)) / log_scale
    loss_col = softplus(torch.logsumexp(pos_logits, dim=-2)
                        + torch.logsumexp(neg_logits, dim=-2)) / log_scale

    def sel_mean(x, sel):
        s = sel.to(x.dtype)
        return (x * s).sum() / all_reduce_sum(s.sum()).clamp_min(1.0)

    return (sel_mean(loss_row, row_sel) + sel_mean(loss_col, col_sel)) / 2.0


def circle_loss(feats_a, feats_b, xyz_a, xyz_b, mask_a, mask_b, r_p, r_n,
                log_scale=10.0, pos_margin=0.1, neg_margin=1.4,
                dist_type="euclidean"):
    """Masked circle loss over all descriptor pairs: feats (B, N, D), xyz
    (B, N, 3) (a's already GT-aligned), masks (B, N) -> scalar."""
    coords_dist = torch.sqrt(pairwise_sqdist(xyz_a, xyz_b) + 1e-12)
    fd = _feature_dist(feats_a.float(), feats_b.float(), dist_type)
    valid = mask_a[:, :, None] & mask_b[:, None, :]
    return _circle_core(coords_dist, fd, valid, r_p, r_n, log_scale,
                        pos_margin, neg_margin)


def correspondence_seed(xyz: torch.Tensor, salt: int) -> int:
    """A sampling seed from the bits of the fp32 sum of one pair's points
    `xyz` (N, 3) and a salt, as the JAX package folds them into its key:
    sampling is random across batches and repeatable on the same pair.
    The sum is taken on a host copy (one sync), so that it is the same
    whatever batch, rank or device the pair came on."""
    host = xyz.detach().to("cpu", torch.float32, copy=True)
    bits = struct.unpack("<i", struct.pack("<f", float(host.sum())))[0]
    return ((17 * 1_000_003 + bits) * 1_000_003 + int(salt)) % (2 ** 63)


def pair_generators(xyz: torch.Tensor, salt: int):
    """One generator per pair of xyz (B, N, 3), on its device, each seeded
    from that pair's points alone (`correspondence_seed`).  A pair's
    samples then depend on nothing but the pair and the salt: not on the
    other pairs of its batch, nor on how a batch is split across ranks."""
    return [torch.Generator(device=xyz.device).manual_seed(
        correspondence_seed(x, salt)) for x in xyz]


def _sample_pair(generator, xyz_a, xyz_b, mask_a, mask_b, r_p, n_sample):
    """`sample_correspondences` for one pair: (Na, 3), (Nb, 3), (Na,),
    (Nb,) -> (idx_a, idx_b, valid), (n_sample,) each."""
    # fresh copies: a product may take another kernel for an operand at
    # another alignment, and a pair's draws must not depend on where in a
    # batch it sat
    sqd = pairwise_sqdist(xyz_a.clone(), xyz_b.clone())
    cand = (sqd < (r_p - 1e-3) ** 2) & mask_a[:, None] & mask_b[None, :]
    na, nb = cand.shape
    flat = cand.reshape(-1)
    dev = flat.device
    u = torch.rand(flat.shape, generator=generator, device=dev)
    top_val, top_idx = torch.topk(torch.where(flat, u, -1.0), n_sample)
    count = flat.sum()
    r = torch.rand((n_sample,), generator=generator, device=dev)
    nth = torch.minimum((r * count).long(), (count - 1).clamp_min(0))
    idx_wr = torch.searchsorted(torch.cumsum(flat.long(), dim=0), nth + 1)
    idx = torch.where(top_val >= 0.0, top_idx,
                      idx_wr.clamp_max(na * nb - 1))
    return idx // nb, idx % nb, (count > 0).expand(n_sample)


def sample_correspondences(generators, xyz_a, xyz_b, mask_a, mask_b, r_p,
                           n_sample):
    """n_sample groundtruth correspondences per pair, drawn uniformly.

    A correspondence is any valid (i, j) with |xyz_a_i - xyz_b_j| <
    r_p - 1e-3.  Without replacement when a pair has at least n_sample of
    them (the n_sample largest of a uniform draw per candidate), else with
    replacement (each slot a uniform draw over the candidates), as the JAX
    package samples.  Pair i draws alone, from `generators[i]` (one per
    pair, on the points' device; `pair_generators`), so its samples do not
    depend on the rest of the batch.  Returns (idx_a, idx_b, valid):
    (B, n_sample) each; `valid` is False for pairs with no candidate
    (their indices are arbitrary).
    """
    if len(generators) != xyz_a.shape[0]:
        raise ValueError(f"{len(generators)} generators for "
                         f"{xyz_a.shape[0]} pairs")
    drawn = [_sample_pair(g, *args, r_p, n_sample) for g, *args in zip(
        generators, xyz_a, xyz_b, mask_a, mask_b)]
    return tuple(torch.stack(t) for t in zip(*drawn))


def circle_loss_sampled(feats_a, feats_b, xyz_a, xyz_b, mask_a, mask_b,
                        r_p, r_n, generators, n_sample=256, log_scale=10.0,
                        pos_margin=0.1, neg_margin=1.4,
                        dist_type="euclidean"):
    """Circle loss on n_sample sampled groundtruth correspondences per
    pair (`sample_correspondences`, pair i drawn from `generators[i]`): the
    (n_sample, n_sample) distance matrices of the sampled points.  Shapes
    as `circle_loss`.  The sampled rows are taken by `batched_row_gather`
    (the row-gather kernel forward, the gather transpose backward)."""
    idx_a, idx_b, valid = sample_correspondences(
        generators, xyz_a, xyz_b, mask_a, mask_b, r_p, n_sample)
    index_a = GatherIndex(idx_a, xyz_a.shape[1])
    index_b = GatherIndex(idx_b, xyz_b.shape[1])
    fa = batched_row_gather(feats_a.float().contiguous(), index_a)
    fb = batched_row_gather(feats_b.float().contiguous(), index_b)
    xa = batched_row_gather(xyz_a.float().contiguous(), index_a)
    xb = batched_row_gather(xyz_b.float().contiguous(), index_b)
    return sampled_circle_core(fa, fb, xa, xb, valid, r_p, r_n, log_scale,
                               pos_margin, neg_margin, dist_type)


def sampled_circle_core(fa, fb, xa, xb, valid, r_p, r_n, log_scale=10.0,
                        pos_margin=0.1, neg_margin=1.4,
                        dist_type="euclidean"):
    """`circle_loss_sampled` after its sampling and gathers: the sampled
    features and points (B, S, D) / (B, S, 3) and valid (B, S)."""
    coords_dist = torch.sqrt(pairwise_sqdist(xa, xb) + 1e-12)
    fd = _feature_dist(fa, fb, dist_type)
    valid_mat = valid[:, :, None] & valid[:, None, :]
    return _circle_core(coords_dist, fd, valid_mat, r_p, r_n, log_scale,
                        pos_margin, neg_margin)
