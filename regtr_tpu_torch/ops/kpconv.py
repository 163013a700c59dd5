"""Kernel-point convolution, forward only (counterpart of
regtr_tpu/ops/kpconv.py, rigid path).

Math per query q with neighbors n (shadow neighbors point at an appended
pad row with coordinates SHADOW_COORD and zero features):
    d[n, p]   = || (x_n - x_q) - kernel_p ||
    w[n, p]   = influence(d)              (linear: relu(1 - d / extent))
    f[p, c]   = sum_n w[n, p] * feat[n, c]
    out[c']   = sum_{p, c} f[p, c] * W[p, c, c']   / n_valid_neighbors

Precision follows the JAX version's bf16 config: coordinates stay fp32 up to
the neighbor-minus-query subtraction, then `rel`, the influence tensor, the
gathered features and the weights are rounded to the compute dtype, and
every contraction accumulates in fp32.  A product of two bf16 values is
exact in fp32, so "bf16 operands, fp32 accumulation" is computed here as an
fp32 product of the bf16-rounded operands.

Row layout: the JAX version bit-splits fp32 coordinates into bf16 halves so
features and coordinates ride in one gathered row, a TPU trick.  Here the
coordinates (fp32) and the features (compute dtype) are two gathers with one
flat index.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SHADOW_COORD = 1e6


def batched_row_gather(x: torch.Tensor, inds: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), inds (B, R) in [0, N) -> (B, R, C), one flat gather."""
    b, n, c = x.shape
    offs = torch.arange(b, device=x.device, dtype=inds.dtype)[:, None] * n
    flat = (inds + offs).reshape(-1)
    return x.reshape(b * n, c).index_select(0, flat).reshape(b, -1, c)


def _pad_row(x: torch.Tensor, value: float) -> torch.Tensor:
    """Append the shadow row (index N) to each cloud of (B, N, C)."""
    pad = torch.full((x.shape[0], 1, x.shape[2]), value, dtype=x.dtype,
                     device=x.device)
    return torch.cat([x, pad], dim=1)


def _influence_from_rel(rel, neighb_inds, ns, kernel_pts, kp_extent,
                        influence="linear", aggregation="sum",
                        compute_dtype=None):
    """rel (B, Nq, K, 3) neighbor-minus-query offsets (fp32) ->
    (infl (B, Nq, K, P), inv_n_valid (B, Nq) fp32)."""
    p = kernel_pts.shape[0]
    if compute_dtype is not None:
        rel = rel.to(compute_dtype)
        kernel_pts = kernel_pts.to(compute_dtype)
    rel_sq = (rel * rel).sum(dim=-1)
    dots = rel @ kernel_pts.t()                                # (B,Nq,K,P)
    kp_sq = (kernel_pts * kernel_pts).sum(dim=-1)
    sq_d = (rel_sq[..., None] - 2.0 * dots + kp_sq).clamp_min(0.0)

    if influence == "linear":
        infl = (1.0 - torch.sqrt(sq_d) / kp_extent).clamp_min(0.0)
    elif influence == "gaussian":
        sigma = kp_extent * 0.3
        infl = torch.exp(-sq_d / (2.0 * sigma * sigma + 1e-9))
    elif influence == "constant":
        infl = torch.ones_like(sq_d)
    else:
        raise ValueError(f"unknown influence {influence}")

    if aggregation == "closest":
        closest = sq_d.argmin(dim=-1)
        infl = infl * F.one_hot(closest, p).to(infl.dtype)
    elif aggregation != "sum":
        raise ValueError(f"unknown aggregation {aggregation}")

    n_valid = (neighb_inds < ns).sum(dim=-1)
    inv_n_valid = 1.0 / n_valid.clamp_min(1).to(torch.float32)
    return infl, inv_n_valid


def _apply_from_gathered(infl, inv_n_valid, neighb_x, weights, compute_dtype,
                         norm: str = "valid"):
    """KPConv contraction given gathered neighbor features (B, Nq, K, C)."""
    b, nq, k, cin = neighb_x.shape
    p = infl.shape[-1]
    if norm == "legacy":
        # Reference quirk: count gathered rows whose channel sum is > 0.
        n = (neighb_x.to(torch.float32).sum(dim=-1) > 0.0).sum(dim=-1)
        inv_n_valid = 1.0 / n.clamp_min(1).to(torch.float32)
    elif norm != "valid":
        raise ValueError(f"unknown kpconv norm {norm}")
    if compute_dtype is not None:
        infl = infl.to(compute_dtype)
        neighb_x = neighb_x.to(compute_dtype)
        weights = weights.to(compute_dtype)
    weighted = torch.einsum("bqkp,bqkc->bqpc", infl.float(), neighb_x.float())
    out = weighted.reshape(b, nq, p * cin) @ weights.float().reshape(p * cin,
                                                                     -1)
    return out * inv_n_valid[..., None]


def kpconv_apply(infl, inv_n_valid, neighb_inds, x, weights,
                 compute_dtype=None, norm: str = "valid"):
    """Feature path of KPConv given precomputed geometry -> (B, Nq, Cout)."""
    b, ns, cin = x.shape
    _, nq, k = neighb_inds.shape
    p = infl.shape[-1]

    if cin == 1:
        # Input features are a constant 1 per valid point, so the gather and
        # contraction reduce to a masked sum of influences.
        valid = (neighb_inds < ns).to(infl.dtype)
        weighted = torch.einsum("bqkp,bqk->bqp", infl.float(), valid.float())
        if compute_dtype is not None:
            weighted = weighted.to(compute_dtype)
            weights = weights.to(compute_dtype)
        out = weighted.float() @ weights.float().reshape(p, -1)
        return out * inv_n_valid[..., None]

    if compute_dtype is not None:
        x = x.to(compute_dtype)
    neighb_x = batched_row_gather(
        _pad_row(x, 0.0), neighb_inds.reshape(b, nq * k)
    ).reshape(b, nq, k, cin)
    return _apply_from_gathered(infl, inv_n_valid, neighb_x, weights,
                                compute_dtype, norm)


def kpconv_fused_gather(q_pts, s_pts, neighb_inds, x, x_extra, kernel_pts,
                        weights, kp_extent: float, influence: str = "linear",
                        aggregation: str = "sum", compute_dtype=None,
                        norm: str = "valid"):
    """KPConv that computes its own geometry from the gathered neighbors.

    x: (B, Ns, Cin) conv features; x_extra: optional (B, Ns, Ce) features
    max-pooled over the same table (the strided resnet shortcut).

    Returns (conv_out (B, Nq, Cout), maxpool_out (B, Nq, Ce) or None,
             (infl, inv_n_valid) for reuse by later blocks at this level).
    """
    b, ns, _ = s_pts.shape
    _, nq, k = neighb_inds.shape
    cin = x.shape[-1]
    gdtype = compute_dtype if compute_dtype is not None else x.dtype

    feats = x.to(gdtype)
    if x_extra is not None:
        feats = torch.cat([feats, x_extra.to(gdtype)], dim=-1)
    flat_inds = neighb_inds.reshape(b, nq * k)
    g = batched_row_gather(_pad_row(feats, 0.0), flat_inds)
    g = g.reshape(b, nq, k, feats.shape[-1])
    neighbors = batched_row_gather(
        _pad_row(s_pts.to(torch.float32), SHADOW_COORD), flat_inds
    ).reshape(b, nq, k, 3)

    rel = neighbors - q_pts.to(torch.float32)[:, :, None, :]
    infl, inv_n = _influence_from_rel(rel, neighb_inds, ns, kernel_pts,
                                      kp_extent, influence, aggregation,
                                      compute_dtype)
    out = _apply_from_gathered(infl, inv_n, g[..., :cin], weights,
                               compute_dtype, norm)
    # Shadow rows gathered zeros, matching max_pool's zero pad row.
    pooled = None if x_extra is None else g[..., cin:].amax(dim=2)
    return out, pooled, (infl, inv_n)


def max_pool(x, pool_inds, compute_dtype=None):
    """Max-pool (B, Ns, C) over (B, Nq, K) tables (shadow = Ns, a zero row)."""
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    b, ns, c = x.shape
    _, nq, k = pool_inds.shape
    gathered = batched_row_gather(_pad_row(x, 0.0),
                                  pool_inds.reshape(b, nq * k))
    return gathered.reshape(b, nq, k, c).amax(dim=2)
