"""Fixed-K radius neighbor search (counterpart of `brute_radius_neighbors`
in regtr_tpu/ops/neighbors.py), batched over a leading cloud axis.

Contract: an (B, Nq, K) index table into the support cloud; entries equal
to Ns are "shadow" neighbors pointing at an appended pad row; only supports
within the radius are returned, nearest first.

The JAX version selects with `jax.lax.approx_min_k` on bf16-rounded
distances.  That has no counterpart here: this version takes an exact
`torch.topk` over the same bf16-rounded distances, which is what the JAX CPU
fallback computes.  Ties in bf16 at the K-th slot may resolve to a different
(equally near) point than in JAX.
"""
from __future__ import annotations

import torch


def brute_radius_neighbors(queries: torch.Tensor, q_mask: torch.Tensor,
                           supports: torch.Tensor, s_mask: torch.Tensor,
                           radius: float, k: int,
                           query_chunk: int = 4096) -> torch.Tensor:
    """K-nearest-within-radius table, distances by matrix expansion.

    queries (B, Nq, 3), q_mask (B, Nq), supports (B, Ns, 3), s_mask (B, Ns)
    -> (B, Nq, k) int64, shadow entries = Ns.

    The |q|^2 - 2 q.s + |s|^2 expansion cancels badly, so it needs true
    fp32: callers keep TF32 off for matrix products (see RegTR.forward).
    """
    b, nq, _ = queries.shape
    ns = supports.shape[1]
    s_sq = (supports * supports).sum(dim=-1)
    s_masked = torch.where(s_mask[..., None], supports,
                           torch.full_like(supports, 1e6))
    s_sq_masked = torch.where(s_mask, s_sq, torch.full_like(s_sq, 1e13))
    r_sq = torch.full((), radius * radius, dtype=torch.float32,
                      device=queries.device)
    k_eff = min(k, ns)
    use_exact = ns < 4 * k   # tiny support sets: selection on fp32 values

    out = torch.empty((b, nq, k), dtype=torch.int64, device=queries.device)
    for q0 in range(0, nq, query_chunk):
        q = queries[:, q0:q0 + query_chunk]
        d = ((q * q).sum(dim=-1)[..., None]
             - 2.0 * (q @ s_masked.transpose(1, 2))
             + s_sq_masked[:, None, :])
        if use_exact:
            vals, idx = torch.topk(d, k_eff, dim=-1, largest=False)
        else:
            # fp32 distances, selection on their bf16 rounding: in-radius
            # values are small (<= r^2), where bf16's 0.4% relative error
            # only moves the effective radius, hence the 1.004 margin below.
            vals, idx = torch.topk(d.to(torch.bfloat16), k_eff, dim=-1,
                                   largest=False)
            vals = vals.to(torch.float32)
        ok = (vals <= r_sq * 1.004) & q_mask[:, q0:q0 + query_chunk, None]
        sel = torch.where(ok, idx, torch.full_like(idx, ns))
        out[:, q0:q0 + query_chunk, :k_eff] = sel
    out[..., k_eff:] = ns
    return out
