"""Groundtruth overlap labels between aligned cloud pairs, on the host
(counterpart of regtr_tpu/data/overlap.py), with scipy's cKDTree.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree


def compute_overlap(src: np.ndarray, tgt: np.ndarray, search_radius: float):
    """
    Args:
        src: (N, 3) source points, already transformed into the target frame.
        tgt: (M, 3) target points.
        search_radius: match radius.

    Returns:
        (src_mask (N,), tgt_mask (M,), src_tgt_corr (2, K) mutual matches):
        a point overlaps when the other cloud has a point within the radius.
    """
    src = np.asarray(src, np.float32)
    tgt = np.asarray(tgt, np.float32)

    # Nearest neighbor within radius in each direction (-1 = none).
    d_s, i_s = cKDTree(tgt).query(src, k=1,
                                  distance_upper_bound=search_radius)
    src_corr = np.where(np.isfinite(d_s), i_s, -1).astype(np.int64)
    src_corr[src_corr >= len(tgt)] = -1

    d_t, i_t = cKDTree(src).query(tgt, k=1,
                                  distance_upper_bound=search_radius)
    tgt_corr = np.where(np.isfinite(d_t), i_t, -1).astype(np.int64)
    tgt_corr[tgt_corr >= len(src)] = -1

    mutual = (src_corr >= 0) & (tgt_corr[np.clip(src_corr, 0, None)] ==
                                np.arange(len(src)))
    src_tgt_corr = np.stack(
        [np.nonzero(mutual)[0], src_corr[mutual]]
    ).astype(np.int64)
    return src_corr >= 0, tgt_corr >= 0, src_tgt_corr
