"""Headless registration views (the port's own copy of
regtr_tpu/utils/viz.py; a CPU test holds the PLY files bitwise equal).

Colored PLY panes (before / after / groundtruth / overlap confidence) and,
where matplotlib is installed, a PNG contact sheet of top-down projections;
without matplotlib only the PNG is skipped.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np

from ..core import se3_np
from .ply import write_ply

RED = np.array([228, 60, 60], np.uint8)
BLUE = np.array([65, 130, 240], np.uint8)
GREEN = np.array([60, 190, 90], np.uint8)


def _colored(xyz, color):
    return np.broadcast_to(color, (len(xyz), 3)).astype(np.uint8)


def _confidence_colors(conf):
    """Scalar [0,1] -> blue->red colormap."""
    conf = np.clip(np.asarray(conf, np.float32), 0.0, 1.0)
    r = (255 * conf).astype(np.uint8)
    b = (255 * (1.0 - conf)).astype(np.uint8)
    g = np.full_like(r, 40)
    return np.stack([r, g, b], axis=1)


def save_cloud_pair(path, src, tgt, src_color=RED, tgt_color=BLUE):
    write_ply(
        path,
        [np.concatenate([src, tgt]),
         np.concatenate([_colored(src, src_color), _colored(tgt, tgt_color)])],
        ["x", "y", "z", "red", "green", "blue"],
    )


def visualize_registration(src_xyz, tgt_xyz, pose_pred, out_dir,
                           pose_gt=None, overlap_conf=None, prefix="reg"):
    """Write the 4-pane visualization as PLY files + a PNG contact sheet.

    Panes:
      1. inputs (src red, tgt blue)
      2. prediction (src warped by pose_pred)
      3. groundtruth (src warped by pose_gt), if given
      4. overlap confidence heat on src, if given
    """
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    src = np.asarray(src_xyz, np.float32)
    tgt = np.asarray(tgt_xyz, np.float32)

    save_cloud_pair(out / f"{prefix}_1_input.ply", src, tgt)
    src_pred = se3_np.se3_transform(np.asarray(pose_pred), src)
    save_cloud_pair(out / f"{prefix}_2_pred.ply", src_pred, tgt)
    panes = [("input", src, tgt), ("pred", src_pred, tgt)]
    if pose_gt is not None:
        src_gt = se3_np.se3_transform(np.asarray(pose_gt), src)
        save_cloud_pair(out / f"{prefix}_3_gt.ply", src_gt, tgt)
        panes.append(("gt", src_gt, tgt))
    if overlap_conf is not None:
        conf = np.asarray(overlap_conf)
        write_ply(
            out / f"{prefix}_4_overlap.ply",
            [src[: len(conf)], _confidence_colors(conf)],
            ["x", "y", "z", "red", "green", "blue"],
        )

    _contact_sheet(out / f"{prefix}.png", panes)
    return out


def _contact_sheet(path, panes, max_pts=4000):
    """Matplotlib top-down projections of each pane into one PNG; None
    where matplotlib is not installed."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    fig, axes = plt.subplots(1, len(panes), figsize=(5 * len(panes), 5))
    if len(panes) == 1:
        axes = [axes]
    for ax, (name, src, tgt) in zip(axes, panes):
        s = src[:: max(1, len(src) // max_pts)]
        t = tgt[:: max(1, len(tgt) // max_pts)]
        ax.scatter(t[:, 0], t[:, 1], s=1, c="#4182f0", alpha=0.5, label="tgt")
        ax.scatter(s[:, 0], s[:, 1], s=1, c="#e43c3c", alpha=0.5, label="src")
        ax.set_title(name)
        ax.set_aspect("equal")
        ax.legend(markerscale=8)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
