"""ModelNet pose-error metrics, DCP/RPMNet conventions (the port's own copy
of regtr_tpu/benchmark/modelnet.py, numpy and scipy only; a CPU test holds
the two bitwise equal).

Euler-angle r_mse / r_mae (xyz convention), anisotropic t_mse / t_mae,
isotropic rotation and translation errors, and the modified Chamfer
distance against the raw (uncropped) cloud.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
from scipy.spatial.transform import Rotation

from ..core import se3_np


def dcm2euler(mats, seq="xyz", degrees=True):
    return np.stack([
        Rotation.from_matrix(m).as_euler(seq, degrees=degrees) for m in mats
    ])


def _pairwise_min_sqdist(a, b):
    """(B, N, 3) x (B, M, 3) -> (B, N) min squared distance per a-point."""
    out = np.empty(a.shape[:2], a.dtype)
    for i in range(a.shape[0]):
        d = np.sum((a[i][:, None] - b[i][None]) ** 2, axis=-1)
        out[i] = d.min(axis=1)
    return out


# The keys compute_metrics returns.
METRIC_KEYS = (
    "r_mse", "r_mae", "t_mse", "t_mae", "err_r_deg", "err_t", "chamfer_dist",
)


def compute_metrics(data: Dict, pred_transforms) -> Dict:
    """data: points_src/points_ref/points_raw (B, N, 3) + transform_gt
    (B, 3, 4); pred_transforms (B, 3, 4).  Returns per-pair metric arrays."""
    gt = np.asarray(data["transform_gt"], np.float64)
    pred = np.asarray(pred_transforms, np.float64)
    src = np.asarray(data["points_src"])[..., :3]
    ref = np.asarray(data["points_ref"])[..., :3]
    raw = np.asarray(data["points_raw"])[..., :3]

    r_gt_euler = dcm2euler(gt[:, :3, :3])
    r_pred_euler = dcm2euler(pred[:, :3, :3])
    r_mse = np.mean((r_gt_euler - r_pred_euler) ** 2, axis=1)
    r_mae = np.mean(np.abs(r_gt_euler - r_pred_euler), axis=1)
    t_mse = np.mean((gt[:, :3, 3] - pred[:, :3, 3]) ** 2, axis=1)
    t_mae = np.mean(np.abs(gt[:, :3, 3] - pred[:, :3, 3]), axis=1)

    combined = se3_np.se3_cat(se3_np.se3_inv(gt), pred)
    trace = combined[:, 0, 0] + combined[:, 1, 1] + combined[:, 2, 2]
    err_r_deg = np.degrees(np.arccos(np.clip(0.5 * (trace - 1), -1, 1)))
    err_t = np.linalg.norm(combined[:, :, 3], axis=-1)

    # Modified Chamfer distance vs the raw (complete) cloud.
    src_transformed = se3_np.se3_transform(pred, src)
    src_clean = se3_np.se3_transform(
        se3_np.se3_cat(pred, se3_np.se3_inv(gt)), raw
    )
    dist_src = _pairwise_min_sqdist(src_transformed, raw)
    dist_ref = _pairwise_min_sqdist(ref, src_clean)
    chamfer = dist_src.mean(axis=1) + dist_ref.mean(axis=1)

    return {
        "r_mse": r_mse, "r_mae": r_mae,
        "t_mse": t_mse, "t_mae": t_mae,
        "err_r_deg": err_r_deg, "err_t": err_t,
        "chamfer_dist": chamfer,
    }


def summarize_metrics(metrics):
    out = {}
    for k, v in metrics.items():
        if k.endswith("mse"):
            out[k[:-3] + "rmse"] = float(np.sqrt(np.mean(v)))
        elif k.startswith("err"):
            out[k + "_mean"] = float(np.mean(v))
            out[k + "_rmse"] = float(np.sqrt(np.mean(np.square(v))))
        else:
            out[k] = float(np.mean(v))
    return out


def print_metrics(logger, s: Dict, title="Metrics"):
    logger.info("%s:", title)
    logger.info(
        "DeepCP metrics: %.4f(rot-rmse) | %.4f(rot-mae) | %.4g(trans-rmse) "
        "| %.4g(trans-mae)", s["r_rmse"], s["r_mae"], s["t_rmse"], s["t_mae"],
    )
    logger.info(
        "Rotation error %.4f(deg, mean) | %.4f(deg, rmse)",
        s["err_r_deg_mean"], s["err_r_deg_rmse"],
    )
    logger.info(
        "Translation error %.4g(mean) | %.4g(rmse)",
        s["err_t_mean"], s["err_t_rmse"],
    )
    logger.info("Chamfer error: %.7f(mean-sq)", s["chamfer_dist"])
