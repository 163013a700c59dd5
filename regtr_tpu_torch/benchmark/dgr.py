"""The DGR success metric for 3DMatch (the port's own copy of
regtr_tpu/benchmark/dgr.py, numpy only; a CPU test holds the reports
equal): a pair succeeds when RRE < 15 deg and RTE < 0.3 m, averaged per
scene, then across scenes.
"""
from __future__ import annotations

import os

import numpy as np

from .predator import read_trajectory


def compute_rte(t_gt, t_est):
    return float(np.linalg.norm(t_gt - t_est))


def compute_rre(r_gt, r_est):
    cos = np.clip((np.trace(r_gt.T @ r_est) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(cos)))


def benchmark_dgr(est_folder, gt_folder, rte_thresh=0.3, rre_thresh=15.0):
    """Returns (report_str, mean_success_rate)."""
    scenes = sorted(os.listdir(gt_folder))
    per_scene_success, all_rte, all_rre = [], [], []
    report = "Scene\t| success\t| rte\t| rre\n"
    for scene in scenes:
        gt_pairs, gt_traj = read_trajectory(
            os.path.join(gt_folder, scene, "gt.log")
        )
        est_pairs, est_traj = read_trajectory(
            os.path.join(est_folder, scene, "est.log")
        )
        gt_map = {
            (int(i), int(j)): idx for idx, (i, j, _n) in enumerate(gt_pairs)
            if j - i > 1
        }
        succ, rtes, rres = [], [], []
        for idx, (i, j, _n) in enumerate(est_pairs):
            gi = gt_map.get((int(i), int(j)))
            if gi is None:
                continue
            rte = compute_rte(gt_traj[gi][:3, 3], est_traj[idx][:3, 3])
            rre = compute_rre(gt_traj[gi][:3, :3], est_traj[idx][:3, :3])
            ok = rte < rte_thresh and rre < rre_thresh
            succ.append(ok)
            if ok:
                rtes.append(rte)
                rres.append(rre)
        rate = float(np.mean(succ)) if succ else 0.0
        per_scene_success.append(rate)
        all_rte.extend(rtes)
        all_rre.extend(rres)
        report += (
            f"{scene}\t| {rate:.3f}\t| "
            f"{np.mean(rtes) if rtes else float('nan'):.3f}\t| "
            f"{np.mean(rres) if rres else float('nan'):.3f}\n"
        )
    mean_rate = float(np.mean(per_scene_success)) if per_scene_success else 0.0
    report += (
        f"Mean success: {mean_rate:.3f}; "
        f"RTE {np.mean(all_rte) if all_rte else float('nan'):.3f}; "
        f"RRE {np.mean(all_rre) if all_rre else float('nan'):.3f}\n"
    )
    return report, mean_rate
