"""3DMatch registration recall, the Redwood/Predator protocol (the port's
own copy of regtr_tpu/benchmark/predator.py, numpy only; a CPU test holds
the reports equal).

A pair counts as registered when its covariance-weighted transformation
error (an approximation of the RMSE over groundtruth correspondences, see
redwood-data.org/indoor/registration.html) is below 0.2 m; only
non-consecutive fragment pairs count.

File formats:
  * gt.log / est.log: blocks of 5 lines, an "i j n" header and a 4x4
    transform.
  * gt.info: blocks of 7 lines, an "i j n" header and a 6x6 covariance.
"""
from __future__ import annotations

import os

import numpy as np

SCENE_SHORT_NAMES = [
    "Kitchen", "Home 1", "Home 2", "Hotel 1", "Hotel 2", "Hotel 3",
    "Study", "MIT Lab",
]


def rotmat_to_quat(r):
    """(3,3) rotation matrix -> quaternion (w, x, y, z)."""
    t = np.trace(r)
    if t > 0:
        s = 0.5 / np.sqrt(t + 1.0)
        return np.array([
            0.25 / s,
            (r[2, 1] - r[1, 2]) * s,
            (r[0, 2] - r[2, 0]) * s,
            (r[1, 0] - r[0, 1]) * s,
        ])
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(max(1.0 + r[i, i] - r[j, j] - r[k, k], 1e-12))
    q = np.empty(4)
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def transformation_error(trans, info):
    """Covariance-weighted squared error of a relative transform.

    trans: (4,4) relative transform (gt^-1 @ est); info: (6,6) covariance."""
    t = trans[:3, 3]
    q = rotmat_to_quat(trans[:3, :3])
    er = np.concatenate([t, q[1:]])
    # A degenerate all-zero covariance (present in the real 3DLoMatch gt)
    # yields 0/0 = nan, which the caller scores as a failure — identical to
    # the reference's computeTransformationErr; errstate just silences the
    # expected warning.
    with np.errstate(invalid="ignore", divide="ignore"):
        return float((er @ info @ er) / info[0, 0])


def read_trajectory(path):
    """Redwood .log -> (pairs (n, 3) int array, transforms (n, 4, 4))."""
    with open(path) as f:
        lines = [ln.strip() for ln in f if ln.strip()]
    pairs, trajs = [], []
    for i in range(0, len(lines), 5):
        pairs.append([int(x) for x in lines[i].split()[:3]])
        mat = [
            [float(v) for v in lines[i + 1 + r].split()[:4]] for r in range(4)
        ]
        trajs.append(mat)
    return np.asarray(pairs), np.asarray(trajs, np.float64)


def read_trajectory_info(path):
    """Redwood .info -> (num_fragments, covariances (n, 6, 6))."""
    with open(path) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip()]
    n_pairs = len(lines) // 7
    covs, n_frame = [], 0
    for i in range(n_pairs):
        head = lines[i * 7].split()
        n_frame = int(head[2])
        covs.append(
            [np.fromstring(lines[i * 7 + 1 + r], sep="\t") for r in range(6)]
        )
    return n_frame, np.asarray(covs, np.float64)


def write_est_log(path, tgt_idx, src_idx, pose_4x4, append=True):
    """Append one pair's estimate in the est.log format (header
    'tgt src -1', then the 4x4 pose)."""
    with open(path, "a" if append else "w") as f:
        f.write(f"{tgt_idx}\t{src_idx}\t{-1}\n")
        for row in pose_4x4:
            f.write("\t".join(f"{v:.12f}" for v in row) + "\n")


def evaluate_scene(num_fragments, est_pairs, est_traj, gt_pairs, gt_traj,
                   gt_covs, err_thresh=0.2):
    """Per-scene precision/recall at RMSE < err_thresh on non-consecutive
    pairs.  Returns (precision, recall, flags, errors, rot_errs, trans_errs).
    flags: 0 = registered, 1 = attempted-but-failed, 2 = not in gt."""
    err2 = err_thresh ** 2
    gt_index = -np.ones((num_fragments, num_fragments), np.int64)
    for idx, (i, j, _n) in enumerate(gt_pairs):
        if j - i > 1:  # only non-consecutive pairs count
            gt_index[i, j] = idx
    n_gt = int(np.sum(gt_index >= 0))

    flags = np.full(len(est_pairs), 2, np.int64)
    errors = np.full(len(est_pairs), np.nan)
    rot_errs, trans_errs = [], []
    good = n_res = 0
    for idx, (i, j, _n) in enumerate(est_pairs):
        gt_idx = gt_index[i, j] if (0 <= i < num_fragments and
                                    0 <= j < num_fragments) else -1
        if gt_idx < 0:
            continue
        n_res += 1
        rel = np.linalg.inv(gt_traj[gt_idx]) @ est_traj[idx]
        p = transformation_error(rel, gt_covs[gt_idx])
        errors[idx] = p
        if p <= err2:
            good += 1
            flags[idx] = 0
            # errors of successful registrations, for RRE/RTE medians
            gt_r, est_r = gt_traj[gt_idx][:3, :3], est_traj[idx][:3, :3]
            cos = np.clip((np.trace(gt_r.T @ est_r) - 1.0) / 2.0, -1, 1)
            rot_errs.append(np.degrees(np.arccos(cos)))
            trans_errs.append(
                np.linalg.norm(gt_traj[gt_idx][:3, 3] - est_traj[idx][:3, 3])
            )
        else:
            flags[idx] = 1
    precision = good / max(n_res, 1e-6)
    recall = good / max(n_gt, 1)
    return precision, recall, flags, errors, np.array(rot_errs), \
        np.array(trans_errs)


def benchmark(est_folder, gt_folder, err_thresh=0.2, save_errors=True):
    """Evaluate every scene under gt_folder; returns (report_str,
    mean_recall), and saves each scene's flags and errors beside its
    est.log when save_errors."""
    scenes = sorted(os.listdir(gt_folder))
    precisions, recalls, n_valids = [], [], []
    re_med, te_med = [], []
    report = "Scene\t| prec.\t| rec.\t| re\t| te\t| samples\n"
    for si, scene in enumerate(scenes):
        gt_pairs, gt_traj = read_trajectory(
            os.path.join(gt_folder, scene, "gt.log"))
        n_frag, gt_covs = read_trajectory_info(
            os.path.join(gt_folder, scene, "gt.info")
        )
        est_pairs, est_traj = read_trajectory(
            os.path.join(est_folder, scene, "est.log")
        )
        prec, rec, flags, errors, re, te = evaluate_scene(
            n_frag, est_pairs, est_traj, gt_pairs, gt_traj, gt_covs,
            err_thresh,
        )
        n_valid = int(np.sum(np.abs(gt_pairs[:, 1] - gt_pairs[:, 0]) > 1))
        n_valids.append(n_valid)
        precisions.append(prec)
        recalls.append(rec)
        re_med.append(np.median(re) if len(re) else np.nan)
        te_med.append(np.median(te) if len(te) else np.nan)
        name = SCENE_SHORT_NAMES[si] if si < len(SCENE_SHORT_NAMES) else scene
        report += (
            f"{name}\t| {prec:.3f}\t| {rec:.3f}\t| {re_med[-1]:.3f}\t| "
            f"{te_med[-1]:.3f}\t| {n_valid:3d}\n"
        )
        if save_errors:
            np.save(os.path.join(est_folder, scene, "flag.npy"), flags)
            np.save(os.path.join(est_folder, scene, "errors.npy"), errors)

    weighted_prec = float(
        np.sum(np.array(n_valids) * np.array(precisions)) / np.sum(n_valids)
    )
    report += (
        f"Mean precision: {np.mean(precisions):.3f} +- "
        f"{np.std(precisions):.3f}\n"
        f"Weighted precision: {weighted_prec:.3f}\n"
        f"Mean recall: {np.mean(recalls):.3f} +- {np.std(recalls):.3f}\n"
        f"Mean median RRE: {np.nanmean(re_med):.3f} +- "
        f"{np.nanstd(re_med):.3f}\n"
        f"Mean median RTE: {np.nanmean(te_med):.3f} +- "
        f"{np.nanstd(te_med):.3f}\n"
    )
    return report, float(np.mean(recalls))
