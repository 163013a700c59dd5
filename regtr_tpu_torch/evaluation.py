"""The test protocols (the port's counterpart of `run_test` in
regtr_tpu/evaluation.py).

For each test batch: the forward, and the final pose of each pair against
its groundtruth (`se3_compare`).  Then, by dataset:
  * 3dmatch: the pose appended to its scene's est.log in the Redwood format
    under out_dir/<benchmark>/<scene>/; at the end, when the groundtruth
    trajectories are present, the Predator registration recall.
  * modelnet / synthetic: the DCP/RPMNet pose metrics and the Chamfer
    distance against the raw target cloud per pair; at the end their
    summary, and the poses in dataset order as pred_transforms.npy.

One process: the multi-process est.log merge is not ported yet (ROADMAP.md
Queue A, item 6).
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

from .benchmark import modelnet as bm_modelnet
from .benchmark import predator as bm_predator
from .core import se3_np
from .train.steps import make_forward

logger = logging.getLogger("regtr_tpu_torch")

# The groundtruth trajectories bundled with the upstream RegTR sources,
# relative to its src/ directory (the working directory of its scripts).
DEFAULT_GT_BENCHMARK_DIR = "datasets/3dmatch/benchmarks"


def _pose_to_4x4(pose_3x4):
    return np.concatenate(
        [np.asarray(pose_3x4, np.float64), [[0.0, 0.0, 0.0, 1.0]]], axis=0)


def _fragment_index(path) -> int:
    """cloud_bin_<i>.pth -> i."""
    return int(os.path.basename(path).split("_")[-1].replace(".pth", ""))


def run_test(cfg, model, test_loader, out_dir,
             gt_benchmark_dir=DEFAULT_GT_BENCHMARK_DIR):
    """Run the test protocol with `model` (its parameters loaded, on the
    device it runs on); returns a dict of summary results."""
    dataset_name = cfg.get("dataset", "modelnet")
    if dataset_name not in ("3dmatch", "modelnet", "synthetic"):
        raise ValueError(f"no test protocol for dataset {dataset_name!r}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fwd = make_forward(model)
    device = next(model.parameters()).device
    benchmark = cfg.get("benchmark", "3DMatch")

    rot_errs, trans_errs = [], []
    mn_metrics, mn_poses, mn_idx = [], [], []
    for batch, meta in test_loader:
        out = fwd(torch.from_numpy(batch["points"]).to(device),
                  torch.from_numpy(batch["mask"]).to(device))
        pose_final = out["pose"][-1].cpu().numpy()         # (B, 3, 4)
        err = se3_np.se3_compare(pose_final, batch["pose"])
        rot_errs.extend(err["rot_deg"].tolist())
        trans_errs.extend(err["trans"].tolist())
        if dataset_name != "3dmatch":
            mn_metrics.append(_modelnet_metrics_ragged(batch, meta,
                                                       pose_final))
            mn_poses.append(pose_final)
            # batches may arrive grouped by size, out of dataset order
            mn_idx.extend(int(i) for i in meta["idx"])
            continue
        for b in range(pose_final.shape[0]):
            # The scene is the directory holding the cloud file.
            scene = Path(meta["src_path"][b]).parent.name
            scene_dir = out_dir / benchmark / scene
            scene_dir.mkdir(parents=True, exist_ok=True)
            bm_predator.write_est_log(
                scene_dir / "est.log", _fragment_index(meta["tgt_path"][b]),
                _fragment_index(meta["src_path"][b]),
                _pose_to_4x4(pose_final[b]))

    results = {
        "rot_err_deg_mean": float(np.mean(rot_errs)),
        "trans_err_mean": float(np.mean(trans_errs)),
        "reg_success": float(np.mean(
            (np.array(rot_errs) < cfg.get("reg_success_thresh_rot", 10))
            & (np.array(trans_errs) < cfg.get("reg_success_thresh_trans",
                                              0.1)))),
    }
    if dataset_name != "3dmatch":
        if mn_poses:
            # pred_transforms.npy row i is dataset sample i
            order = np.argsort(np.asarray(mn_idx, np.int64), kind="stable")
            poses = np.concatenate(mn_poses)[order]
            summary = bm_modelnet.summarize_metrics({
                k: np.concatenate([m[k] for m in mn_metrics])[order]
                for k in mn_metrics[0]})
            bm_modelnet.print_metrics(logger, summary)
            results.update(summary)
            np.save(out_dir / "pred_transforms.npy", poses)
        return results
    gt_dir = os.path.join(gt_benchmark_dir, benchmark)
    if os.path.exists(gt_dir):
        report, recall = bm_predator.benchmark(str(out_dir / benchmark),
                                               gt_dir)
        logger.info("\n%s", report)
        results["registration_recall"] = recall
        (out_dir / "benchmark_report.txt").write_text(report)
    else:
        logger.warning("GT benchmark dir %s missing; recall skipped", gt_dir)
    return results


def _ragged_valid(batch, which):
    """Each pair's valid points (a list of (Ni, 3)) of its source (0) or
    target (1)."""
    pts, mask = batch["points"], batch["mask"]
    return [pts[2 * i + which][mask[2 * i + which]]
            for i in range(pts.shape[0] // 2)]


def _modelnet_metrics_ragged(batch, meta, pose_final):
    """The ModelNet metrics of each pair on its own valid points (the
    pairs of a batch may hold clouds of other sizes)."""
    src, ref = _ragged_valid(batch, 0), _ragged_valid(batch, 1)
    per_pair = [bm_modelnet.compute_metrics({
        "points_src": src[b][None],
        "points_ref": ref[b][None],
        "points_raw": np.asarray(meta["tgt_raw"][b])[None],
        "transform_gt": np.asarray(batch["pose"][b])[None],
    }, pose_final[b][None]) for b in range(pose_final.shape[0])]
    return {k: np.concatenate([p[k] for p in per_pair])
            for k in per_pair[0]}
