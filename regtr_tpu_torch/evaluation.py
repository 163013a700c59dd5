"""The 3DMatch / 3DLoMatch test protocol (the port's counterpart of
`run_test` in regtr_tpu/evaluation.py).

For each test batch: the forward, the final pose of each pair against its
groundtruth (`se3_compare`), and the pose appended to its scene's est.log in
the Redwood format under out_dir/<benchmark>/<scene>/.  Then, when the
groundtruth trajectories are present, the Predator registration recall.

One process.  The ModelNet protocol (ROADMAP.md Queue A 12) and the
multi-process est.log merge (Queue A 14) are not ported yet.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

import numpy as np
import torch

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
    if dataset_name != "3dmatch":
        raise NotImplementedError(
            f"test protocol for {dataset_name!r}: only 3DMatch/3DLoMatch is "
            "ported (ModelNet: ROADMAP.md Queue A 12)")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fwd = make_forward(model)
    device = next(model.parameters()).device
    benchmark = cfg.get("benchmark", "3DMatch")

    rot_errs, trans_errs = [], []
    for batch, meta in test_loader:
        out = fwd(torch.from_numpy(batch["points"]).to(device),
                  torch.from_numpy(batch["mask"]).to(device))
        pose_final = out["pose"][-1].cpu().numpy()         # (B, 3, 4)
        err = se3_np.se3_compare(pose_final, batch["pose"])
        rot_errs.extend(err["rot_deg"].tolist())
        trans_errs.extend(err["trans"].tolist())
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
