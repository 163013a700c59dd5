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

Several ranks (parallel/dist.py): each rank runs its shard of the test
loader and writes its own est.log tree under out_dir/est_rank{r} (with one
process there are no rank directories); the per-pair errors, and the
ModelNet metrics, poses and sample ids, are gathered on every rank; after a
barrier rank 0 merges the est.log trees (`merge_est_log_dirs`) and scores
them, and writes pred_transforms.npy.  The rank-0 work calls no
collective.
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
from .parallel import dist
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


def merge_est_log_dirs(rank_dirs, merged_dir):
    """Concatenate the ranks' est.log trees (<rank dir>/<scene>/est.log)
    into merged_dir/<scene>/est.log, in rank order.  The order of the pairs
    within a scene does not matter to the Redwood reader.  A missing rank
    tree raises: scoring the rest would report the recall of a subset of
    the pairs as the whole (the ranks must share a filesystem)."""
    merged_dir = Path(merged_dir)
    missing = [str(rd) for rd in rank_dirs if not Path(rd).exists()]
    if missing:
        raise FileNotFoundError(
            f"est.log merge expected {len(rank_dirs)} rank directories but "
            f"{len(missing)} are missing: {missing}.  Every rank must write "
            "to a filesystem rank 0 reads before the scoring.")
    scenes: dict = {}
    for rd in rank_dirs:
        for scene_dir in sorted(p for p in Path(rd).iterdir() if p.is_dir()):
            src = scene_dir / "est.log"
            if src.exists():
                scenes.setdefault(scene_dir.name, []).append(src.read_text())
    for scene, texts in scenes.items():
        dst_dir = merged_dir / scene
        dst_dir.mkdir(parents=True, exist_ok=True)
        # written, not appended: a previous run's merge is replaced
        (dst_dir / "est.log").write_text("".join(texts))


def run_test(cfg, model, test_loader, out_dir,
             gt_benchmark_dir=DEFAULT_GT_BENCHMARK_DIR):
    """Run the test protocol with `model` (its parameters loaded, on the
    device it runs on); returns a dict of summary results.  With several
    ranks, `test_loader` is this rank's shard, every rank calls it, and
    the results are the whole test set's (the recall is rank 0's only)."""
    dataset_name = cfg.get("dataset", "modelnet")
    if dataset_name not in ("3dmatch", "modelnet", "synthetic"):
        raise ValueError(f"no test protocol for dataset {dataset_name!r}")
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    fwd = make_forward(model)
    device = next(model.parameters()).device
    benchmark = cfg.get("benchmark", "3DMatch")
    rank, world = dist.rank(), dist.world_size()
    est_root = out_dir if world == 1 else out_dir / f"est_rank{rank}"

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
            scene_dir = est_root / benchmark / scene
            scene_dir.mkdir(parents=True, exist_ok=True)
            bm_predator.write_est_log(
                scene_dir / "est.log", _fragment_index(meta["tgt_path"][b]),
                _fragment_index(meta["src_path"][b]),
                _pose_to_4x4(pose_final[b]))

    if world > 1:
        rot_errs = dist.allgather_ragged(rot_errs).tolist()
        trans_errs = dist.allgather_ragged(trans_errs).tolist()
        dist.barrier()          # every rank's est.log tree is written
        if rank == 0 and dataset_name == "3dmatch":
            merge_est_log_dirs([out_dir / f"est_rank{r}" / benchmark
                                for r in range(world)], out_dir / benchmark)

    results = {
        "rot_err_deg_mean": float(np.mean(rot_errs)),
        "trans_err_mean": float(np.mean(trans_errs)),
        "reg_success": float(np.mean(
            (np.array(rot_errs) < cfg.get("reg_success_thresh_rot", 10))
            & (np.array(trans_errs) < cfg.get("reg_success_thresh_trans",
                                              0.1)))),
    }
    if dataset_name != "3dmatch":
        # every rank gathers, a rank with an empty shard too
        keys = mn_metrics[0].keys() if mn_metrics else \
            bm_modelnet.METRIC_KEYS
        cat = {k: (np.concatenate([m[k] for m in mn_metrics]) if mn_metrics
                   else np.zeros((0,), np.float64)) for k in keys}
        poses = (np.concatenate(mn_poses) if mn_poses
                 else np.zeros((0, 3, 4), np.float32))
        idxs = np.asarray(mn_idx, np.int64)
        if world > 1:
            cat = {k: dist.allgather_ragged(v) for k, v in cat.items()}
            poses = dist.allgather_ragged(poses).astype(np.float32)
            idxs = dist.allgather_ragged(idxs).astype(np.int64)
        if len(poses):
            # pred_transforms.npy row i is dataset sample i
            order = np.argsort(idxs, kind="stable")
            summary = bm_modelnet.summarize_metrics(
                {k: v[order] for k, v in cat.items()})
            bm_modelnet.print_metrics(logger, summary)
            results.update(summary)
            if rank == 0:
                np.save(out_dir / "pred_transforms.npy", poses[order])
        return results
    gt_dir = os.path.join(gt_benchmark_dir, benchmark)
    if rank != 0:
        pass                    # rank 0 scores the merged tree
    elif os.path.exists(gt_dir):
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
