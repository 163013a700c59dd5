"""Run directories, logging and metric accumulation (the port's counterpart
of regtr_tpu/train/logging_utils.py), for one process.

`MetricsWriter` always appends to metrics_<subdir>.jsonl, with the JAX
package's records; TensorBoard gets the same scalars and histograms only
where `torch.utils.tensorboard` imports.
"""
from __future__ import annotations

import json
import logging
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

import numpy as np


def prepare_logger(log_path=None, dev: bool = False,
                   name: str = "regtr_tpu_torch"):
    """Create the run directory and wire console + log.txt logging.
    Returns (logger, logdir).

    The directory is fresh: a new timestamped one under log_path (default
    ../logs), or ../logdev wiped first with dev.  The test protocol appends
    to its est.log files, so a reused directory would mix two runs.
    """
    if dev:
        logdir = Path("../logdev")
        if logdir.exists():
            shutil.rmtree(logdir)
    else:
        base = Path(log_path) if log_path else Path("../logs")
        logdir = base / time.strftime("%y%m%d_%H%M%S")
    logdir.mkdir(parents=True, exist_ok=True)

    logger = logging.getLogger(name)
    logger.setLevel(logging.DEBUG)
    logger.handlers.clear()
    console = logging.StreamHandler(sys.stdout)
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(message)s", "%H:%M:%S"))
    logger.addHandler(console)
    fileh = logging.FileHandler(logdir / "log.txt")
    fileh.setLevel(logging.DEBUG)
    fileh.setFormatter(logging.Formatter(
        "%(asctime)s [%(levelname)s] %(name)s: %(message)s"))
    logger.addHandler(fileh)

    # Provenance: the command line and the git state, where there is one.
    try:
        sha = subprocess.run(["git", "rev-parse", "HEAD"],
                             capture_output=True, text=True,
                             timeout=5).stdout.strip() or "unknown"
        diff = subprocess.run(["git", "diff"], capture_output=True,
                              text=True, timeout=10).stdout
        (logdir / "compareHead.diff").write_text(diff)
    except (OSError, subprocess.TimeoutExpired):
        sha = "unknown"
    logger.info("Command: %s", " ".join(sys.argv))
    logger.info("Git SHA: %s; logdir: %s", sha, logdir)
    return logger, logdir


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.sum = 0.0
        self.count = 0

    def update(self, value, n=1):
        if np.isfinite(value):
            self.sum += float(value) * n
            self.count += n

    @property
    def avg(self):
        return self.sum / max(self.count, 1)


def combine_process_sums(gathered):
    """Global averages from per-process (sum, count) statistics.

    gathered: (P, K, 2), each of P processes' (sum, count) of K metrics.
    Returns (K,) averages.  One process today; the multi-GPU port reduces
    its validation metrics through it.
    """
    tot = np.asarray(gathered, np.float64).sum(axis=0)       # (K, 2)
    return tot[:, 0] / np.maximum(tot[:, 1], 1.0)


class StatsMeter:
    """Dict of AverageMeters keyed by metric name."""

    def __init__(self):
        self.meters = defaultdict(AverageMeter)

    def sums_counts(self, keys):
        """(K, 2) array of (sum, count), for a cross-process reduction."""
        return np.asarray(
            [[self.meters[k].sum, self.meters[k].count] for k in keys],
            np.float64,
        )

    def update(self, metrics: dict):
        for k, v in metrics.items():
            v = np.asarray(v)
            if v.ndim == 0:
                self.meters[k].update(float(v))
            else:
                # per-layer vectors: the final layer's value
                self.meters[k].update(float(v.reshape(-1)[-1]))

    def averages(self):
        return {k: m.avg for k, m in self.meters.items()}

    def reset(self):
        self.meters.clear()


class MetricsWriter:
    """metrics_<subdir>.jsonl (always) + TensorBoard (when it imports)."""

    def __init__(self, logdir, subdir="train"):
        self.path = Path(logdir) / f"metrics_{subdir}.jsonl"
        self._f = open(self.path, "a")
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            return
        self._tb = SummaryWriter(str(Path(logdir) / subdir))

    def write(self, step: int, metrics: dict):
        rec = {"step": int(step)}
        for k, v in metrics.items():
            arr = np.asarray(v)
            rec[k] = float(arr.reshape(-1)[-1]) if arr.ndim else float(arr)
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in rec.items():
                if k != "step":
                    self._tb.add_scalar(k, v, step)

    def write_histogram(self, step: int, tag: str, values):
        """A per-pair error distribution: quantile summaries in the JSONL,
        the full histogram in TensorBoard."""
        v = np.asarray(values, np.float64).reshape(-1)
        if v.size == 0:
            return
        rec = {
            "step": int(step), "tag": tag, "count": int(v.size),
            "mean": float(v.mean()),
            "p50": float(np.percentile(v, 50)),
            "p90": float(np.percentile(v, 90)),
            "p99": float(np.percentile(v, 99)),
            "max": float(v.max()),
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        if self._tb is not None:
            self._tb.add_histogram(tag, v, step)

    def close(self):
        self._f.close()
        if self._tb is not None:
            self._tb.close()
