"""Run directories and logging (the port's counterpart of `prepare_logger`
in regtr_tpu/train/logging_utils.py), for one process."""
from __future__ import annotations

import logging
import shutil
import subprocess
import sys
import time
from pathlib import Path


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
