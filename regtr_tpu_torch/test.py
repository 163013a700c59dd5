"""The port's evaluation command line: the 3DMatch / 3DLoMatch and the
ModelNet / ModelLoNet test protocols.

    python -m regtr_tpu_torch.test (--resume RUN_OR_CKPT_DIR | --params
        params.npz) --benchmark 3DMatch [--config conf.yaml] \
        [--logdir ../logs] [--dev] [--num_workers 4] [--device cuda]

The same surface as the JAX package's test.py: --resume restores the best
checkpoint (by validation score) of a run of `python -m
regtr_tpu_torch.train`, given its run directory or its ckpt/; --params
loads a flat .npz.  The config is resolved next to either when not given,
the model is built at the config's largest bucket, and the protocol's
est.log files, benchmark_report.txt and log.txt go to a fresh run
directory under --logdir.  3DMatch and 3DLoMatch need a `3dmatch` config;
ModelNet and ModelLoNet a `modelnet` or `synthetic` one, whose crop they
set (`partial` [0.7, 0.7] and [0.5, 0.5]), and they write
pred_transforms.npy.  --device replaces --platform: "cuda" (the
default) raises where there is no CUDA device; the CPU runs only when
asked for.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a registration model")
    p.add_argument("--config", type=str,
                   help="Config YAML (default: next to the parameters)")
    p.add_argument("--resume", type=str, default=None,
                   help="Run directory or checkpoint directory of the "
                        "port's trainer, or a flat .npz")
    p.add_argument("--params", type=str, default=None,
                   help="Flat .npz params (save_params_npz, or "
                        "tools/convert_torch_ckpt.py); alternative to "
                        "--resume")
    p.add_argument("--benchmark", type=str, default="3DMatch",
                   choices=["3DMatch", "3DLoMatch", "ModelNet", "ModelLoNet"])
    p.add_argument("--logdir", type=str, default="../logs")
    p.add_argument("--dev", action="store_true")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    import torch

    from .config import load_config
    from .data import get_dataloader
    from .evaluation import run_test
    from .models import create_model
    from .train.checkpoints import (CheckpointManager, load_params_npz,
                                    resolve_ckpt_dir)
    from .train.logging_utils import prepare_logger

    if opt.resume is None and opt.params is None:
        sys.exit("one of --resume / --params is required")
    ckpt_ref = opt.resume or opt.params
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    if opt.config is None:
        candidate = Path(ckpt_ref).parent / "config.yaml"
        if not candidate.exists():
            candidate = Path(ckpt_ref) / "config.yaml"
        if not candidate.exists():
            sys.exit(f"config.yaml not found near {ckpt_ref}")
        opt.config = str(candidate)
    cfg = load_config(opt.config)
    cfg["benchmark"] = opt.benchmark
    if opt.benchmark in ("3DMatch", "3DLoMatch"):
        if cfg["dataset"] != "3dmatch":
            sys.exit(f"--benchmark {opt.benchmark} needs a 3dmatch config, "
                     f"got dataset {cfg['dataset']!r}")
    else:
        if cfg["dataset"] not in ("modelnet", "synthetic"):
            sys.exit(f"--benchmark {opt.benchmark} needs a modelnet or "
                     f"synthetic config, got dataset {cfg['dataset']!r}")
        cfg["partial"] = ([0.5, 0.5] if opt.benchmark == "ModelLoNet"
                          else [0.7, 0.7])

    logger, logdir = prepare_logger(opt.logdir, dev=opt.dev)
    test_loader = get_dataloader(cfg, "test", num_workers=opt.num_workers)
    # Level 0 follows each batch's bucket; levels >= 1 have the capacities
    # of the largest bucket.
    model = create_model(cfg, max(cfg["buckets"]), device)
    npz_path = opt.params or (
        opt.resume if str(ckpt_ref).endswith(".npz") else None)
    if npz_path:
        load_params_npz(npz_path, model)
        logger.info("Loaded .npz params from %s", npz_path)
    else:
        step = CheckpointManager(resolve_ckpt_dir(opt.resume)).restore(
            model, best=True)
        logger.info("Loaded checkpoint at step %d", step)
    results = run_test(cfg, model, test_loader, logdir)
    logger.info("Test results: %s", results)
    return results


if __name__ == "__main__":
    main()
