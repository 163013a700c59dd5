"""The port's evaluation command line: the 3DMatch / 3DLoMatch test protocol.

    python -m regtr_tpu_torch.test --params params.npz --benchmark 3DMatch \
        [--config conf.yaml] [--logdir ../logs] [--dev] [--num_workers 4] \
        [--device cuda]

The same surface as the JAX package's test.py: the config is resolved
next to the parameters when not given, the model is built at the config's
largest bucket, and the protocol's est.log files, benchmark_report.txt and
log.txt go to a fresh run directory under --logdir.  --device replaces
--platform: "cuda" (the default) raises where there is no CUDA device; the
CPU runs only when asked for.
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
                   help="Checkpoint directory (orbax): not supported here")
    p.add_argument("--params", type=str, default=None,
                   help="Flat .npz params (save_params_npz, or "
                        "tools/convert_torch_ckpt.py)")
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
    from .train.checkpoints import load_params_npz
    from .train.logging_utils import prepare_logger

    if opt.resume is not None:
        raise NotImplementedError(
            "--resume: orbax checkpoints: use --params (the port's own "
            "checkpoints come with the trainer, ROADMAP.md Queue A 10)")
    if opt.params is None:
        sys.exit("--params is required")
    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    if opt.config is None:
        candidate = Path(opt.params).parent / "config.yaml"
        if not candidate.exists():
            candidate = Path(opt.params) / "config.yaml"
        if not candidate.exists():
            sys.exit(f"config.yaml not found near {opt.params}")
        opt.config = str(candidate)
    cfg = load_config(opt.config)
    cfg["benchmark"] = opt.benchmark
    if opt.benchmark not in ("3DMatch", "3DLoMatch"):
        raise NotImplementedError(
            f"--benchmark {opt.benchmark}: the ModelNet protocol is not "
            "ported yet (ROADMAP.md Queue A 12)")
    if cfg["dataset"] != "3dmatch":
        sys.exit(f"--benchmark {opt.benchmark} needs a 3dmatch config, got "
                 f"dataset {cfg['dataset']!r}")

    logger, logdir = prepare_logger(opt.logdir, dev=opt.dev)
    test_loader = get_dataloader(cfg, "test", num_workers=opt.num_workers)
    # Level 0 follows each batch's bucket; levels >= 1 have the capacities
    # of the largest bucket.
    model = create_model(cfg, max(cfg["buckets"]), device)
    load_params_npz(opt.params, model)
    logger.info("Loaded .npz params from %s", opt.params)
    results = run_test(cfg, model, test_loader, logdir)
    logger.info("Test results: %s", results)
    return results


if __name__ == "__main__":
    main()
