"""The port's training command line (the counterpart of the root train.py).

    python -m regtr_tpu_torch.train --config conf/synthetic.yaml \
        [--logdir ../logs] [--dev] [--name NAME] [--summary_every 500] \
        [--validate_every -1] [--num_workers 4] [--resume RUN_OR_CKPT_DIR] \
        [--nb_sanity_val_steps 2] [--device cuda:0] [--dist_backend nccl]

    python -m torch.distributed.run --standalone --nproc_per_node N \
        -m regtr_tpu_torch.train --config ...

The config is copied into a fresh run directory under --logdir, beside
log.txt, the metrics_*.jsonl files and ckpt/.  --resume takes a run
directory or its ckpt/ (this run's or another's) and, without --config,
reads the config.yaml found next to it.  --validate_every -1 validates
once per epoch, 0 validates once and exits.  --device replaces the JAX
command's --platform: by default cuda:<LOCAL_RANK> (cuda:0 alone), which
raises where there is no CUDA device; the CPU runs only when asked for.

Data parallelism: the JAX command's --num_devices (the mesh inside one
process) becomes the launcher's --nproc_per_node, one rank per device.
Each rank trains on its shard of the data with `train_batch_size` pairs a
step, so a step's global batch is N times that; the ranks sum their
gradients (regtr_tpu_torch/parallel/dist.py).  --dist_backend defaults to
nccl on a card and gloo on the CPU; gloo also lets several ranks share one
card (`--device cuda:0`).
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a registration model")
    p.add_argument("--config", type=str, help="Path to the config YAML")
    p.add_argument("--logdir", type=str, default="../logs",
                   help="Directory to store logs, summaries, checkpoints")
    p.add_argument("--dev", action="store_true",
                   help="If true, logs to ../logdev (wiped each run)")
    p.add_argument("--name", type=str, help="Experiment name prefix")
    p.add_argument("--summary_every", type=int, default=500)
    p.add_argument("--validate_every", type=int, default=-1,
                   help="-1: once per epoch; 0: validate then exit")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--resume", type=str,
                   help="Run directory or checkpoint directory to resume "
                        "from")
    p.add_argument("--nb_sanity_val_steps", type=int, default=2)
    p.add_argument("--device", type=str, default=None,
                   help="default: cuda:<LOCAL_RANK>")
    p.add_argument("--dist_backend", type=str, default=None,
                   choices=["nccl", "gloo"],
                   help="with several ranks; default: nccl on a card, "
                        "gloo on the CPU")
    p.add_argument("--dist_timeout", type=float, default=1800.0,
                   help="seconds a collective waits for the other ranks")
    return p.parse_args(argv)


def main(argv=None):
    """Train (or validate, with --validate_every 0); returns the Trainer."""
    opt = parse_args(argv)
    import torch

    from ..parallel import dist

    device = dist.resolve_device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    made_group = dist.init_distributed(opt.dist_backend, device,
                                       opt.dist_timeout)
    try:
        return _train(opt, device)
    finally:
        if made_group:
            dist.shutdown()


def _train(opt, device):
    import torch

    from ..config import load_config
    from ..data import get_dataloader
    from ..models import create_model
    from ..parallel import dist
    from .logging_utils import prepare_logger
    from .trainer import Trainer

    if opt.config is None:
        if opt.resume is None:
            sys.exit("--config or --resume required")
        candidate = Path(opt.resume).parent / "config.yaml"
        if not candidate.exists():
            candidate = Path(opt.resume) / "config.yaml"
        if not candidate.exists():
            sys.exit(f"config.yaml not found near {opt.resume}")
        opt.config = str(candidate)

    cfg = load_config(opt.config)
    logger, logdir = prepare_logger(
        opt.logdir if not opt.name else os.path.join(opt.logdir, opt.name),
        dev=opt.dev)
    if dist.rank() == 0:
        shutil.copy(opt.config, logdir / "config.yaml")
    logger.info("Device: %s (%s); rank %d of %d", device,
                torch.cuda.get_device_name(device)
                if device.type == "cuda" else "host CPU", dist.rank(),
                dist.world_size())

    # each rank loads its shard; the trainer reduces over the ranks
    shard = ((dist.rank(), dist.world_size()) if dist.world_size() > 1
             else None)
    train_loader = get_dataloader(cfg, "train", num_workers=opt.num_workers,
                                  shard=shard)
    val_loader = get_dataloader(cfg, "val", num_workers=opt.num_workers,
                                shard=shard)
    model = create_model(cfg, max(cfg["buckets"]), device,
                         seed=int(cfg.get("seed", 0)))
    trainer = Trainer(cfg, logdir, summary_every=opt.summary_every,
                      validate_every=opt.validate_every,
                      nb_sanity_val_steps=opt.nb_sanity_val_steps)
    if opt.validate_every == 0:
        if opt.resume:
            step = trainer.restore_from(opt.resume, model)
            logger.info("Loaded checkpoint at step %d", step)
        trainer._run_validation(model, val_loader)
        return trainer
    trainer.fit(model, train_loader, val_loader, resume=opt.resume,
                niter=cfg.get("niter", -1))
    return trainer


if __name__ == "__main__":
    main()
