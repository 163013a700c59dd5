"""Parameters into the port's flat .npz, with no JAX and no PyYAML.

    python -m regtr_tpu_torch.convert_checkpoint ckpt.pth \
        --config conf/3dmatch.yaml --out params.npz [--kernel_points kp.npz]

    python -m regtr_tpu_torch.convert_checkpoint --export RUN_OR_CKPT_DIR \
        --out params.npz [--config conf.yaml] [--latest]

The first form converts an upstream RegTR checkpoint (the reference saves
{'state_dict': ...}; a bare state_dict is read too) by
`convert.state_dict_from_reference`.  A parameter the checkpoint lacks (a
loss's `W`) keeps the value the model is initialised with, with a warning,
as `load_params_npz` does.  --kernel_points also writes the checkpoint's
per-block kernel dispositions, for the config key
`kernel_dispositions_file`: the reference draws each block's disposition
at random and stores it, so without them the converted model runs on the
port's own dispositions.  The second form writes a checkpoint of the
port's trainer (the best by validation score, or --latest), its config
found next to the run when not given: the counterpart of the JAX
package's tools/export_params_npz.py.

Either .npz is what `python -m regtr_tpu_torch.test --params` and `demo
--params` read (`train.checkpoints.save_params_npz`).  File in, file out:
the model is built on the CPU and nothing is computed.
"""
from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path

logger = logging.getLogger(__name__)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt", nargs="?", type=str,
                   help="upstream RegTR checkpoint (.pth)")
    p.add_argument("--export", type=str, default=None,
                   help="run directory or ckpt/ of the port's trainer, "
                        "instead of an upstream checkpoint")
    p.add_argument("--config", type=str, default=None,
                   help="Config YAML (with --export: default next to the "
                        "run)")
    p.add_argument("--out", type=str, required=True, help="output .npz")
    p.add_argument("--kernel_points", type=str, default=None,
                   help="also write the checkpoint's kernel dispositions "
                        "to this .npz")
    p.add_argument("--latest", action="store_true",
                   help="with --export: the latest step, not the best")
    opt = p.parse_args(argv)
    if (opt.ckpt is None) == (opt.export is None):
        p.error("give either an upstream checkpoint or --export")
    if opt.ckpt is not None and opt.config is None:
        p.error("an upstream checkpoint needs --config")
    if opt.export is not None and opt.kernel_points is not None:
        p.error("--kernel_points reads an upstream checkpoint")
    return opt


def _export_config(ckpt_dir: Path) -> str:
    for candidate in (ckpt_dir.parent / "config.yaml",
                      ckpt_dir / "config.yaml"):
        if candidate.exists():
            return str(candidate)
    sys.exit(f"config.yaml not found near {ckpt_dir}")


def main(argv=None):
    opt = parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    import numpy as np
    import torch

    from .config import load_config
    from .convert import reference_kernel_points, state_dict_from_reference
    from .models import create_model
    from .train.checkpoints import (CheckpointManager, resolve_ckpt_dir,
                                    save_params_npz)

    if opt.export is not None:
        ckpt_dir = resolve_ckpt_dir(opt.export)
        cfg = load_config(opt.config or _export_config(ckpt_dir))
        model = create_model(cfg, max(cfg["buckets"]), "cpu")
        step = CheckpointManager(ckpt_dir).restore(model,
                                                   best=not opt.latest)
        save_params_npz(opt.out, model)
        print(f"wrote the parameters of step {step} to {opt.out}")
        return model

    cfg = load_config(opt.config)
    raw = torch.load(opt.ckpt, map_location="cpu", weights_only=False)
    sd = raw.get("state_dict", raw)
    converted = state_dict_from_reference(sd, cfg)
    model = create_model(cfg, max(cfg["buckets"]), "cpu")
    expected = model.state_dict()
    unknown = sorted(set(converted) - set(expected))
    if unknown:
        raise KeyError(f"converted parameters the model of {opt.config} "
                       f"does not have: {unknown[:5]}")
    missing = sorted(set(expected) - set(converted))
    if missing:
        logger.warning("%d parameters not in %s (kept init values): %s%s",
                       len(missing), opt.ckpt, ", ".join(missing[:5]),
                       "..." if len(missing) > 5 else "")
    model.load_state_dict(converted, strict=False)
    save_params_npz(opt.out, model)
    print(f"wrote {len(converted)} converted parameters of {len(expected)} "
          f"to {opt.out}")
    if opt.kernel_points:
        np.savez(opt.kernel_points, **reference_kernel_points(sd))
        print(f"wrote the kernel dispositions to {opt.kernel_points}")
    return model


if __name__ == "__main__":
    main()
