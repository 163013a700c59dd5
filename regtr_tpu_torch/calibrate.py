"""The calibration command line (the port's counterpart of the root
calibrate.py): measure the static shape schedule of a dataset on the card
and write it back into the config YAML.

    python -m regtr_tpu_torch.calibrate --config conf/3dmatch.yaml \\
        [--output OUT.yaml] [--phase train] [--num_samples 50] \\
        [--keep_ratio 0.8] [--safety 1.15] [--dry-run] [--device cuda]

It writes kpconv_options.neighborhood_limits (per-level K covering
keep_ratio of all neighbors), tpu_options.level_capacities (the most points
per pyramid level) and tpu_options.cell_capacity (the most points per grid
cell), over --config in place unless --output is given; --dry-run prints
them.  The YAML is read and written by the port's own two-level loader and
emitter (regtr_tpu_torch/config.py), without PyYAML.  --device: "cuda"
(the default) raises where there is no CUDA device; the CPU runs only when
asked for.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Calibrate static shapes (neighbor K, level capacities)"
    )
    p.add_argument("--config", required=True, help="Config YAML to calibrate")
    p.add_argument("--output", default=None,
                   help="Where to write the updated YAML "
                        "(default: in-place over --config)")
    p.add_argument("--phase", default="train",
                   choices=["train", "val", "test"])
    p.add_argument("--num_samples", type=int, default=50)
    p.add_argument("--keep_ratio", type=float, default=0.8)
    p.add_argument("--safety", type=float, default=1.15)
    p.add_argument("--dry-run", action="store_true",
                   help="Print the suggestions without writing the YAML")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def update_yaml(raw: dict, result: dict) -> dict:
    """Fold calibration results into a two-level raw-YAML dict (in place).

    neighborhood_limits belongs to the section that already defines it
    (kpconv_options in the shipped schema); capacities go to tpu_options.
    """
    target = None
    for section, entries in raw.items():
        if isinstance(entries, dict) and "neighborhood_limits" in entries:
            target = section
            break
    raw.setdefault("kpconv_options", {})
    raw[target or "kpconv_options"]["neighborhood_limits"] = \
        result["neighborhood_limits"]
    tpu = raw.setdefault("tpu_options", {})
    tpu["level_capacities"] = result["level_capacities"]
    tpu["cell_capacity"] = result["cell_capacity"]
    return raw


def main(argv=None):
    opt = parse_args(argv)
    import torch

    from .config import dump_yaml_sections, load_config, parse_yaml_sections
    from .data import get_dataset
    from .data.calibrate import calibrate

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: CUDA is not available")
    cfg = load_config(opt.config)
    dataset = get_dataset(cfg, opt.phase)
    result = calibrate(
        dataset, cfg, num_samples=opt.num_samples,
        keep_ratio=opt.keep_ratio, safety=opt.safety, device=device,
    )
    print(f"calibrated over {result['num_samples']} samples "
          f"({opt.phase}):", file=sys.stderr)
    print(f"  neighborhood_limits: {result['neighborhood_limits']}",
          file=sys.stderr)
    print(f"  level_capacities:    {result['level_capacities']}",
          file=sys.stderr)
    print(f"  cell_capacity:       {result['cell_capacity']}",
          file=sys.stderr)

    if opt.dry_run:
        print(dump_yaml_sections({
            "kpconv_options": {
                "neighborhood_limits": result["neighborhood_limits"]},
            "tpu_options": {
                "cell_capacity": result["cell_capacity"],
                "level_capacities": result["level_capacities"]}}), end="")
        return result

    raw = parse_yaml_sections(Path(opt.config).read_text(), opt.config)
    update_yaml(raw, result)
    out_path = opt.output or opt.config
    Path(out_path).write_text(dump_yaml_sections(raw))
    print(f"wrote {out_path}", file=sys.stderr)
    return result


if __name__ == "__main__":
    main()
