"""Cells for the tests: each cell's configuration, traffic mix and limits
by name, and tiny versions of them for the CPU: the measured package's
tiny configuration (ModelNet's layout at narrow widths) with small pools
of small scans."""
from __future__ import annotations

from portbench import manifest, run
from portbench.traffic.generator import load_mix

CELLS = {"3dmatch-infer": ("regtr-3dmatch", "rooms-4pairs"),
         "3dmatch-train": ("regtr-3dmatch", "rooms-2pairs-train")}


def tiny_config():
    from regtr_tpu_torch.config import tiny_config as program_tiny

    cfg = program_tiny(remat=False)
    cfg.pop("config_path", None)
    cfg["buckets"] = [1024]
    return cfg


def full(name):
    """(configuration dict, traffic mix) of the cell `name`."""
    config, traffic = CELLS[name]
    return manifest.load_config(config)["config"], load_mix(traffic)


def cell(name, **mix_overrides):
    """The cell `name` on the tiny configuration, its mix cut to a few
    small pairs."""
    mix = load_mix(CELLS[name][1])
    batches = 4 if mix["entry"] == "train_step" else 2
    small = {"pool_pairs": batches * mix["pairs_per_batch"]}
    if mix["source"] == "rooms":
        small["points_per_scan"] = 700
    small.update(mix_overrides)
    mix.update(small)
    return run.Cell(name, {"config": tiny_config()}, mix,
                    manifest.load_limits(name))
