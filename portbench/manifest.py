"""BENCHMARK.json and the files it names: everything about a cell is found
by name, so that a cell, a configuration, a model family, a traffic mix or
a metric is added by adding files and entries, never by editing one.

    portbench/configs/<config>.json   the configuration as it is run
    portbench/families/<family>.py    what differs between model families
                                      (families/__init__.py), found by the
                                      module part of the configuration's
                                      `model` ('regtr.RegTR': regtr)
    portbench/traffic/mixes/<traffic>.json   the traffic's parameters
    portbench/traffic/<source>.py     a mix's `source`: pairs(mix, seed)
    portbench/limits/<workload>.json  the limits of the cell's checks
    portbench/metrics/<metric>.py     a per-layer metric's reader

A configuration of a new model family, and its cell, take these new files
(the program already registers the model under the configuration's
`model`):
    portbench/configs/<config>.json, with its `model`
    portbench/families/<family>.py, with families.HOOKS' names (those
        of every family, weight_rule among them, and of its cells'
        entries), its reference class beside it in the same file or in a
        new file of portbench/reference/
    portbench/traffic/mixes/<traffic>.json, and portbench/traffic/
        <source>.py where no source makes its inputs
    portbench/limits/<cell>.json, keyed as the family's forward_gaps (a
        forward cell) or check.train_gaps (a training cell) name its checks
    portbench/metrics/<metric>.py for each new per-layer metric
and these new entries in BENCHMARK.json: one in `configs`, one in
`workloads`, one in `per_layer` for each new reader.  The one entry that
already exists and has to change: the cell's name is appended to the
`workloads` list of each end-to-end metric it reports (`setup_s` and
`peak_mem_gib` list none, and take every cell).
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json; there are "
                     f"{[w['name'] for w in bench['workloads']]}")


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_limits(name: str) -> dict:
    return json.loads((HERE / "limits" / f"{name}.json").read_text())


def metrics_of(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ('end_to_end' or 'per_layer') metrics this cell reports:
    those that list it, or list no workloads."""
    return [m for m in bench[kind]
            if cell in m.get("workloads", [cell])]


def metric_reader(name: str):
    """`read(trace) -> value or None` of portbench/metrics/<name>.py."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def named_module(folder: str, name: str, provides):
    """portbench/<folder>/<name>.py, which has to define each of
    `provides`."""
    path = HERE / folder / f"{name}.py"
    if not name.isidentifier() or not path.is_file():
        there = sorted(p.stem for p in (HERE / folder).glob("*.py")
                       if not p.stem.startswith("_"))
        raise SystemExit(f"no portbench/{folder}/{name}.py; there are "
                         f"{there}")
    module = importlib.import_module(f"{__package__}.{folder}.{name}")
    missing = [n for n in provides if not hasattr(module, n)]
    if missing:
        raise SystemExit(f"portbench/{folder}/{name}.py lacks {missing}")
    return module


def family(cfg: dict, entries=()):
    """The model family of a configuration (its dict `config`), which has
    to provide the hooks of every family and of each of `entries`."""
    from .families import HOOKS

    provides = [n for part in ("every", *entries) for n in HOOKS[part]]
    return named_module("families", cfg["model"].rsplit(".", 1)[0],
                        provides)


def traffic_source(name: str):
    """A traffic mix's `source`: its module, with pairs(mix, seed)."""
    return named_module("traffic", name, ("pairs",))
