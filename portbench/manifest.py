"""BENCHMARK.json and the files it names: everything about a cell is found
by name, so that a cell, a configuration, a traffic mix or a metric is
added by adding files and entries, never by editing one.

    portbench/configs/<config>.json   the configuration as it is run
    portbench/traffic/mixes/<traffic>.json   the traffic's parameters
    portbench/limits/<workload>.json  the limits of the cell's checks
    portbench/metrics/<metric>.py     a per-layer metric's reader
"""
from __future__ import annotations

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
