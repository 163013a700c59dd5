"""BENCHMARK.json against the benchmark's contract, and the files it names."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import manifest
from portbench.traffic.generator import load_mix

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"configs": {"name", "source", "file", "reduced", "why"},
        "workloads": {"name", "config", "traffic", "chips", "why"},
        "end_to_end": {"name", "unit", "better", "bound", "source"},
        "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")


@pytest.mark.parametrize("section", sorted(KEYS))
def test_entries_have_their_keys_only(section):
    for e in BENCH[section]:
        extra = set(e) - KEYS[section]
        assert set(e) >= KEYS[section], e
        assert extra <= {"workloads"} and (
            not extra or section in ("end_to_end", "per_layer")), e


@pytest.mark.parametrize("section", sorted(KEYS))
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] \
                    and "\t" not in e[key]
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])
        for key in e.get("reduced", []):
            assert NAME.match(key)


def test_configs_files_and_cells():
    configs = {c["name"]: c for c in BENCH["configs"]}
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    for c in BENCH["configs"]:
        doc = json.loads((ROOT / c["file"]).read_text())
        assert c["file"].startswith("portbench/")
        assert doc["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not key.endswith(("_dim", "_rank"))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])


def test_every_cell_has_its_files_and_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in BENCH["workloads"]:
        cell = w["name"]
        assert (ROOT / "portbench/traffic/mixes" /
                f"{w['traffic']}.json").exists()
        assert set(manifest.load_limits(cell))
        ends = [m["name"] for m in manifest.metrics_of(BENCH, cell,
                                                       "end_to_end")]
        assert "setup_s" in ends and len(ends) >= 2
        assert manifest.metrics_of(BENCH, cell, "per_layer")


def test_moves_names_an_end_to_end_metric_of_the_same_cells():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        listed = set(m.get("workloads", cells))
        assert listed <= cells
        assert listed <= set(e2e[m["moves"]].get("workloads", cells))
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()
        assert callable(manifest.metric_reader(m["name"]))
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_four_chip_cells_are_at_most_a_quarter():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_every_config_file_is_complete():
    """The configuration files, also those no cell uses yet."""
    for path in sorted((ROOT / "portbench/configs").glob("*.json")):
        doc = json.loads(path.read_text())
        assert {"source", "shipped", "dtype", "reduced", "assumed",
                "config"} <= set(doc)
        assert doc["config"]["compute_dtype"] == doc["dtype"]
        assert (ROOT / "portbench/limits").exists()


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench/configs").glob("*.json")), ids=lambda p: p.stem)
def test_every_config_has_its_family(path):
    """portbench/families/<family>.py, named by the module part of the
    configuration's model, exists and provides the hooks of every family
    and of the entries of the cells that run the configuration."""
    cfg = json.loads(path.read_text())["config"]
    name = cfg["model"].rsplit(".", 1)[0]
    assert (ROOT / "portbench/families" / f"{name}.py").is_file()
    configs = {c["name"] for c in BENCH["configs"]
               if c["file"] == str(path.relative_to(ROOT))}
    entries = sorted({load_mix(w["traffic"])["entry"]
                      for w in BENCH["workloads"] if w["config"] in configs})
    family = manifest.family(cfg, entries)
    assert family.__name__ == f"portbench.families.{name}"


@pytest.mark.parametrize("path", sorted(
    (ROOT / "portbench/traffic/mixes").glob("*.json")), ids=lambda p: p.stem)
def test_every_mix_has_its_source(path):
    mix = json.loads(path.read_text())
    assert (ROOT / "portbench/traffic" / f"{mix['source']}.py").is_file()
    assert callable(manifest.traffic_source(mix["source"]).pairs)


@pytest.mark.parametrize("name,loader", [("regtr-3dmatch",
                                          "threedmatch_config")])
def test_config_files_are_the_shipped_yaml(name, loader):
    """The frozen configuration is what the program loads from the YAML
    it names (less the paths of files the model never reads), with
    upstream's values where the YAML departs from them."""
    from regtr_tpu_torch import config

    shipped = getattr(config, loader)()
    doc = manifest.load_config(name)
    assert doc["shipped"] == f"conf/{Path(shipped['config_path']).name}"
    for key in ("config_path", "train_categoryfile", "val_categoryfile",
                "test_categoryfile"):
        shipped.pop(key, None)
    upstream = {k: v for k, v in doc.get("upstream_over_shipped", {}).items()
                if k != "why"}
    assert all(shipped[k] != v for k, v in upstream.items())
    assert doc["config"] == dict(shipped, **upstream)
    assert doc["reduced"] == []
