"""The harness end to end on the CPU at tiny sizes: a sound run is
correct, each fault planted underneath the timed path makes it not
correct, no JAX module is loaded, and the command refuses to run without
a card."""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import faults, manifest, run
from portbench.tests.tiny import cell

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
BENCH = manifest.load_benchmark()


@pytest.mark.parametrize("name", ["3dmatch-infer", "3dmatch-train"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_sound_run_is_correct(name, trace):
    r = run.run_cell(cell(name), 2 ** 31 + 17, 0.5, trace, CPU, BENCH)
    assert r["correct"] and r["attempted"] > 0 and r["failed"] == 0
    assert list(r)[-1] == "checks"
    kind = "per_layer" if trace else "end_to_end"
    for m in manifest.metrics_of(BENCH, name, kind):
        if trace and m["source"] == "device_trace":
            continue            # no device here: the readers return None
        if m["name"] == "peak_mem_gib":
            continue
        assert m["name"] in r["metrics"], m["name"]


FAULTS = [("3dmatch-infer", "answer_altered"),
          ("3dmatch-infer", "half_batch"),
          ("3dmatch-infer", "neighbor_dropped"),
          ("3dmatch-train", "answer_altered"),
          ("3dmatch-train", "half_batch"),
          ("3dmatch-train", "state_unchanged"),
          ("3dmatch-train", "neighbor_dropped")]


@pytest.mark.parametrize("name,fault", FAULTS)
def test_a_fault_underneath_is_not_correct(name, fault):
    r = run.run_cell(cell(name), 2 ** 31 + 23, 0.2, False, CPU, BENCH,
                     wrap=functools.partial(faults.plant, fault))
    assert not r["correct"], r["checks"]


def test_forbidden_modules_compares_whole_top_level_names():
    assert run.forbidden_modules(["regtr_tpu_torch", "regtr_tpu_torch.ops",
                                  "jaxtyping", "flaxen", "numpy"]) == []
    assert run.forbidden_modules(["regtr_tpu.ops", "jax._src",
                                  "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "regtr_tpu"]


def test_nothing_the_benchmark_runs_imports_jax():
    code = ("import torch\n"
            "from portbench import calibrate, manifest, run\n"
            "from portbench.tests.tiny import cell\n"
            "run.run_cell(cell('3dmatch-infer'), 5, 0.2, True, "
            "torch.device('cpu'), manifest.load_benchmark())\n"
            "print(run.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_command_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "3dmatch-infer", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""


def test_the_command_needs_the_program():
    """In a directory with only BENCHMARK.json and portbench/ the command
    finds no program and prints no result."""
    import shutil
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy(ROOT / "BENCHMARK.json", tmp)
        shutil.copytree(ROOT / "portbench", Path(tmp) / "portbench",
                        ignore=shutil.ignore_patterns("__pycache__"))
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload",
             "3dmatch-infer", "--seed", "1", "--seconds", "1"],
            cwd=tmp, capture_output=True, text=True, timeout=300,
            env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert not out.stdout.strip() or "correct" not in json.dumps(
        out.stdout)
