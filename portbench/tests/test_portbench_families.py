"""A model family is added to the harness by new files alone.  A copy of
BENCHMARK.json and portbench/ takes a toy registration model's family
module (with its own weight rule, for a scalar parameter that RegTR's
rules refuse, and only the hooks of a forward cell), traffic source,
configuration, mix and limits as new files, and new entries (the recipe
in portbench/manifest.py); the toy model is registered with the
program's `register_model` inside the test.  Its forward cell runs
correct on the CPU through `run.run_cell`, and not correct with its
answer altered where it is produced.  Nothing of the
repository is written."""
from __future__ import annotations

import importlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import manifest
from portbench.tests.tiny import tiny_config

ROOT = Path(__file__).resolve().parents[2]

TOY_FAMILY = '''"""The toy registration model (toy.Toy): each cloud's mean
embedding gives it a shift; the pose is the identity rotation with the
target's shift less the source's, scaled by a scalar `alpha`."""
import math

import torch
import torch.nn as nn


class Reference(nn.Module):
    def __init__(self, cfg, n0):
        super().__init__()
        self.embed = nn.Linear(3, 8)
        self.shift = nn.Linear(8, 3)
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, points, mask):
        m = mask[..., None].float()
        e = torch.relu(points @ self.embed.weight.t() + self.embed.bias)
        f = (e * m).sum(1) / m.sum(1)
        s = f @ self.shift.weight.t() + self.shift.bias
        rot = torch.eye(3).expand(points.shape[0] // 2, 3, 3)
        t = self.alpha * (s[1::2] - s[0::2])
        return torch.cat([rot, t[..., None]], -1)


def parameter_shapes(cfg, n0):
    from regtr_tpu_torch.models import get_model

    with torch.device("meta"):
        model = get_model(cfg["model"])(cfg, None)
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def weight_rule(name, shape):
    if name == "alpha":
        return "uniform", lambda x: x + 0.5
    if name.endswith(".bias"):
        return None, torch.zeros_like
    return "normal", lambda x: x / math.sqrt(shape[1])


def keep(out):
    return {"pose": out["pose"].cpu()}


def failed(kept):
    return not bool(torch.isfinite(kept["pose"]).all())


def reference_forward(model, points, mask):
    return {"pose": model(points, mask).cpu()}


def forward_gaps(got, ref):
    gap = 0.0
    for i, r in ref.items():
        if i not in got:
            return {"pose_gap": float("inf")}
        gap = max(gap, float((got[i]["pose"].double()
                              - r["pose"].double()).abs().max()))
    return {"pose_gap": gap if gap == gap else float("inf")}


def stages(model, points, mask, timed):
    timed("forward", model, points, mask)


def pool_counts(cfg, pool, device):
    return [{"forward": {"flops": float(b["mask"].sum()) * 2 * 3 * 8}}
            for b in pool]


def answer_altered(cell):
    forward = cell.model.forward

    def altered(points, mask):
        out = forward(points, mask)
        return {"pose": out["pose"] + torch.tensor([0.0, 0.0, 0.0, 0.01])}

    cell.model.forward = altered
    return cell


def half_batch(cell):
    forward = cell.forward

    def halved(points, mask):
        half = points.shape[0] // 4 * 2
        pose = forward(points[:half], mask[:half])["pose"]
        return {"pose": torch.cat([pose, pose])}

    cell.forward = halved
    return cell
'''

TOY_SOURCE = '''"""Toy pairs: a uniform cloud of `points` points and its copy
moved by a seeded translation."""
import numpy as np


def pairs(mix, seed):
    rng = np.random.RandomState((seed + mix["seed_offset"]) % 2 ** 32)
    out = []
    for _ in range(mix["pool_pairs"]):
        src = rng.rand(mix["points"], 3).astype(np.float32)
        t = rng.randn(3).astype(np.float32)
        pose = np.concatenate([np.eye(3, dtype=np.float32), t[:, None]], 1)
        out.append({"src_xyz": src, "tgt_xyz": src + t, "pose": pose})
    return out
'''

# the toy program model, registered in the run's process; then a sound
# run and one with the answer altered
RUN_SCRIPT = '''import functools, json, torch
import torch.nn as nn
from regtr_tpu_torch.models import register_model
from portbench import faults, manifest, run


class Toy(nn.Module):
    def __init__(self, cfg, spec):
        super().__init__()
        self.embed = nn.Linear(3, 8)
        self.shift = nn.Linear(8, 3)
        self.alpha = nn.Parameter(torch.tensor(1.0))

    def forward(self, points, mask):
        m = mask[..., None].to(points.dtype)
        f = (torch.relu(self.embed(points)) * m).sum(1) / m.sum(1)
        s = self.shift(f)
        rot = torch.eye(3).expand(points.shape[0] // 2, 3, 3)
        t = self.alpha * (s[1::2] - s[0::2])
        return {"pose": torch.cat([rot, t[..., None]], -1)}


register_model("toy.Toy", Toy)
bench = manifest.load_benchmark()
cell = run.Cell.load(bench, "toy-infer")
out = {"here": str(manifest.HERE)}
for fault in ("", "answer_altered"):
    wrap = functools.partial(faults.plant, fault) if fault else None
    r = run.run_cell(cell, 2 ** 31 + 7, 0.2, False, torch.device("cpu"),
                     bench, wrap=wrap)
    out[fault or "sound"] = {"correct": r["correct"], "attempted":
                             r["attempted"], "failed": r["failed"],
                             "checks": r["checks"],
                             "metrics": sorted(r["metrics"])}
print(json.dumps(out))
'''


def add_toy(tmp: Path):
    """The toy's new files and BENCHMARK.json entries, in a copy."""
    pb = tmp / "portbench"
    (pb / "families" / "toy.py").write_text(TOY_FAMILY)
    (pb / "traffic" / "blobs.py").write_text(TOY_SOURCE)
    cfg = dict(tiny_config(), model="toy.Toy")
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"source": "a toy", "reduced": [], "config": cfg}))
    (pb / "traffic" / "mixes" / "blobs-2pairs.json").write_text(json.dumps(
        {"entry": "forward", "source": "blobs", "pairs_per_batch": 2,
         "pool_pairs": 4, "seed_offset": 0, "points": 300}))
    (pb / "limits" / "toy-infer.json").write_text(json.dumps(
        {"pose_gap": 1e-5}))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy", "source": "a toy",
                             "file": "portbench/configs/toy.json",
                             "reduced": [], "why": "a toy"})
    bench["workloads"].append({"name": "toy-infer", "config": "toy",
                               "traffic": "blobs-2pairs", "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"]:
        if m["name"] in ("infer_pairs_per_s", "infer_p95_ms"):
            m["workloads"].append("toy-infer")
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))


def test_a_family_is_added_by_new_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    add_toy(tmp_path)
    out = subprocess.run(
        [sys.executable, "-c", RUN_SCRIPT], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT), USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["here"] == str(tmp_path / "portbench")
    sound, altered = got["sound"], got["answer_altered"]
    assert sound["correct"] and sound["attempted"] > 0, sound
    assert sound["failed"] == 0
    assert {"setup_s", "infer_pairs_per_s", "infer_p95_ms"} <= set(
        sound["metrics"])
    assert not altered["correct"], altered
    assert altered["checks"]["pose_gap"]["value"] > 0.005


def test_a_model_names_its_family():
    regtr = importlib.import_module("portbench.families.regtr")
    assert manifest.family({"model": "regtr.RegTR"}) is regtr
    with pytest.raises(SystemExit, match="families/toy.py"):
        manifest.family({"model": "toy.Toy"})
    # the toy's scalar takes its own family's rule: RegTR's has none
    with pytest.raises(ValueError, match="no weight rule for alpha"):
        regtr.weight_rule("alpha", ())
