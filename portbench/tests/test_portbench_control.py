"""On the card: the control (the reference in TF32, the next precision
below the configurations' float32) fails each cell's limits, and the
program at the same seed passes them; the same for the training cell's
faults that its limits are held against, and a fault in the neighbour
search.  At the cells' own configurations and batch sizes, on a pool of
one batch (training: the four the first steps and a one-second window
need).

    python -m pytest --noconftest -m cuda portbench/tests
"""
from __future__ import annotations

import pytest
import torch

from portbench import calibrate, cells, check, manifest
from portbench import weights as weights_mod
from portbench.tests.tiny import full
from portbench.traffic.generator import make_pool

SEED = 2 ** 31 + 404


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def readings(name, faults=()):
    device = card()
    cfg, mix = full(name)
    per = mix["pairs_per_batch"]
    mix["pool_pairs"] = per * (4 if mix["entry"] == "train_step" else 1)
    pool = make_pool(mix, cfg, SEED)
    weights = weights_mod.draw(cells.parameter_shapes(
        cfg, pool[0]["points"].shape[1]), SEED, device)
    entry = mix["entry"]
    held = {}
    out = {"program": calibrate.program_gaps(entry, cfg, pool, weights,
                                             device, detail=held)}
    out["control"] = check.gaps(cfg, entry, check.reference_answers(
        entry, cfg, pool, weights, device, tf32=True, got=held["got"]),
        held["ref"])
    for fault in faults:
        out[fault] = calibrate.program_gaps(entry, cfg, pool, weights,
                                            device, fault)
    return out, manifest.load_limits(name)


def fails(gaps, limits):
    return any(gaps[k] > limits[k] for k in limits)


@pytest.mark.cuda
def test_the_control_and_a_neighbor_fault_fail_the_inference_cell():
    got, limits = readings("3dmatch-infer", ("neighbor_dropped",))
    assert not fails(got["program"], limits), got
    for key in ("control", "neighbor_dropped"):
        assert fails(got[key], limits), (key, got)


@pytest.mark.cuda
def test_the_control_and_the_faults_fail_the_training_cell():
    faults = ("half_batch", "answer_altered", "neighbor_dropped")
    got, limits = readings("3dmatch-train", faults)
    assert not fails(got["program"], limits), got
    for key in ("control",) + faults:
        assert fails(got[key], limits), (key, got)
