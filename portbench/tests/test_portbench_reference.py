"""The plain reference against the measured package's plain CPU route at
the tiny configuration, on the same weights and points: the forward and
the losses bit for bit (the same operations in the same order), a
training step's gradients and update to rounding."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import cells, check, weights
from portbench.families import regtr
from portbench.reference.model import RegTR as Reference
from portbench.tests.tiny import tiny_config
from portbench.traffic import generator


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_config()
    mix = dict(generator.load_mix("rooms-2pairs-train"), pool_pairs=6,
               points_per_scan=700)
    pool = generator.make_pool(mix, cfg, 2 ** 31 + 3)
    n0 = pool[0]["points"].shape[1]
    w = weights.draw(cells.parameter_shapes(cfg, n0), 11, torch.device(
        "cpu"))
    return cfg, pool, w


def test_weights_cover_every_parameter(setup):
    cfg, pool, w = setup
    n0 = pool[0]["points"].shape[1]
    assert set(w) == set(Reference(cfg, n0).state_dict())
    assert set(w) == set(cells.parameter_shapes(cfg, n0))
    assert float(w["transformer_encoder.layer_0.norm1.weight"].min()) == 1.0


def test_forward_bitwise_the_plain_route(setup):
    cfg, pool, w = setup
    cpu = torch.device("cpu")
    program = cells.ForwardCell(cfg, pool, w, cpu)
    program.warm()
    got = program.answers()
    ref = check.forward_answers(cfg, pool, w, cpu)
    gaps = regtr.forward_gaps(got, ref)
    assert gaps == {"kp_gap": 0.0, "corr_gap": 0.0, "overlap_gap": 0.0,
                    "pose_gap": 0.0}


def test_losses_bitwise_and_a_step_to_rounding(setup):
    cfg, pool, w = setup
    cpu = torch.device("cpu")
    program = cells.TrainStepCell(cfg, pool, w, cpu)
    program.warm()
    ref = check.train_record(cfg, pool, w, cpu)
    gaps = check.train_gaps(program.answers(), ref)
    assert gaps["loss_gap"] < 1e-5
    assert gaps["grad_gap"] < 1e-4
    assert gaps["update_gap"] < 1e-3
    assert np.isfinite(ref["losses"]).all()


def test_the_losses_of_one_batch_are_the_programs(setup):
    from regtr_tpu_torch.models import create_model

    cfg, pool, w = setup
    b = {k: torch.from_numpy(v) for k, v in pool[0].items()}
    model = create_model(cfg, b["points"].shape[1], "cpu")
    model.load_state_dict(w)
    want, _ = model.compute_loss(b["points"], b["mask"], b["pose"],
                                 b["overlap0"])
    ref = Reference(cfg, b["points"].shape[1])
    ref.load_state_dict(w)
    got, _ = ref.losses(ref.pyramid(b["points"], b["mask"]), b["pose"],
                        b["overlap0"])
    assert set(got) == set(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k


def test_the_window_reference_leaves_the_programs_state_as_it_was(setup):
    """The reference follows the window's stretch from copies of the state
    the program recorded: its optimizer moves moments of its own, not the
    record's (on the host, `.to(device)` alone hands over the record's own
    tensors), so a second reference, such as the control, starts where the
    first did."""
    cfg, pool, w = setup
    start = {"count": 3, "params": {n: t.clone() for n, t in w.items()},
             "mu": {n: torch.full_like(t, 1e-3) for n, t in w.items()},
             "nu": {n: torch.full_like(t, 1e-6) for n, t in w.items()}}
    before = {k: {n: t.clone() for n, t in start[k].items()}
              for k in ("params", "mu", "nu")}
    check.train_record(cfg, pool, w, torch.device("cpu"), steps=1,
                       window={"start": start, "batches": [1]})
    for key, tensors in before.items():
        for n, t in tensors.items():
            assert torch.equal(start[key][n], t), (key, n)
