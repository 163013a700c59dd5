"""The program's profiler spans (regtr_tpu_torch/utils/profiling.py `span`)
and the benchmark's attribution of a profiled stretch to them
(portbench/spans.py), on the CPU at the tiny configuration, one pair a
batch: the spans' nesting on the inference and training paths, a shared
no-op with no profiler running, outputs and updates bitwise unmoved by a
profiler, the attribution rules on hand-made events, and a profiled
stretch of the benchmark's inference cell.  The harness's whole traced
run of each tiny cell is `portbench/tests/test_portbench_run.py`'s."""
from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import cells, spans
from portbench import weights as weights_mod
from portbench.tests.tiny import cell
from portbench.traffic.generator import make_pool
from regtr_tpu_torch.utils.profiling import span

CPU = torch.device("cpu")
SEED = 2 ** 31 + 61
FORWARD = [(0, "regtr.forward"), (1, "regtr.pyramid"), (1, "regtr.backbone"),
           (1, "regtr.transformer"), (1, "regtr.head_pose")]
TRAIN_STEP = [(0, "regtr.train_step"), (1, "regtr.forward_loss"),
              (2, "regtr.pyramid"), (2, "regtr.backbone"),
              (2, "regtr.transformer"), (2, "regtr.head_pose"),
              (2, "regtr.losses"), (1, "regtr.backward"),
              (1, "regtr.optimizer")]


def programs(name, n=1):
    """n of the benchmark's objects around the tiny cell's entry
    (make_forward or make_train_step), each on the same weights and pool
    of one one-pair batch."""
    c = cell(name, pool_pairs=1, pairs_per_batch=1)
    cfg = c.config["config"]
    pool = make_pool(c.mix, cfg, SEED)
    w = weights_mod.draw(cells.parameter_shapes(
        cfg, pool[0]["points"].shape[1]), SEED, CPU)
    return [cells.CELLS[c.mix["entry"]](cfg, pool, w, CPU)
            for _ in range(n)]


def profiled(fn):
    """fn() under a CPU profiler -> (its result, the events)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [spans.record(e) for e in
                 prof.profiler.kineto_results.events()]


def outline(events):
    """(depth, name) of the program's spans, in the order they opened."""
    s = spans.Spans([e for e in events if e.name.startswith(spans.PREFIX)])
    return [(len(chain) - 1, chain[0]) for chain in s.chains]


@pytest.fixture(scope="module")
def forward_runs():
    """The forward's cell object, and its outputs on one batch without
    and with a profiler running, with the profiled call's events."""
    p, = programs("3dmatch-infer")
    x = cells.upload(p.pool[0], CPU, ("points", "mask"))
    plain = p.forward(x["points"], x["mask"])
    traced, events = profiled(lambda: p.forward(x["points"], x["mask"]))
    return p, plain, traced, events


@pytest.fixture(scope="module")
def step_runs():
    """One training step from the same weights on two fresh cell objects,
    the second under a profiler: (metrics, parameters after) of each, and
    the profiled step's events."""
    runs, events = [], None
    for traced, p in zip((False, True), programs("3dmatch-train", 2)):
        batch = cells.upload(p.pool[0], CPU, p.keys)
        if traced:
            metrics, events = profiled(lambda: p.step(batch))
        else:
            metrics = p.step(batch)
        runs.append((metrics, [w.detach().clone() for w in p.params]))
    return runs, events


def test_forward_opens_its_four_stages_once_each(forward_runs):
    events = forward_runs[3]
    assert outline(events) == FORWARD
    # host operations, not user annotations: the profiler mirrors no
    # device span of them onto the card's timeline
    assert not any(e.annotation for e in events
                   if e.name.startswith(spans.PREFIX))


def test_train_step_opens_forward_loss_backward_optimizer(step_runs):
    assert outline(step_runs[1]) == TRAIN_STEP


def test_no_profiler_no_span():
    assert not torch._C._autograd._profiler_enabled()
    first, second = span("regtr.a"), span("regtr.b")
    assert first is second
    with first, second:
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = span("regtr.c")
        assert on is not first
        with on:
            pass
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("regtr.c") == 1
    assert "regtr.a" not in names and "regtr.b" not in names


def test_a_profiler_moves_no_output(forward_runs):
    _, plain, traced, _ = forward_runs
    for k in ("pose", "corr", "overlap_logits", "kp", "kp_mask",
              "feats_cond"):
        assert torch.equal(plain[k], traced[k]), k


def test_a_profiler_moves_no_update(step_runs):
    (plain, plain_params), (traced, traced_params) = step_runs[0]
    assert plain["update_skipped"] == traced["update_skipped"] == 0.0
    assert torch.equal(plain["total"], traced["total"])
    assert all(torch.equal(a, b) for a, b in zip(plain_params,
                                                 traced_params))


def ev(name, start, end, device=False, corr=0, thread=1):
    return spans.Event(name, start, end, device, corr, thread, False)


def launch(corr, t, thread=1, at=10):
    """A runtime call at host time t and its kernel at device time `at`."""
    return [ev("cudaLaunchKernel", t, t + 1, corr=corr, thread=thread),
            ev(f"kernel{corr}", at, at + 10, device=True, corr=corr,
               thread=thread)]


def step_events():
    """One hand-made training step: the cell's thread holds the spans,
    autograd's thread 2 launches kernel 2 inside regtr.backward."""
    return ([ev("regtr.train_step", 0, 1000),
             ev("regtr.forward_loss", 10, 300),
             ev("regtr.pyramid", 20, 100),
             ev("regtr.backward", 300, 700),
             ev("regtr.optimizer", 700, 950),
             ev("cudaStreamSynchronize", 720, 800),
             ev("cudaMalloc", 980, 990),
             ev("cudaMemcpy", 1100, 1110)]
            + launch(1, 50, at=60)                 # in pyramid
            + launch(2, 400, thread=2, at=410)     # autograd's thread
            + launch(3, 710, at=800)               # in optimizer
            + launch(4, 960, at=1000)              # the root's own code
            + launch(5, 1050, at=1100))            # after the step


def test_attribution_rules_on_hand_made_events():
    out = spans.attribute(step_events(), "train_step", 1)
    s = out["spans"]
    ms = 1e-6
    # innermost wins, and an outer span holds what is under it
    assert s["regtr.pyramid"]["device_ms"] == pytest.approx(10 * ms)
    assert s["regtr.forward_loss"]["device_ms"] == pytest.approx(10 * ms)
    assert s["regtr.train_step"]["device_ms"] == pytest.approx(40 * ms)
    # a kernel launched from a second thread inside regtr.backward
    assert s["regtr.backward"]["device_ms"] == pytest.approx(10 * ms)
    assert s["regtr.optimizer"]["device_ms"] == pytest.approx(10 * ms)
    assert out["outside"]["device_ms"] == pytest.approx(20 * ms)
    # gaps: [0,60) mid 30 pyramid; [70,410) mid 240 forward_loss;
    # [420,800) mid 610 backward; [810,1000) mid 905 optimizer;
    # [1010,1100) mid 1055 outside; [1110, 1110) none
    assert s["regtr.pyramid"]["idle_ms"] == pytest.approx(60 * ms)
    assert s["regtr.forward_loss"]["idle_ms"] == pytest.approx(400 * ms)
    assert s["regtr.backward"]["idle_ms"] == pytest.approx(380 * ms)
    assert s["regtr.optimizer"]["idle_ms"] == pytest.approx(190 * ms)
    assert out["outside"]["idle_ms"] == pytest.approx(90 * ms)
    assert (out["launches"], out["host_syncs"], out["cuda_mallocs"]) == (
        5, 1, 1)
    assert out["longest_gaps_ms"][:2] == [
        ["regtr.backward", pytest.approx(380 * ms)],
        ["regtr.forward_loss", pytest.approx(340 * ms)]]
    assert s["regtr.optimizer"]["host_syncs"] == 1
    assert s["regtr.backward"]["host_syncs"] == 0
    for b in out["books"].values():
        assert b["layers_and_outside"] == b["total"]


def test_the_books_close_per_batch():
    a, b = step_events(), [e._replace(start=e.start + 2000,
                                      end=e.end + 2000,
                                      correlation=e.correlation + 10)
                           for e in step_events()]
    out = spans.attribute(a + b, "train_step", 2)
    assert out["spans"]["regtr.train_step"]["count"] == 1
    assert out["launches"] == 5
    assert out["busy_ms"] == pytest.approx(50e-6)
    for k in out["books"].values():
        assert k["layers_and_outside"] == pytest.approx(k["total"],
                                                        rel=1e-12)
    assert out["idle_ms"] + out["busy_ms"] == pytest.approx(3110e-6 / 2)


def test_a_profiled_stretch_names_the_layer_spans(forward_runs):
    """`spans.stretch` over the cell object: one batch, its layer spans
    named, and the harness's own summary of the same events."""
    p = forward_runs[0]
    out = spans.stretch(p, 1e-3, CPU)
    assert out["batches"] == 1
    assert set(spans.LAYERS["forward"]) <= set(out["spans"])
    assert out["spans"]["regtr.forward"]["count"] == 1
    assert out["launches"] == 0 and out["busy_s"] == 0.0
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
