"""The port's trainer on the CPU: `Trainer.fit` against the JAX package's on
the same data and initial parameters, the checkpoints (bitwise round trip,
retention, best record), resume from another run's directory, the
per-step resilience, and `python -m regtr_tpu_torch.train`.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from regtr_tpu.data import get_dataloader as jax_get_dataloader
from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.presets import tiny_config as jax_tiny_config
from regtr_tpu.train import trainer as jax_trainer
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.data import get_dataloader
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.train import __main__ as train_cli
from regtr_tpu_torch.train import checkpoints, optim, steps, trainer
from regtr_tpu_torch.train.checkpoints import CheckpointManager
from regtr_tpu_torch.train.optim import Optimizer
from tests.test_torch_eval import yaml_text
from tests.test_torch_model import flat_params, jax_init

ROOT = Path(__file__).resolve().parent.parent
N0 = 256
# The synthetic crop pipeline at 256 points per cloud (180 after the
# crop), 8 train items in batches of 2, one val batch.  K 64 is more than
# any neighborhood holds here, so the neighbor tables have no tie at the
# K-th slot that XLA and PyTorch could break differently.
DATA = dict(dataset="synthetic", root="", synthetic_items=8,
            synthetic_val_items=2, train_batch_size=2, val_batch_size=2,
            num_points=N0, buckets=[N0], neighborhood_limits=[64, 64],
            num_encoder_layers=1, overlap_loss_on=[0], feature_loss_on=[0],
            corr_loss_on=[0])
FIT = dict(summary_every=2, validate_every=2, nb_sanity_val_steps=1)
# fp32 on both sides, summed in other orders: measured 1.0e-7 relative
# apart on the losses, 6.4e-5 relative L2 on the 4 updates (final minus
# initial parameters; the junit report carries both).  One of the 4
# updates skipped would move the updates by about a quarter of their size.
LOSS_RTOL = 1e-5
UPDATE_TOL = 1e-3


@pytest.fixture
def no_tensorflow(monkeypatch):
    """Hide TensorFlow, which TensorBoard imports when it is installed (tens
    of seconds); the metrics writers then use TensorBoard's own stub."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)


def record_totals(monkeypatch, module, totals, jax_side):
    """Wrap module.make_train_step so that each step's total loss lands in
    `totals`."""
    real = module.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(*a):
            out = step(*a)
            totals.append(float((out[1] if jax_side else out)["total"]))
            return out

        return recorded

    monkeypatch.setattr(module, "make_train_step", make)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers' fits: niter 4, validation every 2 steps, summaries
    every 2, from JAX's initial parameters (its attention through the
    Pallas kernel in interpret mode)."""
    out = tmp_path_factory.mktemp("fit")
    jcfg = jax_tiny_config(attention_impl="pallas_interpret", **DATA)
    cfg = tiny_config(**DATA)
    totals = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        record_totals(mp, jax_trainer, totals["jax"], True)
        record_totals(mp, trainer, totals["port"], False)
        jmodel = jax_create_model(jcfg, N0)
        jtrainer = jax_trainer.Trainer(jcfg, out / "jax", **FIT)
        state, jstep = jtrainer.fit(
            jmodel, jax_get_dataloader(jcfg, "train", num_workers=0),
            jax_get_dataloader(jcfg, "val", num_workers=0), niter=4)
        model = create_model(cfg, N0, "cpu")
        init = state_dict_from_jax(flat_params(jax_init(jmodel, 0)), model)
        model.load_state_dict(init)
        port = trainer.Trainer(cfg, out / "port", **FIT)
        step = port.fit(model, get_dataloader(cfg, "train", num_workers=2),
                        get_dataloader(cfg, "val", num_workers=2), niter=4)
    return dict(out=out, cfg=cfg, totals=totals, steps=(jstep, step),
                params=flat_params(state.params), init=init, model=model,
                trainer=port, jcfg=jcfg, jtrainer=jtrainer,
                jparams=state.params)


def test_fit_matches_jax(runs, record_property):
    assert runs["steps"] == (4, 4)
    jt, pt = np.array(runs["totals"]["jax"]), np.array(runs["totals"]["port"])
    assert len(jt) == len(pt) == 4 and np.isfinite(pt).all()
    np.testing.assert_allclose(pt, jt, rtol=LOSS_RTOL)
    # the 4 updates: the port's (final - initial) against JAX's
    model, init = runs["model"], runs["init"]
    ref = state_dict_from_jax(runs["params"], model)
    num = sum(float((p.detach() - ref[n]).norm()) ** 2
              for n, p in model.named_parameters())
    den = sum(float((ref[n] - init[n]).norm()) ** 2
              for n, _ in model.named_parameters())
    assert den > 0 and (num / den) ** 0.5 <= UPDATE_TOL
    # the measured distances, in the junit report
    record_property("loss_max_rel", float(np.max(np.abs(pt - jt) / jt)))
    record_property("update_rel_l2", (num / den) ** 0.5)
    port = runs["trainer"]
    assert (port.failed_steps, port.skipped_updates) == (0, 0)
    assert len(port.timing["step_s"]) == 4
    assert port.optimizer.count == 4


def test_fit_writes_what_jax_writes(runs):
    """The same metrics records (steps and keys, histograms included) and
    the same best checkpoint."""
    def records(side, name):
        lines = (runs["out"] / side / f"metrics_{name}.jsonl").read_text()
        return [(r["step"], r.get("tag"), sorted(r))
                for r in map(json.loads, lines.splitlines())]

    for name in ("train", "val"):
        assert records("port", name) == records("jax", name)
    assert [s for s, tag, _ in records("port", "val") if tag is None] == [
        2, 4, 4]
    best = [json.loads((runs["out"] / side / "ckpt" / "best.json")
                       .read_text()) for side in ("jax", "port")]
    assert best[0]["step"] == best[1]["step"]
    assert best[1]["score"] == pytest.approx(best[0]["score"])
    assert CheckpointManager(runs["out"] / "port" / "ckpt").all_steps() == [
        2, 4]


def test_test_loop_matches_jax(runs):
    """Trainer.test hands the test step every batch of the loader, in
    order, with its meta, as JAX's Trainer.test does; the batch lies on the
    model's device."""
    def jax_step(params, batch, meta):
        assert params is runs["jparams"]
        return np.asarray(batch["points"]), meta

    def port_step(model, batch, meta):
        assert model is runs["model"]
        assert batch["points"].device == next(model.parameters()).device
        return batch["points"].numpy(), meta

    want = runs["jtrainer"].test(
        None, jax_get_dataloader(runs["jcfg"], "val", num_workers=0),
        runs["jparams"], jax_step)
    got = runs["trainer"].test(
        runs["model"], get_dataloader(runs["cfg"], "val", num_workers=0),
        port_step)
    assert len(got) == len(want) > 0
    for (points, meta), (jpoints, jmeta) in zip(got, want):
        np.testing.assert_array_equal(points, jpoints)
        assert repr(meta) == repr(jmeta)


def test_process_sums_combine_as_jax():
    """StatsMeter.sums_counts and combine_process_sums, the cross-process
    reduction of validation averages, equal the JAX package's."""
    from regtr_tpu.train import logging_utils as jax_logging
    from regtr_tpu_torch.train import logging_utils

    rng = np.random.RandomState(0)
    keys = ["a", "b", "c"]
    gathered = {"jax": [], "port": []}
    for _process in range(3):
        updates = [{k: rng.randn() for k in keys} for _ in range(4)]
        updates[1]["b"] = np.nan          # skipped by both meters
        updates[2]["c"] = rng.randn(6)    # a per-layer vector: its last
        for side, module in (("jax", jax_logging), ("port", logging_utils)):
            meter = module.StatsMeter()
            for u in updates:
                meter.update(u)
            gathered[side].append(meter.sums_counts(keys))
    np.testing.assert_array_equal(gathered["port"], gathered["jax"])
    np.testing.assert_array_equal(
        logging_utils.combine_process_sums(gathered["port"]),
        jax_logging.combine_process_sums(gathered["jax"]))


def test_resume_continues_from_the_checkpoint(runs, tmp_path):
    """A fresh run resumed from the finished run's directory starts at its
    step, with its parameters and optimizer state, and ends at niter."""
    cfg = runs["cfg"]
    model = create_model(cfg, N0, "cpu", seed=9)
    again = trainer.Trainer(cfg, tmp_path / "resumed", summary_every=2,
                            validate_every=-1, nb_sanity_val_steps=0)
    step = again.fit(model, get_dataloader(cfg, "train", num_workers=0),
                     None, resume=str(runs["out"] / "port"), niter=6)
    assert step == 6 and again.optimizer.count == 6
    assert again.failed_steps == 0


def fill_optimizer(model, cfg, seed):
    """An optimizer with two updates of seeded random gradients."""
    gen = torch.Generator().manual_seed(seed)
    opt = Optimizer(model.parameters(), cfg)
    for _ in range(2):
        grads = [torch.randn(p.shape, generator=gen) for p in opt.params]
        opt.update(grads, float(torch.stack([g.norm() for g in grads]).norm()))
    return opt


@pytest.mark.parametrize("name", ["AdamW", "SGD"])
def test_checkpoint_round_trip_is_bitwise(tmp_path, name):
    cfg = tiny_config(optimizer=name)
    model = create_model(cfg, 96, "cpu", seed=1)
    opt = fill_optimizer(model, cfg, 0)
    saver = CheckpointManager(tmp_path / "ckpt")
    assert saver.save(5, model, opt, score=0.25)
    other = create_model(cfg, 96, "cpu", seed=2)
    other_opt = Optimizer(other.parameters(), cfg)
    assert CheckpointManager(tmp_path / "ckpt").restore(other, other_opt) == 5
    for (n, a), b in zip(model.state_dict().items(),
                         other.state_dict().values()):
        assert torch.equal(a, b), n
    assert other_opt.count == opt.count == 2
    for key, mine in opt.state_dict().items():
        if isinstance(mine, list):
            assert all(torch.equal(a, b) for a, b in
                       zip(mine, other_opt.state_dict()[key])), key
    with pytest.raises(ValueError, match="optimizer state of"):
        Optimizer(model.parameters(), dict(
            cfg, optimizer="Adam" if name == "SGD" else "SGD")
        ).load_state_dict(opt.state_dict())


def test_checkpoint_retention_and_best(tmp_path):
    cfg = tiny_config()
    model = create_model(cfg, 96, "cpu")
    saver = CheckpointManager(tmp_path / "ckpt", max_to_keep=3,
                              keep_every_hours=None)
    scores = {1: 0.2, 2: 0.9, 3: 0.1, 4: 0.3, 5: 0.4, 6: 0.5}
    for step, score in scores.items():
        assert saver.save(step, model, score=score)
    assert saver.all_steps() == [4, 5, 6]
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "4", "5", "6", "best.json"]
    # best.json keeps step 2, whose checkpoint is gone: best falls back to
    # the latest, as the JAX manager does
    assert saver.best_record() == {"step": 2, "score": 0.9}
    assert saver.restore(model, best=True) == 6
    # a step at or before the latest is not written; best.json still moves
    assert not saver.save(6, model, score=0.95)
    assert saver.best_record() == {"step": 6, "score": 0.95}
    assert CheckpointManager(tmp_path / "ckpt").latest_step() == 6
    assert saver.restore(model, best=True) == 6
    assert saver.restore(model, step=4) == 4
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore(model)


def test_checkpoint_keep_every_hours_with_a_fake_clock(tmp_path,
                                                       monkeypatch):
    """Saves an hour apart, every_hours 3, max_to_keep 2: the first
    checkpoint stays, then one at least 3 hours after the last one kept,
    and the last two."""
    clock = iter(3600.0 * np.arange(9))
    monkeypatch.setattr(checkpoints, "_now", lambda: next(clock))
    model = create_model(tiny_config(), 96, "cpu")
    saver = CheckpointManager(tmp_path, max_to_keep=2, keep_every_hours=3)
    for step in range(1, 10):
        saver.save(step, model)
    assert saver.all_steps() == [1, 4, 7, 8, 9]
    assert CheckpointManager(tmp_path).all_steps() == [1, 4, 7, 8, 9]


def test_restore_from_a_foreign_run_dir(tmp_path):
    cfg = tiny_config()
    saved = create_model(cfg, 96, "cpu", seed=3)
    CheckpointManager(tmp_path / "old_run" / "ckpt").save(7, saved)
    new = trainer.Trainer(cfg, tmp_path / "new_run")
    for resume in (tmp_path / "old_run", tmp_path / "old_run" / "ckpt"):
        model = create_model(cfg, 96, "cpu", seed=4)
        assert new.restore_from(resume, model) == 7
        assert all(torch.equal(a, b) for a, b in zip(
            model.state_dict().values(), saved.state_dict().values()))
    # this run's own directory goes through its own manager
    new.saver.save(2, saved)
    assert new.restore_from(new.logdir, model) == 2


def small_fit(monkeypatch, tmp_path, fails, niter=2):
    """Fit with the train step raising on the calls where `fails` is true."""
    cfg = tiny_config(**DATA)
    real = trainer.make_train_step
    calls = iter(fails)

    def make(*args):
        step = real(*args)

        def failing(batch):
            if next(calls, False):
                raise RuntimeError("injected loader fault")
            return step(batch)

        return failing

    monkeypatch.setattr(trainer, "make_train_step", make)
    t = trainer.Trainer(cfg, tmp_path, summary_every=2, validate_every=-1,
                        nb_sanity_val_steps=0)
    t.last_step = t.fit(create_model(cfg, N0, "cpu"),
                        get_dataloader(cfg, "train", num_workers=0), None,
                        niter=niter)
    return t


def test_four_failures_in_a_row_are_survived(monkeypatch, tmp_path,
                                             no_tensorflow):
    t = small_fit(monkeypatch, tmp_path, [True] * 4)
    assert (t.failed_steps, t.last_step, t.optimizer.count) == (4, 2, 2)


def test_the_fifth_failure_in_a_row_raises(monkeypatch, tmp_path,
                                           no_tensorflow):
    with pytest.raises(RuntimeError, match="injected"):
        small_fit(monkeypatch, tmp_path, [True] * 5)
    with pytest.raises(RuntimeError, match="injected"):
        small_fit(monkeypatch, tmp_path, [False] + [True] * 5, niter=3)


def test_a_failure_inside_the_update_raises_at_once(monkeypatch, tmp_path,
                                                    no_tensorflow):
    """The schedule raises at the second update: the optimizer is torn and
    the trainer re-raises without retrying."""
    real = optim.make_schedule

    def make(cfg):
        schedule = real(cfg)

        def broken(count):
            if count == 1:
                raise RuntimeError("injected update fault")
            return schedule(count)

        return broken

    monkeypatch.setattr(optim, "make_schedule", make)
    t = trainer.Trainer(tiny_config(**DATA), tmp_path, summary_every=2,
                        nb_sanity_val_steps=0)
    cfg = t.cfg
    with pytest.raises(RuntimeError, match="injected update"):
        t.fit(create_model(cfg, N0, "cpu"),
              get_dataloader(cfg, "train", num_workers=0), None, niter=4)
    assert t.failed_steps == 1 and t.optimizer.torn


def test_a_failure_after_the_update_raises_at_once(monkeypatch, tmp_path,
                                                   no_tensorflow):
    """The second step raises in its metrics, after its update: the count
    has moved, so the trainer re-raises rather than apply a second update
    for the same step."""
    real = steps.registration_metrics
    calls = []

    def failing(*args, **kwargs):
        calls.append(None)
        if len(calls) == 2:
            raise RuntimeError("injected metrics fault")
        return real(*args, **kwargs)

    monkeypatch.setattr(steps, "registration_metrics", failing)
    t = trainer.Trainer(tiny_config(**DATA), tmp_path, summary_every=2,
                        nb_sanity_val_steps=0)
    cfg = t.cfg
    with pytest.raises(RuntimeError, match="injected metrics"):
        t.fit(create_model(cfg, N0, "cpu"),
              get_dataloader(cfg, "train", num_workers=0), None, niter=4)
    assert t.failed_steps == 1 and t.optimizer.count == 2
    assert not t.optimizer.torn


def run_cli(args, cwd):
    """python -m regtr_tpu_torch.train in a subprocess, TensorFlow hidden
    (see no_tensorflow)."""
    code = ("import runpy, sys; sys.modules['tensorflow'] = None; "
            "runpy.run_module('regtr_tpu_torch.train', run_name='__main__', "
            "alter_sys=True)")
    proc = subprocess.run(
        [sys.executable, "-c", code, *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def test_cli_trains_resumes_and_validates(tmp_path):
    """Train 2 steps; resume from the run with a config of niter 4 (the
    run's directory given); validate its checkpoint and exit (the config
    found next to ckpt/)."""
    cfg = {k: v for k, v in tiny_config(**DATA, niter=2).items()
           if k != "config_path"}
    (tmp_path / "mini.yaml").write_text(yaml_text(cfg))
    (tmp_path / "mini4.yaml").write_text(yaml_text(dict(cfg, niter=4)))
    common = ["--device", "cpu", "--num_workers", "2", "--summary_every",
              "2", "--nb_sanity_val_steps", "1"]
    run_cli(["--config", "mini.yaml", "--logdir", "first", *common],
            tmp_path)
    (run,) = (tmp_path / "first").iterdir()
    assert (run / "config.yaml").read_text() == (tmp_path / "mini.yaml"
                                                 ).read_text()
    assert CheckpointManager(run / "ckpt").all_steps() == [2]
    assert (run / "ckpt" / "best.json").exists()
    train = [json.loads(line) for line in
             (run / "metrics_train.jsonl").read_text().splitlines()]
    assert [r["step"] for r in train] == [2]
    assert np.isfinite(train[0]["total"])

    run_cli(["--config", "mini4.yaml", "--resume", str(run), "--logdir",
             "second", *common], tmp_path)
    (run2,) = (tmp_path / "second").iterdir()
    assert "Resumed from step 2" in (run2 / "log.txt").read_text()
    assert CheckpointManager(run2 / "ckpt").all_steps() == [4]

    run_cli(["--resume", str(run2 / "ckpt"), "--validate_every", "0",
             "--logdir", "third", *common], tmp_path)
    (run3,) = (tmp_path / "third").iterdir()
    log = (run3 / "log.txt").read_text()
    assert "Loaded checkpoint at step 4" in log and "validation |" in log
    assert not (run3 / "ckpt").exists()


def test_cli_refuses_cuda_without_a_card(tmp_path):
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.main(["--config",
                            str(ROOT / "conf" / "synthetic.yaml"),
                            "--logdir", str(tmp_path)])
    assert not (tmp_path / "ckpt").exists()
