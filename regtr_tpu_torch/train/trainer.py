"""The training loop (the port's counterpart of regtr_tpu/train/trainer.py).

The host loop feeds the loader's bucketed batches to the eager train step,
accumulates metrics, runs periodic validation, and checkpoints the model
and the optimizer (best by validation score).  As in the JAX package:

  * a negative `niter` counts epochs, a positive one steps;
  * a resumed run restores the step and starts its loop at epoch 0;
  * metrics reach the host every `summary_every // 4` steps, in one copy;
    the step itself syncs once, for its skip of a non-finite update;
  * a step that raises before its update is logged and skipped, up to 5 in
    a row.  A failure inside the update (the optimizer is then `torn`),
    after it (the optimizer's count or micro-step has moved: skipping
    would apply a second update for the same step), or one that leaves the
    CUDA context unusable, re-raises at once: the run resumes from its
    last checkpoint;
  * with `grad_accum_steps` k > 1 each step is a micro-step and the
    parameters move every k-th (train/optim.py), as under optax's
    MultiSteps; `dropout` > 0 raises, as the JAX trainer's step does.

Several ranks (parallel/dist.py, launched by `torch.distributed.run`):
each runs this loop on its own device over its shard of the loaders (of
equal lengths: `shard_pad`), the steps reduce over the ranks
(train/steps.py), validation averages the ranks' meters
(`_global_averages`), and rank 0 writes the checkpoints.  A step that
raises re-raises at once: the other ranks are inside its collectives, and
a skipped step would leave them waiting.  There is no progress bar; the
summaries are logged.
"""
from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..parallel import dist
from .checkpoints import CheckpointManager, resolve_ckpt_dir
from .logging_utils import MetricsWriter, StatsMeter, combine_process_sums
from .optim import Optimizer
from .steps import batch_to_device, make_eval_step, make_train_step

MAX_CONSECUTIVE_FAILURES = 5


def metrics_to_host(metrics: dict) -> dict:
    """The step's metrics as numpy arrays, the tensors in one copy from the
    device (a copy per key would sync once per key)."""
    tensors = {k: v for k, v in metrics.items() if torch.is_tensor(v)}
    out = {k: np.asarray(v) for k, v in metrics.items() if k not in tensors}
    if tensors:
        flat = torch.cat([v.detach().float().reshape(-1)
                          for v in tensors.values()]).cpu().numpy()
        i = 0
        for k, v in tensors.items():
            out[k] = flat[i:i + v.numel()].reshape(v.shape)
            i += v.numel()
    return out


def _device_usable(device: torch.device) -> bool:
    """False when a CUDA error has poisoned the context (errors there are
    sticky: every later call fails)."""
    if device.type != "cuda":
        return True
    try:
        torch.cuda.synchronize(device)
    except RuntimeError:
        return False
    return True


class Trainer:
    def __init__(self, cfg, logdir, summary_every: int = 500,
                 validate_every: int = -1, nb_sanity_val_steps: int = 2):
        # gradient clipping comes from cfg['grad_clip'] through Optimizer
        self.cfg = cfg
        self.logdir = Path(logdir)
        self.summary_every = summary_every
        self.validate_every = validate_every
        self.nb_sanity_val_steps = nb_sanity_val_steps
        self.logger = logging.getLogger("regtr_tpu_torch")
        self.logdir.mkdir(parents=True, exist_ok=True)
        self.saver = CheckpointManager(
            self.logdir / "ckpt", max_to_keep=6, keep_every_hours=3.0)
        self.optimizer: Optional[Optimizer] = None
        # train steps that raised, and non-finite steps whose update was
        # skipped, over this trainer's fits
        self.failed_steps = 0
        self.skipped_updates = 0
        # host-clock seconds: each train step (the batch's copy to the
        # device included), waiting on the train loader, validation
        self.timing = {"step_s": [], "loader_wait_s": 0.0,
                       "validation_s": 0.0}

    def restore_from(self, resume, model, optimizer=None) -> int:
        """Restore the latest checkpoint of a run directory or its ckpt/
        (this run's own, or another run's: a fresh logdir can continue a
        previous run's training) into the model and the optimizer; returns
        its step."""
        path = resolve_ckpt_dir(resume)
        saver = (self.saver if path == self.saver.directory
                 else CheckpointManager(path))
        return saver.restore(model, optimizer)

    def _waited(self, loader):
        """Iterate the loader, adding the time spent waiting for each batch
        to timing['loader_wait_s']."""
        it = iter(loader)
        try:
            while True:
                t = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    return
                finally:
                    self.timing["loader_wait_s"] += time.perf_counter() - t
                yield item
        finally:
            it.close()

    def fit(self, model, train_loader, val_loader,
            resume: Optional[str] = None, niter: int = -1) -> int:
        """Train the model in place from its current parameters (or from
        `resume`'s checkpoint); returns the last step."""
        cfg = self.cfg
        device = next(model.parameters()).device
        optimizer = self.optimizer = Optimizer(model.parameters(), cfg)
        step = 0
        if resume is not None:
            step = self.restore_from(resume, model, optimizer)
            self.logger.info("Resumed from step %d", step)
        train_step = make_train_step(model, optimizer, cfg)

        if niter < 0:
            total_steps = -niter * len(train_loader)
            self.logger.info("Training for %d epochs (%d steps)", -niter,
                             total_steps)
        else:
            total_steps = niter

        validate_every = self.validate_every
        if validate_every < 0:
            validate_every = len(train_loader)  # once per epoch

        if self.nb_sanity_val_steps > 0 and val_loader is not None:
            self._run_validation(model, val_loader,
                                 limit=self.nb_sanity_val_steps)

        writer = MetricsWriter(self.logdir, "train")
        val_writer = MetricsWriter(self.logdir, "val") \
            if val_loader is not None else None
        meters = StatsMeter()
        epoch = 0
        t_last = time.time()
        done = False
        consecutive_failures = 0
        while not done:
            train_loader.set_epoch(epoch)
            for batch, _meta in self._waited(train_loader):
                t_step = time.perf_counter()
                position = optimizer.position
                try:
                    metrics = train_step(batch_to_device(batch, device))
                except Exception:
                    self.failed_steps += 1
                    consecutive_failures += 1
                    self.logger.exception(
                        "Train step %d failed (%d consecutive)", step + 1,
                        consecutive_failures)
                    if (optimizer.torn or optimizer.position != position
                            or not _device_usable(device)
                            or dist.world_size() > 1):
                        self.logger.error(
                            "The failure hit the update, came after it, "
                            "hit the device or left the other ranks in "
                            "the step: re-raising (resume from the last "
                            "checkpoint).")
                        raise
                    if consecutive_failures >= MAX_CONSECUTIVE_FAILURES:
                        raise
                    continue
                self.timing["step_s"].append(time.perf_counter() - t_step)
                consecutive_failures = 0
                self.skipped_updates += int(metrics["update_skipped"])
                step += 1
                if step % max(self.summary_every // 4, 1) == 0:
                    host = metrics_to_host(metrics)
                    if not np.isfinite(float(host["total"])):
                        self.logger.warning(
                            "Non-finite loss at step %d; skipping metrics",
                            step)
                    else:
                        meters.update(host)
                if step % self.summary_every == 0:
                    avgs = meters.averages()
                    rate = self.summary_every / (time.time() - t_last)
                    t_last = time.time()
                    self.logger.info(
                        "step %d | loss %.4f | %.2f it/s | %s", step,
                        avgs.get("total", float("nan")), rate,
                        ", ".join(f"{k}={v:.4f}"
                                  for k, v in sorted(avgs.items())
                                  if k != "total"))
                    writer.write(step, avgs)
                    meters.reset()
                if validate_every > 0 and step % validate_every == 0 \
                        and val_loader is not None:
                    score = self._run_validation(
                        model, val_loader, writer=val_writer, step=step)
                    self.saver.save(step, model, optimizer, score=score)
                if step >= total_steps:
                    done = True
                    break
            epoch += 1
        if val_loader is not None:
            score = self._run_validation(model, val_loader,
                                         writer=val_writer, step=step)
            self.saver.save(step, model, optimizer, score=score)
        if val_writer is not None:
            val_writer.close()
        writer.close()
        return step

    def _run_validation(self, model, val_loader, limit=None, writer=None,
                        step=0) -> float:
        """Validation averages (logged, and written with the per-pair
        error histograms when `writer` is given); returns the score,
        reg_success_final."""
        t0 = time.perf_counter()
        device = next(model.parameters()).device
        eval_step = make_eval_step(model, self.cfg)
        meters = StatsMeter()
        per_pair = {}
        for i, (batch, _meta) in enumerate(val_loader):
            if limit is not None and i >= limit:
                break
            metrics = metrics_to_host(eval_step(batch_to_device(batch,
                                                                device)))
            for k in [k for k in metrics if k.startswith("hist/")]:
                per_pair.setdefault(k, []).append(metrics.pop(k))
            meters.update(metrics)
        avgs = self._global_averages(meters)
        score = avgs.get("reg_success_final", 0.0)
        self.logger.info(
            "validation | score %.4f | %s", score,
            ", ".join(f"{k}={v:.4f}" for k, v in sorted(avgs.items())))
        if writer is not None:
            writer.write(step, avgs)
            for k, chunks in per_pair.items():
                writer.write_histogram(step, k, np.concatenate(chunks))
        self.timing["validation_s"] += time.perf_counter() - t0
        return score

    @staticmethod
    def _global_averages(meters: StatsMeter) -> dict:
        """The meters' averages, over every rank's meters with several
        (each rank validates its shard; regtr_tpu/train/trainer.py
        `_global_averages`)."""
        if dist.world_size() == 1:
            return meters.averages()
        keys = sorted(meters.meters)
        gathered = dist.allgather(torch.from_numpy(
            meters.sums_counts(keys))).numpy()
        return dict(zip(keys, combine_process_sums(gathered).tolist()))

    def test(self, model, test_loader, test_step_fn):
        """test_step_fn(model, batch, meta) over the test loader, the batch
        on the model's device; -> the list of its results."""
        device = next(model.parameters()).device
        return [test_step_fn(model, batch_to_device(batch, device), meta)
                for batch, meta in test_loader]
