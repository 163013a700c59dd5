"""The system under test, driven the way its users drive it: the inference
entry (`train.steps.make_forward`, the model's forward) on a batch of
pairs, or the training step (`train.steps.make_train_step` with the
configuration's optimizer).  One client, a closed loop: a batch's clock
runs from the host's numpy arrays, which are uploaded inside it, to its
result on the host (the poses, or a step's end).

These and the model families' `parameter_shapes` (families/) are the only
places the benchmark imports the program, inside the functions.
"""
from __future__ import annotations

import time

import torch

from . import manifest
from .weights import Leaves


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def upload(batch, device, keys):
    return {k: torch.from_numpy(batch[k]).to(device) for k in keys}


def build_model(cfg, n0, weights, device):
    """The program's model for n0 points a cloud, with the benchmark's
    weights."""
    from regtr_tpu_torch.models import create_model

    model = create_model(cfg, n0, device, seed=0)
    model.load_state_dict(weights)
    return model


def parameter_shapes(cfg, n0) -> Leaves:
    """{name: shape} of the model's parameters, read on the meta device
    by the configuration's model family, with its rule for drawing them."""
    family = manifest.family(cfg)
    return Leaves(family.parameter_shapes(cfg, n0), family.weight_rule)


class ForwardCell:
    """Inference: each batch's result reaches the host (the model family's
    `keep`: RegTR's poses).  Keeps, per pool batch, what `keep` keeps of
    its latest run in the window for the check."""

    entry = "forward"

    def __init__(self, cfg, pool, weights, device):
        from regtr_tpu_torch.train.steps import make_forward

        self.cfg, self.pool, self.device = cfg, pool, device
        self.family = manifest.family(cfg, (self.entry,))
        self.pairs_per_batch = pool[0]["pose"].shape[0]
        self.model = build_model(cfg, pool[0]["points"].shape[1], weights,
                                 device)
        self.forward = make_forward(self.model)
        self.kept = {}
        self.failed = 0

    def warm(self):
        for i in range(len(self.pool)):
            self.one(i)

    def one(self, i):
        """One batch through the entry; returns its pairs."""
        x = upload(self.pool[i], self.device, ("points", "mask"))
        kept = self.family.keep(self.forward(x["points"], x["mask"]))
        if self.family.failed(kept):
            self.failed += 1
        self.kept[i] = kept
        return self.pairs_per_batch

    def at_boundary(self) -> bool:
        return True

    def close(self):
        pass

    def stages(self, i):
        """One batch with the device synchronized after each stage of the
        forward, as the model family orders them: {stage: ms}."""
        x = upload(self.pool[i], self.device, ("points", "mask"))
        times = {}

        def timed(name, fn, *args):
            t = time.perf_counter()
            out = fn(*args)
            sync(self.device)
            times[name] = (time.perf_counter() - t) * 1e3
            return out

        with torch.inference_mode():
            self.family.stages(self.model, x["points"], x["mask"], timed)
        return times

    def answers(self):
        """The kept outputs on the host, by pool batch."""
        return {i: {k: v.detach().float().cpu() if v.is_floating_point()
                    else v.cpu() for k, v in kept.items()}
                for i, kept in self.kept.items()}


class TrainStepCell:
    """Training: a step ends when its update has run on the device.  Set-up
    drives the first steps through the same call and feed, and records
    what the check compares (`record`).  In the window, the state before
    every third step is copied aside, and the window ends on a third step,
    so that the check also compares its last three steps (`close`)."""

    entry = "train_step"
    first_steps = 3
    keys = ("points", "mask", "pose", "overlap0")

    def __init__(self, cfg, pool, weights, device):
        from regtr_tpu_torch.train.optim import Optimizer
        from regtr_tpu_torch.train.steps import make_train_step

        self.cfg, self.pool, self.device = cfg, pool, device
        self.family = manifest.family(cfg, (self.entry,))
        self.pairs_per_batch = pool[0]["pose"].shape[0]
        self.model = build_model(cfg, pool[0]["points"].shape[1], weights,
                                 device)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = list(self.model.parameters())
        self.optimizer = Optimizer(self.params, cfg)
        self.step = make_train_step(self.model, self.optimizer, cfg)
        self.initial = {n: w.detach().clone() for n, w in weights.items()}
        self.record = {}
        self.failed = 0
        self.last = None
        self.snap = None        # the window's copies, made at its start
        self.stretch = None     # the steps since the last copy
        self.window_steps = 0

    def warm(self):
        """The first steps, on distinct pairs: their losses, the first
        gradient as the optimizer's first moment holds it after one step
        (mu = (1 - b1) g), and each leaf's change after the last of them.
        Then the buffers that the window copies its state into."""
        losses = []
        for i in range(self.first_steps):
            self.one(i)
            losses.append(float(self.last["total"]))
            if i == 0:
                self.record["grad_norms"] = self._norms(
                    [m / (1.0 - 0.9) for m in self.optimizer.mu])
        self.record["losses"] = losses
        self.record["change_norms"] = self._norms(
            [p.detach() - self.initial[n] for n, p in zip(self.names,
                                                          self.params)])
        del self.initial
        self.one(self.first_steps % len(self.pool))
        opt = self.optimizer
        self.snap = {k: [torch.empty_like(t) for t in ts] for k, ts in (
            ("params", self.params), ("mu", opt.mu), ("nu", opt.nu),
            ("mu1", opt.mu))}

    def _norms(self, tensors):
        return {n: float(t.double().norm()) for n, t in zip(self.names,
                                                             tensors)}

    def at_boundary(self) -> bool:
        """Whether the window may end here: after a whole number of the
        three-step stretches that the check compares."""
        return self.window_steps % 3 == 0

    def one(self, i):
        first = self.snap is not None and self.window_steps % 3 == 0
        opt = self.optimizer
        if first:
            with torch.no_grad():
                for key, ts in (("params", self.params), ("mu", opt.mu),
                                ("nu", opt.nu)):
                    torch._foreach_copy_(self.snap[key], ts)
            self.stretch = {"batches": [], "losses": [],
                            "count": opt.count}
        batch = upload(self.pool[i], self.device, self.keys)
        metrics = self.step(batch)
        if first:
            with torch.no_grad():
                torch._foreach_copy_(self.snap["mu1"], opt.mu)
        sync(self.device)
        self.last = metrics
        if metrics["update_skipped"]:
            self.failed += 1
        if self.snap is not None:
            self.stretch["batches"].append(i)
            self.stretch["losses"].append(metrics["total"])
            self.window_steps += 1
        return self.pairs_per_batch

    def close(self):
        """After the window: what its last three steps did, for the check:
        their losses, the first one's gradient as the optimizer's first
        moment gives it back ((mu1 - b1 mu) / (1 - b1)), each leaf's change
        over the three, and the state they started from, on the host."""
        if not self.window_steps or not self.at_boundary():
            raise RuntimeError("the window ended inside a compared stretch")
        snap, b1 = self.snap, 0.9
        grads = [(m1 - b1 * m) / (1.0 - b1)
                 for m1, m in zip(snap["mu1"], snap["mu"])]
        self.record["window"] = {
            "batches": list(self.stretch["batches"]),
            "losses": [float(x) for x in self.stretch["losses"]],
            "grad_norms": self._norms(grads),
            "change_norms": self._norms([p.detach() - q for p, q in zip(
                self.params, snap["params"])]),
            "start": {"count": self.stretch["count"], **{
                key: {n: t.cpu() for n, t in zip(self.names, snap[key])}
                for key in ("params", "mu", "nu")}}}

    def stages(self, i):
        """One step with the device synchronized after each part: forward
        and losses, backward, the update."""
        from regtr_tpu_torch.train import steps

        batch = upload(self.pool[i], self.device, self.keys)
        times = {}
        t = time.perf_counter()
        losses, _ = steps.forward_loss(self.model, batch)
        sync(self.device)
        times["forward_loss"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        grads, norm = steps.backward(self.optimizer, losses["total"])
        sync(self.device)
        times["backward"] = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        if steps.apply(self.optimizer, grads, norm, losses["total"]):
            self.failed += 1
        sync(self.device)
        times["optimizer"] = (time.perf_counter() - t) * 1e3
        return times

    def answers(self):
        return self.record


CELLS = {c.entry: c for c in (ForwardCell, TrainStepCell)}
