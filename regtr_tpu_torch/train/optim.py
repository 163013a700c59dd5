"""Optimizer and learning-rate schedule from the config (counterpart of
regtr_tpu/train/optim.py, which builds them from optax).

The updates are written out by hand to give optax's numbers:
  * global-norm clipping: g * (c / ||g||) only when ||g|| >= c (optax's
    `clip_by_global_norm`; `torch.nn.utils.clip_grad_norm_` divides by
    ||g|| + 1e-6 instead);
  * AdamW / Adam: optax's `scale_by_adam` (b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, bias-corrected moments), AdamW then adds
    weight_decay * param, and the step is -lr(count) * update;
  * SGD: optax's `trace` momentum (t = g + momentum * t), step -lr * t;
  * schedules 'none' (constant), 'step' (base_lr * gamma ** (count //
    step_size), optax's staircase `exponential_decay`) and 'warmup' (linear
    warm-up, then exponential decay), evaluated at the count of updates
    taken before this one.
"""
from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay ** count in fp32, as optax computes it."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


def make_schedule(cfg) -> Callable[[int], float]:
    """count of updates taken -> learning rate."""
    base_lr = float(cfg.get("base_lr", 1e-4))
    kind = cfg.get("scheduler", "none") or "none"
    params = cfg.get("scheduler_param", [])
    if kind == "none":
        return lambda count: base_lr
    if kind == "step":
        step_size, gamma = int(params[0]), float(params[1])
        return lambda count: base_lr * gamma ** (count // step_size)
    if kind == "warmup":
        warmup = int(params[0])
        gamma = (math.exp(math.log(float(params[2])) / float(params[1]))
                 if len(params) >= 3 else 1.0)

        def schedule(count):
            if count < warmup:
                return min(count / max(warmup, 1), 1.0) * base_lr
            return base_lr * gamma ** (count - warmup)

        return schedule
    raise ValueError(f"unknown scheduler {kind!r}")


class Optimizer:
    """Clip + AdamW / Adam / SGD over a fixed list of parameters.

    `count` is the number of updates taken (optax's step count); a skipped
    step leaves it, the moments and the parameters untouched.  `torn` is
    True while an update runs, and stays True when one raised: the
    parameters and moments may then be half-updated, and only a checkpoint
    can restore them.
    """

    def __init__(self, params, cfg):
        self.params: List[torch.Tensor] = list(params)
        self.name = cfg.get("optimizer", "AdamW")
        if self.name not in ("AdamW", "Adam", "SGD"):
            raise ValueError(f"unknown optimizer {self.name!r}")
        if int(cfg.get("grad_accum_steps", 1) or 1) > 1:
            raise NotImplementedError("grad_accum_steps > 1 is not ported")
        self.weight_decay = (float(cfg.get("weight_decay", 0.0))
                             if self.name == "AdamW" else 0.0)
        self.momentum = float(cfg.get("momentum", 0.9))
        self.clip = float(cfg.get("grad_clip", 0.0) or 0.0)
        self.schedule = make_schedule(cfg)
        self.count = 0
        self.torn = False
        zeros = [torch.zeros_like(p) for p in self.params]
        if self.name == "SGD":
            self.trace = zeros
        else:
            self.mu = zeros
            self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor], grad_norm: float):
        """One step from `grads` (one per parameter, fp32) whose global
        norm is `grad_norm`.  Modifies `grads`."""
        self.torn = True
        if self.clip > 0 and grad_norm >= self.clip:
            torch._foreach_div_(grads, grad_norm)
            torch._foreach_mul_(grads, self.clip)
        lr = self.schedule(self.count)
        self.count += 1
        if self.name == "SGD":
            torch._foreach_mul_(self.trace, self.momentum)
            torch._foreach_add_(self.trace, grads)
            torch._foreach_add_(self.params, self.trace, alpha=-lr)
            self.torn = False
            return
        torch._foreach_mul_(self.mu, _B1)
        torch._foreach_add_(self.mu, grads, alpha=1.0 - _B1)
        torch._foreach_mul_(self.nu, _B2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - _B2)
        mu_hat = torch._foreach_div(self.mu,
                                    _bias_correction(_B1, self.count))
        denom = torch._foreach_div(self.nu, _bias_correction(_B2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, _EPS)
        upd = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, upd, alpha=-lr)
        self.torn = False

    def _moments(self):
        if self.name == "SGD":
            return {"trace": self.trace}
        return {"mu": self.mu, "nu": self.nu}

    def state_dict(self) -> dict:
        """The update count and the moments (or SGD's trace), as tensors
        on the parameters' device: what a checkpoint needs to resume."""
        return {"name": self.name, "count": self.count, **self._moments()}

    @torch.no_grad()
    def load_state_dict(self, state: dict):
        if state["name"] != self.name:
            raise ValueError(f"optimizer state of {state['name']}, this "
                             f"optimizer is {self.name}")
        for key, mine in self._moments().items():
            theirs = state[key]
            if len(theirs) != len(mine):
                raise ValueError(f"{key}: {len(theirs)} tensors for "
                                 f"{len(mine)} parameters")
            for t, src in zip(mine, theirs):
                t.copy_(src)
        self.count = int(state["count"])
        self.torn = False
