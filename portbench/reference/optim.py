"""The plain reference's update: the configuration's solver (AdamW with
b1 0.9, b2 0.999, eps 1e-8 outside the square root, bias-corrected moments,
decoupled weight decay), after clipping the gradients' global norm to
`grad_clip` where it is at least that, at the 'step' schedule's rate."""
from __future__ import annotations

import torch

B1, B2, EPS = 0.9, 0.999, 1e-8


class AdamW:
    def __init__(self, params, cfg):
        if cfg.get("optimizer", "AdamW") != "AdamW":
            raise ValueError("the reference runs AdamW only")
        self.params = list(params)
        self.lr = float(cfg["base_lr"])
        self.wd = float(cfg.get("weight_decay", 0.0))
        self.clip = float(cfg.get("grad_clip", 0.0) or 0.0)
        kind = cfg.get("scheduler", "none") or "none"
        self.step_size, self.gamma = ((int(cfg["scheduler_param"][0]),
                                       float(cfg["scheduler_param"][1]))
                                      if kind == "step" else (None, 1.0))
        if kind not in ("none", "step"):
            raise ValueError(f"the reference has no schedule {kind!r}")
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads):
        """One update from `grads`; returns their global norm before
        clipping."""
        norm = float(torch.linalg.vector_norm(
            torch.stack([g.norm() for g in grads])))
        scale = self.clip / norm if self.clip > 0 and norm >= self.clip \
            else 1.0
        lr = self.lr * (self.gamma ** (self.count // self.step_size)
                        if self.step_size else 1.0)
        self.count += 1
        c1 = 1.0 - B1 ** self.count
        c2 = 1.0 - B2 ** self.count
        for p, g, m, v in zip(self.params, grads, self.mu, self.nu):
            g = g * scale
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            upd = (m / c1) / ((v / c2).sqrt() + EPS) + self.wd * p
            p.add_(upd, alpha=-lr)
        return norm
