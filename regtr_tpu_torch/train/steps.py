"""Train and eval steps (counterpart of regtr_tpu/train/steps.py).

`make_forward` is the no-gradient forward of the test protocol.  One
training step is forward + losses, backward, and the clipped
optimizer update, in that order: `forward_loss`, `backward` and `apply`,
which `make_train_step` chains and a caller may also time one by one.  It
is one eager program: the JAX package's split into three jitted programs
works around an XLA schedule and has no counterpart here.

batch: {'points' (2B, N, 3), 'mask' (2B, N), 'pose' (B, 3, 4),
        'overlap0' (2B, N)} tensors on the model's device, pairs
interleaved (`batch_to_device` makes it from the loader's numpy batch).
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.se3 import se3_compare
from .optim import Optimizer

BATCH_KEYS = ("points", "mask", "pose", "overlap0")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The collated numpy batch's model inputs as tensors on `device`."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def registration_metrics(pose_pred, pose_gt, cfg, per_pair: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Rotation / translation errors per decoder layer and the success rate
    at the validation thresholds; with per_pair, also the last layer's
    per-pair errors under 'hist/...' keys."""
    err = se3_compare(pose_pred, pose_gt[None])           # over (L, B)
    success = ((err["rot_deg"] < float(cfg.get("reg_success_thresh_rot",
                                                10.0)))
               & (err["trans"] < float(cfg.get("reg_success_thresh_trans",
                                               0.1)))).float()
    out = {
        "rot_err_deg": err["rot_deg"].mean(dim=-1),        # (L,)
        "trans_err": err["trans"].mean(dim=-1),            # (L,)
        "reg_success": success.mean(dim=-1),               # (L,)
        "reg_success_final": success[-1].mean(),
    }
    if per_pair:
        out["hist/rot_err_deg"] = err["rot_deg"][-1]       # (B,)
        out["hist/trans_err"] = err["trans"][-1]           # (B,)
    return out


def forward_loss(model, batch):
    """-> (losses incl. 'total', outputs), recorded for the backward."""
    return model.compute_loss(batch["points"], batch["mask"], batch["pose"],
                              batch["overlap0"])


def backward(optimizer: Optimizer, total: torch.Tensor):
    """Gradients of `total` for every parameter (zeros where it does not
    depend on one), and their global norm as a 0-dim fp32 tensor."""
    grads = torch.autograd.grad(total, optimizer.params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(optimizer.params, grads)]
    grad_norm = torch.linalg.vector_norm(
        torch.stack(torch._foreach_norm(grads)))
    return grads, grad_norm


def apply(optimizer: Optimizer, grads: List[torch.Tensor],
          grad_norm: torch.Tensor, total: torch.Tensor) -> bool:
    """The clipped update, unless the loss or a gradient is non-finite: then
    the parameters, the optimizer's moments and its step count stay as they
    were.  Returns whether the update was skipped (one host sync)."""
    skip = not bool(torch.isfinite(total) & torch.isfinite(grad_norm))
    if not skip:
        optimizer.update(grads, float(grad_norm))
    return skip


def make_train_step(model, optimizer: Optimizer, cfg):
    """-> step(batch) -> metrics: the losses, the registration metrics,
    'grad_norm' (before clipping) and 'update_skipped' (0. or 1.)."""

    def step(batch):
        losses, out = forward_loss(model, batch)
        grads, grad_norm = backward(optimizer, losses["total"])
        skipped = apply(optimizer, grads, grad_norm, losses["total"])
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics.update(registration_metrics(out["pose"], batch["pose"], cfg))
        metrics["grad_norm"] = grad_norm
        metrics["update_skipped"] = float(skipped)
        return metrics

    return step


def make_eval_step(model, cfg):
    """-> step(batch) -> metrics: the losses and the registration metrics,
    with the last layer's per-pair errors."""

    @torch.no_grad()
    def step(batch):
        losses, out = forward_loss(model, batch)
        metrics = dict(losses)
        metrics.update(registration_metrics(out["pose"], batch["pose"], cfg,
                                            per_pair=True))
        return metrics

    return step


def make_forward(model):
    """-> forward(points, mask) -> the model's outputs, with no gradient
    recorded (the inference path; run_test calls it)."""

    def forward(points, mask):
        with torch.inference_mode():
            return model(points, mask)

    return forward
