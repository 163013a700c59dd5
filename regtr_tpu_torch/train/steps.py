"""Train and eval steps (counterpart of regtr_tpu/train/steps.py).

`make_forward` is the no-gradient forward of the test protocol.  One
training step is forward + losses, backward, and the clipped
optimizer update, in that order: `forward_loss`, `backward` and `apply`,
which `make_train_step` chains and a caller may also time one by one; each
opens a profiler span (`regtr.train_step` over `regtr.forward_loss`,
`regtr.backward` and `regtr.optimizer`, utils/profiling.py `span`).  It
is one eager program: the JAX package's split into three jitted programs
works around an XLA schedule and has no counterpart here.

batch: {'points' (2B, N, 3), 'mask' (2B, N), 'pose' (B, 3, 4),
        'overlap0' (2B, N)} tensors on the model's device, pairs
interleaved (`batch_to_device` makes it from the loader's numpy batch).

With several ranks (parallel/dist.py) a rank's batch is its share of the
global batch, and the steps compute what the JAX package's mesh step
computes on the global batch: each rank's losses are its share of the
global losses (compute_loss divides by the global denominators), the
gradients are summed over the ranks in one flat fp32 buffer before the
norm, the skip and the update (so every rank takes the same decision and
keeps the same parameters), and the losses and the registration metrics
are the global batch's.  A flat buffer rather than DDP: the step takes its
gradients with `torch.autograd.grad`, which DDP's hooks do not see, and
one buffer in parameter order sums in a fixed order.  With one process
every reduction is the identity.
"""
from __future__ import annotations

from typing import Dict, List

import torch

from ..core.se3 import se3_compare
from ..parallel import dist
from ..utils.profiling import span
from .optim import Optimizer

BATCH_KEYS = ("points", "mask", "pose", "overlap0")


def batch_to_device(batch, device) -> Dict[str, torch.Tensor]:
    """The collated numpy batch's model inputs as tensors on `device`."""
    return {k: torch.from_numpy(batch[k]).to(device) for k in BATCH_KEYS}


def registration_metrics(pose_pred, pose_gt, cfg, per_pair: bool = False
                         ) -> Dict[str, torch.Tensor]:
    """Rotation / translation errors per decoder layer and the success rate
    at the validation thresholds; with per_pair, also the last layer's
    per-pair errors under 'hist/...' keys.  Means and errors over the
    global batch with several ranks (every rank's batch of one size)."""
    err = se3_compare(pose_pred, pose_gt[None])           # over (L, B)
    success = ((err["rot_deg"] < float(cfg.get("reg_success_thresh_rot",
                                                10.0)))
               & (err["trans"] < float(cfg.get("reg_success_thresh_trans",
                                               0.1)))).float()
    if dist.world_size() > 1:
        return _global_registration_metrics(err, success, per_pair)
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


def _global_registration_metrics(err, success, per_pair):
    """`registration_metrics` over the ranks' batches: the sums over each
    rank's pairs in one collective, over the global count."""
    per = torch.stack([err["rot_deg"], err["trans"], success])  # (3, L, B)
    count = per.new_tensor([float(per.shape[-1])])
    sums = dist.all_reduce_sum(torch.cat([per.sum(dim=-1).reshape(-1),
                                          count]))
    means = (sums[:-1] / sums[-1]).reshape(per.shape[:2])
    out = {"rot_err_deg": means[0], "trans_err": means[1],
           "reg_success": means[2], "reg_success_final": means[2, -1]}
    if per_pair:
        hist = dist.allgather(per[:2, -1])                  # (world, 2, B)
        out["hist/rot_err_deg"] = hist[:, 0].reshape(-1)
        out["hist/trans_err"] = hist[:, 1].reshape(-1)
    return out


def global_losses(losses: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
    """The global batch's losses, detached: the sums over the ranks of
    their shares, in one collective.  `losses` itself with one process."""
    if dist.world_size() == 1:
        return losses
    keys = list(losses)
    sums = dist.all_reduce_sum(torch.stack([losses[k].detach().float()
                                            for k in keys]))
    return dict(zip(keys, sums.unbind()))


def forward_loss(model, batch, deterministic: bool = False):
    """-> (losses incl. 'total', outputs), recorded for the backward.  Not
    deterministic by default, as the JAX step calls compute_loss: with
    `dropout` > 0 that raises, for want of a dropout generator."""
    with span("regtr.forward_loss"):
        return model.compute_loss(batch["points"], batch["mask"],
                                  batch["pose"], batch["overlap0"],
                                  deterministic=deterministic)


def backward(optimizer: Optimizer, total: torch.Tensor):
    """Gradients of `total` for every parameter (zeros where it does not
    depend on one), summed over the ranks, and their global norm as a 0-dim
    fp32 tensor."""
    with span("regtr.backward"):
        grads = torch.autograd.grad(total, optimizer.params,
                                    allow_unused=True)
        grads = dist.all_reduce_sum_flat(
            [torch.zeros_like(p) if g is None else g
             for p, g in zip(optimizer.params, grads)])
        grad_norm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        return grads, grad_norm


def apply(optimizer: Optimizer, grads: List[torch.Tensor],
          grad_norm: torch.Tensor, total: torch.Tensor) -> bool:
    """The clipped update, unless the loss or a gradient is non-finite: then
    the parameters, the optimizer's moments and its step count stay as they
    were.  Returns whether the update was skipped (one host sync).  With
    several ranks `total` is the global loss (`global_losses`) and the
    gradients are the reduced ones, so every rank decides alike."""
    with span("regtr.optimizer"):
        skip = not bool(torch.isfinite(total) & torch.isfinite(grad_norm))
        if not skip:
            optimizer.update(grads, float(grad_norm))
        return skip


def make_train_step(model, optimizer: Optimizer, cfg):
    """-> step(batch) -> metrics: the losses, the registration metrics,
    'grad_norm' (before clipping) and 'update_skipped' (0. or 1.).

    With `grad_accum_steps` > 1 a step is a micro-step (train/optim.py).
    `dropout` > 0 raises: the JAX training step calls compute_loss with no
    dropout rng, which flax refuses, so neither package trains with
    dropout (compute_loss with a generator does run it)."""
    if float(cfg.get("dropout", 0.0)) > 0.0:
        raise ValueError("dropout > 0: the training step passes no dropout "
                         "generator to compute_loss (the JAX package's step "
                         "passes no dropout rng and raises likewise)")

    def step(batch):
        with span("regtr.train_step"):
            losses, out = forward_loss(model, batch)
            grads, grad_norm = backward(optimizer, losses["total"])
            losses = global_losses(losses)
            skipped = apply(optimizer, grads, grad_norm, losses["total"])
            metrics = {k: v.detach() for k, v in losses.items()}
            metrics.update(registration_metrics(out["pose"], batch["pose"],
                                                cfg))
            metrics["grad_norm"] = grad_norm
            metrics["update_skipped"] = float(skipped)
            return metrics

    return step


def make_eval_step(model, cfg):
    """-> step(batch) -> metrics: the losses and the registration metrics,
    with the last layer's per-pair errors (the global batch's, in rank
    order, with several ranks)."""

    @torch.no_grad()
    def step(batch):
        losses, out = forward_loss(model, batch, deterministic=True)
        metrics = dict(global_losses(losses))
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
