"""Whether the timed path's results are right: the plain reference
(reference/, float32, TF32 off) computes the same batches again from the
same points and weights, and each number below is compared with its
limit (portbench/limits/<workload>.json).

Inference, over every pool batch, against the outputs of that batch's
latest run in the window: the numbers of the configuration's model family
(families/<family>.py `forward_gaps`; RegTR's: kp_gap, corr_gap,
overlap_gap, pose_gap).
Training, over the first three steps that set-up drove through the
window's call (the reference runs them from the same weights and batches),
and again, as window_loss_gap, window_grad_gap and window_update_gap, over
the window's last three steps (the reference runs them from the state the
program had reached before them: the parameters and AdamW's moments and
count, which the set-up's three check from their start):
  loss_gap     the first step's |loss - ref| / |ref| (the later steps'
               losses drift apart with the parameters, by round-off that
               Adam's normalisation spreads: update_gap covers them)
  grad_gap     the first step's gradient as the optimizer holds it: the
               worst leaf's |norm - ref norm| / max(ref norm, the median
               leaf's ref norm)
  update_gap   each leaf's change after the three steps, the same measure,
               the median over the leaves whose reference gradient is at
               least a thousandth of the median leaf's (below that, a leaf
               moves under Adam by round-off alone).  The median, not the
               worst: the changes carry the later steps' drift (the loss
               gap grows some hundredfold from step 1 to step 3), and the
               worst leaf, an early backbone layer, swings with it from
               seed to seed.  From the start the first updates are near
               lr * sign(g) for every element, so round-off moves them;
               the window's stretch, with the moments grown, reads some
               tenfold steadier

The control, which has to fail these limits, is the same reference in
TF32 (`tf32=True`), the next precision below the configuration's float32.
"""
from __future__ import annotations

import statistics

import torch

from . import manifest
from .reference import optim as ref_optim

SMALL_GRAD = 1e-3


def set_tf32(on: bool):
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


def reference(cfg, n0, weights, device):
    model = manifest.family(cfg).Reference(cfg, n0).to(device)
    model.load_state_dict(weights)
    return model


def forward_answers(cfg, pool, weights, device, tf32=False):
    """The reference's outputs for each pool batch, in the form the
    program's ForwardCell keeps them."""
    family = manifest.family(cfg, ("forward",))
    set_tf32(tf32)
    try:
        model = reference(cfg, pool[0]["points"].shape[1], weights, device)
        out = {}
        with torch.no_grad():
            for i, batch in enumerate(pool):
                out[i] = family.reference_forward(
                    model, torch.from_numpy(batch["points"]).to(device),
                    torch.from_numpy(batch["mask"]).to(device))
        return out
    finally:
        set_tf32(False)


def _follow(family, model, opt, batches, device) -> dict:
    """The reference's steps on `batches` from its present state: each
    step's loss, the first step's gradient leaf norms as the optimizer
    holds them (after clipping: (mu1 - b1 mu) / (1 - b1)), their shares
    within 10x Adam's eps, and each leaf's change over the steps."""
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    record = {"losses": []}
    for s, batch in enumerate(batches):
        b = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        losses = family.reference_losses(model, b)
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        mu = [m.clone() for m in opt.mu] if s == 0 else None
        opt.step(grads)
        record["losses"].append(float(losses["total"].detach()))
        if s == 0:
            g1 = [(m1 - ref_optim.B1 * m) / (1.0 - ref_optim.B1)
                  for m1, m in zip(opt.mu, mu)]
            record["grad_norms"] = {n: float(g.double().norm())
                                    for n, g in zip(names, g1)}
            record["near_eps"] = {
                n: float((g.abs() < 10 * ref_optim.EPS).float().mean())
                for n, g in zip(names, g1)}
            del mu, g1
        del losses, grads
    record["change_norms"] = {n: float((p.detach() - q).double().norm())
                              for n, p, q in zip(names, params, start)}
    return record


def train_record(cfg, pool, weights, device, steps=3, tf32=False,
                 window=None):
    """The reference's first `steps` steps from the same weights on the
    same batches; with `window` (the program's record of the window's
    last three steps) also those steps, from the state they started at."""
    set_tf32(tf32)
    try:
        family = manifest.family(cfg, ("train_step",))
        n0 = pool[0]["points"].shape[1]
        model = reference(cfg, n0, weights, device)
        opt = ref_optim.AdamW([p for _, p in model.named_parameters()], cfg)
        record = _follow(family, model, opt, pool[:steps], device)
        if window is not None:
            del model, opt
            model = reference(cfg, n0, weights, device)
            start = window["start"]
            names = [n for n, _ in model.named_parameters()]
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(start["params"][n])
            opt = ref_optim.AdamW([p for _, p in model.named_parameters()],
                                  cfg)
            opt.mu = [start["mu"][n].to(device, copy=True) for n in names]
            opt.nu = [start["nu"][n].to(device, copy=True) for n in names]
            opt.count = int(start["count"])
            record["window"] = _follow(
                family, model, opt, [pool[i] for i in window["batches"]],
                device)
        return record
    finally:
        set_tf32(False)


def _leaf_gaps(got: dict, ref: dict, leaves) -> list:
    """Each leaf's |norm - ref norm| / max(ref norm, the median leaf's ref
    norm)."""
    floor = statistics.median(ref[n] for n in leaves)
    gaps = []
    for n in leaves:
        gap = abs(got.get(n, float("nan")) - ref[n]) / max(ref[n], floor,
                                                             1e-30)
        gaps.append(gap if gap == gap else float("inf"))
    return gaps


def _train_gaps(got: dict, ref: dict, prefix: str = "") -> dict:
    first = abs(got["losses"][0] - ref["losses"][0]) / max(
        abs(ref["losses"][0]), 1e-30)
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= SMALL_GRAD * median]
    return {prefix + "loss_gap": first if first == first else float("inf"),
            prefix + "grad_gap": max(_leaf_gaps(got["grad_norms"], grads,
                                                list(grads))),
            prefix + "update_gap": statistics.median(_leaf_gaps(
                got["change_norms"], ref["change_norms"], moved))}


def train_gaps(got: dict, ref: dict) -> dict:
    """The set-up's first three steps, and (window_*) the window's last
    three, each by the same three numbers."""
    out = _train_gaps(got, ref)
    if "window" in ref:
        if "window" not in got:
            return dict(out, **{"window_" + k: float("inf") for k in out})
        out.update(_train_gaps(got["window"], ref["window"], "window_"))
    return out


def train_detail(got: dict, ref: dict, top: int = 3) -> dict:
    """What lies behind the training gaps: each step's relative loss gap,
    and the leaves with the widest gradient and change gaps."""
    grads = ref["grad_norms"]
    median = statistics.median(grads.values())
    moved = [n for n, g in grads.items() if g >= SMALL_GRAD * median]

    def widest(key, leaves):
        floor = statistics.median(ref[key][n] for n in leaves)
        rows = [(abs(got[key][n] - ref[key][n]) / max(ref[key][n], floor),
                 n, ref[key][n], ref.get("near_eps", {}).get(n))
                for n in leaves]
        return sorted(rows, reverse=True)[:top]

    return {"step_loss_gaps": [abs(a - b) / abs(b) for a, b in zip(
                got["losses"], ref["losses"])],
            "grad_leaves": widest("grad_norms", list(grads)),
            "change_leaves": widest("change_norms", moved),
            "update_worst_leaf": max(_leaf_gaps(
                got["change_norms"], ref["change_norms"], moved)),
            "median_grad": median,
            "median_near_eps": statistics.median(
                ref.get("near_eps", {n: 0.0 for n in moved})[n]
                for n in moved),
            "left_out": sorted(set(grads) - set(moved))}


def reference_answers(entry, cfg, pool, weights, device, tf32=False,
                      got=None):
    """The reference's answers; for training, `got` (the program's
    record) names the window's stretch and the state it started from."""
    if entry == "forward":
        return forward_answers(cfg, pool, weights, device, tf32)
    return train_record(cfg, pool, weights, device, tf32=tf32,
                        window=(got or {}).get("window"))


def gaps(cfg, entry, got, ref) -> dict:
    if entry == "forward":
        return manifest.family(cfg, (entry,)).forward_gaps(got, ref)
    return train_gaps(got, ref)
