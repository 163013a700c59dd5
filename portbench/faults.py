"""Faults planted underneath the timed path, each of which the check has
to catch: the broken-path tests (portbench/tests) and the calibration of
the limits (portbench/calibrate.py) apply them to the program's cell
object (portbench/cells.py) before its first batch.

    answer_altered  a result altered where it is produced: the poses'
                    translations moved by 1 cm (inference), or the loss
                    scaled by 1.01 (training)
    half_batch      half of the batch's pairs left out: the forward runs
                    the first half and repeats its outputs; the training
                    step takes the mean over the first half only
    state_unchanged the training step leaves the parameters and moments
                    as they were
    neighbor_dropped the neighbour search leaves out a support it should
                    keep: every neighbour list of the pyramid loses its
                    farthest entry (a list of one keeps it), as a search
                    with a K one short or a coarser selection key would
"""
from __future__ import annotations

import dataclasses

import torch


def answer_altered(cell):
    model = cell.model
    if cell.entry == "forward":
        head_and_pose = model.head_and_pose

        def altered(*args):
            corr, logits, pose = head_and_pose(*args)
            return corr, logits, pose + torch.tensor(
                [0.0, 0.0, 0.0, 0.01], device=pose.device)

        model.head_and_pose = altered
    else:
        compute_loss = model.compute_loss

        def altered(*args, **kwargs):
            losses, out = compute_loss(*args, **kwargs)
            losses["total"] = losses["total"] * 1.01
            return losses, out

        model.compute_loss = altered
    return cell


def half_batch(cell):
    if cell.pairs_per_batch < 2:
        raise ValueError("a batch of one pair has no half to leave out")
    if cell.entry == "forward":
        forward = cell.forward

        def halved(points, mask):
            half = points.shape[0] // 4 * 2
            out = forward(points[:half], mask[:half])
            rep = {"pose": 1, "kp": 0, "kp_mask": 0, "corr": 1,
                   "overlap_logits": 1}
            return {k: torch.cat([out[k], out[k]], dim=d)
                    for k, d in rep.items()}

        cell.forward = halved
    else:
        step = cell.step

        def halved(batch):
            half = batch["pose"].shape[0] // 2
            return step({"points": batch["points"][:2 * half],
                         "mask": batch["mask"][:2 * half],
                         "pose": batch["pose"][:half],
                         "overlap0": batch["overlap0"][:2 * half]})

        cell.step = halved
    return cell


def state_unchanged(cell):
    if cell.entry == "forward":
        raise ValueError("the forward keeps no state")
    cell.optimizer.update = lambda grads, grad_norm: None
    return cell


def neighbor_dropped(cell):
    model = cell.model
    preprocess = model.preprocess

    def dropped(points, mask):
        levels = preprocess(points, mask)
        out = []
        for level in levels:
            nbr = level.neighbors
            shadow = level.points.shape[1]
            count = (nbr < shadow).sum(-1, keepdim=True)
            last = (torch.arange(nbr.shape[-1], device=nbr.device)
                    == count - 1) & (count > 1)
            out.append(dataclasses.replace(
                level, neighbors=torch.where(last, shadow, nbr)))
        return out

    model.preprocess = dropped
    return cell


FAULTS = {f.__name__: f for f in (answer_altered, half_batch,
                                   state_unchanged, neighbor_dropped)}
