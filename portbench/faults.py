"""Faults planted underneath the timed path, each of which the check has
to catch: the broken-path tests (portbench/tests) and the calibration of
the limits (portbench/calibrate.py) plant them (`plant`) in the program's
cell object (portbench/cells.py) before its first batch.

    answer_altered  a result altered where it is produced: on the forward
                    as the model family does it (families/<family>.py;
                    RegTR's poses' translations moved by 1 cm), in
                    training the loss scaled by 1.01
    half_batch      half of the batch's pairs left out: the forward runs
                    the first half and repeats its outputs (the family's
                    half_batch); the training step takes the mean over the
                    first half only
    state_unchanged the training step leaves the parameters and moments
                    as they were
and a family's own, in its FAULTS (RegTR's neighbor_dropped).
"""
from __future__ import annotations


def answer_altered(cell):
    if cell.entry == "forward":
        return cell.family.answer_altered(cell)
    model = cell.model
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
        return cell.family.half_batch(cell)
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


FAULTS = {f.__name__: f for f in (answer_altered, half_batch,
                                   state_unchanged)}


def plant(name, cell):
    """`cell` with the fault `name`, of FAULTS or of its model family's."""
    fault = FAULTS.get(name) or getattr(cell.family, "FAULTS", {})[name]
    return fault(cell)
