"""Model families: portbench/families/<family>.py holds what of the harness
differs between model architectures, and the harness finds it by the
module part of the configuration's `model` key (manifest.family:
`regtr.RegTR` gives regtr.py).  A family module defines the names in
HOOKS["every"], and those of each entry ('forward', 'train_step') that a
cell of its configuration runs; each value below says what the name is.
It may define FAULTS, {name: fault(cell) -> cell}, faults of its own that
faults.plant finds by name.
"""

HOOKS = {
    "every": {
        "Reference": "the plain reference model, Reference(cfg, n0), "
                     "whose state_dict names are the program's",
        "parameter_shapes": "(cfg, n0) -> {name: shape} of the program's "
                            "model, read on the meta device",
        "weight_rule": "(name, shape) -> (stream, finish): how "
                       "weights.draw makes the leaf",
        "pool_counts": "(cfg, pool, device) -> the work of each pool "
                       "batch (counts.py's kinds: flops, bytes, exps) for "
                       "the rooflines and `mfu`",
    },
    "forward": {
        "keep": "(out) -> what the forward cell keeps of one program "
                "forward, the result its clock waits for brought to the "
                "host",
        "failed": "(kept) -> whether those outputs count the batch failed",
        "reference_forward": "(model, points, mask) -> the reference's "
                             "forward in keep's form, on the host",
        "forward_gaps": "(got, ref) -> {check: value} over the pool "
                        "batches, keyed as in portbench/limits/<cell>.json",
        "stages": "(model, points, mask, timed) -> None: the program's "
                  "forward stage by stage, each through timed(stage, fn, "
                  "*args)",
        "answer_altered": "(cell) -> cell: faults.answer_altered on the "
                          "forward",
        "half_batch": "(cell) -> cell: faults.half_batch on the forward",
    },
    "train_step": {
        "reference_losses": "(model, batch) -> the reference's training "
                            "losses ('total' and each term) on a batch of "
                            "tensors",
    },
}
