"""Readings that the check's limits are set from, for one cell on this
machine's card, many seeds in one process:

    python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3
        [--control] [--faults half_batch,answer_altered]

For each seed: the program's gaps to the reference (portbench/check.py)
after the set-up that a run makes (every pool batch through the timed
entry; training: the first three steps, then a one-second window of the
cell's steps, whose last three are compared too), the control's gaps
(the reference in TF32 against the reference in fp32, the window's
stretch from the program's state) and each fault's gaps
(portbench/faults.py).  One JSON line a seed on stdout; the lower reading
of a number is the largest the program gives, the upper the smallest the
control or a fault gives.  The benchmark's runs do not run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import cells, check, faults, manifest
from . import weights as weights_mod
from .traffic.generator import make_pool


CALIBRATION_WINDOW_S = 1.0    # training: steps after set-up, ending on a
                              # stretch the check compares


def program_answers(entry, cfg, pool, w, device, fault=None):
    """The program's answers after the set-up that a run makes and, for
    training, a short window of the cell's own steps."""
    from .run import window

    program = cells.CELLS[entry](cfg, pool, w, device)
    if fault is not None:
        program = faults.plant(fault, program)
    program.warm()
    if entry == "train_step":
        window(program, len(pool), CALIBRATION_WINDOW_S,
               (program.first_steps + 1) % len(pool))
        program.close()
    got = program.answers()
    del program
    torch.cuda.empty_cache()
    return got


def program_gaps(entry, cfg, pool, w, device, fault=None, detail=None):
    """The program's gaps to the reference, which follows the program's
    window (training); `detail` (a dict) also gets check.train_detail and
    the gaps' reference."""
    got = program_answers(entry, cfg, pool, w, device, fault)
    ref = check.reference_answers(entry, cfg, pool, w, device, got=got)
    if detail is not None:
        detail["ref"] = ref
        detail["got"] = got
    return check.gaps(cfg, entry, got, ref)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--faults", default="")
    opt = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = manifest.load_benchmark()
    w_entry = manifest.workload(bench, opt.workload)
    cfg = manifest.load_config(w_entry["config"])["config"]
    from .traffic.generator import load_mix

    mix = load_mix(w_entry["traffic"])
    entry = mix["entry"]
    for seed in (int(s) for s in opt.seeds.split(",")):
        t0 = time.perf_counter()
        pool = make_pool(mix, cfg, seed)
        n0 = pool[0]["points"].shape[1]
        w = weights_mod.draw(cells.parameter_shapes(cfg, n0), seed, device)
        held = {}
        line = {"seed": seed, "program": program_gaps(entry, cfg, pool, w,
                                                      device, detail=held)}
        ref, got = held["ref"], held["got"]
        if entry == "train_step":
            line["detail"] = check.train_detail(got, ref)
            line["window_detail"] = check.train_detail(got["window"],
                                                       ref["window"])
        if opt.control:
            control = check.reference_answers(entry, cfg, pool, w, device,
                                              tf32=True, got=got)
            line["control"] = check.gaps(cfg, entry, control, ref)
            if entry == "train_step":
                line["control_detail"] = check.train_detail(control, ref)
        for fault in filter(None, opt.faults.split(",")):
            line[fault] = program_gaps(entry, cfg, pool, w, device, fault)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del ref, got, held, w, pool
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
