"""A profiled stretch put down to the program's spans.

The program opens a host span at each of its layer boundaries, on the
profiler's own clock (regtr_tpu_torch/utils/profiling.py `span`):
`regtr.forward` over `regtr.pyramid`, `regtr.backbone`,
`regtr.transformer` and `regtr.head_pose`; `regtr.train_step` over
`regtr.forward_loss` (the four, then `regtr.losses`), `regtr.backward` and
`regtr.optimizer`.  Over a profiled stretch, per batch (or step):

- a device operation (kernel, copy or fill) belongs to the innermost span
  whose interval holds the start of the runtime call that launched it (the
  two share a correlation id), on any thread: autograd's worker thread
  launches the backward's kernels while the cell's thread sits in
  `regtr.backward`;
- a span's device ms is the union of the intervals of the operations that
  belong to it or to a span under it;
- an idle gap (`trace.idle_gaps` over the window that `device_idle` reads)
  belongs to the innermost span open on the cell's thread at its
  midpoint: the host work the device waited for;
- device and idle time in none of the cell's layer spans is `outside`:
  the upload, the read-back, the loop and the root span's own code.

Device ms over the layer spans and outside sum to the busy time, idle ms
to the window's idle time.  The ten longest gaps are listed whole, each
with the innermost span it fell in.  Counts: host syncs (blocking runtime calls,
in all inside the root span and by span), launches (device operations)
and `cudaMalloc` calls.

    python3 -m portbench.spans --workload <cell> --seed <n> --seconds <s>

runs the cell's set-up as `portbench.run` does, then a profiled stretch of
its closed loop on the card, and prints one JSON line of these readings.
With no card it prints nothing and exits non-zero.
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
import time
from typing import NamedTuple

import torch

from . import trace

PREFIX = "regtr."
ROOT = {"forward": "regtr.forward", "train_step": "regtr.train_step"}
LAYERS = {"forward": ("regtr.pyramid", "regtr.backbone",
                      "regtr.transformer", "regtr.head_pose"),
          "train_step": ("regtr.forward_loss", "regtr.backward",
                         "regtr.optimizer")}
# runtime calls that block the host until the device has caught up
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize", "cudaMemcpy")


class Event(NamedTuple):
    """One profiler event, times in ns on the profiler's clock."""
    name: str
    start: int
    end: int
    device: bool          # an operation on the card
    correlation: int      # a device operation's = its runtime call's
    thread: int
    annotation: bool      # a user annotation (record_function)


def record(e) -> Event:
    """The fields attribution needs of one of the profiler's events."""
    return Event(e.name(), e.start_ns(), e.end_ns(),
                 e.device_type() == torch.autograd.DeviceType.CUDA,
                 e.correlation_id(), e.start_thread_id(),
                 e.is_user_annotation())


def is_runtime_call(e: Event) -> bool:
    """A call of the CUDA API on the host (cudaLaunchKernel,
    cuLaunchKernel, cudaMemcpyAsync, ...): the events whose correlation
    ids are the device operations'.  The host's operators number their
    own correlation ids apart, so the name tells the two kinds apart."""
    return not e.device and e.name.startswith("cu")


class Spans:
    """The program's spans on one thread, nested by their intervals."""

    def __init__(self, events):
        self.spans = sorted(events, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.spans]
        self.parent, stack = [], []
        for i, e in enumerate(self.spans):
            while stack and self.spans[stack[-1]].end <= e.start:
                stack.pop()
            self.parent.append(stack[-1] if stack else None)
            stack.append(i)
        self.chains = [self._chain(i) for i in range(len(self.spans))]

    def _chain(self, i):
        names = []
        while i is not None:
            names.append(self.spans[i].name)
            i = self.parent[i]
        return tuple(names)

    def at(self, t) -> tuple:
        """The names of the spans open at time t, innermost first."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i].end < t:
            i = self.parent[i]
            if i is None:
                return ()
        return self.chains[i] if i >= 0 else ()


def attribute(events, entry: str, runs: int) -> dict:
    """Device ms and idle ms per batch of every span of the cell's entry
    ('forward' or 'train_step'), of `outside` and in all, and the counts
    per batch (module docstring)."""
    layers = set(LAYERS[entry])
    root = ROOT[entry]
    dev = [e for e in events if e.device and not e.annotation]
    host = [e for e in events if not e.device]
    thread = next((e.thread for e in host if e.name == root), None)
    spans = Spans([e for e in host if e.name.startswith(PREFIX)
                   and e.thread == thread])
    launched = {e.correlation: e.start for e in host if is_runtime_call(e)}

    owned, idle = {}, {}
    outside, outside_idle, unlaunched = [], 0, 0
    for op in dev:
        t = launched.get(op.correlation)
        unlaunched += t is None
        names = () if t is None else spans.at(t)
        for n in names:
            owned.setdefault(n, []).append((op.start, op.end))
        if layers.isdisjoint(names):
            outside.append((op.start, op.end))
    syncs = {}
    for e in host:
        if e.name in SYNCS:
            for n in spans.at(e.start):
                syncs[n] = syncs.get(n, 0) + 1
    ends = [(e.start, e.end) for e in events]
    lo = min((a for a, _ in ends), default=0)
    hi = max((b for _, b in ends), default=0)
    gaps = trace.idle_gaps([(e.start, e.end) for e in dev], lo, hi)
    longest = []
    for a, b in gaps:
        names = spans.at(0.5 * (a + b))
        for n in names:
            idle[n] = idle.get(n, 0) + (b - a)
        if layers.isdisjoint(names):
            outside_idle += b - a
        longest.append((b - a, names[0] if names else "outside"))

    runs = max(runs, 1)
    per = 1e-6 / runs                # ns in all -> ms per batch
    names = dict.fromkeys(e.name for e in spans.spans)   # as they open
    out = {"spans": {n: {
        "device_ms": trace.union_length(owned.get(n, [])) * per,
        "idle_ms": idle.get(n, 0) * per,
        "host_syncs": syncs.get(n, 0) / runs,
        "count": sum(e.name == n for e in spans.spans) / runs}
        for n in names},
        "outside": {"device_ms": trace.union_length(outside) * per,
                    "idle_ms": outside_idle * per},
        "busy_ms": trace.union_length([(e.start, e.end) for e in dev]) * per,
        "idle_ms": sum(b - a for a, b in gaps) * per,
        "launches": len(dev) / runs,
        "unlaunched": unlaunched / runs,
        "host_syncs": syncs.get(root, 0) / runs,
        "cuda_mallocs": sum(e.name == "cudaMalloc" for e in host) / runs,
        "longest_gaps_ms": [[n, g * 1e-6] for g, n in sorted(
            longest, reverse=True)[:10]]}
    layer_spans = [out["spans"].get(n, {"device_ms": 0.0, "idle_ms": 0.0})
                   for n in LAYERS[entry]]
    out["books"] = {
        key: {"layers_and_outside": sum(s[key] for s in layer_spans)
              + out["outside"][key], "total": out[total]}
        for key, total in (("device_ms", "busy_ms"), ("idle_ms", "idle_ms"))}
    return out


def profile(run_once, seconds: float, device, until=lambda: True):
    """`trace.profile`'s stretch, keeping each event's attribution fields
    -> (runs, host seconds, events)."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    runs = []
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or not until():
            runs.append(run_once())
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        host_s = time.perf_counter() - t0
    return runs, host_s, [record(e) for e in
                          prof.profiler.kineto_results.events()]


def measure(cell, seed: int, seconds: float, device) -> dict:
    """The cell's set-up as `run.run_cell` makes it, then `stretch`."""
    from . import cells
    from . import weights as weights_mod
    from .traffic.generator import make_pool

    cfg, mix = cell.config["config"], cell.mix
    pool = make_pool(mix, cfg, seed)
    w = weights_mod.draw(cells.parameter_shapes(
        cfg, pool[0]["points"].shape[1]), seed, device)
    program = cells.CELLS[mix["entry"]](cfg, pool, w, device)
    program.warm()
    cells.sync(device)
    return stretch(program, seconds, device)


def stretch(program, seconds: float, device) -> dict:
    """A profiled stretch of about `seconds` of the closed loop of
    `program` (a `cells.CELLS` object), put down to the program's spans;
    beside it the summary that `trace.summarize` reads from the same
    events, and the batches per second of the stretch."""
    n = len(program.pool)
    at = [(program.first_steps + 1) % n if program.entry == "train_step"
          else 0]

    def once():
        i = at[0] % n
        program.one(i)
        at[0] += 1
        return i

    runs, host_s, events = profile(once, seconds, device,
                                   until=program.at_boundary)
    summary = trace.summarize(
        *[[(e.name, e.start * 1e-9, e.end * 1e-9) for e in events
           if e.device == on] for on in (True, False)])
    out = attribute(events, program.entry, len(runs))
    out.update(batches=len(runs), batches_per_s=len(runs) / host_s,
               busy_s=summary["busy_s"], window_s=summary["window_s"],
               device_idle=100.0 * (1.0 - summary["busy_s"] / max(
                   summary["window_s"], 1e-30)),
               breakdown=trace.breakdown(summary))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=4.0)
    opt = p.parse_args(argv)

    from . import manifest, run

    bench = manifest.load_benchmark()
    manifest.workload(bench, opt.workload)
    if not torch.cuda.is_available():
        run.log(f"{opt.workload}: no CUDA device: no result")
        return 2
    device = torch.device("cuda", 0)
    for line in run.card_lines(device):
        run.log(line)
    out = measure(run.Cell.load(bench, opt.workload), opt.seed,
                  opt.seconds, device)
    for key, b in out["books"].items():
        run.log(f"books {key}: layers + outside {b['layers_and_outside']!r}"
                f", total {b['total']!r} per batch")
    run.log(f"outside device ms {out['outside']['device_ms']!r} per batch")
    print(json.dumps({"workload": opt.workload, "seed": opt.seed,
                      "device": torch.cuda.get_device_name(device), **out}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
