"""The traced run's readings: a profiled stretch of the window (no
synchronizing spans; `torch.profiler` with CUPTI) gives every device
operation's interval and every host operation's, from which come the
device's busy time (the union of the device intervals), the time by
device operation, the longest idle gaps with the host operation that
spanned each, and the time of the kernels a metric names.  Only these
summaries are kept; no trace file is written."""
from __future__ import annotations

import time

import torch


def union_length(intervals) -> float:
    """Total length covered by (start, end) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def idle_gaps(intervals, lo, hi):
    """The gaps in [lo, hi] that no interval covers, as (start, end)."""
    gaps, end = [], lo
    for a, b in sorted(intervals):
        if a > end:
            gaps.append((end, min(a, hi)))
        end = max(end, b)
    if end < hi:
        gaps.append((end, hi))
    return [(a, b) for a, b in gaps if b > a]


def profile(run_once, seconds: float, device, until=lambda: True):
    """Run `run_once()` under the profiler until `seconds` have passed and
    `until()` holds -> (runs, host seconds, device events, host events),
    events as (name, start_s, end_s)."""
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
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9)
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(item)
        else:
            host.append(item)
    return runs, host_s, dev, host


# the profiler's own host events, which name no work of the run
PROFILER_EVENTS = ("Activity Buffer Request",)


def summarize(dev, host) -> dict:
    """busy_s, window_s, per-operation device seconds and the ten longest
    idle gaps."""
    spans = [(a, b) for _, a, b in dev] + [(a, b) for _, a, b in host]
    if not spans:
        return {"busy_s": 0.0, "window_s": 0.0, "ops": {}, "gaps": []}
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    ops = {}
    for name, a, b in dev:
        ops[name] = ops.get(name, 0.0) + (b - a)
    longest = sorted(idle_gaps([(a, b) for _, a, b in dev], lo, hi),
                     key=lambda g: g[0] - g[1])[:10]
    gaps = []
    for a, b in longest:
        mid = 0.5 * (a + b)
        around = [(e - s, n) for n, s, e in host
                  if s <= mid <= e and n not in PROFILER_EVENTS]
        gaps.append((min(around)[1] if around else "(no host op)", b - a))
    return {"busy_s": union_length([(a, b) for _, a, b in dev]),
            "window_s": hi - lo, "ops": ops, "gaps": gaps}


def breakdown(summary) -> dict:
    """The ten device operations with the most time and the ten longest
    idle gaps, each gap named by the innermost host operation around it."""
    ops = sorted(summary["ops"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[n[:120], s] for n, s in summary["gaps"]]}


def kernel_seconds(summary, patterns) -> float:
    """Device seconds of the operations whose names hold any pattern."""
    return sum(s for n, s in summary["ops"].items()
               if any(p in n for p in patterns))
