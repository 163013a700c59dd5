"""What the per-layer metrics (portbench/metrics/<name>.py) read from a
traced run.  `trace` holds:
    stages   {stage: [ms, ...]}: the stage part, synchronized after each
    summary  trace.summarize of the profiled part: busy_s, window_s,
             device seconds by operation
    runs     the pool batch of each run in the profiled part
    counts   the work of each pool batch (the family's pool_counts)
    peaks    counts.peaks of the configuration's dtype
Each reader returns None where the run has nothing for it to read: the
harness then leaves the metric out.
"""
from __future__ import annotations

import statistics

from .counts import bound_s
from .trace import kernel_seconds

# The kernels' names as the program's CUDA sources give them.
K1 = ("flash_fwd_",)
K23 = ("flash_bwd_kernel",)
K6 = ("search_kernel", "pack_kernel")


def stage_ms(trace, name):
    times = trace.get("stages", {}).get(name, [])
    return statistics.median(times) if times else None


def _work(trace, key):
    """The summed work of `key` over the profiled runs."""
    total = {}
    for i in trace["runs"]:
        for k, v in trace["counts"][i][key].items():
            total[k] = total.get(k, 0.0) + v
    return total


def roofline(trace, key, patterns):
    """The kernels' least time on these inputs over their device time, in
    percent."""
    seconds = kernel_seconds(trace["summary"], patterns)
    if seconds <= 0.0 or not trace["runs"]:
        return None
    return 100.0 * bound_s(_work(trace, key), trace["peaks"]) / seconds


def mfu(trace, key):
    """The runs' operations over the profiled window at the dtype's peak,
    in percent."""
    window = trace["summary"]["window_s"]
    if window <= 0.0 or not trace["runs"]:
        return None
    return 100.0 * _work(trace, key)["flops"] / (
        window * trace["peaks"]["flops"])


def idle(trace):
    s = trace["summary"]
    if s["window_s"] <= 0.0 or s["busy_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
