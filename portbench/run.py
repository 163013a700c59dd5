"""Run one cell of the port's benchmark once, on this machine's card.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

A cell of BENCHMARK.json names a configuration (portbench/configs/), whose
`model` names its model family (portbench/families/), a traffic mix
(portbench/traffic/mixes/) and its limits (portbench/limits/).
Set-up makes the pool of batches and the weights from --seed, builds the
program's model, and warms every shape the pool uses (training: the first
three steps, which the check compares); then the window runs the closed
loop for --seconds (training: on to the end of the three-step stretch
that the check also compares).  With --trace 0 the result carries the cell's
end-to-end metrics; with --trace 1 the window is a profiled stretch and a
stage-by-stage stretch, and the result carries its per-layer metrics.
Either way the program's state is then freed and the plain reference
(portbench/reference/) checks the results (portbench/check.py).

The last line of stdout is one JSON object: correct, attempted, failed,
metrics, device (and with --trace 1 breakdown), then checks, each number
compared beside its limit, which are also the last lines of stderr.
Exits non-zero with no result where there is no card, too few cards, or
where jax, jaxlib, flax or the JAX package is loaded after the window.
"""
import time


def _process_age() -> float:
    """Seconds since this process started (0 where /proc has no record)."""
    try:
        with open("/proc/self/stat") as f:
            start = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / __import__("os").sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "regtr_tpu")
TRACE_PROFILED_S = 4.0     # the profiled stretch of a traced window
TRACE_STAGES_S = 3.0       # the stage-by-stage stretch


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (so regtr_tpu_torch is not regtr_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names}
                  & set(FORBIDDEN))


def percentile(values, q):
    """The q-th percentile, linear between order statistics (numpy's
    default)."""
    xs = sorted(values)
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def card_lines(device) -> list:
    """The card, its power limit and clocks, and the host's load, as
    nvidia-smi and the kernel report them."""
    import torch

    lines = [f"host: load average {os.getloadavg()}, {os.cpu_count()} "
             f"cores; torch {torch.__version__}"]
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader",
             f"--id={device.index or 0}"], capture_output=True, text=True,
            timeout=60)
        lines.append(f"card: {smi.stdout.strip() or smi.stderr.strip()} "
                     "(name, power limit, SM clock, max SM clock, "
                     "temperature)")
    return lines


class Cell:
    """What one run needs of a cell, from BENCHMARK.json's files."""

    def __init__(self, name, config, mix, limits):
        self.name, self.config, self.mix, self.limits = (name, config, mix,
                                                         limits)

    @classmethod
    def load(cls, bench, name):
        from . import manifest
        from .traffic.generator import load_mix

        w = manifest.workload(bench, name)
        return cls(name, manifest.load_config(w["config"]),
                   load_mix(w["traffic"]), manifest.load_limits(name))


def window(cell_obj, n_batches, seconds, start):
    """The closed loop for `seconds`, and on to the end of the stretch of
    steps that the check compares: each batch's latency (s) with its pool
    batch, the pairs, and the window's length (s)."""
    latencies, pairs, i = [], 0, start
    cpu_start = time.process_time()
    t_start = time.perf_counter()
    t_end = t_start
    while t_end - t_start < seconds or not cell_obj.at_boundary():
        t = time.perf_counter()
        pairs += cell_obj.one(i % n_batches)
        t_end = time.perf_counter()
        latencies.append((t_end - t, i % n_batches))
        i += 1
    log(f"the process's CPU time in the window: "
        f"{time.process_time() - cpu_start:.3f} s")
    return latencies, pairs, t_end - t_start


def traced_window(cell_obj, pool, seconds, start, device):
    """The profiled stretch, then the stage-by-stage stretch -> (trace
    fields, batches run)."""
    from . import trace as tr

    n = len(pool)
    at = [start]

    def once():
        i = at[0] % n
        cell_obj.one(i)
        at[0] += 1
        return i

    runs, _, dev, host = tr.profile(once, min(seconds, TRACE_PROFILED_S),
                                    device, until=cell_obj.at_boundary)
    cell_obj.close()
    summary = tr.summarize(dev, host)
    stages = {}
    t0 = time.perf_counter()
    count = 0
    while count < 3 or time.perf_counter() - t0 < TRACE_STAGES_S:
        for k, v in cell_obj.stages(at[0] % n).items():
            stages.setdefault(k, []).append(v)
        at[0] += 1
        count += 1
    return {"summary": summary, "stages": stages, "runs": runs}, \
        len(runs) + count


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device,
             bench=None, wrap=None) -> dict:
    """One run of `cell` on `device` -> the result's fields.  `wrap`, for
    tests, may replace the program's cell object before the window."""
    import torch

    from . import cells, check
    from . import weights as weights_mod
    from .traffic.generator import make_pool

    cfg, mix = cell.config["config"], cell.mix
    entry = mix["entry"]
    pool = make_pool(mix, cfg, seed)
    n0 = pool[0]["points"].shape[1]
    w = weights_mod.draw(cells.parameter_shapes(cfg, n0), seed, device)
    log(f"{cell.name}: {len(pool)} batches of {mix['pairs_per_batch']} "
        f"pairs at bucket {n0}, clouds of "
        f"{sorted({int(x) for b in pool for x in b['mask'].sum(1)})} points")
    program = cells.CELLS[entry](cfg, pool, w, device)
    if wrap is not None:
        program = wrap(program)
    program.warm()
    cells.sync(device)
    setup_peak = (torch.cuda.max_memory_allocated(device)
                  if device.type == "cuda" else 0)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - T0
    start = (program.first_steps + 1) % len(pool) if entry == "train_step" \
        else 0
    log(f"set-up {setup_s:.3f} s (process start to the window)")

    result = {"metrics": {}}
    if trace:
        tfields, attempted = traced_window(program, pool, seconds, start,
                                           device)
    else:
        latencies, pairs, span = window(program, len(pool), seconds,
                                        start)
        program.close()
        attempted = len(latencies)
        ms = sorted(x * 1e3 for x, _ in latencies)
        log(f"window {span:.3f} s, {attempted} batches, {pairs} pairs; "
            f"batch latency median {statistics.median(ms):.3f} ms, p95 "
            f"{percentile(ms, 95):.3f} ms, max {ms[-1]:.3f} ms")
        slow = sorted(latencies, reverse=True)[:max(1, attempted // 20)]
        log("the slowest 5 %: " + ", ".join(
            f"{x * 1e3:.1f} ms (batch {i})" for x, i in slow[:12]))
    window_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    failed = program.failed
    answers = program.answers()
    shared = {"setup_s": setup_s}
    if not trace:
        rate = "infer_pairs_per_s" if entry == "forward" else \
            "train_pairs_per_s"
        shared.update({rate: pairs / span,
                       "infer_p95_ms": percentile(ms, 95),
                       "peak_mem_gib": window_peak / 2 ** 30})
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()

    got = check.gaps(cfg, entry, answers, check.reference_answers(
        entry, cfg, pool, w, device, got=answers))
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in got.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and \
        failed == 0 and attempted > 0
    result.update(correct=bool(correct), attempted=attempted, failed=failed)

    if trace:
        from . import counts, manifest

        dtype = cfg.get("compute_dtype", "float32")
        tfields["counts"] = manifest.family(cfg).pool_counts(cfg, pool,
                                                             device)
        tfields["peaks"] = counts.peaks(dtype, counts.max_sm_clock_hz()
                                        if device.type == "cuda" else 1.98e9)
        from . import trace as tr
        result["breakdown"] = tr.breakdown(tfields["summary"])
        result["busy_s"] = tfields["summary"]["busy_s"]
        result["window_s"] = tfields["summary"]["window_s"]
        shared = tfields
    result["metrics"] = report(bench, cell.name, trace, shared)
    result["memory_peak_bytes"] = max(setup_peak, window_peak)
    result["checks"] = checks
    return result


def report(bench, name, trace, values) -> dict:
    """The cell's metrics of this kind, by name and unit: end-to-end from
    the window's values, per-layer from their readers."""
    from . import manifest

    out = {}
    kind = "per_layer" if trace else "end_to_end"
    for m in manifest.metrics_of(bench, name, kind):
        if trace:
            value = manifest.metric_reader(m["name"])(values)
        else:
            value = values.get(m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    opt = p.parse_args(argv)

    from . import manifest

    bench = manifest.load_benchmark()
    w = manifest.workload(bench, opt.workload)
    import torch

    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < w["chips"]:
        log(f"{opt.workload} needs {w['chips']} CUDA device(s); this "
            f"machine has {cards}: no result")
        return 2
    device = torch.device("cuda", 0)
    for line in card_lines(device):
        log(line)
    cell = Cell.load(bench, opt.workload)
    result = run_cell(cell, opt.seed, opt.seconds, bool(opt.trace), device,
                      bench)
    found = forbidden_modules()
    if found:
        log(f"loaded after the window: {found}: no result")
        return 3
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"],
            "device": {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(device),
                       "count": w["chips"],
                       "memory_peak_bytes": result["memory_peak_bytes"]}}
    if opt.trace:
        line["device"].update(busy_s=result["busy_s"],
                              window_s=result["window_s"])
        line["breakdown"] = result["breakdown"]
    for line_no in card_lines(device):
        log(line_no)
    for k, c in result["checks"].items():
        log(f"check {k}: {c['value']!r} (limit {c['limit']!r})")
    line["checks"] = result["checks"]
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
