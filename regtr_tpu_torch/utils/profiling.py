"""Stage timing and device traces (the port's counterpart of
regtr_tpu/utils/profiling.py).

`Timer` and `StageTimer` time by CUDA events on a CUDA device and by the
host clock on the CPU; `StageTimer.dump` appends one line of stage means to
timings.txt in the JAX package's format.  `force` waits for the devices of
a nested container's tensors, `bench` times a function after a warm-up
call, and `device_trace` writes a Chrome trace with `torch.profiler`.

`span(name)` marks a stretch of the program's host work for the profiler.
The model and the training step open one at each layer boundary (every
name starts with `regtr.`: forward, pyramid, backbone, transformer,
head_pose, losses; train_step, forward_loss, backward, optimizer), so a
profile, `device_trace`'s Chrome trace among them, carries them on the
profiler's own clock beside the device's operations.  With no profiler
running a span costs one flag check and records nothing.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

from .misc import tree_leaves


def force(tree) -> float:
    """Wait for every CUDA device that holds a tensor of `tree`; returns a
    checksum of its first tensor (the sum of its first 8 elements)."""
    tensors = [x for x in tree_leaves(tree) if torch.is_tensor(x)]
    for dev in {t.device for t in tensors if t.is_cuda}:
        torch.cuda.synchronize(dev)
    if not tensors:
        return 0.0
    return float(tensors[0].detach().float().reshape(-1)[:8].sum())


def _is_cuda(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


class Timer:
    """Accumulating timer (tic / toc).  On a CUDA `device` it times the
    work queued on the current stream between tic and toc with CUDA
    events; otherwise the host clock, after forcing `tree` at toc."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.total = 0.0
        self.calls = 0
        self._t0 = None

    def tic(self):
        if _is_cuda(self.device):
            self._t0 = torch.cuda.Event(enable_timing=True)
            self._t0.record()
        else:
            self._t0 = time.perf_counter()

    def toc(self, tree=None) -> float:
        """Seconds since tic, added to the total."""
        if _is_cuda(self.device):
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._t0.elapsed_time(end) / 1e3
        else:
            if tree is not None:
                force(tree)
            dt = time.perf_counter() - self._t0
        self.total += dt
        self.calls += 1
        return dt

    @property
    def avg(self):
        return self.total / max(self.calls, 1)


class StageTimer:
    """Named stage timers and the timings.txt record (one line per dump:
    the stages' means in seconds, tab-separated, in first-use order)."""

    def __init__(self, out_path=None, device=None):
        self.timers = {}
        self.device = device
        self.out_path = Path(out_path) if out_path else None

    def _timer(self, name) -> Timer:
        return self.timers.setdefault(name, Timer(self.device))

    @contextlib.contextmanager
    def stage(self, name, tree_fn=None):
        t = self._timer(name)
        t.tic()
        yield
        t.toc(tree_fn() if tree_fn else None)

    def record(self, name, seconds):
        t = self._timer(name)
        t.total += seconds
        t.calls += 1

    def summary(self):
        return {k: t.avg for k, t in self.timers.items()}

    def dump(self):
        if self.out_path is None:
            return
        with open(self.out_path, "a") as f:
            f.write("\t".join(f"{t.avg:10f}" for t in self.timers.values())
                    + "\n")


def bench(fn, *args, iters: int = 10, device=None):
    """(seconds of the first call, seconds per call after it) of fn(*args):
    the first call warms up (kernel builds, allocations), then `iters`
    calls back to back are timed, by CUDA events on a CUDA `device`, else
    by the host clock (the counterpart of the JAX package's
    `bench_jitted`)."""
    t0 = time.perf_counter()
    force(fn(*args))
    first_s = time.perf_counter() - t0
    timer = Timer(device)
    timer.tic()
    for _ in range(iters):
        out = fn(*args)
    return first_s, timer.toc(out) / iters


_NO_SPAN = contextlib.nullcontext()


def profiler_running() -> bool:
    """Whether a torch.profiler is recording: the one flag that `span` and
    the program's profile-only counters check."""
    return torch._C._autograd._profiler_enabled()


def span(name: str):
    """A context that records `name` as a host event of the running
    profiler, or, with none running, a shared no-op context: no
    allocation, no device sync.  The event is a plain host operation, not a
    user annotation: the profiler mirrors each user annotation onto the
    device's timeline as a span from its first operation to its last,
    which a reader of device intervals would count as device work."""
    if profiler_running():
        return torch._C._profiler._RecordFunctionFast(name)
    return _NO_SPAN


@contextlib.contextmanager
def device_trace(out_dir, name: str = "trace.json"):
    """Profile the block with torch.profiler (the CPU, and the card where
    there is one) and write its Chrome trace to out_dir/name."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out_dir / name))
