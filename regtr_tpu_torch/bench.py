"""Inference throughput of the port on one card: the counterpart of the
root bench.py.

    python -m regtr_tpu_torch.bench [n_pairs=4] [bucket=20480]
        [dtype=bfloat16] [--device cpu]

Prints ONE JSON line on stdout, with bench.py's keys: {"metric":
"3dmatch_inference_throughput", "value": pairs/s, "unit": "pairs/sec",
"vs_baseline": pairs/s / 10 (the reference's ~0.1 s a pair on a Titan RTX,
BASELINE.md), "init_s", "compile_s", "lower_compile_s", "first_exec_s",
"tflops": null, "mfu": null}.  `init_s` is the model's seeded
construction and the inputs' generation and upload, `lower_compile_s` the
kernels' build (one nvcc per source, at once, into .build/; 0 on the CPU,
which runs the plain versions), `first_exec_s` the first forward and
`compile_s` their sum.  No FLOP count is to hand, so `tflops` and `mfu`
are null, as bench.py prints them without one.  On stderr: the device
(the card's name and power limit from nvidia-smi), the per-stage medians
(pyramid, backbone, transformer, head + pose, each synchronized) and the
timed runs.

The model is the shipped conf/3dmatch.yaml at its full width, with random
weights from seed 0, run through `train.steps.make_forward` on a batch of
n_pairs pairs of deterministic synthetic room scans of 19 000 points at
2.5 cm (data/rooms.py, seed 0), each padded to the bucket.  bench.py reads
a real 3DMatch scan from outside the repository instead; this reads no
file.  bench.py's fourth argument, the JAX attention implementation, has
no counterpart: the port has one attention route on the card (K1).

`--device` defaults to cuda:<LOCAL_RANK>, which raises where there is no
card; "cpu" runs the plain versions (the tests).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import torch

N_POINTS = 19000     # points per synthetic scan
BASELINE_PAIRS_PER_S = 10.0


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_line(device) -> str:
    """What runs the forward: the card's name and power limit as nvidia-smi
    prints them, or the CPU."""
    if device.type != "cuda":
        return "device: cpu (the plain versions; no device time)"
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60)
    return f"device: {device} {smi.stdout.strip()}"


def stage_medians(model, pts, mask, iters, device) -> dict:
    """Median ms of each stage of the forward over `iters` forwards, the
    device synchronized after each stage (host clock)."""
    stages = {"pyramid": [], "backbone": [], "transformer": [],
              "head_pose": []}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        _sync(device)
        stages[name].append((time.perf_counter() - t) * 1e3)
        return out

    with torch.inference_mode():
        for _ in range(iters):
            levels = timed("pyramid", model.preprocess, pts, mask)
            feats_un, pe = timed("backbone", model.encode, levels)
            cond = timed("transformer", model.condition, feats_un, pe,
                         levels[-1].mask)
            timed("head_pose", model.head_and_pose, cond, levels[-1].points,
                  levels[-1].mask, pe)
    return {k: statistics.median(v) for k, v in stages.items()}


def run(n_pairs: int = 4, n0: int = 20480, dtype: str = "bfloat16",
        device=None, iters: int = 10,
        n_points: int = N_POINTS) -> dict:
    """Build, time and return bench.py's record (see the module's
    docstring); `iters` forwards are timed, and as many per-stage runs."""
    from .config import threedmatch_config
    from .data.rooms import padded_pairs
    from .models import create_model
    from .ops import cuda_build
    from .parallel.dist import resolve_device
    from .train.steps import make_forward

    dev = resolve_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: CUDA is not available")
    log(device_line(dev))

    t_init = time.perf_counter()
    cfg = threedmatch_config(compute_dtype=dtype)
    model = create_model(cfg, n0, dev, seed=0)
    pts_np, mask_np = padded_pairs(n_pairs, min(n_points, n0), 0, n0)
    pts = torch.from_numpy(pts_np).to(dev)
    mask = torch.from_numpy(mask_np).to(dev)
    _sync(dev)
    init_s = time.perf_counter() - t_init
    log(f"bucket {n0}, {n_pairs} pairs of synthetic scans "
        f"({mask_np.sum(1).tolist()} points), {dtype}; pyramid caps "
        f"{model.spec.capacities}, K {model.spec.neighbor_ks}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters; init {init_s:.1f} s")

    t0 = time.perf_counter()
    if dev.type == "cuda":
        libraries = cuda_build.kernel_libraries()
        cuda_build.build_all(libraries)
        for lib in libraries:
            lib.load()
    lower_compile_s = time.perf_counter() - t0

    forward = make_forward(model)
    t0 = time.perf_counter()
    forward(pts, mask)
    _sync(dev)
    first_exec_s = time.perf_counter() - t0
    compile_s = lower_compile_s + first_exec_s
    log(f"kernels' build {lower_compile_s:.1f} s, first forward "
        f"{first_exec_s:.1f} s")

    forward(pts, mask)       # warm
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = forward(pts, mask)
    _sync(dev)
    dt = time.perf_counter() - t0
    pairs_per_s = n_pairs * iters / dt
    if not bool(torch.isfinite(out["pose"]).all()):
        raise RuntimeError("the forward's poses are not finite")
    log(f"{iters} forwards in {dt:.3f} s -> {pairs_per_s:.3f} pairs/s "
        f"({1e3 * dt / (iters * n_pairs):.1f} ms/pair), host clock")
    stages = stage_medians(model, pts, mask, iters, dev)
    log("stages (median ms, synchronized): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages.items()))
    return {
        "metric": "3dmatch_inference_throughput",
        "value": round(pairs_per_s, 3),
        "unit": "pairs/sec",
        "vs_baseline": round(pairs_per_s / BASELINE_PAIRS_PER_S, 3),
        "init_s": round(init_s, 1),
        "compile_s": round(compile_s, 1),
        "lower_compile_s": round(lower_compile_s, 1),
        "first_exec_s": round(first_exec_s, 1),
        "tflops": None,
        "mfu": None,
    }


def main(argv=None, iters: int = 10, n_points: int = N_POINTS) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n_pairs", nargs="?", type=int, default=4)
    p.add_argument("bucket", nargs="?", type=int, default=20480)
    p.add_argument("dtype", nargs="?", default="bfloat16",
                   choices=("bfloat16", "float32"))
    p.add_argument("--device", default=None,
                   help="cuda:<LOCAL_RANK> when not given, or e.g. cpu")
    opt = p.parse_args(argv)
    record = run(opt.n_pairs, opt.bucket, opt.dtype, opt.device, iters,
                 n_points)
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
