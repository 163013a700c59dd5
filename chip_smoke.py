#!/usr/bin/env python3
"""Drive the PyTorch port's inference path once on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it exits
non-zero without one, and without the checkout beside it).  Phases:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA;
2. build: nvcc compiles the flash-attention kernel into .build/;
3. kernel: the kernel against its plain PyTorch version on the card, at the
   main-path shape and at ragged shapes, bf16 and fp32, with a fully masked
   row; CUDA-event times of both;
4. small input: the tiny config in fp32 on the card against the same model
   on the CPU (plain versions), same seeded parameters and input;
5. main path: the 3DMatch config in bf16 at bucket 20480 with seeded random
   parameters, on 4 pairs of synthetic room scans (19k points each, meter
   scale, on a 2.5 cm grid, made here with numpy): register() once, then the batched forward,
   timed, with per-stage times, a torch.profiler pass (device busy share,
   top kernels; the trace goes to .build/forward_trace.json), checks of the
   outputs, of the kernel's launch count, of the pyramid's bitwise
   repeatability, and of the kernel path against a forward whose attention
   calls the plain version.

It imports torch, numpy and regtr_tpu_torch, nothing of JAX.

Every phase prints what it found.  The second-to-last line is the kernels'
JSON summary and the last line {"ok": true, "device": {...}}; a failed
check exits non-zero before either.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N0 = 20480            # bucket of the main path (bench.py's)
N_PAIRS = 4
N_POINTS = 19000      # points per synthetic scan
VOXEL = 0.025         # the scans' grid (conf/3dmatch.yaml first_subsampling_dl)
TIMED_ITERS = 10
REPEATS = 5
PROFILED_ITERS = 3
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_pallas_attention.py
DEVICE = "cuda"


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def cuda_ms(fn, iters=30, warmup=5):
    """Median milliseconds of fn() over `iters` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch

    log("== phase 1: device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")


def phase_build():
    from regtr_tpu_torch.ops import attention

    log("== phase 2: build")
    t0 = time.perf_counter()
    attention.load_library()
    log(f"built/loaded {attention.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    ptxas = attention.library_path().with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log("  " + line.strip())


def attention_inputs(bh, nq, nk, d, dtype, seed, device):
    import torch

    from regtr_tpu_torch.ops.attention import NEG_BIAS

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v = (torch.randn(bh, n, d, generator=g) for n in (nq, nk, nk))
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, :4] = True
    mask[0] = False                      # one slice with every key masked
    bias = torch.where(mask, 0.0, NEG_BIAS).float()
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)] + [
        bias.to(device)]


def phase_kernel():
    import torch

    from regtr_tpu_torch.ops.attention import (
        flash_masked_attention, flash_masked_attention_reference)

    log("== phase 3: kernel vs plain version")
    main_shape = (64, 1872, 1872, 32)  # 8 clouds x 8 heads, coarse level
    result = {}
    for shape in [main_shape, (8, 1000, 1313, 16), (5, 777, 2049, 64),
                  (3, 65, 7, 32)]:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            q, k, v, bias = attention_inputs(*shape, dtype, 1, DEVICE)
            scale = shape[3] ** -0.5
            out = flash_masked_attention(q, k, v, bias, scale)
            ref = flash_masked_attention_reference(q, k, v, bias, scale)
            torch.cuda.synchronize()
            err = float((out[1:].float() - ref[1:].float()).abs().max())
            # |out - ref| <= tol + tol * |ref| (atol = rtol = tol)
            excess = float(((out[1:].float() - ref[1:].float()).abs()
                            - TOL[name] * ref[1:].float().abs()).max())
            log(f"  {shape} {name}: max abs err {err:.3e} "
                f"(tol {TOL[name]:g} abs + rel)")
            check(out.dtype == dtype and out.shape == q.shape,
                  f"{shape} {name} dtype/shape")
            check(bool(torch.isfinite(out[0].float()).all()),
                  f"{shape} {name} fully masked row finite")
            check(excess <= TOL[name], f"{shape} {name} within tolerance")
            if shape == main_shape:
                ms = cuda_ms(lambda: flash_masked_attention(q, k, v, bias,
                                                            scale))
                plain_ms = cuda_ms(lambda: flash_masked_attention_reference(
                    q, k, v, bias, scale))
                flops = 4 * shape[0] * shape[1] * shape[2] * shape[3]
                log(f"  {shape} {name}: kernel {ms:.4f} ms "
                    f"({flops / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.4f}"
                    f" ms (median of 30, CUDA events)")
                result[name] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms}
    return result


def phase_small_input():
    import dataclasses

    import torch

    from regtr_tpu_torch.config import tiny_config
    from regtr_tpu_torch.models import create_model

    log("== phase 4: tiny config, card vs CPU on one input")
    data = np.load(ROOT / "tests" / "golden_tiny.npz")
    pts, mask = torch.from_numpy(data["points"]), torch.from_numpy(
        data["mask"])
    models = {dev: create_model(tiny_config(), 96, dev, seed=42)
              for dev in ("cpu", DEVICE)}
    with torch.inference_mode():
        lv_cpu = models["cpu"].preprocess(pts, mask)
        lv_dev = models[DEVICE].preprocess(pts.to(DEVICE), mask.to(DEVICE))
    rows = differ = 0
    for li, (a, b) in enumerate(zip(lv_cpu, lv_dev)):
        check(torch.equal(a.points, b.points.cpu())
              and torch.equal(a.mask, b.mask.cpu()),
              f"level {li} points/mask bitwise equal")
        for name in ("neighbors", "pools", "upsamples"):
            ta, tb = getattr(a, name), getattr(b, name)
            if ta is not None:
                rows += ta.shape[0] * ta.shape[1]
                differ += int((ta.sort(-1).values
                               != tb.cpu().sort(-1).values).any(-1).sum())
    # Selection runs on bf16-rounded distances: a tie at the K-th slot or a
    # bf16 rounding at the radius may resolve differently on the two devices.
    check(differ <= 0.01 * rows,
          f"neighbor tables: {differ} of {rows} rows differ as sets")

    def run(model, levels):
        coarse = levels[-1]
        feats_un, pe = model.encode(levels)
        cond = model.condition(feats_un, pe, coarse.mask)
        return model.head_and_pose(cond, coarse.points, coarse.mask)

    # Downstream of the pyramid, both devices run on the CPU's tables.
    lv_moved = [dataclasses.replace(lv, **{
        f.name: getattr(lv, f.name).to(DEVICE)
        for f in dataclasses.fields(lv) if getattr(lv, f.name) is not None})
        for lv in lv_cpu]
    with torch.inference_mode():
        ref = run(models["cpu"], lv_cpu)
        got = run(models[DEVICE], lv_moved)
    for key, a, b in zip(("corr", "overlap_logits", "pose"), ref, got):
        b = b.cpu()
        err = float((a - b).abs().max())
        # tests/test_golden.py's tolerances (fp32, another summation order)
        check(torch.allclose(b, a, rtol=1e-3, atol=2e-4),
              f"{key} card vs CPU (max abs err {err:.2e})")


def _rotation(rng, max_deg):
    """Rotation about a random axis by an angle uniform in [0, max_deg]."""
    axis = rng.randn(3)
    axis /= np.linalg.norm(axis)
    angle = np.deg2rad(rng.uniform(0.0, max_deg))
    k = np.array([[0.0, -axis[2], axis[1]], [axis[2], 0.0, -axis[0]],
                  [-axis[1], axis[0], 0.0]])
    return np.eye(3) + np.sin(angle) * k + (1.0 - np.cos(angle)) * k @ k


def _wavy_plane(rng, n, half_x, half_y):
    """Points on a plane patch z = a sum of 1-3 sine waves (floor, wall)."""
    x = rng.uniform(-half_x, half_x, n)
    y = rng.uniform(-half_y, half_y, n)
    z = np.zeros(n)
    for _ in range(rng.randint(1, 4)):
        kx, ky = rng.uniform(2.0, 9.0, 2) * rng.choice([-1.0, 1.0], 2)
        z += rng.uniform(0.005, 0.04) * np.sin(
            kx * x + ky * y + rng.uniform(0.0, 2 * np.pi))
    return np.stack([x, y, z], 1)


def _box_surface(rng, n, half):
    """Points on the surface of a box with half-extents `half`."""
    areas = np.array([half[1] * half[2], half[0] * half[2],
                      half[0] * half[1]]).repeat(2)
    face = rng.choice(6, n, p=areas / areas.sum())
    pts = rng.uniform(-1.0, 1.0, (n, 3)) * half
    axis, sign = face // 2, np.where(face % 2 == 0, 1.0, -1.0)
    pts[np.arange(n), axis] = sign * half[axis]
    return pts


def make_room(rng, n_points):
    """One indoor scene at meter scale: a floor, four walls and 4-8 boxes
    of furniture, ~n_points points spread by area."""
    lx, ly, h = rng.uniform(3.5, 5.5), rng.uniform(3.5, 5.5), \
        rng.uniform(2.3, 2.8)
    halves = [rng.uniform(0.2, 0.5, 3) * rng.uniform(0.8, 2.0)
              for _ in range(rng.randint(4, 9))]
    areas = np.array([lx * ly, lx * h, lx * h, ly * h, ly * h]
                     + [8 * (a[0] * a[1] + a[0] * a[2] + a[1] * a[2])
                        for a in halves])
    counts = (areas / areas.sum() * n_points).astype(int)
    floor = _wavy_plane(rng, counts[0], lx / 2, ly / 2) + [lx / 2, ly / 2, 0]
    parts = [floor]
    for i, wall_y in ((1, 0.0), (2, ly)):      # walls along x
        q = _wavy_plane(rng, counts[i], lx / 2, h / 2)
        parts.append(np.stack([q[:, 0] + lx / 2, q[:, 2] + wall_y,
                               q[:, 1] + h / 2], 1))
    for i, wall_x in ((3, 0.0), (4, lx)):      # walls along y
        q = _wavy_plane(rng, counts[i], ly / 2, h / 2)
        parts.append(np.stack([q[:, 2] + wall_x, q[:, 0] + ly / 2,
                               q[:, 1] + h / 2], 1))
    for half, n in zip(halves, counts[5:]):
        offset = [rng.uniform(0.6, lx - 0.6), rng.uniform(0.6, ly - 0.6),
                  half[2]]
        parts.append(_box_surface(rng, n, half) @ _rotation(rng, 180).T
                     + offset)
    return np.concatenate(parts).astype(np.float32), (lx, ly)


def synthetic_pairs(n_pairs, n_points, seed):
    """Interleaved pairs of overlapping scans of synthetic rooms, each cloud
    in its own random frame (rotation up to 50 degrees).

    Like a 3DMatch fragment, a scan is a contiguous patch at the density of
    a 2.5 cm voxel grid: the room is voxel-downsampled once, and a scan is
    the n_points points nearest to its center.
    """
    rng = np.random.RandomState(seed)
    clouds = []
    for _ in range(n_pairs):
        room, (lx, ly) = make_room(rng, 600000)
        _, first = np.unique(np.floor(room / VOXEL).astype(np.int64),
                             axis=0, return_index=True)
        room = room[np.sort(first)]
        center = np.array([lx * 0.45, ly * 0.5, 1.1])
        for c in (center, center + [0.7, 0.3, 0.0]):
            dist = np.linalg.norm(room - c, axis=1)
            keep = np.argpartition(dist, n_points)[:n_points]
            rot = _rotation(rng, 50.0)
            clouds.append((room[keep] @ rot.T
                           + rng.randn(3) * 0.3).astype(np.float32))
    pts = np.zeros((len(clouds), N0, 3), np.float32)
    mask = np.zeros((len(clouds), N0), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)] = c
        mask[i, :len(c)] = True
    return pts, mask


def profile_forward(model, pts, mask, n=PROFILED_ITERS):
    """torch.profiler over n back-to-back forwards: the device's busy share
    (union of kernel intervals over the span from the first kernel's start
    to the last one's end) and the kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.inference_mode(), profile(activities=acts) as prof:
        for _ in range(n):
            model(pts, mask)
        torch.cuda.synchronize()
    trace = ROOT / ".build" / "forward_trace.json"
    trace.parent.mkdir(exist_ok=True)
    prof.export_chrome_trace(str(trace))
    kernels = [e for e in json.loads(trace.read_text())["traceEvents"]
               if e.get("cat") == "kernel"]
    check(len(kernels) > 0, f"profiler saw {len(kernels)} device kernels")
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in kernels)
    busy, end = 0.0, spans[0][0]
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    total = end - spans[0][0]
    log(f"profile of {n} forwards: device busy {busy / 1e3:.1f} of "
        f"{total / 1e3:.1f} ms ({100 * busy / total:.1f} %), kernels "
        f"{busy / 1e3 / n:.1f} ms per forward")
    per_name = {}
    for e in kernels:
        name = e["name"].removeprefix("void ")[:100]
        per_name[name] = per_name.get(name, 0.0) + e["dur"]
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / 1e3 / n:8.2f} ms/forward  {name}")


def phase_main_path():
    import torch

    import regtr_tpu_torch
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.nn import transformer
    from regtr_tpu_torch.ops.attention import (
        flash_masked_attention, flash_masked_attention_reference)

    log("== phase 5: main path (3DMatch config, bf16, bucket 20480)")
    cfg = threedmatch_config(compute_dtype="bfloat16")
    t0 = time.perf_counter()
    model = create_model(cfg, N0, DEVICE, seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"model: {n_params / 1e6:.2f} M parameters, caps "
        f"{model.spec.capacities}, K {model.spec.neighbor_ks}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    pts_np, mask_np = synthetic_pairs(N_PAIRS, N_POINTS, seed=0)
    log(f"inputs: {N_PAIRS} pairs, points per cloud "
        f"{mask_np.sum(1).tolist()}")
    pts = torch.from_numpy(pts_np).to(DEVICE)
    mask = torch.from_numpy(mask_np).to(DEVICE)
    n_layers = cfg["num_encoder_layers"]
    per_forward = 2 * n_layers           # self + cross attention per layer

    flash_masked_attention.launches = 0
    # -- register() on one pair
    t0 = time.perf_counter()
    res = regtr_tpu_torch.register(
        pts_np[0][mask_np[0]], pts_np[1][mask_np[1]],
        params=model.state_dict(), cfg=cfg, bucket=N0, device=DEVICE)
    log(f"register(): {time.perf_counter() - t0:.2f} s (first call), "
        f"{len(res['src_kp'])} source keypoints")
    check(flash_masked_attention.launches == per_forward,
          f"register() launched the kernel {per_forward} times")
    check(np.all(np.isfinite(res["pose"])), "register() pose finite")

    # -- the batched forward: warm-up, then REPEATS x TIMED_ITERS timed.
    # The launch count is zeroed just before the timed window and read just
    # after it, so it counts that window's forwards only.
    with torch.inference_mode():
        for _ in range(2):
            out = model(pts, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        flash_masked_attention.launches = 0
        rates = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                out = model(pts, mask)
            torch.cuda.synchronize()
            rates.append(N_PAIRS * TIMED_ITERS / (time.perf_counter() - t0))
        launches = flash_masked_attention.launches
    forwards = REPEATS * TIMED_ITERS
    check(launches == per_forward * forwards,
          f"{launches} kernel launches in {forwards} forwards "
          f"({per_forward} per forward)")
    peak = torch.cuda.max_memory_allocated()
    pairs_per_s = statistics.median(rates)
    log(f"forward: {N_PAIRS / pairs_per_s * 1e3:.1f} ms per batch of "
        f"{N_PAIRS} pairs, {pairs_per_s:.3f} pairs/s (median of {REPEATS} "
        f"runs of {TIMED_ITERS} forwards after 2 warm-up, host clock; runs "
        f"{' / '.join(f'{r:.3f}' for r in rates)}), peak memory "
        f"{peak / 2**30:.2f} GiB")

    # -- outputs
    b2, nc = pts.shape[0], model.spec.capacities[-1]
    shapes = {"feats_un": (b2, nc, cfg["d_embed"]),
              "feats_cond": (n_layers, b2, nc, cfg["d_embed"]),
              "corr": (n_layers, b2, nc, 3),
              "overlap_logits": (n_layers, b2, nc),
              "pose": (n_layers, N_PAIRS, 3, 4)}
    for key, shape in shapes.items():
        check(tuple(out[key].shape) == shape
              and bool(torch.isfinite(out[key].float()).all()),
              f"{key} finite, shape {shape}")
    rot = out["pose"][..., :3].double()
    eye = torch.eye(3, dtype=rot.dtype, device=rot.device)
    orth = float((rot @ rot.transpose(-1, -2) - eye).abs().max())
    det = torch.linalg.det(rot)
    check(orth < 1e-3 and bool(((det - 1).abs() < 1e-3).all()),
          f"rotations orthonormal (max dev {orth:.1e}) with det +1")

    # -- per-stage times (synchronized after each stage)
    stages = {"pyramid": [], "backbone": [], "transformer": [],
              "head_pose": []}
    with torch.inference_mode():
        for _ in range(TIMED_ITERS):
            t = time.perf_counter()
            levels = model.preprocess(pts, mask)
            torch.cuda.synchronize()
            stages["pyramid"].append(time.perf_counter() - t)
            t = time.perf_counter()
            feats_un, pe = model.encode(levels)
            torch.cuda.synchronize()
            stages["backbone"].append(time.perf_counter() - t)
            t = time.perf_counter()
            cond = model.condition(feats_un, pe, levels[-1].mask)
            torch.cuda.synchronize()
            stages["transformer"].append(time.perf_counter() - t)
            t = time.perf_counter()
            model.head_and_pose(cond, levels[-1].points, levels[-1].mask)
            torch.cuda.synchronize()
            stages["head_pose"].append(time.perf_counter() - t)
    log("stages (median ms, host clock around synchronized stages): "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f}"
                    for k, v in stages.items()))
    profile_forward(model, pts, mask)

    # -- determinism of the pyramid
    with torch.inference_mode():
        again = model.preprocess(pts, mask)
    same = all(
        (getattr(a, f) is None and getattr(b, f) is None)
        or torch.equal(getattr(a, f), getattr(b, f))
        for a, b in zip(levels, again)
        for f in ("points", "mask", "neighbors", "pools", "upsamples",
                  "perm"))
    check(same, "pyramid tables bitwise-equal on a second run")
    counts = [int((lv.neighbors < lv.points.shape[1]).sum(-1).float().mean())
              for lv in levels]
    log(f"mean neighbors per level {counts}, occupied points per level "
        f"{[int(lv.mask.sum(1).float().mean()) for lv in levels]}")

    # -- kernel path vs a forward whose attention is the plain version
    with torch.inference_mode():
        transformer.flash_masked_attention = flash_masked_attention_reference
        try:
            plain = model(pts, mask)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                model(pts, mask)
            torch.cuda.synchronize()
            plain_elapsed = time.perf_counter() - t0
        finally:
            transformer.flash_masked_attention = flash_masked_attention
    log(f"forward with the plain attention instead: "
        f"{plain_elapsed / TIMED_ITERS * 1e3:.1f} ms per batch, "
        f"{N_PAIRS * TIMED_ITERS / plain_elapsed:.2f} pairs/s")
    for key in ("feats_cond", "overlap_logits"):
        err = rel_l2(out[key], plain[key])
        check(err < TOL["bfloat16"],
              f"{key}: kernel path vs plain attention, rel L2 {err:.2e}")
    return launches, forwards


def main():
    if not (ROOT / "regtr_tpu_torch").is_dir():
        raise SystemExit("FAILED: run chip_smoke.py from a checkout of the "
                         "repository (regtr_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false")
    phase_device()
    phase_build()
    kern = phase_kernel()
    phase_small_input()
    launches, forwards = phase_main_path()
    main_bf16 = kern["bfloat16"]
    log(json.dumps({"kernels": [{
        "name": "flash_attn_fwd",
        "route": "cuda",
        "source": "regtr_tpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "regtr_tpu/ops/pallas/attention.py:49",
        "launches": launches,
        "forwards": forwards,
        "max_abs_err": main_bf16["max_abs_err"],
        "ms": main_bf16["ms"],
        "plain_ms": main_bf16["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
