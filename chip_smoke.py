#!/usr/bin/env python3
"""Drive the PyTorch port's inference path, training step, trainer, test
protocols, other command lines and data parallelism on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it exits
non-zero without one, and without the checkout beside it).  Phases:

1. device: the card's name and power limit (nvidia-smi), its maximum SM
   clock, torch and CUDA;
2. build: one nvcc per kernel source (csrc/flash_attn_fwd.cu,
   flash_attn_bwd.cu, segsum.cu, gather.cu, neighbors.cu), all at once,
   into .build/;
3. attention kernels against their plain PyTorch versions on the card, at
   the inference, training, protocol, trainer and ModelNet protocol shapes
   and at ragged shapes, bf16
   and fp32, with a fully masked row: the forward and its lse, the
   backward's dq, dk, dv and dbias (every kernel bitwise equal over two
   launches); CUDA-event times of each kernel, its plain version and
   scaled_dot_product_attention (timed as a yardstick only), the forward
   beside its bound (the largest of bytes, products at the design's rate
   and exponentials) and the fp32 kernels beside their 3xTF32 and FMA
   bounds;
3a. K1 with key extents (each slice's last valid key) against K1 without,
   fp32, out and lse bitwise: at the inference cell's coarse level (64,
   2240, 2240, 32) with prefix masks of 280-420 valid keys a slice, and at
   ModelNet's shape with every key valid; the key tiles run under a
   profiler, times of both (single launches and back to back) beside the
   bound over the valid work;
3b. gather kernels (K5) against index_select and torch.gather, bitwise: the
   row gather at the main path's shapes with its int32 flat ids (the
   inference feature and coordinate gathers, the training feature gather;
   the coordinate rows with int64 ids too) and at ragged widths with both
   id widths, the element gather on both axes, 2-D and batched (rows wider
   than 48 KB and than a block's shared memory, a batch stride larger than
   the slice, operands off 16 bytes); CUDA-event times beside the bound and
   the library call, the row gather in turns with index_select;
3c. the brute neighbor search (K6) against its plain version, bitwise and
   bitwise over two launches, on the ten searches of phase 5's pyramid,
   the four of a ModelNet pair's, a constructed fp32-key case (Ns < 4K)
   and adversarial cases (a pair 100 m from the origin, supports in tight
   clusters at the threshold's edge, a single tile, K above every
   neighbor count, 64-bit words at Ns >= 65536), its threshold against
   the plain version's on the card and its launch plan against the
   mirror in ops/neighbors.py; CUDA-event times of the kernel (single
   launches and back to back) beside its first design's and the plain
   version's, and beside three bounds: 8 fp32 operations a candidate over
   every valid pair (brute) and over the pairs the culling test keeps at
   a 32 x 32 grain (culled), and the bytes;
4. small input: the tiny config in fp32 on the card against the same model
   on the CPU (plain versions), same seeded parameters and input: the
   forward, and the gradients of one training step leaf by leaf;
5. inference path: the 3DMatch config in bf16 at bucket 20480 with seeded
   random parameters, on 4 pairs of synthetic room scans (19k points each,
   meter scale, on a 2.5 cm grid, made here with numpy): register() once,
   then the batched forward, timed, with per-stage times, a torch.profiler
   pass (device busy share, top kernels; the trace goes to
   .build/forward_trace.json), checks of the outputs, of the kernels'
   launch counts (ten neighbor searches, no gather transpose), of the
   pyramid's bitwise repeatability, of the kernel path
   against a forward whose attention calls the plain version, and of the
   forward with K5 against the forward with index_select (bitwise);
5b. `python -m regtr_tpu_torch.bench` at its defaults, once: its JSON
   line beside phase 5's pairs/s;
5c. GeoTransformer (portbench/configs/geotr-3dmatch.json, fp32, its
   program's seeded init) on 4 pairs of those scans at bucket 24576: K1
   at the cross-attention's shape (16, 512, 512, 64) with key extents
   (352 / 377 and 300 valid keys) against its plain version, and bitwise
   the launch without extents, timed; a forward with the launch counts
   set to 0 just before it, the counts against
   `geotr_launches_per_forward` (ten searches, two K1 launches a cross
   block, the backbone's, the decoder's and the four patch gathers, one
   embedding, no other kernel), every K6, K1, K5a and embedding launch of
   it held to its plain
   version as it happens, finite poses; K5a at the patch gathers' own
   tables and ids (level-1 features, 256 wide, and points, 3 wide)
   bitwise index_select, timed; the geometric embedding's kernel (one
   launch a forward, held to its plain version within TOL) timed on that
   forward's inputs beside the module's stage and the plain version;
6. training path: the shipped 3DMatch config (fp32) on 2 pairs of those
   scans with GT poses and overlap labels, collated at the bucket the
   config picks (24576): the gather transpose on the step's level-0 table
   (the transpose kernels bitwise against a stable sort, there and on
   tables with a 6000-row segment, of pad rows only and with empty
   segments; the segment-sum kernel against itself over the plain
   transpose, its plain version and index_add_; times in turns beside
   torch.sort); the first step's gradients on the kernel path against the
   plain attention, gather and gather transpose, and bitwise against the
   same step with index_select in place of K5 and with the plain transpose
   in place of the transpose kernel; 2 warm-up and 20 timed steps
   (ms/step, pairs/s, peak memory, launch counts: one transpose per
   distinct neighbor table, finite losses, a falling loss); a NaN batch
   that must skip its update; per-stage times; a torch.profiler pass (the
   transpose and segsum kernels by name; trace in
   .build/train_trace.json);
7. test protocol: a synthetic data root in 3DMatch's on-disk formats under
   .build/protocol (2 scenes of 6 scans of 19k points, GT trajectories for
   3DMatch and 3DLoMatch), run_test on the shipped config (fp32, batch 1,
   the model at the largest bucket) for both benchmarks: launch counts,
   est.log contents, poses against a direct forward, recall 1.0 for GT
   poses, pairs/s and per-stage times; then `python -m
   regtr_tpu_torch.test` on the same parameters saved as .npz;
8. the trainer: `python -m regtr_tpu_torch.train`'s main in-process on
   conf/synthetic_3dmatch.yaml at its published width (16384 points,
   batch 2, bf16, 11 blocks, 6 layers) with the data cut to 16 synthetic
   items and 4 for validation: sanity validation, 8 steps with validation
   and best-by-score checkpoints every 4, a restore into a fresh model and
   optimizer (bitwise the trained run's tensors), then a resume from the
   run's ckpt/ to step 10; every loss finite, no update skipped, no failed
   step, the same kernels launched by every step (K1, K2, K3, K4 with its
   transpose and K5a; not K5b), the median step time, the loader's wait
   and the validation time;
9. the ModelNet / ModelLoNet protocols: `python -m regtr_tpu_torch.test`'s
   main in-process on conf/modelnet.yaml as shipped (fp32, bucket 768, 6
   layers) with seeded random parameters saved as .npz, on the dataset's
   synthetic stand-in (the HDF5 shards are not in the repository; the
   dataset's root a directory of the checkout that does not exist), its
   test split cut from 256 to 32 pairs: launches per pair (K1 and K5a
   only), pred_transforms.npy in dataset order, every pose bitwise a direct
   forward's, finite metrics, the metrics of groundtruth poses, pairs/s
   and per-pair times; then each kernel launch of one pair held to its
   plain version and a profile of its forward;
10. the other command lines: `python -m regtr_tpu_torch.demo` on a
   ModelNet-size pair written as .ply with --save_attn (12 maps whose rows
   sum to 1; every output bitwise the run without the hook's) and on a
   3DMatch-size pair of phase 7's scans; `python -m
   regtr_tpu_torch.calibrate` on phase 7's data root on the card (3
   samples, the YAML it writes read back) and on the card and the CPU (1
   sample, equal results); `python -m regtr_tpu_torch.evaluate_3dmatch`
   on phase 7's est.log trees (Predator recall as run_test's, DGR 1.0 on
   the GT logs, individual_errors.xlsx read back);
11. the options the shipped configs leave off, at the full width of
   conf/3dmatch.yaml (a derived YAML under .build/options: the last three
   blocks deformable and modulated, the attention decoder head with its
   top-64 mask, the learned positional embedding, the sampled circle
   loss, 2 micro-steps per update): (a) the bf16 forward on 4 pairs at
   bucket 20480, finite, each K1 and K5a launch of one pair held to its
   plain version; (b) the trainer over 4 micro-steps (fp32, 2 pairs,
   bucket 24576): the parameters move at micro-steps 2 and 4 only, the
   losses finite, each launch of the last micro-step held to its plain
   version; (c) compute_loss and its backward with dropout 0.1 (dense
   attention, no K1), finite, bitwise repeatable with a seed and not
   with another; (d) one pair's pyramid by the 'scan' and 'grid'
   searches: each K5b launch bitwise torch.gather, the tables the brute
   search's by tests/test_torch_pyramid.py's rule, K5b timed at the
   scan's merge shape;
12. data parallelism (regtr_tpu_torch/parallel/dist.py) under `python -m
   torch.distributed.run --standalone`, and remat: (a) the trainer on
   phase 8's first run, one rank per card over NCCL (world size 1 on one
   card, where no process group is made): its losses and its checkpoint
   bitwise phase 8's, its median step and peak memory beside phase 8's;
   (b) two ranks sharing the card over Gloo (`--device cuda:0`): the
   trainer (the ranks' parameters bitwise equal, one run directory with
   log.rank1.txt, rank 0's checkpoints and best.json, phase 8's launches
   per step on both ranks), `python -m regtr_tpu_torch.test` on phase 7's
   parameters and root (the merged est.log holds phase 7's pairs, each
   pose bitwise) and phase 6's first step with one pair per rank (the
   sum-reduced gradients bitwise-near one process on the ranks' shapes,
   the all-reduce timed); the batch shape's spread (C1,
   `batch_shape_study`: phase 6's first pair alone and twice in fp32, and
   alone in float64, per leaf, per block, with the leaky ReLU slopes and
   max-pool choices that differ), then the ranks' gradients per leaf
   against phase 6's and a float64 step (C2), and the sampled circle loss
   on the two ranks against one process (C3: each pair's samples bitwise);
   (c) one step with remat off and on at the full
   width of conf/modelnet.yaml and of conf/3dmatch.yaml at bucket 24576:
   the gradients bitwise, the peak memory of each, each kernel launch of
   the remat step held to its plain version.  The ranks run this file as
   `chip_smoke.py --rank-worker KIND OUT ARGS` (`rank_worker`);
13. an upstream RegTR checkpoint: a state_dict in the reference's layout
   at the full width of conf/3dmatch.yaml (numpy, seed 0, each block's
   kernel points drawn in the unit ball), converted by `python -m
   regtr_tpu_torch.convert_checkpoint` where JAX and PyYAML cannot be
   imported, every parameter and disposition bitwise its source; `python
   -m regtr_tpu_torch.test --params` on it over phase 7's root (launches
   per pair, each of one pair's held to its plain version, pairs/s; the
   unfused `kpconv` of a level-0 block bitwise the fused one); and
   `--export` of phase 8's run, bitwise its restored model's parameters.

It imports torch, numpy, scipy and regtr_tpu_torch, nothing of JAX.

Every phase prints what it found.  The second-to-last line is the kernels'
JSON summary and the last line {"ok": true, "device": {...}}; a failed
check exits non-zero before either.
"""
from __future__ import annotations

import contextlib
import json
import os
import pickle
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N0 = 20480            # bucket of the inference path (bench.py's)
N_PAIRS = 4
N_POINTS = 19000      # points per synthetic scan
TIMED_ITERS = 10
REPEATS = 5
PROFILED_ITERS = 3
TRAIN_WARMUP = 2
TRAIN_STEPS = 20
TOL = {"bfloat16": 2e-2, "float32": 2e-5}   # tests/test_pallas_attention.py
# Backward: every gradient sums N products in another order than the plain
# version; held to TOL_BWD times the larger of its largest magnitude and 1
# (plus TOL_BWD relative), as tests/test_torch_cuda.py holds it.  fp32: the
# kernels' products run in 3xTF32 (~1e-6 of the largest gradient; one TF32
# product alone would be ~1e-3).  bf16: p and ds rounded to bf16 on both
# sides.
TOL_BWD = {"bfloat16": 2e-2, "float32": 2e-5}
TOL_LSE = 1e-4        # abs, fp32 logsumexp of the same scores
TOL_SEGSUM = 1e-5     # x largest |sum|: fp32 sums of the same rows
TOL_GRAD = 1e-3       # relative L2 per parameter, kernels vs plain (fp32)
# The same in bf16 (phase 8), the key projections' biases aside: both
# routes round the operands to bf16 (2^-8 relative), and a kernel's fp32
# sums in another order move some roundings by one bf16 step, which the
# layers after it carry on (measured on the H100, synthetic_3dmatch's last
# batch: 6.3e-2 at worst, in the attention's q and k projections, whose
# gradients pass through softmax's cancelling dS; 5.9e-3 the median leaf).
# Beside it, the kernels' gradients as a whole may lie no more than
# TOL_BF16_NOISE times as far from an fp32 step's (the plain route, fp32
# operands) as the plain route's bf16 gradients do.
TOL_GRAD_BF16 = 0.25
TOL_BF16_NOISE = 1.5
DEVICE = "cuda"
# NVIDIA's data sheet, H100 SXM at 700 W:
PEAK_BYTES = 3.35e12
# fp32 on the CUDA cores' FMAs; "3xtf32": an fp32 product as three TF32
# products on the tensor cores (495 TFLOP/s), what K1, K2 and K3 run.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "3xtf32": 495e12 / 3}
# ex2 (the exponent) on the MUFU units: 16 per SM per clock (the CUDA C
# Programming Guide's throughput table, compute capability 9.0), 132 SMs,
# at the card's maximum SM clock (read in phase 1).  The bound this gives
# assumes every 2^x on MUFU, as K1 computes it: a kernel that evaluated part
# of them as polynomials on the FMA pipe could go below it.
EXP_PER_SM_CLOCK = 16
SMS = 132
SM_CLOCK_HZ = 1980e6


def log(*args):
    print(*args, flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"FAILED: {what}")
    log(f"  ok: {what}")


def rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def cuda_ms(fn, iters=30, warmup=5, reps=1):
    """Median milliseconds per call of fn() over `iters` runs of `reps`
    calls, each run between two CUDA events.  With reps=1 (every `ms` of
    the kernels line) a run is one launch: the host's latency from the
    first event to the launch is in it.  With reps > 1 (`back_to_back_ms`)
    the host queues a run's calls while the device works through them, so
    the time per call is nearer the device's alone."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def max_sm_clock_hz():
    """The card's maximum SM clock in Hz as nvidia-smi reports it, or None
    when it reports none."""
    try:
        text = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
        return float(text.split()[0]) * 1e6
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def phase_device():
    import torch

    global SM_CLOCK_HZ
    log("== phase 1: device")
    log(card_line())
    clock = max_sm_clock_hz()
    if clock is None:
        log(f"max SM clock: assumed {SM_CLOCK_HZ / 1e6:.0f} MHz (nvidia-smi "
            "gave none) for the exponent bound")
    else:
        SM_CLOCK_HZ = clock
        log(f"max SM clock {SM_CLOCK_HZ / 1e6:.0f} MHz (nvidia-smi; the "
            "exponent bound's)")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.device_count()} device(s): "
        f"{torch.cuda.get_device_name(0)}")


def phase_build():
    from regtr_tpu_torch.ops import cuda_build

    log("== phase 2: build")
    libs = cuda_build.kernel_libraries()
    t0 = time.perf_counter()
    cuda_build.build_all(libs)
    for lib in libs:
        lib.load()
    log(f"built/loaded {', '.join(lib.path().name for lib in libs)} in "
        f"{time.perf_counter() - t0:.2f} s (one nvcc per source, at once)")
    for lib in libs:
        ptxas = lib.path().with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    log("  " + line.strip())


def bound(flops, nbytes, dtype):
    """Least time the card could take (ms) and what bounds it."""
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_fwd_bounds(shape, name, valid=None):
    """K1's bounds (ms): the largest of bytes, products at the design's
    instruction rate (bf16 mma, or 3xTF32 for fp32) and exponentials on
    MUFU, with its parts and the CUDA cores' FMA bound (the yardstick of an
    FMA design) beside it.  With `valid`, each slice's count of valid
    queries and keys (self-attention), over the valid work alone."""
    bh, nq, nk, d = shape
    width = 2 if name == "bfloat16" else 4
    if valid is None:
        rows, keys, pairs = bh * nq, bh * nk, bh * nq * nk
    else:
        rows = keys = sum(valid)
        pairs = sum(n * n for n in valid)
    flops = 4 * pairs * d
    # reads q, k, v, bias once, writes out once
    bytes_ms = (2 * (rows + keys) * d * width + keys * 4) / PEAK_BYTES
    ops_ms = flops / PEAK_FLOPS["3xtf32" if width == 4 else name]
    exp_ms = pairs / (EXP_PER_SM_CLOCK * SMS * SM_CLOCK_HZ)
    return dict(bound_ms=max(bytes_ms, ops_ms, exp_ms) * 1e3,
                bound_by="bytes" if bytes_ms >= max(ops_ms, exp_ms)
                else "operations",
                ops_bound_ms=ops_ms * 1e3, exp_bound_ms=exp_ms * 1e3,
                bytes_bound_ms=bytes_ms * 1e3,
                fma_bound_ms=flops / PEAK_FLOPS["float32"] * 1e3)


def attention_inputs(bh, nq, nk, d, dtype, seed, device):
    import torch

    from regtr_tpu_torch.ops.attention import NEG_BIAS

    g = torch.Generator(device="cpu").manual_seed(seed)
    q, k, v, do = (torch.randn(bh, n, d, generator=g)
                   for n in (nq, nk, nk, nq))
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, :4] = True
    mask[0] = False                      # one slice with every key masked
    bias = torch.where(mask, 0.0, NEG_BIAS).float()
    return [x.to(device=device, dtype=dtype) for x in (q, k, v)] + [
        bias.to(device), do.to(device=device, dtype=dtype)]


def _excess(got, ref, tol, scale=None):
    """max over elements of |got - ref| - tol * (scale or |ref|): <= tol
    passes (atol = rtol = tol, or atol = tol * scale)."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if scale is None:
        return float((err - tol * ref.abs()).max())
    return float((err - tol * ref.abs()).max()) / max(scale, 1e-30)


def phase_attention(train_n, protocol_n, trainer_shape, modelnet_shape):
    """K1 (with lse) and the backward kernels against the plain versions.

    Returns the numbers of the kernels line: K1 at the inference shape in
    bf16 and at the training, protocol and ModelNet protocol (phase 9's)
    shapes in fp32, the backward kernels at the training shape, and all
    three at the trainer's shape (phase 8's, bf16)."""
    import torch
    import torch.nn.functional as F

    from regtr_tpu_torch.ops.attention import (
        _fwd, attention_delta, flash_attn_bwd_dkv, flash_attn_bwd_dq,
        flash_masked_attention, flash_masked_attention_bwd_reference,
        flash_masked_attention_reference)

    log("== phase 3: attention kernels vs plain versions")
    infer_shape = (64, 1872, 1872, 32)   # 8 clouds x 8 heads, coarse level
    train_shape = (32, train_n, train_n, 32)   # 4 clouds x 8 heads
    # the test protocol: 2 clouds x 8 heads at the model's largest bucket
    protocol_shape = (16, protocol_n, protocol_n, 32)
    result = {}
    for shape in [infer_shape, train_shape, protocol_shape, trainer_shape,
                  modelnet_shape, (8, 1000, 1313, 16), (5, 777, 2049, 64), (3, 65, 7, 32),
                  (2, 17, 9, 16), (4, 2241, 130, 32)]:
        for name in ("bfloat16", "float32"):
            dtype = getattr(torch, name)
            bh, nq, nk, d = shape
            q, k, v, bias, do = attention_inputs(*shape, dtype, 1, DEVICE)
            scale = d ** -0.5
            out = flash_masked_attention(q, k, v, bias, scale)
            again = flash_masked_attention(q, k, v, bias, scale)
            out2, lse = _fwd(q, k, v, bias, scale, True)
            ref, ref_lse = flash_masked_attention_reference(
                q, k, v, bias, scale, return_lse=True)
            torch.cuda.synchronize()
            err = float((out[1:].float() - ref[1:].float()).abs().max())
            lse_err = float((lse - ref_lse).abs().max())
            log(f"  {shape} {name}: forward max abs err {err:.3e} "
                f"(tol {TOL[name]:g} abs + rel), lse {lse_err:.3e} (tol "
                f"{TOL_LSE:g} abs + 1e-6 rel)")
            check(out.dtype == dtype and out.shape == q.shape,
                  f"{shape} {name} dtype/shape")
            check(torch.equal(out, again) and torch.equal(out, out2),
                  f"{shape} {name} forward bitwise equal over two launches "
                  "and the lse launch")
            check(bool(torch.isfinite(out[0].float()).all())
                  and bool(torch.isfinite(lse).all()),
                  f"{shape} {name} fully masked row and lse finite")
            check(_excess(out[1:], ref[1:], TOL[name]) <= TOL[name],
                  f"{shape} {name} forward within tolerance")
            check(float(((lse - ref_lse).abs() - 1e-6 * ref_lse.abs())
                        .max()) <= TOL_LSE, f"{shape} {name} lse within "
                  "tolerance")
            # backward: kernels vs plain, on the kernel forward's out, lse
            delta = attention_delta(out, do)
            dk, dv, db = flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta,
                                            scale, True)
            dq = flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, scale)
            refs = flash_masked_attention_bwd_reference(q, k, v, bias, out,
                                                        lse, do, scale)
            again = (flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, scale),
                     *flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta,
                                         scale, True))
            torch.cuda.synchronize()
            check(all(torch.equal(a, b) for a, b in
                      zip((dq, dk, dv, db), again)),
                  f"{shape} {name} dq, dk, dv, dbias bitwise equal over two "
                  "launches of each kernel")
            errs = {}
            for gname, got, r in zip(("dq", "dk", "dv", "dbias"),
                                     (dq, dk, dv, db), refs):
                check(got.dtype == r.dtype and got.shape == r.shape
                      and bool(torch.isfinite(got.float()).all()),
                      f"{shape} {name} {gname} dtype/shape/finite")
                errs[gname] = float((got.float() - r.float()).abs().max())
                scale_r = float(r.float().abs().max())
                check(_excess(got, r, TOL_BWD[name], max(scale_r, 1.0))
                      <= TOL_BWD[name],
                      f"{shape} {name} {gname} within tolerance (max abs "
                      f"err {errs[gname]:.3e}, largest |grad| "
                      f"{scale_r:.3e})")
            if (shape, name) in ((protocol_shape, "float32"),
                                 (modelnet_shape, "float32")):
                result[(shape, name)] = {"fwd": _time_forward(
                    shape, name, q, k, v, bias, scale, err, F)}
            if (shape, name) not in ((infer_shape, "bfloat16"),
                                     (train_shape, "float32"),
                                     (train_shape, "bfloat16"),
                                     (trainer_shape, "bfloat16")):
                continue
            result[(shape, name)] = _time_attention(
                shape, name, q, k, v, bias, do, out, lse, delta, scale, errs,
                err, F)
            if (shape, name) == (train_shape, "float32"):
                result[(shape, name)]["fp64"] = _fp64_errors(
                    q, k, v, bias, do, scale, (dq, dk, dv, db), refs)
    return result


def phase_key_extents(modelnet_shape):
    """K1 with key extents against K1 with a null extent, fp32: out and
    lse bitwise, the key tiles run (under a profiler), CUDA-event times of
    both (medians of 30 single launches and of 30 runs of 10 back to back)
    beside the bound over the valid work.  At the inference cell's coarse
    level (prefix masks of 280-420 valid keys a slice: the cell's ~350 of
    2240) and at ModelNet's shape with every key valid, where nothing is
    left to skip and the extents must cost nothing."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from regtr_tpu_torch.ops import attention

    log("== phase 3a: K1 with key extents")
    found = []
    for what, shape, lengths in (
            ("inference cell", (64, 2240, 2240, 32), (280, 420)),
            ("modelnet, every key valid", modelnet_shape, None)):
        bh, nq, nk, d = shape
        g = torch.Generator().manual_seed(nk)
        q, k, v = (torch.randn(bh, nk, d, generator=g).to(DEVICE)
                   for _ in range(3))
        valid = (torch.full((bh,), nk) if lengths is None else
                 torch.randint(lengths[0], lengths[1] + 1, (bh,),
                               generator=g))
        mask = torch.arange(nk)[None, :] < valid[:, None]
        bias = torch.where(mask, 0.0, attention.NEG_BIAS).float().to(DEVICE)
        ext = attention.key_extents(mask.to(DEVICE))
        scale = d ** -0.5
        full = attention._fwd(q, k, v, bias, scale, True)
        attention.flash_masked_attention.key_tiles = None
        with profile(activities=[ProfilerActivity.CPU]):
            cut = attention._fwd(q, k, v, bias, scale, True, ext)
        run, grid = attention.flash_masked_attention.key_tiles.tolist()
        attention.flash_masked_attention.key_tiles = None
        check(torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1]),
              f"{what} {shape}: out and lse with key extents bitwise those "
              "without")
        times = {}
        for how, e in (("extents", ext), ("null", None)):
            fn = (lambda e=e: attention._fwd(q, k, v, bias, scale, False, e))
            times[how] = (cuda_ms(fn), cuda_ms(fn, reps=10))
        b = attention_fwd_bounds(shape, "float32", valid.tolist())
        log(f"  {what} {shape}: valid keys {int(valid.min())}-"
            f"{int(valid.max())} (mean {float(valid.float().mean()):.0f}); "
            f"key tiles run {run} of {grid} ({100 * run / grid:.1f} %); "
            f"with extents {times['extents'][0]:.4f} ms, b2b "
            f"{times['extents'][1]:.4f}; null {times['null'][0]:.4f}, b2b "
            f"{times['null'][1]:.4f}; bound over the valid work "
            f"{b['bound_ms']:.4f} ({b['bound_by']}; "
            f"{b['bound_ms'] / times['extents'][1] * 100:.1f} % of it b2b)")
        found.append(dict(
            what=what, shape=list(shape), dtype="float32",
            valid_keys=[int(valid.min()), int(valid.max())],
            key_tiles_run=run, key_tiles_grid=grid,
            ms=times["extents"][0], back_to_back_ms=times["extents"][1],
            null_extent_ms=times["null"][0],
            null_extent_back_to_back_ms=times["null"][1],
            valid_bound_ms=b["bound_ms"], valid_bound_by=b["bound_by"]))
    return found


def _fp64_errors(q, k, v, bias, do, scale, kernel, plain):
    """max |err| / max |grad| of the kernels' and the plain version's fp32
    gradients against an fp64 backward, on the slices with a valid key (in
    the fully masked one fp32 rounds the scores into the -1e9 bias)."""
    from kernel_variants import fp64_backward

    truth = fp64_backward(*(x[1:] for x in (q, k, v, bias, do)), scale)
    found = {}
    for who, grads in (("kernel", kernel), ("plain", plain)):
        found[who] = {
            nm: float((g[1:].double() - t).abs().max() / t.abs().max())
            for nm, g, t in zip(("dq", "dk", "dv", "dbias"), grads, truth)}
    log("    against an fp64 backward (max |err| / max |grad|): " + "; ".join(
        f"{who} " + ", ".join(f"{nm} {e:.2e}" for nm, e in errs.items())
        for who, errs in found.items()))
    return found


def _time_forward(shape, name, q, k, v, bias, scale, fwd_err, F):
    """K1's time beside its bounds, its plain version and SDPA."""
    from regtr_tpu_torch.ops.attention import (
        _fwd, flash_masked_attention_reference)

    bh, nq, nk, d = shape
    ms = cuda_ms(lambda: _fwd(q, k, v, bias, scale, False))
    plain_ms = cuda_ms(lambda: flash_masked_attention_reference(
        q, k, v, bias, scale))
    # the library yardstick: one SDPA call with the additive bias as its mask
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=bias[:, None, :], scale=scale))
    b = attention_fwd_bounds(shape, name)
    rate = "bf16 mma" if name == "bfloat16" else "3xTF32"
    log(f"  {shape} {name}: forward kernel {ms:.4f} ms, "
        f"{4 * bh * nq * nk * d / ms / 1e9:.2f} TFLOP/s; bound "
        f"{b['bound_ms']:.4f} ms ({b['bound_by']}; {b['bound_ms'] / ms * 100:.1f}"
        f" % of it): exponentials {b['exp_bound_ms']:.4f} (MUFU only, at "
        f"{SM_CLOCK_HZ / 1e6:.0f} MHz), products {b['ops_bound_ms']:.4f} "
        f"({rate}; {b['ops_bound_ms'] / ms * 100:.1f} % of it), bytes "
        f"{b['bytes_bound_ms']:.4f}; FMA bound {b['fma_bound_ms']:.4f}; "
        f"plain {plain_ms:.4f}, SDPA {lib_ms:.4f} ms (medians of 30, CUDA "
        f"events)")
    return dict(max_abs_err=fwd_err, ms=ms, plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b["bound_ms"],
                bound_by=b["bound_by"], exp_bound_ms=b["exp_bound_ms"],
                fma_bound_ms=b["fma_bound_ms"])


def _time_attention(shape, name, q, k, v, bias, do, out, lse, delta, scale,
                    errs, fwd_err, F):
    import torch

    from regtr_tpu_torch.ops.attention import (
        flash_attn_bwd_dkv, flash_attn_bwd_dq,
        flash_masked_attention_bwd_reference)

    bh, nq, nk, d = shape
    width = 2 if name == "bfloat16" else 4
    fwd = _time_forward(shape, name, q, k, v, bias, scale, fwd_err, F)
    dkv_ms = cuda_ms(lambda: flash_attn_bwd_dkv(q, k, v, bias, do, lse,
                                                delta, scale, True))
    dq_ms = cuda_ms(lambda: flash_attn_bwd_dq(q, k, v, bias, do, lse, delta,
                                              scale))
    plain_bwd_ms = cuda_ms(lambda: flash_masked_attention_bwd_reference(
        q, k, v, bias, out, lse, do, scale))
    # the library yardstick: SDPA forward + backward (dq, dk, dv) with the
    # additive bias as its mask, less its forward
    mask4 = bias[:, None, :]
    qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask4,
                                           scale=scale)
        torch.autograd.grad(o, (qs, ks, vs), do)

    lib_bwd_ms = cuda_ms(sdpa_fwd_bwd) - fwd["library_ms"]
    n2d = bh * nq * nk * d
    rows = bh * (nq + nk)
    # dkv reads q, k, v, dO, bias, lse, delta; writes dk, dv, dbias.  The
    # fp32 backward runs 3xTF32 on the tensor cores: its bound is at that
    # rate, with the CUDA cores' FMA bound (the yardstick of an FMA design)
    # beside it.
    dkv_bytes = ((2 * rows * d + 2 * bh * nk * d) * width
                 + (2 * bh * nk + 2 * bh * nq) * 4)
    dq_bytes = ((2 * rows * d + bh * nq * d) * width
                + (bh * nk + 2 * bh * nq) * 4)
    bwd_rate = "3xtf32" if name == "float32" else name
    dkv_bound = bound(8 * n2d, dkv_bytes, bwd_rate)
    dq_bound = bound(6 * n2d, dq_bytes, bwd_rate)
    dkv_fma = bound(8 * n2d, dkv_bytes, "float32")
    dq_fma = bound(6 * n2d, dq_bytes, "float32")
    log(f"  {shape} {name}: backward plain {plain_bwd_ms:.4f}, SDPA backward "
        f"{lib_bwd_ms:.4f} ms (medians of 30, CUDA events)")
    for what, ms, flops, bnd, fma in (("dkv", dkv_ms, 8 * n2d, dkv_bound,
                                       dkv_fma),
                                      ("dq", dq_ms, 6 * n2d, dq_bound,
                                       dq_fma)):
        tflops = flops / ms / 1e9
        log(f"    {what} {ms:.4f} ms, {tflops:.2f} TFLOP/s: bound "
            f"{bnd[0]:.4f} ms at {PEAK_FLOPS[bwd_rate] / 1e12:.0f} TFLOP/s "
            f"({bwd_rate}, {bnd[1]}; {bnd[0] / ms * 100:.1f} % of it), FMA "
            f"bound {fma[0]:.4f} ms at 67 TFLOP/s ({fma[0] / ms * 100:.1f} "
            f"% of it)")
    return {
        "fwd": fwd,
        "dkv": {"max_abs_err": max(errs["dk"], errs["dv"], errs["dbias"]),
                "ms": dkv_ms, "plain_ms": plain_bwd_ms,
                "bound_ms": dkv_bound[0], "bound_by": dkv_bound[1],
                "fma_bound_ms": dkv_fma[0], "library_ms": lib_bwd_ms},
        "dq": {"max_abs_err": errs["dq"], "ms": dq_ms,
               "plain_ms": plain_bwd_ms, "bound_ms": dq_bound[0],
               "bound_by": dq_bound[1], "fma_bound_ms": dq_fma[0],
               "library_ms": lib_bwd_ms},
    }


def neighbor_like_ids(gen, clouds, n, k):
    """Flat ids as a level's neighbor table gives them for `clouds` clouds
    of n points, each followed by its pad (shadow) row: a query's K
    neighbors near it in the spatially sorted order, a third of the slots
    the shadow row.  (clouds * n * k,) int64 on the card."""
    import torch

    q = torch.arange(n)[None, :, None]
    near = (q + torch.randint(-256, 257, (clouds, n, k), generator=gen)
            ).clamp(0, n - 1)
    shadow = torch.rand(clouds, n, k, generator=gen) < 0.3
    ids = (torch.where(shadow, n, near)
           + torch.arange(clouds)[:, None, None] * (n + 1))
    return ids.reshape(-1).to(DEVICE)


def _time_row_gather(table, ids, what):
    """K5a bitwise against index_select on one table and ids, and timed in
    turns with it (kernel, index_select, index_select, kernel: the two are
    close on the narrow rows, and a card's memory rate drifts between
    calls), as single launches and in runs of 10 back-to-back calls,
    beside the bound of the bytes it moves."""
    import torch

    from regtr_tpu_torch.ops.gather import row_gather, row_gather_reference

    got = row_gather(table, ids)
    ref = row_gather_reference(table, ids)
    torch.cuda.synchronize()
    err = float((got.float() - ref.float()).abs().max())
    width = str(ids.dtype)[6:]
    check(torch.equal(got, ref), f"row gather {what} ({ids.shape[0]} rows x "
          f"{table.shape[1]} {table.dtype}, {width} ids) bitwise equal to "
          "index_select")
    def in_turns(reps):
        return [cuda_ms(lambda: row_gather(table, ids), reps=reps),
                cuda_ms(lambda: torch.index_select(table, 0, ids), reps=reps),
                cuda_ms(lambda: torch.index_select(table, 0, ids), reps=reps),
                cuda_ms(lambda: row_gather(table, ids), reps=reps)]

    turns, b2b = in_turns(1), in_turns(10)
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    b2b_ms, b2b_lib_ms = (b2b[0] + b2b[3]) / 2, (b2b[1] + b2b[2]) / 2
    plain_ms = cuda_ms(lambda: row_gather_reference(table, ids))
    item = table.element_size()
    # reads the table and the ids (at their width), writes the rows; no
    # arithmetic
    bnd = bound(0, table.numel() * item + ids.numel() * ids.element_size()
                + got.numel() * item, "float32")
    log(f"  row gather {what}, {width} ids: kernel {ms:.4f} ms (bound "
        f"{bnd[0]:.4f}, {bnd[1]}; {bnd[0] / ms * 100:.1f} % of it), plain "
        f"{plain_ms:.4f}, index_select {lib_ms:.4f} ms ({lib_ms / ms:.2f}x "
        f"the kernel's time; turns kernel {turns[0]:.4f} / {turns[3]:.4f}, "
        f"index_select {turns[1]:.4f} / {turns[2]:.4f}; medians of 30 single "
        f"launches, CUDA events); back to back (runs of 10 calls): kernel "
        f"{b2b_ms:.4f} ({bnd[0] / b2b_ms * 100:.1f} % of the bound), "
        f"index_select {b2b_lib_ms:.4f} (turns kernel {b2b[0]:.4f} / "
        f"{b2b[3]:.4f}, index_select {b2b[1]:.4f} / {b2b[2]:.4f})")
    return dict(what=what, shape=[ids.shape[0], table.shape[1]],
                dtype=str(table.dtype)[6:], ids=width, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bnd[0], bound_by=bnd[1],
                library_ms=lib_ms, turns=turns,
                faster_in_every_turn=max(turns[0], turns[3])
                < min(turns[1], turns[2]),
                back_to_back_ms=b2b_ms, back_to_back_library_ms=b2b_lib_ms,
                back_to_back_turns=b2b,
                faster_in_every_back_to_back_turn=max(b2b[0], b2b[3])
                < min(b2b[1], b2b[2]))


def phase_gather(train_n0):
    """K5 against its plain versions (index_select, torch.gather), bitwise:
    the row gather at the main path's shapes and at ragged ones, the
    element gather on both axes, 2-D and batched.  Returns the kernels
    line's numbers."""
    import torch

    from regtr_tpu_torch.ops.gather import (element_gather,
                                            element_gather_reference,
                                            row_gather, row_gather_reference)

    log("== phase 3b: gather kernels (K5) vs index_select / torch.gather")
    gen = torch.Generator().manual_seed(5)
    rows_result = []
    # the main path's gathers take a table's int32 flat ids; the coordinate
    # rows (the narrow path) are timed with int64 ids too
    for clouds, n, k, c, dtype, id_dtypes, what in (
            (2 * N_PAIRS, N0, 32, 32, torch.bfloat16, (torch.int32,),
             "inference features"),
            (2 * N_PAIRS, N0, 32, 3, torch.float32,
             (torch.int32, torch.int64), "inference coordinates"),
            (4, train_n0, 32, 32, torch.float32, (torch.int32,),
             "training features")):
        table = torch.randn(clouds * (n + 1), c, generator=gen).to(DEVICE,
                                                                   dtype)
        ids64 = neighbor_like_ids(gen, clouds, n, k)
        for id_dtype in id_dtypes:
            ids = ids64.to(id_dtype)
            rows_result.append(_time_row_gather(table, ids, what))
        del table, ids, ids64
    # ragged widths (every vector width) and row counts off every block
    for c in (1, 3, 7, 32, 65, 128):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(3001, c, generator=gen).to(DEVICE, dtype)
            ids = torch.randint(0, 3000, (70002,), generator=gen).to(DEVICE)
            shifted = table.view(-1)[1:1 + 3000 * c].view(3000, c)
            same = all(torch.equal(row_gather(tab, i.to(id_dtype)),
                                   row_gather_reference(tab, i))
                       for tab in (table, shifted)
                       for i in (ids[:70001], ids[1:])
                       for id_dtype in (torch.int32, torch.int64))
            check(same, f"row gather 70001 x {c} {dtype} (aligned and "
                  "offset table, int32 and int64 ids, aligned and off 16 "
                  "bytes) bitwise equal to index_select")
    def element_case(shape, axis, dtype, what="", offset=0, batch_pad=0):
        """src of `shape` (3-D: a batch stride `batch_pad` rows larger than
        its slice), `offset` elements past an allocation's start; idx at
        the same offset."""
        lead, rows, cols = (1, *shape) if len(shape) == 2 else shape
        full = torch.randn(lead * (rows + batch_pad) * cols + offset,
                           generator=gen).to(DEVICE, dtype)
        src = full[offset:].view(lead, rows + batch_pad, cols)[:, :rows]
        n_idx = (rows, cols)[axis]
        flat = torch.randint(0, n_idx, (lead * rows * cols + offset,),
                             generator=gen).to(DEVICE)
        idx = flat[offset:].view(lead, rows, cols)
        if len(shape) == 2:
            src, idx = src[0], idx[0]
        got = element_gather(src, idx, axis)
        ref = element_gather_reference(src, idx, axis)
        torch.cuda.synchronize()
        check(torch.equal(got, ref), f"element gather {shape} axis {axis} "
              f"{dtype}{what} bitwise equal to torch.gather")
        return src, idx, got, ref

    for shape, axis, dtype in (((5120, 32), 0, torch.float32),
                               ((5120, 32), 1, torch.float32),
                               ((5120, 32), 0, torch.bfloat16),
                               ((5120, 32), 1, torch.bfloat16),
                               ((160, 5120, 32), 0, torch.bfloat16),
                               ((4, 8, 20000), 1, torch.float32),
                               ((2, 3, 70000), 1, torch.float32),
                               ((2, 3, 120000), 1, torch.bfloat16)):
        element_case(shape, axis, dtype, " (rows of "
                     f"{shape[-1] * (4 if dtype == torch.float32 else 2)} "
                     "bytes)" if axis == 1 else "")
    for axis in (0, 1):
        for dtype in (torch.float32, torch.bfloat16):
            element_case((6, 40, 3001), axis, dtype,
                         ", batch stride 7 rows larger than its slice, "
                         "src and idx 1 element off 16 bytes", offset=1,
                         batch_pad=7)
    # the batched probe at one level-0 cloud's tiles, timed
    shape, axis = (160, 32, 5120), 1
    src, idx, got, ref = element_case(shape, axis, torch.float32)
    err = float((got.float() - ref.float()).abs().max())
    # kernel and torch.gather in turns (kernel, library, library, kernel):
    # the two are close, and a card's memory rate drifts between calls
    turns = [cuda_ms(lambda: element_gather(src, idx, axis)),
             cuda_ms(lambda: torch.gather(src, 2, idx)),
             cuda_ms(lambda: torch.gather(src, 2, idx)),
             cuda_ms(lambda: element_gather(src, idx, axis))]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    plain_ms = cuda_ms(lambda: element_gather_reference(src, idx, axis))
    # reads each source row, each index once; writes each output once
    bnd = bound(0, src.numel() * 4 + idx.numel() * 8 + got.numel() * 4,
                "float32")
    log(f"  element gather {shape} axis {axis} fp32: kernel {ms:.4f} ms "
        f"(bound {bnd[0]:.4f}, {bnd[1]}; {bnd[0] / ms * 100:.1f} % of it), "
        f"plain {plain_ms:.4f}, torch.gather {lib_ms:.4f} ms "
        f"({lib_ms / ms:.2f}x the kernel's time; turns kernel "
        f"{turns[0]:.4f} / {turns[3]:.4f}, torch.gather {turns[1]:.4f} / "
        f"{turns[2]:.4f}; medians of 30, CUDA events)")
    return rows_result, dict(shape=list(shape), axis=axis, dtype="float32",
                             max_abs_err=err, ms=ms, plain_ms=plain_ms,
                             bound_ms=bnd[0], bound_by=bnd[1],
                             library_ms=lib_ms)


def recorded_searches(cfg, pts, mask):
    """The brute searches of one pyramid of cfg over (pts, mask) on the
    card, in build_pyramid's order, recorded where the pyramid calls them:
    [(name, (queries, q_mask, supports, s_mask, radius, k))]."""
    from regtr_tpu_torch.ops import pyramid

    spec = pyramid.make_pyramid_spec(cfg, pts.shape[1])
    calls, real = [], pyramid.radius_neighbors_batch

    def record(*args, **kw):
        calls.append(args)
        return real(*args, **kw)

    pyramid.radius_neighbors_batch = record
    try:
        pyramid.build_pyramid(pts, mask, spec)
    finally:
        pyramid.radius_neighbors_batch = real
    names = [f"L{li} {what}" for li in range(spec.num_levels)
             for what in (("neighbors", "pools", "upsamples")
                          if li + 1 < spec.num_levels else ("neighbors",))]
    check(len(calls) == len(names) == searches_per_pyramid(cfg),
          f"{len(calls)} searches in one pyramid of {spec.capacities}")
    return list(zip(names, calls))


# K6's times in its first design (one thread a query, every tile scanned;
# PERF.md section 6, NVIDIA H100 80GB HBM3, 700.00 W), by phase 3c's
# search names
FIRST_DESIGN_MS = {
    "L0 neighbors": 2.2507, "L0 pools": 1.9096, "L0 upsamples": 1.4712,
    "L1 neighbors": 1.1516, "L1 pools": 1.1983, "L1 upsamples": 0.8823,
    "L2 neighbors": 0.8612, "L2 pools": 0.5808, "L2 upsamples": 0.5972,
    "L3 neighbors": 0.3778, "ModelNet L0 neighbors": 0.4366,
    "ModelNet L0 pools": 0.5298, "ModelNet L0 upsamples": 0.1511,
    "ModelNet L1 neighbors": 0.1602, "L2 into 150 of L3": 0.3962}
FIRST_DESIGN_FORWARD_MS = 11.281
CULL_GRAIN = 32        # the culled bound's queries x supports of sorted order


def culled_candidates(args, grain=CULL_GRAIN):
    """The (valid query, valid support) pairs of the grain x grain blocks
    of the sorted order that ops/neighbors.py `tile_may_accept` (the
    kernel's culling test, mirrored) keeps at the threshold's bound."""
    import torch

    from regtr_tpu_torch.ops import neighbors

    queries, q_mask, supports, s_mask, radius, k = args
    lim = neighbors.hot_bound(neighbors.acceptance_threshold(radius),
                              supports.shape[1] >= 4 * k)
    q_lo, q_hi = neighbors.run_boxes(queries, q_mask, grain)
    s_lo, s_hi = neighbors.run_boxes(supports, s_mask, grain)
    keep = neighbors.tile_may_accept(q_lo[:, :, None], q_hi[:, :, None],
                                     s_lo[:, None], s_hi[:, None], lim)

    def valid(mask):
        b, n = mask.shape
        pad = torch.zeros(b, -n % grain, dtype=torch.bool, device=mask.device)
        return torch.cat([mask, pad], 1).reshape(b, -1, grain).sum(-1)

    return float((keep.double() * valid(q_mask)[:, :, None].double()
                  * valid(s_mask)[:, None, :].double()).sum())


def search_bound(args):
    """K6's least times (ms) on these inputs: 8 fp32 operations a
    candidate (the 3-term dot, the doubling, two adds, the compare) on the
    CUDA cores over (a) every valid query times every valid support (the
    brute bound) and (b) the candidates the culling test keeps at a
    32 x 32 grain (`culled_candidates`); (c) the bytes of the inputs read
    once and the int64 table written once.  bound_ms is the larger of (b)
    and (c)."""
    queries, q_mask, supports, s_mask, _, k = args
    b, nq, ns = queries.shape[0], queries.shape[1], supports.shape[1]
    brute = float((q_mask.sum(1).double() * s_mask.sum(1).double()).sum())
    culled = culled_candidates(args)
    nbytes = b * (nq + ns) * 13 + b * nq * k * 8
    bound_ms, bound_by = bound(8 * culled, nbytes, "float32")
    return dict(bound_ms=bound_ms, bound_by=bound_by,
                brute_bound_ms=8 * brute / PEAK_FLOPS["float32"] * 1e3,
                culled_bound_ms=8 * culled / PEAK_FLOPS["float32"] * 1e3,
                bytes_bound_ms=nbytes / PEAK_BYTES * 1e3,
                candidates=brute, culled_candidates=culled)


def _share(bound_ms, ms):
    """A bound's share of a time, in percent, or '> 100 %' where the
    kernel beats a bound counted at a coarser grain than it culls."""
    pct = bound_ms / ms * 100
    return (f"{pct:.1f} %" if pct <= 100 else
            "> 100 % (the kernel culls finer than the 32 x 32 count)")


def check_search(name, args, plain_iters=3, iters=20, b2b=True):
    """K6 on one search's inputs: bitwise its plain version and itself over
    two launches, CUDA-event times of both beside the bounds and the first
    design's time.  The first design's time, typed in from PERF.md, goes
    to the log line only: the returned numbers are this run's."""
    import torch

    from regtr_tpu_torch.ops import neighbors

    queries, q_mask, supports, s_mask, radius, k = args
    got = neighbors.brute_radius_neighbors(*args)
    again = neighbors.brute_radius_neighbors(*args)
    ref = neighbors.brute_radius_neighbors_plain(*args)
    torch.cuda.synchronize()
    ns = supports.shape[1]
    rows = int(((got != ref).any(-1)).sum())
    err = float((got - ref).abs().max())
    check(torch.equal(got, ref) and torch.equal(got, again),
          f"K6 {name} ({queries.shape[0]} x {queries.shape[1]} queries, "
          f"{ns} supports, r {radius}, K {k}, "
          f"{'bf16' if ns >= 4 * k else 'fp32'} key): bitwise the plain "
          f"version "
          f"({rows} rows differ) and over two launches")
    ms = cuda_ms(lambda: neighbors.brute_radius_neighbors(*args), iters=iters)
    b2b_ms = (cuda_ms(lambda: neighbors.brute_radius_neighbors(*args),
                      iters=10, reps=10) if b2b else None)
    plain_ms = cuda_ms(lambda: neighbors.brute_radius_neighbors_plain(*args),
                       iters=plain_iters, warmup=1)
    bnd = search_bound(args)
    filled = (got < ns).sum(-1).float()[q_mask]
    before = FIRST_DESIGN_MS.get(name)
    vs = (f" (first design: {before:.4f}, {ms / before:.2f}x)" if before
          else "")
    b2b_text = f" (back to back {b2b_ms:.4f})" if b2b else ""
    log(f"    {name}: kernel {ms:.4f} ms{b2b_text}{vs}, plain "
        f"{plain_ms:.3f} ms; "
        f"bounds: culled {bnd['culled_bound_ms']:.4f} ms "
        f"({_share(bnd['culled_bound_ms'], ms)}), bytes "
        f"{bnd['bytes_bound_ms']:.4f} ms ({_share(bnd['bytes_bound_ms'], ms)}"
        f"), brute {bnd['brute_bound_ms']:.4f} ms; culled candidates "
        f"{bnd['culled_candidates'] / max(bnd['candidates'], 1) * 100:.1f} % "
        f"of valid x valid; mean neighbors {float(filled.mean()):.1f}, rows "
        f"full {float((filled == k).float().mean()) * 100:.1f} %")
    return dict(what=name, shape=[queries.shape[0], queries.shape[1], ns, k],
                radius=radius, key="bfloat16" if ns >= 4 * k else "float32",
                max_abs_err=err, ms=ms, back_to_back_ms=b2b_ms,
                plain_ms=plain_ms, **bnd)


def threshold_shells(r, k, roll, device="cpu"):
    """Queries near the origin with supports in tight clusters of 128 at r
    sqrt(1.004) (1 -+ 2^-8), the edge of the threshold, and at finer steps
    of 2^-12 across it, where a bf16 key accepts distances above the fp32
    threshold; a cluster a kernel tile, or (roll) each tile over two
    clusters: (queries, q_mask, supports, s_mask, r, k), 100 m from the
    origin in the second cloud."""
    import torch

    rng = np.random.RandomState(5)
    rho = r * np.sqrt(1.004)
    centers = rng.uniform(-0.2, 0.2, (6, 3))
    steps = [1 - 2.0 ** -8, 1 + 2.0 ** -8] + [1 + j * 2.0 ** -12
                                              for j in range(-6, 7)]
    clusters = []
    for c in centers:
        for f in steps:
            u = rng.randn(3)
            u /= np.linalg.norm(u)
            clusters.append(c + rho * f * u + rng.randn(128, 3) * 1e-7)
    s = np.roll(np.concatenate(clusters), roll, axis=0)
    q = np.repeat(centers, 8, 0)
    qs = np.stack([q, q + 100.0]).astype(np.float32)
    ss = np.stack([s, s + 100.0]).astype(np.float32)
    return (torch.from_numpy(qs).to(device),
            torch.ones(2, len(q), dtype=torch.bool, device=device),
            torch.from_numpy(ss).to(device),
            torch.ones(2, len(s), dtype=torch.bool, device=device), r, k)


def adversarial_searches(searches):
    """K6's cases beyond the pyramids' searches, from phase 5's searches:
    [(name, args)]."""
    import torch

    q, qm, s, sm, r, k = searches[0][1]          # L0 neighbors
    l3 = searches[9][1]
    cases = [
        ("L0 neighbors, one pair 100 m away",
         (q[:2] + 100.0, qm[:2], s[:2] + 100.0, sm[:2], r, k)),
        ("L0 neighbors, K 200 (above every count)",
         (q[:2], qm[:2], s[:2], sm[:2], r, 200)),
        ("L0 neighbors, K 256 (the most)",
         (q[:2], qm[:2], s[:2], sm[:2], r, 256)),
        ("a single tile, bf16 key (L3 into 100 of L3, K 16)",
         (l3[0], l3[1], l3[2][:, :100].contiguous(),
          l3[3][:, :100].contiguous(), l3[4], 16)),
        ("a single tile, fp32 key (L3 into 128 of L3)",
         (l3[0], l3[1], l3[2][:, :128].contiguous(),
          l3[3][:, :128].contiguous(), l3[4], l3[5])),
        ("64-bit words (Ns >= 65536: four L0 clouds as one)",
         (q[:2, :4096].contiguous(), qm[:2, :4096].contiguous(),
          s.reshape(2, -1, 3).contiguous(), sm.reshape(2, -1).contiguous(),
          r, k)),
    ]
    for r_, k_ in ((0.0625, 32), (0.075, 32), (0.5, 200)):
        for roll in (0, 48):
            cases.append((f"threshold shells r {r_} K {k_} roll {roll}",
                          threshold_shells(r_, k_, roll, DEVICE)))
    q, qm, s, sm, r, _ = threshold_shells(0.075, 256, 48, DEVICE)
    cases.append(("threshold shells r 0.075 K 256 on 1000 supports, fp32 "
                  "key", (q, qm, s[:, :1000], sm[:, :1000], r, 256)))
    return [(n, tuple(a.contiguous() if isinstance(a, torch.Tensor) else a
                      for a in args)) for n, args in cases]


def phase_neighbors():
    """Phase 3c: K6 against its plain version on the card, bitwise, on the
    ten searches of phase 5's pyramid, the four of a ModelNet pair's, a
    constructed fp32-key case (Ns < 4K) and the adversarial cases; times
    beside the bounds and the first design's.  Returns the kernels line's
    numbers."""
    import torch

    from regtr_tpu_torch.config import modelnet_config, threedmatch_config
    from regtr_tpu_torch.data import get_dataset
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.ops import neighbors

    log("== phase 3c: the brute neighbor search (K6) against its plain "
        "version")
    for r in (0.0625, 0.125, 0.25, 0.5, 1.0, 0.0825, 0.165):
        plain = torch.full((), r * r, dtype=torch.float32,
                           device=DEVICE) * 1.004
        check(float(plain) == neighbors.acceptance_threshold(r),
              f"radius {r}: the kernel's threshold is the plain version's "
              f"r^2 * 1.004 on the card ({float(plain)!r})")
    cfg = threedmatch_config()
    pts_np, mask_np = synthetic_pairs(N_PAIRS, N_POINTS, seed=0)
    pts = torch.from_numpy(pts_np).to(DEVICE)
    mask = torch.from_numpy(mask_np).to(DEVICE)
    searches = recorded_searches(cfg, pts, mask)
    log(f"  phase 5's pyramid ({N_PAIRS} pairs at bucket {N0}; "
        f"{card_line()}):")
    main = [check_search(name, args) for name, args in searches]
    total = {key: sum(e[key] for e in main)
             for key in ("ms", "back_to_back_ms", "plain_ms", "bound_ms",
                         "brute_bound_ms", "culled_bound_ms",
                         "bytes_bound_ms")}
    # what bounds the most of the summed bound
    total["bound_by"] = max(("operations", "bytes"), key=lambda by: sum(
        e["bound_ms"] for e in main if e["bound_by"] == by))
    log(f"  per forward ({len(main)} launches; {card_line()}): kernel "
        f"{total['ms']:.3f} ms (first design: "
        f"{FIRST_DESIGN_FORWARD_MS:.3f} ms, "
        f"{total['ms'] / FIRST_DESIGN_FORWARD_MS:.2f}x; back to back "
        f"{total['back_to_back_ms']:.3f} ms), plain "
        f"{total['plain_ms']:.1f} ms; bounds: culled "
        f"{total['culled_bound_ms']:.3f} ms "
        f"({_share(total['culled_bound_ms'], total['ms'])}), bytes "
        f"{total['bytes_bound_ms']:.3f} ms "
        f"({_share(total['bytes_bound_ms'], total['ms'])}), brute "
        f"{total['brute_bound_ms']:.3f} ms (medians of single launches, "
        f"CUDA events)")

    mcfg = modelnet_config(root=str(MODELNET_NO_SHARDS))
    batch, _ = collate_pairs([get_dataset(mcfg, "test")[0]],
                             [max(mcfg["buckets"])])
    log(f"  a ModelNet pair's pyramid (bucket {batch['points'].shape[1]}, "
        "the dataset's synthetic stand-in):")
    modelnet = [check_search("ModelNet " + name, args)
                for name, args in recorded_searches(
                    mcfg, torch.from_numpy(batch["points"]).to(DEVICE),
                    torch.from_numpy(batch["mask"]).to(DEVICE))]

    # the fp32 key: level 2's points as queries into 150 of level 3's
    q, qm = searches[6][1][0], searches[6][1][1]
    s, sm = (x[:, :150].contiguous() for x in searches[9][1][:2])
    log("  fp32 key (Ns < 4K):")
    exact = check_search("L2 into 150 of L3", (q, qm, s, sm, 0.5, 40))
    check(exact["key"] == "float32", "the constructed case takes the fp32 "
          "key")
    log("  adversarial cases:")
    adversarial = [check_search(name, args, plain_iters=1, iters=5, b2b=False)
                   for name, args in adversarial_searches(searches)]
    return dict(main=main, total=total, modelnet=modelnet, exact=exact,
                adversarial=adversarial)


def phase_bench(pairs_per_s):
    """`python -m regtr_tpu_torch.bench` at its defaults, once: its one
    JSON line has bench.py's keys, beside phase 5's pairs/s."""
    import torch

    log("== phase 5b: python -m regtr_tpu_torch.bench")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "regtr_tpu_torch.bench"],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    took = time.perf_counter() - t0
    for line in proc.stderr.strip().splitlines()[-8:]:
        log("  " + line)
    check(proc.returncode == 0, f"the bench exited {proc.returncode}")
    lines = proc.stdout.strip().splitlines()
    record = json.loads(lines[-1])
    keys = {"metric", "value", "unit", "vs_baseline", "init_s", "compile_s",
            "lower_compile_s", "first_exec_s", "tflops", "mfu"}
    check(len(lines) == 1 and set(record) == keys
          and record["metric"] == "3dmatch_inference_throughput"
          and record["unit"] == "pairs/sec" and record["value"] > 0
          and record["tflops"] is None and record["mfu"] is None,
          f"one JSON line with bench.py's keys: {lines[-1]}")
    log(f"bench: {record['value']} pairs/s ({took:.1f} s with the process's "
        f"start) beside phase 5's {pairs_per_s:.3f} pairs/s")
    return record


GEOTR_CONFIG = ROOT / "portbench" / "configs" / "geotr-3dmatch.json"
GEOTR_N0 = 24576      # the bucket 19 000-point scans take (geotr-3dmatch)


def geotr_launches_per_forward(model):
    """Kernel launches of one forward of `model`, a
    models/geotransformer.GeoTransformer: K6, the pyramid's searches; K1,
    two a cross block (the target's update, then the source's); K5a, the
    backbone's gathers as RegTR's (the first block at each (conv or pool,
    level) table gathers its features and its neighbors' coordinates,
    later blocks the features), the decoder's two nearest upsamplings
    and the four patch gathers (level-1 features and points of both
    sides of the chosen node pairs); the geometric embedding, one; no
    other kernel."""
    seen, rows = set(), 0
    for block in model.backbone.children():
        if hasattr(block, "KPConv"):
            key = ("pool" if block.strided else "conv", block.layer_ind)
            rows += 1 if key in seen else 2
            seen.add(key)
    counts = dict.fromkeys(_counted(), 0)
    counts.update(neighbor_search=3 * model.spec.num_levels - 2,
                  flash_attn_fwd=2 * model.transformer.blocks.count("cross"),
                  row_gather=rows + 2 + 4, geo_embedding=1)
    return counts


def geotr_cross_attention():
    """K1 at GeoTransformer's cross-attention, fp32 (16, 512, 512, 64):
    4 pairs x 4 heads, queries and keys at the model's extent of
    superpoints, with key extents (alternate slices of 352 and 377 valid
    keys, and 300 in every slice): out and lse within TOL and TOL_LSE of
    the plain version and bitwise the launch without extents; CUDA-event
    times of the kernel (single and back to back), of the launch without
    extents and of the plain version, beside the bound over the valid
    work."""
    import torch

    from regtr_tpu_torch.ops import attention

    bh, n, d = 16, 512, 64
    shape = (bh, n, n, d)
    scale = d ** -0.5
    found = []
    for lengths in ((352, 377), (300, 300)):
        g = torch.Generator().manual_seed(sum(lengths))
        q, k, v = (torch.randn(bh, n, d, generator=g).to(DEVICE)
                   for _ in range(3))
        valid = torch.tensor([lengths[i % 2] for i in range(bh)])
        mask = torch.arange(n)[None, :] < valid[:, None]
        bias = torch.where(mask, 0.0, attention.NEG_BIAS).float().to(DEVICE)
        ext = attention.key_extents(mask.to(DEVICE))
        out, lse = attention._fwd(q, k, v, bias, scale, True, ext)
        full = attention._fwd(q, k, v, bias, scale, True)
        ref, ref_lse = attention.flash_masked_attention_reference(
            q, k, v, bias, scale, return_lse=True)
        err = float((out - ref).abs().max())
        lse_err = float(((lse - ref_lse).abs() - 1e-6 * ref_lse.abs()).max())
        what = f"K1 fp32 {shape}, valid keys {lengths[0]} / {lengths[1]}"
        check(_excess(out, ref, TOL["float32"]) <= TOL["float32"]
              and lse_err <= TOL_LSE, f"{what}: within TOL of the plain "
              f"version (max |diff| {err:.2e}), lse within TOL_LSE")
        check(torch.equal(out, full[0]) and torch.equal(lse, full[1]),
              f"{what}: out and lse bitwise the launch without extents")
        times = {name: (cuda_ms(fn), cuda_ms(fn, reps=10)) for name, fn in (
            ("kernel", lambda: attention._fwd(q, k, v, bias, scale, False,
                                              ext)),
            ("null", lambda: attention._fwd(q, k, v, bias, scale, False)),
            ("plain", lambda: attention.flash_masked_attention_reference(
                q, k, v, bias, scale)))}
        b = attention_fwd_bounds(shape, "float32", valid.tolist())
        log(f"  {what}: kernel {times['kernel'][0]:.4f} ms, b2b "
            f"{times['kernel'][1]:.4f}; without extents "
            f"{times['null'][0]:.4f}, b2b {times['null'][1]:.4f}; plain "
            f"{times['plain'][0]:.4f}, b2b {times['plain'][1]:.4f}; bound "
            f"over the valid work {b['bound_ms']:.4f} ({b['bound_by']}; "
            f"{b['bound_ms'] / times['kernel'][1] * 100:.1f} % of it b2b)")
        found.append(dict(
            what="geotransformer cross-attention", shape=list(shape),
            dtype="float32", valid_keys=list(lengths), max_abs_err=err,
            ms=times["kernel"][0], back_to_back_ms=times["kernel"][1],
            null_extent_ms=times["null"][0],
            null_extent_back_to_back_ms=times["null"][1],
            plain_ms=times["plain"][0],
            plain_back_to_back_ms=times["plain"][1],
            valid_bound_ms=b["bound_ms"], valid_bound_by=b["bound_by"]))
    return found


def phase_geotransformer():
    """Phase 5c (the module's docstring) -> {'k1': [...], 'launches':
    {kernel: launches of one forward}, 'gathers': [...]}."""
    import torch

    from regtr_tpu_torch.data.rooms import padded_pairs
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.models import geotransformer as program
    from regtr_tpu_torch.ops.gather import row_gather_reference
    from regtr_tpu_torch.train.steps import make_forward

    log("== phase 5c: GeoTransformer")
    torch.cuda.empty_cache()
    k1 = geotr_cross_attention()
    cfg = json.loads(GEOTR_CONFIG.read_text())["config"]
    model = create_model(cfg, GEOTR_N0, DEVICE, seed=0)
    forward = make_forward(model)
    points, mask = (torch.from_numpy(x).to(DEVICE) for x in padded_pairs(
        N_PAIRS, N_POINTS, 3, GEOTR_N0))
    forward(points, mask)
    torch.cuda.synchronize()

    # the patch gathers call the kernel from the model's module: held
    # there, and their tables and ids kept by width for the timing
    real, patch = program.row_gather, {}

    def patch_rows(table, idx):
        out = real(table, idx)
        same = torch.equal(out, row_gather_reference(table, idx))
        patch.setdefault(table.shape[1], []).append((table, idx, same))
        return out

    found, keep = {}, {}
    _zero_launch_counts()
    program.row_gather = patch_rows
    try:
        with held_to_plain(found, keep):
            out = forward(points, mask)
            torch.cuda.synchronize()
    finally:
        program.row_gather = real
    launches = _launch_counts()
    want = geotr_launches_per_forward(model)
    log(f"  launches of one forward: {launches}")
    check(launches == want, f"launches of one forward {want}")
    for (name, shape, dtype), (calls, worst, ok) in sorted(found.items()):
        check(ok, f"{name} {shape} {dtype}: {calls} launches held to the "
              f"plain version (largest |difference| {worst:.2e})")
    held = sum(calls for (name, *_), (calls, _, _) in found.items()
               if name == "row_gather") + sum(len(v) for v in patch.values())
    check(held == launches["row_gather"] and sorted(patch) == [3, 256]
          and all(same for v in patch.values() for *_, same in v),
          f"every row gather held: the backbone's and the patch gathers' "
          f"({sum(len(v) for v in patch.values())}, bitwise index_select)")
    check(bool(torch.isfinite(out["pose"]).all()), "finite poses")
    gathers = [_time_row_gather(table, idx, f"GeoTransformer patch rows, "
                                f"{width} wide")
               for width, ((table, idx, _), *_) in sorted(patch.items())]
    embedding = geotr_embedding_timing(model, keep["geo"])
    return {"k1": k1, "launches": launches, "gathers": gathers,
            "embedding": embedding}


def geotr_embedding_timing(model, args):
    """The embedding kernel on one forward's own inputs (`args` of its
    launch, held to the plain version as it happened), by CUDA events:
    single launches and back to back (10), the module's whole stage (the
    angle neighbours' selection, then the kernel) and the plain version,
    beside the 3xTF32 bound of the products over the key tiles computed
    and over the valid pairs alone."""
    import torch

    from regtr_tpu_torch.ops import geo_embedding as geo

    points, mask, knn, w_d = args[:4]
    c, m, _ = points.shape
    d = w_d.shape[0]
    counts = mask.sum(1)
    with torch.inference_mode():
        ms = cuda_ms(lambda: geo._kernel(*args))
        b2b = cuda_ms(lambda: geo._kernel(*args), reps=10)
        stage = cuda_ms(lambda: model.transformer.embedding(points, mask),
                        reps=10)
        plain = cuda_ms(lambda: geo.geo_embedding_reference(*args[:-1]),
                        iters=10, warmup=2)
    tile = geo.KEY_TILE
    computed = int(((counts + tile - 1) // tile * tile).clamp(max=m).sum())
    flop = 4 * 2 * d * d * m          # four codes' products, a key column
    bound = computed * flop / PEAK_FLOPS["3xtf32"] * 1e3
    bound_valid = int(counts.sum()) * flop / PEAK_FLOPS["3xtf32"] * 1e3
    torch.cuda.synchronize()
    log(f"  geometric embedding {(c, m, m, d)} fp32, valid "
        f"{counts.tolist()}: kernel {ms:.4f} ms, b2b {b2b:.4f}; the stage "
        f"(neighbours + kernel) b2b {stage:.4f}; plain {plain:.4f} ms; "
        f"bound {bound:.4f} ms over the key tiles run, {bound_valid:.4f} "
        f"over the valid pairs (3xTF32)")
    return dict(what="GeoTransformer's embedding, one forward's inputs",
                shape=[c, m, m, d], dtype="float32",
                valid=counts.tolist(), ms=ms, back_to_back_ms=b2b,
                stage_back_to_back_ms=stage, plain_ms=plain,
                bound_ms=bound, bound_valid_ms=bound_valid)


def phase_small_input():
    import dataclasses

    import torch

    from regtr_tpu_torch.config import tiny_config
    from regtr_tpu_torch.models import create_model

    log("== phase 4: tiny config, card vs CPU on one input (forward and "
        "one training step)")
    data = np.load(ROOT / "tests" / "golden_tiny.npz")
    pts, mask = torch.from_numpy(data["points"]), torch.from_numpy(
        data["mask"])
    models = {dev: create_model(tiny_config(), 96, dev, seed=42)
              for dev in ("cpu", DEVICE)}
    with torch.no_grad():   # not inference mode: the step below saves them
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
        return model.head_and_pose(cond, coarse.points, coarse.mask, pe)

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

    # One training step's gradients: the kernels (attention forward with
    # lse, its backward, the gather transpose) against the CPU's plain
    # versions, on the same tables, parameters, pose and labels.
    from regtr_tpu_torch.data.overlap import compute_overlap
    from regtr_tpu_torch.ops import attention, kpconv

    pts_np, mask_np = data["points"], data["mask"]
    a = np.deg2rad(20.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pose = np.concatenate([rot, [[0.05], [-0.02], [0.01]]], 1)[None]
    src_ov, tgt_ov, _ = compute_overlap(
        pts_np[0][mask_np[0]] @ rot.T + pose[0, :, 3],
        pts_np[1][mask_np[1]], 0.15)
    ov = np.zeros(mask_np.shape, np.float32)
    ov[0, mask_np[0]], ov[1, mask_np[1]] = src_ov, tgt_ov
    grads = {}
    counts = {}
    for dev, levels in (("cpu", lv_cpu), (DEVICE, lv_moved)):
        model = models[dev]
        launches = (attention.flash_masked_attention.launches,
                    attention.flash_attn_bwd_dkv.launches,
                    attention.flash_attn_bwd_dq.launches,
                    kpconv.segment_sum.launches,
                    kpconv.segment_transpose.launches)
        losses, _ = model.loss_levels(
            levels, torch.from_numpy(pose.astype(np.float32)).to(dev),
            torch.from_numpy(ov).to(dev))
        gs = torch.autograd.grad(losses["total"], list(model.parameters()),
                                 allow_unused=True)
        grads[dev] = {n: (torch.zeros_like(p) if g is None else g).cpu()
                      for (n, p), g in zip(model.named_parameters(), gs)}
        counts[dev] = [x1 - x0 for x0, x1 in zip(launches, (
            attention.flash_masked_attention.launches,
            attention.flash_attn_bwd_dkv.launches,
            attention.flash_attn_bwd_dq.launches,
            kpconv.segment_sum.launches,
            kpconv.segment_transpose.launches))]
    n_attn = 2 * tiny_config()["num_encoder_layers"]
    n_seg, n_transposes = gather_transposes_per_step(tiny_config())
    check(counts["cpu"] == [0] * 5
          and counts[DEVICE] == [n_attn, n_attn, n_attn, n_seg, n_transposes],
          f"tiny step launches (fwd, dkv, dq, segsum, transpose): CPU "
          f"{counts['cpu']}, card {counts[DEVICE]}")
    worst = max((rel_l2(grads[DEVICE][n], g), n) for n, g in
                grads["cpu"].items() if float(g.norm()) > 1e-6)
    check(worst[0] < TOL_GRAD, f"tiny step gradients card vs CPU, leaf by "
          f"leaf: worst rel L2 {worst[0]:.2e} ({worst[1]}, tol {TOL_GRAD})")


def synthetic_pairs(n_pairs, n_points, seed):
    """Interleaved pairs of synthetic scans (regtr_tpu_torch/data/rooms.py)
    padded to the bucket N0: (points (2B, N0, 3), mask (2B, N0))."""
    from regtr_tpu_torch.data.rooms import padded_pairs

    return padded_pairs(n_pairs, n_points, seed, N0)


def synthetic_samples(n_pairs, n_points, seed, cfg):
    """The same pairs as training samples: src_xyz, tgt_xyz, the GT pose
    src -> tgt (3, 4), and overlap labels at cfg['overlap_radius'] from the
    port's compute_overlap (collate with data.collate.collate_pairs)."""
    from regtr_tpu_torch.data.overlap import compute_overlap
    from regtr_tpu_torch.data.rooms import scans

    clouds = scans(n_pairs, n_points, seed)
    samples = []
    for (src, rs, ts), (tgt, rt, tt) in zip(clouds[::2], clouds[1::2]):
        rot = rt @ rs.T
        pose = np.concatenate([rot, (tt - rot @ ts)[:, None]], 1)
        src_ov, tgt_ov, _ = compute_overlap(src @ rot.T + pose[:, 3], tgt,
                                            cfg["overlap_radius"])
        samples.append({"src_xyz": src, "tgt_xyz": tgt,
                        "pose": pose.astype(np.float32),
                        "src_overlap": src_ov, "tgt_overlap": tgt_ov})
    return samples


def profile_device(run, n, what, trace_name):
    """torch.profiler over n back-to-back calls of run(): the device's busy
    share (union of kernel intervals over the span from the first kernel's
    start to the last one's end) and the kernels with the most device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    trace = ROOT / ".build" / trace_name
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
    log(f"profile of {n} {what}s: device busy {busy / 1e3:.1f} of "
        f"{total / 1e3:.1f} ms ({100 * busy / total:.1f} %), kernels "
        f"{busy / 1e3 / n:.1f} ms per {what}")
    per_name = {}
    for e in kernels:
        name = e["name"].removeprefix("void ")[:100]
        per_name[name] = per_name.get(name, 0.0) + e["dur"]
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        log(f"  {us / 1e3 / n:8.2f} ms/{what}  {name}")
    return per_name


def phase_main_path():
    import torch

    import regtr_tpu_torch
    from regtr_tpu_torch.bench import stage_medians
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.nn import transformer
    from regtr_tpu_torch.ops.attention import (
        flash_masked_attention, flash_masked_attention_plain)

    log("== phase 5: inference path (3DMatch config, bf16, bucket 20480)")
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
    gathers = row_gathers_per_forward(cfg)

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
        _zero_launch_counts()
        rates = []
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            for _ in range(TIMED_ITERS):
                out = model(pts, mask)
            torch.cuda.synchronize()
            rates.append(N_PAIRS * TIMED_ITERS / (time.perf_counter() - t0))
        launches = _launch_counts()
    forwards = REPEATS * TIMED_ITERS
    searches = searches_per_pyramid(cfg)
    check(launches == {"flash_attn_fwd": per_forward * forwards,
                       "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
                       "segsum": 0, "segment_transpose": 0,
                       "row_gather": gathers * forwards,
                       "element_gather": 0,
                       "neighbor_search": searches * forwards},
          f"launches in {forwards} forwards: {launches} ({per_forward} "
          f"attention forwards, {gathers} row gathers and {searches} "
          "neighbor searches per forward, no gather transpose)")
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

    # -- per-stage times (synchronized after each stage), as the port's
    # bench takes them
    stages = stage_medians(model, pts, mask, TIMED_ITERS,
                           torch.device(DEVICE))
    log("stages (median ms, host clock around synchronized stages): "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    with torch.inference_mode():
        profile_device(lambda: model(pts, mask), PROFILED_ITERS, "forward",
                       "forward_trace.json")

    # -- determinism of the pyramid
    with torch.inference_mode():
        levels = model.preprocess(pts, mask)
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
        transformer.flash_masked_attention = flash_masked_attention_plain
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

    # -- K5 vs index_select in the whole forward: a gather is a copy, so
    # the outputs are bitwise equal (and the forward repeats bitwise)
    with torch.inference_mode():
        again = model(pts, mask)
        with plain_row_gather():
            plain = model(pts, mask)
        torch.cuda.synchronize()
    keys = ("feats_un", "feats_cond", "corr", "overlap_logits", "pose")
    check(all(torch.equal(out[k], again[k]) for k in keys),
          "forward bitwise repeatable")
    check(all(torch.equal(out[k], plain[k]) for k in keys),
          "forward with K5 bitwise equal to the forward with index_select "
          f"({', '.join(keys)})")
    with torch.inference_mode():
        ab = k5_against_index_select(lambda: model(pts, mask), TIMED_ITERS)
    log(f"forward, K5 vs index_select in turns ({TIMED_ITERS} forwards "
        f"each, host clock): {ab} ms per batch")
    return launches, forwards, pairs_per_s


_COUNTED = {}


def _counted():
    """Every kernel wrapper, by the name the kernels line gives it (taken
    once, so that a route that swaps a wrapper for its plain version still
    reads the wrappers' counts)."""
    from regtr_tpu_torch.ops import (attention, gather, geo_embedding,
                                     kpconv, neighbors)

    if not _COUNTED:
        _COUNTED.update({
            "flash_attn_fwd": attention.flash_masked_attention,
            "flash_attn_bwd_dkv": attention.flash_attn_bwd_dkv,
            "flash_attn_bwd_dq": attention.flash_attn_bwd_dq,
            "segsum": kpconv.segment_sum,
            "segment_transpose": kpconv.segment_transpose,
            "row_gather": gather.row_gather,
            "element_gather": gather.element_gather,
            "neighbor_search": neighbors.brute_radius_neighbors,
            "geo_embedding": geo_embedding.geo_embedding})
    return _COUNTED


def _launch_counts():
    return {k: fn.launches for k, fn in _counted().items()}


def _zero_launch_counts():
    for fn in _counted().values():
        fn.launches = 0


def searches_per_pyramid(cfg):
    """K6 launches in one pyramid of cfg's architecture (the brute search,
    one launch over the batch): a neighbor table per level, a pool and an
    upsample table per stride (ops/pyramid.py build_pyramid)."""
    from regtr_tpu_torch.ops.pyramid import count_pyramid_levels

    return 3 * count_pyramid_levels(cfg["architecture"]) - 2


def plain_route_launches(per_step):
    """The launches of kernel_route("plain") for the kernel route's
    `per_step`: K6's alone.  The plain route keeps the neighbor search: its
    integer tables are held to their plain version on their own (phase
    3c), so that the route's gradients measure the float kernels alone."""
    return {k: v if k == "neighbor_search" else 0
            for k, v in per_step.items()}


def row_gathers_per_forward(cfg):
    """K5 row-gather launches in one forward: the first block at each
    (conv or pool, level) table gathers its features and its neighbors'
    coordinates (kpconv_fused_gather), later blocks at that table only the
    features (kpconv_apply)."""
    from regtr_tpu_torch.nn.backbone import encoder_plan

    seen, n = set(), 0
    for name, *_, li in encoder_plan(cfg)[0]:
        key = ("pool" if "strided" in name else "conv", li)
        n += 1 if key in seen else 2
        seen.add(key)
    return n


# The kernels of csrc/segsum.cu, as the profiler names them.
K4_KERNELS = ("segsum_kernel", "transpose_", "scan_reduce_kernel",
              "scan_sums_kernel", "scan_apply_kernel")


def gather_transposes_per_step(cfg):
    """(segment sums, transposes) in one training step's backward: one
    gather with a gradient per block after the first (the first block's
    input is the constant feature, which has none), and one transpose per
    distinct (conv or pool, level) table among those blocks."""
    from regtr_tpu_torch.nn.backbone import encoder_plan

    keys = [("pool" if "strided" in name else "conv", li)
            for name, *_, li in encoder_plan(cfg)[0]][1:]
    return len(keys), len(set(keys))


def k5_against_index_select(run, iters):
    """Milliseconds per call of run() with K5 and with index_select in its
    place, in turns (K5, index_select, index_select, K5), `iters` calls
    each, synchronized: "K5 a / b, index_select a / b"."""
    import torch

    times = {"K5": [], "index_select": []}
    for route in ("K5", "index_select", "index_select", "K5"):
        with (plain_row_gather() if route == "index_select"
              else contextlib.nullcontext()):
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(iters):
                run()
            torch.cuda.synchronize()
        times[route].append((time.perf_counter() - t) / iters * 1e3)
    return ", ".join(f"{k} " + " / ".join(f"{x:.2f}" for x in v)
                     for k, v in times.items())


@contextlib.contextmanager
def plain_row_gather():
    """Every neighbor gather through index_select instead of K5."""
    from regtr_tpu_torch.ops import gather, kpconv

    kpconv.row_gather = gather.row_gather_reference
    try:
        yield
    finally:
        kpconv.row_gather = gather.row_gather


@contextlib.contextmanager
def kernel_route(route):
    """The training path with some kernels swapped for their plain
    versions: "kernels" (none), "index_select" (K5's row gather),
    "plain transpose" (the transpose kernels: a stable sort), "plain"
    (the attention, the row gather and the gather transpose).  Every route
    keeps K6: its tables are integers, held to its plain version on their
    own (phase 3c, held_to_plain)."""
    from regtr_tpu_torch.nn import transformer
    from regtr_tpu_torch.ops import attention, kpconv

    kernel_attention = transformer.flash_masked_attention
    kernel_gather = kpconv.batched_row_gather_padded
    kernel_transpose = kpconv.segment_transpose
    with contextlib.ExitStack() as stack:
        if route in ("plain", "index_select"):
            stack.enter_context(plain_row_gather())
        if route == "plain transpose":
            kpconv.segment_transpose = kpconv.segment_transpose_reference
        if route == "plain":
            transformer.flash_masked_attention = \
                attention.flash_masked_attention_plain
            kpconv.batched_row_gather_padded = \
                kpconv.batched_row_gather_padded_plain
        try:
            yield
        finally:
            transformer.flash_masked_attention = kernel_attention
            kpconv.batched_row_gather_padded = kernel_gather
            kpconv.segment_transpose = kernel_transpose


def _in_turns(fns, names, reps=1):
    """Median ms of each fn (CUDA events; `reps` calls per run, see
    cuda_ms), in turns: in order, then in reverse; -> {name: [first,
    second]}."""
    times = {name: [] for name in names}
    for fn, name in list(zip(fns, names)) + list(zip(fns, names))[::-1]:
        times[name].append(cuda_ms(fn, reps=reps))
    return times


def watch_against_fp64(model, levels, batch, leaves):
    """ROADMAP Watch 1 taken apart: the first step's gradients (no clip)
    on the kernel route and on the plain route, each against a float64
    step on the plain route, the same tables and parameters, at the leaves
    where the two routes lie farthest apart.  The kernels may lie no
    farther from the float64 step than the plain route does (1.5x):
    where the routes part, the plain route's fp32 sums carry it.  ->
    {leaf: (kernels vs plain, kernels vs fp64, plain vs fp64)}."""
    grads = {}
    for route in ("kernels", "plain"):
        with kernel_route(route):
            grads[route] = recorded_first_step(
                model, levels, batch["pose"], batch["overlap0"])[0]
    grads["fp64"] = fp64_first_step(model, levels, batch)[0]
    names = [n for n, _ in model.named_parameters()]
    out = {}
    for leaf in leaves:
        k, p, f = (grads[r][names.index(leaf)]
                   for r in ("kernels", "plain", "fp64"))
        out[leaf] = (rel_l2(k, p), rel_l2(k, f), rel_l2(p, f))
    log("  the watch against a float64 step (kernels vs plain / kernels vs "
        "fp64 / plain vs fp64): " + ", ".join(
            f"{leaf} {a:.3e} / {b:.3e} / {c:.3e}"
            for leaf, (a, b, c) in out.items()))
    check(all(b <= 1.5 * c for _, b, c in out.values()),
          "at the leaves where the routes part most, the kernel route lies "
          "no farther from the float64 step than 1.5x the plain route")
    return out


def check_transpose(ids, num, stride, what):
    """The transpose kernels bitwise against the plain version (starts, and
    perm's rows of a segment), twice; -> the kernel's transpose."""
    import torch

    from regtr_tpu_torch.ops.kpconv import (segment_transpose,
                                            segment_transpose_reference)

    got = segment_transpose(ids, num, stride)
    again = segment_transpose(ids, num, stride)
    ref = segment_transpose_reference(ids, num, stride)
    torch.cuda.synchronize()
    m = int(ref.starts[-1])
    longest = int(ref.starts.diff().max())
    check(all(torch.equal(t.starts, ref.starts)
              and torch.equal(t.perm[:m], ref.perm[:m]) for t in (got, again)),
          f"segment transpose, {what} ({ids.shape[0]} {str(ids.dtype)[6:]} "
          f"ids, {num} segments, {m} non-pad rows, longest segment "
          f"{longest}): bitwise the stable sort, twice")
    return got


def check_segsum(table, n_pad):
    """The gather transpose on a real neighbor table (B, Nq, K) into clouds
    of n_pad rows (the pad row last), by its flat ids as the main path
    makes them (int32): the transpose kernels bitwise against the plain
    version (there, with int64 ids, with each cloud's shadow row kept as
    batched_row_gather's backward keeps it, and on tables with a segment of
    6000 rows, of pad rows only and with empty segments); the segment-sum
    kernel over the kernel's transpose against the same kernel over the
    plain transpose (bitwise), the plain version and index_add_, twice for
    bitwise repeatability, in fp32 at the backbone's level-0 width (32) and
    at ragged widths, and in bf16.  Times in turns, as single launches and
    back to back: the transpose beside torch.sort of the same int32 ids,
    the sum, and their first use together.  Returns the kernels line's
    numbers (fp32, width 32): the gather transpose's at first use
    (transpose + sum: the whole function, as the earlier design's `ms`
    timed it with a sort in every backward in place of the transpose), with
    the sum's beside it, and the transpose's."""
    import torch

    from regtr_tpu_torch.ops.kpconv import (GatherIndex,
                                            padded_segment_sum_reference,
                                            segment_sum, segment_transpose,
                                            segment_transpose_reference)

    b = table.shape[0]
    index = GatherIndex(table, n_pad)
    ids, num = index.flat, index.num_segments
    t = check_transpose(ids, num, n_pad, "level-0 table")
    check_transpose(ids.long(), num, n_pad, "level-0 table")
    gen = torch.Generator(device="cpu").manual_seed(3)
    long_seg = torch.randint(0, num, (ids.shape[0] // 8,), generator=gen)
    long_seg[torch.randperm(long_seg.shape[0], generator=gen)[:6000]] = 5
    check_transpose(long_seg.to(DEVICE, torch.int32), num, n_pad,
                    "a segment of 6000 rows")
    pads = (torch.arange(b) * n_pad + n_pad - 1).repeat_interleave(50000)
    check_transpose(pads.to(DEVICE, torch.int32), num, n_pad, "pad rows only")
    evens = 2 * torch.randint(0, num // 2, (200000,), generator=gen)
    check_transpose(evens.to(DEVICE, torch.int32), num, n_pad,
                    "only even segments named")
    plain_t = segment_transpose_reference(ids, num, n_pad)
    rows, m = ids.shape[0], int(t.starts[-1])
    result = None
    for c, dtype in ((32, torch.float32), (33, torch.float32),
                     (192, torch.float32), (32, torch.bfloat16)):
        g = torch.randn(rows, c, generator=gen).to(DEVICE, dtype)
        got = segment_sum(g, t)
        again = segment_sum(g, t)
        over_plain = segment_sum(g, plain_t)
        ref = padded_segment_sum_reference(g, ids, num, n_pad)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        log(f"  segsum rows {rows} x {c} {dtype}: max abs err {err:.3e} "
            f"(largest |sum| {scale:.2f}, tol {TOL_SEGSUM:g} x that)")
        check(got.dtype == torch.float32 and got.shape == (num, c),
              "segsum dtype/shape")
        check(err <= TOL_SEGSUM * scale, f"segsum {c} {dtype} within "
              "tolerance")
        check(torch.equal(got, again) and torch.equal(got, over_plain),
              f"segsum {c} {dtype} bitwise repeatable, and bitwise the sum "
              "over the plain transpose")
        if result is not None:
            continue

        def sort_search(keys):
            sorted_ids, _ = torch.sort(keys, stable=True)
            torch.searchsorted(sorted_ids, torch.arange(
                num + 1, device=DEVICE, dtype=keys.dtype))

        fns = [lambda: segment_transpose(ids, num, n_pad),
               lambda: torch.sort(ids, stable=True),
               lambda: segment_sum(g, t),
               lambda: segment_sum(g, segment_transpose(ids, num, n_pad))]
        names = ["transpose", "sort", "sum", "first_use"]
        turns = _in_turns(fns, names)
        b2b = _in_turns(fns, names, reps=10)
        ms = {k: sum(v) / 2 for k, v in turns.items()}
        b2b_ms = {k: sum(v) / 2 for k, v in b2b.items()}
        t_plain_ms = cuda_ms(lambda: segment_transpose_reference(ids, num,
                                                                 n_pad))
        sort_search_ms = cuda_ms(lambda: sort_search(ids))
        # the earlier design's sort before its sum: int64 keys
        parent_ms = cuda_ms(lambda: sort_search(ids.long()))
        plain_ms = cuda_ms(lambda: padded_segment_sum_reference(g, ids, num,
                                                                n_pad))
        lib_ms = cuda_ms(lambda: torch.zeros(
            (num, c), device=DEVICE).index_add_(0, ids, g))
        # the transpose reads the ids and writes perm's non-pad rows and
        # starts; the sum reads the non-pad rows of g, their perm entries
        # and starts and writes the sums, one add per element
        t_bnd = bound(0, rows * 4 + m * 4 + (num + 1) * 4, "float32")
        s_bnd = bound(m * c, m * c * 4 + m * 4 + (num + 1) * 4 + num * c * 4,
                      "float32")
        first_bnd = bound(m * c, rows * 4 + m * c * 4 + num * c * 4,
                          "float32")
        log(f"  segment transpose {rows} int32 ids, {num} segments ({m} "
            f"non-pad rows): kernel {ms['transpose']:.4f} ms (bound "
            f"{t_bnd[0]:.4f}, {t_bnd[1]}; "
            f"{t_bnd[0] / ms['transpose'] * 100:.1f} % of it), plain "
            f"{t_plain_ms:.4f}, torch.sort(stable) of the int32 ids "
            f"{ms['sort']:.4f} (+ searchsorted {sort_search_ms:.4f}; of "
            f"int64 ids, the earlier design's, {parent_ms:.4f}) ms")
        log(f"  segsum {rows} x {c} fp32 over the transpose: kernel "
            f"{ms['sum']:.4f} ms (bound {s_bnd[0]:.4f}, {s_bnd[1]}; "
            f"{s_bnd[0] / ms['sum'] * 100:.1f} % of it); first use "
            f"(transpose + sum) {ms['first_use']:.4f} ms (bound "
            f"{first_bnd[0]:.4f}); plain {plain_ms:.4f}, index_add_ "
            f"{lib_ms:.4f} ms (medians of 30 single launches, CUDA events; "
            f"turns " + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                                  for k, v in turns.items()) + ")")
        log("  back to back (runs of 10 calls): " + "; ".join(
            f"{k} {b2b_ms[k]:.4f} ({' / '.join(f'{x:.4f}' for x in v)})"
            for k, v in b2b.items()))
        # batched_row_gather's backward keeps each cloud's shadow row: a
        # segment of every unfilled neighbor slot per cloud
        shadow = check_transpose(ids, num, num + 1,
                                 "level-0 table, shadow rows kept")
        longest = int(shadow.starts.diff().max())
        del shadow
        sh = _in_turns([lambda: segment_transpose(ids, num, num + 1),
                        lambda: torch.sort(ids, stable=True)],
                       ["transpose", "sort"])
        sh_ms = {k: sum(v) / 2 for k, v in sh.items()}
        log(f"  segment transpose, shadow rows kept (longest segment "
            f"{longest}): kernel {sh_ms['transpose']:.4f} ms, "
            f"torch.sort(stable) {sh_ms['sort']:.4f} ms (turns "
            + "; ".join(f"{k} " + " / ".join(f"{x:.4f}" for x in v)
                        for k, v in sh.items()) + ")")
        result = {"segsum": {
            "max_abs_err": err, "ms": ms["first_use"], "plain_ms": plain_ms,
            "bound_ms": first_bnd[0], "bound_by": first_bnd[1],
            "library_ms": lib_ms,
            "back_to_back_ms": b2b_ms["first_use"],
            "sum_ms": ms["sum"], "sum_back_to_back_ms": b2b_ms["sum"],
            "sum_bound_ms": s_bnd[0],
            "rows": rows, "width": c, "non_pad_rows": m},
            "segment_transpose": {
            "max_abs_err": 0.0, "ms": ms["transpose"], "plain_ms": t_plain_ms,
            "bound_ms": t_bnd[0], "bound_by": t_bnd[1],
            "library_ms": ms["sort"],
            "back_to_back_ms": b2b_ms["transpose"],
            "back_to_back_library_ms": b2b_ms["sort"],
            "sort_searchsorted_ms": sort_search_ms,
            "parent_route_ms": parent_ms,
            "rows": rows, "segments": num, "non_pad_rows": m,
            "shadow_rows_kept": {"ms": sh_ms["transpose"],
                                 "library_ms": sh_ms["sort"],
                                 "longest_segment": longest}}}
    return result


def phase_training():
    import torch

    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps
    from regtr_tpu_torch.train.optim import Optimizer

    cfg = threedmatch_config()
    n_pairs = int(cfg["train_batch_size"])
    log(f"== phase 6: training path (3DMatch config as shipped: "
        f"{cfg['compute_dtype']}, {n_pairs} pairs, {cfg['optimizer']} lr "
        f"{cfg['base_lr']} wd {cfg['weight_decay']}, {cfg['scheduler']} "
        f"schedule, clip {cfg['grad_clip']}, dropout {cfg['dropout']})")
    samples = synthetic_samples(n_pairs, N_POINTS, 0, cfg)
    batch_np, _ = collate_pairs(samples, cfg["buckets"])
    n0 = batch_np["points"].shape[1]
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in batch_np.items()}
    t0 = time.perf_counter()
    model = create_model(cfg, n0, DEVICE, seed=0)
    log(f"bucket {n0} (pick_bucket of {N_POINTS} over {cfg['buckets']}), "
        f"pyramid caps {model.spec.capacities}, K {model.spec.neighbor_ks}; "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.2f} M "
        f"parameters, built in {time.perf_counter() - t0:.1f} s; overlap "
        f"labels at radius {cfg['overlap_radius']}: "
        f"{float(batch_np['overlap0'][batch_np['mask']].mean()):.3f} of the "
        f"points")
    opt = Optimizer(model.parameters(), cfg)
    step = steps.make_train_step(model, opt, cfg)
    n_attn = 2 * cfg["num_encoder_layers"]     # self + cross per layer
    n_segsum, n_transposes = gather_transposes_per_step(cfg)
    gathers = row_gathers_per_forward(cfg)

    # -- K4 on the step's own level-0 neighbor table
    with torch.no_grad():
        levels = model.preprocess(batch["points"], batch["mask"])
    segsum = check_segsum(levels[0].neighbors, n0 + 1)

    # -- first-step gradients: kernels vs the plain attention, gather and
    # gather transpose on the card, same parameters and batch; and the
    # kernels with only K5 replaced by index_select, with only the
    # transpose kernel replaced by its plain version (a stable sort), and
    # once more
    grads = {}
    kernels = {"flash_attn_fwd": n_attn, "flash_attn_bwd_dkv": n_attn,
               "flash_attn_bwd_dq": n_attn, "segsum": n_segsum,
               "segment_transpose": n_transposes, "row_gather": gathers,
               "element_gather": 0,
               "neighbor_search": searches_per_pyramid(cfg)}
    wants = {"kernels": kernels, "index_select": dict(kernels, row_gather=0),
             "plain transpose": dict(kernels, segment_transpose=0),
             "plain": plain_route_launches(kernels), "kernels again": kernels}
    for route, want in wants.items():
        with kernel_route(route):
            before = _launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            losses, _ = steps.forward_loss(model, batch)
            g, _ = steps.backward(opt, losses["total"])
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t
            grads[route] = g
            used = {k: v - before[k] for k, v in _launch_counts().items()}
        log(f"first step, {route}: loss {losses['total'].item():.5f}, "
            f"forward + backward {elapsed * 1e3:.1f} ms, launches {used}")
        check(used == want, f"{route} route launched {want}")
    for route in ("kernels again", "index_select", "plain transpose"):
        check(all(torch.equal(a, b) for a, b in zip(grads["kernels"],
                                                     grads[route])),
              f"first-step gradients, kernels vs {route}: bitwise equal "
              f"over all {len(grads[route])} parameters")
    names = [n for n, _ in model.named_parameters()]
    errs = sorted(((rel_l2(a, b), n) for n, a, b in
                   zip(names, grads["kernels"], grads["plain"])
                   if float(b.norm()) > 1e-6), reverse=True)
    check(errs[0][0] < TOL_GRAD,
          f"first-step gradients, kernels vs plain, leaf by leaf over "
          f"{len(errs)} parameters: worst rel L2 {errs[0][0]:.2e} "
          f"({errs[0][1]}; tol {TOL_GRAD})")
    segsum["segsum"]["first_step_grad_rel_l2"] = errs[0][0]
    segsum["segsum"]["first_step_vs_fp64"] = watch_against_fp64(
        model, levels, batch, [name for _, name in errs[:4]])
    # phase 12 holds the data-parallel first step to this one
    PHASE12.mkdir(parents=True, exist_ok=True)
    np.savez(PHASE12 / "first_step.npz", **batch_np)
    torch.save([g.cpu() for g in grads["kernels"]],
               PHASE12 / "first_step_grads.pt")
    del grads

    # -- warm-up, then the timed window with the counts zeroed just before
    # and read just after
    history = [step(batch) for _ in range(TRAIN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launch_counts()
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        history.append(step(batch))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    want = {k: v * TRAIN_STEPS for k, v in kernels.items()}
    check(launches == want, f"launches in {TRAIN_STEPS} steps: {launches} "
          f"({n_attn} attention forwards and backwards, {n_segsum} "
          f"segment sums over {n_transposes} transposes (one per distinct "
          f"table), {gathers} row gathers and "
          f"{kernels['neighbor_search']} neighbor searches per step)")
    totals = [float(m["total"]) for m in history]
    norms = [float(m["grad_norm"]) for m in history]
    log(f"train: {elapsed / TRAIN_STEPS * 1e3:.1f} ms per step, "
        f"{n_pairs * TRAIN_STEPS / elapsed:.3f} pairs/s ({TRAIN_STEPS} "
        f"steps after {TRAIN_WARMUP} warm-up, host clock), peak memory "
        f"{peak / 2**30:.2f} GiB")
    log("loss per step: " + " ".join(f"{x:.4f}" for x in totals))
    log("grad_norm per step: " + " ".join(f"{x:.3f}" for x in norms))
    log("last step: " + ", ".join(
        f"{k} {float(v) if v.numel() == 1 else v.tolist()}"
        if torch.is_tensor(v) else f"{k} {v}"
        for k, v in history[-1].items()))
    check(all(np.isfinite(totals)) and all(np.isfinite(norms)),
          "every step's loss and grad_norm finite")
    check(all(m["update_skipped"] == 0.0 for m in history),
          "no step skipped its update")
    check(totals[-1] < totals[0], f"loss fell over {len(totals)} steps: "
          f"{totals[0]:.4f} -> {totals[-1]:.4f}")

    # -- a NaN point: the update is skipped, the parameters stay bitwise
    bad = dict(batch, points=batch["points"].clone())
    bad["points"][0, 5, 2] = float("nan")
    kept = [p.detach().clone() for p in model.parameters()]
    count = opt.count
    m = step(bad)
    check(m["update_skipped"] == 1.0 and opt.count == count
          and all(torch.equal(a, p) for a, p in zip(kept,
                                                    model.parameters())),
          f"NaN batch: loss {float(m['total'])}, update skipped, every "
          "parameter bitwise unchanged")

    # -- per-stage times (synchronized after each stage)
    stages = {"forward_loss": [], "backward": [], "optimizer": []}
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses, _ = steps.forward_loss(model, batch)
        torch.cuda.synchronize()
        stages["forward_loss"].append(time.perf_counter() - t)
        t = time.perf_counter()
        g, gn = steps.backward(opt, losses["total"])
        torch.cuda.synchronize()
        stages["backward"].append(time.perf_counter() - t)
        t = time.perf_counter()
        steps.apply(opt, g, gn, losses["total"])
        torch.cuda.synchronize()
        stages["optimizer"].append(time.perf_counter() - t)
    log("stages (median ms of 5, host clock around synchronized stages): "
        + ", ".join(f"{k} {statistics.median(v) * 1e3:.2f}"
                    for k, v in stages.items()))

    def forward_backward():
        losses, _ = steps.forward_loss(model, batch)
        steps.backward(opt, losses["total"])

    log("forward + loss + backward, K5 vs index_select in turns (5 each, "
        f"host clock): {k5_against_index_select(forward_backward, 5)} ms")
    per_name = profile_device(lambda: step(batch), PROFILED_ITERS, "step",
                              "train_trace.json")
    # the gather transpose's kernels by name: the transpose's (count, the
    # scan's three, fill, order, the long pass's two) and the sum, with
    # their device time per step (PyTorch's own scans, e.g. cumsum's
    # scan_innermost_dim, are not among them)
    mine = {name: us for name, us in per_name.items()
            if any(k in name for k in K4_KERNELS)}
    check(any("transpose_" in n for n in mine)
          and any("segsum_kernel" in n for n in mine),
          "the step's profile shows the transpose and segsum kernels")
    for name, us in sorted(mine.items(), key=lambda kv: -kv[1]):
        log(f"  {us / 1e3 / PROFILED_ITERS:8.3f} ms/step  {name}")
    k4_ms = sum(mine.values()) / 1e3 / PROFILED_ITERS
    log(f"gather transpose (K4: transposes + segment sums) in the step's "
        f"profile: {k4_ms:.3f} ms per step")
    segsum["segsum"]["step_profile_ms"] = k4_ms
    return launches, segsum


# The test protocol's synthetic data root: scenes of PROTOCOL_FRAGMENTS
# scans each, every scan N_POINTS points of one room on the 2.5 cm grid,
# centres PROTOCOL_STEP m apart; 3DMatch pairs the nearer scans, 3DLoMatch
# the farther ones.  Recall counts the non-consecutive pairs only.
PROTOCOL_SCENES = 2
PROTOCOL_FRAGMENTS = 6
PROTOCOL_STEP = 0.35
PROTOCOL_PAIRS = {"3DMatch": [(0, 1), (0, 2), (1, 3), (2, 4), (3, 5)],
                  "3DLoMatch": [(0, 3), (1, 4), (2, 5), (0, 4), (1, 5)]}


def write_protocol_root(base):
    """A data root in 3DMatch's on-disk formats, laid out as the upstream
    sources expect it from their src/ directory: base/data/indoor/test/
    <scene>/cloud_bin_<i>.pth (pickled numpy arrays, as torch.save writes
    them), base/src/datasets/3dmatch/test_<benchmark>_info.pkl ({src, tgt,
    rot, trans, overlap}) and .../benchmarks/<benchmark>/<scene>/gt.log and
    gt.info (Redwood format).  A pair (i, j), i < j, has src = fragment j,
    tgt = fragment i and the pose tgt <- src; gt.log's header is "i j n"."""
    import torch

    from regtr_tpu_torch.core import se3_np
    from regtr_tpu_torch.data.overlap import compute_overlap
    from regtr_tpu_torch.data.rooms import rotation, voxel_room

    shutil.rmtree(base, ignore_errors=True)
    meta = base / "src" / "datasets" / "3dmatch"
    infos = {bm: {"src": [], "tgt": [], "rot": [], "trans": [],
                  "overlap": []} for bm in PROTOCOL_PAIRS}
    rng = np.random.RandomState(7)
    for si in range(PROTOCOL_SCENES):
        scene = f"synthroom-{si}"
        (base / "data" / "indoor" / "test" / scene).mkdir(parents=True)
        room, (lx, ly) = voxel_room(rng)
        poses, local = [], []
        for i in range(PROTOCOL_FRAGMENTS):
            center = np.array([lx * 0.2 + i * PROTOCOL_STEP, ly * 0.5, 1.1])
            dist = np.linalg.norm(room - center, axis=1)
            world = room[np.argpartition(dist, N_POINTS)[:N_POINTS]]
            pose = se3_np.se3_init(rotation(rng, 180.0),
                                   rng.randn(3) * 0.5)      # frame -> world
            local.append(se3_np.se3_transform(se3_np.se3_inv(pose), world)
                         .astype(np.float32))
            torch.save(local[-1], base / "data" / "indoor" / "test" / scene
                       / f"cloud_bin_{i}.pth")
            poses.append(pose)
        for bm, pairs in PROTOCOL_PAIRS.items():
            gt = meta / "benchmarks" / bm / scene
            gt.mkdir(parents=True)
            with open(gt / "gt.log", "w") as f, open(gt / "gt.info",
                                                      "w") as g:
                for i, j in pairs:
                    rel = se3_np.se3_cat(se3_np.se3_inv(poses[i]), poses[j])
                    ov, _, _ = compute_overlap(
                        se3_np.se3_transform(rel, local[j]), local[i],
                        0.0375)
                    info = infos[bm]
                    info["src"].append(f"test/{scene}/cloud_bin_{j}.pth")
                    info["tgt"].append(f"test/{scene}/cloud_bin_{i}.pth")
                    info["rot"].append(rel[:, :3])
                    info["trans"].append(rel[:, 3:])
                    info["overlap"].append(float(ov.mean()))
                    for out, mat in ((f, np.concatenate(
                            [rel, [[0.0, 0.0, 0.0, 1.0]]])),
                                     (g, np.eye(6) * 100.0)):
                        out.write(f"{i}\t{j}\t{PROTOCOL_FRAGMENTS}\n")
                        for row in mat:
                            out.write("\t".join(f"{v:.12f}" for v in row)
                                      + "\n")
    for bm, info in infos.items():
        info = {k: np.stack(v) if k in ("rot", "trans") else
                (np.asarray(v) if k == "overlap" else v)
                for k, v in info.items()}
        with open(meta / f"test_{bm}_info.pkl", "wb") as f:
            pickle.dump(info, f)
        log(f"  {bm}: {len(info['src'])} pairs, overlap "
            f"{info['overlap'].min():.2f}-{info['overlap'].max():.2f}")
    return meta


@contextlib.contextmanager
def timed_protocol(record, stages, also=()):
    """run_test with its forward, est.log writes and scorer timed (the
    forward synchronized), and each forward's inputs and final poses
    recorded; each (module, attribute) of `also` timed into
    stages[attribute] too (host clock)."""
    import torch

    from regtr_tpu_torch import evaluation
    from regtr_tpu_torch.benchmark import predator
    from regtr_tpu_torch.train.steps import make_forward

    def timed(name, fn, sync=False):
        def run(*args, **kwargs):
            t = time.perf_counter()
            try:
                out = fn(*args, **kwargs)
                if sync:
                    torch.cuda.synchronize()
                return out
            finally:
                stages[name] += time.perf_counter() - t
        return run

    def recording_forward(model):
        fwd = timed("forward", make_forward(model), sync=True)

        def run(points, mask):
            out = fwd(points, mask)
            record.append((points, mask, out["pose"][-1].clone()))
            return out
        return run

    targets = [(evaluation, "make_forward"), (predator, "write_est_log"),
               (predator, "benchmark"), *also]
    saved = [(module, name, getattr(module, name))
             for module, name in targets]
    patched = {"make_forward": recording_forward,
               "write_est_log": timed("est_log", predator.write_est_log),
               "benchmark": timed("scorer", predator.benchmark)}
    for module, name, fn in saved:
        setattr(module, name, patched.get(name) or timed(name, fn))
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def phase_protocol():
    """The 3DMatch and 3DLoMatch test protocols (run_test) on the shipped
    config at full width, and the port's command line on the same
    parameters.  Returns the launch counts and the protocol's numbers."""
    import torch

    from regtr_tpu_torch import evaluation
    from regtr_tpu_torch.benchmark import predator
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.data import get_dataloader
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train.checkpoints import save_params_npz
    from regtr_tpu_torch.train.steps import make_forward

    log("== phase 7: the 3DMatch / 3DLoMatch test protocol "
        "(conf/3dmatch.yaml as shipped)")
    base = ROOT / ".build" / "protocol"
    t0 = time.perf_counter()
    meta = write_protocol_root(base)
    log(f"synthetic data root under {base.relative_to(ROOT)}: "
        f"{PROTOCOL_SCENES} scenes x {PROTOCOL_FRAGMENTS} scans of "
        f"{N_POINTS} points, written in {time.perf_counter() - t0:.1f} s")
    shipped = threedmatch_config()
    model = create_model(shipped, max(shipped["buckets"]), DEVICE, seed=0)
    log(f"model at the largest bucket {max(shipped['buckets'])} (caps "
        f"{model.spec.capacities}), {shipped['compute_dtype']}, "
        f"test_batch_size {shipped['test_batch_size']}, buckets "
        f"{shipped['buckets']}")
    per_forward = {"flash_attn_fwd": 2 * shipped["num_encoder_layers"],
                   "row_gather": row_gathers_per_forward(shipped),
                   "neighbor_search": searches_per_pyramid(shipped)}
    smi = card_line()
    result = {}
    for bm in PROTOCOL_PAIRS:
        cfg = threedmatch_config(root=str(base / "data" / "indoor"),
                                 metadata_dir=str(meta), benchmark=bm)
        out_dir = base / "run" / bm
        if not result:      # warm-up forward at the protocol's bucket
            batch, _ = next(iter(get_dataloader(cfg, "test",
                                                num_workers=0)))
            make_forward(model)(torch.from_numpy(batch["points"]).to(DEVICE),
                                torch.from_numpy(batch["mask"]).to(DEVICE))
        record, stages = [], dict.fromkeys(("forward", "est_log", "scorer"),
                                           0.0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launch_counts()
        t0 = time.perf_counter()
        with timed_protocol(record, stages):
            results = evaluation.run_test(
                cfg, model, get_dataloader(cfg, "test", num_workers=4),
                out_dir, gt_benchmark_dir=str(meta / "benchmarks"))
        total = time.perf_counter() - t0
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        n = len(PROTOCOL_PAIRS[bm]) * PROTOCOL_SCENES
        check(len(record) == n, f"{bm}: {n} pairs, one forward each "
              f"(test_batch_size 1)")
        check(launches == dict(dict.fromkeys(launches, 0), **{
            k: v * n for k, v in per_forward.items()}),
              f"{bm}: launches {launches}")
        # est.log: one line group per pair, and the poses the forward gave
        poses = torch.stack([p for _, _, p in record]).squeeze(1)
        written = {}
        for si in range(PROTOCOL_SCENES):
            pairs, traj = predator.read_trajectory(
                out_dir / bm / f"synthroom-{si}" / "est.log")
            check([tuple(p[:2]) for p in pairs] == PROTOCOL_PAIRS[bm]
                  and bool((pairs[:, 2] == -1).all()),
                  f"{bm} scene {si}: est.log has one group per pair, in "
                  "order")
            written[si] = traj
        est = np.concatenate([written[si] for si in range(PROTOCOL_SCENES)])
        err = float(np.abs(est[:, :3] - poses.double().cpu().numpy()).max())
        check(err <= 5e-13, f"{bm}: est.log poses are the forward's "
              f"(largest difference {err:.1e}, the %.12f format)")
        with torch.inference_mode():
            direct = torch.stack([make_forward(model)(p, m)["pose"][-1]
                                  for p, m, _ in record]).squeeze(1)
        check(torch.equal(direct, poses), f"{bm}: the protocol's poses "
              "bitwise equal a direct make_forward of the same batches")
        check(all(np.isfinite(results[k]) for k in
                  ("rot_err_deg_mean", "trans_err_mean")),
              f"{bm}: finite errors, {results}")
        # the scorer on est.log files written from the GT poses
        gt_est = base / "gt_est" / bm
        for si in range(PROTOCOL_SCENES):
            scene = f"synthroom-{si}"
            pairs, traj = predator.read_trajectory(
                meta / "benchmarks" / bm / scene / "gt.log")
            (gt_est / scene).mkdir(parents=True)
            for (i, j, _), pose in zip(pairs, traj):
                predator.write_est_log(gt_est / scene / "est.log", i, j, pose)
        _, gt_recall = predator.benchmark(str(gt_est),
                                          str(meta / "benchmarks" / bm))
        check(gt_recall == 1.0, f"{bm}: est.log from the GT poses scores "
              f"recall {gt_recall}")
        loop = total - stages["scorer"]
        loading = loop - stages["forward"] - stages["est_log"]
        log(f"{bm} protocol ({smi}): {n} pairs in {total:.3f} s, "
            f"{n / loop:.3f} pairs/s over the loop (loading, forward, "
            f"est.log; host clock); per pair: forward "
            f"{stages['forward'] / n * 1e3:.1f} ms, waiting on the loader "
            f"{loading / n * 1e3:.1f} ms, est.log "
            f"{stages['est_log'] / n * 1e3:.2f} ms; scorer "
            f"{stages['scorer'] * 1e3:.1f} ms; peak memory "
            f"{peak / 2**30:.2f} GiB")
        log(f"{bm} results (random weights, not checked): {results}")
        result[bm] = dict(launches=launches, pairs=n,
                          pairs_per_s=n / loop,
                          recall=results.get("registration_recall"),
                          est_dir=out_dir / bm)

    # -- the port's command line, on the same parameters saved as .npz,
    # from the upstream working directory (the shipped config's root and
    # the default metadata and GT places resolve from there)
    npz = base / "ckpt" / "params.npz"
    npz.parent.mkdir()
    save_params_npz(npz, model)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "regtr_tpu_torch.test", "--params", str(npz),
         "--config", str(ROOT / "conf" / "3dmatch.yaml"), "--benchmark",
         "3DMatch", "--logdir", str(base / "cli_logs")],
        cwd=meta.parent.parent, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600)
    log(f"python -m regtr_tpu_torch.test: exit {proc.returncode} in "
        f"{time.perf_counter() - t0:.1f} s")
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0, "the command line exits 0")
    (logdir,) = (base / "cli_logs").iterdir()
    worst = 0.0
    for si in range(PROTOCOL_SCENES):
        scene = f"synthroom-{si}"
        pairs, traj = predator.read_trajectory(logdir / "3DMatch" / scene
                                               / "est.log")
        _, ref = predator.read_trajectory(base / "run" / "3DMatch" / "3DMatch"
                                          / scene / "est.log")
        check([tuple(p[:2]) for p in pairs] == PROTOCOL_PAIRS["3DMatch"],
              f"command line: est.log of scene {si} written")
        worst = max(worst, float(np.abs(traj - ref).max()))
    check((logdir / "benchmark_report.txt").exists()
          and worst <= 1e-5, f"command line: benchmark_report.txt written; "
          f"its poses vs the in-process run's: largest difference "
          f"{worst:.1e}")
    return result


# Phase 8's configuration: the synthetic 3DMatch-scale training config at
# its published width; only the data scale (the items, the steps) is cut.
TRAINER_CONFIG = ROOT / "conf" / "synthetic_3dmatch.yaml"
TRAINER_DATA = {"synthetic_items": 16, "synthetic_val_items": 4}
TRAINER_STEPS = (8, 10)         # the first run's niter, the resumed run's
# the kernels of the trainer's path (every one but K5b)
TRAINER_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dkv",
                   "flash_attn_bwd_dq", "segsum", "segment_transpose",
                   "row_gather", "neighbor_search")
TRAINER_TIMED_STEPS = 5     # the trainer's step back to back, synchronized


def trainer_attention_shape(cfg):
    """(B * H, N, N, d) of the trainer's attention calls: both clouds of
    each pair of a train batch times the heads, at the model's coarse
    capacity for the largest cloud the config makes."""
    from regtr_tpu_torch.data.collate import pick_bucket
    from regtr_tpu_torch.ops.pyramid import make_pyramid_spec

    n = make_pyramid_spec(cfg, pick_bucket(cfg["num_points"],
                                           cfg["buckets"])).capacities[-1]
    return (2 * cfg["train_batch_size"] * cfg["nhead"], n, n,
            cfg["d_embed"] // cfg["nhead"])


def derived_config(src, dst, **values):
    """The YAML text of src with each `key: value` line of `values`
    replaced (the machines the port runs on have no PyYAML)."""
    text = src.read_text()
    for key, value in values.items():
        text, n = re.subn(rf"^(\s+{key}:).*$", rf"\g<1> {value}", text,
                          flags=re.M)
        if n != 1:
            raise SystemExit(f"FAILED: {key} appears {n} times in {src}")
    dst.write_text(text)
    return dst


@contextlib.contextmanager
def recorded_train_steps(record, latest):
    """Every train step the trainer builds appends (its total loss as a
    tensor, update_skipped, the kernels' launches within it) to
    `record`; reading the launch counts costs no sync.  `latest` keeps the
    latest step function, its batch, model and optimizer."""
    from regtr_tpu_torch.train import trainer

    real = trainer.make_train_step

    def make(model, optimizer, cfg):
        step = real(model, optimizer, cfg)

        def run(batch):
            before = _launch_counts()
            metrics = step(batch)
            after = _launch_counts()
            record.append((metrics["total"].detach(),
                           metrics["update_skipped"],
                           {k: after[k] - before[k] for k in after}))
            latest.update(step=step, batch=batch, model=model,
                          optimizer=optimizer)
            return metrics

        return run

    trainer.make_train_step = make
    try:
        yield
    finally:
        trainer.make_train_step = real


@contextlib.contextmanager
def held_to_plain(found, keep=None):
    """Every kernel launch of the training path and of the neighbor
    searches, held to its plain version on the same inputs as it happens:
    the attention forward (out and lse) and backward within TOL and TOL_BWD
    of the operands' dtype (as phase 3 holds them), the brute search (K6,
    wrapped where the pyramid calls it), the row gathers (the kernels' and
    the grid search's), the element gather (the scan and grid searches'
    merges) and the segment transpose bitwise, the segment sum within
    TOL_SEGSUM of its largest |sum|, GeoTransformer's embedding within
    TOL (fp32).  found[(kernel, shape, dtype)] = (launches, largest
    |difference|, all within).  keep, if given, gets the element gather's
    inputs of the largest src under 'args' and the embedding's latest
    under 'geo' (for timing)."""
    import torch

    from regtr_tpu_torch.ops import (attention, geo_embedding, kpconv,
                                     neighbors, pyramid)
    from regtr_tpu_torch.ops.gather import (element_gather_reference,
                                            row_gather_reference)

    def note(name, shape, dtype, err, ok):
        key = (name, tuple(shape), str(dtype)[6:])
        calls, worst, good = found.get(key, (0, 0.0, True))
        found[key] = (calls + 1, max(worst, err), good and bool(ok))

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.

    real = dict(fwd=attention._kernel_fwd, bwd=attention._bwd,
                gather=kpconv.row_gather, transpose=kpconv.segment_transpose,
                sum=kpconv.segment_sum, search_gather=neighbors.row_gather,
                elements=neighbors.element_gather,
                search=pyramid.radius_neighbors_batch,
                geo=geo_embedding._kernel)

    def search(queries, q_mask, supports, s_mask, radius, k, method,
               chunk, cell_cap):
        out = real["search"](queries, q_mask, supports, s_mask, radius, k,
                             method=method, chunk=chunk, cell_cap=cell_cap)
        if method == "brute":
            ref = neighbors.brute_radius_neighbors_plain(
                queries, q_mask, supports, s_mask, radius, k)
            same = torch.equal(out, ref)
            note("neighbor_search", (queries.shape[0], queries.shape[1],
                                     supports.shape[1], k), queries.dtype,
                 0.0 if same else max_err(out, ref), same)
        return out

    def fwd(q, k, v, bias, scale, want_lse, kv_extent=None):
        out, lse = real["fwd"](q, k, v, bias, scale, want_lse, kv_extent)
        ref, ref_lse = attention.flash_masked_attention_reference(
            q, k, v, bias, scale, return_lse=True)
        tol = TOL[str(q.dtype)[6:]]
        ok = _excess(out, ref, tol) <= tol
        if lse is not None:
            ok = ok and float(((lse - ref_lse).abs() - 1e-6 * ref_lse.abs())
                              .max()) <= TOL_LSE
        note("flash_attn_fwd", q.shape, q.dtype, max_err(out, ref), ok)
        return out, lse

    def bwd(q, k, v, bias, o, lse, do, scale, want_dbias):
        got = real["bwd"](q, k, v, bias, o, lse, do, scale, want_dbias)
        refs = attention.flash_masked_attention_bwd_reference(
            q, k, v, bias, o, lse, do, scale)
        tol = TOL_BWD[str(q.dtype)[6:]]
        for name, pairs in (("flash_attn_bwd_dq", [(got[0], refs[0])]),
                            ("flash_attn_bwd_dkv", list(zip(got[1:],
                                                            refs[1:])))):
            pairs = [(g, r) for g, r in pairs if g is not None]
            note(name, q.shape, q.dtype, max(max_err(g, r) for g, r in pairs),
                 all(_excess(g, r, tol, max(float(r.float().abs().max()), 1.))
                     <= tol for g, r in pairs))
        return got

    def held_rows(which):
        def gather(table, idx):
            out = real[which](table, idx)
            ref = row_gather_reference(table, idx)
            same = torch.equal(out, ref)
            note("row_gather", (idx.shape[0], table.shape[1]), table.dtype,
                 0.0 if same else max_err(out, ref), same)
            return out
        return gather

    def elements(src, idx, axis):
        out = real["elements"](src, idx, axis)
        ref = element_gather_reference(src, idx, axis)
        same = torch.equal(out, ref)
        note("element_gather", idx.shape, src.dtype,
             0.0 if same else max_err(out, ref), same)
        if keep is not None and src.numel() > keep.get("numel", 0):
            keep.update(numel=src.numel(), args=(src, idx, axis))
        return out

    def transpose(ids, num, stride):
        t = real["transpose"](ids, num, stride)
        ref = kpconv.segment_transpose_reference(ids, num, stride)
        m = int(ref.starts[-1])
        same = (torch.equal(t.starts, ref.starts)
                and torch.equal(t.perm[:m], ref.perm[:m]))
        note("segment_transpose", ids.shape, ids.dtype,
             0.0 if same else float("inf"), same)
        return t

    def segsum(g, t):
        out = real["sum"](g, t)
        ref = kpconv.segment_sum_reference(g, t)
        err = max_err(out, ref)
        note("segsum", g.shape, g.dtype, err,
             err <= TOL_SEGSUM * float(ref.abs().max()))
        return out

    def geo(*args):
        out = real["geo"](*args)
        ref = geo_embedding.geo_embedding_reference(*args[:-1])
        tol = TOL["float32"]
        note("geo_embedding", out.shape, out.dtype, max_err(out, ref),
             _excess(out, ref, tol) <= tol)
        if keep is not None:
            keep["geo"] = args
        return out

    # kpconv's own kernels count their launches under their module names,
    # which the wrappers take meanwhile: fold those counts back on exit
    transpose.launches = segsum.launches = 0
    attention._kernel_fwd, attention._bwd = fwd, bwd
    kpconv.row_gather = held_rows("gather")
    kpconv.segment_transpose, kpconv.segment_sum = transpose, segsum
    neighbors.row_gather = held_rows("search_gather")
    neighbors.element_gather = elements
    pyramid.radius_neighbors_batch = search
    geo_embedding._kernel = geo
    try:
        yield
    finally:
        geo_embedding._kernel = real["geo"]
        pyramid.radius_neighbors_batch = real["search"]
        attention._kernel_fwd, attention._bwd = real["fwd"], real["bwd"]
        kpconv.row_gather = real["gather"]
        neighbors.row_gather = real["search_gather"]
        neighbors.element_gather = real["elements"]
        kpconv.segment_transpose = real["transpose"]
        kpconv.segment_sum = real["sum"]
        real["transpose"].launches += transpose.launches
        real["sum"].launches += segsum.launches


@contextlib.contextmanager
def fp32_operands(model):
    """The model with every module's compute_dtype (bf16) unset: its
    operands stay fp32."""
    mods = [m for m in model.modules()
            if getattr(m, "compute_dtype", None) is not None]
    saved = [m.compute_dtype for m in mods]
    for m in mods:
        m.compute_dtype = None
    try:
        yield
    finally:
        for m, dtype in zip(mods, saved):
            m.compute_dtype = dtype


def trainer_kernels_against_plain(latest, per_step, trainer_shape):
    """The trainer's model on its last batch, one forward and backward per
    route (no update): with every kernel launch held to its plain version
    (held_to_plain), the kernels once more, the plain route, and the plain
    route on fp32 operands; the gradients bitwise repeatable, within
    TOL_GRAD_BF16 (relative L2, leaf by leaf) of the plain route's, and
    no more than TOL_BF16_NOISE times as far from the fp32 step's as the
    plain route's.  Returns the distances and the shapes checked."""
    import torch

    from regtr_tpu_torch.train import steps

    model, opt, batch = latest["model"], latest["optimizer"], latest["batch"]
    check(model.spec.capacities[-1] == trainer_shape[1],
          f"the trainer's model has phase 3's trainer shape: coarse "
          f"capacity {model.spec.capacities[-1]}, {trainer_shape}")
    found, grads = {}, {}
    for route in ("kernels", "kernels again", "plain", "plain fp32"):
        with contextlib.ExitStack() as stack:
            stack.enter_context(kernel_route(
                "kernels" if route.startswith("kernels") else "plain"))
            if route == "kernels":
                stack.enter_context(held_to_plain(found))
            if route == "plain fp32":
                stack.enter_context(fp32_operands(model))
            before = _launch_counts()
            losses, _ = steps.forward_loss(model, batch)
            grads[route], _ = steps.backward(opt, losses["total"])
            torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in _launch_counts().items()}
        want = (per_step if route.startswith("kernels")
                else plain_route_launches(per_step))
        log(f"trainer's last batch, {route}: loss "
            f"{float(losses['total'].detach()):.5f}, launches {used}")
        check(used == want, f"{route} route launched {want}")
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    bh, n, _, d = trainer_shape
    check(all(ok for *_, ok in found.values())
          and {k[0] for k in found} == set(TRAINER_KERNELS)
          and all(sum(c for (nm, *_), (c, *_) in found.items() if nm == name)
                  == per_step[name] for name in TRAINER_KERNELS)
          and ("flash_attn_fwd", (bh, n, d), "bfloat16") in found,
          f"each of the step's {sum(per_step.values())} launches of "
          f"{len(TRAINER_KERNELS)} kernels at {len(found)} (kernel, shape, "
          f"dtype) within its tolerance of its plain version on the same "
          f"inputs, the attention at {trainer_shape} bfloat16")
    check(all(torch.equal(a, b) for a, b in zip(grads["kernels"],
                                                 grads["kernels again"])),
          f"the trainer's gradients, kernels vs kernels again: bitwise equal "
          f"over all {len(grads['kernels'])} parameters")
    # a key projection's bias shifts each query's scores by one constant,
    # which the softmax takes out: its gradient is 0 in exact arithmetic,
    # and what either route gives there is rounding alone
    names = [nm for nm, _ in model.named_parameters()]
    noise = [(float(a.norm()), float(b.norm())) for nm, a, b in zip(
        names, grads["kernels"], grads["plain"]) if nm.endswith("k_proj.bias")]
    errs = sorted(((rel_l2(a, b), nm) for nm, a, b in
                   zip(names, grads["kernels"], grads["plain"])
                   if float(b.norm()) > 1e-6
                   and not nm.endswith("k_proj.bias")), reverse=True)
    flat = {route: torch.cat([g.reshape(-1) for g in gs])
            for route, gs in grads.items()}
    whole = rel_l2(flat["kernels"], flat["plain"])
    from_fp32 = {route: rel_l2(flat[route], flat["plain fp32"])
                 for route in ("kernels", "plain")}
    far = sorted(((float((a - b).norm()), nm) for nm, a, b in zip(
        names, grads["plain"], grads["plain fp32"])), reverse=True)[:3]
    log("  the plain route, bf16 vs fp32 operands: the largest leaf "
        "differences " + ", ".join(f"{nm} {diff:.3e}" for diff, nm in far)
        + f" (of {float((flat['plain'] - flat['plain fp32']).norm()):.3e} "
        f"over a norm of {float(flat['plain fp32'].norm()):.3e})")
    median_norm = statistics.median(float(g.norm()) for g in grads["plain"])
    log("  the 5 farthest leaves: " + ", ".join(
        f"{nm} {e:.2e}" for e, nm in errs[:5]) + f"; median leaf "
        f"{statistics.median(e for e, _ in errs):.2e}; all parameters as "
        f"one vector {whole:.2e}; the {len(noise)} key biases' gradient "
        f"norms (0 in exact arithmetic): at most "
        f"{max(a for a, _ in noise):.2e} (kernels), "
        f"{max(b for _, b in noise):.2e} (plain), against a median leaf "
        f"norm of {median_norm:.2e}")
    check(errs[0][0] < TOL_GRAD_BF16,
          f"the trainer's gradients (bf16), kernels vs plain, leaf by leaf "
          f"over {len(errs)} parameters (the key biases aside): worst rel "
          f"L2 {errs[0][0]:.2e} ({errs[0][1]}; tol {TOL_GRAD_BF16})")
    check(from_fp32["kernels"] <= TOL_BF16_NOISE * from_fp32["plain"],
          f"the trainer's gradients as one vector, rel L2 from the fp32 "
          f"step's: kernels {from_fp32['kernels']:.3e}, plain (bf16) "
          f"{from_fp32['plain']:.3e} (ratio "
          f"{from_fp32['kernels'] / from_fp32['plain']:.3f}; at most "
          f"{TOL_BF16_NOISE})")
    return dict(grad_rel_l2=errs[0][0], grad_rel_l2_all=whole,
                grad_from_fp32=from_fp32, shapes_checked=len(found))


def phase_trainer(trainer_shape):
    """The trainer's command line in-process at full width: sanity
    validation, TRAINER_STEPS[0] steps with validation and best-by-score
    checkpoints, then a resume from the run's ckpt/ to TRAINER_STEPS[1];
    then its kernels at the shapes of its last batch against their plain
    versions.  Returns the launch counts of the phase and per train step,
    and the trainer's numbers."""
    import tempfile

    import torch

    from regtr_tpu_torch.config import load_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import __main__ as train_cli
    from regtr_tpu_torch.train.checkpoints import CheckpointManager
    from regtr_tpu_torch.train.optim import Optimizer

    first, last = TRAINER_STEPS
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_trainer_"))
    cfg_first = derived_config(TRAINER_CONFIG, work / "first.yaml",
                               niter=first, **TRAINER_DATA)
    cfg_last = derived_config(TRAINER_CONFIG, work / "last.yaml",
                              niter=last, **TRAINER_DATA)
    cfg = load_config(cfg_first)
    log(f"== phase 8: the trainer (python -m regtr_tpu_torch.train on "
        f"{TRAINER_CONFIG.name}: {cfg['num_points']} points, buckets "
        f"{cfg['buckets']}, batch {cfg['train_batch_size']}, "
        f"{cfg['compute_dtype']}, {len(cfg['architecture'])} blocks, "
        f"{cfg['num_encoder_layers']} layers; {TRAINER_DATA}, niter "
        f"{first}, then resumed to {last})")
    flags = ["--device", DEVICE, "--nb_sanity_val_steps", "1",
             "--validate_every", "4", "--summary_every", "2",
             "--num_workers", "4"]
    record, latest = [], {}
    smi = card_line()
    try:
        _zero_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with recorded_train_steps(record, latest):
            run1 = train_cli.main(["--config", str(cfg_first), "--logdir",
                                   str(work / "first"), *flags])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        peak1 = torch.cuda.max_memory_allocated()
        (logdir,) = (work / "first").iterdir()
        # phase 12 runs the same training under the launcher
        PHASE12.mkdir(parents=True, exist_ok=True)
        shutil.copy(logdir / "ckpt" / str(first) / "state.pt",
                    PHASE12 / "phase8_state.pt")
        # phase 13 exports its checkpoints
        shutil.rmtree(PHASE13 / "phase8_run", ignore_errors=True)
        shutil.copytree(logdir, PHASE13 / "phase8_run",
                        ignore=shutil.ignore_patterns("*.jsonl", "*.txt",
                                                      "events.*"))
        saver = CheckpointManager(logdir / "ckpt")
        check(saver.all_steps() == [4, first]
              and saver.best_record() is not None,
              f"checkpoints at steps {saver.all_steps()}, best.json "
              f"{saver.best_record()}")
        # a fresh model and optimizer restored from the last checkpoint
        # hold the trained run's tensors bitwise
        fresh = create_model(cfg, max(cfg["buckets"]), DEVICE, seed=1)
        fresh_opt = Optimizer(fresh.parameters(), cfg)
        live = run1.optimizer
        check(saver.restore(fresh, fresh_opt) == first
              and fresh_opt.count == live.count == first
              and all(torch.equal(a, b) for a, b in zip(fresh_opt.params,
                                                        live.params))
              and all(torch.equal(a, b) for a, b in zip(
                  fresh_opt.mu + fresh_opt.nu, live.mu + live.nu)),
              f"restored step {first}: parameters, moments and count "
              f"bitwise the trained run's")
        del fresh, fresh_opt, live

        t0 = time.perf_counter()
        with recorded_train_steps(record, latest):
            run2 = train_cli.main(["--config", str(cfg_last), "--resume",
                                   str(logdir / "ckpt"), "--logdir",
                                   str(work / "last"), *flags])
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t0
        launches = _launch_counts()
        (logdir2,) = (work / "last").iterdir()
        check(CheckpointManager(logdir2 / "ckpt").latest_step() == last
              and run2.optimizer.count == last
              and f"Resumed from step {first}" in
              (logdir2 / "log.txt").read_text(),
              f"the resumed run starts at step {first} and ends at {last}")
    finally:
        close_port_logger()
        shutil.rmtree(work, ignore_errors=True)

    totals = [float(t) for t, _, _ in record]
    check(len(record) == last and all(np.isfinite(totals)),
          f"{len(record)} train steps, every loss finite: "
          + ", ".join(f"{t:.4f}" for t in totals))
    check(all(s == 0.0 for _, s, _ in record)
          and run1.skipped_updates == run2.skipped_updates == 0,
          "no update skipped")
    check(run1.failed_steps == run2.failed_steps == 0,
          "the trainer counted 0 failed steps")
    per_step = record[-1][2]
    check(all(r[2] == per_step for r in record),
          f"every train step launches the same kernels: {per_step}")
    check(all(launches[k] > 0 for k in TRAINER_KERNELS)
          and launches["element_gather"] == 0,
          f"launches in the phase: {launches} (K5b: none)")
    steps_s = run1.timing["step_s"] + run2.timing["step_s"]
    # each run's first step is cold (its allocations, its first launches)
    warm = run1.timing["step_s"][1:] + run2.timing["step_s"][1:]
    median = statistics.median(warm)
    loop = {k: run1.timing[k] + run2.timing[k]
            for k in ("loader_wait_s", "validation_s")}
    busy = sum(steps_s) + loop["loader_wait_s"]
    log("trainer steps (ms, host clock around each step, its copy to the "
        "card included): " + "; ".join(
            f"run {i}: " + " ".join(f"{t * 1e3:.1f}" for t in r.timing[
                "step_s"]) for i, r in ((1, run1), (2, run2))))
    log(f"trainer ({smi}): median step {median * 1e3:.1f} ms "
        f"({1 / median:.3f} steps/s) over the {len(warm)} steps after each "
        f"run's first (min {min(warm) * 1e3:.1f}, max {max(warm) * 1e3:.1f} "
        f"ms); waiting on the loader {loop['loader_wait_s']:.2f} s, "
        f"{loop['loader_wait_s'] / busy:.1%} of the steps' and waits' "
        f"time, {loop['loader_wait_s'] / (wall1 + wall2):.1%} of the two "
        f"runs' wall time ({wall1:.1f} + {wall2:.1f} s); validation "
        f"{loop['validation_s']:.2f} s in all")
    log(f"trainer launches per train step: {per_step}")
    held = trainer_kernels_against_plain(latest, per_step, trainer_shape)
    # the trainer's own step function on its last batch, back to back and
    # synchronized after each (more updates of the resumed run's model,
    # after every check): the step without the loop around it
    alone = []
    for _ in range(TRAINER_TIMED_STEPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        latest["step"](latest["batch"])
        torch.cuda.synchronize()
        alone.append(time.perf_counter() - t)
    log(f"the trainer's step alone on its last batch ({smi}): "
        + " ".join(f"{t * 1e3:.1f}" for t in alone) + f" ms, median "
        f"{statistics.median(alone) * 1e3:.1f}")
    per_name = profile_device(lambda: latest["step"](latest["batch"]),
                              PROFILED_ITERS, "trainer step",
                              "trainer_trace.json")
    k4_ms = sum(us for name, us in per_name.items()
                if any(k in name for k in K4_KERNELS)) / 1e3 / PROFILED_ITERS
    log(f"gather transpose (K4) in the trainer step's profile: {k4_ms:.3f} "
        "ms per step")
    first_run = dict(
        totals=[float(t) for t, _, _ in record[:first]],
        median_step_ms=statistics.median(run1.timing["step_s"][1:]) * 1e3,
        peak_bytes=peak1)
    log(f"trainer's first run ({first} steps): median step "
        f"{first_run['median_step_ms']:.1f} ms after its first, peak memory "
        f"{peak1 / 2**30:.2f} GiB ({smi})")
    return dict(launches=launches, per_step=per_step, steps=len(steps_s),
                first_run=first_run, median_step_ms=median * 1e3,
                step_alone_ms=statistics.median(alone) * 1e3,
                loader_wait_share=loop["loader_wait_s"] / busy,
                validation_s=loop["validation_s"], **held)


# Phase 9's configuration: conf/modelnet.yaml as shipped (fp32, bucket 768,
# 6 layers), on the dataset's synthetic stand-in, its test split cut from
# 256 pairs to MODELNET_PAIRS: the per-pair metrics on the host take ~0.14
# s a pair, and no check of the phase needs more pairs.  The dataset's root
# is a directory of the checkout that holds no shards, so that no lookup
# leaves the checkout whatever the working directory.
MODELNET_CONFIG = ROOT / "conf" / "modelnet.yaml"
MODELNET_PAIRS = 32
MODELNET_NO_SHARDS = ROOT / ".build" / "modelnet_no_shards"
MODELNET_BENCHMARKS = {"ModelNet": [0.7, 0.7], "ModelLoNet": [0.5, 0.5]}


def modelnet_attention_shape(cfg):
    """(B * H, N, N, d) of the ModelNet protocol's attention calls: the two
    clouds of a test batch times the heads, at the coarse capacity of the
    model the command line builds (at the largest bucket)."""
    from regtr_tpu_torch.ops.pyramid import make_pyramid_spec

    n = make_pyramid_spec(cfg, max(cfg["buckets"])).capacities[-1]
    return (2 * cfg["test_batch_size"] * cfg["nhead"], n, n,
            cfg["d_embed"] // cfg["nhead"])


def close_port_logger():
    """Detach the handlers the command lines' prepare_logger attached."""
    import logging

    logger = logging.getLogger("regtr_tpu_torch")
    for h in logger.handlers:
        h.close()
    logger.handlers.clear()


def phase_modelnet(modelnet_shape):
    """The ModelNet and ModelLoNet protocols through `python -m
    regtr_tpu_torch.test`'s main, in-process, at the full width of
    conf/modelnet.yaml with seeded random parameters saved as .npz, on
    MODELNET_PAIRS pairs of the dataset's synthetic stand-in; then one
    pair's kernel launches against their plain versions, and a profile of
    its forward.  Returns each benchmark's launches and numbers."""
    import importlib.util

    import torch

    from regtr_tpu_torch import evaluation
    from regtr_tpu_torch import test as test_cli
    from regtr_tpu_torch.config import (dump_yaml_sections, load_config,
                                        parse_yaml_sections)
    from regtr_tpu_torch.data import get_dataset
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train.checkpoints import save_params_npz
    from regtr_tpu_torch.train.steps import make_forward

    base = ROOT / ".build" / "modelnet"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    raw = parse_yaml_sections(MODELNET_CONFIG.read_text())
    raw["dataset"]["synthetic_val_items"] = MODELNET_PAIRS
    raw["dataset"]["root"] = str(MODELNET_NO_SHARDS)
    config = base / MODELNET_CONFIG.name
    config.write_text(dump_yaml_sections(raw))
    cfg = load_config(config)
    model = create_model(cfg, max(cfg["buckets"]), DEVICE, seed=0)
    log(f"== phase 9: the ModelNet / ModelLoNet protocols (python -m "
        f"regtr_tpu_torch.test on {MODELNET_CONFIG.name} as shipped: "
        f"{cfg['compute_dtype']}, buckets {cfg['buckets']}, caps "
        f"{model.spec.capacities}, K {cfg['neighborhood_limits']}, d_embed "
        f"{cfg['d_embed']}, {cfg['nhead']} heads, "
        f"{cfg['num_encoder_layers']} layers, "
        f"{sum(p.numel() for p in model.parameters())} parameters, batch "
        f"{cfg['test_batch_size']}; the stand-in's test split cut to "
        f"{MODELNET_PAIRS} pairs)")
    check(not MODELNET_NO_SHARDS.exists(),
          f"{MODELNET_NO_SHARDS} (the dataset's root) does not exist")
    check(model.spec.capacities[-1] == modelnet_shape[1],
          f"the protocol's model has phase 3's ModelNet shape {modelnet_shape}")
    npz = base / "params.npz"
    save_params_npz(npz, model)
    per_pair = {"flash_attn_fwd": 2 * cfg["num_encoder_layers"],
                "row_gather": row_gathers_per_forward(cfg),
                "neighbor_search": searches_per_pyramid(cfg)}
    smi = card_line()
    result = {}
    try:
        for bm, partial in MODELNET_BENCHMARKS.items():
            dataset = get_dataset(dict(cfg, partial=partial), "test")
            check(type(dataset).__name__ == "SyntheticShapeDataset",
                  f"{bm}: the ModelNet HDF5 shards are not in the "
                  f"repository (root {cfg['root']!r}) and h5py is "
                  f"{'absent' if importlib.util.find_spec('h5py') is None else 'installed'}"
                  f" here: the protocol runs on the dataset's synthetic "
                  f"stand-in, {len(dataset)} test pairs")
            record = []
            stages = dict.fromkeys(("forward", "est_log", "scorer", "run_test",
                                    "_modelnet_metrics_ragged"), 0.0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _zero_launch_counts()
            with timed_protocol(record, stages, also=[
                    (evaluation, "run_test"),
                    (evaluation, "_modelnet_metrics_ragged")]):
                results = test_cli.main([
                    "--params", str(npz), "--config", str(config),
                    "--benchmark", bm, "--logdir", str(base / bm),
                    "--device", DEVICE, "--num_workers", "4"])
            launches = _launch_counts()
            peak = torch.cuda.max_memory_allocated()
            (logdir,) = (base / bm).iterdir()
            n = len(record)
            check(n == len(dataset), f"{bm}: {n} pairs, one forward each "
                  f"(test_batch_size 1)")
            check(launches == dict(dict.fromkeys(launches, 0), **{
                k: v * n for k, v in per_pair.items()}),
                  f"{bm}: launches {launches}, per pair {per_pair}")
            poses = torch.stack([p for _, _, p in record]).squeeze(1)
            pred = np.load(logdir / "pred_transforms.npy")
            check(pred.shape == (n, 3, 4)
                  and np.array_equal(pred, poses.cpu().numpy()),
                  f"{bm}: pred_transforms.npy {pred.shape} holds the "
                  f"forward's poses")
            for i in (0, n // 2, n - 1):
                sample = dataset[i]
                pts, mask, _ = record[i]
                src = sample["src_xyz"]
                check(np.array_equal(pts[0, :len(src)].cpu().numpy(), src)
                      and int(mask[0].sum()) == len(src),
                      f"{bm}: pose {i} is dataset sample {i}'s ("
                      f"{len(src)} source points)")
            with torch.inference_mode():
                direct = torch.stack([make_forward(model)(p, m)["pose"][-1]
                                      for p, m, _ in record]).squeeze(1)
            check(torch.equal(direct, poses), f"{bm}: the protocol's poses "
                  "bitwise equal a direct make_forward of the same batches")
            check("chamfer_dist" in results
                  and all(np.isfinite(v) for v in results.values()),
                  f"{bm}: every metric finite")
            # the metrics of groundtruth poses
            batch, meta = collate_pairs([dataset[i] for i in range(8)],
                                        cfg["buckets"])
            gt = evaluation._modelnet_metrics_ragged(batch, meta,
                                                     batch["pose"])
            worst = {k: float(np.abs(gt[k]).max())
                     for k in ("err_r_deg", "err_t", "r_mae", "t_mae")}
            # err_r_deg is arccos((trace - 1) / 2) of an fp32 rotation times
            # its transpose: ~0.02 degrees at trace 3 - 1e-7, its floor
            check(worst["err_r_deg"] <= 0.05
                  and worst["err_t"] == worst["r_mae"] == worst["t_mae"] == 0,
                  f"{bm}: compute_metrics on 8 groundtruth poses: largest "
                  f"errors {worst} (degrees and metres; the isotropic "
                  f"rotation error's floor on fp32 poses is ~0.02 degrees)")
            loop = stages["run_test"]
            metrics = stages["_modelnet_metrics_ragged"]
            rest = loop - stages["forward"] - metrics
            log(f"{bm} protocol ({smi}): {n} pairs, {n / loop:.3f} pairs/s "
                f"over run_test (loading, forward, metrics; host clock); "
                f"per pair: forward {stages['forward'] / n * 1e3:.2f} ms, "
                f"metrics {metrics / n * 1e3:.2f} ms, waiting on the loader "
                f"and the rest {rest / n * 1e3:.2f} ms; peak memory "
                f"{peak / 2**30:.3f} GiB")
            log(f"{bm} results (random weights, not checked): {results}")
            result[bm] = dict(launches=launches, pairs=n,
                              pairs_per_s=n / loop,
                              forward_ms=stages["forward"] / n * 1e3,
                              loader_ms=rest / n * 1e3,
                              metrics_ms=metrics / n * 1e3,
                              peak_gib=peak / 2**30)
    finally:
        close_port_logger()

    # one pair's kernel launches, each held to its plain version
    points, mask, _ = record[0]
    found = {}
    before = _launch_counts()
    with held_to_plain(found):
        make_forward(model)(points, mask)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in _launch_counts().items()}
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    bh, nq, _, d = modelnet_shape
    check(used == dict(dict.fromkeys(used, 0), **per_pair)
          and all(ok for *_, ok in found.values())
          and {k[0] for k in found} == set(per_pair)
          and all(sum(c for (nm, *_), (c, *_) in found.items() if nm == name)
                  == per_pair[name] for name in per_pair)
          and ("flash_attn_fwd", (bh, nq, d), "float32") in found,
          f"each of one ModelNet pair's {sum(per_pair.values())} launches "
          f"({len(found)} kernel, shape and dtype) within its tolerance of "
          f"its plain version on the same inputs, K1 at {modelnet_shape} "
          f"float32")
    profile_device(lambda: make_forward(model)(points, mask),
                   PROFILED_ITERS, "ModelNet forward", "modelnet_trace.json")
    return result


def phase_tools(protocol):
    """The other command lines on the card: the demo on a ModelNet-size
    pair with --save_attn and on a 3DMatch-size pair of phase 7's scans,
    calibrate on phase 7's data root (card and CPU), evaluate_3dmatch on
    phase 7's est.log trees."""
    import io

    import torch

    from regtr_tpu_torch import calibrate as calibrate_cli
    from regtr_tpu_torch import demo as demo_cli
    from regtr_tpu_torch import evaluate_3dmatch as evaluate_cli
    from regtr_tpu_torch.config import (dump_yaml_sections, load_config,
                                        modelnet_config, parse_yaml_sections,
                                        threedmatch_config)
    from regtr_tpu_torch.data import get_dataset
    from regtr_tpu_torch.utils.ply import write_ply
    from regtr_tpu_torch.utils.xlsx import read_xlsx

    log("== phase 10: the other command lines (demo, calibrate, "
        "evaluate_3dmatch)")
    base = ROOT / ".build" / "tools"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    smi = card_line()

    # -- the demo on a ModelNet-size pair, with and without --save_attn
    cfg = modelnet_config(root=str(MODELNET_NO_SHARDS))
    sample = get_dataset(cfg, "test")[0]
    for name, key in (("src", "src_xyz"), ("tgt", "tgt_xyz")):
        write_ply(base / f"{name}.ply", sample[key], ["x", "y", "z"])
    pair = ["--src", str(base / "src.ply"), "--tgt", str(base / "tgt.ply"),
            "--device", DEVICE]
    per_pair = {"flash_attn_fwd": 2 * cfg["num_encoder_layers"],
                "row_gather": row_gathers_per_forward(cfg),
                "neighbor_search": searches_per_pyramid(cfg)}
    runs = {}
    for flag in ("attn", "plain"):
        _zero_launch_counts()
        t0 = time.perf_counter()
        runs[flag] = demo_cli.main(pair + ["--out", str(base / flag)] + (
            ["--save_attn"] if flag == "attn" else []))
        torch.cuda.synchronize()
        runs[flag].update(s=time.perf_counter() - t0,
                          launches=_launch_counts())
        check(runs[flag]["launches"] == dict(
            dict.fromkeys(runs[flag]["launches"], 0), **per_pair),
              f"demo ({flag}): launches {runs[flag]['launches']}")
    maps = runs["attn"]["maps"]
    n = runs["attn"]["outputs"]["kp"].shape[1]
    want = {f"transformer_encoder/layer_{i}/{kind}"
            for i in range(cfg["num_encoder_layers"])
            for kind in ("self_attn", "cross_attn")}
    row_err = max(float((m.sum(-1) - 1).abs().max()) for m in maps.values())
    check(set(maps) == want
          and all(m.shape == (2, cfg["nhead"], n, n)
                  and m.dtype == torch.float32 for m in maps.values())
          and row_err <= 1e-5,
          f"demo --save_attn: {len(maps)} maps of (2, {cfg['nhead']}, {n}, "
          f"{n}) fp32, every row summing to 1 within {row_err:.1e}")
    saved = np.load(base / "attn" / "attn.npz")
    check(sorted(saved.files) == sorted(want), "attn.npz holds the 12 maps")
    differ = [k for k, v in runs["plain"]["outputs"].items()
              if k != "levels" and not torch.equal(
                  v, runs["attn"]["outputs"][k])]
    check(not differ and all((base / flag / f).exists()
                             for flag in runs
                             for f in ("before.ply", "after.ply")),
          "demo: the pose and every output bitwise the same with the "
          "attention hook on and off; before.ply and after.ply written")
    log(f"demo on a ModelNet-size pair ({len(sample['src_xyz'])} and "
        f"{len(sample['tgt_xyz'])} points, the modelnet preset at bucket "
        f"{max(cfg['buckets'])}; {smi}): {runs['attn']['s']:.2f} s with "
        f"--save_attn, {runs['plain']['s']:.2f} s without (model "
        f"creation, forward, files)")

    # -- the demo on a 3DMatch-size pair of phase 7's scans
    scans = ROOT / ".build" / "protocol" / "data" / "indoor" / "test" \
        / "synthroom-0"
    big = threedmatch_config()
    _zero_launch_counts()
    t0 = time.perf_counter()
    run = demo_cli.main(["--src", str(scans / "cloud_bin_1.pth"), "--tgt",
                         str(scans / "cloud_bin_0.pth"), "--out",
                         str(base / "3dmatch"), "--device", DEVICE])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = _launch_counts()
    check(launches == dict(dict.fromkeys(launches, 0), **{
        "flash_attn_fwd": 2 * big["num_encoder_layers"],
        "row_gather": row_gathers_per_forward(big),
        "neighbor_search": searches_per_pyramid(big)})
          and bool(torch.isfinite(run["outputs"]["pose"]).all())
          and run["maps"] is None,
          f"demo on a 3DMatch-size pair (the 3dmatch preset, "
          f"{big['compute_dtype']}): finite pose, launches {launches}, "
          f"{took:.2f} s ({smi})")

    # -- calibrate on phase 7's data root: on the card over 3 samples into
    # a YAML file; on the card and on the CPU over 1 (the CPU's exact
    # neighbor counts on a 19k-point scan take seconds)
    meta = ROOT / ".build" / "protocol" / "src" / "datasets" / "3dmatch"
    raw = parse_yaml_sections((ROOT / "conf" / "3dmatch.yaml").read_text())
    raw["dataset"]["root"] = str(scans.parent.parent)
    raw["dataset"]["metadata_dir"] = str(meta)
    cal_yaml = base / "calibrate.yaml"
    cal_yaml.write_text(dump_yaml_sections(raw))
    args = ["--config", str(cal_yaml), "--phase", "test"]
    t0 = time.perf_counter()
    three = calibrate_cli.main(args + [
        "--num_samples", "3", "--device", DEVICE, "--output",
        str(base / "calibrated.yaml")])
    took = {"card, 3 samples": time.perf_counter() - t0}
    written = load_config(base / "calibrated.yaml")
    check(three["num_samples"] == 3 and all(
        written[k] == three[k] for k in ("neighborhood_limits",
                                         "level_capacities",
                                         "cell_capacity")),
          f"calibrate on 3 test pairs of 19k-point scans on the card: "
          f"{three}; the written YAML loads to it")
    one = {}
    for device in (DEVICE, "cpu"):
        t0 = time.perf_counter()
        one[device] = calibrate_cli.main(args + [
            "--num_samples", "1", "--device", device, "--dry-run"])
        took[f"{device}, 1 sample"] = time.perf_counter() - t0
    check(one[DEVICE] == one["cpu"],
          f"calibrate on 1 test pair: the card's {one[DEVICE]} equals the "
          f"CPU's (seconds {took}; {smi})")

    # -- evaluate_3dmatch on phase 7's est.log trees
    for bm, res in protocol.items():
        gt = str(meta / "benchmarks")
        printed = {}
        for method, est in (("predator", res["est_dir"]),
                            ("dgr", ROOT / ".build" / "protocol" / "gt_est"
                             / bm)):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                evaluate_cli.main([str(est), "--benchmark", bm, "--gt_dir",
                                   gt, "--method", method])
            printed[method] = out.getvalue()
        recall = float(re.search(r"Mean registration recall: (\S+)",
                                 printed["predator"]).group(1))
        rows = read_xlsx(res["est_dir"] / "individual_errors.xlsx")
        check(abs(recall - res["recall"]) <= 5e-5
              and "Mean success rate: 1.0000" in printed["dgr"]
              and rows[0] == ["scene", "src", "tgt", "error", "flag"]
              and len(rows) == 1 + res["pairs"],
              f"evaluate_3dmatch {bm}: Predator recall {recall:.4f} as "
              f"run_test's {res['recall']}; DGR 1.0 on the GT est.logs; "
              f"individual_errors.xlsx read back, {len(rows) - 1} pairs")


# Phase 11's configuration: conf/3dmatch.yaml at every shipped width, with
# the options the shipped configs leave off switched on: deformable
# (modulated) blocks at the two deepest levels (the last three blocks, as
# KPConv's deformable KP-FCNN puts them), the attention decoder head with
# its top-64 mask, the learned positional embedding, the sampled circle
# loss and gradient accumulation over 2 micro-steps.
OPTIONS_CONFIG = ROOT / ".build" / "options" / "3dmatch_options.yaml"
OPTIONS = {"modulated": True, "direct_regress_coor": False,
           "corr_decoder_num_neighbors": 64, "pos_emb_type": "learned",
           "feature_loss_type": "circle_sampled", "circle_n_sample": 256,
           "grad_accum_steps": 2}
OPTIONS_MICRO_STEPS = 4
OPTIONS_DROPOUT = 0.1
# An fp32 distance expansion errs by a few roundings of its largest terms:
# |d - exact| <= FP32_TIE * (|q|^2 + |s|^2) (tests/test_torch_neighbors_
# scan.py measured 2.1 roundings of 2^-24 between two backends).
FP32_TIE = 4 * 2.0 ** -24
# kernels of the training path, in phase 11's checks
STEP_KERNELS = ("flash_attn_fwd", "flash_attn_bwd_dkv", "flash_attn_bwd_dq",
                "segsum", "segment_transpose", "row_gather",
                "neighbor_search")


def options_config():
    """Write OPTIONS_CONFIG: conf/3dmatch.yaml's text and a last section of
    OPTIONS (later sections override earlier keys) -> its config."""
    from regtr_tpu_torch.config import dump_yaml_sections, load_config

    src = ROOT / "conf" / "3dmatch.yaml"
    arch = list(load_config(src)["architecture"])
    check(arch[-3:] == ["resnetb_strided", "resnetb", "resnetb"],
          f"conf/3dmatch.yaml's last three blocks: {arch[-3:]}")
    arch[-3:] = ["resnetb_deformable_strided", "resnetb_deformable",
                 "resnetb_deformable"]
    OPTIONS_CONFIG.parent.mkdir(parents=True, exist_ok=True)
    OPTIONS_CONFIG.write_text(src.read_text() + "\n" + dump_yaml_sections(
        {"options": dict(OPTIONS, architecture=arch)}))
    return load_config(OPTIONS_CONFIG)


class FixedBatches:
    """The trainer's loader interface over fixed collated batches."""

    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass

    def __iter__(self):
        return ((b, None) for b in self.batches)


def tables_match(got, ref, queries, supports, radius):
    """tests/test_torch_pyramid.py's rule for two neighbor tables (numpy,
    (B, Nq, K)), on exact (float64) distances with each window widened by
    what the brute search's fp32 expansion |q|^2 - 2 q.s + |s|^2 may err:
    rows equal as sets, except points within one bf16 step of the K-th
    slot's distance in rows full in both, and points within two bf16 steps
    of the acceptance threshold r^2 * 1.004.  At room coordinates (|q|^2
    ~ 18 m^2) the expansion errs by up to ~0.3 bf16 steps of a distance
    near r^2, so two points 1.25 steps apart can round to one bf16 value
    (the rule on bf16 roundings of exact distances would call them 2 steps
    apart).  A row's slack is sized from the points that row's tables name
    (the differing points and the K-th slots), not from the whole cloud.
    -> (rows that differ, the first row that breaks the rule or None, the
    widest slack of a differing row in bf16 steps at the threshold)."""
    ns, k = supports.shape[-2], got.shape[-1]
    thr = float(np.float32(radius * radius) * np.float32(1.004))
    s_sq = (supports.astype(np.float64) ** 2).sum(-1)

    def ulp(x):
        return 2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7)

    g_sorted = np.sort(np.where(got < ns, got, ns), -1)
    r_sorted = np.sort(np.where(ref < ns, ref, ns), -1)
    rows = np.nonzero((g_sorted != r_sorted).any(-1))
    widest = 0.0
    for b, i in zip(*rows):
        g = set(got[b, i][got[b, i] < ns].tolist())
        r = set(ref[b, i][ref[b, i] < ns].tolist())
        q = queries[b, i].astype(np.float64)
        # two of the row's points' distances, each within FP32_TIE of its
        # expansion
        slack = 2 * FP32_TIE * ((q * q).sum() + s_sq[b, sorted(g | r)].max())
        widest = max(widest, slack / ulp(thr))

        def d2(idx):
            return ((supports[b, sorted(idx)].astype(np.float64) - q)
                    ** 2).sum(-1)

        diff = d2(g ^ r)
        at_thr = np.abs(diff - thr) <= 2 * ulp(thr) + slack
        if len(g) == len(r) == k:
            kth = max(d2(g).max(), d2(r).max())
            tie = ((kth - diff <= ulp(kth) + slack)
                   & (diff >= d2(g & r).max(initial=0.0) - ulp(kth)
                      - slack))
            good = np.all(tie | at_thr)
        else:
            good = np.all(at_thr)
        if not good:
            return len(rows[0]), (
                f"cloud {b} row {i}: {len(g)} vs {len(r)} points, only in "
                f"the first {sorted(g - r)} at {d2(g - r).tolist()}, only "
                f"in the second {sorted(r - g)} at {d2(r - g).tolist()}, "
                f"common up to {d2(g & r).max(initial=0.0)}, threshold "
                f"{thr}, slack {slack:.3e}"), widest
    return len(rows[0]), None, widest


def options_searches(cfg, pts, mask, smi):
    """Phase 11(d): one pair's pyramid (pts (2, N0, 3), mask (2, N0)) by
    the brute, scan and grid searches, every kernel launch of theirs held
    to its plain version on the same inputs and the scan and grid tables to
    the brute search's by tables_match; then K5b timed on the largest of
    the searches' inputs.  -> the searches' times and launches, and K5b's
    kernels-line numbers."""
    import torch

    from regtr_tpu_torch.ops.gather import (element_gather,
                                            element_gather_reference)
    from regtr_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    spec = make_pyramid_spec(cfg, pts.shape[1])
    pyramids, search, held, keep = {}, {}, {}, {}
    for method in ("brute", "scan", "grid"):
        held[method] = {}
        _zero_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with held_to_plain(held[method], keep):
            pyramids[method] = build_pyramid(
                pts, mask, spec, method=method,
                chunk=int(cfg["neighbor_chunk"]),
                cell_cap=int(cfg.get("cell_capacity", 32)))
            torch.cuda.synchronize()
        search[method] = dict(ms=(time.perf_counter() - t) * 1e3,
                              launches=_launch_counts())
    for method, found in held.items():
        for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
            log(f"  {method}: {name} {list(shape)} {dtype}: {calls} "
                f"launches, largest |kernel - plain| {err:.3e}")
    used = {m: {k: n for k, n in v["launches"].items() if n}
            for m, v in search.items()}
    check(used["brute"] == {"neighbor_search": searches_per_pyramid(cfg)}
          and set(used["scan"]) == {"element_gather"}
          and set(used["grid"]) == {"element_gather", "row_gather"}
          and all(ok for found in held.values() for *_, ok in found.values())
          and all(sum(c for (nm, *_), (c, *_) in held[m].items() if nm == k)
                  == n for m in used for k, n in used[m].items()),
          f"searches' launches {used}: brute K6, scan K5b, grid K5b and "
          "K5a, each launch bitwise its plain version (the plain brute "
          "search, torch.gather, index_select) on the same inputs")
    differ, slack = {}, {}
    for method in ("scan", "grid"):
        for li, (lv, ref) in enumerate(zip(pyramids[method],
                                           pyramids["brute"])):
            r = spec.radii[li]
            for name, qi, si, radius in (("neighbors", li, li, r),
                                         ("pools", li + 1, li, r),
                                         ("upsamples", li, li + 1, 2 * r)):
                if getattr(lv, name) is None:
                    continue
                n, broken, widest = tables_match(
                    getattr(lv, name).cpu().numpy(),
                    getattr(ref, name).cpu().numpy(),
                    pyramids["brute"][qi].points.cpu().numpy(),
                    pyramids["brute"][si].points.cpu().numpy(), radius)
                differ[f"{method} L{li} {name}"] = n
                slack[f"{method} L{li} {name}"] = widest
                check(broken is None, f"{method} level {li} {name}: the "
                      f"brute search's table by tests/test_torch_pyramid."
                      f"py's rule ({n} rows differ; {broken})")
    log(f"searches of one pair's pyramid ({smi}): " + ", ".join(
        f"{m} {v['ms']:.1f} ms" for m, v in search.items()) + " (host "
        "clock, synchronized; the kernel checks in); rows differing from "
        "brute's (the widest slack of such a row, in bf16 steps of the "
        "threshold): " + ", ".join(f"{k} {n} ({slack[k]:.2f})"
                                   for k, n in differ.items()))
    # K5b at the scan's merge shape, on the search's own inputs
    src, idx, axis = keep["args"]
    out = element_gather_reference(src, idx, axis)

    def kernel():
        return element_gather(src, idx, axis)

    def library():
        return torch.gather(src, src.dim() - 2 + axis, idx)

    # in turns (kernel, library, library, kernel), single launches and runs
    # of 10 (b2b: nearer the device's time, the wrappers' host time hidden)
    turns = [cuda_ms(kernel), cuda_ms(library), cuda_ms(library),
             cuda_ms(kernel)]
    b2b = [cuda_ms(kernel, reps=10), cuda_ms(library, reps=10),
           cuda_ms(library, reps=10), cuda_ms(kernel, reps=10)]
    ms, lib_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    b2b_ms, b2b_lib_ms = (b2b[0] + b2b[3]) / 2, (b2b[1] + b2b[2]) / 2
    # the data this gather needs: each index and output once, and the
    # gathered elements of src (not its whole rows)
    bnd = bound(0, idx.numel() * 8 + 2 * out.numel() * 4, "float32")
    log(f"  K5b at the search's shape, src {list(src.shape)} int32, idx "
        f"{list(idx.shape)}: kernel {ms:.4f} ms, b2b {b2b_ms:.4f} (bound "
        f"{bnd[0]:.4f}, {bnd[1]}), torch.gather {lib_ms:.4f} ms, b2b "
        f"{b2b_lib_ms:.4f} (turns {' / '.join(f'{x:.4f}' for x in turns)}"
        f", b2b {' / '.join(f'{x:.4f}' for x in b2b)}; medians of 30, "
        f"CUDA events)")
    # the largest |kernel - plain| of the searches' K5b launches (held above)
    k5b_err = max(err for found in held.values()
                  for (nm, *_), (_, err, _) in found.items()
                  if nm == "element_gather")
    return dict(
        ms={m: v["ms"] for m, v in search.items()},
        launches={k: search["scan"]["launches"][k]
                  + search["grid"]["launches"][k]
                  for k in search["scan"]["launches"]},
        launches_by_method=used,
        k5b=dict(shape=list(src.shape), idx_shape=list(idx.shape),
                 axis=axis, dtype="int32", max_abs_err=k5b_err, ms=ms,
                 plain_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1],
                 library_ms=lib_ms, back_to_back_ms=b2b_ms,
                 library_back_to_back_ms=b2b_lib_ms))


def phase_options():
    """The model and training options at the full width of
    conf/3dmatch.yaml (OPTIONS_CONFIG): (a) the bf16 forward on 4 pairs,
    each K1 and K5a launch of one pair held to its plain version; (b) the
    trainer over OPTIONS_MICRO_STEPS micro-steps (fp32, 2 pairs, bucket
    24576; 2 updates), the last micro-step's kernel launches held to their
    plain versions; (c) compute_loss and its backward with dropout (dense
    attention), seeded; (d) one pair's pyramid by the 'scan' and 'grid'
    searches, their K5b and (grid) K5a launches held bitwise to their plain
    versions and their tables to the brute search's.  Returns the launches
    and the numbers."""
    import tempfile

    import torch

    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import trainer

    t_phase = time.perf_counter()
    cfg = options_config()
    log(f"== phase 11: the options at the width of conf/3dmatch.yaml "
        f"({OPTIONS_CONFIG.relative_to(ROOT)}: {OPTIONS}, the last three "
        f"blocks {cfg['architecture'][-3:]})")
    smi = card_line()
    result = {}

    # (a) inference: bf16, 4 pairs at bucket N0
    cfg_a = dict(cfg, compute_dtype="bfloat16")
    model = create_model(cfg_a, N0, DEVICE, seed=0)
    pts_np, mask_np = synthetic_pairs(N_PAIRS, N_POINTS, seed=3)
    pts = torch.from_numpy(pts_np).to(DEVICE)
    mask = torch.from_numpy(mask_np).to(DEVICE)
    with torch.inference_mode():
        model(pts, mask)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(3):
            _zero_launch_counts()
            t = time.perf_counter()
            out = model(pts, mask)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            launches = _launch_counts()
    peak = torch.cuda.max_memory_allocated()
    n_layers = cfg["num_encoder_layers"]
    nc = model.spec.capacities[-1]
    for key, shape in (("corr", (n_layers, 2 * N_PAIRS, nc, 3)),
                       ("overlap_logits", (n_layers, 2 * N_PAIRS, nc)),
                       ("pose", (n_layers, N_PAIRS, 3, 4))):
        check(tuple(out[key].shape) == shape
              and bool(torch.isfinite(out[key].float()).all()),
              f"options forward: {key} finite, shape {shape}")
    fwd_ms = statistics.median(times) * 1e3
    check(launches["flash_attn_fwd"] == 2 * n_layers
          and launches["row_gather"] > 0
          and launches["neighbor_search"] == searches_per_pyramid(cfg)
          and launches["element_gather"] == launches["segsum"] == 0,
          f"options forward ({N_PAIRS} pairs) launches {launches}")
    found = {}
    with torch.inference_mode(), held_to_plain(found):
        _zero_launch_counts()
        model(pts[:2], mask[:2])
        torch.cuda.synchronize()
    per_pair = _launch_counts()
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    check(all(ok for *_, ok in found.values())
          and sum(c for (nm, *_), (c, *_) in found.items()
                  if nm == "flash_attn_fwd") == 2 * n_layers
          and sum(c for (nm, *_), (c, *_) in found.items()
                  if nm == "row_gather") == per_pair["row_gather"] > 0
          and sum(c for (nm, *_), (c, *_) in found.items()
                  if nm == "neighbor_search") == per_pair["neighbor_search"]
          == searches_per_pyramid(cfg),
          f"one pair's forward: each of its {sum(per_pair.values())} "
          f"launches {per_pair} within its tolerance of its plain version")
    log(f"options forward ({smi}): {fwd_ms:.1f} ms per batch of {N_PAIRS} "
        f"pairs ({N_PAIRS / fwd_ms * 1e3:.3f} pairs/s; median of 3, host "
        f"clock), peak {peak / 2**30:.2f} GiB")
    result["inference"] = dict(ms=fwd_ms, launches_per_pair=per_pair,
                               peak_gib=peak / 2**30)
    del model, out, pts, mask
    torch.cuda.empty_cache()

    # (b) the trainer: fp32, 2 pairs, micro-steps of grad_accum_steps 2
    n_pairs = int(cfg["train_batch_size"])
    batches = [collate_pairs(synthetic_samples(n_pairs, N_POINTS, seed, cfg),
                             cfg["buckets"])[0] for seed in (4, 5)]
    n0 = batches[0]["points"].shape[1]
    model = create_model(cfg, n0, DEVICE, seed=0)
    record, found = [], {}
    real_make = trainer.make_train_step

    def make(model_, optimizer, cfg_):
        step = real_make(model_, optimizer, cfg_)
        prev = [p.detach().clone() for p in optimizer.params]

        def run(batch):
            last = len(record) == OPTIONS_MICRO_STEPS - 1
            _zero_launch_counts()
            with held_to_plain(found) if last else contextlib.nullcontext():
                metrics = step(batch)
                torch.cuda.synchronize()
            moved = any(not torch.equal(a, b)
                        for a, b in zip(prev, optimizer.params))
            prev[:] = [p.detach().clone() for p in optimizer.params]
            record.append(dict(total=float(metrics["total"]),
                               skipped=metrics["update_skipped"],
                               launches=_launch_counts(), moved=moved,
                               position=optimizer.position))
            return metrics

        return run

    work = Path(tempfile.mkdtemp(prefix="chip_smoke_options_"))
    trainer.make_train_step = make
    torch.cuda.reset_peak_memory_stats()
    try:
        run = trainer.Trainer(cfg, work, summary_every=4, validate_every=0,
                              nb_sanity_val_steps=0)
        run.fit(model, FixedBatches(batches), None,
                niter=OPTIONS_MICRO_STEPS)
    finally:
        trainer.make_train_step = real_make
        close_port_logger()
        shutil.rmtree(work, ignore_errors=True)
    for i, r in enumerate(record):
        log(f"  micro-step {i + 1}: loss {r['total']:.5f}, parameters "
            f"{'moved' if r['moved'] else 'unchanged'}, (updates, "
            f"micro-steps) {r['position']}, launches {r['launches']}")
    step_launches = record[0]["launches"]
    check(len(record) == OPTIONS_MICRO_STEPS
          and all(np.isfinite(r["total"]) and r["skipped"] == 0.0
                  for r in record),
          f"{OPTIONS_MICRO_STEPS} micro-steps, every loss finite, none "
          "skipped")
    check([r["moved"] for r in record] == [False, True] * (
        OPTIONS_MICRO_STEPS // 2)
          and record[-1]["position"] == (OPTIONS_MICRO_STEPS // 2, 0),
          "grad_accum_steps 2: the parameters unchanged after micro-steps "
          "1 and 3, changed after 2 and 4 (2 updates)")
    check(all(r["launches"] == step_launches for r in record)
          and all(step_launches[k] > 0 for k in STEP_KERNELS)
          and step_launches["element_gather"] == 0,
          f"every micro-step launches {step_launches}")
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    check(all(ok for *_, ok in found.values())
          and all(sum(c for (nm, *_), (c, *_) in found.items() if nm == k)
                  == step_launches[k] for k in STEP_KERNELS),
          f"the last micro-step: each of its launches of "
          f"{len(STEP_KERNELS)} kernels within its tolerance of its plain "
          "version on the same inputs")
    steps_ms = [t * 1e3 for t in run.timing["step_s"]]
    peak = torch.cuda.max_memory_allocated()
    log(f"options micro-steps ({smi}): " + " ".join(
        f"{t:.1f}" for t in steps_ms) + " ms (host clock; the last held "
        f"to the plain versions), peak {peak / 2**30:.2f} GiB")
    result["training"] = dict(micro_step_ms=statistics.median(steps_ms[1:-1]),
                              launches_per_micro_step=step_launches,
                              bucket=n0, peak_gib=peak / 2**30)

    # (c) dropout: compute_loss and its backward, seeded
    model_d = create_model(dict(cfg, dropout=OPTIONS_DROPOUT), n0, DEVICE,
                           seed=1)
    model_d.load_state_dict(model.state_dict())
    del model
    batch = {k: torch.from_numpy(v).to(DEVICE)
             for k, v in batches[0].items() if k in
             ("points", "mask", "pose", "overlap0")}
    params = list(model_d.parameters())
    runs, times = [], []
    torch.cuda.reset_peak_memory_stats()
    for seed in (0, 0, 1):
        gen = torch.Generator(device=DEVICE).manual_seed(seed)
        _zero_launch_counts()
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses, _ = model_d.compute_loss(batch["points"], batch["mask"],
                                         batch["pose"], batch["overlap0"],
                                         generator=gen)
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        runs.append((losses["total"].detach(), grads, _launch_counts()))
    (l0, g0, used), (l1, g1, _), (l2, g2, _) = runs
    peak = torch.cuda.max_memory_allocated()
    log(f"dropout {OPTIONS_DROPOUT}: losses {float(l0):.6f} / "
        f"{float(l1):.6f} (seed 0), {float(l2):.6f} (seed 1); launches "
        f"{used}; compute_loss + backward " + " ".join(
            f"{t * 1e3:.1f}" for t in times) + f" ms, peak "
        f"{peak / 2**30:.2f} GiB")
    same = torch.equal(l0, l1) and all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in zip(g0, g1))
    check(bool(torch.isfinite(l0)) and all(
        g is None or bool(torch.isfinite(g).all()) for g in g0),
        "dropout step: loss and gradients finite")
    check(same, "dropout step bitwise repeatable with one seed")
    check(not torch.equal(l0, l2), "another seed, another loss")
    check(used["flash_attn_fwd"] == used["flash_attn_bwd_dkv"]
          == used["flash_attn_bwd_dq"] == 0
          and all(used[k] == step_launches[k]
                  for k in ("row_gather", "segsum", "segment_transpose",
                            "neighbor_search")),
          f"dropout step launches {used}: attention dense (K1, K2, K3 "
          "none by design), the gathers, their transposes and the "
          "neighbor searches as a micro-step's")
    result["dropout"] = dict(ms=statistics.median(times) * 1e3,
                             launches=used, peak_gib=peak / 2**30)
    del model_d, runs, g0, g1, g2, grads
    torch.cuda.empty_cache()

    # (d) the neighbor searches on one pair's pyramid at bucket N0
    result["search"] = options_searches(
        cfg, torch.from_numpy(pts_np[:2]).to(DEVICE),
        torch.from_numpy(mask_np[:2]).to(DEVICE), smi)
    torch.cuda.empty_cache()
    log(f"phase 11: {time.perf_counter() - t_phase:.1f} s")
    return result


# Phase 12: data parallelism (regtr_tpu_torch/parallel/dist.py) through
# python -m torch.distributed.run, and rematerialization at full width.
# Its work files live in PHASE12; phases 6 and 8 leave their references
# there.
PHASE12 = ROOT / ".build" / "phase12"
DP_TRAINER_STEPS = 4        # (b): the two ranks' run, validation every 2
DP_TIMEOUT_S = 600          # a launch of the ranks, killed whole after it
ALLREDUCE_REPS = 5
REMAT_3DMATCH_BUCKET = 24576


def launch_ranks(nproc, args, what, cwd=ROOT):
    """python -m torch.distributed.run --standalone --nproc_per_node nproc
    args, in a session of its own, killed with every rank after
    DP_TIMEOUT_S; fails unless every rank exits 0."""
    import signal

    t = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(nproc), *args], cwd=cwd,
        env=dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="4"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=DP_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
    log(f"{what}: exit {proc.returncode} in {time.perf_counter() - t:.1f} s "
        f"(host clock, the ranks' start included)")
    if proc.returncode != 0:
        log(out[-6000:])
    check(proc.returncode == 0, f"{what}: every rank exits 0")
    return out


def rank_worker(kind, out, *args):
    """One rank of a phase 12 launch: `chip_smoke.py --rank-worker trainer
    OUT ARGS` runs the trainer's command line main(ARGS) and saves this
    rank's parameters, losses, launches per step, step times and peak
    memory to OUT/rank{r}.pt; `--rank-worker first_step OUT` takes the
    first step of phase 6's two-pair batch with one pair per rank over
    Gloo on cuda:0, writes its loss, a digest of its reduced gradients and
    the all-reduce's times to OUT/first_step_rank{r}.json and rank 0's
    reduced gradients to OUT/first_step_dp_grads.pt; then the sampled
    circle loss on its pair (`sampled_draws`) to OUT/circle_rank{r}.pt.
    """
    sys.path.insert(0, str(ROOT))
    import torch

    from regtr_tpu_torch.parallel import dist

    out, rank = Path(out), int(os.environ.get("RANK", "0"))
    if kind == "trainer":
        from regtr_tpu_torch.train import __main__ as train_cli

        record, latest = [], {}
        with recorded_train_steps(record, latest):
            trainer = train_cli.main(list(args))
        torch.cuda.synchronize()
        torch.save({"params": [p.detach().cpu()
                               for p in trainer.optimizer.params],
                    "totals": [float(t) for t, _, _ in record],
                    "skipped": [float(s) for _, s, _ in record],
                    "launches": [n for _, _, n in record],
                    "step_s": trainer.timing["step_s"],
                    "peak_bytes": torch.cuda.max_memory_allocated()},
                   out / f"rank{rank}.pt")
        return
    if kind != "first_step":
        raise SystemExit(f"FAILED: unknown rank worker {kind!r}")
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps
    from regtr_tpu_torch.train.optim import Optimizer

    device = torch.device("cuda:0")
    check(dist.init_distributed("gloo", device, timeout=DP_TIMEOUT_S)
          and dist.world_size() == 2, "two ranks over Gloo")
    try:
        data = np.load(out / "first_step.npz")
        cfg = threedmatch_config()
        n0 = data["points"].shape[1]
        model = create_model(cfg, n0, device, seed=0)
        share = {k: (data[k][rank:rank + 1] if k == "pose"
                     else data[k][2 * rank:2 * rank + 2])
                 for k in steps.BATCH_KEYS}
        batch = steps.batch_to_device(share, device)
        opt = Optimizer(model.parameters(), cfg)
        losses, _ = steps.forward_loss(model, batch)
        grads, grad_norm = steps.backward(opt, losses["total"])
        total = float(steps.global_losses(losses)["total"])
        times = []
        for _ in range(ALLREDUCE_REPS):
            torch.cuda.synchronize()
            dist.barrier()
            t = time.perf_counter()
            dist.all_reduce_sum_flat(grads)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        if rank == 0:
            torch.save([g.cpu() for g in grads],
                       out / "first_step_dp_grads.pt")
        (out / f"first_step_rank{rank}.json").write_text(json.dumps({
            "n0": n0, "total": total, "grad_norm": float(grad_norm),
            "grad_bytes": 4 * sum(g.numel() for g in grads),
            "allreduce_ms": [x * 1e3 for x in times],
            "digest": float(sum(float(g.double().abs().sum())
                                for g in grads))}))
        del model, opt, losses, grads
        torch.save(sampled_draws(cfg, batch, n0),
                   out / f"circle_rank{rank}.pt")
    finally:
        dist.shutdown()


def sampled_draws(cfg, batch, n0):
    """C3: the sampled circle loss (`feature_loss_type: circle_sampled`)
    of a model of cfg's widths from seed 0 on `batch`, forward and
    backward: -> {'losses': the global losses, 'draws': every draw of the
    sampler (idx_a, idx_b, valid) on the CPU, in order, 'launches'}."""
    import torch

    from regtr_tpu_torch.losses import feature
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps

    model = create_model(dict(cfg, feature_loss_type="circle_sampled"), n0,
                         batch["points"].device, seed=0)
    draws, real = [], feature.sample_correspondences

    def recorded(*args):
        drawn = real(*args)
        draws.append([t.cpu() for t in drawn])
        return drawn

    feature.sample_correspondences = recorded
    before = _launch_counts()
    try:
        losses, _ = steps.forward_loss(model, batch)
        torch.autograd.grad(losses["total"], list(model.parameters()),
                            allow_unused=True)
    finally:
        feature.sample_correspondences = real
    torch.cuda.synchronize()
    return {"losses": {k: float(v.detach()) for k, v in
                       steps.global_losses(losses).items()},
            "draws": draws,
            "launches": {k: v - before[k]
                         for k, v in _launch_counts().items()}}


def remat_steps(cfg, batch, what, runs=5):
    """Forward and backward (no update) of a model made from seed 0 with
    cfg's remat off and on, `runs` times each: the first run's gradients
    bitwise equal, the peak memory and the median time of the runs after
    the first of each; then one remat run with each kernel launch held to
    its plain version."""
    import torch

    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps
    from regtr_tpu_torch.train.optim import Optimizer

    n0 = batch["points"].shape[1]
    grads, stats, found = {}, {}, {}
    for key, remat in (("off", False), ("on", True), ("held", True)):
        model = create_model(dict(cfg, remat=remat), n0, DEVICE, seed=0)
        opt = Optimizer(model.parameters(), cfg)
        times = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for i in range(1 if key == "held" else runs):
            before = _launch_counts()
            with contextlib.ExitStack() as stack:
                if key == "held":
                    stack.enter_context(held_to_plain(found))
                t = time.perf_counter()
                losses, _ = steps.forward_loss(model, batch)
                g, _ = steps.backward(opt, losses["total"])
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t) * 1e3)
            # held_to_plain folds kpconv's counts back on its exit
            launches = {k: v - before[k] for k, v in
                        _launch_counts().items()}
            if i == 0:
                grads[key] = g
        stats[key] = dict(ms=statistics.median(times[1:] or times),
                          peak=torch.cuda.max_memory_allocated(),
                          launches=launches)
        del model, opt, losses, g
    check(all(torch.equal(a, b) for a, b in zip(grads["off"], grads["on"])),
          f"{what}: one step's gradients with remat on bitwise those with "
          f"it off, over all {len(grads['off'])} parameters")
    on, off = stats["on"], stats["off"]
    log(f"{what} ({card_line()}): forward + backward {off['ms']:.1f} ms and "
        f"peak memory {off['peak'] / 2**30:.3f} GiB with remat off, "
        f"{on['ms']:.1f} ms and {on['peak'] / 2**30:.3f} GiB with it on "
        f"(host clock, synchronized, the median of the {runs - 1} runs "
        f"after each model's first); launches per run off "
        f"{off['launches']}, on {on['launches']}")
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    check(all(ok for *_, ok in found.values())
          and {k[0] for k in found} == set(TRAINER_KERNELS)
          and on["launches"] == stats["held"]["launches"]
          and all(on["launches"][k] >= off["launches"][k] > 0
                  for k in TRAINER_KERNELS),
          f"{what}: each of the remat step's "
          f"{sum(on['launches'].values())} launches within its tolerance of "
          f"its plain version on the same inputs (the recompute's forward "
          f"launches included)")
    return dict(off=off, on=on)


def per_pair_step_grads(batch_np):
    """The first step's gradients of phase 6's two pairs in one process,
    taken as the two ranks take them: one pair per forward and backward,
    each over both pairs' denominators, the two gradients summed.  The
    collectives are stood in for: a first pass records each pair's own
    denominators, and the second replays their sums (the gradients' own
    all-reduce, after them, passes its buffer through)."""
    import torch
    import torch.distributed as tdist

    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.parallel import dist
    from regtr_tpu_torch.train import steps
    from regtr_tpu_torch.train.optim import Optimizer

    cfg = threedmatch_config()
    model = create_model(cfg, batch_np["points"].shape[1], DEVICE, seed=0)
    opt = Optimizer(model.parameters(), cfg)
    shares = [steps.batch_to_device(
        {k: (batch_np[k][r:r + 1] if k == "pose"
             else batch_np[k][2 * r:2 * r + 2]) for k in steps.BATCH_KEYS},
        DEVICE) for r in range(2)]
    mode = {"record": None, "replay": iter(())}

    def all_reduce(buf):
        if mode["record"] is not None:
            mode["record"].append(buf.clone())
            return
        total = next(mode["replay"], None)
        if total is not None:
            buf.copy_(total)

    real = (dist.world_size, dist._comm_device, tdist.all_reduce)
    dist.world_size = lambda: 2
    dist._comm_device = lambda: torch.device(DEVICE)
    tdist.all_reduce = all_reduce
    try:
        own = [[], []]
        for r in range(2):
            mode["record"] = own[r]
            with torch.no_grad():
                steps.forward_loss(model, shares[r])
        mode["record"] = None
        grads = []
        for r in range(2):
            mode["replay"] = iter([a + b for a, b in zip(*own)])
            losses, _ = steps.forward_loss(model, shares[r])
            grads.append(steps.backward(opt, losses["total"])[0])
    finally:
        dist.world_size, dist._comm_device, tdist.all_reduce = real
    names = [n for n, _ in model.named_parameters()]
    return names, [a + b for a, b in zip(*grads)]


C1_WORST = 6           # the leaves whose cancellation ratios are reported
C1_APART = 2.0         # conditioning: alone and twice this near in distance
C1_RATIO = 100.0       # ... and the worst leaves' sums cancel this much
C2_FARTHER = 1.5       # C2: the ranks at most this much farther from fp64
TOL_SAMPLED = 1e-5     # C3: the ranks' sampled circle losses, relative


@contextlib.contextmanager
def float64_for_float32():
    """Inside, every float32 the port asks for is float64: `Tensor.float`
    and `Tensor.to(float32)` give float64, and the factories asked for
    float32 make float64.  The port casts to fp32 where it accumulates
    (fp32 sums of bf16 operands); this runs the same code in fp64, on the
    plain route (the kernels take fp32 and bf16 only).  A tensor that
    stayed fp32 would meet an fp64 one in a product and raise."""
    import torch

    f32, f64 = torch.float32, torch.float64
    real_float, real_to = torch.Tensor.float, torch.Tensor.to
    names = ("zeros", "ones", "empty", "full", "arange", "tensor",
             "as_tensor")
    real = {n: getattr(torch, n) for n in names}

    def to(self, *args, **kw):
        args = tuple(f64 if a is f32 else a for a in args)
        if kw.get("dtype") is f32:
            kw["dtype"] = f64
        return real_to(self, *args, **kw)

    def factory(fn):
        def make(*args, **kw):
            if kw.get("dtype") is f32:
                kw["dtype"] = f64
            return fn(*args, **kw)
        return make

    torch.Tensor.float = lambda self, *a, **kw: real_to(self, f64)
    torch.Tensor.to = to
    for n, fn in real.items():
        setattr(torch, n, factory(fn))
    try:
        yield
    finally:
        torch.Tensor.float, torch.Tensor.to = real_float, real_to
        for n, fn in real.items():
            setattr(torch, n, fn)


def levels_as(levels, dtype=None, times=1):
    """The pyramid's levels with their coordinates cast to `dtype` and
    every field repeated `times` along the batch (a batch of the same
    pairs `times` over, on the same tables)."""
    import dataclasses

    import torch

    def one(x):
        if x is None:
            return None
        if dtype is not None and x.is_floating_point():
            x = x.to(dtype)
        return torch.cat([x] * times) if times > 1 else x

    return [dataclasses.replace(lvl, **{f.name: one(getattr(lvl, f.name))
                                        for f in dataclasses.fields(lvl)})
            for lvl in levels]


def _cancellation(rows, grads):
    """A weight gradient sum_r rows_r^T grads_r (rows (R, A), grads (R,
    C)): the norm of its terms' absolute sum over the norm of the sum."""
    rows, grads = rows.double(), grads.double()
    return float((rows.abs().t() @ grads.abs()).norm()
                 / (rows.t() @ grads).norm().clamp_min(1e-300))


def recorded_first_step(model, levels, pose, overlap0, ratios=None):
    """One first step on given levels (no update): -> (gradients per
    parameter, zeros where unused; {encoder block: the gradient of its
    output}).  With a dict `ratios`, the cancellation ratio
    (`_cancellation`) of each backbone KPConv and Linear weight's gradient
    is stored in it by parameter name."""
    import torch

    from regtr_tpu_torch.ops import kpconv

    enc = model.kpf_encoder
    names = {id(p): n for n, p in model.named_parameters()}
    out_grads, handles = {}, []

    def keep(store, key, fn=None):
        def hook(g):
            store[key] = g if fn is None else fn(g)
        return hook

    def on_block(name):
        def hook(mod, args, out):
            out.register_hook(keep(out_grads, name))
        return hook

    def on_linear(key):
        def hook(mod, args, out):
            x = args[0].reshape(-1, args[0].shape[-1])
            out.register_hook(keep(ratios, key, lambda g: _cancellation(
                x, g.reshape(-1, g.shape[-1]))))
        return hook

    for name in enc.block_names:
        if hasattr(enc, name):
            handles.append(getattr(enc, name).register_forward_hook(
                on_block(name)))
    real_apply = kpconv._apply_from_gathered
    if ratios is not None:
        for mname, mod in enc.named_modules():
            if isinstance(mod, torch.nn.Linear):
                handles.append(mod.register_forward_hook(
                    on_linear(f"kpf_encoder.{mname}.weight")))

        def apply(infl, inv_n, neighb_x, weights, compute_dtype,
                  norm="valid"):
            out = real_apply(infl, inv_n, neighb_x, weights, compute_dtype,
                             norm)
            if out.requires_grad and id(weights) in names:
                rows = torch.einsum("bqkp,bqkc->bqpc", infl, neighb_x)
                rows = rows.reshape(-1, rows.shape[-2] * rows.shape[-1])
                out.register_hook(keep(ratios, names[id(weights)],
                                       lambda g: _cancellation(
                                           rows, g.reshape(-1, g.shape[-1])
                                           * inv_n.reshape(-1, 1))))
            return out

        kpconv._apply_from_gathered = apply
    try:
        losses, _ = model.loss_levels(levels, pose, overlap0)
        params = list(model.parameters())
        grads = torch.autograd.grad(losses["total"], params,
                                    allow_unused=True)
    finally:
        kpconv._apply_from_gathered = real_apply
        for h in handles:
            h.remove()
    return ([torch.zeros_like(p) if g is None else g.detach()
             for p, g in zip(params, grads)], out_grads)


def fp64_first_step(model, levels, batch, ratios=None):
    """`recorded_first_step` of a float64 copy of `model` on the plain
    route, `levels` (built in fp32) and the batch cast to float64."""
    import copy

    import torch

    model64 = copy.deepcopy(model).double()
    try:
        with kernel_route("plain"), float64_for_float32():
            return recorded_first_step(
                model64, levels_as(levels, torch.float64),
                batch["pose"].double(), batch["overlap0"].double(), ratios)
    finally:
        del model64


@contextlib.contextmanager
def current_block(model):
    """-> a one-item list holding the name of the encoder block that is
    running its forward (None before the first)."""
    enc, current, handles = model.kpf_encoder, [None], []
    for name in enc.block_names:
        if hasattr(enc, name):
            handles.append(getattr(enc, name).register_forward_pre_hook(
                lambda m, a, name=name: current.__setitem__(0, name)))
    try:
        yield current
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def discrete_choices(model, record, force=None):
    """The encoder's points where the gradient jumps: each leaky ReLU's
    sign pattern (its slope, 1 or 0.1, per element) and each strided
    block's max pool's choice of neighbor (the argmax over the neighbors,
    (B, Nq, C)), appended to `record` as (block, kind, choice) in call
    order.  With `force`, such a record of another run whose choices were
    tiled to this batch, each takes the recorded choice instead of its
    own: the recorded slope, the recorded neighbor."""
    import torch

    from regtr_tpu_torch.nn import blocks
    from regtr_tpu_torch.ops import kpconv

    real_relu, real_fused = blocks.leaky_relu, blocks.kpconv_fused_gather

    def relu(x):
        record.append((current[0], "leaky relu", x.detach() > 0))
        if force is None:
            return real_relu(x)
        return torch.where(force[len(record) - 1][2], x,
                           blocks.LEAKY_SLOPE * x)

    def fused(q_pts, s_pts, index, x, x_extra, *args, **kw):
        if x_extra is None:
            return real_fused(q_pts, s_pts, index, x, x_extra, *args, **kw)
        padded = kpconv._pad_row(x_extra, 0.0)
        rows = torch.stack([padded[b][index.inds[b]]
                            for b in range(padded.shape[0])])
        record.append((current[0], "max pool", rows.detach().argmax(dim=2)))
        if force is None:
            return real_fused(q_pts, s_pts, index, x, x_extra, *args, **kw)
        out, _, geom = real_fused(q_pts, s_pts, index, x, None, *args, **kw)
        choice = force[len(record) - 1][2]
        return out, rows.gather(2, choice[:, :, None, :])[:, :, 0], geom

    with current_block(model) as current:
        blocks.leaky_relu, blocks.kpconv_fused_gather = relu, fused
        try:
            yield
        finally:
            blocks.leaky_relu, blocks.kpconv_fused_gather = (real_relu,
                                                             real_fused)


def batch_shape_study(batch_np):
    """C1 (ROADMAP.md Queue C): phase 6's first pair at its bucket, three
    first steps on one set of pyramid tables, built once in fp32: (i)
    alone, fp32, and (ii) in a batch of itself twice, fp32 (the same loss:
    every numerator and denominator doubles), both on the kernels; (iii)
    alone in float64 on the plain route; and (ii') as (ii) on (i)'s
    choices at the encoder's points where the gradient jumps
    (`discrete_choices`: the leaky ReLU slopes, the max-pool neighbors).
    Per leaf the distances, the worst leaves' cancellation ratios, per
    encoder block the distance of its output gradient (twice: the sum over
    the two copies), and the choices that differ between (i) and (ii) ->
    a dict with the verdict, 'conditioning' or 'fault'."""
    import torch

    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps

    cfg = threedmatch_config()
    model = create_model(cfg, batch_np["points"].shape[1], DEVICE, seed=0)
    names = [n for n, _ in model.named_parameters()]
    pair = steps.batch_to_device(
        {k: batch_np[k][:1] if k == "pose" else batch_np[k][:2]
         for k in steps.BATCH_KEYS}, DEVICE)
    with torch.no_grad():
        levels = model.preprocess(pair["points"], pair["mask"])
    doubled = (levels_as(levels, times=2), torch.cat([pair["pose"]] * 2),
               torch.cat([pair["overlap0"]] * 2))
    chosen = {"alone": [], "twice": [], "forced": []}
    torch.cuda.synchronize()
    t = time.perf_counter()
    with discrete_choices(model, chosen["alone"]):
        alone, blocks_alone = recorded_first_step(
            model, levels, pair["pose"], pair["overlap0"])
    with discrete_choices(model, chosen["twice"]):
        twice, blocks_twice = recorded_first_step(model, *doubled)
    torch.cuda.synchronize()
    fp32_s = time.perf_counter() - t
    flips = {}
    for (name, kind, a), (_, _, b) in zip(chosen["alone"], chosen["twice"]):
        key = (name, kind)
        flips[key] = flips.get(key, 0) + int((torch.cat([a, a]) != b).sum())
    # (ii) once more, with (i)'s choices at every point where the gradient
    # jumps
    with discrete_choices(model, chosen["forced"], force=[
            (n, k, torch.cat([c, c])) for n, k, c in chosen["alone"]]):
        forced, _ = recorded_first_step(model, *doubled)
    ratios = {}
    t = time.perf_counter()
    exact, blocks_exact = fp64_first_step(model, levels, pair, ratios)
    torch.cuda.synchronize()
    fp64_s = time.perf_counter() - t

    def dist(a, b):
        return float((a.double() - b.double()).norm()
                     / b.double().norm().clamp_min(1e-300))

    rows = [(dist(a, c), dist(b, c), dist(a, b), n, dist(a, f))
            for n, a, b, c, f in zip(names, alone, twice, exact, forced)
            if float(c.norm()) > 1e-6 and not n.endswith("k_proj.bias")]
    worst = sorted(rows, key=lambda r: -r[2])[:C1_WORST]
    median = [sorted(r[k] for r in rows)[len(rows) // 2] for k in (0, 1)]
    # every leaf's distances, for a reader of the run's files
    PHASE12.mkdir(parents=True, exist_ok=True)
    (PHASE12 / "c1_leaves.json").write_text(json.dumps(
        {n: {"i_iii": a, "ii_iii": b, "i_ii": c, "i_ii_forced": f,
             "cancellation": ratios.get(n)} for a, b, c, n, f in rows},
        indent=1))
    log(f"C1 ({card_line()}): phase 6's first pair at bucket "
        f"{batch_np['points'].shape[1]}, one set of fp32 tables; (i) alone "
        f"and (ii) twice on the kernels ({fp32_s:.1f} s), (iii) alone in "
        f"float64 on the plain route ({fp64_s:.1f} s); (ii') as (ii) on "
        f"(i)'s leaky ReLU slopes and max-pool neighbors; relative L2 per "
        f"leaf, the worst {C1_WORST} by (i)-(ii):")
    for a, b, c, n, f in worst:
        log(f"  {n}: (i)-(iii) {a:.3e}, (ii)-(iii) {b:.3e}, (i)-(ii) "
            f"{c:.3e}, (i)-(ii') {f:.3e}; weight-sum cancellation ratio "
            f"{ratios.get(n, float('nan')):.3e}")
    spread = {}
    for what, k in (("(i)-(iii)", 0), ("(ii)-(iii)", 1), ("(i)-(ii)", 2),
                    ("(i)-(ii')", 4)):
        vals = sorted(r[k] for r in rows)
        spread[what] = (vals[len(vals) // 2], vals[-1])
        log(f"  {what} over {len(rows)} leaves: median {spread[what][0]:.3e}, "
            f"worst {spread[what][1]:.3e}")
    parted = []
    for name in model.kpf_encoder.block_names[::-1]:   # the backward's order
        if name not in blocks_alone:
            continue
        g1, g3 = blocks_alone[name], blocks_exact[name]
        n = g1.shape[0]
        g2 = blocks_twice[name][:n] + blocks_twice[name][n:]
        parted.append((name, dist(g1, g3), dist(g2, g3), dist(g1, g2)))
        log(f"  block {name} output gradient: (i)-(iii) {parted[-1][1]:.3e}, "
            f"(ii)-(iii) {parted[-1][2]:.3e}, (i)-(ii) {parted[-1][3]:.3e}")
    # the first block, in the backward's order, whose output gradients of
    # (i) and (ii) lie 10x farther apart than at the backbone's output
    # (its gradient comes from the backward of the block after it)
    first_parted = next((q[0] for q in parted
                         if q[3] > 10 * max(parted[0][3], 1e-12)), None)
    # conditioning: both routes as far from fp64, on the same leaves, and
    # the function's own sensitivity: weight sums that cancel, or points
    # where the gradient jumps, whose choices alone carry the spread
    near = all(max(a, b) <= C1_APART * min(a, b) for a, b, *_ in worst)
    same = all(a >= 10 * median[0] and b >= 10 * median[1]
               for a, b, *_ in worst)
    cancels = all(ratios.get(r[3], 0.0) >= C1_RATIO for r in worst)
    forced_worst = max(r[4] for r in rows)
    jumps = forced_worst <= 0.1 * worst[0][2]
    verdict = ("conditioning" if near and same and (cancels or jumps)
               else "fault")
    flipped = {f"{n} {k}": v for (n, k), v in flips.items() if v}
    n_choices = sum(c.numel() for *_, c in chosen["alone"])
    log(f"C1: choices that differ between (i) and (ii): "
        f"{flipped or 'none'} (of {n_choices} "
        f"leaky ReLU elements and max-pool choices of (i)); on (i)'s choices "
        f"(ii') lies {forced_worst:.3e} from (i) (worst leaf)")
    log(f"C1: the first block whose output gradients part: "
        f"{first_parted or 'none (the weight sums alone)'}; the worst "
        f"leaves' (i) and (ii) as far from fp64 within {C1_APART}x: {near}; "
        f"those leaves >= 10x the median leaf's distance in both: {same}; "
        f"their weight sums' cancellation >= {C1_RATIO:g}: {cancels}; the "
        f"jumps' choices carry the spread (10x less on (i)'s): {jumps} -> "
        f"{verdict}")
    return dict(verdict=verdict, worst=worst, first_parted=first_parted,
                blocks=parted, fp32_s=fp32_s, fp64_s=fp64_s,
                flips=flipped, forced_worst=forced_worst, spread=spread,
                ratios={r[3]: ratios.get(r[3]) for r in worst})


def grad_leaves(names, a, b):
    """Relative L2 per leaf in float64 (the key biases aside: 0 in exact
    arithmetic), worst first, and over all parameters as one vector."""
    import torch

    def dist(x, y):
        x, y = x.detach().cpu().double(), y.detach().cpu().double()
        return float((x - y).norm() / y.norm())

    errs = sorted(((dist(x, y), n) for n, x, y in zip(names, a, b)
                   if float(y.norm()) > 1e-6
                   and not n.endswith("k_proj.bias")), reverse=True)
    flat = dist(*(torch.cat([t.reshape(-1) for t in g]) for g in (a, b)))
    return errs, flat


def fp64_batch_grads(batch_np):
    """The first step of phase 6's batch in float64 on the plain route
    (`fp64_first_step`), its tables built in fp32: -> gradients."""
    import torch

    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps

    model = create_model(threedmatch_config(), batch_np["points"].shape[1],
                         DEVICE, seed=0)
    batch = steps.batch_to_device(batch_np, DEVICE)
    with torch.no_grad():
        levels = model.preprocess(batch["points"], batch["mask"])
    return fp64_first_step(model, levels, batch)[0]


def phase12_first_step(result):
    """Phase 12(b)'s first step: phase 6's batch with one pair per rank
    over Gloo, held to one process on the ranks' shapes (bitwise-near,
    TOL_GRAD per leaf) and to phase 6's batched step; C1 (the batch
    shape's spread, `batch_shape_study`) decides how: a fault, TOL_GRAD
    per leaf against phase 6's step; conditioning, both held to the
    float64 step, each leaf of the ranks at most C2_FARTHER times as far
    as phase 6's farthest leaf, and their median leaf ratio at most
    C2_FARTHER.
    C3: the ranks' sampled circle loss (`sampled_draws`) draws for each
    pair what one process draws for it, bitwise, and its losses lie
    within TOL_SAMPLED of one process's."""
    import torch

    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.train import steps

    me = str(ROOT / "chip_smoke.py")
    launch_ranks(2, [me, "--rank-worker", "first_step", str(PHASE12)],
                 "(b) phase 6's first step, one pair per rank over Gloo")
    res = [json.loads((PHASE12 / f"first_step_rank{r}.json").read_text())
           for r in range(2)]
    check(res[0]["digest"] == res[1]["digest"],
          "(b) the two ranks' sum-reduced gradients equal")
    batch_np = dict(np.load(PHASE12 / "first_step.npz"))
    names, per_pair = per_pair_step_grads(batch_np)
    ranks = torch.load(PHASE12 / "first_step_dp_grads.pt", weights_only=True)
    batched = torch.load(PHASE12 / "first_step_grads.pt", weights_only=True)
    errs, flat = grad_leaves(names, ranks, per_pair)
    check(errs[0][0] < TOL_GRAD,
          f"(b) the sum-reduced gradients of the two ranks (bucket "
          f"{res[0]['n0']}, fp32) against one process's step on both pairs "
          f"(one pair per forward, both pairs' denominators), leaf by leaf "
          f"over {len(errs)} parameters (the key biases aside): worst rel L2 "
          f"{errs[0][0]:.2e} ({errs[0][1]}; tol {TOL_GRAD}), all as one "
          f"vector {flat:.2e}")
    far = {what: grad_leaves(names, g, batched)
           for what, g in (("ranks", ranks), ("one process", per_pair))}
    log("(b) against phase 6's step on both pairs in one batch: "
        + "; ".join(f"{what}: worst leaf {e[0][0]:.2e} ({e[0][1]}), median "
                    f"{e[len(e) // 2][0]:.2e}, all as one vector {v:.2e}"
                    for what, (e, v) in far.items()))
    check(far["ranks"][1] <= TOL_GRAD
          and far["ranks"][1] <= 1.01 * far["one process"][1],
          f"(b) the ranks' gradients as one vector {far['ranks'][1]:.2e} "
          f"from phase 6's batched step (tol {TOL_GRAD}), as far as one "
          f"process's per-pair step ({far['one process'][1]:.2e})")

    # -- C1, then C2: the per-leaf check its verdict calls for
    c1 = batch_shape_study(batch_np)
    if c1["verdict"] == "fault":
        check(far["ranks"][0][0][0] < TOL_GRAD,
              f"C2: the ranks' gradients against phase 6's batched step, "
              f"leaf by leaf: worst {far['ranks'][0][0][0]:.2e} "
              f"({far['ranks'][0][0][1]}; tol {TOL_GRAD})")
        c2 = dict(worst=far["ranks"][0][0][0])
    else:
        exact = fp64_batch_grads(batch_np)
        to_exact = {what: dict((n, e) for e, n in grad_leaves(
            names, g, exact)[0]) for what, g in (("ranks", ranks),
                                                 ("batched", batched))}
        # a leaf's distance from fp64 is the jumps its route happened to
        # take (C1: the leaky ReLU slopes that the last bits flip), and the
        # two routes take different ones: a leaf of one may lie several
        # times farther than the same leaf of the other.  So each leaf of
        # the ranks is held to the spread the jumps give phase 6's step
        # (its farthest leaf), and the ranks' typical leaf to phase 6's
        ratios = sorted(to_exact["ranks"][n] / e
                        for n, e in to_exact["batched"].items())
        worst = {k: max(v.items(), key=lambda kv: kv[1])
                 for k, v in to_exact.items()}
        median = ratios[len(ratios) // 2]
        log(f"C2: the ranks' and phase 6's batched gradients against the "
            f"float64 step of phase 6's batch, per leaf over {len(ratios)} "
            f"leaves: farthest leaf of the ranks {worst['ranks'][1]:.3e} "
            f"({worst['ranks'][0]}), of phase 6's step "
            f"{worst['batched'][1]:.3e} ({worst['batched'][0]}); ranks / "
            f"phase 6 per leaf: median {median:.3f}, largest "
            f"{ratios[-1]:.3f}")
        check(worst["ranks"][1] <= C2_FARTHER * worst["batched"][1]
              and median <= C2_FARTHER,
              f"C2: every leaf of the ranks within {C2_FARTHER}x the "
              f"farthest leaf of phase 6's step from the float64 step, and "
              f"their typical leaf within {C2_FARTHER}x phase 6's (median "
              f"ratio {median:.3f})")
        c2 = dict(worst_ranks=worst["ranks"], worst_batched=worst["batched"],
                  median_ratio=median, largest_ratio=ratios[-1])

    # -- C3: the sampled circle loss, ranks against one process
    cfg = threedmatch_config()
    one = sampled_draws(cfg, steps.batch_to_device(batch_np, DEVICE),
                        batch_np["points"].shape[1])
    ranks_c = [torch.load(PHASE12 / f"circle_rank{r}.pt",
                          weights_only=True) for r in range(2)]
    same = all(len(rc["draws"]) == len(one["draws"]) > 0 and all(
        torch.equal(g[0], w[r]) for got, want in zip(rc["draws"], one["draws"])
        for g, w in zip(got, want)) for r, rc in enumerate(ranks_c))
    n_valid = [int(d[2].all(dim=1).sum()) for d in one["draws"]]
    check(same, f"C3: each rank's sampled indices for its pair bitwise one "
          f"process's on the two-pair batch ({len(one['draws'])} draws of "
          f"{one['draws'][0][0].shape[1]} per pair; pairs with candidates "
          f"{n_valid})")
    loss_err = max(abs(rc["losses"][k] - v) / max(abs(v), 1e-12)
                   for rc in ranks_c for k, v in one["losses"].items())
    check(loss_err <= TOL_SAMPLED,
          f"C3: the ranks' global losses within {TOL_SAMPLED} (relative) of "
          f"one process's: largest {loss_err:.2e}; launches per rank "
          f"{ranks_c[0]['launches']}, one process {one['launches']}")
    result["first_step"] = dict(
        vs_one_process=errs[0][0], vs_batched=far["ranks"][0][0][0],
        vs_batched_all=far["ranks"][1],
        one_process_vs_batched=far["one process"][0][0][0],
        c1=c1, c2=c2, c3=dict(loss_rel_err=loss_err,
                              launches=one["launches"]))
    return res


def phase_data_parallel(trained):
    """(a) the trainer on phase 8's run under the launcher, one rank per
    card over NCCL; (b) two Gloo ranks sharing the card: the trainer, the
    3DMatch test protocol on phase 7's files and the first step at full
    width; (c) remat at full width."""
    import torch

    from regtr_tpu_torch.benchmark import predator
    from regtr_tpu_torch.config import load_config, threedmatch_config
    from regtr_tpu_torch.data import get_dataset
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.train.checkpoints import CheckpointManager
    from regtr_tpu_torch.train.steps import batch_to_device

    first, _ = TRAINER_STEPS
    n_cards = torch.cuda.device_count()
    smi = card_line()
    log(f"== phase 12: data parallelism under python -m "
        f"torch.distributed.run ({n_cards} card(s)), and remat")
    work = PHASE12 / "runs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    me = str(ROOT / "chip_smoke.py")
    flags = ["--nb_sanity_val_steps", "1", "--summary_every", "2",
             "--num_workers", "4"]
    result = {}

    # -- (a) one rank per card over NCCL, phase 8's first run
    cfg_first = derived_config(TRAINER_CONFIG, work / "first.yaml",
                               niter=first, **TRAINER_DATA)
    out = work / "a"
    out.mkdir()
    launch_ranks(n_cards, [me, "--rank-worker", "trainer", str(out),
                           "--config", str(cfg_first), "--logdir",
                           str(out / "logs"), "--dist_backend", "nccl",
                           "--validate_every", "4", *flags],
                 f"(a) the trainer, {n_cards} rank(s) over NCCL")
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=True)
             for r in range(n_cards)]
    (run,) = (out / "logs").iterdir()
    ref = trained["first_run"]
    if n_cards == 1:
        mine = torch.load(run / "ckpt" / str(first) / "state.pt",
                          weights_only=True)["model"]
        theirs = torch.load(PHASE12 / "phase8_state.pt",
                            weights_only=True)["model"]
        check(ranks[0]["totals"] == ref["totals"]
              and mine.keys() == theirs.keys()
              and all(torch.equal(mine[k], theirs[k]) for k in theirs),
              f"(a) world size 1 (one process: no group is made): the "
              f"{first} losses and the step-{first} checkpoint's "
              f"{len(theirs)} tensors bitwise phase 8's")
    step_ms = statistics.median(ranks[0]["step_s"][1:]) * 1e3
    log(f"(a) ({smi}): median step {step_ms:.1f} ms, peak memory "
        f"{ranks[0]['peak_bytes'] / 2**30:.2f} GiB under the launcher; "
        f"phase 8's first run in-process {ref['median_step_ms']:.1f} ms, "
        f"{ref['peak_bytes'] / 2**30:.2f} GiB (host clock, steps after "
        f"the first)")
    result["a"] = dict(world=n_cards, median_step_ms=step_ms,
                       peak_bytes=ranks[0]["peak_bytes"],
                       phase8_median_step_ms=ref["median_step_ms"],
                       phase8_peak_bytes=ref["peak_bytes"])

    # -- (b) two ranks on cuda:0 over Gloo: the trainer
    cfg_dp = derived_config(TRAINER_CONFIG, work / "dp.yaml",
                            niter=DP_TRAINER_STEPS, **TRAINER_DATA)
    out = work / "b"
    out.mkdir()
    launch_ranks(2, [me, "--rank-worker", "trainer", str(out), "--config",
                     str(cfg_dp), "--logdir", str(out / "logs"), "--device",
                     "cuda:0", "--dist_backend", "gloo", "--validate_every",
                     "2", *flags],
                 "(b) the trainer, 2 ranks on one card over Gloo")
    r0, r1 = (torch.load(out / f"rank{r}.pt", weights_only=True)
              for r in range(2))
    (run,) = (out / "logs").iterdir()
    saver = CheckpointManager(run / "ckpt")
    check(len(r0["params"]) == len(r1["params"]) > 0 and all(
        torch.equal(a, b) for a, b in zip(r0["params"], r1["params"])),
          f"(b) the two ranks' {len(r0['params'])} parameters bitwise equal "
          f"after step {DP_TRAINER_STEPS}")
    check(r0["totals"] == r1["totals"]
          and len(r0["totals"]) == DP_TRAINER_STEPS
          and all(np.isfinite(r0["totals"]))
          and not any(r0["skipped"] + r1["skipped"]),
          "(b) both ranks' global losses equal and finite, no update "
          "skipped: " + " ".join(f"{t:.4f}" for t in r0["totals"]))
    check((run / "log.txt").exists() and (run / "log.rank1.txt").exists()
          and sorted(p.name for p in (run / "ckpt").iterdir())
          == ["2", "4", "best.json"] and saver.best_record() is not None,
          f"(b) one run directory ({run.name}) with log.rank1.txt; "
          f"checkpoints {saver.all_steps()} and one best.json, rank 0's")
    per_step = trained["per_step"]
    check(all(n == per_step for n in r0["launches"] + r1["launches"]),
          f"(b) every rank's every step launches phase 8's kernels: "
          f"{per_step}")
    dp_ms = statistics.median(r0["step_s"][1:]) * 1e3
    log(f"(b) trainer ({smi}): median step {dp_ms:.1f} ms per rank, 2 "
        f"ranks sharing the card (a global batch of "
        f"{2 * load_config(cfg_dp)['train_batch_size']} pairs), peak "
        f"memory {r0['peak_bytes'] / 2**30:.2f} and "
        f"{r1['peak_bytes'] / 2**30:.2f} GiB")
    result["b_trainer"] = dict(median_step_ms=dp_ms,
                               peak_bytes=[r0["peak_bytes"],
                                           r1["peak_bytes"]])

    # -- (b) the 3DMatch test protocol on phase 7's parameters and root
    proto = ROOT / ".build" / "protocol"
    (cli_run,) = (proto / "cli_logs").iterdir()
    logs = work / "test_logs"
    launch_ranks(2, ["-m", "regtr_tpu_torch.test", "--params",
                     str(proto / "ckpt" / "params.npz"), "--config",
                     str(ROOT / "conf" / "3dmatch.yaml"), "--benchmark",
                     "3DMatch", "--logdir", str(logs), "--device", "cuda:0",
                     "--dist_backend", "gloo"],
                 "(b) python -m regtr_tpu_torch.test, 2 ranks over Gloo",
                 cwd=proto / "src")
    (run,) = logs.iterdir()
    n_pairs = 0
    for si in range(PROTOCOL_SCENES):
        scene = f"synthroom-{si}"
        got, want = ({tuple(int(x) for x in p[:2]): pose for p, pose in zip(
            *predator.read_trajectory(d / "3DMatch" / scene / "est.log"))}
            for d in (run, cli_run))
        check(got.keys() == want.keys() and all(
            np.array_equal(got[k], want[k]) for k in want),
              f"(b) scene {si}: the merged est.log holds phase 7's "
              f"{len(want)} pairs, each pose bitwise")
        n_pairs += len(want)
    check(all((run / f"est_rank{r}").is_dir() for r in range(2))
          and (run / "benchmark_report.txt").exists(),
          "(b) both ranks' est.log trees beside the merged one, and rank "
          "0's benchmark report")
    result["b_protocol_pairs"] = n_pairs

    # -- (b) the first step at full width, one pair per rank; C1, C2, C3
    res = phase12_first_step(result)
    ar = statistics.median(res[0]["allreduce_ms"])
    mib = res[0]["grad_bytes"] / 2**20
    log(f"(b) all-reduce of the step's gradients ({mib:.1f} MiB fp32, one "
        f"flat buffer, Gloo through host copies, 2 ranks on one card; "
        f"{smi}): median {ar:.1f} ms of "
        + " ".join(f"{x:.1f}" for x in res[0]["allreduce_ms"])
        + " (host clock)")
    result["allreduce_ms"] = ar

    # -- (c) remat at full width
    mn = load_config(MODELNET_CONFIG)
    mn["root"] = str(MODELNET_NO_SHARDS)
    dataset = get_dataset(mn, "train")
    batch_np, _ = collate_pairs([dataset[i] for i in
                                 range(mn["train_batch_size"])],
                                mn["buckets"])
    result["remat_modelnet"] = remat_steps(
        mn, batch_to_device(batch_np, DEVICE),
        f"(c) remat on {MODELNET_CONFIG.name} (fp32, bucket "
        f"{batch_np['points'].shape[1]}, {mn['train_batch_size']} pairs)")
    data = np.load(PHASE12 / "first_step.npz")
    check(data["points"].shape[1] == REMAT_3DMATCH_BUCKET,
          f"phase 6's batch at bucket {REMAT_3DMATCH_BUCKET}")
    result["remat_3dmatch"] = remat_steps(
        threedmatch_config(), batch_to_device(data, DEVICE),
        f"(c) remat on 3dmatch.yaml (fp32, bucket {REMAT_3DMATCH_BUCKET}, "
        f"phase 6's 2 pairs)")
    return result


PHASE13 = ROOT / ".build" / "phase13"
# the interpreter of phase 13's conversion: no JAX, flax, PyYAML or JAX
# package importable, as on the machines the port runs on
NO_JAX = ("import sys\n"
          "for name in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'yaml', "
          "'regtr_tpu', 'tools'):\n"
          "    sys.modules[name] = None\n"
          "from regtr_tpu_torch.convert_checkpoint import main\n"
          "main(sys.argv[1:])\n")


def reference_state_dict(cfg, seed=0):
    """A state_dict in upstream RegTR's layout (names and shapes) for the
    model of `cfg`, drawn with numpy from `seed`: tests/test_converter.py's
    scheme, with the deformable KPConv's offset branch and the attention
    decoder head where cfg asks for them, and each KPConv's kernel_points
    as the reference draws them: a disposition in the unit ball, its first
    point at the centre (`fixed_kernel_points: center`), times the
    block's radius."""
    import torch

    from regtr_tpu_torch.nn.backbone import encoder_out_dim, encoder_plan

    rng = np.random.RandomState(seed)
    sd = {}

    def add(name, *shape):
        sd[name] = torch.from_numpy(rng.randn(*shape).astype(np.float32)
                                    * 0.1)

    def kernel_points(name, radius):
        p = cfg["num_kernel_points"]
        u = rng.randn(p, 3)
        u *= rng.rand(p, 1) ** (1.0 / 3.0) / np.linalg.norm(u, axis=1,
                                                            keepdims=True)
        u[0] = 0.0
        sd[name] = torch.from_numpy((u * radius).astype(np.float32))

    p = cfg["num_kernel_points"]
    offset_dim = (3 + int(bool(cfg.get("modulated", False)))) * p
    for i, (name, in_dim, out_dim, radius, _) in enumerate(
            encoder_plan(cfg)[0]):
        src = f"kpf_encoder.encoder_blocks.{i}"
        if "simple" in name:
            conv_in, conv_out = in_dim, out_dim // 2
        elif "resnetb" in name:
            mid = conv_in = conv_out = out_dim // 4
            if in_dim != mid:
                add(f"{src}.unary1.mlp.weight", mid, in_dim)
        else:
            continue
        add(f"{src}.KPConv.weights", p, conv_in, conv_out)
        kernel_points(f"{src}.KPConv.kernel_points", radius)
        if "deform" in name:
            add(f"{src}.KPConv.offset_conv.weights", p, conv_in, offset_dim)
            kernel_points(f"{src}.KPConv.offset_conv.kernel_points", radius)
            add(f"{src}.KPConv.offset_bias", offset_dim)
        if "resnetb" in name:
            add(f"{src}.unary2.mlp.weight", out_dim, mid)
            if in_dim != out_dim:
                add(f"{src}.unary_shortcut.mlp.weight", out_dim, in_dim)
    d, ff = cfg["d_embed"], cfg["d_feedforward"]
    add("feat_proj.weight", d, encoder_out_dim(cfg))
    add("feat_proj.bias", d)
    for layer in range(cfg["num_encoder_layers"]):
        src = f"transformer_encoder.layers.{layer}"
        for attn in ("self_attn", "multihead_attn"):
            add(f"{src}.{attn}.in_proj_weight", 3 * d, d)
            add(f"{src}.{attn}.in_proj_bias", 3 * d)
            add(f"{src}.{attn}.out_proj.weight", d, d)
            add(f"{src}.{attn}.out_proj.bias", d)
        for lin, (o, i) in (("linear1", (ff, d)), ("linear2", (d, ff))):
            add(f"{src}.{lin}.weight", o, i)
            add(f"{src}.{lin}.bias", o)
        for norm in ("norm1", "norm2", "norm3"):
            add(f"{src}.{norm}.weight", d)
            add(f"{src}.{norm}.bias", d)
    add("transformer_encoder.norm.weight", d)
    add("transformer_encoder.norm.bias", d)
    dec = "correspondence_decoder"
    if cfg.get("direct_regress_coor", True):
        for j in (0, 2, 4):
            add(f"{dec}.coor_mlp.{j}.weight", 3 if j == 4 else d, d)
            add(f"{dec}.coor_mlp.{j}.bias", 3 if j == 4 else d)
    else:
        for proj in ("q_proj", "k_proj"):
            add(f"{dec}.{proj}.weight", d, d)
            add(f"{dec}.{proj}.bias", d)
    add(f"{dec}.conf_logits_decoder.weight", 1, d)
    add(f"{dec}.conf_logits_decoder.bias", 1)
    add("feature_criterion.W", d, d)
    add("feature_criterion_un.W", d, d)
    return sd


def phase_checkpoint():
    """An upstream checkpoint on the card: a state_dict in the reference's
    layout at the full width of conf/3dmatch.yaml, converted by `python -m
    regtr_tpu_torch.convert_checkpoint` in an interpreter where JAX,
    PyYAML and the JAX package cannot be imported; the loaded model's
    parameters and dispositions bitwise their sources; `python -m
    regtr_tpu_torch.test` on it over phase 7's root (launches per pair,
    each of one pair's held to its plain version, the unfused KPConv);
    and --export of phase 8's trainer checkpoint, bitwise
    save_params_npz of the restored model."""
    import torch

    from regtr_tpu_torch.config import (dump_yaml_sections, load_config,
                                        parse_yaml_sections)
    from regtr_tpu_torch.convert import state_dict_from_reference
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.nn.blocks import KPConvLayer
    from regtr_tpu_torch.train.checkpoints import load_params_npz

    shipped = ROOT / "conf" / "3dmatch.yaml"
    cfg = load_config(shipped)
    shutil.rmtree(PHASE13 / "run", ignore_errors=True)
    (PHASE13 / "run").mkdir(parents=True)
    sd = reference_state_dict(cfg, seed=0)
    n_params = sum(v.numel() for k, v in sd.items()
                   if not k.endswith("kernel_points"))
    ckpt = PHASE13 / "run" / "regtr.pth"
    torch.save({"state_dict": sd}, ckpt)
    log(f"== phase 13: an upstream checkpoint on the card (the reference's "
        f"layout at the width of {shipped.name}: {len(sd)} tensors, "
        f"{n_params / 1e6:.2f} M parameters, seed 0)")
    npz, kp = PHASE13 / "run" / "params.npz", PHASE13 / "run" / "kp.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, str(ckpt), "--config", str(shipped),
         "--out", str(npz), "--kernel_points", str(kp)], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT)), capture_output=True,
        text=True, timeout=600)
    convert_s = time.perf_counter() - t0
    log(f"python -m regtr_tpu_torch.convert_checkpoint (jax, flax, yaml and "
        f"regtr_tpu unimportable): exit {proc.returncode} in "
        f"{convert_s:.1f} s (host clock, the interpreter's start included): "
        + proc.stdout.strip().replace("\n", "; "))
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0, "the conversion exits 0")

    # the loaded model: every parameter and disposition bitwise its source
    raw = parse_yaml_sections(shipped.read_text())
    meta = ROOT / ".build" / "protocol" / "src" / "datasets" / "3dmatch"
    raw["dataset"]["root"] = str(ROOT / ".build" / "protocol" / "data" /
                                 "indoor")
    raw["dataset"]["metadata_dir"] = str(meta)
    raw["model"]["kernel_dispositions_file"] = str(kp)
    config = PHASE13 / "run" / "3dmatch_converted.yaml"
    config.write_text(dump_yaml_sections(raw))
    cfg = load_config(config)
    model = create_model(cfg, max(cfg["buckets"]), DEVICE, seed=1)
    load_params_npz(npz, model)
    mapped = state_dict_from_reference(sd, cfg)
    got = model.state_dict()
    direct = {"feat_proj.weight": sd["feat_proj.weight"],
              "transformer_encoder.layer_0.cross_attn.k_proj.weight":
              sd["transformer_encoder.layers.0.multihead_attn."
                 "in_proj_weight"][cfg["d_embed"]:2 * cfg["d_embed"]],
              "feature_criterion.W": sd["feature_criterion.W"]}
    check(set(mapped) == set(got) and all(
        torch.equal(got[k].cpu(), v) for k, v in mapped.items())
          and all(torch.equal(got[k].cpu(), v) for k, v in direct.items()),
          f"every one of the converted model's {len(got)} parameters "
          f"bitwise its checkpoint tensor under the mapping (Linear weights "
          f"in the reference's (out, in) layout, in_proj split in q, k, v)")
    convs = [(name, m) for name, m in model.named_modules()
             if isinstance(m, KPConvLayer)]
    check(len(convs) == 11 and all(
        torch.equal(m.kernel_points.cpu(), sd[
            f"kpf_encoder.encoder_blocks.{m.block_index}.KPConv."
            f"kernel_points"]) for _, m in convs),
          f"each of the {len(convs)} blocks' kernel_points bitwise the "
          f"checkpoint's, through kernel_dispositions_file")
    result = converted_protocol(model, cfg, npz, config)
    result.update(convert_s=convert_s, export_s=export_trainer_run(),
                  parameters=n_params)
    return result


def converted_protocol(model, cfg, npz, config):
    """Phase 13: `python -m regtr_tpu_torch.test --params` of the converted
    checkpoint on phase 7's root, in-process: launches per pair, finite
    poses, pairs/s; then one pair's launches held to their plain
    versions."""
    import torch

    from regtr_tpu_torch import evaluation
    from regtr_tpu_torch import test as test_cli
    from regtr_tpu_torch.train.steps import make_forward

    record = []
    stages = dict.fromkeys(("forward", "est_log", "scorer", "run_test"), 0.0)
    logs = PHASE13 / "run" / "test_logs"
    torch.cuda.synchronize()
    _zero_launch_counts()
    # from the upstream working directory, where the GT trajectories'
    # default place resolves (phase 7's command line runs there too)
    try:
        with timed_protocol(record, stages, also=[(evaluation,
                                                   "run_test")]), \
                contextlib.chdir(ROOT / ".build" / "protocol" / "src"):
            test_cli.main(["--params", str(npz), "--config", str(config),
                           "--benchmark", "3DMatch", "--logdir", str(logs),
                           "--device", DEVICE, "--num_workers", "4"])
    finally:
        close_port_logger()
    launches = _launch_counts()
    n = len(record)
    per_pair = {"flash_attn_fwd": 2 * cfg["num_encoder_layers"],
                "row_gather": row_gathers_per_forward(cfg),
                "neighbor_search": searches_per_pyramid(cfg)}
    check(n == PROTOCOL_SCENES * len(PROTOCOL_PAIRS["3DMatch"])
          and launches == dict(dict.fromkeys(launches, 0), **{
              k: v * n for k, v in per_pair.items()}),
          f"python -m regtr_tpu_torch.test --params (converted) --benchmark "
          f"3DMatch: {n} pairs, launches {launches} ({per_pair} a pair)")
    poses = torch.stack([pose for *_, pose in record])
    check(bool(torch.isfinite(poses).all()),
          f"the converted model's {n} poses finite")
    (logdir,) = logs.iterdir()
    check((logdir / "benchmark_report.txt").exists(),
          "its benchmark_report.txt written (random weights: recall "
          "not checked)")
    loop = stages["run_test"]
    log(f"converted model, 3DMatch protocol ({card_line()}): {n} pairs, "
        f"{n / loop:.3f} pairs/s over run_test (loading, forward, est.log, "
        f"scorer; host clock), forward {stages['forward'] / n * 1e3:.1f} ms "
        f"a pair")
    points, mask, _ = record[0]
    found = {}
    before = _launch_counts()
    with held_to_plain(found):
        make_forward(model)(points, mask)
    torch.cuda.synchronize()
    used = {k: v - before[k] for k, v in _launch_counts().items()}
    for (name, shape, dtype), (calls, err, ok) in sorted(found.items()):
        log(f"  {name} {list(shape)} {dtype}: {calls} launches, largest "
            f"|kernel - plain| {err:.3e}")
    check(used == dict(dict.fromkeys(used, 0), **per_pair)
          and all(ok for *_, ok in found.values())
          and {k[0] for k in found} == set(per_pair),
          f"each of one converted pair's {sum(per_pair.values())} launches "
          f"within its tolerance of its plain version on the same inputs")
    unfused_kpconv(model, points, mask)
    return dict(launches=launches, launches_per_pair=per_pair, pairs=n,
                pairs_per_s=n / loop)


def unfused_kpconv(model, points, mask):
    """The unfused KPConv (`kpconv`: `kpconv_geometry`, then
    `kpconv_apply`) of the model's first level-0 resnet block, on the
    pair's level-0 table and seeded features: bitwise the fused gather's
    output on the same inputs, its coordinate and feature gathers two
    launches of the row-gather kernel."""
    import torch

    from regtr_tpu_torch.ops import kpconv

    enc = model.kpf_encoder
    i, (name, *_) = next((i, b) for i, b in enumerate(enc.plan)
                         if b[0] == "resnetb" and b[4] == 0)
    layer = getattr(enc, f"block_{i}_{name}").kpconv
    with torch.no_grad():
        lvl = model.preprocess(points, mask)[0]
        index = kpconv.GatherIndex(lvl.neighbors, lvl.points.shape[1] + 1)
        gen = torch.Generator(device=lvl.points.device).manual_seed(0)
        x = torch.randn(lvl.points.shape[:2] + layer.weights.shape[1:2],
                        generator=gen, device=lvl.points.device)
        args = (layer.kernel_points, layer.weights, layer.extent,
                layer.influence, layer.aggregation, layer.compute_dtype)
        before = _launch_counts()
        got = kpconv.kpconv(lvl.points, lvl.points, index, x, *args,
                            layer.norm)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in _launch_counts().items()}
        want, _, _ = kpconv.kpconv_fused_gather(
            lvl.points, lvl.points, index, x, None, *args, layer.norm)
    check(torch.equal(got, want)
          and used == dict(dict.fromkeys(used, 0), row_gather=2),
          f"the unfused kpconv of block_{i}_{name} ({tuple(x.shape)} "
          f"features, K {lvl.neighbors.shape[-1]}) bitwise the fused "
          f"gather's, launches {used}")


def export_trainer_run():
    """Phase 13: `convert_checkpoint --export` of phase 8's run (without
    JAX or PyYAML), bitwise save_params_npz of the model restored from its
    best checkpoint; -> the command's seconds."""
    from regtr_tpu_torch.config import load_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                                   save_params_npz)

    run8 = PHASE13 / "phase8_run"
    out = PHASE13 / "run" / "exported.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c", NO_JAX, "--export", str(run8), "--out",
         str(out)], cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=600)
    export_s = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:] + proc.stderr[-4000:])
    check(proc.returncode == 0, f"--export of phase 8's run exits 0 in "
          f"{export_s:.1f} s: {proc.stdout.strip()}")
    cfg8 = load_config(run8 / "config.yaml")
    restored = create_model(cfg8, max(cfg8["buckets"]), "cpu", seed=1)
    step = CheckpointManager(run8 / "ckpt").restore(restored, best=True)
    want = PHASE13 / "run" / "restored.npz"
    save_params_npz(want, restored)
    with np.load(out) as a, np.load(want) as b:
        same = (sorted(a.files) == sorted(b.files) and all(
            a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
            for k in a.files))
        n_arrays = len(a.files)
    check(same, f"--export's {n_arrays} arrays bitwise save_params_npz of "
          f"phase 8's best checkpoint (step {step}) restored")
    return export_s


def main():
    if not (ROOT / "regtr_tpu_torch").is_dir():
        raise SystemExit("FAILED: run chip_smoke.py from a checkout of the "
                         "repository (regtr_tpu_torch/ is missing)")
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false")
    from regtr_tpu_torch.config import load_config, threedmatch_config
    from regtr_tpu_torch.data.collate import pick_bucket
    from regtr_tpu_torch.ops.pyramid import make_pyramid_spec

    trainer_shape = trainer_attention_shape(load_config(TRAINER_CONFIG))
    modelnet_shape = modelnet_attention_shape(load_config(MODELNET_CONFIG))
    cfg = threedmatch_config()
    train_n0 = pick_bucket(N_POINTS, cfg["buckets"])
    train_n = make_pyramid_spec(cfg, train_n0).capacities[-1]
    # the protocol builds the model at the largest bucket
    protocol_n = make_pyramid_spec(cfg, max(cfg["buckets"])).capacities[-1]
    seconds = {}

    def timed(name, fn, *args):
        """fn(*args), its wall time kept under `name`."""
        t = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t
        return out

    timed("1", phase_device)
    timed("2", phase_build)
    attn = timed("3", phase_attention, train_n, protocol_n, trainer_shape,
                 modelnet_shape)
    k1_extents = timed("3a", phase_key_extents, modelnet_shape)
    gather_rows, gather_elements = timed("3b", phase_gather, train_n0)
    searches = timed("3c", phase_neighbors)
    timed("4", phase_small_input)
    infer_launches, forwards, pairs_per_s = timed("5", phase_main_path)
    bench = timed("5b", phase_bench, pairs_per_s)
    geotr = timed("5c", phase_geotransformer)
    train_launches, segsum = timed("6", phase_training)
    protocol = timed("7", phase_protocol)
    trained = timed("8", phase_trainer, trainer_shape)
    modelnet = timed("9", phase_modelnet, modelnet_shape)
    timed("10", phase_tools, protocol)
    options = timed("11", phase_options)
    parallel = timed("12", phase_data_parallel, trained)
    converted = timed("13", phase_checkpoint)
    log(f"upstream checkpoint (phase 13): converted in "
        f"{converted['convert_s']:.1f} s, exported in "
        f"{converted['export_s']:.1f} s; the converted model's 3DMatch "
        f"protocol {converted['pairs_per_s']:.3f} pairs/s")
    log(f"data parallel (phase 12): all-reduce "
        f"{parallel['allreduce_ms']:.1f} ms per step (Gloo, 2 ranks on one "
        f"card); at world size {parallel['a']['world']} a step "
        f"{parallel['a']['median_step_ms']:.1f} ms beside phase 8's "
        f"{parallel['a']['phase8_median_step_ms']:.1f} ms")
    log("seconds per phase (host clock): " + ", ".join(
        f"{k} {v:.1f}" for k, v in seconds.items()) + f"; all "
        f"{sum(seconds.values()):.1f}")
    k1 = attn[((64, 1872, 1872, 32), "bfloat16")]
    bwd = attn[((32, train_n, train_n, 32), "float32")]
    k1_other = [dict(what=what, shape=list(shape), dtype="float32",
                     **attn[(shape, "float32")]["fwd"])
                for what, shape in (
                    ("training", (32, train_n, train_n, 32)),
                    ("protocol", (16, protocol_n, protocol_n, 32)),
                    ("modelnet protocol", modelnet_shape))]
    at_trainer = attn[(trainer_shape, "bfloat16")]

    def trainer_shape_entry(kernel):
        """The kernel at the trainer's attention shape, bf16 (phase 3)."""
        return [dict(what="trainer", shape=list(trainer_shape),
                     dtype="bfloat16", **at_trainer[kernel])]

    fp64 = bwd.pop("fp64")
    k4 = segsum["segsum"]
    k4_shape = [k4.pop("rows"), k4.pop("width")]
    transpose = segsum["segment_transpose"]
    row = dict(gather_rows[0])
    row.pop("what")
    protocol_launches = {bm: r["launches"]["row_gather"]
                         for bm, r in protocol.items()}

    def modelnet_launches(name):
        """Phase 9's launches of a kernel: over each benchmark's run, and
        per pair."""
        return dict(modelnet_launches={bm: r["launches"][name]
                                       for bm, r in modelnet.items()},
                    modelnet_launches_per_pair={
                        bm: r["launches"][name] / r["pairs"]
                        for bm, r in modelnet.items()},
                    modelnet_pairs={bm: r["pairs"]
                                    for bm, r in modelnet.items()})

    def trainer_launches(name):
        """Phase 8's launches of a kernel: over the phase, and per train
        step; and phase 11's, per pair of its forward, per micro-step, per
        dropout step and per pair's searches (scan and grid)."""
        return dict(trainer_launches=trained["launches"][name],
                    trainer_launches_per_step=trained["per_step"][name],
                    trainer_steps=trained["steps"], options_launches=dict(
                        forward_per_pair=options["inference"][
                            "launches_per_pair"][name],
                        micro_step=options["training"][
                            "launches_per_micro_step"][name],
                        dropout_step=options["dropout"]["launches"][name],
                        searches_per_pair=options["search"]["launches"][
                            name]),
                    remat_launches_per_step={
                        what: {route: parallel[f"remat_{what}"][route][
                            "launches"][name] for route in ("off", "on")}
                        for what in ("modelnet", "3dmatch")})

    def converted_launches(name):
        """Phase 13's launches of a kernel: the converted checkpoint's
        3DMatch protocol, over its pairs and per pair."""
        return dict(converted_launches=converted["launches"][name],
                    converted_pairs=converted["pairs"],
                    converted_launches_per_pair=converted["launches"][name]
                    / converted["pairs"])

    src = "regtr_tpu_torch/csrc/"
    log(json.dumps({"kernels": [
        dict(name="flash_attn_fwd", row="K1", route="cuda",
             **trainer_launches("flash_attn_fwd"),
             **modelnet_launches("flash_attn_fwd"),
             **converted_launches("flash_attn_fwd"),
             source=src + "flash_attn_fwd.cu",
             replaces="regtr_tpu/ops/pallas/attention.py:49",
             launches=infer_launches["flash_attn_fwd"], forwards=forwards,
             train_launches=train_launches["flash_attn_fwd"],
             steps=TRAIN_STEPS, protocol_launches={
                 bm: r["launches"]["flash_attn_fwd"]
                 for bm, r in protocol.items()},
             shape=[64, 1872, 1872, 32], dtype="bfloat16",
             other_shapes=k1_other + trainer_shape_entry("fwd")
             + geotr["k1"], key_extents=k1_extents,
             geotr_launches_per_forward=geotr["launches"]["flash_attn_fwd"],
             **k1["fwd"]),
        dict(name="flash_attn_bwd_dkv", row="K2", route="cuda",
             **trainer_launches("flash_attn_bwd_dkv"),
             source=src + "flash_attn_bwd.cu",
             replaces="regtr_tpu/ops/pallas/attention.py:194",
             launches=train_launches["flash_attn_bwd_dkv"],
             steps=TRAIN_STEPS, shape=[32, train_n, train_n, 32],
             dtype="float32", fp64_rel_err={
                 nm: fp64["kernel"][nm] for nm in ("dk", "dv", "dbias")},
             other_shapes=trainer_shape_entry("dkv"), **bwd["dkv"]),
        dict(name="flash_attn_bwd_dq", row="K3", route="cuda",
             **trainer_launches("flash_attn_bwd_dq"),
             source=src + "flash_attn_bwd.cu",
             replaces="regtr_tpu/ops/pallas/attention.py:232",
             launches=train_launches["flash_attn_bwd_dq"],
             steps=TRAIN_STEPS, shape=[32, train_n, train_n, 32],
             dtype="float32", fp64_rel_err=fp64["kernel"]["dq"],
             other_shapes=trainer_shape_entry("dq"), **bwd["dq"]),
        dict(name="segsum", row="K4", route="cuda",
             **trainer_launches("segsum"),
             source=src + "segsum.cu",
             replaces="regtr_tpu/ops/pallas/segsum.py:60",
             launches=train_launches["segsum"], steps=TRAIN_STEPS,
             shape=k4_shape, dtype="float32", **k4),
        dict(name="segment_transpose", row="K4", route="cuda",
             **trainer_launches("segment_transpose"),
             source=src + "segsum.cu",
             replaces="regtr_tpu/ops/pallas/segsum.py:205",
             launches=train_launches["segment_transpose"], steps=TRAIN_STEPS,
             infer_launches=infer_launches["segment_transpose"],
             forwards=forwards, id_dtype="int32", **transpose),
        dict(name="row_gather", row="K5a", route="cuda",
             **trainer_launches("row_gather"),
             **modelnet_launches("row_gather"),
             **converted_launches("row_gather"),
             source=src + "gather.cu",
             replaces="tools/exp_pallas_gather.py:44",
             also_replaces=["tools/exp_pallas_gather.py:77",
                            "tools/exp_pallas_gather2.py:58",
                            "tools/exp_pallas_gather2.py:65",
                            "tools/exp_pallas_gather2.py:71",
                            "tools/exp_pallas_gather2.py:77",
                            "tools/exp_pallas_gather3.py:33"],
             launches=infer_launches["row_gather"], forwards=forwards,
             train_launches=train_launches["row_gather"],
             steps=TRAIN_STEPS, protocol_launches=protocol_launches,
             geotr_launches_per_forward=geotr["launches"]["row_gather"],
             other_shapes=gather_rows[1:] + geotr["gathers"], **row),
        dict(name="element_gather", row="K5b", route="cuda",
             **trainer_launches("element_gather"),
             source=src + "gather.cu",
             replaces="tools/exp_pallas_gather3.py:65",
             also_replaces=["tools/exp_pallas_gather4.py:30",
                            "tools/exp_pallas_gather5.py:29",
                            "tools/exp_pallas_gather5.py:67"],
             launches=options["search"]["launches"]["element_gather"],
             launches_by_search={
                 m: n.get("element_gather", 0) for m, n in
                 options["search"]["launches_by_method"].items()},
             path="phase 11: one pair's pyramid by the scan and grid "
                  "searches", infer_launches=infer_launches[
                      "element_gather"],
             other_shapes=[dict(what="probe (phase 3b)", **gather_elements)],
             **options["search"]["k5b"]),
        dict(name="neighbor_search", row="K6", route="cuda",
             **trainer_launches("neighbor_search"),
             **modelnet_launches("neighbor_search"),
             **converted_launches("neighbor_search"),
             source=src + "neighbors.cu",
             replaces="regtr_tpu/ops/neighbors.py:267",
             also_replaces=["regtr_tpu/ops/neighbors.py:215"],
             launches=infer_launches["neighbor_search"], forwards=forwards,
             train_launches=train_launches["neighbor_search"],
             steps=TRAIN_STEPS, protocol_launches={
                 bm: r["launches"]["neighbor_search"]
                 for bm, r in protocol.items()},
             geotr_launches_per_forward=geotr["launches"][
                 "neighbor_search"],
             what="the ten searches of one phase-5 forward's pyramid "
                  "(4 pairs, bucket 20480), summed",
             max_abs_err=max(e["max_abs_err"] for e in searches["main"]),
             **searches["total"], library_ms=None,
             per_search=searches["main"], modelnet_searches=searches[
                 "modelnet"], other_shapes=[searches["exact"]],
             adversarial=searches["adversarial"], bench=bench),
        dict(name="geo_embedding", row="GeoTransformer", route="cuda",
             source=src + "geo_embedding.cu", replaces=None,
             geotr_launches_per_forward=geotr["launches"]["geo_embedding"],
             **geotr["embedding"]),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-worker"]:
        rank_worker(*sys.argv[2:])
    else:
        main()
