#!/usr/bin/env python3
"""Drive the PyTorch port's inference path, training step, trainer, test
protocols and other command lines on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (it exits
non-zero without one, and without the checkout beside it).  Phases:

1. device: the card's name and power limit (nvidia-smi), its maximum SM
   clock, torch and CUDA;
2. build: one nvcc per kernel source (csrc/flash_attn_fwd.cu,
   flash_attn_bwd.cu, segsum.cu, gather.cu), all at once, into .build/;
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
3b. gather kernels (K5) against index_select and torch.gather, bitwise: the
   row gather at the main path's shapes with its int32 flat ids (the
   inference feature and coordinate gathers, the training feature gather;
   the coordinate rows with int64 ids too) and at ragged widths with both
   id widths, the element gather on both axes, 2-D and batched (rows wider
   than 48 KB and than a block's shared memory, a batch stride larger than
   the slice, operands off 16 bytes); CUDA-event times beside the bound and
   the library call, the row gather in turns with index_select;
4. small input: the tiny config in fp32 on the card against the same model
   on the CPU (plain versions), same seeded parameters and input: the
   forward, and the gradients of one training step leaf by leaf;
5. inference path: the 3DMatch config in bf16 at bucket 20480 with seeded
   random parameters, on 4 pairs of synthetic room scans (19k points each,
   meter scale, on a 2.5 cm grid, made here with numpy): register() once,
   then the batched forward, timed, with per-stage times, a torch.profiler
   pass (device busy share, top kernels; the trace goes to
   .build/forward_trace.json), checks of the outputs, of the kernels'
   launch counts (no gather transpose), of the pyramid's bitwise
   repeatability, of the kernel path
   against a forward whose attention calls the plain version, and of the
   forward with K5 against the forward with index_select (bitwise);
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
   the GT logs, individual_errors.xlsx read back).

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
VOXEL = 0.025         # the scans' grid (conf/3dmatch.yaml first_subsampling_dl)
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


def kernel_libraries():
    from regtr_tpu_torch.ops import attention, gather, kpconv

    return [attention.FWD_LIBRARY, attention.BWD_LIBRARY,
            kpconv.SEGSUM_LIBRARY, gather.GATHER_LIBRARY]


def phase_build():
    from regtr_tpu_torch.ops import cuda_build

    log("== phase 2: build")
    libs = kernel_libraries()
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


def attention_fwd_bounds(shape, name):
    """K1's bounds (ms): the largest of bytes, products at the design's
    instruction rate (bf16 mma, or 3xTF32 for fp32) and exponentials on
    MUFU, with its parts and the CUDA cores' FMA bound (the yardstick of an
    FMA design) beside it."""
    bh, nq, nk, d = shape
    width = 2 if name == "bfloat16" else 4
    flops = 4 * bh * nq * nk * d
    # reads q, k, v, bias once, writes out once
    bytes_ms = (2 * bh * (nq + nk) * d * width + bh * nk * 4) / PEAK_BYTES
    ops_ms = flops / PEAK_FLOPS["3xtf32" if width == 4 else name]
    exp_ms = bh * nq * nk / (EXP_PER_SM_CLOCK * SMS * SM_CLOCK_HZ)
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


def _scans(n_pairs, n_points, seed):
    """Pairs of overlapping scans of synthetic rooms: a list of (cloud,
    rotation, translation), source then target of each pair, each cloud
    the room's points moved by its own random rigid transform (rotation up
    to 50 degrees).

    Like a 3DMatch fragment, a scan is a contiguous patch at the density of
    a 2.5 cm voxel grid: the room is voxel-downsampled once, and a scan is
    the n_points points nearest to its center.
    """
    rng = np.random.RandomState(seed)
    scans = []
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
            trans = rng.randn(3) * 0.3
            scans.append(((room[keep] @ rot.T + trans).astype(np.float32),
                          rot, trans))
    return scans


def synthetic_pairs(n_pairs, n_points, seed):
    """Interleaved pairs of synthetic scans padded to the bucket N0:
    (points (2B, N0, 3), mask (2B, N0))."""
    clouds = [c for c, _, _ in _scans(n_pairs, n_points, seed)]
    pts = np.zeros((len(clouds), N0, 3), np.float32)
    mask = np.zeros((len(clouds), N0), bool)
    for i, c in enumerate(clouds):
        pts[i, :len(c)] = c
        mask[i, :len(c)] = True
    return pts, mask


def synthetic_samples(n_pairs, n_points, seed, cfg):
    """The same pairs as training samples: src_xyz, tgt_xyz, the GT pose
    src -> tgt (3, 4), and overlap labels at cfg['overlap_radius'] from the
    port's compute_overlap (collate with data.collate.collate_pairs)."""
    from regtr_tpu_torch.data.overlap import compute_overlap

    scans = _scans(n_pairs, n_points, seed)
    samples = []
    for (src, rs, ts), (tgt, rt, tt) in zip(scans[::2], scans[1::2]):
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
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.nn import transformer
    from regtr_tpu_torch.ops.attention import (
        flash_masked_attention, flash_masked_attention_reference)

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
    check(launches == {"flash_attn_fwd": per_forward * forwards,
                       "flash_attn_bwd_dkv": 0, "flash_attn_bwd_dq": 0,
                       "segsum": 0, "segment_transpose": 0,
                       "row_gather": gathers * forwards,
                       "element_gather": 0},
          f"launches in {forwards} forwards: {launches} ({per_forward} "
          f"attention forwards and {gathers} row gathers per forward, no "
          "gather transpose)")
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
    with torch.inference_mode():
        profile_device(lambda: model(pts, mask), PROFILED_ITERS, "forward",
                       "forward_trace.json")

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
    return launches, forwards


_COUNTED = {}


def _counted():
    """Every kernel wrapper, by the name the kernels line gives it (taken
    once, so that a route that swaps a wrapper for its plain version still
    reads the wrappers' counts)."""
    from regtr_tpu_torch.ops import attention, gather, kpconv

    if not _COUNTED:
        _COUNTED.update({
            "flash_attn_fwd": attention.flash_masked_attention,
            "flash_attn_bwd_dkv": attention.flash_attn_bwd_dkv,
            "flash_attn_bwd_dq": attention.flash_attn_bwd_dq,
            "segsum": kpconv.segment_sum,
            "segment_transpose": kpconv.segment_transpose,
            "row_gather": gather.row_gather,
            "element_gather": gather.element_gather})
    return _COUNTED


def _launch_counts():
    return {k: fn.launches for k, fn in _counted().items()}


def _zero_launch_counts():
    for fn in _counted().values():
        fn.launches = 0


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
    (the attention, the row gather and the gather transpose)."""
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
               "element_gather": 0}
    wants = {"kernels": kernels, "index_select": dict(kernels, row_gather=0),
             "plain transpose": dict(kernels, segment_transpose=0),
             "plain": dict.fromkeys(kernels, 0), "kernels again": kernels}
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
          f"table) and {gathers} row gathers per step)")
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

    shutil.rmtree(base, ignore_errors=True)
    meta = base / "src" / "datasets" / "3dmatch"
    infos = {bm: {"src": [], "tgt": [], "rot": [], "trans": [],
                  "overlap": []} for bm in PROTOCOL_PAIRS}
    rng = np.random.RandomState(7)
    for si in range(PROTOCOL_SCENES):
        scene = f"synthroom-{si}"
        (base / "data" / "indoor" / "test" / scene).mkdir(parents=True)
        room, (lx, ly) = make_room(rng, 600000)
        _, first = np.unique(np.floor(room / VOXEL).astype(np.int64),
                             axis=0, return_index=True)
        room = room[np.sort(first)]
        poses, local = [], []
        for i in range(PROTOCOL_FRAGMENTS):
            center = np.array([lx * 0.2 + i * PROTOCOL_STEP, ly * 0.5, 1.1])
            dist = np.linalg.norm(room - center, axis=1)
            world = room[np.argpartition(dist, N_POINTS)[:N_POINTS]]
            pose = se3_np.se3_init(_rotation(rng, 180.0),
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
                   "row_gather": row_gathers_per_forward(shipped)}
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
                   "row_gather")
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
def held_to_plain(found):
    """Every kernel launch of the training path, held to its plain version
    on the same inputs as it happens: the attention forward (out and lse)
    and backward within TOL and TOL_BWD of the operands' dtype (as phase 3
    holds them), the row gather and the segment transpose bitwise, the
    segment sum within TOL_SEGSUM of its largest |sum|.  found[(kernel,
    shape, dtype)] = (launches, largest |difference|, all within)."""
    import torch

    from regtr_tpu_torch.ops import attention, kpconv
    from regtr_tpu_torch.ops.gather import row_gather_reference

    def note(name, shape, dtype, err, ok):
        key = (name, tuple(shape), str(dtype)[6:])
        calls, worst, good = found.get(key, (0, 0.0, True))
        found[key] = (calls + 1, max(worst, err), good and bool(ok))

    def max_err(a, b):
        return float((a.float() - b.float()).abs().max()) if a.numel() else 0.

    real = dict(fwd=attention._kernel_fwd, bwd=attention._bwd,
                gather=kpconv.row_gather, transpose=kpconv.segment_transpose,
                sum=kpconv.segment_sum)

    def fwd(q, k, v, bias, scale, want_lse):
        out, lse = real["fwd"](q, k, v, bias, scale, want_lse)
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

    def gather(table, idx):
        out = real["gather"](table, idx)
        same = torch.equal(out, row_gather_reference(table, idx))
        note("row_gather", (idx.shape[0], table.shape[1]), table.dtype,
             0.0 if same else float("inf"), same)
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

    # kpconv's own kernels count their launches under their module names,
    # which the wrappers take meanwhile: fold those counts back on exit
    transpose.launches = segsum.launches = 0
    attention._kernel_fwd, attention._bwd = fwd, bwd
    kpconv.row_gather, kpconv.segment_transpose = gather, transpose
    kpconv.segment_sum = segsum
    try:
        yield
    finally:
        attention._kernel_fwd, attention._bwd = real["fwd"], real["bwd"]
        kpconv.row_gather = real["gather"]
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
                else dict.fromkeys(per_step, 0))
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
        t0 = time.perf_counter()
        with recorded_train_steps(record, latest):
            run1 = train_cli.main(["--config", str(cfg_first), "--logdir",
                                   str(work / "first"), *flags])
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t0
        (logdir,) = (work / "first").iterdir()
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
    return dict(launches=launches, per_step=per_step, steps=len(steps_s),
                median_step_ms=median * 1e3,
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
                "row_gather": row_gathers_per_forward(cfg)}
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
                "row_gather": row_gathers_per_forward(cfg)}
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
        "row_gather": row_gathers_per_forward(big)})
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
    phase_device()
    phase_build()
    attn = phase_attention(train_n, protocol_n, trainer_shape,
                           modelnet_shape)
    gather_rows, gather_elements = phase_gather(train_n0)
    phase_small_input()
    infer_launches, forwards = phase_main_path()
    train_launches, segsum = phase_training()
    protocol = phase_protocol()
    trained = phase_trainer(trainer_shape)
    modelnet = phase_modelnet(modelnet_shape)
    phase_tools(protocol)
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
        step."""
        return dict(trainer_launches=trained["launches"][name],
                    trainer_launches_per_step=trained["per_step"][name],
                    trainer_steps=trained["steps"])

    src = "regtr_tpu_torch/csrc/"
    log(json.dumps({"kernels": [
        dict(name="flash_attn_fwd", row="K1", route="cuda",
             **trainer_launches("flash_attn_fwd"),
             **modelnet_launches("flash_attn_fwd"),
             source=src + "flash_attn_fwd.cu",
             replaces="regtr_tpu/ops/pallas/attention.py:49",
             launches=infer_launches["flash_attn_fwd"], forwards=forwards,
             train_launches=train_launches["flash_attn_fwd"],
             steps=TRAIN_STEPS, protocol_launches={
                 bm: r["launches"]["flash_attn_fwd"]
                 for bm, r in protocol.items()},
             shape=[64, 1872, 1872, 32], dtype="bfloat16",
             other_shapes=k1_other + trainer_shape_entry("fwd"),
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
             other_shapes=gather_rows[1:], **row),
        dict(name="element_gather", row="K5b", route="cuda",
             **trainer_launches("element_gather"),
             source=src + "gather.cu",
             replaces="tools/exp_pallas_gather3.py:65",
             also_replaces=["tools/exp_pallas_gather4.py:30",
                            "tools/exp_pallas_gather5.py:29",
                            "tools/exp_pallas_gather5.py:67"],
             launches=infer_launches["element_gather"], on_path=False,
             **gather_elements),
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
