#!/usr/bin/env python3
"""Time design variants of the attention kernels (and of K5b, the element
gather) on one CUDA card.

    python3 kernel_variants.py [--forward | --gather] [--parent OLD.cu]
                               [--variants NAME,NAME,...]

Each variant is the committed regtr_tpu_torch/csrc/flash_attn_bwd.cu (with
--forward: flash_attn_fwd.cu; with --gather: gather.cu) and the headers
beside it (csrc/*.cuh) with a few text edits, each applied to whichever of
the files holds its text (a variant whose edits no longer apply is skipped,
and said so).  All are built at once with the port's nvcc flags into
.build/variants/, with `--parent` (another version of the source, e.g. from
`git show REV:regtr_tpu_torch/csrc/flash_attn_bwd.cu`) beside them.
Backward: at the training shape (32, 2240, 2240, 32), fp32 and bf16, 20 %
of keys masked, each is checked for bitwise repeatability and for its error
against the plain version and against an fp64 backward (max |err| / max
|grad|), then dkv and dq are timed with CUDA events (medians of 30) in two
turns, in order and in reverse, with SDPA's backward as the yardstick.
Forward: the same at the inference shape (64, 1872, 1872, 32) in bf16 and
at the training and protocol shapes (32, 2240, 2240, 32) and (16, 2992,
2992, 32) in fp32 (errors of out and lse against the plain version and of
out against an fp64 forward), SDPA's forward the yardstick.  Gather: the
element gather at the probes' (160, 32, 5120) axis 1 in fp32 and bf16,
bitwise against torch.gather, and timed in turns with it.  Diagnostic
variants (marked) compute wrong results on purpose: they only say which
resource the time goes to.  Needs a card; imports torch and the port.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "regtr_tpu_torch" / "csrc"
OUT = ROOT / ".build" / "variants"

_MMA3 = "\n".join(
    f"  mma_tf32(c, a_{a}, __float_as_uint(b0_{b}), __float_as_uint(b1_{b}));"
    for a, b in (("small", "big"), ("big", "small"), ("big", "big")))
_INT_RNA = "  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
_MB = "__launch_bounds__(kThreads, D >= 64 ? 2 : 3)"
_SMALL_LOADS = [(f"load_vec({v}, {src} + 2 * L::kTile{off});",
                 f"load_vec({v}, {src}{off});")
                for v, src, off in (("v1s", "b1", ""), ("v2s", "b2", ""),
                                    ("u0s", "y1r", ""), ("u1s", "y1r", " + S"),
                                    ("u0s", "y2r", ""), ("u1s", "y2r", " + S"))]

# name -> (text edits, what it tests; "diagnostic" when the result is wrong)
VARIANTS = {
    "shipped": ([], "the committed source"),
    "expf": ([("p = __expf(", "p = expf(")], "accurate expf"),
    "no_rounded_sums": (
        [("mma_3xtf32_rn(acc", "mma_3xtf32(acc")],
        "gradient sums kept in the tensor cores' accumulator"),
    "cvt_rna": ([(_INT_RNA, '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;" '
                            ': "=r"(r) : "f"(x));\n  return r;')],
                "TF32 rounding by cvt.rna.tf32.f32 (the same bits)"),
    "two_blocks_per_sm": ([(_MB, "__launch_bounds__(kThreads, 2)")],
                          "no register cap below 255, no spills"),
    "eight_warps": ([("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                     (_MB, "__launch_bounds__(kThreads, 1)")],
                    "128 rows per block"),
    "tiles_of_32": ([("constexpr int kCols = 64; ",
                      "constexpr int kCols = 32; ")],
                    "32-row tiles of the streamed side"),
    "one_tf32_pass": ([(_MMA3, "  mma_tf32(c, a_big, __float_as_uint(b0_big), "
                               "__float_as_uint(b1_big));")],
                      "diagnostic: one TF32 product in place of three"),
    "half_smem_reads": (_SMALL_LOADS,
                        "diagnostic: B's small part read from its big part"),
    "no_exp": ([("p = __expf(", "p = 1e-3f * (")], "diagnostic: no exp"),
    "no_split_pass": ([("i < 2 * kCols * kVecs; i += kThreads", "i < 0; ++i")],
                      "diagnostic: the tile is not split"),
}

_BF16_RESCALE = """#pragma unroll
    for (int n = 0; n < kNd; ++n) {
      o[n][0] *= alpha[0];"""
FWD_VARIANTS = {
    "shipped": ([], "the committed source"),
    "sums_per_8_keys": (
        [("mma_3xtf32(c[nd], pb, ps,", "mma_3xtf32_rn(c[nd], pb, ps,")],
        "fp32 p v summed in fresh registers per 8 keys, not per tile"),
    "two_stages": ([("constexpr int kStagesBf16 = 3;",
                     "constexpr int kStagesBf16 = 2;")],
                   "bf16 ring of two stages"),
    "four_stages": ([("constexpr int kStagesBf16 = 3;",
                      "constexpr int kStagesBf16 = 4;")],
                    "bf16 ring of four stages"),
    "tiles_of_128": ([("constexpr int kBlockK = 64; ",
                       "constexpr int kBlockK = 128; ")], "128-key tiles"),
    "tiles_of_32": ([("constexpr int kBlockK = 64; ",
                      "constexpr int kBlockK = 32; ")], "32-key tiles"),
    "rescale_when_max_moves": (
        [(_BF16_RESCALE, "if (__any_sync(0xffffffffu, alpha[0] != 1.f || "
                         "alpha[1] != 1.f))\n" + _BF16_RESCALE)],
        "bf16: the accumulator rescaled only when a row's max moved"),
    "one_tf32_pass": VARIANTS["one_tf32_pass"],
    "no_exp": ([("s[nb][i] = exp2_approx(s[nb][i] - m[i >> 1]);",
                 "s[nb][i] = (s[nb][i] - m[i >> 1]) * 1e-3f;")],
               "diagnostic: no exponent"),
    "no_split_pass": ([("i < 2 * kBlockK * kVecs; i += kThreads",
                        "i < 0; ++i")],
                      "diagnostic: the fp32 tile is not split"),
}


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


GATHER_VARIANTS = {
    "shipped": ([], "the committed source"),
    "unroll_2": ([("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
                 "two vectors per batch"),
    "unroll_8": ([("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
                 "eight vectors per batch"),
    "no_shared": ([("if (row_bytes <= (size_t)max_shared_bytes())",
                    "if (false)")],
                  "axis 1 from device memory (L1), no shared-memory copy"),
    "threads_128": ([("  threads = std::min((long long)kThreads,",
                      "  threads = std::min(128LL,")],
                    "128 threads per block"),
}

# kind -> (source, variants, kernels whose D = 32 / fp32 ptxas lines print)
KINDS = {
    "bwd": ("flash_attn_bwd.cu", VARIANTS, ["IfLi32E"]),
    "fwd": ("flash_attn_fwd.cu", FWD_VARIANTS,
            ["flash_fwd_f32_kernelILi32E", "flash_fwd_bf16_kernelILi32E"]),
    "gather": ("gather.cu", GATHER_VARIANTS,
               ["element_gather_kernelIjLi1ELb1E"]),
}


def _ptxas_lines(log, kernels):
    """Registers and spills of the entries that name one of `kernels`."""
    lines = log.splitlines()
    return [lines[i + 3].split(":")[-1].strip() + "; " + lines[i + 2].strip()
            for i, ln in enumerate(lines)
            if "Compiling entry" in ln and any(k in ln for k in kernels)]


def build(parent, kind, only=None):
    from regtr_tpu_torch.ops import attention, cuda_build, gather

    name_cu, variants, kernels = KINDS[kind]
    texts = {f.name: f.read_text()
             for f in [CSRC / name_cu, *sorted(CSRC.glob("*.cuh"))]}
    sources = {}
    for name, (edits, _) in variants.items():
        if only and name not in only:
            continue
        files = dict(texts)
        if not all(any(a in t for t in files.values()) for a, _ in edits):
            print(f"{name}: its edits no longer apply to the source; skipped")
            continue
        for a, b in edits:
            files = {f: t.replace(a, b) for f, t in files.items()}
        (OUT / name).mkdir(parents=True, exist_ok=True)
        for f, t in files.items():
            (OUT / name / f).write_text(t)
        sources[name] = OUT / name / name_cu
    if parent:
        sources["parent"] = Path(parent)
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I",
         str(CSRC), "-o", str(OUT / f"{name}.so"), str(path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, path in sources.items()}
    declare = {"bwd": attention._declare_bwd, "fwd": attention._declare_fwd,
               "gather": gather._declare}[kind]
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        print(f"{name}: ptxas: {' / '.join(_ptxas_lines(log, kernels))}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        declare(lib)
        libs[name] = lib
    return libs


def run(lib, which, q, k, v, bias, do, lse, delta, scale):
    """One launch of a library's dkv or dq entry; its outputs."""
    import torch

    bh, nq, d = q.shape
    nk = k.shape[1]
    stream = torch.cuda.current_stream().cuda_stream
    common = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
              do.data_ptr(), lse.data_ptr(), delta.data_ptr()]
    flags = [bh, nq, nk, d, int(q.dtype == torch.bfloat16), float(scale),
             stream]
    if which == "dq":
        dq = torch.empty_like(q)
        err = lib.regtr_flash_attn_bwd_dq(*common, dq.data_ptr(), *flags)
        outs = (dq,)
    else:
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        db = torch.empty((bh, nk), dtype=torch.float32, device=q.device)
        err = lib.regtr_flash_attn_bwd_dkv(*common, dk.data_ptr(),
                                           dv.data_ptr(), db.data_ptr(),
                                           *flags)
        outs = (dk, dv, db)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return outs


def run_fwd(lib, q, k, v, bias, scale, want_lse):
    """One launch of a library's forward; (out, lse or None)."""
    import torch

    bh, nq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    err = lib.regtr_flash_attn_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), bh, nq,
        k.shape[1], d, int(q.dtype == torch.bfloat16), float(scale),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out, lse


def cuda_ms(fn, iters=30, warmup=5):
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


def fp64_backward(q, k, v, bias, do, scale):
    """(dq, dk, dv, dbias) of the masked attention, all in fp64."""
    import torch

    q, k, v, do = (x.double() for x in (q, k, v, do))
    s = torch.einsum("bqd,bkd->bqk", q, k) * scale + bias[:, None, :].double()
    p = torch.softmax(s, -1)
    o = torch.einsum("bqk,bkd->bqd", p, v)
    ds = p * (torch.einsum("bqd,bkd->bqk", do, v)
              - (do * o).sum(-1, keepdim=True))
    return (torch.einsum("bqk,bkd->bqd", ds, k) * scale,
            torch.einsum("bqk,bqd->bkd", ds, q) * scale,
            torch.einsum("bqk,bqd->bkd", p, do), ds.sum(1))


def run_gather(lib, src, idx, axis):
    """One launch of a library's element gather (as ops/gather.py calls
    it); its output."""
    import torch

    from regtr_tpu_torch.ops.gather import _slices

    _, _, s_cols, s_stride = _slices(src, "src")
    b, rows, cols, i_stride = _slices(idx, "idx")
    out = torch.empty(idx.shape, dtype=src.dtype, device=src.device)
    err = lib.regtr_element_gather(
        src.data_ptr(), idx.data_ptr(), out.data_ptr(), b, rows, cols, s_cols,
        axis, s_stride, i_stride, rows * cols, src.element_size(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out


def main_gather(libs):
    import torch

    g = torch.Generator().manual_seed(5)
    shape, axis = (160, 32, 5120), 1
    for dtype in (torch.float32, torch.bfloat16):
        src = torch.randn(*shape, generator=g).to("cuda", dtype)
        idx = torch.randint(0, shape[2], shape, generator=g).cuda()
        ref = torch.gather(src, 2, idx)
        nbytes = src.numel() * src.element_size() * 2 + idx.numel() * 8
        print(f"{str(dtype)[6:]} {shape} axis {axis}: bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms (bytes)")
        for name, lib in libs.items():
            print(f"  {name}: bitwise torch.gather "
                  f"{torch.equal(run_gather(lib, src, idx, axis), ref)}")
        times = {}
        for name in list(libs) + list(reversed(list(libs))):
            lib = libs[name]
            times.setdefault(name, []).append(
                (cuda_ms(lambda: run_gather(lib, src, idx, axis)),
                 cuda_ms(lambda: torch.gather(src, 2, idx))))
        print(f"{str(dtype)[6:]} ms in two turns (variant, torch.gather "
              "right after it):")
        for name, turns in times.items():
            what = (GATHER_VARIANTS[name][1] if name in GATHER_VARIANTS
                    else "--parent")
            print(f"  {name}: " + "; ".join(f"{a:.4f} ({b:.4f})"
                                           for a, b in turns)
                  + f"  ({what})", flush=True)


def _masked_inputs(shape, dtype, seed):
    import torch

    from regtr_tpu_torch.ops import attention

    bh, nq, nk, d = shape
    g = torch.Generator().manual_seed(seed)
    q, k, v, do = (torch.randn(bh, n, d, generator=g).to("cuda", dtype)
                   for n in (nq, nk, nk, nq))
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, :4] = True
    bias = torch.where(mask, 0.0, attention.NEG_BIAS).float().cuda()
    return q, k, v, bias, do


def _rel(got, ref):
    return float((got.double() - ref.double()).abs().max()
                 / ref.double().abs().max())


def main_forward(libs):
    import torch
    import torch.nn.functional as F

    from regtr_tpu_torch.ops import attention

    for name, shape in (("bfloat16", (64, 1872, 1872, 32)),
                        ("float32", (32, 2240, 2240, 32)),
                        ("float32", (16, 2992, 2992, 32))):
        q, k, v, bias, _ = _masked_inputs(shape, getattr(torch, name), 1)
        scale = shape[3] ** -0.5
        plain, plain_lse = attention.flash_masked_attention_reference(
            q, k, v, bias, scale, return_lse=True)
        s64 = (torch.einsum("bqd,bkd->bqk", q.double(), k.double()) * scale
               + bias[:, None, :].double())
        truth = torch.einsum("bqk,bkd->bqd", torch.softmax(s64, -1),
                             v.double())
        del s64
        print(f"{name} {shape} plain vs fp64: out {_rel(plain, truth):.2e}")
        for vname, lib in libs.items():
            out, lse = run_fwd(lib, q, k, v, bias, scale, True)
            again, _ = run_fwd(lib, q, k, v, bias, scale, False)
            print(f"  {vname}: bitwise repeat {torch.equal(out, again)}; "
                  f"out vs plain max abs "
                  f"{float((out.float() - plain.float()).abs().max()):.2e}, "
                  f"vs fp64 {_rel(out, truth):.2e}; lse vs plain max abs "
                  f"{float((lse - plain_lse).abs().max()):.2e}")
        times = {}
        for vname in list(libs) + list(reversed(list(libs))):
            lib = libs[vname]
            times.setdefault(vname, []).append(cuda_ms(
                lambda: run_fwd(lib, q, k, v, bias, scale, False)))
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=bias[:, None, :], scale=scale))
        print(f"{name} {shape} forward ms in two turns:")
        for vname, turns in times.items():
            what = (FWD_VARIANTS[vname][1] if vname in FWD_VARIANTS
                    else "--parent")
            print(f"  {vname}: " + "; ".join(f"{t:.4f}" for t in turns)
                  + f"  ({what})")
        print(f"  SDPA forward {lib_ms:.4f}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--forward", action="store_true",
                      help="the forward kernel's variants")
    kind.add_argument("--gather", action="store_true",
                      help="the element gather's variants")
    ap.add_argument("--parent", help="another version of the source to time")
    ap.add_argument("--variants", help="comma-separated names: build and "
                    "time only these (and --parent)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    from regtr_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    kind = "fwd" if args.forward else "gather" if args.gather else "bwd"
    libs = build(args.parent, kind,
                 args.variants.split(",") if args.variants else None)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.forward:
        return main_forward(libs)
    if args.gather:
        return main_gather(libs)
    names = ("dq", "dk", "dv", "dbias")
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, bias, do = _masked_inputs((32, 2240, 2240, 32), dtype, 1)
        scale = 32 ** -0.5
        out, lse = attention._fwd(q, k, v, bias, scale, True)
        delta = attention.attention_delta(out, do)
        ins = (q, k, v, bias, do, lse, delta, scale)
        plain = attention.flash_masked_attention_bwd_reference(
            q, k, v, bias, out, lse, do, scale)
        truth = fp64_backward(q, k, v, bias, do, scale)
        print(f"{str(dtype)[6:]} plain vs fp64: " + ", ".join(
            f"{nm} {_rel(p, t):.2e}" for nm, p, t in zip(names, plain, truth)))
        for name, lib in libs.items():
            got = run(lib, "dq", *ins) + run(lib, "dkv", *ins)
            again = run(lib, "dq", *ins) + run(lib, "dkv", *ins)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  {name}: bitwise repeat {same}; vs plain / fp64: "
                  + ", ".join(f"{nm} {_rel(x, p):.2e} / {_rel(x, t):.2e}"
                              for nm, x, p, t in zip(names, got, plain,
                                                     truth)))
        times = {}
        for name in list(libs) + list(reversed(list(libs))):
            lib = libs[name]
            times.setdefault(name, []).append(
                (cuda_ms(lambda: run(lib, "dkv", *ins)),
                 cuda_ms(lambda: run(lib, "dq", *ins))))
        mask4 = bias[:, None, :]
        qs, ks, vs = (x.detach().clone().requires_grad_() for x in (q, k, v))
        fwd_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask4, scale=scale))

        def sdpa():
            o = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask4,
                                               scale=scale)
            torch.autograd.grad(o, (qs, ks, vs), do)

        lib_ms = cuda_ms(sdpa) - fwd_ms
        print(f"{str(dtype)[6:]} (32, 2240, 2240, 32), ms (dkv, dq) in two "
              "turns:")
        for name, turns in times.items():
            what = VARIANTS[name][1] if name in VARIANTS else args.parent
            print(f"  {name}: " + "; ".join(f"{a:.4f} + {b:.4f} = {a + b:.4f}"
                                           for a, b in turns) + f"  ({what})")
        print(f"  SDPA backward {lib_ms:.4f}", flush=True)


if __name__ == "__main__":
    main()
