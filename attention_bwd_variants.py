#!/usr/bin/env python3
"""Time design variants of the attention backward kernels on one CUDA card.

    python3 attention_bwd_variants.py [--parent OLD.cu]

Each variant is the committed regtr_tpu_torch/csrc/flash_attn_bwd.cu with a
few text edits (a variant whose edits no longer apply is skipped, and
said so).  All are built at once with the port's nvcc flags into
.build/variants/, with `--parent` (another version of the source, e.g. from
`git show REV:regtr_tpu_torch/csrc/flash_attn_bwd.cu`) beside them.  At the
training shape (32, 2240, 2240, 32), fp32 and bf16, 20 % of keys masked,
each is checked for bitwise repeatability and for its error against the
plain version and against an fp64 backward (max |err| / max |grad|), then
dkv and dq are timed with CUDA events (medians of 30) in two turns, in
order and in reverse, with SDPA's backward as the yardstick.  Diagnostic
variants (marked) compute wrong gradients on purpose: they only say which
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
SOURCE = ROOT / "regtr_tpu_torch" / "csrc" / "flash_attn_bwd.cu"
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


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def build(parent):
    from regtr_tpu_torch.ops import attention, cuda_build

    OUT.mkdir(parents=True, exist_ok=True)
    src = SOURCE.read_text()
    sources = {}
    for name, (edits, _) in VARIANTS.items():
        text = src
        if not all(a in text for a, _ in edits):
            print(f"{name}: its edits no longer apply to the source; skipped")
            continue
        for a, b in edits:
            text = text.replace(a, b)
        sources[name] = OUT / f"{name}.cu"
        sources[name].write_text(text)
    if parent:
        sources["parent"] = Path(parent)
    procs = {name: subprocess.Popen(
        [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o",
         str(OUT / f"{name}.so"), str(path)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, path in sources.items()}
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        lines = log.splitlines()
        regs = [lines[i + 3].split(":")[-1].strip()
                + "; " + lines[i + 2].strip()
                for i, ln in enumerate(lines)
                if "Compiling entry" in ln and "IfLi32E" in ln]
        print(f"{name}: fp32 D 32 ptxas: {' / '.join(regs)}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        attention._declare_bwd(lib)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="another flash_attn_bwd.cu to time")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch
    import torch.nn.functional as F

    from regtr_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    libs = build(args.parent)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = ("dq", "dk", "dv", "dbias")
    for dtype in (torch.float32, torch.bfloat16):
        bh, n, d = 32, 2240, 32
        g = torch.Generator().manual_seed(1)
        q, k, v, do = (torch.randn(bh, n, d, generator=g).to("cuda", dtype)
                       for _ in range(4))
        mask = torch.rand(bh, n, generator=g) > 0.2
        mask[:, :4] = True
        bias = torch.where(mask, 0.0, attention.NEG_BIAS).float().cuda()
        scale = d ** -0.5
        out, lse = attention._fwd(q, k, v, bias, scale, True)
        delta = attention.attention_delta(out, do)
        ins = (q, k, v, bias, do, lse, delta, scale)
        plain = attention.flash_masked_attention_bwd_reference(
            q, k, v, bias, out, lse, do, scale)
        truth = fp64_backward(q, k, v, bias, do, scale)

        def rel(got, ref):
            return float((got.double() - ref.double()).abs().max()
                         / ref.double().abs().max())

        print(f"{str(dtype)[6:]} plain vs fp64: " + ", ".join(
            f"{nm} {rel(p, t):.2e}" for nm, p, t in zip(names, plain, truth)))
        for name, lib in libs.items():
            got = run(lib, "dq", *ins) + run(lib, "dkv", *ins)
            again = run(lib, "dq", *ins) + run(lib, "dkv", *ins)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"  {name}: bitwise repeat {same}; vs plain / fp64: "
                  + ", ".join(f"{nm} {rel(x, p):.2e} / {rel(x, t):.2e}"
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
