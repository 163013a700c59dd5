#!/usr/bin/env python3
"""Time design variants of the attention kernels (and of K5b, the element
gather; K5a's narrow rows; K4, the gather transpose; K6, the brute
neighbor search) on one CUDA card.

    python3 kernel_variants.py [--forward | --gather | --rows | --segsum
                                | --neighbors]
                               [--parent OLD.cu] [--variants NAME,NAME,...]
    python3 kernel_variants.py --step-profile TREE

Each variant is the committed regtr_tpu_torch/csrc/flash_attn_bwd.cu (with
--forward: flash_attn_fwd.cu; with --gather or --rows: gather.cu; with
--segsum: segsum.cu; with --neighbors: neighbors.cu) and the headers
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
out against an fp64 forward), SDPA's forward the yardstick; then with key
extents at the inference cell's coarse level, (64, 2240, 2240, 32) fp32
with 280-420 valid keys a slice (prefix masks), and at ModelNet's (16, 656,
656, 32) with every key valid, each variant with and without extents
(bitwise equal) in turns; a parent source without the extent argument is
called as it was.  Gather: the
element gather at the probes' (160, 32, 5120) axis 1 in fp32 and bf16,
bitwise against torch.gather, and timed in turns with it.  Rows: the
row gather of the inference path's coordinate rows (5 242 880 rows of 3
fp32 from 8 clouds of 20 481 rows, neighbor-like ids) with int32 and int64
ids, bitwise against index_select and timed in turns with it (a parent
source without int32 ids is timed with int64 ids only).  Segsum: the
transpose of the training step's level-0 flat ids (3 145 728 int32 ids,
98 308 segments, a third pad rows), of ids with ~1400-row segments and of
the level-0 ids with each cloud's shadow row kept (segments of ~340 000
rows) bitwise against a stable sort, the sum over it (fp32, width 32)
bitwise against the shipped kernel's, and the transpose, the sum and their
first use together timed in turns; a parent source of the sorted form
(int64 perm and starts) is timed with its torch.sort + searchsorted route
on int64 ids, as it ran; torch.sort of the int32 ids is the yardstick.
Rows and segsum time single launches (chip_smoke.py's `ms`) and runs of 10
back-to-back calls.  Neighbors: K6 on the ten searches of chip_smoke.py
phase 5's pyramid (4 pairs of synthetic scans at bucket 20480) and the four
of a ModelNet pair's, each variant's table against the plain version's,
single launches in two turns with the culled, bytes and brute bounds
beside them; a parent of the first design, whose C entry takes no
scratch, is called as it was.  Step profile: the
training step's backward (the shipped config, chip_smoke.py phase 6's
batch; 2 warm-up steps, then torch.profiler over 3 backwards) with the
port imported from TREE (the root of a checkout, e.g. a parent commit
unpacked by `git archive`): the device time per backward of the gather
transpose's kernels (segsum, the transpose kernels, and torch.sort's and
searchsorted's, which only the gather transpose runs in the backward).
Diagnostic
variants (marked) compute wrong results on purpose: they only say which
resource the time goes to.  Needs a card; imports torch and the port.
"""
from __future__ import annotations

import argparse
import ctypes
import json
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
    "no_shared": ([("if (row_bytes <= (size_t)max_shared_bytes() &&",
                    "if (false &&")],
                  "axis 1 by the direct kernel, no shared-memory copy"),
    "threads_128": ([("  threads = std::min((long long)kThreads,",
                      "  threads = std::min(128LL,")],
                    "128 threads per block"),
}

_TAIL = "  for (int b = done + threadIdx.x * (int)sizeof(V); b < span;"
_STAGE = "          *reinterpret_cast<const uint4*>(stage + b)"
_STORE = "      *reinterpret_cast<uint4*>(o + b) =\n" + _STAGE + ";"
ROWS_VARIANTS = {
    "shipped": ([], "the committed source"),
    "rows_per_thread_1": ([("constexpr int kNarrowRows = 8;",
                            "constexpr int kNarrowRows = 1;")],
                          "one row per thread"),
    "rows_per_thread_2": ([("constexpr int kNarrowRows = 8;",
                            "constexpr int kNarrowRows = 2;")],
                          "two rows per thread"),
    "rows_per_thread_4": ([("constexpr int kNarrowRows = 8;",
                            "constexpr int kNarrowRows = 4;")],
                          "four rows per thread"),
    "rows_per_thread_16": ([("constexpr int kNarrowRows = 8;",
                            "constexpr int kNarrowRows = 16;")],
                          "sixteen rows per thread"),
    "scalar_ids": ([("constexpr bool kVectorIds = true;",
                     "constexpr bool kVectorIds = false;")],
                   "ids read one by one, not as 16-byte vectors"),
    "wide_path": ([("if constexpr (sizeof(V) < 16) {",
                    "if constexpr (sizeof(V) < 1) {")],
                  "narrow rows by the wide kernel (one vector per thread)"),
    "streaming_stores": ([(_STORE, "      __stcs(reinterpret_cast<uint4*>("
                           "o + b),\n" + _STAGE + ");")],
                         "the output stored with an evict-first hint"),
    "streaming_ids": ([("pack.v = reinterpret_cast<const uint4*>(idx)[h];",
                        "pack.v = __ldcs(reinterpret_cast<const uint4*>(idx)"
                        " + h);")],
                      "the ids loaded with an evict-first hint"),
    "scalar_stage": ([("constexpr bool kStageVectors = true;",
                       "constexpr bool kStageVectors = false;")],
                     "the stage written as 4-byte vectors, not 16-byte ones"),
    "no_table_loads": ([("if (r0 + k < n) mine.v[k * kVecs + i] = src[i];",
                         "mine.v[k * kVecs + i] = V{};")],
                       "diagnostic: the table is not read"),
    "no_output": ([(_TAIL, "  if (ids16 && out16 && !ids16)\n" + _TAIL),
                   ("    done = span / 16 * 16;", "    done = 0;")],
                  "diagnostic: the stage is not written out"),
}

SEGSUM_VARIANTS = {
    "shipped": ([], "the committed source"),
    "sum_rows_1": ([("constexpr int kRows = 8;", "constexpr int kRows = 1;")],
                   "one row's loads in flight (the first design)"),
    "sum_rows_4": ([("constexpr int kRows = 8;", "constexpr int kRows = 4;")],
                   "the sum with four rows' loads in flight"),
    "sum_rows_16": ([("constexpr int kRows = 8;",
                      "constexpr int kRows = 16;")],
                    "the sum with sixteen rows' loads in flight"),
    "sum_warps_8": ([("constexpr int kWarps = 2;",
                      "constexpr int kWarps = 8;")],
                    "8 segments (warps) per block"),
    "sum_warps_1": ([("constexpr int kWarps = 2;",
                      "constexpr int kWarps = 1;")],
                    "1 segment (warp) per block"),
    "long_from_1024": ([("constexpr int kLongSegment = 4096;",
                         "constexpr int kLongSegment = 1024;")],
                       "segments of more than 1024 rows by the long pass"),
    "no_order_pass": ([("    perm[lo + below] = r;", "    perm[p] = r;")],
                      "diagnostic: the rows are left in the atomics' order"),
}

# K6 (csrc/neighbors.cu): the team, the launch bounds, the culling test's
# verdict and the insertion's ballot in the shipped source
def _k6_team(t):
    """Teams of t lanes (32 / t queries a warp) where k <= 64; a warp a
    query for k > 64, as shipped."""
    return [("constexpr int kTeam = 32;", f"constexpr int kTeam = {t};"),
            ("launch_search<kTeam, slots_for(kTeam, 256)",
             "launch_search<32, slots_for(32, 256)")]


NEIGHBOR_VARIANTS = {
    "shipped": ([], "the committed source"),
    "no_culling": ([("  return gap2 <= __fadd_ru(lim, margin);",
                     "  return true;")],
                   "every tile scanned (tiles without a valid support "
                   "skipped, as in the first design)"),
    "team_1": (_k6_team(1), "T = 1: one lane a query, its whole list in "
                            "its registers"),
    "team_4": (_k6_team(4), "T = 4: 8 queries a warp"),
    "team_8": (_k6_team(8), "T = 8"),
    "team_16": (_k6_team(16), "T = 16: 2 queries a warp"),
    "min_blocks_1": ([("constexpr int kMinBlocks = 8;",
                       "constexpr int kMinBlocks = 1;")],
                     "no register cap below 255 (the launch bounds' "
                     "second argument 1)"),
    "warps_2": ([("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")],
                "2 warps a block"),
    "warps_8": ([("constexpr int kWarps = 4;", "constexpr int kWarps = 8;"),
                 ("constexpr int kMinBlocks = 8;",
                  "constexpr int kMinBlocks = 4;")],
                "8 warps a block"),
    "words_64": ([("  return bf16_key && ns < 65536;", "  return false;")],
                 "64-bit words only (no 32-bit packing of bf16 keys)"),
    "tile_64": ([("constexpr int kTile = 128;", "constexpr int kTile = 64;")],
                "tiles of 64 supports"),
    "tile_256": ([("constexpr int kTile = 128;",
                   "constexpr int kTile = 256;")], "tiles of 256 supports"),
    "keeps_nothing": ([("(__ballot_sync(kFull, w < worst) >> team_base) & "
                        "team_bits;",
                        "0u;\n            list[0] ^= (W)(w < worst);")],
                      "diagnostic: nothing is inserted (the bound never "
                      "tightens): the culling, the scan and the exact test "
                      "alone"),
}

# kind -> (source, variants, kernels whose D = 32 / fp32 ptxas lines print)
KINDS = {
    "bwd": ("flash_attn_bwd.cu", VARIANTS, ["IfLi32E"]),
    "fwd": ("flash_attn_fwd.cu", FWD_VARIANTS,
            ["flash_fwd_f32_kernelILi32E", "flash_fwd_bf16_kernelILi32E"]),
    "gather": ("gather.cu", GATHER_VARIANTS,
               ["element_gather_kernelIjLb1E",
                "element_gather_direct_kernelIjj"]),
    "rows": ("gather.cu", ROWS_VARIANTS, ["row_gather_narrow_kernelIji"]),
    "segsum": ("segsum.cu", SEGSUM_VARIANTS,
               ["segsum_kernelIf", "transpose_"]),
    "neighbors": ("neighbors.cu", NEIGHBOR_VARIANTS,
                  ["brute_neighbors_kernelILi64ELb1E", "pack_kernel",
                   "search_kernelILi32ELi2EjLb1E"]),
}


def _parent_form(path):
    """Whether a source is of the committed form, not the sorted form (no
    int32 row ids; a segsum over int64 perm and starts, no transpose
    entry)."""
    text = Path(path).read_text()
    return "idx_int64" in text or "regtr_segment_transpose" in text


def _ptxas_lines(log, kernels):
    """Registers and spills of the entries that name one of `kernels`."""
    lines = log.splitlines()
    return [lines[i + 3].split(":")[-1].strip() + "; " + lines[i + 2].strip()
            for i, ln in enumerate(lines)
            if "Compiling entry" in ln and any(k in ln for k in kernels)]


def build(parent, kind, only=None):
    from regtr_tpu_torch.ops import (attention, cuda_build, gather, kpconv,
                                     neighbors)

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
               "gather": gather._declare, "rows": gather._declare,
               "segsum": kpconv._declare_segsum,
               "neighbors": neighbors._declare}[kind]
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        print(f"{name}: ptxas: {' / '.join(_ptxas_lines(log, kernels))}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        if (name == "parent" and kind in ("rows", "segsum")
                and not _parent_form(sources[name])):
            _declare_sorted_form(lib, kind)
            lib.sorted_form = True
        elif kind == "neighbors" and not hasattr(
                lib, "regtr_neighbors_scratch_bytes"):
            _declare_unculled_form(lib)
            lib.unculled_form = True
        elif (name == "parent" and kind == "fwd"
              and "kv_extent" not in sources[name].read_text()):
            lib.regtr_flash_attn_fwd.argtypes = (
                [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                + [ctypes.c_float, ctypes.c_void_p])
            lib.regtr_flash_attn_fwd.restype = ctypes.c_int
            lib.no_extents = True
        else:
            declare(lib)
            # set, not looked up: a missing attribute of a CDLL is a
            # symbol lookup, microseconds on every launch
            lib.no_extents = False
        libs[name] = lib
    return libs


def _declare_sorted_form(lib, kind):
    """The sorted form's C interfaces: the row gather with int64 ids only,
    the segment sum over an int64 sort's perm and starts with the pad
    stride."""
    if kind == "rows":
        lib.regtr_row_gather.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
            + [ctypes.c_void_p])
        lib.regtr_row_gather.restype = ctypes.c_int
    elif kind == "segsum":
        lib.regtr_segsum.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_longlong, ctypes.c_int,
                                     ctypes.c_void_p])
        lib.regtr_segsum.restype = ctypes.c_int
    else:
        raise ValueError(f"--parent of another form for {kind}")


def _declare_unculled_form(lib):
    """The first design of the brute search (one thread a query, no
    pre-pass): its C entry takes no scratch."""
    lib.regtr_brute_neighbors.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 3
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int]
        + [ctypes.c_void_p] * 2)
    lib.regtr_brute_neighbors.restype = ctypes.c_int


def _check(err):
    if err:
        raise RuntimeError(f"launch failed: {err}")


def run_rows(lib, table, ids):
    """One launch of a library's row gather; its output."""
    import torch

    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    stream = torch.cuda.current_stream().cuda_stream
    row_bytes = table.shape[1] * table.element_size()
    if getattr(lib, "sorted_form", False):
        _check(lib.regtr_row_gather(table.data_ptr(), ids.data_ptr(),
                                    out.data_ptr(), ids.shape[0], row_bytes,
                                    stream))
    else:
        _check(lib.regtr_row_gather(
            table.data_ptr(), ids.data_ptr(), int(ids.dtype == torch.int64),
            out.data_ptr(), ids.shape[0], row_bytes, stream))
    return out


def main_rows(libs):
    import torch

    from chip_smoke import neighbor_like_ids

    g = torch.Generator().manual_seed(5)
    clouds, n, k = 8, 20480, 32
    table = torch.randn(clouds * (n + 1), 3, generator=g).cuda()
    ids64 = neighbor_like_ids(g, clouds, n, k)
    for ids in (ids64.int(), ids64):
        width = str(ids.dtype)[6:]
        ref = torch.index_select(table, 0, ids)
        nbytes = table.numel() * 4 + ids.numel() * ids.element_size() \
            + ref.numel() * 4
        print(f"{ids.shape[0]} x 3 fp32, {width} ids: bound "
              f"{nbytes / 3.35e12 * 1e3:.4f} ms (bytes)")
        runs = {name: lib for name, lib in libs.items()
                if ids.dtype == torch.int64
                or not getattr(lib, "sorted_form", False)}
        for name, lib in runs.items():
            print(f"  {name}: bitwise index_select "
                  f"{torch.equal(run_rows(lib, table, ids), ref)}")
        for reps in (1, 10):
            times = {}
            for name in list(runs) + list(reversed(list(runs))):
                lib = runs[name]
                times.setdefault(name, []).append(
                    (cuda_ms(lambda: run_rows(lib, table, ids), reps=reps),
                     cuda_ms(lambda: torch.index_select(table, 0, ids),
                             reps=reps)))
            print(f"{width} ids, ms in two turns (variant, index_select "
                  f"right after it), "
                  + ("single launches:" if reps == 1 else
                     f"runs of {reps} back-to-back calls:"))
            for name, turns in times.items():
                what = (ROWS_VARIANTS[name][1] if name in ROWS_VARIANTS
                        else "--parent")
                print(f"  {name}: " + "; ".join(f"{a:.4f} ({b:.4f})"
                                               for a, b in turns)
                      + f"  ({what})", flush=True)


def run_transpose(lib, ids, num, stride):
    """One launch of a library's transpose, as ops/kpconv.py
    segment_transpose makes it; (perm, starts)."""
    import torch

    rows = ids.shape[0]
    starts = torch.empty(num + 1, dtype=torch.int32, device=ids.device)
    perm = torch.empty(rows, dtype=torch.int32, device=ids.device)
    tmp = torch.empty(lib.regtr_segment_transpose_scratch(rows, num),
                      dtype=torch.int32, device=ids.device)
    _check(lib.regtr_segment_transpose(
        ids.data_ptr(), int(ids.dtype == torch.int64), rows, num, stride,
        starts.data_ptr(), perm.data_ptr(), tmp.data_ptr(),
        torch.cuda.current_stream().cuda_stream))
    return perm, starts


def run_sum(lib, g, perm, starts, stride):
    """One launch of a library's segment sum; its output."""
    import torch

    num = starts.shape[0] - 1
    out = torch.empty((num, g.shape[1]), dtype=torch.float32, device=g.device)
    stream = torch.cuda.current_stream().cuda_stream
    if getattr(lib, "sorted_form", False):
        _check(lib.regtr_segsum(g.data_ptr(), perm.data_ptr(),
                                starts.data_ptr(), out.data_ptr(), num,
                                g.shape[1], stride, 0, stream))
    else:
        _check(lib.regtr_segsum(g.data_ptr(), perm.data_ptr(),
                                starts.data_ptr(), out.data_ptr(), num,
                                g.shape[1], 0, stream))
    return out


def level0_ids():
    """The training step's level-0 flat ids as chip_smoke.py's phase 6
    makes them (2 pairs of synthetic scans, the shipped config), int32;
    the number of segments and their stride (the clouds' padded length)."""
    import torch

    from chip_smoke import N_POINTS, synthetic_samples
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.ops.kpconv import GatherIndex
    from regtr_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    cfg = threedmatch_config()
    batch, _ = collate_pairs(synthetic_samples(
        int(cfg["train_batch_size"]), N_POINTS, 0, cfg), cfg["buckets"])
    n0 = batch["points"].shape[1]
    with torch.no_grad():
        levels = build_pyramid(torch.from_numpy(batch["points"]).cuda(),
                               torch.from_numpy(batch["mask"]).cuda(),
                               make_pyramid_spec(cfg, n0))
    table = levels[0].neighbors
    index = GatherIndex(table.reshape(table.shape[0], -1), n0 + 1)
    return index.flat, index.num_segments, n0 + 1


def main_segsum(libs):
    import torch

    from chip_smoke import neighbor_like_ids
    from regtr_tpu_torch.ops.kpconv import segment_transpose_reference

    g = torch.Generator().manual_seed(3)
    real, num, stride = level0_ids()
    # neighbor_like_ids clamps at each cloud's ends: 8 segments of ~1400
    # rows, the long-segment case
    clamped = neighbor_like_ids(g, num // stride, stride - 1, 32).int()
    for what, ids, seg_stride in (
            ("the training step's level-0 table", real, stride),
            ("neighbor-like ids with ~1400-row segments", clamped, stride),
            ("the level-0 table, shadow rows kept (batched_row_gather's "
             "backward)", real, num + 1)):
        _segsum_turns(libs, what, ids, num, seg_stride, g,
                      segment_transpose_reference)


def _segsum_turns(libs, what, ids, num, stride, g, reference):
    import torch

    c = 32
    ids64 = ids.long()
    rows = torch.randn(ids.shape[0], c, generator=g).cuda()
    ref = reference(ids, num, stride)
    m = int(ref.starts[-1])
    want = run_sum(libs["shipped"], rows, ref.perm, ref.starts, stride) \
        if "shipped" in libs else None
    print(f"{what}: {ids.shape[0]} int32 ids, {num} segments, {m} non-pad "
          f"rows, longest segment {int(ref.starts.diff().max())}; bound "
          f"(bytes): transpose "
          f"{(ids.shape[0] + m + num + 1) * 4 / 3.35e12 * 1e3:.4f} ms, sum "
          f"{((m * c + m + num + 1) + num * c) * 4 / 3.35e12 * 1e3:.4f} ms")

    def sort_transpose():
        sorted_ids, perm = torch.sort(ids64, stable=True)
        return perm, torch.searchsorted(
            sorted_ids, torch.arange(num + 1, device=ids.device))

    fns = {}
    for name, lib in libs.items():
        if getattr(lib, "sorted_form", False):
            perm, starts = sort_transpose()
            fns[name] = (sort_transpose,
                         lambda lib=lib, p=perm, st=starts: run_sum(
                             lib, rows, p, st, stride),
                         lambda lib=lib: run_sum(lib, rows, *sort_transpose(),
                                                 stride))
            continue
        perm, starts = run_transpose(lib, ids, num, stride)
        same_t = (torch.equal(starts, ref.starts)
                  and torch.equal(perm[:m], ref.perm[:m]))
        got = run_sum(lib, rows, perm, starts, stride)
        print(f"  {name}: transpose bitwise the stable sort {same_t}; sum "
              f"bitwise the shipped kernel's "
              f"{want is not None and torch.equal(got, want)}")
        fns[name] = (lambda lib=lib: run_transpose(lib, ids, num, stride),
                     lambda lib=lib, p=perm, st=starts: run_sum(
                         lib, rows, p, st, stride),
                     lambda lib=lib: run_sum(lib, rows, *run_transpose(
                         lib, ids, num, stride), stride))
    for reps in (1, 10):
        times = {}
        for name in list(fns) + list(reversed(list(fns))):
            times.setdefault(name, []).append(
                [cuda_ms(fn, reps=reps) for fn in fns[name]]
                + [cuda_ms(lambda: torch.sort(ids, stable=True), reps=reps)])
        print("ms in two turns: transpose / sum / first use (torch.sort of "
              "the int32 ids right after them), "
              + ("single launches:" if reps == 1 else
                 f"runs of {reps} back-to-back calls:"))
        for name, turns in times.items():
            what = (SEGSUM_VARIANTS[name][1] if name in SEGSUM_VARIANTS
                    else "--parent: torch.sort + searchsorted of int64 ids, "
                    "its sum")
            print(f"  {name}: " + "; ".join(
                " / ".join(f"{x:.4f}" for x in t[:3]) + f" ({t[3]:.4f})"
                for t in turns) + f"  ({what})", flush=True)


# The gather transpose's kernels as the profiler names them (chip_smoke.py
# K4_KERNELS), and the sorted form's sort and searchsorted, which only the
# gather transpose runs in the backward.  (chip_smoke is imported from
# TREE, which may predate K4_KERNELS.)
K4_NAMES = ("segsum_kernel", "transpose_", "scan_reduce_kernel",
            "scan_sums_kernel", "scan_apply_kernel", "RadixSort",
            "searchsorted")


def main_step_profile(tree):
    """K4's kernels per training-step backward for the port in `tree`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import regtr_tpu_torch
    from chip_smoke import N_POINTS, synthetic_samples
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.models import create_model
    from regtr_tpu_torch.train import steps
    from regtr_tpu_torch.train.optim import Optimizer

    print(f"port from {Path(regtr_tpu_torch.__file__).parent}")
    cfg = threedmatch_config()
    batch_np, _ = collate_pairs(synthetic_samples(
        int(cfg["train_batch_size"]), N_POINTS, 0, cfg), cfg["buckets"])
    batch = {k: torch.from_numpy(v).cuda() for k, v in batch_np.items()}
    model = create_model(cfg, batch_np["points"].shape[1], "cuda", seed=0)
    opt = Optimizer(model.parameters(), cfg)
    step = steps.make_train_step(model, opt, cfg)
    for _ in range(2):
        step(batch)
    per_name, n = {}, 3
    trace = OUT.parent / "step_profile.json"
    trace.parent.mkdir(exist_ok=True)
    for _ in range(n):
        losses, _ = steps.forward_loss(model, batch)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps.backward(opt, losses["total"])
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(trace))
        for e in json.loads(trace.read_text())["traceEvents"]:
            if e.get("cat") == "kernel" and any(k in e["name"]
                                                for k in K4_NAMES):
                per_name[e["name"]] = per_name.get(e["name"], 0.0) + e["dur"]
    total = sum(per_name.values()) / 1e3 / n
    print(f"gather transpose kernels per backward: {total:.4f} ms")
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1]):
        print(f"  {us / 1e3 / n:.4f} ms  {name[:110]}")


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


def run_fwd(lib, q, k, v, bias, scale, want_lse, kv_extent=None):
    """One launch of a library's forward; (out, lse or None).  A library
    without the extent argument is called without it."""
    import torch

    bh, nq, d = q.shape
    out = torch.empty_like(q)
    lse = (torch.empty((bh, nq), dtype=torch.float32, device=q.device)
           if want_lse else None)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if lse is None else lse.data_ptr()]
    if not lib.no_extents:
        ptrs.append(None if kv_extent is None else kv_extent.data_ptr())
    err = lib.regtr_flash_attn_fwd(
        *ptrs, bh, nq, k.shape[1], d, int(q.dtype == torch.bfloat16),
        float(scale), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: {err}")
    return out, lse


def cuda_ms(fn, iters=30, warmup=5, reps=1):
    """chip_smoke.py's timing: the median ms per call over `iters` runs of
    `reps` calls between CUDA events (reps=1: single launches, the host's
    launch latency in; reps=10: back to back)."""
    from chip_smoke import cuda_ms as timed

    return timed(fn, iters, warmup, reps)


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


def run_search(lib, args):
    """One launch of a library's brute search (as ops/neighbors.py calls
    it); its table."""
    import torch

    from regtr_tpu_torch.ops.neighbors import acceptance_threshold

    q, qm, s, sm, radius, k = args
    b, nq, ns = q.shape[0], q.shape[1], s.shape[1]
    out = torch.empty((b, nq, k), dtype=torch.int64, device=q.device)
    head = (q.data_ptr(), qm.data_ptr(), s.data_ptr(), sm.data_ptr(), b, nq,
            ns, k, acceptance_threshold(radius), int(ns >= 4 * k),
            out.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if getattr(lib, "unculled_form", False):
        _check(lib.regtr_brute_neighbors(*head, stream))
        return out
    scratch = torch.empty(lib.regtr_neighbors_scratch_bytes(b, ns),
                          dtype=torch.uint8, device=q.device)
    _check(lib.regtr_brute_neighbors(*head, scratch.data_ptr(), stream))
    return out


def main_neighbors(libs):
    """K6's variants on the ten searches of chip_smoke.py phase 5's pyramid
    and the four of a ModelNet pair's: bitwise the plain version, then
    single launches in two turns (in order, then in reverse)."""
    import torch

    import chip_smoke
    from regtr_tpu_torch.config import modelnet_config, threedmatch_config
    from regtr_tpu_torch.data import get_dataset
    from regtr_tpu_torch.data.collate import collate_pairs
    from regtr_tpu_torch.ops.neighbors import brute_radius_neighbors_plain

    pts, mask = (torch.from_numpy(x).cuda()
                 for x in chip_smoke.synthetic_pairs(
                     chip_smoke.N_PAIRS, chip_smoke.N_POINTS, seed=0))
    mcfg = modelnet_config(root=str(chip_smoke.MODELNET_NO_SHARDS))
    batch, _ = collate_pairs([get_dataset(mcfg, "test")[0]],
                             [max(mcfg["buckets"])])
    groups = {"3DMatch forward": chip_smoke.recorded_searches(
        threedmatch_config(), pts, mask),
        "ModelNet pair": chip_smoke.recorded_searches(
            mcfg, torch.from_numpy(batch["points"]).cuda(),
            torch.from_numpy(batch["mask"]).cuda())}
    for group, searches in groups.items():
        sums = {}
        print(f"{group}: ms of single launches in two turns (bound):")
        for name, args in searches:
            ref = brute_radius_neighbors_plain(*args)
            same = {v: torch.equal(run_search(lib, args), ref)
                    for v, lib in libs.items()}
            times = {}
            for v in list(libs) + list(reversed(list(libs))):
                lib = libs[v]
                times.setdefault(v, []).append(
                    cuda_ms(lambda: run_search(lib, args)))
            bnd = chip_smoke.search_bound(args)
            print(f"  {name} {list(args[0].shape[:2])} x {args[2].shape[1]}"
                  f", K {args[5]} (bounds: culled "
                  f"{bnd['culled_bound_ms']:.4f}, bytes "
                  f"{bnd['bytes_bound_ms']:.4f}, brute "
                  f"{bnd['brute_bound_ms']:.4f}):")
            for v, turns in times.items():
                sums[v] = sums.get(v, 0.0) + sum(turns) / 2
                print(f"    {v}: " + " / ".join(f"{t:.4f}" for t in turns)
                      + ("" if same[v] else "  (not the plain version's "
                         "table)"), flush=True)
        for v, total in sums.items():
            what = (NEIGHBOR_VARIANTS[v][1] if v in NEIGHBOR_VARIANTS
                    else "--parent")
            print(f"  {group}, all searches: {v} {total:.3f} ms ({what})",
                  flush=True)


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
    for shape, lengths in (((64, 2240, 2240, 32), (280, 420)),
                           ((16, 656, 656, 32), None)):
        forward_with_extents(libs, shape, lengths)


def forward_with_extents(libs, shape, lengths):
    """fp32 K1 with and without key extents: prefix masks with valid
    lengths drawn from `lengths` (every key valid at None), out and lse
    bitwise equal, single launches and back to back in turns."""
    import torch

    from regtr_tpu_torch.ops import attention

    bh, nq, nk, d = shape
    g = torch.Generator().manual_seed(nk)
    q, k, v = (torch.randn(bh, nk, d, generator=g).cuda() for _ in range(3))
    valid = (torch.full((bh,), nk) if lengths is None else
             torch.randint(lengths[0], lengths[1] + 1, (bh,), generator=g))
    mask = torch.arange(nk)[None, :] < valid[:, None]
    bias = torch.where(mask, 0.0, attention.NEG_BIAS).float().cuda()
    ext = attention.key_extents(mask.cuda())
    scale = d ** -0.5
    runs = {}
    for vname, lib in libs.items():
        runs[vname] = {"null": lambda lib=lib: run_fwd(
            lib, q, k, v, bias, scale, False)}
        if not lib.no_extents:
            runs[vname]["extents"] = lambda lib=lib: run_fwd(
                lib, q, k, v, bias, scale, False, ext)
            out, lse = run_fwd(lib, q, k, v, bias, scale, True, ext)
            ref, ref_lse = run_fwd(lib, q, k, v, bias, scale, True)
            print(f"{shape} valid {lengths or 'all'}: {vname} with extents "
                  f"bitwise {torch.equal(out, ref) and torch.equal(lse, ref_lse)}",
                  flush=True)
    order = [(v, how) for v in runs for how in runs[v]]
    times = {}
    for reps in (1, 10):
        for key in order + order[::-1]:
            times.setdefault((key, reps), []).append(
                cuda_ms(runs[key[0]][key[1]], reps=reps))
    for key in order + order[::-1]:
        times.setdefault((key, "device"), []).append(
            device_ms(runs[key[0]][key[1]]))
    print(f"{shape} valid {lengths or 'all'}: forward ms in two turns "
          "(single; back to back 10; the kernel's device time by the "
          "profiler):")
    for key in order:
        print(f"  {key[0]} {key[1]}: " + "; ".join(
            f"{t:.4f}" for t in times[(key, 1)]) + "  b2b " + "; ".join(
            f"{t:.4f}" for t in times[(key, 10)]) + "  device " + "; ".join(
            f"{t:.4f}" for t in times[(key, "device")]), flush=True)


def device_ms(fn, iters=30):
    """Median device milliseconds of the K1 launches of `iters` calls of
    fn(), from torch.profiler's kernel events: no host time in it."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    found = [(e.end_ns() - e.start_ns()) * 1e-6
             for e in prof.profiler.kineto_results.events()
             if e.device_type() == torch.autograd.DeviceType.CUDA
             and "flash_fwd_" in e.name()]
    return statistics.median(found) if found else float("nan")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    kind = ap.add_mutually_exclusive_group()
    kind.add_argument("--forward", action="store_true",
                      help="the forward kernel's variants")
    kind.add_argument("--gather", action="store_true",
                      help="the element gather's variants")
    kind.add_argument("--rows", action="store_true",
                      help="the row gather's narrow-row variants")
    kind.add_argument("--segsum", action="store_true",
                      help="the gather transpose's variants")
    kind.add_argument("--neighbors", action="store_true",
                      help="the brute neighbor search's variants")
    kind.add_argument("--step-profile", metavar="TREE",
                      help="the gather transpose's kernels per training "
                      "backward, for the port in a checkout's root")
    ap.add_argument("--parent", help="another version of the source to time")
    ap.add_argument("--variants", help="comma-separated names: build and "
                    "time only these (and --parent)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    if args.step_profile:
        sys.path.insert(0, str(Path(args.step_profile).resolve()))
        print(card_line(), flush=True)
        return main_step_profile(args.step_profile)
    import torch
    import torch.nn.functional as F

    from regtr_tpu_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(card_line(), flush=True)
    t0 = time.perf_counter()
    kind = ("fwd" if args.forward else "gather" if args.gather else "rows"
            if args.rows else "segsum" if args.segsum else "neighbors"
            if args.neighbors else "bwd")
    libs = build(args.parent, kind,
                 args.variants.split(",") if args.variants else None)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if args.forward:
        return main_forward(libs)
    if args.gather:
        return main_gather(libs)
    if args.rows:
        return main_rows(libs)
    if args.segsum:
        return main_segsum(libs)
    if args.neighbors:
        return main_neighbors(libs)
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
