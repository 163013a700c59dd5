"""The work that the kernels shared by model families need, counted from
the shapes and valid counts of their inputs, and the card's peaks: what
the rooflines and `mfu` divide.  A family (families/<family>.py
`pool_counts`) counts each pool batch with these, on its reference's
tensors, never on the program's own, so that the numbers do not depend on
how the program computes them:
  * a radius search (K6): 12 bytes a valid point and 1 mask byte a slot
    read once, queries and supports, a 4-byte entry per valid query and
    neighbor slot written once; 8 fp32 operations per (query, support)
    pair within the radius;
  * attention (K1 forward, K2/K3 backward): q, k, v and o read or written
    once (the backward also do, lse, dq, dk, dv) at the valid rows; 4 d
    operations per (query, key) pair forward, 8 d backward (2x the
    forward's products); one exponential per pair forward.
"""
from __future__ import annotations

import subprocess

# NVIDIA's H100 SXM data sheet, dense: TF32 is the fastest route for fp32
# operands, bf16 the fastest for bf16; HBM3 bandwidth; MUFU throughput.
PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
SMS = 132
EXP_PER_SM_CLOCK = 16


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock from nvidia-smi, in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits", "--id=0"], capture_output=True, text=True, check=True,
        timeout=60).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def peaks(dtype: str, sm_clock_hz: float) -> dict:
    return {"flops": PEAK_FLOPS[dtype], "bytes": PEAK_BYTES,
            "exps": SMS * EXP_PER_SM_CLOCK * sm_clock_hz}


def bound_s(work: dict, peak: dict) -> float:
    """The least time the card could take for `work`: the largest of its
    parts, each over its peak."""
    return max(work.get(k, 0.0) / peak[k] for k in ("flops", "bytes", "exps"))


def add(total: dict, part: dict) -> dict:
    """Adds each kind of `part`'s work to `total`'s."""
    for k, v in part.items():
        total[k] = total.get(k, 0.0) + v
    return total


def search_work(nq_valid, nq_slots, ns_valid, ns_slots, k, pairs) -> dict:
    """One radius search over the batch (sums over its clouds)."""
    return {"bytes": 12.0 * (nq_valid + ns_valid) + nq_slots + ns_slots
            + 4.0 * k * nq_valid,
            "flops": 8.0 * pairs}


def attention_pairs(n_valid, cross: bool) -> float:
    """Sum over the clouds of (valid queries) x (valid keys): keys of the
    same cloud, or of the partner (clouds interleaved in pairs)."""
    total = 0.0
    for i, nq in enumerate(n_valid):
        nk = n_valid[i ^ 1] if cross else nq
        total += float(nq) * float(nk)
    return total


def attention_work(n_valid, d, heads, cross, backward=False) -> dict:
    pairs = attention_pairs(n_valid, cross)
    rows_q = float(sum(n_valid))     # a cross call's keys are the partners'
    if backward:                     # q, o, do, dq; k, v, dk, dv; lse
        return {"bytes": 4.0 * d * 8 * rows_q + 4.0 * heads * rows_q,
                "flops": 8.0 * d * pairs}
    return {"bytes": 4.0 * d * 4 * rows_q, "flops": 4.0 * d * pairs,
            "exps": heads * pairs}
