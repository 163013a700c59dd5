"""The work that one batch needs, counted from the shapes and valid counts of
its inputs, and the card's peaks: what the rooflines and `mfu` divide.

Counted on the reference's pyramid of the same points (reference/
pyramid.py), never on the program's own tensors, so that the numbers do not
depend on how the program computes them:
  * the radius searches (K6): 12 bytes a valid point and 1 mask byte a
    slot read once, queries and supports, a 4-byte entry per valid query
    and neighbor slot written once; 8 fp32 operations per (query, support)
    pair within the radius;
  * attention (K1 forward, K2/K3 backward): q, k, v and o read or written
    once (the backward also do, lse, dq, dk, dv) at the valid rows; 4 d
    operations per (query, key) pair forward, 8 d backward (2x the
    forward's products); one exponential per pair forward;
  * the model step: KPConv as the reference formulates it (the kernel-point
    weighting, 2 P Cin per valid neighbor, then the P Cin x Cout product,
    2 P Cin Cout per valid query), every linear layer at the valid points,
    attention as above, the head on all layers' outputs; a training step
    adds the losses' products and counts the backward at 2x the forward.
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


def _add(total: dict, part: dict) -> dict:
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


def batch_counts(cfg, levels, spec, pairs_within) -> dict:
    """The work of one batch on the reference's `levels`: {'k6', 'k1',
    'k23', 'forward', 'train'}, each a dict of flops / bytes / exps.
    `pairs_within(q, qm, s, sm, r)` counts pairs within a radius."""
    n_valid = [[int(x) for x in lvl.mask.sum(1).tolist()] for lvl in levels]
    slots = [lvl.mask.shape[0] * lvl.mask.shape[1] for lvl in levels]
    k6 = {}
    for li, lvl in enumerate(levels):
        r, k = spec.radii[li], spec.ks[li]
        nv = sum(n_valid[li])
        searches = [(lvl, lvl, r, nv, slots[li], nv, slots[li])]
        if li + 1 < len(levels):
            nxt = levels[li + 1]
            nn = sum(n_valid[li + 1])
            searches += [(nxt, lvl, r, nn, slots[li + 1], nv, slots[li]),
                         (lvl, nxt, 2.0 * r, nv, slots[li], nn,
                          slots[li + 1])]
        for q, s, rad, nqv, nqs, nsv, nss in searches:
            _add(k6, search_work(nqv, nqs, nsv, nss, k, pairs_within(
                q.points, q.mask, s.points, s.mask, rad)))

    d, heads = cfg["d_embed"], cfg["nhead"]
    layers = cfg["num_encoder_layers"]
    coarse = n_valid[-1]
    k1, k23 = {}, {}
    for _ in range(layers):
        for cross in (False, True):
            _add(k1, attention_work(coarse, d, heads, cross))
            _add(k23, attention_work(coarse, d, heads, cross, backward=True))

    fwd = {"flops": _backbone_flops(cfg, levels, n_valid)}
    n_c = float(sum(coarse))
    enc_out = _encoder_widths(cfg)[1]
    dff = cfg["d_feedforward"]
    linear = (2 * n_c * enc_out * d                       # feat_proj
              + layers * (8 * 2 * n_c * d * d             # q, k, v, out x2
                          + 2 * 2 * n_c * d * dff)        # the FFN
              + layers * (2 * 2 * n_c * d * d + 2 * n_c * d * 4))  # head
    fwd["flops"] += linear + k1["flops"]
    # the losses: InfoNCE's logits (anchor W, then against every positive)
    # for the conditioned and the unconditioned features
    loss = 0.0
    for i in range(0, len(coarse), 2):
        na, npos = float(coarse[i]), float(coarse[i + 1])
        loss += 2 * (2 * na * d * d + 2 * na * npos * d)
    return {"k6": k6, "k1": k1, "k23": k23, "forward": fwd,
            "train": {"flops": 3.0 * (fwd["flops"] + loss)}}


def _encoder_widths(cfg):
    """(name, in_dim, out_dim, level) of each encoder block, and the
    encoder's output width."""
    in_dim, out_dim, level, blocks = (cfg["in_feats_dim"],
                                      cfg["first_feats_dim"], 0, [])
    for name in cfg["architecture"]:
        blocks.append((name, in_dim, out_dim, level))
        in_dim = out_dim // 2 if "simple" in name else out_dim
        if "strided" in name:
            level += 1
            out_dim *= 2
    return blocks, in_dim


def _backbone_flops(cfg, levels, n_valid) -> float:
    p = cfg["num_kernel_points"]
    flops = 0.0
    for name, cin, cout, li in _encoder_widths(cfg)[0]:
        lvl = levels[li]
        if "strided" in name:
            q_valid = float(sum(n_valid[li + 1]))
            table = lvl.pools
        else:
            q_valid = float(sum(n_valid[li]))
            table = lvl.neighbors
        entries = float((table < lvl.points.shape[1]).sum())
        n_in = float(sum(n_valid[li]))
        if "simple" in name:
            c_in, c_out = cin, cout // 2
            flops += 2 * entries * p * c_in + 2 * q_valid * p * c_in * c_out
            continue
        mid = cout // 4
        if cin != mid:
            flops += 2 * n_in * cin * mid                      # unary1
        flops += 2 * entries * p * mid + 2 * q_valid * p * mid * mid
        flops += 2 * q_valid * mid * cout                      # unary2
        if cin != cout:
            flops += 2 * q_valid * cin * cout                  # shortcut
    return flops
