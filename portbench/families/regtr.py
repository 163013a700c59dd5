"""RegTR (the program's `regtr.RegTR`): its plain reference, the outputs
the check compares, the forward's stages, its work counts and its faults.

The check compares, over every pool batch, the outputs of that batch's
latest run in the window (the forward is deterministic, so these are every
distinct answer the window gave) with the reference's:
  kp_gap       coarse keypoints, max |difference| (inf if a mask differs)
  corr_gap     predicted correspondences (last layer), max |difference|
  overlap_gap  overlap scores (sigmoid), max |difference|
  pose_gap     the poses' 3x4 entries, max |difference|

The neighbour search is the measured package's stated semantics (the
selection on the bf16 rounding of the fp32 distance, the radius widened
by 0.4 %; reference/pyramid.py), not an exact radius search:
neighbor_dropped shows the check sees a list one entry short.

Work counts (counts.py's kinds), on the reference's pyramid of the same
points, never on the program's own tensors:
  * k6: the ten radius searches (counts.search_work);
  * k1, k23: self- and cross-attention of every encoder layer at the
    coarse level (counts.attention_work);
  * forward: KPConv as the reference formulates it (the kernel-point
    weighting, 2 P Cin per valid neighbor, then the P Cin x Cout product,
    2 P Cin Cout per valid query), every linear layer at the valid points,
    attention as above, the head on all layers' outputs;
  * train: the forward and the losses' products, the backward at 2x.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..counts import add, attention_work, search_work
from ..reference import pyramid as ref_pyramid
from ..reference.model import RegTR as Reference


def parameter_shapes(cfg, n0) -> dict:
    """{name: shape} of the program's model, read on the meta device."""
    from regtr_tpu_torch.models import get_model
    from regtr_tpu_torch.ops.pyramid import make_pyramid_spec

    with torch.device("meta"):
        model = get_model(cfg["model"])(cfg, make_pyramid_spec(cfg, n0))
    return {n: tuple(t.shape) for n, t in model.state_dict().items()}


def weight_rule(name: str, shape):
    """Each leaf's stream and finish (weights.draw):
      * InfoNCE's W: normal with stddev 0.1;
      * a KPConv weight (P, Cin, Cout): uniform in +-1 / sqrt(P Cin);
      * a 2-D weight (out, in): normal with stddev 1 / sqrt(in) (lecun);
      * every bias: zero; a LayerNorm's scale: one."""
    if name.endswith(".W"):
        return "normal", lambda x: x * 0.1
    if len(shape) == 3:
        bound = 1.0 / math.sqrt(shape[0] * shape[1])
        return "uniform", lambda x: (x * 2.0 - 1.0) * bound
    if len(shape) == 2:
        return "normal", lambda x: x / math.sqrt(shape[1])
    if name.endswith(".bias"):
        return None, torch.zeros_like
    if len(shape) == 1 and "norm" in name.rsplit(".", 2)[-2]:
        return None, torch.ones_like
    raise ValueError(f"no weight rule for {name} {tuple(shape)}")


def keep(out) -> dict:
    """The last layer's poses on the host (a batch's clock stops there),
    and the coarse keypoints, correspondences and overlap logits."""
    return {"pose": out["pose"][-1].cpu(), "kp": out["kp"],
            "kp_mask": out["kp_mask"], "corr": out["corr"][-1],
            "overlap": out["overlap_logits"][-1]}


def failed(kept) -> bool:
    return not bool(torch.isfinite(kept["pose"]).all())


def reference_forward(model, points, mask) -> dict:
    r = model(points, mask)
    return {"pose": r["pose"][-1].cpu(), "kp": r["kp"].cpu(),
            "kp_mask": r["kp_mask"].cpu(), "corr": r["corr"][-1].cpu(),
            "overlap": r["overlap_logits"][-1].cpu()}


def forward_gaps(got: dict, ref: dict) -> dict:
    gaps = {"kp_gap": 0.0, "corr_gap": 0.0, "overlap_gap": 0.0,
            "pose_gap": 0.0}
    for i, r in ref.items():
        g = got.get(i)
        if g is None or not torch.equal(g["kp_mask"], r["kp_mask"]):
            return {k: float("inf") for k in gaps}
        m = r["kp_mask"]

        def gap(a, b):
            d = (a.double() - b.double()).abs()
            return float(d[m].max()) if bool(m.any()) else 0.0

        upd = {"kp_gap": gap(g["kp"], r["kp"]),
               "corr_gap": gap(g["corr"], r["corr"]),
               "overlap_gap": gap(torch.sigmoid(g["overlap"].double()),
                                  torch.sigmoid(r["overlap"].double())),
               "pose_gap": float((g["pose"].double()
                                  - r["pose"].double()).abs().max())}
        for k, v in upd.items():
            gaps[k] = max(gaps[k], v if v == v else float("inf"))
    return gaps


def stages(model, points, mask, timed):
    """pyramid, backbone, transformer, head_pose."""
    levels = timed("pyramid", model.preprocess, points, mask)
    feats, pe = timed("backbone", model.encode, levels)
    cond = timed("transformer", model.condition, feats, pe, levels[-1].mask)
    timed("head_pose", model.head_and_pose, cond, levels[-1].points,
          levels[-1].mask, pe)


def reference_losses(model, batch) -> dict:
    levels = model.pyramid(batch["points"], batch["mask"])
    losses, _ = model.losses(levels, batch["pose"], batch["overlap0"])
    return losses


def pool_counts(cfg, pool, device):
    """batch_counts of each pool batch, on the reference's pyramid of its
    points."""
    spec = ref_pyramid.make_spec(cfg, pool[0]["points"].shape[1])
    out = []
    with torch.no_grad():
        for batch in pool:
            levels = ref_pyramid.build(
                torch.from_numpy(batch["points"]).to(device),
                torch.from_numpy(batch["mask"]).to(device), spec)
            out.append(batch_counts(cfg, levels, spec,
                                    ref_pyramid.pairs_within))
            del levels
    return out


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
            add(k6, search_work(nqv, nqs, nsv, nss, k, pairs_within(
                q.points, q.mask, s.points, s.mask, rad)))

    d, heads = cfg["d_embed"], cfg["nhead"]
    layers = cfg["num_encoder_layers"]
    coarse = n_valid[-1]
    k1, k23 = {}, {}
    for _ in range(layers):
        for cross in (False, True):
            add(k1, attention_work(coarse, d, heads, cross))
            add(k23, attention_work(coarse, d, heads, cross, backward=True))

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


def answer_altered(cell):
    """The poses' translations moved by 1 cm where the head solves them."""
    model = cell.model
    head_and_pose = model.head_and_pose

    def altered(*args):
        corr, logits, pose = head_and_pose(*args)
        return corr, logits, pose + torch.tensor(
            [0.0, 0.0, 0.0, 0.01], device=pose.device)

    model.head_and_pose = altered
    return cell


def half_batch(cell):
    """The forward runs the first half of the pairs and repeats its
    outputs."""
    forward = cell.forward

    def halved(points, mask):
        half = points.shape[0] // 4 * 2
        out = forward(points[:half], mask[:half])
        rep = {"pose": 1, "kp": 0, "kp_mask": 0, "corr": 1,
               "overlap_logits": 1}
        return {k: torch.cat([out[k], out[k]], dim=d)
                for k, d in rep.items()}

    cell.forward = halved
    return cell


def neighbor_dropped(cell):
    """The neighbour search leaves out a support it should keep: every
    neighbour list of the pyramid loses its farthest entry (a list of one
    keeps it), as a search with a K one short or a coarser selection key
    would."""
    model = cell.model
    preprocess = model.preprocess

    def dropped(points, mask):
        levels = preprocess(points, mask)
        out = []
        for level in levels:
            nbr = level.neighbors
            shadow = level.points.shape[1]
            count = (nbr < shadow).sum(-1, keepdim=True)
            last = (torch.arange(nbr.shape[-1], device=nbr.device)
                    == count - 1) & (count > 1)
            out.append(dataclasses.replace(
                level, neighbors=torch.where(last, shadow, nbr)))
        return out

    model.preprocess = dropped
    return cell


FAULTS = {"neighbor_dropped": neighbor_dropped}
