"""GeoTransformer (the program's `geotransformer.GeoTransformer`): its
plain reference, the outputs the check compares, the forward's stages,
its work counts and its faults.

The model makes discrete choices (the nodes' patches, the top node pairs,
the mutual top-k correspondences over a threshold, the best hypothesis,
the inliers of each refinement solve), which random weights leave close
to ties, so that rounding alone may tip them.  So the check follows the
program's choices and asks of each whether it is right under the
reference's own numbers: the reference recomputes each later stage on
the program's choices, and a choice that differs from the reference's
counts only by how far it lies from its cut.  Over every pool batch, the
outputs of its latest run in the window against the reference's:
  kp_gap            coarse and level-1 points, max |difference|; inf if
                    a mask or a patch differs (the partition is computed
                    on the same bits on both sides)
  coarse_feat_gap   the transformer's L2-normalised features at valid
                    superpoints, max |difference| (a vector's length)
  fine_feat_gap     level-1 features at valid points, max |difference|
                    over the RMS length of the reference's
  node_choice_gap   how far below the reference's k-th dual-normalised
                    score the lowest of the program's chosen node pairs
                    lies, relative; 0 when the sets agree or differ in ties
  ot_gap            the transport's log scores on the program's node
                    pairs, recomputed by the reference on the same pairs,
                    max |difference| over the patches' valid entries
  corr_choice_gap   each correspondence in one set and not the other:
                    how far, relative, it lies from the cut that decides
                    it (the k-th or (k+1)-th of its row or column, or the
                    threshold); inf where a mask would decide it
  hypothesis_gap    inlier decisions that rounding cannot explain, in
                    correspondences: the reference's largest inlier count
                    of a hypothesis (residuals below 0.1 m less
                    ROUNDING_M) over its count of the program's best
                    (below 0.1 m plus ROUNDING_M), and each refinement
                    mask's entries that differ from the reference's
                    residuals by more than ROUNDING_M from the radius
  pose_gap          the poses' 3x4 entries against the reference's
                    registration run from the program's correspondences,
                    best hypothesis and inlier masks, max |difference|

Work counts (counts.py's kinds), on the reference's pyramid of the same
points:
  * k6: the pyramid's ten radius searches, as RegTR's family counts them
    (the same pyramid: counts.search_work over the pairs within each
    radius);
  * k1: the cross-attention of the three cross blocks at the valid
    superpoints (counts.attention_work, d 256, 4 heads);
  * forward: KPConv as the reference formulates it and every linear
    layer at the valid points, the embedding's projections over every
    valid pair, the self-attention's products with the geometric term,
    the cross-attention (k1), the node scores, the patch scores, the
    Sinkhorn iterations (4 operations and one exponential an entry of
    each log-sum-exp) and the hypotheses' residuals.
"""
from __future__ import annotations

import math

import torch

from ..counts import add, attention_work, search_work
from ..reference import geotransformer as ref_geo
from ..reference import pyramid as ref_pyramid
from ..reference.geotransformer import GeoTransformer as Reference
from .regtr import neighbor_dropped, parameter_shapes  # noqa: F401

ROUNDING_M = 1e-3     # residuals this near the acceptance radius may fall
                      # either way between the program and the reference
GAPS = ("kp_gap", "coarse_feat_gap", "fine_feat_gap", "node_choice_gap",
        "ot_gap", "corr_choice_gap", "hypothesis_gap", "pose_gap")
KEPT = ("kp", "kp_mask", "fine_points", "fine_mask", "feats_c", "feats_f",
        "node_ref", "node_src", "node_valid", "ot", "corr", "best",
        "inliers")


def weight_rule(name: str, shape):
    """Each leaf's stream and finish (weights.draw):
      * the transport's 0-D alpha: one (upstream's initial value);
      * a KPConv weight (P, Cin, Cout): uniform in +-1 / sqrt(P Cin);
      * a 2-D weight (out, in): normal with stddev 1 / sqrt(in) (lecun);
      * every bias: zero; a GroupNorm's or LayerNorm's scale: one."""
    if len(shape) == 0:
        return None, torch.ones_like
    if len(shape) == 3:
        bound = 1.0 / math.sqrt(shape[0] * shape[1])
        return "uniform", lambda x: (x * 2.0 - 1.0) * bound
    if len(shape) == 2:
        return "normal", lambda x: x / math.sqrt(shape[1])
    if name.endswith(".bias"):
        return None, torch.zeros_like
    if len(shape) == 1 and name.endswith(".weight"):
        return None, torch.ones_like
    raise ValueError(f"no weight rule for {name} {tuple(shape)}")


def keep(out) -> dict:
    """The poses on the host (a batch's clock stops there), and on the
    device what the check compares: the points, features, patches (-1 at
    empty slots), node pairs, transport scores, correspondences, best
    hypothesis and inlier masks."""
    kept = {k: out[k] for k in KEPT}
    kept["patches"] = torch.where(out["patch_mask"], out["patches"], -1)
    kept["pose"] = out["pose"].cpu()
    return kept


def failed(kept) -> bool:
    return not bool(torch.isfinite(kept["pose"]).all())


def reference_forward(model, points, mask) -> dict:
    return model(points, mask)


def _device():
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def forward_gaps(got: dict, ref: dict) -> dict:
    gaps = dict.fromkeys(GAPS, 0.0)
    for i, r in ref.items():
        g = _at_extent(got.get(i), r["feats_c"].shape[1])
        if g is None or not _same_layout(g, r):
            return dict.fromkeys(GAPS, float("inf"))
        with torch.no_grad():
            upd = batch_gaps({k: v.to(_device()) if torch.is_tensor(v)
                              else v for k, v in g.items()},
                             {k: v.to(_device()) if torch.is_tensor(v)
                              else v for k, v in r.items()})
        for k, v in upd.items():
            gaps[k] = max(gaps[k], v if v == v else float("inf"))
    return gaps


def _at_extent(g, m):
    """The program's outputs at the reference's extent of superpoints, m
    (the largest valid count): the program may run at a larger one, whose
    rows past m hold no node."""
    if g is None or g["feats_c"].shape[1] < m or bool(
            (g["patches"][:, m:] >= 0).any()):
        return None
    return dict(g, feats_c=g["feats_c"][:, :m], patches=g["patches"][:, :m])


def _same_layout(g, r) -> bool:
    return all(g[k].shape == r[k].shape for k in KEPT + ("patches", "pose")) \
        and all(torch.equal(g[k], r[k]) for k in ("kp_mask", "fine_mask",
                                                  "patches"))


def _vec_gap(a, b, mask):
    d = torch.linalg.vector_norm(a.double() - b.double(), dim=-1)
    return float(d[mask].max()) if bool(mask.any()) else 0.0


def batch_gaps(g, r) -> dict:
    s = r["settings"]
    m = g["feats_c"].shape[1]

    def pts_gap(key, mkey):
        d = (g[key].double() - r[key].double()).abs().amax(-1)
        return float(d[r[mkey]].max()) if bool(r[mkey].any()) else 0.0

    c_mask, f_mask = r["kp_mask"][:, :m], r["fine_mask"]
    rms = float(torch.linalg.vector_norm(r["feats_f"].double(), dim=-1)[
        f_mask].pow(2).mean().sqrt()) if bool(f_mask.any()) else 1.0
    out = {"kp_gap": max(pts_gap("kp", "kp_mask"),
                         pts_gap("fine_points", "fine_mask")),
           "coarse_feat_gap": _vec_gap(g["feats_c"], r["feats_c"], c_mask),
           "fine_feat_gap": _vec_gap(g["feats_f"], r["feats_f"], f_mask)
           / max(rms, 1e-30)}
    pair = dict.fromkeys(GAPS[3:], 0.0)
    for b in range(r["pose"].shape[0]):
        for k, v in pair_gaps(g, r, b, s).items():
            pair[k] = max(pair[k], v)
    out.update(pair)
    return out


def pair_gaps(g, r, b, s) -> dict:
    """The gaps of pair b's choices, each stage on the program's choices
    of the stages before it."""
    inf = float("inf")
    bad = dict.fromkeys(GAPS[3:], inf)
    dual = r["dual"][b]
    n_valid = int((dual >= 0).sum())
    pv = g["node_valid"][b]
    k_nodes = min(s["correspondences"], n_valid)
    if int(pv.sum()) != k_nodes or not bool(pv[:k_nodes].all()):
        return bad
    nr, ns = g["node_ref"][b][pv], g["node_src"][b][pv]
    chosen = dual[nr, ns]
    keys = nr * dual.shape[1] + ns
    if bool((chosen < 0).any()) or keys.unique().numel() != keys.numel():
        return bad
    kth = dual.flatten().topk(k_nodes).values[-1]
    out = {"node_choice_gap": max(0.0, float((kth - chosen.min()) / kth))}

    # the transport on the program's node pairs
    n1 = r["feats_f"].shape[1]
    patches = {}
    for side, slot in (("ref", 2 * b + 1), ("src", 2 * b)):
        knn = r["patches"][slot]
        patches[side] = (r["feats_f"][slot], r["fine_points"][slot],
                         torch.where(knn >= 0, knn, n1), knn >= 0)
    (rf, rp, rk, rm), (sf, sp, sk, sm) = patches["ref"], patches["src"]
    k = s["patch"]
    ot = ref_geo.transport(rf, sf, rk, sk, rm, sm, nr, ns,
                           r["alpha"].to(rf.device), s)[:, :k, :k]
    valid = rm[nr][:, :, None] & sm[ns][:, None, :]
    got_ot = g["ot"][b][pv]
    out["ot_gap"] = float((got_ot.double() - ot.double()).abs()[valid].max()) \
        if bool(valid.any()) else 0.0

    # the correspondences on the reference's scores
    p = torch.exp(ot)
    corr_ref = ref_geo.correspondence_matrix(p, rm[nr], sm[ns], s["topk"],
                                             s["threshold"])
    corr = g["corr"][b][pv]
    if bool((g["corr"][b][~pv]).any()) or bool((corr & ~valid).any()):
        return dict(bad, **out)
    out["corr_choice_gap"] = _corr_choice_gap(p, corr, corr_ref, valid, s)

    # the hypotheses and the refinement on the program's correspondences
    ref_kp = torch.cat([rp, rp.new_zeros(1, 3)])[rk[nr]]
    src_kp = torch.cat([sp, sp.new_zeros(1, 3)])[sk[ns]]
    out.update(_registration_gaps(g, b, s, p * corr, corr, ref_kp, src_kp))
    return out


def _corr_choice_gap(p, corr, corr_ref, valid, s) -> float:
    differ = corr != corr_ref
    if not bool(differ.any()):
        return 0.0
    kk = s["topk"]

    def margins(dim):
        """Signed relative margin of each entry from its rank cut along
        `dim`: in the top k, above the (k+1)-th; else below the k-th."""
        vals = p.topk(min(kk + 1, p.shape[dim]), dim=dim).values
        kth = vals.select(dim, kk - 1).unsqueeze(dim)
        nxt = (vals.select(dim, kk).unsqueeze(dim) if vals.shape[dim] > kk
               else torch.zeros_like(kth))
        return torch.where(p >= kth, p - nxt, p - kth) / p.clamp_min(1e-30)

    crit = torch.stack([margins(2), margins(1),
                        (p - s["threshold"]) / s["threshold"]])
    in_ref = corr_ref[differ]
    c = crit[:, differ]
    # in the reference's set: its smallest margin; in the program's alone:
    # the largest by which a criterion it fails would have to move
    gap = torch.where(in_ref, c.amin(0), (-c).clamp_min(0.0).amax(0))
    gap = torch.where(valid[differ], gap, float("inf"))
    return float(gap.max())


def _registration_gaps(g, b, s, w, corr, ref_kp, src_kp) -> dict:
    radius, steps = s["radius"], s["steps"]
    pi, ri, ci = torch.nonzero(corr, as_tuple=True)
    ref_c, src_c, sc = ref_kp[pi, ri], src_kp[pi, ci], w[pi, ri, ci]
    n = pi.shape[0]
    masks = g["inliers"][b]
    best = int(g["best"][b])
    counts = corr.sum((1, 2))
    has = counts >= s["corr_threshold"]
    inf = float("inf")
    if bool(masks[:, n:].any()):
        return {"hypothesis_gap": inf, "pose_gap": inf}
    gap = 0.0
    if bool(has.any()):
        if best < 0 or best >= has.shape[0] or not bool(has[best]):
            return {"hypothesis_gap": inf, "pose_gap": inf}
        hyps = torch.stack([ref_geo.weighted_procrustes(
            src_c[None, pi == h], ref_c[None, pi == h], sc[None, pi == h])[0]
            for h in torch.nonzero(has, as_tuple=True)[0].tolist()])
        res = ref_geo.residuals(hyps, src_c, ref_c)
        lo = (res < radius - ROUNDING_M).sum(1)
        hi = (res < radius + ROUNDING_M).sum(1)
        at = int(torch.nonzero(has, as_tuple=True)[0].tolist().index(best))
        gap = max(0.0, float(lo.max() - hi[at]))
        pose = hyps[at]
    elif best != -1:
        return {"hypothesis_gap": inf, "pose_gap": inf}
    else:
        pose = ref_geo.weighted_procrustes(src_c[None], ref_c[None],
                                           sc[None])[0]
    for step in range(steps):
        res = ref_geo.residuals(pose, src_c, ref_c)
        mask = masks[step, :n]
        unexplained = (mask != (res < radius)) & (
            (res - radius).abs() > ROUNDING_M)
        gap = max(gap, float(unexplained.sum()))
        pose = ref_geo.weighted_procrustes(src_c[None], ref_c[None],
                                           (sc * mask)[None])[0]
    return {"hypothesis_gap": gap, "pose_gap": float(
        (g["pose"][b].double() - pose.double()).abs().max())}


def stages(model, points, mask, timed):
    """pyramid, backbone, embedding, transformer, coarse_matching,
    optimal_transport, registration."""
    levels = timed("pyramid", model.preprocess, points, mask)
    feats_c, feats_f = timed("backbone", model.encode, levels)
    m, emb = timed("embedding", model.embed, levels[-1])
    feats = timed("transformer", model.condition, feats_c, emb, levels[-1],
                  m)
    del emb
    match = timed("coarse_matching", model.match_coarse, feats, levels[1],
                  levels[-1], m)
    ot = timed("optimal_transport", model.transport, feats_f, match)
    timed("registration", model.register, levels[1], match, ot)


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
            out.append(batch_counts(cfg, levels, spec))
            del levels
    return out


def search_counts(levels, spec) -> dict:
    """K6's work over the pyramid: each level's neighbor search, and
    between each level and the next the pool (the next level's points in
    this level's radius) and the upsample (this level's in twice it)."""
    n_valid = [float(lvl.mask.sum()) for lvl in levels]
    slots = [lvl.mask.numel() for lvl in levels]
    k6 = {}
    for li, lvl in enumerate(levels):
        r, k = spec.radii[li], spec.ks[li]
        searches = [(lvl, li, lvl, li, r)]
        if li + 1 < len(levels):
            searches += [(levels[li + 1], li + 1, lvl, li, r),
                         (lvl, li, levels[li + 1], li + 1, 2.0 * r)]
        for q, qi, s, si, rad in searches:
            add(k6, search_work(n_valid[qi], slots[qi], n_valid[si],
                                slots[si], k, ref_pyramid.pairs_within(
                                    q.points, q.mask, s.points, s.mask,
                                    rad)))
    return k6


def batch_counts(cfg, levels, spec) -> dict:
    """The work of one batch on the reference's `levels` (built by
    `spec`): {'k6', 'k1', 'forward'}, each a dict of flops / bytes /
    exps."""
    n = [[int(x) for x in lvl.mask.sum(1).tolist()] for lvl in levels]
    nv = [float(sum(x)) for x in n]
    p = cfg["num_kernel_points"]
    d0 = cfg["init_dim"]
    flops = 0.0
    for name, cin, cout, level, strided in ref_geo.Backbone.PLAN:
        lvl = levels[level]
        table = lvl.pools if strided else lvl.neighbors
        entries = float((table < lvl.points.shape[1]).sum())
        q = nv[level + int(strided)]
        cin = cfg["in_feats_dim"] if name == "encoder1_1" else cin * d0
        cout *= d0
        if name == "encoder1_1":
            flops += 2 * entries * p * cin + 2 * q * p * cin * cout
            continue
        mid = cout // 4
        if cin != mid:
            flops += 2 * nv[level] * cin * mid
        flops += 2 * entries * p * mid + 2 * q * p * mid * mid
        flops += 2 * q * mid * cout
        if cin != cout:
            flops += 2 * q * cin * cout
    flops += 2 * nv[2] * 24 * d0 * 8 * d0 + 2 * nv[1] * 12 * d0 \
        * cfg["output_dim"]

    d, heads = cfg["geo_hidden_dim"], cfg["geo_num_heads"]
    coarse = n[3]
    sq = float(sum(c * c for c in coarse))
    k1, fwd = {}, {"flops": flops, "exps": 0.0}
    fwd["flops"] += 2 * nv[3] * cfg["geo_input_dim"] * d \
        + 2 * nv[3] * d * cfg["geo_output_dim"]
    fwd["flops"] += (1 + cfg["geo_angle_k"]) * 2 * sq * d * d
    for block in cfg["geo_blocks"]:
        fwd["flops"] += 4 * 2 * nv[3] * d * d + 2 * 2 * nv[3] * d * 2 * d
        if block == "self":
            fwd["flops"] += 2 * sq * d * d + 3 * 2 * sq * d
            fwd["exps"] += heads * sq
        else:
            add(k1, attention_work(coarse, d, heads, True))
    add(fwd, k1)
    pairs = len(coarse) // 2
    kk = cfg["num_points_in_patch"]
    corr = cfg["num_correspondences"]
    fwd["flops"] += sum(2.0 * coarse[2 * i] * coarse[2 * i + 1] * d
                        for i in range(pairs))
    fwd["flops"] += pairs * corr * 2.0 * kk * kk * cfg["output_dim"]
    lse = pairs * corr * (kk + 1) ** 2 * 2 * cfg["num_sinkhorn_iterations"]
    fwd["flops"] += 4.0 * lse
    fwd["exps"] += lse
    cap = corr * kk * cfg["fine_topk"]
    fwd["flops"] += pairs * (corr + cfg["fine_num_refinement_steps"]) \
        * cap * 20.0
    return {"k6": search_counts(levels, spec), "k1": k1, "forward": fwd}


def answer_altered(cell):
    """The poses' translations moved by 1 cm where the registration
    solves them."""
    model = cell.model
    register = model.register

    def altered(*args):
        out = register(*args)
        out["pose"] = out["pose"] + torch.tensor(
            [0.0, 0.0, 0.0, 0.01], device=out["pose"].device)
        return out

    model.register = altered
    return cell


def half_batch(cell):
    """The forward runs the first half of the pairs and repeats its
    outputs."""
    forward = cell.forward

    def halved(points, mask):
        half = points.shape[0] // 4 * 2
        out = forward(points[:half], mask[:half])
        return {k: torch.cat([v, v]) for k, v in out.items()
                if torch.is_tensor(v)}

    cell.forward = halved
    return cell


FAULTS = {"neighbor_dropped": neighbor_dropped}
