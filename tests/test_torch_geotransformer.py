"""GeoTransformer in the port (models/geotransformer.py, nn/geotransformer.py,
nn/matching.py) against the benchmark's plain reference
(portbench/reference/geotransformer.py: one pair at a time in upstream's
stack mode, unpadded) on seeded random weights, on the CPU at a small
size: ~300 points a cloud, init_dim 8 with 4 groups, 16 node pairs, 8
points a patch, 100 Sinkhorn iterations.  Part by part, then the whole
forward through the harness's family (its gaps), a pair alone against
the same pair in a padded batch of two, the fixed-capacity compaction
against `torch.nonzero`, the degenerate branch of the registration, the
family's hooks, the spans and counters under a CPU profiler, and RegTR's
seeded draws unchanged by the new init rules."""
from __future__ import annotations

import hashlib

import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from portbench import cells, manifest, spans
from portbench import weights as weights_mod
from portbench.families import HOOKS
from portbench.families import geotransformer as family
from portbench.reference import geotransformer as ref_geo
from portbench.reference import pyramid as ref_pyramid
from portbench.traffic.generator import load_mix, make_pool
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.models import geotransformer as program
from regtr_tpu_torch.nn import geotransformer as geo_nn
from regtr_tpu_torch.nn import matching
from regtr_tpu_torch.ops import geo_embedding as geo_ops
from regtr_tpu_torch.ops.kpconv import GatherIndex, kpconv_fused_gather
from regtr_tpu_torch.train.steps import make_forward

CPU = torch.device("cpu")
SEED = 2 ** 31 + 77
TOL = 2e-5          # fp32 round-off between two orders of the same sums


def geo_config(**over):
    """geotr-3dmatch's configuration at a small width."""
    cfg = dict(manifest.load_config("geotr-3dmatch")["config"])
    cfg.update(buckets=[512], init_dim=8, output_dim=32, group_norm=4,
               geo_input_dim=128, geo_hidden_dim=32, geo_output_dim=32,
               num_correspondences=16, num_points_in_patch=8)
    cfg.update(over)
    return cfg


def pool_of(cfg, pairs=2, points=300, seed=SEED):
    mix = load_mix("rooms-4pairs")
    mix.update(pool_pairs=pairs, pairs_per_batch=pairs,
               points_per_scan=points)
    return make_pool(mix, cfg, seed)


@pytest.fixture(scope="module")
def setup():
    """The program and the reference on one set of drawn weights, one
    batch of two pairs, and each side's forward of it."""
    cfg = geo_config()
    pool = pool_of(cfg)
    n0 = pool[0]["points"].shape[1]
    w = weights_mod.draw(cells.parameter_shapes(cfg, n0), SEED, CPU)
    model = cells.build_model(cfg, n0, w, CPU)
    ref = ref_geo.GeoTransformer(cfg, n0)
    ref.load_state_dict(w)
    pts = torch.from_numpy(pool[0]["points"])
    mask = torch.from_numpy(pool[0]["mask"])
    out = make_forward(model)(pts, mask)
    with torch.no_grad():
        r = ref(pts, mask)
    return {"cfg": cfg, "model": model, "ref": ref, "w": w, "pool": pool,
            "pts": pts, "mask": mask, "out": out, "r": r}


def stacked(setup, i=0):
    ref = setup["ref"]
    with torch.no_grad():
        levels, ups = ref.pyramid(setup["pts"], setup["mask"])
    return levels, ref.stack(levels, ups, i)


# ---------------------------------------------------------------- parts ---

def test_kpconv_divides_by_neighbours_with_a_positive_feature_sum():
    """The legacy count: some neighbours' features sum to <= 0, so the
    divisor is below the valid count; the program's KPConv (fused gather,
    norm 'legacy') is the reference's."""
    g = torch.Generator().manual_seed(1)
    nq, ns, k, c, cout, p = 20, 30, 6, 4, 5, 15
    q = torch.rand(1, nq, 3, generator=g) * 0.1
    s = torch.rand(1, ns, 3, generator=g) * 0.1
    nbr = torch.randint(0, ns, (1, nq, k), generator=g)
    nbr[0, :5, 3:] = ns                         # shadow entries
    x = torch.randn(1, ns, c, generator=g)
    x[0, :10] = -x[0, :10].abs()                # feature sums <= 0
    cfg = geo_config()
    layer = ref_geo.KPConv(cfg, c, cout, 0.0625)
    with torch.no_grad():
        layer.weights.copy_(torch.randn(p, c, cout, generator=g))
        want = layer(x[0], q[0], s[0], nbr[0])
        got, _, _ = kpconv_fused_gather(
            q, s, GatherIndex(nbr, ns + 1), x, None, layer.kernel_points,
            layer.weights, layer.sigma, norm="legacy")
    positive = (torch.cat([x[0], torch.zeros(1, c)])[nbr[0]].sum(-1) > 0)
    assert bool((positive.sum(-1) < (nbr[0] < ns).sum(-1)).any())
    torch.testing.assert_close(got[0], want, atol=TOL, rtol=TOL)


def test_group_norm_takes_statistics_over_the_pair():
    """PairGroupNorm on two padded clouds is torch's GroupNorm on their
    stacked valid points, and differs from per-cloud statistics."""
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 50, 8, generator=g) * 3 + 1
    x[1] += 2.0
    mask = torch.zeros(2, 50, dtype=torch.bool)
    mask[0, :40], mask[1, :27] = True, True
    norm = geo_nn.PairGroupNorm(4, 8)
    ref = ref_geo.GroupNorm(4, 8)
    with torch.no_grad():
        for p in (norm, ref):
            p.weight.copy_(torch.linspace(0.5, 2, 8))
            p.bias.copy_(torch.linspace(-1, 1, 8))
        got = norm(x, mask)
        want = ref(torch.cat([x[0, :40], x[1, :27]]))
    torch.testing.assert_close(torch.cat([got[0, :40], got[1, :27]]), want,
                               atol=TOL, rtol=TOL)
    assert bool((got[~mask] == 0).all())
    alone = ref(x[0, :40])
    assert not torch.allclose(got[0, :40], alone, atol=1e-3)


def test_backbone_and_upsampling_decoder_match_stack_mode(setup):
    """Level 3's and level 1's features (the decoder's nearest upsampling
    and concatenation) of pair 0 against the reference's stack mode."""
    model, ref = setup["model"], setup["ref"]
    levels, st = stacked(setup)
    with torch.no_grad():
        feats = torch.ones(st["pts"][0].shape[0], 1)
        want_c, want_f = ref.backbone(feats, st["pts"], st["nbrs"],
                                      st["subs"], st["ups"])
    with torch.inference_mode():
        got_c, got_f = model.encode(model.preprocess(setup["pts"],
                                                     setup["mask"]))
    for got, want, level in ((got_c, want_c, 3), (got_f, want_f, 1)):
        n_t, n_s = st["lens"][level]
        torch.testing.assert_close(
            torch.cat([got[1, :n_t], got[0, :n_s]]), want, atol=1e-4,
            rtol=1e-4)


def test_sinusoidal_embedding_interleaves_sin_and_cos():
    x = torch.tensor([0.0, 0.7, 3.1])
    emb = geo_ops.sinusoidal_embedding(x, 8)
    div = torch.exp(torch.arange(0, 8, 2).float() * (-torch.log(
        torch.tensor(1e4)) / 8))
    torch.testing.assert_close(emb[:, 0::2], torch.sin(x[:, None] * div))
    torch.testing.assert_close(emb[:, 1::2], torch.cos(x[:, None] * div))
    torch.testing.assert_close(emb, ref_geo.sinusoidal_embedding(x, 8))


def test_embedding_takes_the_max_over_the_angle_neighbours(setup):
    """The batched, masked embedding of two padded clouds is the
    reference's per cloud; its angle term is the max over the 3 nearest
    other superpoints (not their mean)."""
    model, ref = setup["model"], setup["ref"]
    g = torch.Generator().manual_seed(3)
    pts = torch.rand(2, 12, 3, generator=g)
    mask = torch.zeros(2, 12, dtype=torch.bool)
    mask[0, :12], mask[1, :9] = True, True
    with torch.no_grad():
        got = model.transformer.embedding(pts, mask)
        for c, n in ((0, 12), (1, 9)):
            torch.testing.assert_close(got[c, :n, :n],
                                       ref.transformer.embedding(pts[c, :n]),
                                       atol=TOL, rtol=TOL)
        emb = ref.transformer.embedding
        p = pts[0]
        sq = ref_geo.sq_dist(p, p)
        knn = sq.argsort(1)[:, 1:4]
        d = emb.proj_d(ref_geo.sinusoidal_embedding(
            torch.sqrt(sq) / emb.sigma_d, emb.d))
        terms = []
        for x in range(3):
            u = (p[knn[:, x]] - p)[:, None].expand(12, 12, 3)
            v = p[None] - p[:, None]
            a = torch.atan2(torch.linalg.norm(torch.cross(u, v, dim=-1),
                                              dim=-1), (u * v).sum(-1))
            terms.append(emb.proj_a(ref_geo.sinusoidal_embedding(
                a * emb.factor_a, emb.d)))
        torch.testing.assert_close(got[0], d + torch.stack(terms).amax(0),
                                   atol=TOL, rtol=TOL)


def _padded_clouds(d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 10, d, generator=g)
    pts = torch.rand(2, 10, 3, generator=g)
    mask = torch.zeros(2, 10, dtype=torch.bool)
    mask[0, :10], mask[1, :6] = True, True
    return x, pts, mask


@pytest.mark.parametrize("padded_keys", ["zeros", "large"])
def test_self_blocks_do_not_read_the_embedding_at_padded_keys(setup,
                                                              padded_keys):
    """The embedding's entries at padded keys reach nothing: every self
    block's output, at every row (padded ones too), is the same bit for bit
    whether those entries hold the plain embedding's values, zeros (what
    the embedding writes, kernel and plain version alike) or large finite
    values."""
    model = setup["model"]
    x, pts, mask = _padded_clouds(setup["cfg"]["geo_hidden_dim"], 6)
    emb = model.transformer.embedding
    _, sq = geo_ops.pair_offsets(pts)
    knn = matching.nearest_first(
        torch.where(mask[:, None, :], sq, float("inf")), 4)[1][..., 1:]
    args = (emb.proj_d.weight, emb.proj_d.bias, emb.proj_a.weight,
            emb.proj_a.bias, emb.sigma_d, emb.factor_a)
    with torch.no_grad():
        unzeroed = geo_ops.geo_embedding_reference(
            pts, torch.ones_like(mask), knn, *args)
        got = emb(pts, mask)
        keys = mask[:, None, :, None]
        assert torch.equal(got, torch.where(keys, unzeroed, 0.0))
        other = (got if padded_keys == "zeros"
                 else torch.where(keys, unzeroed, 1e30))
        selfs = [layer for b, layer in zip(model.transformer.blocks,
                                           model.transformer.layers)
                 if b == "self"]
        assert selfs
        for layer in selfs:
            assert torch.equal(layer(x, other, mask),
                               layer(x, unzeroed, mask))


def test_rpe_self_attention_layer_matches_unpadded(setup):
    model, ref = setup["model"], setup["ref"]
    g = torch.Generator().manual_seed(4)
    d = setup["cfg"]["geo_hidden_dim"]
    x = torch.randn(2, 10, d, generator=g)
    pts = torch.rand(2, 10, 3, generator=g)
    mask = torch.zeros(2, 10, dtype=torch.bool)
    mask[0, :10], mask[1, :6] = True, True
    layer, want_layer = model.transformer.layers[0], ref.transformer.layers[0]
    with torch.no_grad():
        emb = model.transformer.embedding(pts, mask)
        got = layer(x, emb, mask)
        for c, n in ((0, 10), (1, 6)):
            want = want_layer(x[c, :n], emb[c, :n, :n])
            torch.testing.assert_close(got[c, :n], want, atol=TOL,
                                       rtol=TOL)


def test_superpoint_matching_matches_the_reference():
    g = torch.Generator().manual_seed(5)
    ref_f = F.normalize(torch.randn(1, 9, 16, generator=g), dim=-1)
    src_f = F.normalize(torch.randn(1, 9, 16, generator=g), dim=-1)
    rm = torch.ones(1, 9, dtype=torch.bool)
    sm = torch.ones(1, 9, dtype=torch.bool)
    rm[0, 7:], sm[0, 2] = False, False
    r, s, scores, valid = matching.superpoint_matching(ref_f, src_f, rm, sm,
                                                       10)
    dual = ref_geo.dual_scores(ref_f[0], src_f[0], rm[0], sm[0])
    wr, ws, wscores = ref_geo.superpoint_matching(dual, 10)
    assert bool(valid.all())
    assert torch.equal(r[0], wr) and torch.equal(s[0], ws)
    torch.testing.assert_close(scores[0], wscores)


def test_partition_is_the_reference_bit_for_bit(setup):
    """Each valid level-1 point in its nearest node's patch, nearest first,
    up to 8 a patch: the program's batched partition is the reference's
    per cloud, index for index (ties included)."""
    out, r = setup["out"], setup["r"]
    m_ref = r["patches"].shape[1]
    kept = torch.where(out["patch_mask"], out["patches"], -1)
    assert torch.equal(kept[:, :m_ref], r["patches"])
    assert bool((kept[:, m_ref:] == -1).all())
    fine = out["levels"][1]
    nodes = out["levels"][-1]
    m = out["patches"].shape[1]
    for c in range(fine.mask.shape[0]):
        n = int(fine.mask[c].sum())
        knn, km, nm = ref_geo.point_to_node_partition(
            fine.points[c, :n], nodes.points[c, :int(nodes.mask[c].sum())],
            8)
        assert torch.equal(out["node_mask"][c, :nm.shape[0]], nm)
        assert not bool(out["node_mask"][c, nm.shape[0]:m].any())
        assert 0 < int(km.sum()) <= n


def test_transport_matches_the_reference():
    g = torch.Generator().manual_seed(6)
    scores = torch.randn(5, 7, 6, generator=g)
    rm = torch.rand(5, 7, generator=g) > 0.3
    cm = torch.rand(5, 6, generator=g) > 0.3
    rm[:, 0], cm[:, 0] = True, True
    ot = matching.LogOptimalTransport(100)
    with torch.no_grad():
        ot.alpha.fill_(0.7)
        got = ot(scores, rm, cm)
    want = ref_geo.log_optimal_transport(scores, rm, cm, torch.tensor(0.7),
                                         100)
    valid = torch.cat([rm, torch.ones(5, 1, dtype=torch.bool)], 1)[
        :, :, None] & torch.cat([cm, torch.ones(5, 1, dtype=torch.bool)],
                                1)[:, None, :]
    torch.testing.assert_close(got[valid], want[valid], atol=TOL, rtol=TOL)
    # the transport's marginals: each valid row of exp sums to one
    rows = torch.exp(got[:, :-1]).sum(-1)[rm]
    torch.testing.assert_close(rows, torch.ones_like(rows), atol=1e-4,
                               rtol=1e-4)


def patches_case(seed, p=6, k=8, spread=2.0):
    """Random patches of a rigidly moved cloud and transport-like scores
    that favour the true matches."""
    g = torch.Generator().manual_seed(seed)
    src = torch.rand(1, p, k, 3, generator=g) * 2
    angle = torch.tensor(0.4)
    rot = torch.tensor([[torch.cos(angle), -torch.sin(angle), 0.0],
                        [torch.sin(angle), torch.cos(angle), 0.0],
                        [0.0, 0.0, 1.0]])
    ref = src @ rot.t() + torch.tensor([0.3, -0.2, 0.1])
    perm = torch.randperm(k, generator=g)
    ref = ref[:, :, perm]
    logits = torch.randn(1, p, k, k, generator=g)
    logits[0, :, torch.arange(k), perm.argsort()] += spread
    log_scores = torch.log_softmax(logits, dim=-1)
    rm = torch.rand(1, p, k, generator=g) > 0.1
    sm = torch.rand(1, p, k, generator=g) > 0.1
    return ref, src, rm, sm, log_scores


@pytest.mark.parametrize("seed,spread", [(7, 3.0), (8, 1.0), (9, 0.0)])
def test_registration_matches_the_reference(seed, spread):
    ref, src, rm, sm, log_scores = patches_case(seed, spread=spread)
    cfg = geo_config()
    pv = torch.ones(1, ref.shape[1], dtype=torch.bool)
    out = matching.local_global_registration(ref, src, rm, sm, log_scores,
                                             pv, cfg)
    s = ref_geo.settings(cfg)
    p = torch.exp(log_scores[0])
    corr = ref_geo.correspondence_matrix(p, rm[0], sm[0], 3, 0.05)
    assert torch.equal(out["corr"][0], corr)
    best, masks, pose = ref_geo.local_to_global(ref[0], src[0], p * corr,
                                                corr, s)
    assert int(out["best"][0]) == best
    n = masks.shape[1]
    assert torch.equal(out["inliers"][0, :, :n], masks)
    assert not bool(out["inliers"][0, :, n:].any())
    torch.testing.assert_close(out["pose"][0], pose, atol=1e-4, rtol=1e-4)


def test_registration_degenerate_branch():
    """No patch pair reaches 3 correspondences: one solve over every
    correspondence starts the refinement (best -1), as upstream's."""
    ref, src, rm, sm, log_scores = patches_case(10, spread=4.0)
    cfg = geo_config(fine_topk=1)
    # one correspondence a row at most, and only two rows a patch pair
    log_scores[..., 2:, :] = -30.0
    out = matching.local_global_registration(
        ref, src, rm, sm, log_scores, torch.ones(1, 6, dtype=torch.bool),
        cfg)
    assert int(out["best"][0]) == -1
    assert bool((out["hyp_counts"] == -1).all())
    s = ref_geo.settings(cfg)
    p = torch.exp(log_scores[0])
    corr = ref_geo.correspondence_matrix(p, rm[0], sm[0], 1, 0.05)
    assert 0 < int(corr.sum()) and int(corr.sum((1, 2)).max()) < 3
    best, masks, pose = ref_geo.local_to_global(ref[0], src[0], p * corr,
                                                corr, s)
    assert best == -1
    assert torch.equal(out["inliers"][0, :, :masks.shape[1]], masks)
    torch.testing.assert_close(out["pose"][0], pose, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("density", [0.0, 0.05, 0.5, 1.0])
def test_compaction_is_nonzero_at_a_fixed_capacity(density):
    g = torch.Generator().manual_seed(11)
    flags = torch.rand(3, 500, generator=g) < density
    idx, valid = matching.compact(flags, 500)
    for b in range(3):
        want = torch.nonzero(flags[b], as_tuple=True)[0]
        assert torch.equal(idx[b][valid[b]], want)
        assert int(valid[b].sum()) == want.shape[0]
        assert bool((idx[b][~valid[b]] == 0).all())


# ------------------------------------------------------ the whole forward ---

def test_forward_matches_the_reference_under_the_cells_gaps(setup):
    kept = family.keep(setup["out"])
    gaps = family.forward_gaps({0: kept}, {0: setup["r"]})
    limits = manifest.load_limits("geotr-3dmatch-infer")
    assert set(gaps) == set(limits)
    assert gaps["kp_gap"] == 0.0
    for k in ("coarse_feat_gap", "fine_feat_gap", "ot_gap", "pose_gap"):
        assert gaps[k] < 1e-4, (k, gaps[k])
    for k in ("node_choice_gap", "corr_choice_gap", "hypothesis_gap"):
        assert gaps[k] <= limits[k], (k, gaps[k])
    # the discrete choices agree outright at this size
    r, out = setup["r"], setup["out"]
    for k in ("node_ref", "node_src", "corr", "best"):
        assert torch.equal(out[k], r[k]), k
    assert torch.isfinite(out["pose"]).all()


def test_answer_altered_fails_the_pose_gap(setup):
    kept = dict(family.keep(setup["out"]))
    kept["pose"] = kept["pose"] + torch.tensor([0.0, 0.0, 0.0, 0.01])
    gaps = family.forward_gaps({0: kept}, {0: setup["r"]})
    assert gaps["pose_gap"] > manifest.load_limits(
        "geotr-3dmatch-infer")["pose_gap"]


def test_a_pair_alone_and_in_a_padded_batch_agree(setup):
    """Pair 0 in the batch of two against pair 0 alone at the same bucket:
    the group norm takes only its own pair's points, the embedding and
    attention mask the padding."""
    model = setup["model"]
    alone = make_forward(model)(setup["pts"][:2], setup["mask"][:2])
    both = setup["out"]
    for k in ("node_ref", "node_src", "corr", "best", "inliers"):
        assert torch.equal(alone[k][0], both[k][0]), k
    m = alone["feats_c"].shape[1]
    torch.testing.assert_close(alone["feats_c"][:2], both["feats_c"][:2, :m],
                               atol=TOL, rtol=TOL)
    assert not bool(both["feats_c"][:2, m:].any())
    torch.testing.assert_close(alone["feats_f"][:2], both["feats_f"][:2],
                               atol=TOL, rtol=TOL)
    torch.testing.assert_close(alone["ot"][0], both["ot"][0], atol=TOL,
                               rtol=TOL)
    torch.testing.assert_close(alone["pose"][0], both["pose"][0], atol=TOL,
                               rtol=TOL)


# ----------------------------------------------------------- the harness ---

def test_the_family_provides_every_hook():
    cfg = manifest.load_config("geotr-3dmatch")["config"]
    fam = manifest.family(cfg, ("forward",))
    for part in ("every", "forward"):
        for name in HOOKS[part]:
            assert callable(getattr(fam, name)), name
    assert "neighbor_dropped" in fam.FAULTS
    shapes = fam.parameter_shapes(cfg, 24576)
    assert shapes["optimal_transport.alpha"] == ()
    assert shapes["backbone.encoder4_3.KPConv.weights"] == (15, 256, 256)
    assert shapes["transformer.layers.0.p_proj.weight"] == (256, 256)
    rules = {n: fam.weight_rule(n, s) for n, s in shapes.items()}
    assert rules["optimal_transport.alpha"][0] is None


def test_work_counts_hold_k1_and_the_forward(setup):
    cfg, pool = setup["cfg"], setup["pool"]
    counts = family.pool_counts(cfg, pool, CPU)
    spec = ref_pyramid.make_spec(cfg, pool[0]["points"].shape[1])
    levels = ref_pyramid.build(setup["pts"], setup["mask"], spec)
    n = [int(x) for x in levels[-1].mask.sum(1)]
    cross = sum(a * n[i ^ 1] for i, a in enumerate(n))
    assert counts[0]["k1"]["flops"] == pytest.approx(
        3 * 4 * cfg["geo_hidden_dim"] * cross)
    assert counts[0]["forward"]["flops"] > counts[0]["k1"]["flops"]
    assert counts[0]["forward"]["exps"] > 0


def test_work_counts_hold_k6_as_regtrs_family_counts_it(setup):
    """The ten radius searches of the shared pyramid: K6's work as the
    RegTR family counts it on the same levels."""
    from portbench.families import regtr

    cfg, pool = setup["cfg"], setup["pool"]
    spec = ref_pyramid.make_spec(cfg, pool[0]["points"].shape[1])
    levels = ref_pyramid.build(setup["pts"], setup["mask"], spec)
    got = family.batch_counts(cfg, levels, spec)["k6"]
    want = regtr.batch_counts(manifest.load_config("regtr-3dmatch")[
        "config"], levels, spec, ref_pyramid.pairs_within)["k6"]
    assert got == want
    assert got["flops"] > 0 and got["bytes"] > 0


def test_chip_smokes_launch_count_is_the_forwards_calls(setup, monkeypatch):
    """chip_smoke.py phase 5c holds the card's launch counts of one
    forward to `geotr_launches_per_forward`: here the calls of each
    kernel's wrapper, where the forward makes them, are those counts."""
    import chip_smoke
    from regtr_tpu_torch.nn import transformer
    from regtr_tpu_torch.ops import kpconv, pyramid

    calls = dict.fromkeys(("neighbor_search", "flash_attn_fwd",
                           "row_gather", "geo_embedding"), 0)

    def counted(module, name, kernel):
        real = getattr(module, name)

        def wrapper(*args, **kw):
            calls[kernel] += 1
            return real(*args, **kw)
        monkeypatch.setattr(module, name, wrapper)

    counted(pyramid, "radius_neighbors_batch", "neighbor_search")
    counted(transformer, "flash_masked_attention", "flash_attn_fwd")
    counted(kpconv, "row_gather", "row_gather")
    counted(program, "row_gather", "row_gather")
    counted(geo_nn, "geo_embedding", "geo_embedding")
    make_forward(setup["model"])(setup["pts"], setup["mask"])
    want = chip_smoke.geotr_launches_per_forward(setup["model"])
    assert calls == {k: want[k] for k in calls}
    assert calls == {"neighbor_search": 10, "flash_attn_fwd": 6,
                     "row_gather": 24, "geo_embedding": 1}
    assert sum(want.values()) == sum(calls.values())


def test_embedding_kernels_weights_are_its_b_fragments():
    """split_weight: entry [h, q, p, s, r, e, i, kk] is part p (TF32 big,
    then small) of W[n, k] for n = 128 h + 8 r + i and k = 64 q + 8 s + 2 kk
    + e; big + small is W to TF32's second rounding."""
    d = 256
    w = torch.randn(d, d, generator=torch.Generator().manual_seed(8))
    parts = geo_ops.split_weight(w)
    assert parts.shape == (2, 4, 2, 8, 16, 2, 8, 4) and parts.is_contiguous()
    bits = parts.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())          # TF32: 13 bits 0
    for h, q, s, r, e, i, kk in ((0, 0, 0, 0, 0, 0, 0), (1, 3, 7, 15, 1, 7, 3),
                                 (1, 2, 5, 5, 0, 3, 2), (0, 1, 2, 9, 1, 6, 1)):
        n, k = 128 * h + 8 * r + i, 64 * q + 8 * s + 2 * kk + e
        big = float(parts[h, q, 0, s, r, e, i, kk])
        small = float(parts[h, q, 1, s, r, e, i, kk])
        assert big == float(geo_ops._tf32(w[n, k]))
        assert abs(big + small - float(w[n, k])) <= 2 ** -21 * abs(
            float(w[n, k]))


def test_embedding_tile_counts_and_what_the_kernel_refuses():
    """The kernel's key tiles at the card test's valid counts; the checks
    that refuse what it was not built for (they run before any launch);
    a device that is neither the CPU nor a card raises."""
    counts = torch.tensor([512, 450, 377, 300, 1, 0, 450, 377])
    run, grid = geo_ops.key_tile_counts(counts, 512, 256)
    assert int(run) == (8 + 8 + 6 + 5 + 1 + 0 + 8 + 6) * 256 * 2
    assert grid == 8 * 8 * 256 * 2
    pts = torch.rand(2, 9, 3)
    mask = torch.ones(2, 9, dtype=torch.bool)
    knn = torch.zeros(2, 9, 3, dtype=torch.long)
    w, b = torch.zeros(256, 256), torch.zeros(256)
    geo_ops._check(pts, mask, knn, w, b, w, b)
    bad = [(pts, mask, knn[..., :2], w, b, w, b),          # angle_k 2
           (pts, mask, knn, w[:192, :192], b[:192], w[:192, :192],
            b[:192]),                                      # d 192
           (pts.double(), mask, knn, w, b, w, b),
           (pts, mask.float(), knn, w, b, w, b),
           (pts, mask, knn.float(), w, b, w, b),
           (pts, mask, knn, w.t(), b, w, b),               # not contiguous
           (torch.rand(40000, 4, 3), torch.ones(40000, 4, dtype=torch.bool),
            torch.zeros(40000, 4, 3, dtype=torch.long), w, b, w, b)]
    for args in bad:
        with pytest.raises(ValueError):
            geo_ops._check(*args)
    with pytest.raises(ValueError):
        geo_ops.geo_embedding(pts.to("meta"), mask.to("meta"),
                              knn.to("meta"), w, b, w, b, 0.2, 3.8)


# ------------------------------------------------ spans, counters, init ---

SPANS = [(0, "geotr.forward"), (1, "geotr.pyramid"), (1, "geotr.backbone"),
         (1, "geotr.embedding"), (1, "geotr.transformer"),
         (1, "geotr.coarse_matching"), (1, "geotr.optimal_transport"),
         (1, "geotr.registration")]


def test_spans_nest_and_counters_count_under_a_profiler(setup):
    model, out = setup["model"], setup["out"]
    for k in program.COUNTERS:
        program.COUNTERS[k] = None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = make_forward(model)(setup["pts"], setup["mask"])
    events = [spans.record(e) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("geotr.")]
    s = spans.Spans(events)
    assert [(len(c) - 1, c[0]) for c in s.chains] == SPANS
    assert torch.equal(traced["pose"], out["pose"])
    counts = out["levels"][-1].mask.sum(1)
    m = out["feats_c"].shape[1]
    # the extent: the largest valid count rounded up to the grain, at most
    # the coarse level's capacity
    assert m == min(-(-int(counts.max()) // program.EXTENT_GRAIN)
                    * program.EXTENT_GRAIN, out["kp_mask"].shape[1])
    assert program.COUNTERS["geotr.embedding_pairs"].tolist() == [
        int((counts ** 2).sum()), 4 * m * m]
    assert program.COUNTERS["geotr.fine_correspondences"].tolist() == [
        int(out["valid"].sum())]
    assert program.COUNTERS["geotr.hypotheses"].tolist() == [
        int((out["hyp_counts"] >= 0).sum())]
    # no profiler: nothing counted
    before = program.COUNTERS["geotr.hypotheses"].clone()
    make_forward(model)(setup["pts"], setup["mask"])
    assert torch.equal(program.COUNTERS["geotr.hypotheses"], before)


def test_create_model_builds_geotransformer_with_its_init():
    cfg = geo_config()
    model = create_model(cfg, 512, CPU, seed=3)
    assert isinstance(model, program.GeoTransformer)
    assert float(model.optimal_transport.alpha.detach()) == 1.0
    norm = model.backbone.encoder1_1.norm
    assert bool((norm.weight == 1).all()) and bool((norm.bias == 0).all())
    with pytest.raises(ValueError):
        create_model(geo_config(fine_use_dustbin=True), 512, CPU)


# RegTR's tiny parameters from create_model(seed=0), as drawn before the
# GroupNorm and alpha rules were added (sha256 of the state_dict's bytes in
# its order)
REGTR_TINY_SHA256 = ("afa24df8941ea79a0871876a1900f97c8cff41707747590a"
                     "2063f9de19e6a9c6")


def test_regtr_draws_are_unchanged():
    model = create_model(tiny_config(), 256, CPU, seed=0)
    digest = hashlib.sha256()
    for v in model.state_dict().values():
        digest.update(v.numpy().tobytes())
    assert digest.hexdigest() == REGTR_TINY_SHA256
