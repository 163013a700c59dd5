"""Port parity: pyramid preprocessing (spec, voxel subsampling, neighbor
search, the full pyramid) against regtr_tpu on the CPU.

Neighbor tables are compared as sets per row.  Selection and acceptance run
on bf16 roundings of fp32 distances from the |q|^2 - 2 q.s + |s|^2
expansion, whose last bits differ between backends, so a point may differ
between the two tables only where that rounding decides (adapted from the
rule in tests/test_preproc.py:228-234):
  * at the K-th slot of a row that is full in both tables, among points at
    the K-th slot's bf16 distance (a tie, broken differently), or
  * at the acceptance threshold r^2 * 1.004, where a one-ulp flip of the
    bf16 rounding moves a point in or out of range.
"""
import glob
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.config import load_config as jax_load_config
from regtr_tpu.nn.backbone import encoder_plan as jax_encoder_plan
from regtr_tpu.ops import neighbors as jnb
from regtr_tpu.ops import pyramid as jpyr
from regtr_tpu.ops import subsample as jsub
from regtr_tpu_torch.config import load_config, threedmatch_config
from regtr_tpu_torch.nn.backbone import encoder_plan
from regtr_tpu_torch.ops import neighbors, pyramid, subsample

CONFS = sorted(glob.glob(str(Path(__file__).parent.parent / "conf" /
                             "*.yaml")))


def plane_scene(rng, n, spacing=0.03):
    """Meter-scale floor + two walls on a jittered grid (3DMatch-like)."""
    side = int(np.ceil(np.sqrt(n / 3)))
    u, v = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    u, v = u.ravel() * spacing, v.ravel() * spacing
    z = np.zeros_like(u)
    pts = np.concatenate([np.stack([u, v, z], 1), np.stack([u, z, v], 1),
                          np.stack([z, u, v], 1)])
    pts = pts + rng.randn(*pts.shape) * spacing * 0.1
    return pts[rng.permutation(len(pts))[:n]].astype(np.float32)


def padded_batch(rng, b, n_cap, fill=(0.9, 0.7, 0.8, 1.0)):
    pts = np.zeros((b, n_cap, 3), np.float32)
    mask = np.zeros((b, n_cap), bool)
    for i in range(b):
        n = int(n_cap * fill[i % len(fill)])
        pts[i, :n] = plane_scene(rng, n) + rng.randn(3).astype(np.float32)
        mask[i, :n] = True
    return pts, mask


def bf16(x):
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def assert_tables_match(got, ref, queries, supports, radius):
    """Per-row set equality, up to the bf16 rounding rules above."""
    ns, k = supports.shape[-2], got.shape[-1]
    assert got.shape == ref.shape
    thr = np.float32(radius * radius) * np.float32(1.004)
    # One bf16 ulp (2^-7 of the leading power of two) at a value: the step
    # by which a last-bit fp32 difference can move a bf16 rounding.
    def ulp(x):
        return np.float32(2.0 ** (np.floor(np.log2(np.maximum(x, 1e-30))) - 7))

    for b in range(got.shape[0]):
        for i in range(got.shape[1]):
            g = set(got[b, i][got[b, i] < ns].tolist())
            r = set(ref[b, i][ref[b, i] < ns].tolist())
            if g == r:
                continue
            def d2(idx):
                return bf16(((supports[b, sorted(idx)].astype(np.float64)
                              - queries[b, i]) ** 2).sum(-1))
            diff = d2(g ^ r)
            at_thr = np.abs(diff - thr) <= 2 * ulp(thr)
            if len(g) == len(r) == k:
                # The differing points fill the last slot(s): one bf16
                # distance, no nearer than any point both tables hold.
                kth = diff.max()
                tie = ((kth - diff <= ulp(kth))
                       & (diff >= d2(g & r).max(initial=0.0) - ulp(kth)))
                assert np.all(tie | at_thr), (b, i, g ^ r, diff)
            else:
                assert np.all(at_thr), (b, i, g ^ r, diff, thr)


@pytest.mark.parametrize("path", CONFS, ids=lambda p: Path(p).stem)
def test_spec_and_plan_match_jax(path):
    cfg = load_config(path)
    jcfg = jax_load_config(path)
    for n0 in list(cfg["buckets"]) + [20480, 96]:
        assert vars(pyramid.make_pyramid_spec(cfg, n0)) == \
            vars(jpyr.make_pyramid_spec(jcfg, n0))
    assert encoder_plan(cfg) == jax_encoder_plan(jcfg)
    assert pyramid.count_pyramid_levels(cfg["architecture"]) == \
        jpyr.count_pyramid_levels(jcfg["architecture"])


def test_3dmatch_spec_at_bench_bucket():
    spec = pyramid.make_pyramid_spec(threedmatch_config(), 20480)
    assert spec.capacities == (20480, 9216, 4152, 1872)
    assert spec.neighbor_ks == (32, 36, 40, 40)


@pytest.mark.parametrize("dl,cap", [(0.05, 400), (0.1, 120), (0.025, 50)])
def test_voxel_keys_and_subsample_bitwise(dl, cap):
    rng = np.random.RandomState(int(dl * 1000))
    pts, mask = padded_batch(rng, 3, 600)
    keys = subsample.voxel_keys(torch.from_numpy(pts), torch.from_numpy(mask),
                                dl).numpy()
    for b in range(3):
        jkeys = np.asarray(jsub.voxel_keys(jnp.asarray(pts[b]),
                                           jnp.asarray(mask[b]), dl))
        np.testing.assert_array_equal(keys[b], jkeys)
    sub, smask, nvox = subsample.grid_subsample(
        torch.from_numpy(pts), torch.from_numpy(mask), dl, cap)
    jsub_pts, jsub_mask, jnvox = jsub.grid_subsample_batch(
        jnp.asarray(pts), jnp.asarray(mask), dl, cap)
    np.testing.assert_array_equal(sub.numpy(), np.asarray(jsub_pts))
    np.testing.assert_array_equal(smask.numpy(), np.asarray(jsub_mask))
    np.testing.assert_array_equal(nvox.numpy(), np.asarray(jnvox))


@pytest.mark.parametrize("ns,k", [(40, 12), (700, 24)],
                         ids=["exact_topk", "bf16_selection"])
def test_brute_neighbors_match_jax(ns, k):
    rng = np.random.RandomState(ns)
    # Uniform clouds dense enough that most rows overflow K (ties at K).
    s = ((rng.rand(2, ns, 3) - 0.5) * 0.4).astype(np.float32)
    q = ((rng.rand(2, 300, 3) - 0.5) * 0.4).astype(np.float32)
    s_mask = rng.rand(2, ns) > 0.1
    q_mask = rng.rand(2, 300) > 0.1
    got = neighbors.brute_radius_neighbors(
        *(torch.from_numpy(x) for x in (q, q_mask, s, s_mask)), 0.1, k,
        query_chunk=128).numpy()
    ref = np.asarray(jnb.radius_neighbors_batch(
        *(jnp.asarray(x) for x in (q, q_mask, s, s_mask)), 0.1, k,
        method="brute", query_chunk=128))
    assert np.all(got[~q_mask] == ns)
    assert np.all(s_mask[np.arange(2)[:, None, None],
                         np.minimum(got, ns - 1)][got < ns])
    assert_tables_match(got, ref, q, s, 0.1)


def _both_pyramids(seed, n0=512):
    cfg = threedmatch_config()
    spec = pyramid.make_pyramid_spec(cfg, n0)
    rng = np.random.RandomState(seed)
    pts, mask = padded_batch(rng, 4, n0)
    levels = pyramid.build_pyramid(torch.from_numpy(pts),
                                   torch.from_numpy(mask), spec)
    jlevels = jpyr.build_pyramid(
        jnp.asarray(pts), jnp.asarray(mask),
        jpyr.make_pyramid_spec(jax_load_config(cfg["config_path"]), n0),
        recall_target=cfg["neighbor_recall"])
    return pts, mask, spec, levels, jlevels


def test_build_pyramid_matches_jax():
    pts, mask, spec, levels, jlevels = _both_pyramids(3)
    np.testing.assert_array_equal(levels[0].perm.numpy(),
                                  np.asarray(jlevels[0].perm))
    for li, (lv, jl) in enumerate(zip(levels, jlevels)):
        np.testing.assert_array_equal(lv.points.numpy(),
                                      np.asarray(jl.points), f"level {li}")
        np.testing.assert_array_equal(lv.mask.numpy(), np.asarray(jl.mask))
        p = lv.points.numpy()
        r = spec.radii[li]
        assert_tables_match(lv.neighbors.numpy(), np.asarray(jl.neighbors),
                            p, p, r)
        if li + 1 < spec.num_levels:
            nxt = levels[li + 1].points.numpy()
            assert_tables_match(lv.pools.numpy(), np.asarray(jl.pools),
                                nxt, p, r)
            assert_tables_match(lv.upsamples.numpy(),
                                np.asarray(jl.upsamples), p, nxt, 2 * r)


def test_pyramid_is_bitwise_repeatable():
    cfg = threedmatch_config()
    spec = pyramid.make_pyramid_spec(cfg, 512)
    pts, mask = (torch.from_numpy(x)
                 for x in padded_batch(np.random.RandomState(4), 4, 512))
    a = pyramid.build_pyramid(pts, mask, spec)
    b = pyramid.build_pyramid(pts.clone(), mask.clone(), spec)
    for la, lb in zip(a, b):
        for field in ("points", "mask", "neighbors", "pools", "upsamples",
                      "perm"):
            x, y = getattr(la, field), getattr(lb, field)
            assert (x is None and y is None) or torch.equal(x, y), field
