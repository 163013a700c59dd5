"""Port parity on the CPU for the 'scan' and 'grid' neighbor searches (their
tables against the JAX package's, `grid`'s cell-capacity overflow and the
whole pyramid with each method), and for the Lie-group helpers:
core/lie.py (numpy, bitwise) and the so3 maps of core/se3.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.core import lie as jlie
from regtr_tpu.core import se3 as jse3
from regtr_tpu.ops import neighbors as jnb
from regtr_tpu.ops import pyramid as jpyr
from regtr_tpu_torch.config import threedmatch_config
from regtr_tpu_torch.core import lie, se3
from regtr_tpu_torch.ops import neighbors, pyramid
from tests.test_torch_pyramid import assert_tables_match, padded_batch

# The fp32 expansion |q|^2 - 2 q.s + |s|^2 summed in another order may
# differ by a few roundings of its largest terms: two distances within
# FP32_TIE * (|q|^2 + |s|^2) of each other (measured up to 1.25e-7 x, 2.1
# roundings of 2^-24 each) are a tie that either backend may break.
FP32_TIE = 4 * 2.0 ** -24


def search_inputs(seed, duplicate):
    """Three padded clouds of meter-scale planes; with `duplicate`, each
    support point appears twice (at i and i + n), so that exactly equal
    distances compete for the last slots of full rows."""
    rng = np.random.RandomState(seed)
    pts, mask = padded_batch(rng, 3, 160)
    if duplicate:
        pts, mask = (np.concatenate([pts, pts], 1),
                     np.concatenate([mask, mask], 1))
    return pts[:, :120], mask[:, :120], pts, mask


def assert_exact_rows(got, ref, queries, supports, radius):
    """Rows equal slot by slot, except where fp32 ties decide: slots whose
    points lie at one distance, points in or out at the K-th slot of a full
    row at that slot's distance, or at the radius (each within FP32_TIE of
    the expansion's terms).  Returns the number of rows that differ."""
    ns, k = supports.shape[1], got.shape[-1]
    r_sq = np.float64(np.float32(radius) ** 2)
    differ = 0
    for b, i in zip(*np.nonzero((got != ref).any(-1))):
        differ += 1
        q = queries[b, i].astype(np.float64)
        s_sq = (supports[b].astype(np.float64) ** 2).sum(-1)
        slack = FP32_TIE * ((q ** 2).sum() + s_sq.max())

        def d2(idx):
            idx = np.asarray(sorted(idx), int)
            return ((supports[b, idx].astype(np.float64) - q) ** 2).sum(-1)

        g, r = got[b, i], ref[b, i]
        gs, rs = set(g[g < ns].tolist()), set(r[r < ns].tolist())
        if gs == rs:
            for x, y in zip(g[g != r], r[g != r]):
                assert abs(d2([x])[0] - d2([y])[0]) <= slack, (b, i, x, y)
            continue
        diff = d2(gs ^ rs)
        at_radius = np.abs(diff - r_sq) <= slack
        if len(gs) == len(rs) == k:
            kth = max(d2(gs).max(), d2(rs).max())
            assert np.all((kth - diff <= slack) | at_radius), (b, i, diff,
                                                               kth)
        else:
            assert np.all(at_radius), (b, i, diff, r_sq)
    return differ


@pytest.mark.parametrize("duplicate", [False, True])
@pytest.mark.parametrize("radius,k", [(0.06, 8), (0.1, 24)])
def test_scan_matches_jax(duplicate, radius, k):
    """The streaming merge in chunks of 64 supports: JAX's tables by the
    pyramid tests' rule, and slot by slot where no fp32 tie decides; with
    duplicated supports, the ties at the last slot go to the lower index,
    as jax.lax.top_k breaks them."""
    q, qm, s, sm = search_inputs(int(radius * 100) + k, duplicate)
    ref = np.asarray(jnb.radius_neighbors_batch(
        *map(jnp.asarray, (q, qm, s, sm)), radius, k, chunk=64,
        method="scan"))
    got = neighbors.scan_radius_neighbors(
        *map(torch.from_numpy, (q, qm, s, sm)), radius, k, chunk=64).numpy()
    assert got.dtype == np.int64
    assert_tables_match(got, ref, q, s, radius)
    differ = assert_exact_rows(got, ref, q, s, radius)
    assert differ <= 0.02 * qm.sum()
    full = (ref < s.shape[1]).sum(-1) == k
    assert full.sum() > 10          # rows cut at K: the ties are exercised


@pytest.mark.parametrize("duplicate", [False, True])
@pytest.mark.parametrize("radius,k,cell_cap", [(0.06, 8, 32), (0.1, 24, 32),
                                               (0.1, 12, 3)])
def test_grid_matches_jax(duplicate, radius, k, cell_cap):
    """Grid cells of edge `radius`: bitwise JAX's tables (the distances are
    elementwise, the same arithmetic); cell_cap 3 overflows most cells,
    which keep their lowest sorted indices as JAX's do."""
    q, qm, s, sm = search_inputs(int(radius * 100) + k + cell_cap, duplicate)
    ref = np.asarray(jnb.radius_neighbors_batch(
        *map(jnp.asarray, (q, qm, s, sm)), radius, k, method="grid",
        cell_cap=cell_cap))
    got = neighbors.grid_radius_neighbors(
        *map(torch.from_numpy, (q, qm, s, sm)), radius, k,
        cell_cap=cell_cap).numpy()
    np.testing.assert_array_equal(got, ref)
    if cell_cap == 3:
        full = neighbors.grid_radius_neighbors(
            *map(torch.from_numpy, (q, qm, s, sm)), radius, k,
            cell_cap=64).numpy()
        assert ((got < s.shape[1]).sum() < (full < s.shape[1]).sum())


@pytest.mark.parametrize("method", ["scan", "grid"])
def test_pyramid_with_method_matches_jax(method):
    """build_pyramid(method=...) over the 3DMatch schedule's four levels:
    every table against JAX's (conv, pool and upsample)."""
    cfg = threedmatch_config()
    q, qm, _, _ = search_inputs(5, False)
    spec = pyramid.make_pyramid_spec(cfg, q.shape[1])
    levels = pyramid.build_pyramid(torch.from_numpy(q), torch.from_numpy(qm),
                                   spec, method=method, chunk=64)
    jlevels = jpyr.build_pyramid(jnp.asarray(q), jnp.asarray(qm),
                                 jpyr.make_pyramid_spec(cfg, q.shape[1]),
                                 chunk=64, method=method)
    for li, (lv, jl) in enumerate(zip(levels, jlevels)):
        np.testing.assert_array_equal(lv.points.numpy(),
                                      np.asarray(jl.points))
        r = spec.radii[li]
        for name, qi, si, radius in (("neighbors", li, li, r),
                                     ("pools", li + 1, li, r),
                                     ("upsamples", li, li + 1, 2 * r)):
            table = getattr(lv, name)
            if table is None:
                continue
            ref = np.asarray(getattr(jl, name))
            args = (table.numpy(), ref, levels[qi].points.numpy(),
                    levels[si].points.numpy(), radius)
            if method == "grid":
                np.testing.assert_array_equal(table.numpy(), ref)
            else:
                assert_tables_match(*args)
                assert_exact_rows(*args)


def test_radius_neighbors_batch_dispatch():
    q, qm, s, sm = map(torch.from_numpy, search_inputs(6, False))
    brute = neighbors.radius_neighbors_batch(q, qm, s, sm, 0.06, 8)
    assert torch.equal(brute, neighbors.brute_radius_neighbors(
        q, qm, s, sm, 0.06, 8))
    with pytest.raises(ValueError, match="neighbor method"):
        neighbors.radius_neighbors_batch(q, qm, s, sm, 0.06, 8,
                                         method="nearest")


def test_lie_classes_match_jax_bitwise():
    """The numpy SO3 / SE3 classes: the same seeds and inputs give the
    JAX package's arrays bit for bit."""
    rng = np.random.RandomState(0)
    omega = (rng.randn(5, 3) * 0.7).astype(np.float32)
    xi = (rng.randn(4, 6) * 0.5).astype(np.float32)
    pts = rng.randn(20, 3).astype(np.float32)
    mat = rng.randn(3, 3).astype(np.float32)
    fns = [
        lambda m: m.SO3.exp(omega).as_matrix(),
        lambda m: m.SO3.exp(omega).log(),
        lambda m: m.SO3.exp(omega).inv().as_matrix(),
        lambda m: (m.SO3.exp(omega[:1]) * m.SO3.exp(omega[1:2])).data,
        lambda m: m.SO3.exp(omega[0]) * pts,
        lambda m: m.SO3.hat(omega),
        lambda m: m.SO3.vee(m.SO3.hat(omega)),
        lambda m: m.SO3.exp(omega[2]).as_quaternion(),
        lambda m: m.SO3.from_matrix(mat, normalize=True).data,
        lambda m: m.SO3.sample_uniform(np.random.RandomState(1)).data,
        lambda m: m.SO3.sample_small(0.2, np.random.RandomState(2)).data,
        lambda m: m.SE3.exp(xi).data,
        lambda m: m.SE3.exp(xi).log(),
        lambda m: m.SE3.pexp(xi).data,
        lambda m: m.SE3.exp(xi).inv().data,
        lambda m: (m.SE3.exp(xi[0]) * m.SE3.exp(xi[1])).data,
        lambda m: m.SE3.exp(xi[0]) * pts,
        lambda m: m.SE3.exp(xi).as_matrix_4x4(),
        lambda m: m.SE3.exp(xi[0]).compare(m.SE3.exp(xi[1]))["rot_deg"],
        lambda m: m.SE3.from_rt(m.SO3.exp(omega[0]), xi[0, 3:]).data,
        lambda m: m.SE3.sample_uniform(2.0, np.random.RandomState(3)).data,
        lambda m: m.SE3.sample_small(0.1, np.random.RandomState(4)).data,
        lambda m: m.SE3.jacob_expeD_de(m.SE3.exp(xi)),
        lambda m: m.SE3.jacob_Dexpe_de(m.SE3.exp(xi)),
        lambda m: m.SE3.jacob_dAexpeD_de(m.SE3.exp(xi[:2]),
                                         m.SE3.exp(xi[2:])),
        lambda m: m.SE3.jacob_dAexpeD_de(m.SE3.exp(xi[:2]),
                                         m.SE3.exp(xi[2:]), False),
        lambda m: m.SE3.identity().data,
        lambda m: m.SO3.identity().data,
    ]
    for n, fn in enumerate(fns):
        np.testing.assert_array_equal(np.asarray(fn(lie)),
                                      np.asarray(fn(jlie)), err_msg=str(n))
    assert lie.SE3.exp(xi).shape == (4,) and lie.SO3.exp(omega).shape == (5,)


def test_so3_maps_match_jax():
    """so3_hat, so3_vee, so3_exp and so3_log (tiny angles included) within
    fp32 rounding of the JAX functions (measured 6e-8, and 0 for the
    log)."""
    rng = np.random.RandomState(1)
    omega = np.concatenate([rng.randn(6, 3) * 0.8,
                            rng.randn(2, 3) * 1e-8]).astype(np.float32)
    t = torch.from_numpy(omega)
    np.testing.assert_array_equal(se3.so3_hat(t).numpy(),
                                  np.asarray(jse3.so3_hat(jnp.asarray(omega))))
    rot = se3.so3_exp(t)
    jrot = jse3.so3_exp(jnp.asarray(omega))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=2e-6)
    np.testing.assert_array_equal(se3.so3_vee(rot).numpy(),
                                  np.asarray(jse3.so3_vee(jrot)))
    np.testing.assert_allclose(se3.so3_log(torch.tensor(np.asarray(
        jrot))).numpy(), np.asarray(jse3.so3_log(jrot)), atol=2e-6)
