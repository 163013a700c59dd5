"""The brute radius-neighbor search of the port (ops/neighbors.py): the
plain version, which is the K6 kernel's specification (csrc/neighbors.cu),
and the wrapper's contract on the CPU.

The kernel itself runs only on a card (tests/test_torch_cuda.py, and
chip_smoke.py phase 3c, hold it bitwise to the plain version there).
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from regtr_tpu.ops import neighbors as jnb
from regtr_tpu_torch.config import threedmatch_config
from regtr_tpu_torch.data.rooms import padded_pairs
from regtr_tpu_torch.ops import neighbors, pyramid
from tests.test_torch_pyramid import assert_tables_match, padded_batch

RADIUS = 0.1
# fp32 0.05^2 and a farther distance with the same bf16 rounding
TIE = 0.05
TIE_BF16_ONLY = 0.0500049


def _bf16(x):
    return torch.tensor(np.float32(x)).to(torch.bfloat16).float().item()


def _cloud(ns, placed, seed=0):
    """A query at the origin and ns supports: `placed` maps a support id to
    (distance, axis, sign); every other support lies 0.5 away, outside
    RADIUS, in a random direction."""
    rng = np.random.RandomState(seed)
    far = rng.randn(ns, 3)
    s = (0.5 * far / np.linalg.norm(far, axis=1, keepdims=True))
    for i, (dist, axis, sign) in placed.items():
        s[i] = 0.0
        s[i, axis] = sign * dist
    s = torch.from_numpy(s.astype(np.float32))[None]
    q = torch.zeros(1, 1, 3)
    return q, torch.ones(1, 1, dtype=torch.bool), s, torch.ones(
        1, ns, dtype=torch.bool)


def _tie_group(ids):
    """Supports at exactly TIE along the axes, each with the same fp32
    distance from the origin."""
    return {i: (TIE, n % 3, 1.0 if n % 2 == 0 else -1.0)
            for n, i in enumerate(ids)}


def test_premise_bf16_only_tie():
    d_tie = np.float32(TIE) * np.float32(TIE)
    d_far = np.float32(TIE_BF16_ONLY) * np.float32(TIE_BF16_ONLY)
    assert d_far > d_tie and _bf16(d_far) == _bf16(d_tie)
    assert d_tie < np.float32(RADIUS * RADIUS)


def test_plain_bf16_key_ties_go_lowest_id_first():
    # Ns = 40 >= 4k: selection on bf16 keys.  Five supports tie in bf16 at
    # the K-th slot, one of them (id 2) farther in fp32 only.
    placed = {7: (0.02, 0, 1.0), 2: (TIE_BF16_ONLY, 1, 1.0)}
    placed.update(_tie_group([31, 3, 20, 11]))
    out = neighbors.brute_radius_neighbors_plain(*_cloud(40, placed),
                                                 RADIUS, 4)
    assert out.dtype == torch.int64 and out.shape == (1, 1, 4)
    assert out[0, 0].tolist() == [7, 2, 3, 11]


def test_plain_fp32_key_ties_go_lowest_id_first():
    # Ns = 40 < 4k: selection on the fp32 distances.  Nine nearer supports
    # in distance order, then the exact tie at the K-th slots, lowest ids
    # first; id 2, tied in bf16 only, is farther and left out.
    near = {30 + j: (0.01 + 0.004 * j, j % 3, 1.0) for j in range(9)}
    near[38], near[30] = near[30], near[38]      # ids not in distance order
    placed = {**near, 2: (TIE_BF16_ONLY, 1, 1.0)}
    placed.update(_tie_group([39, 14, 5, 25]))
    out = neighbors.brute_radius_neighbors_plain(*_cloud(40, placed),
                                                 RADIUS, 11)
    nearest = sorted(near, key=lambda i: near[i][0])
    assert out[0, 0].tolist() == nearest + [5, 14]
    # the same supports with the bf16 key (k = 10 <= Ns / 4): the tie in
    # bf16 takes the lowest id, 2
    out = neighbors.brute_radius_neighbors_plain(*_cloud(40, placed),
                                                 RADIUS, 10)
    assert out[0, 0].tolist() == nearest + [2]


@pytest.mark.parametrize("radius", [0.0625, 0.125, 0.25, 0.5, 0.0825, 0.165,
                                    0.1, 0.075, 0.0375, 1.3])
def test_kernel_threshold_bits_are_the_plain_versions(radius):
    plain = (torch.full((), radius * radius, dtype=torch.float32)
             * 1.004).numpy()
    # what ctypes hands the kernel as its float argument
    passed = np.float32(ctypes.c_float(
        neighbors.acceptance_threshold(radius)).value)
    assert passed.view(np.uint32) == plain.view(np.uint32)


def test_masked_query_and_k_above_ns_pad_with_ns():
    rng = np.random.RandomState(1)
    q = torch.from_numpy((rng.rand(2, 6, 3) * 0.1).astype(np.float32))
    s = torch.from_numpy((rng.rand(2, 5, 3) * 0.1).astype(np.float32))
    q_mask = torch.ones(2, 6, dtype=torch.bool)
    q_mask[0, 2] = q_mask[1, 5] = False
    s_mask = torch.ones(2, 5, dtype=torch.bool)
    s_mask[1, 0] = False
    out = neighbors.brute_radius_neighbors(q, q_mask, s, s_mask, 1.0, 8)
    assert out.shape == (2, 6, 8)
    assert (out[0, 2] == 5).all() and (out[1, 5] == 5).all()
    assert (out[..., 5:] == 5).all()          # beyond k_eff = Ns
    # every valid support is within 1.0 of every query: all taken
    assert sorted(out[0, 0, :5].tolist()) == [0, 1, 2, 3, 4]
    assert sorted(out[1, 0, :5].tolist()) == [1, 2, 3, 4, 5]


def test_other_devices_raise_and_never_take_the_plain_route(monkeypatch):
    calls = []
    monkeypatch.setattr(neighbors, "brute_radius_neighbors_plain",
                        lambda *a, **k: calls.append(a))
    q = torch.zeros(1, 4, 3, device="meta")
    qm = torch.ones(1, 4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="meta"):
        neighbors.brute_radius_neighbors(q, qm, q, qm, 0.1, 2)
    assert calls == [] and neighbors.brute_radius_neighbors.launches == 0


def test_kernel_input_checks():
    q = torch.zeros(2, 8, 3)
    m = torch.ones(2, 8, dtype=torch.bool)
    neighbors.check_kernel_inputs(q, m, q, m, 4)
    for args, what in (
            ((q.double(), m, q, m, 4), "queries"),
            ((q, m.float(), q, m, 4), "q_mask"),
            ((q, m, q.transpose(0, 1).contiguous().transpose(0, 1), m, 4),
             "supports"),
            ((q, m, q, m[:, :4], 4), "s_mask"),
            ((q, m, q, m, neighbors.MAX_K + 1), "k"),
            ((q, m, q, m, 0), "k")):
        with pytest.raises(ValueError, match=what):
            neighbors.check_kernel_inputs(*args)


def test_pyramid_hands_the_search_what_the_kernel_takes(monkeypatch):
    # Every search of the shipped 3DMatch pyramid would launch the kernel
    # on a card: its inputs pass the wrapper's checks.
    calls = []
    plain = neighbors.brute_radius_neighbors

    def spy(queries, q_mask, supports, s_mask, radius, k):
        neighbors.check_kernel_inputs(queries, q_mask, supports, s_mask, k)
        calls.append((queries.shape[1], supports.shape[1], k))
        return plain(queries, q_mask, supports, s_mask, radius, k)

    monkeypatch.setattr(neighbors, "brute_radius_neighbors", spy)
    spec = pyramid.make_pyramid_spec(threedmatch_config(), 512)
    pts, mask = padded_batch(np.random.RandomState(2), 2, 512)
    pyramid.build_pyramid(torch.from_numpy(pts), torch.from_numpy(mask), spec)
    caps, ks = spec.capacities, spec.neighbor_ks
    assert calls == [c for li in range(4) for c in (
        [(caps[li], caps[li], ks[li])] + ([
            (caps[li + 1], caps[li], ks[li]),
            (caps[li], caps[li + 1], ks[li])] if li < 3 else []))]


@pytest.mark.parametrize("n,k,radius", [(900, 12, 0.0625), (900, 40, 0.1),
                                        (60, 20, 0.1)],
                         ids=["bf16_small_radius", "bf16_large_radius",
                              "exact_topk"])
def test_plain_matches_jax_on_room_like_clouds(n, k, radius):
    pts, mask = padded_batch(np.random.RandomState(n + k), 2, n)
    q, qm = pts[:, ::2].copy(), mask[:, ::2].copy()
    got = neighbors.brute_radius_neighbors(
        *(torch.from_numpy(x) for x in (q, qm, pts, mask)), radius, k,
        query_chunk=200).numpy()
    ref = np.asarray(jnb.radius_neighbors_batch(
        *(jnp.asarray(x) for x in (q, qm, pts, mask)), radius, k,
        method="brute", query_chunk=200))
    assert (got[~qm] == n).all()
    assert_tables_match(got, ref, q, pts, radius)
    # rows whose K fills, where the tie order decides
    assert ((got < n).sum(-1) == k).any()


# --- the kernel's tile culling (csrc/neighbors.cu `tile_may_accept`),
# through its float64 mirror in ops/neighbors.py.  These tests cover the
# margin's mathematics: that a box test with this margin, at these grains,
# keeps every pair the plain version accepts.  The kernel's own fp32 test
# (its directed roundings, its norm bound, the limit it tightens while it
# scans) runs only on a card, where tests/test_torch_cuda.py and
# chip_smoke.py phase 3c hold its tables bitwise to the plain version on
# the same kinds of clouds.

CSRC = Path(__file__).resolve().parent.parent / "regtr_tpu_torch" / "csrc"


def _recorded_searches(pts, mask, cfg):
    """The brute searches one pyramid of cfg makes over (pts, mask), in
    build_pyramid's order: [(queries, q_mask, supports, s_mask, r, k)]."""
    return [args for _, args in chip_smoke.recorded_searches(
        cfg, torch.from_numpy(pts), torch.from_numpy(mask))]


def _rooms(offset=0.0):
    """One pair of room scans (data/rooms.py) at bucket 2048, moved by
    `offset` metres along every axis."""
    pts, mask = padded_pairs(1, 1800, 3, 2048)
    return pts + np.float32(offset), mask


def _corner_clusters():
    """Two clouds of clusters at the corners of the 10-bit voxel key grid
    (1024 voxels of 2.5 cm a side) and beyond it, where the keys clamp."""
    rng = np.random.RandomState(4)
    corners = np.array([[0, 0, 0], [1, 1, 1], [1, 0, 1], [0, 1, 0],
                        [1.2, 1.2, 1.2]]) * 1024 * 0.025
    pts = np.zeros((2, 1024, 3), np.float32)
    mask = np.zeros((2, 1024), bool)
    for i in range(2):
        c = np.repeat(corners, 200, 0)
        pts[i, :1000] = c + rng.uniform(-0.15, 0.15, c.shape)
        mask[i, :1000] = True
    return pts, mask


def _accepted(queries, q_mask, supports, s_mask, radius, k):
    """Every (query, support) pair whose key passes the threshold, by the
    plain version's arithmetic: (B, Nq, Ns) bool."""
    ns = supports.shape[1]
    qx, qy, qz = (c[..., None] for c in queries.unbind(-1))
    sx, sy, sz = (c[:, None, :] for c in supports.unbind(-1))
    d = (neighbors._sq3(qx, qy, qz) - 2.0 * ((qx * sx + qy * sy) + qz * sz)
         ) + neighbors._sq3(sx, sy, sz)
    key = d.to(torch.bfloat16).float() if ns >= 4 * k else d
    thr = torch.tensor(neighbors.acceptance_threshold(radius))
    return (key <= thr) & q_mask[..., None] & s_mask[:, None, :]


def _kept_pairs(queries, q_mask, supports, s_mask, radius, k, q_block,
                s_tile):
    """The (query, support) pairs of the (block, tile) pairs the culling
    test keeps, at the hot loop's first bound: (B, Nq, Ns) bool."""
    lim = neighbors.hot_bound(neighbors.acceptance_threshold(radius),
                              supports.shape[1] >= 4 * k)
    q_lo, q_hi = neighbors.run_boxes(queries, q_mask, q_block)
    s_lo, s_hi = neighbors.run_boxes(supports, s_mask, s_tile)
    keep = neighbors.tile_may_accept(q_lo[:, :, None], q_hi[:, :, None],
                                     s_lo[:, None], s_hi[:, None], lim)
    nq, ns = queries.shape[1], supports.shape[1]
    qi = torch.arange(nq) // q_block
    si = torch.arange(ns) // s_tile
    return keep[:, qi][:, :, si]


CULL_CASES = {
    "rooms": lambda: _recorded_searches(*_rooms(), threedmatch_config()),
    "rooms_100m": lambda: _recorded_searches(*_rooms(100.0),
                                             threedmatch_config()),
    "key_grid_corners": lambda: _recorded_searches(*_corner_clusters(),
                                                   threedmatch_config())[:4],
    # bf16 keys at three radii (at 0.075 the fp32 threshold lies below the
    # midpoint of its bf16 neighbours, so keys accept distances above it),
    # and the fp32 key (Ns < 4k)
    "threshold_shell": lambda: [chip_smoke.threshold_shells(r, k, roll)
                                for r, k in (
        (0.0625, 32), (0.075, 32), (0.5, 200), (0.0625, 3000))
        for roll in (0, 48)],
}
# (queries a warp, supports a tile): the kernel's warp a query,
# kernel_variants.py's teams of 4 and 1 lanes, and chip_smoke.py's culled
# bound (32 x 32)
GRAINS = [(1, neighbors.TILE), (8, neighbors.TILE), (32, neighbors.TILE),
          (32, 32)]


@pytest.mark.parametrize("grain", GRAINS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("case", list(CULL_CASES))
def test_culling_never_drops_an_accepted_support(case, grain):
    searches = CULL_CASES[case]()
    culled = 0
    for args in searches:
        acc = _accepted(*args)
        kept = _kept_pairs(*args, *grain)
        assert not (acc & ~kept).any(), (
            f"{int((acc & ~kept).sum())} accepted pairs in culled tiles")
        # the plain version's table lies in kept pairs too
        table = neighbors.brute_radius_neighbors_plain(*args)
        ns = args[2].shape[1]
        b, q, j = torch.nonzero(table < ns, as_tuple=True)
        assert kept[b, q, table[b, q, j]].all()
        culled += int((~kept & args[1][..., None] & args[3][:, None]).sum())
    if case == "rooms":
        assert culled > 0        # the test has something to rule out


def test_culling_margin_covers_the_offset_clouds():
    # 100 m from the origin the margin (2^-20 (|q|^2 + |s|^2) ~ 0.06 m^2)
    # exceeds level 0's r^2 (0.0039 m^2): the kernel keeps twice the
    # candidates of the same clouds at the origin, and drops none
    # (test_culling_never_drops_an_accepted_support[rooms_100m-*]).
    near, far = (_recorded_searches(*_rooms(off), threedmatch_config())[0]
                 for off in (0.0, 100.0))
    share = []
    for args in (near, far):
        valid = args[1][..., None] & args[3][:, None]
        kept = _kept_pairs(*args, 8, neighbors.TILE) & valid
        share.append(float(kept.sum() / valid.sum()))
    assert share[0] < 0.5 < share[1] and share[1] > 2 * share[0]
    q = far[0][far[1]].double()
    margin = neighbors.MARGIN_SCALE * 2 * float((q * q).sum(-1).min())
    assert margin > 10 * far[4] ** 2


def _source_constant(name):
    text = (CSRC / "neighbors.cu").read_text()
    m = re.search(rf"constexpr \w+ {name} = ([0-9.e+-]+)f?;", text)
    assert m, name
    return float(m.group(1))


def test_mirrors_hold_the_sources_constants():
    assert _source_constant("kTile") == neighbors.TILE
    assert _source_constant("kMarginScale") == neighbors.MARGIN_SCALE
    assert np.float32(_source_constant("kMarginFloor")) == np.float32(
        neighbors.MARGIN_FLOOR)


@pytest.mark.parametrize("size", [1, 32, neighbors.TILE])
def test_run_boxes_are_the_runs_valid_corners(size):
    rng = np.random.RandomState(7)
    n = 3 * neighbors.TILE + 5
    pts = rng.uniform(-50, 50, (2, n, 3)).astype(np.float32)
    mask = rng.uniform(size=(2, n)) < 0.7
    mask[0, :size] = False          # a run with no valid point
    lo, hi = neighbors.run_boxes(torch.from_numpy(pts),
                                 torch.from_numpy(mask), size)
    assert lo.shape == hi.shape == (2, -(-n // size), 3)
    assert lo.dtype == hi.dtype == torch.float64
    for b in range(2):
        for r in range(lo.shape[1]):
            run = slice(r * size, (r + 1) * size)
            valid = pts[b, run][mask[b, run]].astype(np.float64)
            if len(valid):
                np.testing.assert_array_equal(lo[b, r], valid.min(0))
                np.testing.assert_array_equal(hi[b, r], valid.max(0))
            else:
                assert (lo[b, r] == np.inf).all()
                assert (hi[b, r] == -np.inf).all()
    # an empty run's box accepts nothing, whatever the limit
    keep = neighbors.tile_may_accept(lo[0, :1], hi[0, :1], lo[1], hi[1],
                                     1e30)
    assert not keep.any()


def test_hot_bound_covers_every_distance_a_key_accepts():
    rng = np.random.RandomState(6)
    for t in np.concatenate([rng.uniform(1e-4, 1.5, 200),
                             -rng.uniform(1e-9, 1e-4, 50)]).astype(np.float32):
        lim = neighbors.hot_bound(float(t), True)
        key = np.float32(_bf16(t))
        # the bf16 value above the key, and the largest fp32 that rounds
        # to the key or below: the midpoint (exact in fp32), or the float
        # under it where the tie goes up
        bits = key.view(np.uint32)
        above = (bits + np.uint32(0x10000) if key > 0
                 else bits - np.uint32(0x10000)).view(np.float32)
        probe = np.float32((np.float64(key) + np.float64(above)) / 2)
        if _bf16(probe) > key:
            probe = np.nextafter(probe, np.float32(-np.inf),
                                 dtype=np.float32)
        assert _bf16(probe) <= key and probe <= lim
        assert neighbors.hot_bound(float(t), False) == float(t)
