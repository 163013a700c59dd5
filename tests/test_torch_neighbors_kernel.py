"""The brute radius-neighbor search of the port (ops/neighbors.py): the
plain version, which is the K6 kernel's specification (csrc/neighbors.cu),
and the wrapper's contract on the CPU.

The kernel itself runs only on a card (tests/test_torch_cuda.py, and
chip_smoke.py phase 3c, hold it bitwise to the plain version there).
"""
import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.ops import neighbors as jnb
from regtr_tpu_torch.config import threedmatch_config
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
