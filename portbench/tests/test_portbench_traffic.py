"""The frozen traffic generators give their originals' draws bit for bit,
and the general generator's pools have the shapes a cell states."""
from __future__ import annotations

import numpy as np
import pytest

from portbench.traffic import generator, rooms


def test_rooms_bitwise_the_programs():
    from regtr_tpu_torch.data import rooms as original

    for seed in (0, 2 ** 31 + 11):
        seed %= 2 ** 32
        a = original.scans(1, 2000, seed)
        b = rooms.scans(1, 2000, seed)
        for (ca, ra, ta), (cb, rb, tb) in zip(a, b):
            assert np.array_equal(ca, cb) and np.array_equal(ra, rb) \
                and np.array_equal(ta, tb)


def test_room_pool_poses_and_labels():
    mix = dict(generator.load_mix("rooms-2pairs-train"), pool_pairs=2,
               points_per_scan=6000)
    pool = generator.make_pool(mix, {"buckets": [4096, 8192]}, 3)
    assert len(pool) == 1
    b = pool[0]
    assert b["points"].shape == (4, 8192, 3) and b["mask"].sum() == 24000
    # the pose carries each source onto its target's frame: the labelled
    # points lie within the radius of a target point
    for i in range(2):
        src = b["points"][2 * i][b["mask"][2 * i]]
        tgt = b["points"][2 * i + 1][b["mask"][2 * i + 1]]
        rot, t = b["pose"][i][:, :3], b["pose"][i][:, 3]
        warped = src @ rot.T + t
        lab = b["overlap0"][2 * i][b["mask"][2 * i]] > 0
        assert 0.05 < lab.mean() < 1.0
        d = np.linalg.norm(warped[lab][:50, None] - tgt[None], axis=-1)
        assert (d.min(1) <= 0.0375 + 1e-5).all()


def test_room_pool_is_seeded():
    mix = dict(generator.load_mix("rooms-4pairs"), pool_pairs=4,
               points_per_scan=3000)
    a = generator.make_pool(mix, {"buckets": [4096]}, 2 ** 31 + 99)
    b = generator.make_pool(mix, {"buckets": [4096]}, 2 ** 31 + 99)
    c = generator.make_pool(mix, {"buckets": [4096]}, 5)
    assert len(a) == 1 and a[0]["points"].shape == (8, 4096, 3)
    assert a[0]["mask"].sum(1).tolist() == [3000] * 8
    assert all(np.array_equal(x["points"], y["points"]) for x, y in zip(a, b))
    assert not np.array_equal(a[0]["points"], c[0]["points"])


def test_pick_bucket():
    assert generator.pick_bucket(19000, [8192, 16384, 24576, 32768]) == 24576
    assert generator.pick_bucket(40000, [8192, 32768]) == 32768
