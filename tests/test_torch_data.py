"""The port's own copies of the JAX package's host helpers (kernel points,
collate, overlap labels) give the JAX modules' outputs bitwise."""
import numpy as np
import pytest

from regtr_tpu.data import collate as jcollate
from regtr_tpu.data.overlap import compute_overlap as jax_compute_overlap
from regtr_tpu.utils import kernel_points as jkp
from regtr_tpu_torch.data import collate
from regtr_tpu_torch.data.overlap import compute_overlap
from regtr_tpu_torch.utils import kernel_points


@pytest.mark.parametrize("method,num,seed,fixed", [
    ("lloyd", 15, 0, "center"),       # the shipped configs' KPConv
    ("lloyd", 15, 3, "center"),
    ("lloyd", 15, 0, "verticals"),
    ("repulsion", 15, 0, "center"),   # kernel_point_method: repulsion
])
def test_kernel_points_bitwise(method, num, seed, fixed):
    for radius in (0.0625, 0.125):
        got = kernel_points.load_kernel_points(radius, num, 3, fixed, seed,
                                               method)
        ref = jkp.load_kernel_points(radius, num, 3, fixed, seed, method)
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got, ref)


def test_collate_bitwise():
    rng = np.random.RandomState(0)
    samples = [{"src_xyz": rng.rand(n, 3), "tgt_xyz": rng.rand(m, 3),
                "src_overlap": rng.rand(n) > 0.5,
                "tgt_overlap": rng.rand(m) > 0.5,
                "pose": rng.rand(3, 4), "idx": i}
               for i, (n, m) in enumerate([(19000, 18500), (30000, 100)])]
    buckets = [8192, 16384, 24576, 32768]
    for n in (1, 8192, 8193, 19000, 40000):
        assert collate.pick_bucket(n, buckets) == jcollate.pick_bucket(
            n, buckets)
    assert collate.pick_bucket(19000, buckets) == 24576
    got, gmeta = collate.collate_pairs(samples, buckets)
    ref, rmeta = jcollate.collate_pairs(samples, buckets)
    assert got.keys() == ref.keys() and gmeta == rmeta
    for key in ref:
        assert got[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(got[key], ref[key])


def test_compute_overlap_bitwise():
    rng = np.random.RandomState(1)
    tgt = rng.rand(3000, 3).astype(np.float32)
    src = (tgt[:2000] + rng.randn(2000, 3) * 0.01).astype(np.float32)
    got = compute_overlap(src, tgt, 0.0375)
    ref = jax_compute_overlap(src, tgt, 0.0375)
    assert 0.3 < got[0].mean() < 1.0
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    # by definition: a point overlaps iff the other cloud has one in range
    d = np.linalg.norm(src[:, None] - tgt[None], axis=-1).min(1)
    np.testing.assert_array_equal(got[0], d < 0.0375)
