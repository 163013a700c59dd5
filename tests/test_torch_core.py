"""Port parity: regtr_tpu_torch.core against regtr_tpu.core on the CPU.

Inputs come from numpy with fixed seeds and go through both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.core import masking as jmasking
from regtr_tpu.core import pairs as jpairs
from regtr_tpu.core import se3 as jse3
from regtr_tpu.core import se3_np
from regtr_tpu_torch.core import masking, pairs, se3


@pytest.mark.parametrize("dim", [0, 1])
def test_pairs_match_jax(dim):
    x = np.random.RandomState(0).randn(3, 6, 4).astype(np.float32)
    if dim == 0:
        x = x.transpose(1, 0, 2).copy()
    src, tgt = pairs.split_pairs(torch.from_numpy(x), dim=dim)
    jsrc, jtgt = jpairs.split_pairs(jnp.asarray(x), axis=dim)
    np.testing.assert_array_equal(src.numpy(), np.asarray(jsrc))
    np.testing.assert_array_equal(tgt.numpy(), np.asarray(jtgt))
    np.testing.assert_array_equal(
        pairs.swap_pairs(torch.from_numpy(x), dim=dim).numpy(),
        np.asarray(jpairs.swap_pairs(jnp.asarray(x), axis=dim)))


def test_masked_instance_norm_matches_jax():
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 50, 8) * 3 + 1).astype(np.float32)
    mask = rng.rand(4, 50) > 0.3
    mask[3] = False                      # an empty cloud normalizes to zeros
    out = masking.masked_instance_norm(torch.from_numpy(x),
                                       torch.from_numpy(mask)).numpy()
    ref = np.asarray(jmasking.masked_instance_norm(jnp.asarray(x),
                                                   jnp.asarray(mask)))
    # fp32, same two-pass formula; sums may be taken in another order.
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5)
    assert np.all(out[~mask] == 0.0)


def _random_pose(rng):
    return se3_np.se3_init(se3_np.sample_uniform_rotation(rng),
                           rng.randn(3).astype(np.float32))


def test_rigid_transform_matches_jax():
    """Batched weighted Kabsch with padded rows and a near-reflection case;
    the rotation is compared (SVD sign conventions differ by backend)."""
    rng = np.random.RandomState(2)
    l, b, n = 3, 4, 60
    a = rng.randn(l, b, n, 3).astype(np.float32)
    poses = np.stack([_random_pose(rng) for _ in range(l * b)]).reshape(
        l, b, 3, 4)
    bb = (np.einsum("lbij,lbnj->lbni", poses[..., :3], a)
          + poses[..., None, :, 3] + rng.randn(l, b, n, 3) * 0.05
          ).astype(np.float32)
    bb[0, 0] = -a[0, 0]                  # a point reflection: det fix path
    w = rng.rand(l, b, n).astype(np.float32)
    w[..., 50:] = 0.0                    # padded rows drop out
    out = se3.compute_rigid_transform(
        torch.from_numpy(a), torch.from_numpy(bb), torch.from_numpy(w)).numpy()
    ref = np.asarray(jse3.compute_rigid_transform(
        jnp.asarray(a), jnp.asarray(bb), jnp.asarray(w)))
    # fp32 3x3 SVDs from two LAPACK paths: agree to ~1e-5.
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    rot = out[..., :3]
    np.testing.assert_allclose(rot @ np.swapaxes(rot, -1, -2),
                               np.broadcast_to(np.eye(3), rot.shape),
                               atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(rot), 1.0, atol=1e-5)


def test_se3_inv_and_transform_match_numpy():
    rng = np.random.RandomState(3)
    pose = _random_pose(rng).astype(np.float32)
    xyz = rng.randn(20, 3).astype(np.float32)
    out = se3.se3_transform(torch.from_numpy(pose), torch.from_numpy(xyz))
    np.testing.assert_allclose(out.numpy(), se3_np.se3_transform(pose, xyz),
                               atol=1e-5)
    np.testing.assert_allclose(se3.se3_inv(torch.from_numpy(pose)).numpy(),
                               se3_np.se3_inv(pose), atol=1e-6)
