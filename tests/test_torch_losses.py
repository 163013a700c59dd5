"""Port parity: the training losses and the helpers they use, against the
JAX package on the CPU (fp32 on both sides, the same arithmetic in another
order: tolerances of a few fp32 ulps of each result)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.core import masking as jmasking
from regtr_tpu.core import se3 as jse3
from regtr_tpu.losses.corr import corr_loss as jax_corr_loss
from regtr_tpu.losses.feature import InfoNCELoss as JaxInfoNCE
from regtr_tpu.losses.overlap import overlap_loss as jax_overlap_loss
from regtr_tpu.ops import pyramid as jpyr
from regtr_tpu_torch.config import threedmatch_config
from regtr_tpu_torch.core import masking, se3
from regtr_tpu_torch.losses.corr import corr_loss
from regtr_tpu_torch.losses.feature import InfoNCELoss
from regtr_tpu_torch.losses.overlap import overlap_loss
from regtr_tpu_torch.ops.pyramid import compute_overlap_pyramid
from tests.test_torch_kpconv import jax_levels, to_torch_levels

T = torch.from_numpy


def random_pose(rng, b):
    q = rng.randn(b, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], 1).reshape(b, 3, 3)
    return np.concatenate([rot, rng.randn(b, 3, 1)], 2).astype(np.float32)


def test_overlap_loss_matches_jax():
    rng = np.random.RandomState(0)
    logits = (rng.randn(6, 50) * 4).astype(np.float32)
    labels = rng.rand(6, 50).astype(np.float32)
    mask = rng.rand(6, 50) > 0.3
    got = overlap_loss(T(logits), T(labels), T(mask))
    ref = jax_overlap_loss(*(jnp.asarray(a) for a in (logits, labels, mask)))
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


@pytest.mark.parametrize("metric", ["mae", "mse"])
def test_corr_loss_matches_jax(metric):
    rng = np.random.RandomState(1)
    kp = rng.randn(2, 40, 3).astype(np.float32)
    pred = rng.randn(3, 2, 40, 3).astype(np.float32)
    pose = random_pose(rng, 2)
    w = (rng.rand(2, 40) * (rng.rand(2, 40) > 0.4)).astype(np.float32)
    got = corr_loss(T(kp), T(pred), T(pose), T(w), metric)
    ref = jax_corr_loss(*(jnp.asarray(a) for a in (kp, pred, pose, w)),
                        metric=metric)
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5)


def test_infonce_matches_jax():
    """Anchors near the positives (a jittered copy), both masks ragged, and
    a learned W; the loss and its gradients w.r.t. the features and W."""
    rng = np.random.RandomState(2)
    b, n, d = 2, 60, 16
    pos_xyz = rng.rand(b, n, 3).astype(np.float32)
    anc_xyz = (pos_xyz + rng.randn(b, n, 3) * 0.05).astype(np.float32)
    fa, fp = (rng.randn(b, n, d).astype(np.float32) for _ in range(2))
    ma, mp = rng.rand(b, n) > 0.2, rng.rand(b, n) > 0.2
    w = (rng.randn(d, d) * 0.1).astype(np.float32)
    jmod = JaxInfoNCE(d, 0.1, 0.2)
    args = [jnp.asarray(a) for a in (fa, fp, anc_xyz, pos_xyz, ma, mp)]

    import jax

    ref, jgrads = jax.value_and_grad(
        lambda p, a0, a1: jmod.apply({"params": p}, a0, a1, *args[2:]),
        argnums=(0, 1, 2))({"W": jnp.asarray(w)}, args[0], args[1])
    mod = InfoNCELoss(d, 0.1, 0.2)
    with torch.no_grad():
        mod.W.copy_(T(w))
    tfa, tfp = T(fa).requires_grad_(), T(fp).requires_grad_()
    got = mod(tfa, tfp, T(anc_xyz), T(pos_xyz), T(ma), T(mp))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    for g, r in ((mod.W.grad, jgrads[0]["W"]), (tfa.grad, jgrads[1]),
                 (tfp.grad, jgrads[2])):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-4,
                                   atol=1e-6)


def test_masked_logsumexp_and_softmax_match_jax():
    rng = np.random.RandomState(3)
    x = (rng.randn(4, 7, 9) * 5).astype(np.float32)
    m = rng.rand(4, 7, 9) > 0.5
    m[0, 0] = False                      # a row with no valid entry
    for dim in (-1, 1):
        np.testing.assert_allclose(
            masking.masked_logsumexp(T(x), T(m), dim).numpy(),
            np.asarray(jmasking.masked_logsumexp(jnp.asarray(x),
                                                 jnp.asarray(m), dim)),
            rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(
            masking.masked_softmax(T(x), T(m), dim).numpy(),
            np.asarray(jmasking.masked_softmax(jnp.asarray(x),
                                               jnp.asarray(m), dim)),
            rtol=1e-6, atol=1e-7)


def test_se3_compare_matches_jax():
    rng = np.random.RandomState(4)
    a, b = random_pose(rng, 8), random_pose(rng, 8)
    b[0] = a[0]                          # identical: zero error
    got = se3.se3_compare(T(a), T(b))
    ref = jse3.se3_compare(jnp.asarray(a), jnp.asarray(b))
    for key in ("rot_deg", "trans"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]),
                                   rtol=1e-4, atol=2e-3)
    np.testing.assert_allclose(se3.se3_cat(T(a), T(b)).numpy(),
                               np.asarray(jse3.se3_cat(jnp.asarray(a),
                                                       jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)


def test_overlap_pyramid_matches_jax():
    jl = jax_levels(threedmatch_config(), n0=256, b=2, seed=5)
    rng = np.random.RandomState(5)
    ov = (rng.rand(2, 256) > 0.5).astype(np.float32) * np.asarray(jl[0].mask)
    got = compute_overlap_pyramid(T(ov), to_torch_levels(jl))
    ref = jpyr.compute_overlap_pyramid(jnp.asarray(ov), jl)
    assert len(got) == len(ref) == 4
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
