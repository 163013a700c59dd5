"""Port parity: the gather transpose (padded segment sum) and the backward
of the padded feature gathers.

On the CPU the port runs the plain version (`padded_segment_sum_reference`,
an fp32 `index_add_` with the pad-row segments zeroed); it is held against
the JAX package's Pallas kernel in interpret mode and its XLA oracle, and
the gradients of a KPConv block through `batched_row_gather_padded` against
`jax.grad` with the JAX gather transpose set to the Pallas kernel.  The CUDA
kernel is compared with the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.ops import kpconv as jkp
from regtr_tpu.ops.pallas.segsum import (
    padded_segment_sum_reference as jax_reference)
from regtr_tpu.ops.pallas.segsum import (
    sorted_padded_segment_sum as jax_sorted_segsum)
from regtr_tpu_torch.ops import kpconv
from regtr_tpu_torch.utils.kernel_points import load_kernel_points
from tests.test_torch_kpconv import close

# fp32 sums of the same rows in another order: a few ulps of the sums.
ATOL = 3e-5


def neighbor_like_ids(rng, b, n, rows_per_cloud, shadow_rows):
    """Ids as the neighbor tables make them: local runs, a block of shadow
    (pad-row) ids per cloud, shuffled; segments past n // 2 stay empty."""
    ids = []
    for bb in range(b):
        loc = np.clip(np.arange(rows_per_cloud) // 8
                      + rng.randint(-5, 6, rows_per_cloud), 0, n // 2)
        ids.append(bb * n + np.concatenate([loc, np.full(shadow_rows,
                                                         n - 1)]))
    ids = np.concatenate(ids)
    rng.shuffle(ids)
    return ids


@pytest.mark.parametrize("c", [16, 33, 160])
def test_plain_segment_sum_matches_jax(c):
    rng = np.random.RandomState(c)
    b, n = 3, 301
    ids = neighbor_like_ids(rng, b, n, 1200, 400)
    g = rng.randn(len(ids), c).astype(np.float32)
    got = kpconv.sorted_padded_segment_sum(
        torch.from_numpy(g), torch.from_numpy(ids), b * n, n).numpy()
    pallas = np.asarray(jax_sorted_segsum(
        jnp.asarray(g), jnp.asarray(ids, jnp.int32), b * n, n,
        interpret=True))
    oracle = np.asarray(jax_reference(jnp.asarray(g),
                                      jnp.asarray(ids, jnp.int32), b * n, n))
    assert got.dtype == np.float32 and got.shape == (b * n, c)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    # pad-row segments and segments no row names are zero
    seg = np.arange(b * n)
    assert not got[seg % n == n - 1].any()
    assert not got[np.setdiff1d(seg, ids)].any()


def test_bf16_cotangents_sum_in_fp32():
    """bf16 rows are summed in fp32 (the JAX contract): the sum of 512 rows
    of 1 + 2^-7 is exact in fp32, while a bf16 accumulator would stall."""
    g = torch.full((512, 4), 1.0 + 2.0 ** -7, dtype=torch.bfloat16)
    ids = torch.zeros(512, dtype=torch.int64)
    out = kpconv.sorted_padded_segment_sum(g, ids, 4, 2)
    assert out.dtype == torch.float32
    torch.testing.assert_close(out[0], torch.full((4,), 512 * (1 + 2 ** -7)),
                               rtol=0, atol=0)
    assert not out[1:].any()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(neighbor_like_ids(rng, 2, 50, 100, 30))
    g = torch.randn(len(ids), 8, generator=torch.Generator().manual_seed(0))
    before = kpconv.sorted_padded_segment_sum.launches
    out = kpconv.sorted_padded_segment_sum(g, ids, 100, 50)
    assert kpconv.sorted_padded_segment_sum.launches == before
    torch.testing.assert_close(
        out, kpconv.padded_segment_sum_reference(g, ids, 100, 50),
        rtol=0, atol=0)


@pytest.mark.parametrize("extra", [False, True])
def test_gather_backward_through_kpconv_matches_jax(extra):
    """Gradients of one KPConv (the merged gather, plus the max-pooled
    shortcut when `extra`) w.r.t. its features and weights, against
    jax.grad with the JAX gather transpose on the Pallas kernel."""
    from tests.test_torch_kpconv import jax_levels, to_torch_levels
    from regtr_tpu_torch.config import threedmatch_config

    jl = jax_levels(threedmatch_config(), n0=256, b=2, seed=4)
    tl = to_torch_levels(jl)
    rng = np.random.RandomState(6)
    cin, ce, cout = 8, 6, 10
    s_pts = tl[0].points
    x = rng.rand(*s_pts.shape[:2], cin).astype(np.float32)
    xe = rng.randn(*s_pts.shape[:2], ce).astype(np.float32)
    w = rng.randn(15, cin, cout).astype(np.float32)
    cot = rng.randn(tl[1].points.shape[0], tl[1].points.shape[1],
                    cout).astype(np.float32)
    cot_p = rng.randn(tl[1].points.shape[0], tl[1].points.shape[1],
                      ce).astype(np.float32)
    kp = load_kernel_points(0.0625, 15)

    def jax_loss(x_, xe_, w_):
        out, pooled, _ = jkp.kpconv_fused_gather(
            jl[1].points, jl[0].points, jl[0].pools, x_,
            xe_ if extra else None, jnp.asarray(kp), w_, 0.05)
        loss = jnp.sum(out * cot)
        return loss + (jnp.sum(pooled * cot_p) if extra else 0.0)

    jkp.set_segsum_impl("pallas")
    try:
        jgrads = jax.grad(jax_loss, argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(xe), jnp.asarray(w))
    finally:
        jkp.set_segsum_impl("auto")

    tx, txe, tw = (torch.from_numpy(a).requires_grad_() for a in (x, xe, w))
    out, pooled, _ = kpconv.kpconv_fused_gather(
        tl[1].points, s_pts, tl[0].pools, tx, txe if extra else None,
        torch.from_numpy(kp), tw, 0.05)
    loss = (out * torch.from_numpy(cot)).sum()
    if extra:
        loss = loss + (pooled * torch.from_numpy(cot_p)).sum()
    loss.backward()
    close(tx.grad, jgrads[0], "float32")
    close(tw.grad, jgrads[2], "float32")
    if extra:
        close(txe.grad, jgrads[1], "float32")
    else:
        assert txe.grad is None
