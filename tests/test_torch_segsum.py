"""Port parity: the gather transpose (padded segment sum), its two parts
(the transpose of a table's flat ids and the sum over it), and the backward
of the padded feature gathers.

On the CPU the port runs the plain versions (`padded_segment_sum_reference`,
an fp32 `index_add_` with the pad-row segments zeroed;
`segment_transpose_reference`, a stable sort with the pad rows dropped;
`segment_sum_reference`, the sum over a transpose); they are held against
numpy's stable argsort, the JAX package's Pallas kernel in interpret mode
and its XLA oracle, and the gradients of a KPConv block and of the whole
backbone (one transpose per distinct neighbor table) against `jax.grad`
with the JAX gather transpose set to the Pallas kernel.  The CUDA kernels
are compared with the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
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
    got = kpconv.padded_segment_sum_reference(
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


@pytest.mark.parametrize("c", [16, 33, 160])
def test_transposed_segment_sum_matches_jax(c):
    """The route of the backward: the transpose of the ids, then the sum
    over it, against the Pallas kernel (interpret mode) and the oracle."""
    rng = np.random.RandomState(c + 1)
    b, n = 3, 301
    ids = neighbor_like_ids(rng, b, n, 1200, 400)
    g = rng.randn(len(ids), c).astype(np.float32)
    t = kpconv.segment_transpose(torch.from_numpy(ids.astype(np.int32)),
                                 b * n, n)
    got = kpconv.segment_sum(torch.from_numpy(g), t).numpy()
    jids = jnp.asarray(ids, jnp.int32)
    pallas = np.asarray(jax_sorted_segsum(jnp.asarray(g), jids, b * n, n,
                                          interpret=True))
    oracle = np.asarray(jax_reference(jnp.asarray(g), jids, b * n, n))
    assert got.dtype == np.float32 and got.shape == (b * n, c)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, oracle, rtol=0, atol=ATOL)
    seg = np.arange(b * n)
    assert not got[seg % n == n - 1].any()
    assert not got[np.setdiff1d(seg, ids)].any()


def numpy_transpose(ids, num_segments, stride):
    """numpy's stable argsort with the pad rows dropped, and each segment's
    start in it."""
    keep = ids % stride != stride - 1
    order = np.argsort(ids, kind="stable")
    order = order[keep[order]]
    starts = np.searchsorted(ids[order], np.arange(num_segments + 1))
    return order, starts


@pytest.mark.parametrize("case", ["neighbors", "long_segment", "all_pad",
                                  "empty_segments", "no_pad_stride"])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_segment_transpose_reference_is_stable_argsort(case, dtype):
    rng = np.random.RandomState(len(case))
    b, n = 3, 301
    stride = n
    if case == "neighbors":
        ids = neighbor_like_ids(rng, b, n, 1200, 400)
    elif case == "long_segment":            # one segment of 6000 rows
        ids = neighbor_like_ids(rng, b, n, 500, 100)
        ids = np.concatenate([ids, np.full(6000, n + 7)])
        rng.shuffle(ids)
    elif case == "all_pad":
        ids = np.repeat(np.arange(b) * n + n - 1, 700)
    elif case == "empty_segments":          # only even segments named
        ids = 2 * rng.randint(0, (b * n - 1) // 2, 2000)
    else:                                   # a stride past the last segment
        ids = rng.randint(0, b * n, 2000)
        stride = b * n + 1
    ids = ids.astype(dtype)
    t = kpconv.segment_transpose_reference(torch.from_numpy(ids), b * n,
                                           stride)
    order, starts = numpy_transpose(ids, b * n, stride)
    assert t.perm.dtype == t.starts.dtype == torch.int32
    assert t.perm.shape == (len(ids),) and t.starts.shape == (b * n + 1,)
    np.testing.assert_array_equal(t.starts.numpy(), starts)
    np.testing.assert_array_equal(t.perm[:starts[-1]].numpy(), order)
    if case == "all_pad":
        assert starts[-1] == 0
    if case == "long_segment":
        assert np.diff(starts).max() >= 6000


def test_bf16_cotangents_sum_in_fp32():
    """bf16 rows are summed in fp32 (the JAX contract): the sum of 512 rows
    of 1 + 2^-7 is exact in fp32, while a bf16 accumulator would stall."""
    g = torch.full((512, 4), 1.0 + 2.0 ** -7, dtype=torch.bfloat16)
    ids = torch.zeros(512, dtype=torch.int64)
    csr = kpconv.segment_sum(g, kpconv.segment_transpose(ids, 4, 2))
    for out in (kpconv.padded_segment_sum_reference(g, ids, 4, 2), csr):
        assert out.dtype == torch.float32
        torch.testing.assert_close(
            out[0], torch.full((4,), 512 * (1 + 2 ** -7)), rtol=0, atol=0)
        assert not out[1:].any()


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.RandomState(0)
    ids = torch.from_numpy(neighbor_like_ids(rng, 2, 50, 100, 30))
    g = torch.randn(len(ids), 8, generator=torch.Generator().manual_seed(0))
    before = (kpconv.segment_sum.launches, kpconv.segment_transpose.launches)
    t = kpconv.segment_transpose(ids, 100, 50)
    csr = kpconv.segment_sum(g, t)
    assert (kpconv.segment_sum.launches,
            kpconv.segment_transpose.launches) == before
    ref = kpconv.padded_segment_sum_reference(g, ids, 100, 50)
    ref_t = kpconv.segment_transpose_reference(ids, 100, 50)
    assert all(torch.equal(a, b) for a, b in zip(t, ref_t))
    # the same rows added in the same (increasing row) order
    torch.testing.assert_close(csr, ref, rtol=0, atol=0)


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
    index = kpconv.GatherIndex(tl[0].pools, s_pts.shape[1] + 1)
    out, pooled, _ = kpconv.kpconv_fused_gather(
        tl[1].points, s_pts, index, tx, txe if extra else None,
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


def test_backbone_backward_builds_one_transpose_per_table():
    """The 11-block 3DMatch backbone (narrowed to 16 first features), fp32:
    the gradients of its output and skips w.r.t. every parameter against
    jax.grad (the JAX gather transpose on the Pallas kernel), with each
    neighbor table's transpose built once, at its first backward: 7 for
    the 10 gathers with a gradient (block 0 gathers the constant feature)."""
    from flax.core import unfreeze

    from regtr_tpu.nn.backbone import KPFEncoder as JaxKPFEncoder
    from regtr_tpu.train.checkpoints import _slash_key
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.convert import state_dict_from_jax
    from regtr_tpu_torch.models import init_parameters
    from regtr_tpu_torch.nn.backbone import KPFEncoder
    from tests.test_torch_kpconv import jax_levels, to_torch_levels

    cfg = threedmatch_config(first_feats_dim=16, remat=False)
    jl = jax_levels(cfg, n0=192, b=2, seed=8)
    tl = to_torch_levels(jl)
    feats0 = jnp.asarray(np.asarray(jl[0].mask, np.float32)[..., None])
    jenc = JaxKPFEncoder(cfg)
    params = jax.jit(lambda k: jenc.init(k, feats0, jl))(jax.random.PRNGKey(1))
    rng = np.random.RandomState(9)
    jout, jskips = jax.jit(lambda p: jenc.apply(p, feats0, jl))(params)
    cots = [rng.randn(*np.shape(x)).astype(np.float32)
            for x in (*jskips, jout)]

    def loss(p):
        out, skips = jenc.apply(p, feats0, jl)
        return sum(jnp.sum(x * c) for x, c in zip((*skips, out), cots))

    jkp.set_segsum_impl("pallas")
    try:
        jgrads = jax.jit(jax.grad(loss))(params)
    finally:
        jkp.set_segsum_impl("auto")
    flat = {_slash_key(k): np.asarray(x) for k, x in
            jax.tree_util.tree_flatten_with_path(
                unfreeze(params)["params"])[0]}
    gflat = {_slash_key(k): np.asarray(x) for k, x in
             jax.tree_util.tree_flatten_with_path(
                 unfreeze(jgrads)["params"])[0]}

    with torch.device("meta"):
        enc = KPFEncoder(cfg)
    enc.to_empty(device="cpu")
    for m in enc.modules():
        if hasattr(m, "reset_kernel_points"):
            m.reset_kernel_points()
    init_parameters(enc, torch.Generator().manual_seed(0))
    enc.load_state_dict(state_dict_from_jax(flat, enc))
    builds = kpconv.GatherIndex.builds
    launches = (kpconv.segment_transpose.launches, kpconv.segment_sum.launches)
    out, skips = enc(torch.from_numpy(np.array(feats0)), tl)
    assert kpconv.GatherIndex.builds == builds       # none in the forward
    total = sum((x * torch.from_numpy(c)).sum()
                for x, c in zip((*skips, out), cots))
    total.backward()
    assert kpconv.GatherIndex.builds - builds == 7
    assert (kpconv.segment_transpose.launches,
            kpconv.segment_sum.launches) == launches     # the CPU: none
    ref = state_dict_from_jax(gflat, enc)
    for name, p in enc.named_parameters():
        want = ref[name].numpy()
        err = float(np.linalg.norm(p.grad.numpy() - want)
                    / max(np.linalg.norm(want), 1e-30))
        # fp32 on both sides, the same sums in another order (test_torch_
        # train.py's bound for the whole model's first step)
        assert err <= 1e-4, (name, err)
