"""Port parity: the row and element gathers (ops/gather.py) and the
gradient of `batched_row_gather`.

On the CPU the wrappers run their plain versions (`index_select`,
`torch.gather`); they are held bitwise against `jnp.take` and
`jnp.take_along_axis`, the functions of the TPU gather kernels
(tools/exp_pallas_gather*.py).  The CUDA kernel is compared with the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.ops import kpconv as jkp
from regtr_tpu_torch.ops import gather, kpconv


def bits(x):
    """Raw bits of a torch or JAX array (bf16 included)."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32)
    x = np.asarray(x)
    return x.view(np.int16 if x.dtype.itemsize == 2 else np.int32)


def both(a, dtype):
    """numpy fp32 -> (torch, jax) arrays of dtype with the same bits."""
    t = torch.from_numpy(a)
    if dtype == "bfloat16":
        t = t.to(torch.bfloat16)
        return t, jnp.asarray(t.view(torch.int16).numpy().view(jnp.bfloat16))
    return t, jnp.asarray(a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3, 7, 32, 65])
def test_row_gather_matches_jnp_take(c, dtype):
    rng = np.random.RandomState(c)
    rows_table, rows = 101, 777           # not multiples of any block
    table = rng.randn(rows_table, c).astype(np.float32)
    if dtype == "float32":
        # A copy moves a NaN as it is.  (XLA on the CPU moves bf16 through
        # fp32 and rewrites a bf16 NaN's payload, so not there.)
        table[5, 0] = np.nan
    idx = rng.randint(0, rows_table, rows)
    idx[:4] = rows_table - 1              # the shadow (last) row
    tt, jt = both(table, dtype)
    before = gather.row_gather.launches
    got = gather.row_gather(tt, torch.from_numpy(idx))
    ref = jnp.take(jt, jnp.asarray(idx, jnp.int32), axis=0)
    assert gather.row_gather.launches == before      # the CPU launches none
    assert got.dtype == tt.dtype and got.shape == (rows, c)
    np.testing.assert_array_equal(bits(got), bits(ref))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3, 32])
def test_row_gather_int32_ids_match_jnp_take(c, dtype):
    """int32 indices (a table's flat ids, ops/kpconv.py GatherIndex) gather
    the same rows as int64 ones."""
    rng = np.random.RandomState(c + 7)
    table = rng.randn(257, c).astype(np.float32)
    idx = rng.randint(0, 257, 1001).astype(np.int32)
    tt, jt = both(table, dtype)
    got = gather.row_gather(tt, torch.from_numpy(idx))
    ref = jnp.take(jt, jnp.asarray(idx), axis=0)
    assert got.dtype == tt.dtype and got.shape == (1001, c)
    np.testing.assert_array_equal(bits(got), bits(ref))
    np.testing.assert_array_equal(
        bits(got), bits(gather.row_gather(tt, torch.from_numpy(idx).long())))


def test_gather_index_flat_ids():
    """A table's flat ids: int32, cloud b's rows offset by b * n, shared
    by the gathers over the table, with its transpose built once; more
    rows than int32 ids can name are refused."""
    inds = torch.tensor([[0, 2, 2], [1, 0, 2]])
    index = kpconv.GatherIndex(inds, 3)
    assert index.inds is inds
    assert index.flat.dtype == torch.int32
    assert index.flat.tolist() == [0, 2, 2, 4, 3, 5]
    builds = kpconv.GatherIndex.builds
    first = index.transpose()
    assert index.transpose() is first
    assert kpconv.GatherIndex.builds == builds + 1
    # rows naming a cloud's last row (2 and 5) are pad rows
    assert first.starts.tolist() == [0, 1, 1, 1, 2, 3, 3]
    assert first.perm[:3].tolist() == [0, 4, 3]
    x = torch.arange(12.0).reshape(2, 3, 2)
    np.testing.assert_array_equal(
        kpconv.batched_row_gather(x, index).numpy(),
        x.reshape(6, 2)[index.flat.long()].reshape(2, 3, 2).numpy())
    with pytest.raises(ValueError, match="index over 6 rows"):
        kpconv.batched_row_gather(x[:, :2], index)
    with pytest.raises(ValueError, match="int32"):
        kpconv.GatherIndex(inds, 2 ** 30)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("shape", [(50, 9), (3, 17, 40)])
def test_element_gather_matches_take_along_axis(shape, axis, dtype):
    rng = np.random.RandomState(len(shape) + axis)
    src = rng.randn(*shape).astype(np.float32)
    # the gathered axis may be longer in the output than in src
    out_shape = list(shape)
    out_shape[len(shape) - 2 + axis] += 5
    idx = rng.randint(0, shape[len(shape) - 2 + axis], out_shape)
    ts, js = both(src, dtype)
    got = gather.element_gather(ts, torch.from_numpy(idx), axis)
    ref = jnp.take_along_axis(js, jnp.asarray(idx, jnp.int32),
                              axis=len(shape) - 2 + axis)
    assert got.shape == tuple(out_shape)
    np.testing.assert_array_equal(bits(got), bits(ref))


def test_wrappers_refuse_other_devices():
    """A tensor on neither the CPU nor a CUDA card is refused, not
    gathered by the plain version."""
    table = torch.empty(4, 3, device="meta")
    idx = torch.zeros(5, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="device"):
        gather.row_gather(table, idx)
    with pytest.raises(ValueError, match="device"):
        gather.element_gather(table, idx.view(5, 1)[:4].expand(4, 3), 0)


@pytest.mark.parametrize("b,n,r,c", [(3, 16, 20, 5), (2, 41, 300, 32)])
def test_batched_row_gather_and_gradient_match_jax(b, n, r, c):
    """The forward bitwise; the gradient (the fp32 gather transpose over
    every row, pad rows included) against jax.grad through the JAX
    package's batched_row_gather, at 1e-6: sums of the same fp32 rows in
    another order."""
    rng = np.random.RandomState(n)
    x = rng.randn(b, n, c).astype(np.float32)
    inds = rng.randint(0, n, (b, r))
    inds[:, :3] = n - 1
    g = rng.randn(b, r, c).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_()
    out = kpconv.batched_row_gather(
        xt, kpconv.GatherIndex(torch.from_numpy(inds), n))
    (dx,) = torch.autograd.grad(out, xt, torch.from_numpy(g))

    jinds = jnp.asarray(inds, jnp.int32)
    jout = jkp.batched_row_gather(jnp.asarray(x), jinds)
    jdx = jax.grad(lambda v: jnp.sum(jkp.batched_row_gather(v, jinds)
                                     * jnp.asarray(g)))(jnp.asarray(x))
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(dx.numpy(), np.asarray(jdx), rtol=0,
                               atol=1e-6)
    assert dx[:, n - 1].abs().sum() > 0      # the last row keeps its sum
