"""Tests of the port's CUDA kernels against their plain PyTorch versions.

They need a CUDA device and skip without one.  This file imports neither
jax nor the repository's conftest, so on a machine with the card and
without jax it runs as

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""
import pytest
import torch

from regtr_tpu_torch.ops.attention import (NEG_BIAS, flash_masked_attention,
                                           flash_masked_attention_reference)

# tests/test_pallas_attention.py's tolerances: fp32 online softmax ~1e-6;
# bf16 operands and output round at 2^-8.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d", [
    (64, 1872, 1872, 32),    # the main path's coarse-level attention
    (16, 2992, 2992, 32),    # the test protocol's (the model at bucket 32768)
    (3, 200, 333, 16),       # ragged key edge, the tiny config's head dim
    (2, 65, 130, 64),        # one query past a tile
    (2, 17, 9, 16),          # less than one tile each way
    (1, 1, 1, 32),
])
def test_flash_kernel_matches_plain_version(cuda, bh, nq, nk, d, dtype):
    g = torch.Generator().manual_seed(nq + nk)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(cuda, tdt)
               for n in (nq, nk, nk))
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, 0] = True
    mask[0] = False                  # a slice with every key masked
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    before = flash_masked_attention.launches
    out = flash_masked_attention(q, k, v, bias, d ** -0.5)
    ref = flash_masked_attention_reference(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert flash_masked_attention.launches == before + 1
    assert out.dtype == tdt and out.shape == (bh, nq, d)
    # A fully masked row is a bias-weighted mean over the keys; finite.
    assert torch.isfinite(out[0].float()).all()
    torch.testing.assert_close(out[1:].float(), ref[1:].float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_kernel_is_bitwise_repeatable(cuda, dtype):
    """No atomics and a fixed order of sums: two launches, and a launch
    that also writes lse, give the same bits."""
    from regtr_tpu_torch.ops.attention import _fwd

    g = torch.Generator().manual_seed(7)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(8, n, 32, generator=g).to(cuda, tdt)
               for n in (1000, 1313, 1313))
    mask = torch.rand(8, 1313, generator=g) > 0.2
    mask[:, 0] = True
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    first = flash_masked_attention(q, k, v, bias, 32 ** -0.5)
    second = flash_masked_attention(q, k, v, bias, 32 ** -0.5)
    with_lse, lse = _fwd(q, k, v, bias, 32 ** -0.5, True)
    again, lse_again = _fwd(q, k, v, bias, 32 ** -0.5, True)
    torch.cuda.synchronize()
    assert torch.equal(first, second) and torch.equal(first, with_lse)
    assert torch.equal(with_lse, again) and torch.equal(lse, lse_again)


def _extent_case(bh, nk, lengths, g):
    """Prefix masks of `lengths` (lo, hi) valid keys a slice (None: drawn
    from 1 .. nk), slice 0 with no valid key, slice 1 full and slice 2
    with a hole (valid keys before and after a masked stretch)."""
    lo, hi = lengths or (1, nk)
    valid = torch.randint(lo, hi + 1, (bh,), generator=g)
    mask = torch.arange(nk)[None, :] < valid[:, None]
    mask[0], mask[1] = False, True
    if bh > 2:
        mask[2] = False
        mask[2, :3] = True
        mask[2, nk // 2:nk // 2 + 5] = True
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d,lengths", [
    (64, 2240, 2240, 32, (280, 420)),   # the inference cell's coarse level
    (16, 656, 656, 32, (656, 656)),     # ModelNet's, every key valid
    (6, 300, 333, 16, None),            # a ragged key edge
    (5, 130, 200, 64, None),
    (3, 17, 9, 16, None),               # less than one tile
])
def test_key_extents_leave_the_kernel_bitwise_unchanged(cuda, bh, nq, nk,
                                                        d, lengths, dtype):
    """K1 with each slice's key extent gives the out and lse of K1 with a
    null extent bit for bit, and so the same gradients; under a profiler
    `key_tiles` counts the key tiles it ran and those of the padded grid."""
    from torch.profiler import ProfilerActivity, profile

    from regtr_tpu_torch.ops import attention

    g = torch.Generator().manual_seed(nq * nk + d)
    tdt = getattr(torch, dtype)
    q, k, v = (torch.randn(bh, n, d, generator=g).to(cuda, tdt)
               for n in (nq, nk, nk))
    mask = _extent_case(bh, nk, lengths, g)
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    ext = attention.key_extents(mask.to(cuda))
    full = attention._fwd(q, k, v, bias, d ** -0.5, True)
    attention.flash_masked_attention.key_tiles = None
    with profile(activities=[ProfilerActivity.CPU]):
        cut = attention._fwd(q, k, v, bias, d ** -0.5, True, ext)
    run, grid = attention.flash_masked_attention.key_tiles.tolist()
    attention.flash_masked_attention.key_tiles = None
    assert torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1])
    expect = attention.key_tile_counts(ext, bh, nq, nk)
    assert (run, grid) == (int(expect[0]), expect[1])
    print(f"{(bh, nq, nk, d)} {dtype}: key tiles {run} of {grid} "
          f"({100 * run / grid:.1f} %)")
    grads = []
    for e in (None, ext):
        qq, kk, vv = (x.clone().requires_grad_() for x in (q, k, v))
        out = attention.flash_masked_attention(qq, kk, vv, bias, d ** -0.5,
                                               kv_extent=e)
        out.float().square().sum().backward()
        grads.append((out, qq.grad, kk.grad, vv.grad))
    assert all(torch.equal(a, b) for a, b in zip(*grads))


@pytest.mark.cuda
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 24, device=cuda)           # head dim 24
    bias = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):
        flash_masked_attention(q, q, q, bias, 0.2)
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError):                   # non-contiguous k
        flash_masked_attention(q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), q, bias, 0.2)
    with pytest.raises(ValueError):                   # int64 key extents
        flash_masked_attention(q, q, q, bias, 0.2,
                               kv_extent=torch.full((2,), 8, device=cuda))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d", [
    (32, 2240, 2240, 32),    # the training step's coarse-level attention
    (3, 200, 333, 16),
    (2, 65, 130, 64),
    (1, 1, 1, 32),
    (2, 17, 9, 16),          # less than one tile and one chunk each way
    (4, 2241, 130, 32),      # one query past the last tile, ragged keys
])
def test_backward_kernels_match_plain_version(cuda, bh, nq, nk, d, dtype):
    """K1's lse, and the dkv and dq kernels, against the plain versions on
    the kernel forward's own output and lse; two launches of each kernel
    bitwise equal."""
    from regtr_tpu_torch.ops.attention import (
        _fwd, attention_delta, flash_attn_bwd_dkv, flash_attn_bwd_dq,
        flash_masked_attention_bwd_reference)

    g = torch.Generator().manual_seed(nq * nk)
    tdt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(bh, n, d, generator=g).to(cuda, tdt)
                   for n in (nq, nk, nk, nq))
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, 0] = True
    mask[0] = False                  # a slice with every key masked
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    out, lse = _fwd(q, k, v, bias, d ** -0.5, True)
    _, ref_lse = flash_masked_attention_reference(q, k, v, bias, d ** -0.5,
                                                  return_lse=True)
    # the fp32 logsumexp of the same scores, in another order
    torch.testing.assert_close(lse, ref_lse, rtol=1e-6, atol=1e-4)
    delta = attention_delta(out, do)
    before = (flash_attn_bwd_dkv.launches, flash_attn_bwd_dq.launches)
    dk, dv, db = flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta,
                                    d ** -0.5, True)
    dq = flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, d ** -0.5)
    again = (flash_attn_bwd_dq(q, k, v, bias, do, lse, delta, d ** -0.5),
             *flash_attn_bwd_dkv(q, k, v, bias, do, lse, delta, d ** -0.5,
                                 True))
    refs = flash_masked_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                                d ** -0.5)
    torch.cuda.synchronize()
    assert (flash_attn_bwd_dkv.launches, flash_attn_bwd_dq.launches) == (
        before[0] + 2, before[1] + 2)
    # No atomics: the same inputs give the same bits.
    for got, rerun in zip((dq, dk, dv, db), again):
        assert torch.equal(got, rerun)
    # fp32: the products run in 3xTF32 (~1e-6 of the largest gradient,
    # tests/test_torch_attention_bwd.py); one TF32 product alone would be
    # ~1e-3 and fail.  bf16: p and ds rounded to bf16 on both sides.
    tol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for got, ref in zip((dq, dk, dv, db), refs):
        assert got.dtype == ref.dtype and got.shape == ref.shape
        assert torch.isfinite(got.float()).all()
        # Held to tol times the larger of the largest |gradient| and 1, the
        # inputs' scale: where a softmax row has one key, dq, dk and dbias
        # are 0 up to the cancellation in dO.v - delta (~1e-7 here).
        scale = max(float(ref.float().abs().max()), 1.0)
        torch.testing.assert_close(got.float(), ref.float(), rtol=tol,
                                   atol=tol * scale)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_kernels_take_operands_off_16_bytes(cuda, dtype):
    """Operands 4 bytes past a 16-byte boundary, which the wrappers accept,
    take the kernels' 4-byte copies: the same bits as aligned copies."""
    from regtr_tpu_torch.ops.attention import (
        _fwd, attention_delta, flash_attn_bwd_dkv, flash_attn_bwd_dq)

    g = torch.Generator().manual_seed(3)
    tdt = getattr(torch, dtype)
    bh, nq, nk, d = 3, 150, 97, 32
    off = 4 // torch.empty((), dtype=tdt).element_size()

    def shifted(n):
        flat = torch.randn(bh * n * d + off, generator=g).to(cuda, tdt)
        return flat[off:].view(bh, n, d)

    q, k, v, do = shifted(nq), shifted(nk), shifted(nk), shifted(nq)
    aligned = [x.clone() for x in (q, k, v, do)]
    assert all(x.data_ptr() % 16 == 4 for x in (q, k, v, do))
    assert all(x.data_ptr() % 16 == 0 for x in aligned)
    mask = torch.rand(bh, nk, generator=g) > 0.2
    mask[:, 0] = True
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    out, lse = _fwd(*aligned[:3], bias, d ** -0.5, True)
    delta = attention_delta(out, aligned[3])
    runs = []
    for qq, kk, vv, dd in ((q, k, v, do), aligned):
        runs.append((flash_attn_bwd_dq(qq, kk, vv, bias, dd, lse, delta,
                                       d ** -0.5),
                     *flash_attn_bwd_dkv(qq, kk, vv, bias, dd, lse, delta,
                                         d ** -0.5, True)))
    torch.cuda.synchronize()
    for got, ref in zip(*runs):
        assert torch.equal(got, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(32, "float32"), (33, "float32"),
                                     (192, "float32"), (32, "bfloat16")])
def test_segsum_kernel_matches_plain_and_repeats(cuda, c, dtype):
    """The gather transpose by the kernels (the ids' transpose, then the
    segment sum over it) against the plain version on a neighbor-like table
    (shadow rows and empty segments included), bitwise equal over two runs
    and to the sum kernel fed the plain transpose."""
    from regtr_tpu_torch.ops.kpconv import (padded_segment_sum_reference,
                                            segment_sum, segment_transpose,
                                            segment_transpose_reference)

    g = torch.Generator().manual_seed(c)
    b, n, k = 3, 4001, 24
    table = torch.randint(0, n // 2, (b, n - 1, k), generator=g)
    table[:, :, 15:] = n - 1                       # shadow neighbors
    ids = (table.reshape(b, -1) + torch.arange(b)[:, None] * n).reshape(-1)
    rows = torch.randn(ids.shape[0], c, generator=g)
    rows, ids = rows.to(cuda, getattr(torch, dtype)), ids.to(cuda)
    before = (segment_sum.launches, segment_transpose.launches)
    got = segment_sum(rows, segment_transpose(ids, b * n, n))
    again = segment_sum(rows, segment_transpose(ids, b * n, n))
    plain_t = segment_sum(rows, segment_transpose_reference(ids, b * n, n))
    ref = padded_segment_sum_reference(rows, ids, b * n, n)
    torch.cuda.synchronize()
    assert (segment_sum.launches, segment_transpose.launches) == (
        before[0] + 3, before[1] + 2)
    assert got.dtype == torch.float32 and got.shape == (b * n, c)
    assert torch.equal(got, again) and torch.equal(got, plain_t)
    # fp32 sums of the same rows in another order
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert not got.view(b, n, c)[:, n // 2:].any()   # pad and empty rows


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
@pytest.mark.parametrize("case", ["neighbors", "long_segment", "all_pad",
                                  "empty_segments", "no_pad_stride",
                                  "shadow_rows_kept", "many_long_segments"])
def test_segment_transpose_kernel_is_stable_sort(cuda, case, id_dtype):
    """The transpose kernels against the plain version (a stable sort with
    the pad rows dropped), bitwise on starts and on perm's rows: a
    neighbor-like table, one segment of 6000 rows, a table of pad rows
    only, segments no row names, a stride that drops no row, a
    neighbor-like table whose shadow rows are kept (a segment of ~13 000
    rows per cloud) and 40 segments of 4097 to 6000 rows among short ones;
    twice.  Segments of more than 4096 rows take the long pass."""
    from regtr_tpu_torch.ops.kpconv import (segment_transpose,
                                            segment_transpose_reference)

    g = torch.Generator().manual_seed(len(case))
    b, n, stride = 4, 5001, 5001
    if case == "neighbors":
        ids = torch.randint(0, n - 1, (b, 40000), generator=g)
        ids[:, ::3] = n - 1
        ids = (ids + torch.arange(b)[:, None] * n).reshape(-1)
    elif case == "long_segment":
        ids = torch.randint(0, b * n, (50000,), generator=g)
        ids[torch.randperm(50000, generator=g)[:6000]] = 7
    elif case == "all_pad":
        ids = (torch.arange(b) * n + n - 1).repeat_interleave(9000)
    elif case == "empty_segments":
        ids = 2 * torch.randint(0, b * n // 2, (30000,), generator=g)
    elif case == "no_pad_stride":
        ids = torch.randint(0, b * n, (30000,), generator=g)
        stride = b * n + 1
    elif case == "shadow_rows_kept":
        ids = torch.randint(0, n - 1, (b, 40000), generator=g)
        ids[:, ::3] = n - 1
        ids = (ids + torch.arange(b)[:, None] * n).reshape(-1)
        stride = b * n + 1
    else:
        ids = torch.randint(0, b * n, (260000,), generator=g)
        # 40 segments of 4097 to 6000 rows (none a pad row's)
        lengths = torch.randint(4097, 6001, (40,), generator=g)
        ids[:int(lengths.sum())] = torch.repeat_interleave(
            torch.arange(40) * 97, lengths)
        ids = ids[torch.randperm(ids.shape[0], generator=g)]
    ids = ids.to(cuda, getattr(torch, id_dtype))
    before = segment_transpose.launches
    got = segment_transpose(ids, b * n, stride)
    again = segment_transpose(ids, b * n, stride)
    ref = segment_transpose_reference(ids, b * n, stride)
    torch.cuda.synchronize()
    assert segment_transpose.launches == before + 2
    m = int(ref.starts[-1])
    for t in (got, again):
        assert t.perm.dtype == t.starts.dtype == torch.int32
        assert torch.equal(t.starts, ref.starts)
        assert torch.equal(t.perm[:m], ref.perm[:m])
    if case == "all_pad":
        assert m == 0
    if case == "long_segment":
        assert int(ref.starts.diff().max()) >= 6000
    if case in ("shadow_rows_kept", "many_long_segments"):
        assert int((ref.starts.diff() > 4096).sum()) == (
            b if case == "shadow_rows_kept" else 40)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 3, 7, 32, 65, 128])
def test_row_gather_kernel_is_index_select(cuda, c, dtype):
    """K5's row gather is a copy: bitwise equal to index_select, at widths
    that take each vector width, and row counts off every block size."""
    from regtr_tpu_torch.ops.gather import row_gather, row_gather_reference

    g = torch.Generator().manual_seed(c)
    table = torch.randn(3001, c, generator=g).to(cuda, getattr(torch, dtype))
    idx = torch.randint(0, 3001, (70001,), generator=g).to(cuda)
    before = row_gather.launches
    got = row_gather(table, idx)
    # an offset view: the kernel takes narrower vectors for its alignment
    shifted = row_gather(table.view(-1)[1:1 + 3000 * c].view(3000, c),
                         idx % 3000)
    torch.cuda.synchronize()
    assert row_gather.launches == before + 2
    assert torch.equal(got, row_gather_reference(table, idx))
    assert torch.equal(shifted, row_gather_reference(
        table.view(-1)[1:1 + 3000 * c].view(3000, c), idx % 3000))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("id_dtype", ["int32", "int64"])
def test_narrow_row_gather_kernel_is_index_select(cuda, id_dtype, c, dtype):
    """The narrow rows (at most four vectors narrower than 16 bytes, the
    coordinate rows among them) through shared memory: bitwise equal to
    index_select with int32 and int64 indices, for tables, indices and
    outputs off 16 bytes, and row counts off the block's."""
    from regtr_tpu_torch.ops.gather import row_gather, row_gather_reference

    g = torch.Generator().manual_seed(c)
    tdt = getattr(torch, dtype)
    table = torch.randn(3002, c, generator=g).to(cuda, tdt)
    idx = torch.randint(0, 3000, (70001 + 4,), generator=g).to(
        cuda, getattr(torch, id_dtype))
    # tables 1 and 2 elements past the allocation's start: narrower vectors
    shifted = [table.view(-1)[k:k + 3000 * c].view(3000, c) for k in (1, 2)]
    before = row_gather.launches
    for tab in (table, *shifted):
        for ids in (idx[:70001], idx[1:70002], idx[:1], idx[:2049]):
            assert torch.equal(row_gather(tab, ids),
                               row_gather_reference(tab, ids.long()))
    assert row_gather.launches == before + 12


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axis", [0, 1])
def test_element_gather_kernel_is_torch_gather(cuda, axis, dtype):
    """K5's element gather against torch.gather, bitwise: 2-D, and batched
    with a batch stride that is not the slices' size."""
    from regtr_tpu_torch.ops.gather import (element_gather,
                                            element_gather_reference)

    g = torch.Generator().manual_seed(axis)
    tdt = getattr(torch, dtype)
    src = torch.randn(517, 33, generator=g).to(cuda, tdt)
    n = src.shape[axis]
    idx = torch.randint(0, n, (600, 33) if axis == 0 else (517, 70),
                        generator=g).to(cuda)
    batched = torch.randn(7, 2, 40, 50, generator=g).to(cuda, tdt)[:, 0]
    bidx = torch.randint(0, (40, 50)[axis], (7, 40, 50), generator=g
                         ).to(cuda)
    before = element_gather.launches
    got = element_gather(src, idx, axis)
    bgot = element_gather(batched, bidx, axis)
    torch.cuda.synchronize()
    assert element_gather.launches == before + 2
    assert torch.equal(got, element_gather_reference(src, idx, axis))
    assert torch.equal(bgot, element_gather_reference(batched, bidx, axis))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cols", [20000, 130000])
def test_element_gather_kernel_wide_rows(cuda, cols, dtype):
    """Axis-1 rows wider than 48 KB take shared memory past the default
    (20000 fp32: 80 KB; 2999 outputs a row, enough to stage the row);
    rows wider than a block's shared memory (130000: 260 or 520 KB) gather
    from device memory.  Bitwise torch.gather, with a batch stride larger
    than the slice and operands off 16 bytes."""
    from regtr_tpu_torch.ops.gather import (element_gather,
                                            element_gather_reference)

    g = torch.Generator().manual_seed(cols)
    tdt = getattr(torch, dtype)
    flat = torch.randn(3 * 5 * cols + 1, generator=g).to(cuda, tdt)
    src = flat[1:].view(3, 5, cols)[:, :4]            # batch stride 5 rows
    idx = torch.randint(0, cols, (3 * 4 * 2999 + 1,), generator=g).to(cuda)
    idx = idx[1:].view(3, 4, 2999)
    before = element_gather.launches
    got = element_gather(src, idx, 1)
    torch.cuda.synchronize()
    assert element_gather.launches == before + 1
    assert torch.equal(got, element_gather_reference(src, idx, 1))


@pytest.mark.cuda
def test_batched_row_gather_on_the_card(cuda):
    """batched_row_gather launches K5 forward and K4 backward (the ids'
    transpose and the segment sum); both match the CPU (the forward
    bitwise, the fp32 sums to a few ulps)."""
    from regtr_tpu_torch.ops import gather, kpconv

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 400, 32, generator=g)
    inds = torch.randint(0, 400, (3, 5000), generator=g)
    cot = torch.randn(3, 5000, 32, generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).requires_grad_()
        before = (gather.row_gather.launches,
                  kpconv.segment_transpose.launches,
                  kpconv.segment_sum.launches)
        out = kpconv.batched_row_gather(
            xd, kpconv.GatherIndex(inds.to(dev), 400))
        (dx,) = torch.autograd.grad(out, xd, cot.to(dev))
        outs[str(dev)] = (out.detach().cpu(), dx.cpu(), (
            gather.row_gather.launches - before[0],
            kpconv.segment_transpose.launches - before[1],
            kpconv.segment_sum.launches - before[2]))
    (out_c, dx_c, n_c), (out_g, dx_g, n_g) = outs.values()
    assert n_c == (0, 0, 0) and n_g == (1, 1, 1)
    assert torch.equal(out_c, out_g)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_batched_row_gather_backward_long_segments(cuda):
    """batched_row_gather's backward keeps each cloud's last (shadow) row,
    which most neighbor slots name: segments of ~12 000 rows, ordered by the
    transpose's long pass.  The gradient against the CPU's, bitwise over two
    runs on the card."""
    from regtr_tpu_torch.ops import kpconv

    g = torch.Generator().manual_seed(1)
    b, n, r = 2, 3000, 20000
    x = torch.randn(b, n, 8, generator=g)
    inds = torch.randint(0, n, (b, r), generator=g)
    inds[:, torch.rand(r, generator=g) < 0.6] = n - 1
    cot = torch.randn(b, r, 8, generator=g)
    dxs = []
    for dev in ("cpu", cuda, cuda):
        xd = x.to(dev).requires_grad_()
        out = kpconv.batched_row_gather(
            xd, kpconv.GatherIndex(inds.to(dev), n))
        dxs.append(torch.autograd.grad(out, xd, cot.to(dev))[0].cpu())
    assert torch.equal(dxs[1], dxs[2])
    torch.testing.assert_close(dxs[1], dxs[0], rtol=1e-5,
                               atol=1e-5 * float(dxs[0].abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("axis", [0, 1])
def test_element_gather_moves_int32_bits(cuda, axis):
    """K5b on int32 ids whose float view is NaN (quiet and signalling
    payloads), infinite, subnormal or negative zero: bitwise torch.gather,
    2-D and batched, rows staged in shared memory and rows read from
    device memory, so the kernel moves 4-byte words and does no float
    arithmetic on them."""
    from regtr_tpu_torch.ops.gather import (element_gather,
                                            element_gather_reference)

    special = torch.tensor([0x7FC00001, -0x3ED0000, 0x7F800001, 0x7F800000,
                            -0x800000, 1, 0x007FFFFF, -0x80000000, 0,
                            0x7FFFFFFF], dtype=torch.int32)
    g = torch.Generator().manual_seed(axis)
    src = special[torch.randint(0, len(special), (3, 97, 41), generator=g)]
    src = src.to(cuda)
    assert torch.isnan(src.view(torch.float32)).any()
    n = src.shape[1 + axis]
    shape = (3, 150, 41) if axis == 0 else (3, 97, 60)
    idx = torch.randint(0, n, shape, generator=g).to(cuda)
    # a search's merge: 32 of 1056 candidates a row, gathered from device
    # memory without staging the row
    merge = special[torch.randint(0, len(special), (2, 50, 1056),
                                  generator=g)].to(cuda)
    pick = torch.randint(0, 1056, (2, 50, 32), generator=g).to(cuda)
    before = element_gather.launches
    got = element_gather(src, idx, axis)
    got2d = element_gather(src[1], idx[1].contiguous(), axis)
    got_merge = element_gather(merge, pick, 1)
    torch.cuda.synchronize()
    assert element_gather.launches == before + 3
    assert got.dtype == torch.int32
    assert torch.equal(got, element_gather_reference(src, idx, axis))
    assert torch.equal(got2d, element_gather_reference(src[1], idx[1], axis))
    assert torch.equal(got_merge, element_gather_reference(merge, pick, 1))


def _plane_clouds(b, n, seed):
    """Meter-scale floor and wall points, jittered off a 3 cm grid."""
    g = torch.Generator().manual_seed(seed)
    side = int((n / 2) ** 0.5) + 1
    u, v = torch.meshgrid(torch.arange(side), torch.arange(side),
                          indexing="ij")
    u, v = u.reshape(-1) * 0.03, v.reshape(-1) * 0.03
    z = torch.zeros_like(u)
    base = torch.cat([torch.stack([u, v, z], 1), torch.stack([u, z, v], 1)])
    pts = torch.stack([base[torch.randperm(len(base), generator=g)[:n]]
                       for _ in range(b)])
    pts = pts + torch.randn(pts.shape, generator=g) * 0.003
    mask = torch.ones(b, n, dtype=torch.bool)
    mask[1, n * 3 // 4:] = False
    return pts.float(), mask


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["scan", "grid"])
def test_scan_and_grid_on_the_card(cuda, method):
    """The 'scan' and 'grid' searches on the card take their candidates'
    ids by K5b (launched once per chunk, once per cloud) and give the CPU's
    tables: 'grid' bitwise (elementwise distances), 'scan' slot by slot
    except at fp32 ties of the distance expansion (a few roundings of
    |q|^2 + |s|^2)."""
    from regtr_tpu_torch.ops import neighbors
    from regtr_tpu_torch.ops.gather import element_gather

    torch.backends.cuda.matmul.allow_tf32 = False
    pts, mask = _plane_clouds(2, 3000, 3)
    args = (pts, mask, pts, mask, 0.0625, 12)
    before = element_gather.launches
    got = neighbors.radius_neighbors_batch(
        *(a.to(cuda) for a in args[:4]), *args[4:], method=method,
        chunk=512).cpu()
    launches = element_gather.launches - before
    ref = neighbors.radius_neighbors_batch(*args, method=method, chunk=512)
    assert launches == (2 if method == "grid" else 3000 // 512 + 1)
    assert ((ref < 3000).sum(-1) == 12).sum() > 100     # full rows: ties
    if method == "grid":
        assert torch.equal(got, ref)
        return
    for b, i in zip(*torch.nonzero((got != ref).any(-1), as_tuple=True)):
        q = pts[b, i].double()
        slack = 4 * 2.0 ** -24 * (float((q * q).sum())
                                  + float((pts[b].double() ** 2).sum(-1)
                                          .max()))
        d = {int(j): float(((pts[b, j].double() - q) ** 2).sum())
             for j in torch.cat([got[b, i], ref[b, i]]) if j < 3000}
        kth = max(d.values())
        for j in set(got[b, i].tolist()) ^ set(ref[b, i].tolist()):
            assert (kth - d[j] <= slack
                    or abs(d[j] - 0.0625 ** 2) <= slack), (b, i, j)


@pytest.mark.cuda
@pytest.mark.parametrize("modulated", [False, True])
def test_deformable_block_on_the_card(cuda, modulated):
    """A strided deformable bottleneck block (fp32), forward and backward
    on the card (K5a gathers, K4 gather transposes) against the same block
    on the CPU (plain versions), same parameters and tables."""
    from regtr_tpu_torch.config import threedmatch_config
    from regtr_tpu_torch.models import init_parameters
    from regtr_tpu_torch.nn.blocks import ResnetBottleneckBlock
    from regtr_tpu_torch.ops import gather, kpconv
    from regtr_tpu_torch.ops.pyramid import build_pyramid, make_pyramid_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = threedmatch_config(modulated=modulated)
    pts, mask = _plane_clouds(2, 2000, 4)
    levels = build_pyramid(pts, mask, make_pyramid_spec(cfg, 2000))
    block = ResnetBottleneckBlock("resnetb_deformable_strided", 64, 128,
                                  0.0625, 0, cfg)
    init_parameters(block, torch.Generator().manual_seed(0))
    with torch.no_grad():       # offsets of a fraction of the extent
        block.kpconv.offset_weights.mul_(0.2)
    g = torch.Generator().manual_seed(1)
    x = torch.rand(2, 2000, 64, generator=g)
    cot = torch.randn(2, levels[1].points.shape[1], 128, generator=g)
    results = []
    for dev in ("cpu", cuda):
        blk = block.to(dev)
        lv = [kpconv_level.__class__(**{
            k: None if v is None else v.to(dev)
            for k, v in vars(kpconv_level).items()})
            for kpconv_level in levels]
        xd = x.to(dev).requires_grad_()
        before = (gather.row_gather.launches, kpconv.segment_sum.launches)
        out = blk(xd, lv, {})
        grads = torch.autograd.grad(out, [xd, *blk.parameters()],
                                    cot.to(dev))
        used = (gather.row_gather.launches - before[0],
                kpconv.segment_sum.launches - before[1])
        results.append((out.detach().cpu(), [t.cpu() for t in grads], used))
    (out_c, g_c, used_c), (out_g, g_g, used_g) = results
    # offset conv: features + coordinates; the conv: coordinates, features;
    # the shortcut's max pool: features.  Backward: a sum per feature gather
    assert used_c == (0, 0) and used_g == (5, 3)
    torch.testing.assert_close(out_g, out_c, rtol=1e-4,
                               atol=1e-4 * float(out_c.abs().max()))
    for a, b in zip(g_g, g_c):
        assert torch.isfinite(a).all()
        assert float((a - b).norm()) <= 1e-4 * float(b.norm()) + 1e-12


@pytest.mark.cuda
@pytest.mark.parametrize("b,nq,ns,k,radius", [
    (2, 3000, 3000, 32, 0.0625),    # bf16 key, level 0 of a small pyramid
    (2, 1400, 3000, 36, 0.125),     # a pool search: fewer queries
    (2, 3000, 1400, 40, 0.25),      # an upsample search: fewer supports
    (3, 300, 100, 50, 0.2),         # fp32 key (Ns < 4k)
    (2, 129, 4100, 64, 0.3),        # ragged block and tile edges
    (2, 50, 600, 100, 0.5),         # k above 64: the wider instance
    (2, 17, 5, 8, 1.0),             # k above Ns
])
def test_brute_neighbor_kernel_is_the_plain_version(cuda, b, nq, ns, k,
                                                    radius):
    """K6 against its plain version on the same inputs: bitwise, on grid
    clouds whose rows fill K and tie at the K-th slot; the second launch
    repeats the first."""
    from regtr_tpu_torch.ops import neighbors

    supports, s_mask = _plane_clouds(b, ns, ns + k)
    queries, q_mask = _plane_clouds(b, nq, nq + 1)
    q_mask[0, ::7] = False
    if ns > 4096:
        s_mask[0, 2048:4096] = False        # one tile with no support
    args = (queries, q_mask, supports, s_mask)
    before = neighbors.brute_radius_neighbors.launches
    got = neighbors.brute_radius_neighbors(
        *(a.to(cuda) for a in args), radius, k)
    again = neighbors.brute_radius_neighbors(
        *(a.to(cuda) for a in args), radius, k)
    torch.cuda.synchronize()
    ref = neighbors.brute_radius_neighbors_plain(
        *(a.to(cuda) for a in args), radius, k)
    assert neighbors.brute_radius_neighbors.launches == before + 2
    assert got.dtype == torch.int64 and got.shape == (b, nq, k)
    assert torch.equal(got, ref) and torch.equal(got, again)
    assert torch.equal(got.cpu(), neighbors.brute_radius_neighbors_plain(
        *args, radius, k))
    assert (got[~q_mask.to(cuda)] == ns).all()


@pytest.mark.cuda
def test_brute_neighbor_kernel_refuses_what_it_does_not_take(cuda):
    from regtr_tpu_torch.ops import neighbors

    q = torch.zeros(2, 64, 3, device=cuda)
    m = torch.ones(2, 64, dtype=torch.bool, device=cuda)
    for args in ((q.transpose(0, 1).contiguous().transpose(0, 1), m, q, m,
                  0.1, 8),
                 (q.half(), m, q, m, 0.1, 8),
                 (q, m.float(), q, m, 0.1, 8),
                 (q, m, q, m, 0.1, neighbors.MAX_K + 1)):
        with pytest.raises(ValueError):
            neighbors.brute_radius_neighbors(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("lengths", [(352, 377), (300, 300)])
def test_k1_fp32_d64_at_geotransformers_cross_attention(cuda, lengths):
    """K1 at GeoTransformer's cross-attention: 4 pairs x 4 heads, d_head 64,
    fp32, queries and keys at the model's extent of superpoints (512 at
    ~360 valid a cloud), with key extents: the plain version's result,
    bitwise that without extents; its time by CUDA events beside the
    plain one."""
    from regtr_tpu_torch.ops import attention

    bh, n, d = 16, 512, 64
    g = torch.Generator().manual_seed(sum(lengths))
    q, k, v = (torch.randn(bh, n, d, generator=g).to(cuda)
               for _ in range(3))
    mask = torch.zeros(bh, n, dtype=torch.bool)
    for i in range(bh):
        mask[i, :lengths[i % 2]] = True
    bias = torch.where(mask, 0.0, NEG_BIAS).float().to(cuda)
    ext = attention.key_extents(mask.to(cuda))
    out = attention.flash_masked_attention(q, k, v, bias, d ** -0.5,
                                           kv_extent=ext)
    full = attention.flash_masked_attention(q, k, v, bias, d ** -0.5)
    ref = flash_masked_attention_reference(q, k, v, bias, d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, full)
    torch.testing.assert_close(out, ref, atol=TOL["float32"],
                               rtol=TOL["float32"])
    times = {}
    for name, fn in (("kernel", lambda: attention.flash_masked_attention(
            q, k, v, bias, d ** -0.5, kv_extent=ext)),
            ("plain", lambda: flash_masked_attention_reference(
                q, k, v, bias, d ** -0.5))):
        fn()
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        start.record()
        for _ in range(30):
            fn()
        end.record()
        end.synchronize()
        times[name] = start.elapsed_time(end) / 30
    print(f"K1 fp32 {(bh, n, n, d)} valid {lengths}: kernel "
          f"{times['kernel']:.4f} ms, plain {times['plain']:.4f} ms a call "
          f"(30 back to back)")


def _geotr_cell(cuda, seed):
    from portbench import cells, manifest
    from portbench import weights as weights_mod
    from portbench.traffic.generator import load_mix, make_pool

    cfg = manifest.load_config("geotr-3dmatch")["config"]
    pool = make_pool(load_mix("rooms-4pairs"), cfg, seed)
    w = weights_mod.draw(cells.parameter_shapes(
        cfg, pool[0]["points"].shape[1]), seed, cuda)
    return cfg, pool, w


@pytest.mark.cuda
def test_geotransformer_full_width_forward_within_the_cells_limits(cuda):
    """The cell's configuration at its published widths on the card: the
    forward of both pool batches through the inference entry, against the
    plain reference, under the cell's limits."""
    from portbench import calibrate, manifest

    cfg, pool, w = _geotr_cell(cuda, 3300000001)
    gaps = calibrate.program_gaps("forward", cfg, pool, w, cuda)
    limits = manifest.load_limits("geotr-3dmatch-infer")
    print(gaps)
    assert all(gaps[k] <= limits[k] for k in limits), gaps


@pytest.mark.cuda
def test_geotransformer_counters_on_the_card(cuda):
    """The model's counters under a profiler with the card traced: pairs
    embedded (valid and of the grid at the model's extent, far below the
    coarse level's capacity), correspondences and hypotheses."""
    from torch.profiler import ProfilerActivity, profile

    from portbench import cells
    from regtr_tpu_torch.models import geotransformer as program
    from regtr_tpu_torch.train.steps import make_forward

    cfg, pool, w = _geotr_cell(cuda, 3300000002)
    model = cells.build_model(cfg, pool[0]["points"].shape[1], w, cuda)
    x = cells.upload(pool[0], cuda, ("points", "mask"))
    for key in program.COUNTERS:
        program.COUNTERS[key] = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out = make_forward(model)(x["points"], x["mask"])
        torch.cuda.synchronize()
    counts = out["levels"][-1].mask.sum(1)
    cap = out["levels"][-1].mask.shape[1]
    m = out["feats_c"].shape[1]
    pairs = program.COUNTERS["geotr.embedding_pairs"].tolist()
    assert pairs == [int((counts ** 2).sum()), 8 * m * m]
    assert pairs[1] < 8 * cap * cap / 10
    assert program.COUNTERS["geotr.fine_correspondences"].tolist() == [
        int(out["valid"].sum())]
    assert program.COUNTERS["geotr.hypotheses"].tolist() == [
        int((out["hyp_counts"] >= 0).sum())]
    print(f"embedding pairs {pairs} (capacity grid {8 * cap * cap}); "
          f"correspondences {int(out['valid'].sum())}, hypotheses "
          f"{int((out['hyp_counts'] >= 0).sum())}")


GEO_COUNTS = (512, 450, 377, 300, 1, 0, 450, 377)


def _geo_embedding_case(device, m=512, counts=GEO_COUNTS, seed=2100):
    """GeoTransformer's embedding at the cell's widths (geotr-3dmatch: d
    256, 3 angle neighbours) on seeded weights (nn.Linear's uniform
    range): len(counts) clouds of m superpoints in a 3 m cube, each valid
    for a prefix of its count, the angle neighbours as the module picks
    them.  -> (module, the kernel's arguments)."""
    from portbench import manifest
    from regtr_tpu_torch.nn.geotransformer import GeometricStructureEmbedding
    from regtr_tpu_torch.nn.matching import nearest_first
    from regtr_tpu_torch.ops import geo_embedding as geo

    cfg = manifest.load_config("geotr-3dmatch")["config"]
    emb = GeometricStructureEmbedding(cfg["geo_hidden_dim"],
                                      cfg["geo_sigma_d"], cfg["geo_sigma_a"],
                                      cfg["geo_angle_k"])
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in emb.parameters():
            p.copy_((torch.rand(p.shape, generator=g) * 2 - 1)
                    / emb.d_model ** 0.5)
    emb = emb.to(device).requires_grad_(False)
    points = (torch.rand(len(counts), m, 3, generator=g) * 3.0).to(device)
    mask = (torch.arange(m)[None, :]
            < torch.tensor(counts)[:, None]).to(device)
    _, sq = geo.pair_offsets(points)
    knn = nearest_first(torch.where(mask[:, None, :], sq, float("inf")),
                        emb.angle_k + 1)[1][..., 1:]
    return emb, (points, mask, knn, emb.proj_d.weight, emb.proj_d.bias,
                 emb.proj_a.weight, emb.proj_a.bias, emb.sigma_d,
                 emb.factor_a)


def _float64_embedding(args):
    """The plain version's own fp32 codes, projected, maxed and summed in
    float64, a cloud at a time; zeros at padded keys."""
    import torch.nn.functional as F

    from regtr_tpu_torch.ops import geo_embedding as geo

    points, mask, knn, w_d, b_d, w_a, b_a, sigma_d, factor_a = args
    w_d, b_d, w_a, b_a = (t.double() for t in (w_d, b_d, w_a, b_a))
    outs = []
    for c in range(points.shape[0]):
        codes = geo.embedding_codes(points[c:c + 1], knn[c:c + 1],
                                    w_d.shape[0], sigma_d, factor_a)
        out = F.linear(next(codes).double(), w_d, b_d)
        out = out + torch.stack([F.linear(code.double(), w_a, b_a)
                                 for code in codes]).amax(0)
        outs.append(torch.where(mask[c:c + 1, None, :, None], out, 0.0))
    return torch.cat(outs)


def _b2b_ms(fn, reps=30):
    fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


@pytest.mark.cuda
def test_geo_embedding_kernel_at_the_cells_shape(cuda):
    """The embedding kernel at (8, 512, 512, 256) with valid counts 512 to
    0: within TOL of the plain version everywhere and zeros past each
    count; its largest error against float64 (the same codes and weights)
    at most twice the plain fp32 route's; two launches bitwise equal; one
    launch a call, its key tiles counted under a profiler; the weights
    split once per version.  Kernel and plain times, 30 back to back."""
    from torch.profiler import ProfilerActivity, profile

    from regtr_tpu_torch.ops import geo_embedding as geo

    emb, args = _geo_embedding_case(cuda)
    mask = args[1]
    cache = {}
    before = geo.geo_embedding.launches
    out = geo.geo_embedding(*args, cache=cache)
    again = geo.geo_embedding(*args, cache=cache)
    ref = geo.geo_embedding_reference(*args)
    torch.cuda.synchronize()
    assert geo.geo_embedding.launches == before + 2
    assert out.shape == (8, 512, 512, 256) and out.dtype == torch.float32
    assert torch.equal(out, again)
    torch.testing.assert_close(out, ref, atol=TOL["float32"],
                               rtol=TOL["float32"])
    for c, n in enumerate(GEO_COUNTS):
        assert not bool(out[c, :, n:].any())
    f64 = _float64_embedding(args)
    err = float((out.double() - f64).abs().max())
    plain_err = float((ref.double() - f64).abs().max())
    print(f"largest error against float64: kernel {err:.3e}, plain fp32 "
          f"{plain_err:.3e}")
    assert err <= 2 * plain_err
    del f64, again

    geo.geo_embedding.tiles = None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        geo.geo_embedding(*args, cache=cache)
        torch.cuda.synchronize()
    run, grid = geo.key_tile_counts(mask.sum(1), 512, 256)
    tiles = geo.geo_embedding.tiles.tolist()
    assert tiles == [int(run), grid] == [42 * 256 * 2, 8 * 8 * 256 * 2]
    geo.geo_embedding.tiles = None

    split = cache["d"][2]
    geo.geo_embedding(*args, cache=cache)
    assert cache["d"][2] is split
    with torch.no_grad():
        emb.proj_d.weight.mul_(1.0)              # a new version
    geo.geo_embedding(*args, cache=cache)
    assert cache["d"][2] is not split

    kernel = _b2b_ms(lambda: geo.geo_embedding(*args, cache=cache))
    plain = _b2b_ms(lambda: geo.geo_embedding_reference(*args))
    print(f"geometric embedding (8, 512, 512, 256), valid {GEO_COUNTS} "
          f"({tiles[0]} of {tiles[1]} key tiles): kernel {kernel:.3f} ms, "
          f"plain {plain:.3f} ms a call (30 back to back)")


@pytest.mark.cuda
def test_geo_embedding_kernel_refuses_what_it_does_not_take(cuda):
    from regtr_tpu_torch.ops import geo_embedding as geo

    _, args = _geo_embedding_case(cuda, m=64, counts=(64, 30))
    points, mask, knn, w_d, b_d, w_a, b_a, sigma_d, factor_a = args
    narrow = (w_d[:192, :192].contiguous(), b_d[:192],
              w_a[:192, :192].contiguous(), b_a[:192])
    for bad in ((points, mask, knn[..., :2], w_d, b_d, w_a, b_a),
                (points, mask, knn) + narrow,
                (points.double(), mask, knn, w_d, b_d, w_a, b_a),
                (points, mask.float(), knn, w_d, b_d, w_a, b_a),
                (points, mask, knn, w_d.t(), b_d, w_a, b_a),
                (points, mask, knn.cpu(), w_d, b_d, w_a, b_a),
                (points, mask, knn, w_d.clone().requires_grad_(), b_d, w_a,
                 b_a)):                                   # no backward
        with pytest.raises(ValueError):
            geo.geo_embedding(*bad, sigma_d, factor_a)
