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
    (3, 200, 333, 16),       # ragged key edge, the tiny config's head dim
    (2, 65, 130, 64),        # one query past a tile
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
def test_flash_kernel_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(2, 8, 24, device=cuda)           # head dim 24
    bias = torch.zeros(2, 8, device=cuda)
    with pytest.raises(ValueError):
        flash_masked_attention(q, q, q, bias, 0.2)
    q = torch.zeros(2, 8, 32, device=cuda)
    with pytest.raises(ValueError):                   # non-contiguous k
        flash_masked_attention(q, q.transpose(1, 2).contiguous()
                               .transpose(1, 2), q, bias, 0.2)


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
    """The segment-sum kernel against the plain version on a neighbor-like
    table (shadow rows and empty segments included), and bitwise equal
    over two runs."""
    from regtr_tpu_torch.ops.kpconv import (padded_segment_sum_reference,
                                            sorted_padded_segment_sum)

    g = torch.Generator().manual_seed(c)
    b, n, k = 3, 4001, 24
    table = torch.randint(0, n // 2, (b, n - 1, k), generator=g)
    table[:, :, 15:] = n - 1                       # shadow neighbors
    ids = (table.reshape(b, -1) + torch.arange(b)[:, None] * n).reshape(-1)
    rows = torch.randn(ids.shape[0], c, generator=g)
    rows, ids = rows.to(cuda, getattr(torch, dtype)), ids.to(cuda)
    before = sorted_padded_segment_sum.launches
    got = sorted_padded_segment_sum(rows, ids, b * n, n)
    again = sorted_padded_segment_sum(rows, ids, b * n, n)
    ref = padded_segment_sum_reference(rows, ids, b * n, n)
    torch.cuda.synchronize()
    assert sorted_padded_segment_sum.launches == before + 2
    assert got.dtype == torch.float32 and got.shape == (b * n, c)
    assert torch.equal(got, again)
    # fp32 sums of the same rows in another order
    torch.testing.assert_close(got, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    assert not got.view(b, n, c)[:, n // 2:].any()   # pad and empty rows


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
def test_batched_row_gather_on_the_card(cuda):
    """batched_row_gather launches K5 forward and K4 backward; both match
    the CPU (the forward bitwise, the fp32 sums to a few ulps)."""
    from regtr_tpu_torch.ops import gather, kpconv

    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 400, 32, generator=g)
    inds = torch.randint(0, 400, (3, 5000), generator=g)
    cot = torch.randn(3, 5000, 32, generator=g)
    outs = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev).requires_grad_()
        before = (gather.row_gather.launches,
                  kpconv.sorted_padded_segment_sum.launches)
        out = kpconv.batched_row_gather(xd, inds.to(dev))
        (dx,) = torch.autograd.grad(out, xd, cot.to(dev))
        outs[str(dev)] = (out.detach().cpu(), dx.cpu(), (
            gather.row_gather.launches - before[0],
            kpconv.sorted_padded_segment_sum.launches - before[1]))
    (out_c, dx_c, n_c), (out_g, dx_g, n_g) = outs.values()
    assert n_c == (0, 0) and n_g == (1, 1)
    assert torch.equal(out_c, out_g)
    torch.testing.assert_close(dx_g, dx_c, rtol=1e-5, atol=1e-5)
