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
