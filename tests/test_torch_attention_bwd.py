"""Port parity: the backward of masked flash attention.

On the CPU the port's autograd Function runs its plain forward and plain
backward (`flash_masked_attention_bwd_reference`); both are held against
the JAX custom_vjp with its Pallas kernels in interpret mode, and the plain
backward alone against the JAX `_flash_bwd_impl` on the same forward
outputs.  Small blocks make the JAX kernels loop over several query and key
tiles.  The CUDA kernels are compared with the plain backward on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.ops.pallas import attention as jax_attention
from regtr_tpu_torch.ops.attention import (
    NEG_BIAS, flash_masked_attention, flash_masked_attention_bwd_reference,
    flash_masked_attention_plain, flash_masked_attention_reference)

# fp32: the same products summed in another order (~1e-6 relative).  bf16:
# operands, p and ds rounded to bf16 (2^-8) and outputs stored in bf16;
# the sums' order decides some roundings.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BLOCK = 64


def _inputs(bh, nq, nk, d, seed, masked_slice=None):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(bh, n, d).astype(np.float32)
                   for n in (nq, nk, nk, nq))
    mask = rng.rand(bh, nk) > 0.25
    mask[:, :3] = True
    if masked_slice is not None:
        mask[masked_slice] = False
    bias = np.where(mask, 0.0, NEG_BIAS).astype(np.float32)
    return q, k, v, bias, do


def _close(out, ref, dtype, what):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-6),
                               err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d,masked", [
    (3, 128, 192, 32, 2),   # tile-aligned keys: the masked slice compares too
    (2, 150, 128, 16, 0),   # ragged queries, a fully masked slice
    (2, 100, 173, 32, None),  # ragged both
    (2, 70, 64, 64, None),  # one key tile, d 64
])
def test_backward_matches_jax_custom_vjp(bh, nq, nk, d, masked, dtype):
    q, k, v, bias, do = _inputs(bh, nq, nk, d, seed=nq + nk,
                                masked_slice=masked)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    scale = d ** -0.5
    tq, tk, tv = (torch.from_numpy(x).to(tdt).requires_grad_()
                  for x in (q, k, v))
    tb = torch.from_numpy(bias).requires_grad_()
    out = flash_masked_attention(tq, tk, tv, tb, scale)
    out.backward(torch.from_numpy(do).to(tdt))

    def f(q_, k_, v_, b_):
        return jax_attention.flash_masked_attention(
            q_, k_, v_, b_, scale, BLOCK, BLOCK, True)

    jout, vjp = jax.vjp(f, *(jnp.asarray(x, jdt) for x in (q, k, v)),
                        jnp.asarray(bias))
    grads = vjp(jnp.asarray(do, jdt))
    assert tq.grad.dtype == tdt and tb.grad.dtype == torch.float32
    # A fully masked slice is a mean over every key, and the JAX kernels'
    # keys include their zero padding up to the tile: it compares only
    # where the keys fill whole tiles.
    keep = (slice(None) if masked is None or nk % BLOCK == 0
            else [i for i in range(bh) if i != masked])
    for name, got, ref in zip(("out", "dq", "dk", "dv", "dbias"),
                              (out, tq.grad, tk.grad, tv.grad, tb.grad),
                              (jout, *grads)):
        assert torch.isfinite(got.float()).all(), name
        _close(got.detach()[keep], np.asarray(ref, np.float32)[keep], dtype,
               name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d", [(2, 130, 200, 32), (3, 64, 64, 16)])
def test_plain_backward_matches_jax_bwd_impl(bh, nq, nk, d, dtype):
    """The plain backward on JAX's own forward outputs (out and lse)."""
    q, k, v, bias, do = _inputs(bh, nq, nk, d, seed=7, masked_slice=0)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x, jdt) for x in (q, k, v, do))
    scale = d ** -0.5
    o, lse = jax_attention._flash_fwd_impl(jq, jk, jv, jnp.asarray(bias),
                                           scale, BLOCK, BLOCK, True)
    ref = jax_attention._flash_bwd_impl(jq, jk, jv, jnp.asarray(bias), o,
                                        lse, jdo, scale, BLOCK, BLOCK, True)
    got = flash_masked_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(bias), torch.from_numpy(np.array(o, np.float32))
        .to(tdt), torch.from_numpy(np.asarray(lse)[:, :nq, 0].copy()),
        torch.from_numpy(do).to(tdt), scale)
    keep = slice(None) if nk % BLOCK == 0 else slice(1, None)
    for name, g, r in zip(("dq", "dk", "dv", "dbias"), got, ref):
        _close(g[keep], np.asarray(r, np.float32)[keep], dtype, name)


def test_lse_of_the_plain_forward():
    """lse is the fp32 logsumexp of the scores; a fully masked row rounds
    to the -1e9 bias, as the JAX kernel's lse does."""
    q, k, v, bias, _ = _inputs(2, 40, 50, 16, seed=3, masked_slice=1)
    t = [torch.from_numpy(x) for x in (q, k, v, bias)]
    out, lse = flash_masked_attention_reference(*t, 0.25, return_lse=True)
    _, jlse = jax_attention._flash_fwd_impl(
        *(jnp.asarray(x) for x in (q, k, v, bias)), 0.25, BLOCK, BLOCK, True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[:, :40, 0],
                               rtol=1e-6, atol=1e-5)
    assert lse.dtype == torch.float32 and lse.shape == (2, 40)
    assert float(lse[1].max()) == NEG_BIAS


def _tf32(x):
    """cvt.rna.tf32.f32: the fp32 mantissa rounded to 10 bits, ties away
    from zero (the low 13 bits cleared)."""
    u = x.contiguous().numpy().view(np.uint32)
    r = (((u & 0x7FFFFFFF) + 0x1000) & 0x7FFFE000) | (u & 0x80000000)
    return torch.from_numpy(r.view(np.float32))


def _tensor_core_mm(a, b, passes):
    """a @ b in fp32 as the CUDA backward kernels' tensor cores take fp32
    operands: 3 passes is the 3xTF32 split (big = tf32(x), small =
    tf32(x - big); small*big + big*small + big*big), 1 pass plain TF32.
    Products of TF32 values are exact in fp32; the sums are fp32."""
    a_big, b_big = _tf32(a), _tf32(b)
    if passes == 1:
        return a_big @ b_big
    a_small, b_small = _tf32(a - a_big), _tf32(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _emulated_backward(q, k, v, bias, lse, delta, do, scale, passes):
    """csrc/flash_attn_bwd.cu's fp32 arithmetic: every product on the
    tensor cores, exp and the elementwise steps in fp32."""
    def mm(a, b):
        return _tensor_core_mm(a, b, passes)

    s = mm(q, k.transpose(1, 2)) * scale + bias[:, None, :]
    p = torch.exp(s - lse[..., None])
    ds = p * (mm(do, v.transpose(1, 2)) - delta[..., None])
    return (mm(ds, k) * scale, mm(ds.transpose(1, 2), q) * scale,
            mm(p.transpose(1, 2), do), ds.sum(dim=1))


@pytest.mark.parametrize("grad", ["dq", "dk", "dv", "dbias"])
@pytest.mark.parametrize("passes", [3, 1])
def test_tf32_split_within_the_card_tolerance(passes, grad):
    """The fp32 kernels' 3xTF32 products, emulated at (2, 512, 512, 32)
    with masked keys, stay within the card tests' fp32 tolerance of the
    plain backward (2e-5 of the larger of the largest |gradient| and 1;
    measured ~6e-7); one TF32 product alone (~5e-4) does not, which is
    why the kernels have no plain-TF32 path."""
    from regtr_tpu_torch.ops.attention import attention_delta

    q, k, v, bias, do = (torch.from_numpy(x) for x in
                         _inputs(2, 512, 512, 32, seed=11))
    scale = 32 ** -0.5
    out, lse = flash_masked_attention_reference(q, k, v, bias, scale,
                                                return_lse=True)
    names = ("dq", "dk", "dv", "dbias")
    ref = flash_masked_attention_bwd_reference(q, k, v, bias, out, lse, do,
                                               scale)[names.index(grad)]
    got = _emulated_backward(q, k, v, bias, lse, attention_delta(out, do),
                             do, scale, passes)[names.index(grad)]
    tol = 2e-5   # tests/test_torch_cuda.py, chip_smoke.py TOL_BWD fp32
    excess = ((got - ref).abs() - tol * ref.abs()).max() / max(
        float(ref.abs().max()), 1.0)
    if passes == 3:
        assert float(excess) <= tol
    else:
        assert float(excess) > 10 * tol


def test_plain_route_and_inference_route_agree():
    """flash_masked_attention_plain (what chip_smoke compares the kernels
    with) gives the CPU route's numbers; without a gradient to record the
    forward is the plain version itself, unchanged."""
    q, k, v, bias, do = (torch.from_numpy(x) for x in
                         _inputs(2, 33, 47, 32, seed=5))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    ins2 = [x.clone().requires_grad_() for x in (q, k, v)]
    flash_masked_attention(*ins, bias, 0.2).backward(do)
    flash_masked_attention_plain(*ins2, bias, 0.2).backward(do)
    for a, b in zip(ins, ins2):
        assert torch.equal(a.grad, b.grad)
    with torch.no_grad():
        torch.testing.assert_close(
            flash_masked_attention(q, k, v, bias, 0.2),
            flash_masked_attention_reference(q, k, v, bias, 0.2),
            rtol=0, atol=0)
