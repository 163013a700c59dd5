"""Port parity: masked flash attention and MultiHeadAttention.

On the CPU the port's wrapper runs its plain version; it is held against
the JAX Pallas kernel in interpret mode, the way tests/test_pallas_attention
runs it.  The CUDA kernel itself is compared with the plain version on the
card (tests/test_torch_cuda.py, and chip_smoke.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.nn.transformer import MultiHeadAttention as JaxMHA
from regtr_tpu.ops.pallas.attention import flash_masked_attention as jax_flash
from regtr_tpu.train.checkpoints import _slash_key
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.nn.transformer import MultiHeadAttention
from regtr_tpu_torch.ops import attention
from regtr_tpu_torch.ops.attention import (NEG_BIAS, flash_masked_attention,
                                           flash_masked_attention_reference)

# Tolerances of tests/test_pallas_attention.py: fp32 parity with an online
# softmax is ~1e-6; bf16 operands and a bf16 output round at 2^-8.
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(bh, nq, nk, d, seed, masked_row=None):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32)
               for n in (nq, nk, nk))
    mask = rng.rand(bh, nk) > 0.2
    mask[:, :4] = True
    if masked_row is not None:
        mask[masked_row] = False
    bias = np.where(mask, 0.0, NEG_BIAS).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bh,nq,nk,d", [
    (4, 256, 256, 32),     # block-aligned
    (2, 200, 328, 32),     # ragged
    (3, 96, 96, 64),       # smaller than one block
    (2, 70, 130, 16),      # the tiny config's head dim
])
def test_reference_matches_pallas_kernel(bh, nq, nk, d, dtype):
    q, k, v, bias = _inputs(bh, nq, nk, d, seed=nq, masked_row=bh - 1)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    out = flash_masked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(bias), 1.0 / d ** 0.5)
    ref = jax_flash(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                    jnp.asarray(bias), 1.0 / d ** 0.5, block_q=128,
                    block_k=128, interpret=True)
    assert out.dtype == tdt and out.shape == (bh, nq, d)
    out = out.float().numpy()
    ref = np.asarray(ref, np.float32)
    # The last slice has every key masked.  With the finite bias it is a
    # weighted mean, not zeros, and the Pallas kernel also spreads it over
    # its zero-padded keys while the plain version covers only the real
    # ones, so that row is checked for finiteness only.
    assert np.all(np.isfinite(out[-1]))
    np.testing.assert_allclose(out[:-1], ref[:-1], atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_cpu_tensors_take_the_plain_version():
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 16, 1))
    before = flash_masked_attention.launches
    out = flash_masked_attention(q, k, v, bias, 0.25)
    assert flash_masked_attention.launches == before
    torch.testing.assert_close(
        out, flash_masked_attention_reference(q, k, v, bias, 0.25),
        rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "bias_dtype", "shape", "head_dim",
                                 "contiguity"])
def test_kernel_argument_checks(bad):
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 32, 2))
    if bad == "dtype":
        q = q.half()
    elif bad == "bias_dtype":
        bias = bias.double()
    elif bad == "shape":
        k = k[:, :30]
    elif bad == "head_dim":
        q, k, v = (x[..., :24].contiguous() for x in (q, k, v))
    else:
        q = q.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        attention._check(q, k, v, bias)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_multihead_attention_matches_jax(compute_dtype):
    rng = np.random.RandomState(21)
    q, k, v = (rng.randn(2, 96, 64).astype(np.float32) for _ in range(3))
    mask = rng.rand(2, 96) > 0.2
    jdt = None if compute_dtype is None else jnp.bfloat16
    jmod = JaxMHA(64, 4, 0.0, attn_impl="pallas_interpret", compute_dtype=jdt)
    params = jmod.init(jax.random.PRNGKey(0), *(jnp.asarray(x)
                                                for x in (q, k, v, mask)))
    ref = np.asarray(jmod.apply(params, *(jnp.asarray(x)
                                          for x in (q, k, v, mask))))
    flat = {_slash_key(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    mod = MultiHeadAttention(64, 4, None if jdt is None else torch.bfloat16)
    mod.load_state_dict(state_dict_from_jax(flat, mod))
    with torch.inference_mode():
        out = mod(*(torch.from_numpy(x) for x in (q, k, v, mask))).numpy()
    # fp32: projections and softmax in fp32 -> ~1e-6.  bf16: the q/k/v
    # operands and the attention output are rounded to bf16 (2^-8), and the
    # two fp32 projections may round a value to neighbouring bf16 numbers.
    tol = 1e-5 if compute_dtype is None else 3e-2
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("pre_norm,activation,val_pos", [
    (True, "relu", True),      # the shipped configs
    (False, "relu", True),     # post-norm
    (True, "gelu", False),     # values without the positional embedding
])
def test_cross_encoder_layer_matches_jax(pre_norm, activation, val_pos):
    from regtr_tpu.nn.transformer import CrossEncoderLayer as JaxLayer
    from regtr_tpu_torch.nn.transformer import CrossEncoderLayer

    rng = np.random.RandomState(31)
    x, pos = (rng.randn(4, 48, 64).astype(np.float32) for _ in range(2))
    mask = rng.rand(4, 48) > 0.25
    jlayer = JaxLayer(64, 4, 128, 0.0, activation, pre_norm, val_pos,
                      val_pos, "pallas_interpret", None)
    args = [jnp.asarray(a) for a in (x, pos, mask)]
    params = jax.jit(jlayer.init)(jax.random.PRNGKey(1), *args)
    ref = np.asarray(jax.jit(jlayer.apply)(params, *args))
    flat = {_slash_key(p): np.asarray(a) for p, a in
            jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    layer = CrossEncoderLayer(64, 4, 128, activation, pre_norm, val_pos,
                              val_pos)
    layer.load_state_dict(state_dict_from_jax(flat, layer))
    with torch.inference_mode():
        out = layer(*(torch.from_numpy(a) for a in (x, pos, mask))).numpy()
    # fp32 throughout (LayerNorm eps 1e-6 on both sides); sums in another
    # order.
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
