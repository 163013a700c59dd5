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


# ------------------------------------------- the CUDA forward's numerics ---

def _fma(a, b, c):
    """fmaf: a * b + c rounded once to fp32 (the fp64 product of two fp32
    values is exact)."""
    return (a.double() * b + c.double()).float()


def _emulated_forward(q, k, v, bias, scale, passes, tile=64, kv_extent=None):
    """csrc/flash_attn_fwd.cu's arithmetic on the CPU: 64-key tiles, scores
    in base 2 with scale * log2(e) folded into one FMA and the bias
    pre-multiplied by log2(e), the running max from -1e30, 2^x for the
    exponent, lse = (m + log2 l) ln 2.  fp32 operands (passes 3 or 1): both
    products on the tensor cores as 3xTF32 (or one TF32 pass), p v summed
    over each tile and added to the fp32 accumulator rescaled by alpha.
    bf16 operands (passes None): bf16 products summed in fp32, p rounded to
    bf16 before p v.  With `kv_extent` a slice runs only the tiles that
    start before its extent (all of them at 0), as the kernel's blocks do.
    Returns (out fp32, lse)."""
    from tests.test_torch_attention_bwd import _tensor_core_mm

    def mm(a, b):
        if passes is None:
            return a.float() @ b.float()
        return _tensor_core_mm(a, b, passes)

    log2e = torch.tensor(np.log2(np.e), dtype=torch.float32)
    c = float(torch.tensor(scale, dtype=torch.float32) * log2e)
    b2 = bias * log2e
    bh, nq, d = q.shape
    nk = k.shape[1]
    m = torch.full((bh, nq, 1), -1e30)
    l = torch.zeros(bh, nq, 1)
    acc = torch.zeros(bh, nq, d)
    ends = torch.full((bh,), nk)
    if kv_extent is not None:
        ends = torch.where(kv_extent > 0, kv_extent.clamp(max=nk), nk)
    for k0 in range(0, nk, tile):
        kt, vt, bt = k[:, k0:k0 + tile], v[:, k0:k0 + tile], b2[:, k0:k0 + tile]
        x = _fma(mm(q, kt.transpose(1, 2)), c, bt[:, None, :])
        m_new = torch.maximum(m, x.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new)
        l_new = l * alpha + p.sum(-1, keepdim=True)
        if passes is None:
            p = p.to(torch.bfloat16)
        runs = (k0 < ends)[:, None, None]
        acc = torch.where(runs, _fma(acc, alpha, mm(p, vt)), acc)
        m, l = torch.where(runs, m_new, m), torch.where(runs, l_new, l)
    lse = (m + torch.log2(l)) * float(np.log(2.0))
    return acc / l, lse[..., 0]


EMU_SHAPES = [(2, 512, 512, 32), (2, 512, 450, 32)]   # whole and ragged tiles


def _emu_inputs(shape):
    bh, nq, nk, d = shape
    return [torch.from_numpy(x) for x in _inputs(bh, nq, nk, d, seed=nk,
                                                masked_row=0)]


def _assert_forward_close(out, lse, ref, ref_lse, tol):
    """Slice 0 has every key masked: its scores round to the bias (in base
    2 at another step than in base e), so it is held finite only."""
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    np.testing.assert_allclose(out[1:].numpy(), np.asarray(ref, np.float32)[1:],
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse, np.float32),
                               atol=1e-4, rtol=1e-6)


@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_kernel_numerics_match_plain_forward(shape):
    """The fp32 kernel's arithmetic (3xTF32, base 2, per-tile sums) within
    the card tests' tolerances of the plain forward: out 2e-5 (measured
    ~1e-7), lse 1e-4 + 1e-6 relative."""
    q, k, v, bias = _emu_inputs(shape)
    scale = shape[3] ** -0.5
    out, lse = _emulated_forward(q, k, v, bias, scale, passes=3)
    ref, ref_lse = flash_masked_attention_reference(q, k, v, bias, scale,
                                                    return_lse=True)
    _assert_forward_close(out, lse, ref, ref_lse, TOL["float32"])


@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_kernel_numerics_match_pallas_kernel(shape):
    """The same arithmetic against the JAX kernel in interpret mode, out
    and lse.  With ragged keys the JAX kernel also spreads the masked
    slice over its zero padding; that slice is held finite only anyway."""
    q, k, v, bias = _emu_inputs(shape)
    scale = shape[3] ** -0.5
    out, lse = _emulated_forward(q, k, v, bias, scale, passes=3)
    from regtr_tpu.ops.pallas import attention as jax_attention

    ref, ref_lse = jax_attention._flash_fwd_impl(
        *(jnp.asarray(x.numpy()) for x in (q, k, v, bias)), scale, 128, 128,
        True)
    _assert_forward_close(out, lse, ref, np.asarray(ref_lse)[:, :shape[1], 0],
                          TOL["float32"])


def test_one_tf32_pass_fails_the_forward_tolerance():
    """Plain TF32 products (~1e-3 on the scores) miss fp32's 2e-5 by far:
    why the kernel has no plain-TF32 path."""
    q, k, v, bias = _emu_inputs(EMU_SHAPES[0])
    out, _ = _emulated_forward(q, k, v, bias, 32 ** -0.5, passes=1)
    ref = flash_masked_attention_reference(q, k, v, bias, 32 ** -0.5)
    err = (out[1:] - ref[1:]).abs() - TOL["float32"] * ref[1:].abs()
    assert float(err.max()) > 5 * TOL["float32"]


def test_kernel_numerics_bf16_match_plain_forward():
    """The bf16 kernel's arithmetic (base 2, p rounded to bf16 before p v,
    unnormalized) within bf16's 2e-2 of the plain forward."""
    q, k, v, bias = _emu_inputs(EMU_SHAPES[1])
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, lse = _emulated_forward(q, k, v, bias, 32 ** -0.5, passes=None)
    ref, ref_lse = flash_masked_attention_reference(q, k, v, bias, 32 ** -0.5,
                                                    return_lse=True)
    _assert_forward_close(out.to(torch.bfloat16).float(), lse, ref.float(),
                          ref_lse, TOL["bfloat16"])


# ------------------------------------------------------------ key extents ---

def _extent_mask(case, nk):
    """(2, nk) key masks: slice 0 and slice 1 of each case."""
    mask = torch.zeros(2, nk, dtype=torch.bool)
    if case == "hole":            # a whole masked tile between valid keys
        mask[0, :10] = mask[0, 200:230] = True
        mask[1, 130:140] = True   # the first two tiles masked
    elif case == "no_key":        # extent 0: every tile runs
        mask[1, :100] = True
    else:                         # a prefix of `case` keys, and a longer one
        n = min(case, nk)
        mask[0, :n] = True
        mask[1, :min(n + 37, nk)] = True
    return mask


@pytest.mark.parametrize("passes", [3, None])
@pytest.mark.parametrize("case", [1, 63, 64, 65, 450, "hole", "no_key"])
@pytest.mark.parametrize("shape", EMU_SHAPES)
def test_key_extents_leave_the_forward_bitwise_unchanged(shape, case, passes):
    """K1 running only the key tiles before each slice's extent gives the
    out and lse it gives over every tile, bit for bit: past a row's first
    valid key a masked key's 2^(x - m) is exactly 0 and alpha exactly 1.
    The emulation of the kernel's arithmetic, with and without extents."""
    bh, nq, nk, d = shape
    q, k, v, _ = _emu_inputs(shape)
    if passes is None:
        q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    mask = _extent_mask(case, nk)
    bias = torch.where(mask, 0.0, NEG_BIAS).float()
    ext = attention.key_extents(mask)
    last = [int(np.nonzero(r)[0].max()) + 1 if r.any() else 0
            for r in mask.numpy()]
    assert ext.dtype == torch.int32 and ext.tolist() == last
    full = _emulated_forward(q, k, v, bias, d ** -0.5, passes)
    cut = _emulated_forward(q, k, v, bias, d ** -0.5, passes, kv_extent=ext)
    assert torch.equal(cut[0], full[0]) and torch.equal(cut[1], full[1])


def _lengths_mask(case, n, rng):
    if case == "non_prefix":
        mask = rng.rand(4, n) > 0.5
        mask[1, 30:] = False
        mask[2, :] = False
        mask[2, 7] = True
        return mask
    lengths = [40, 17, 1, 30] if case == "prefix" else [25, 0, 40, 12]
    return np.arange(n)[None, :] < np.array(lengths)[:, None]


@pytest.mark.parametrize("case", ["prefix", "empty_cloud", "non_prefix"])
def test_cross_encoder_hands_each_attention_its_key_extents(case,
                                                            monkeypatch):
    """The encoder derives the extents once a forward: self-attention's
    from the cloud's own mask, cross-attention's from its partner's (one
    past the last valid index, 0 for an empty cloud), repeated over the
    heads, the same tensors for every layer; a module called without them
    derives the same; the output is the one without extents."""
    from regtr_tpu_torch.nn import transformer

    rng = np.random.RandomState(5)
    nhead, n = 4, 40
    x, pos = (torch.from_numpy(rng.randn(4, n, 32).astype(np.float32))
              for _ in range(2))
    mask = torch.from_numpy(_lengths_mask(case, n, rng))
    enc = transformer.TransformerCrossEncoder(32, nhead, 2, 64)
    seen = []
    real = transformer.flash_masked_attention

    def recorded(*args, kv_extent=None):
        seen.append(kv_extent)
        return real(*args, kv_extent=kv_extent)

    monkeypatch.setattr(transformer, "flash_masked_attention", recorded)
    with torch.no_grad():
        out = enc(x, pos, mask)
        layer = enc.layer_0
        alone = layer(x, pos, mask)
    last = np.array([np.nonzero(r)[0].max() + 1 if r.any() else 0
                     for r in mask.numpy()])
    own = np.repeat(last, nhead)
    partner = np.repeat(last.reshape(-1, 2)[:, ::-1].reshape(-1), nhead)
    assert len(seen) == 2 * 2 + 2
    for i, ext in enumerate(seen):
        assert ext.dtype == torch.int32 and ext.shape == (4 * nhead,)
        assert ext.tolist() == (own if i % 2 == 0 else partner).tolist()
    assert seen[0] is seen[2] and seen[1] is seen[3]
    monkeypatch.setattr(transformer, "flash_masked_attention",
                        lambda *a, kv_extent=None: real(*a))
    with torch.no_grad():
        assert torch.equal(enc(x, pos, mask), out)
        assert torch.equal(layer(x, pos, mask), alone)


@pytest.mark.parametrize("bad", ["shape", "dtype", "contiguity"])
def test_kernel_refuses_a_bad_key_extent(bad):
    q, k, v, bias = (torch.from_numpy(x) for x in _inputs(2, 40, 40, 32, 2))
    ext = torch.full((2,), 40, dtype=torch.int32)
    attention._check(q, k, v, bias, ext)
    if bad == "shape":
        ext = torch.full((2, 1), 40, dtype=torch.int32)
    elif bad == "dtype":
        ext = ext.long()
    else:
        ext = torch.full((4,), 40, dtype=torch.int32)[::2]
    with pytest.raises(ValueError):
        attention._check(q, k, v, bias, ext)


def test_key_tiles_counts_the_tiles_the_kernel_runs():
    """The coarse level of a 3DMatch batch: ~350 valid keys of 2240 run 6
    of 35 key tiles in each of a slice's 35 query blocks; an extent of 0
    runs them all; no extents: the whole grid."""
    ext = torch.tensor([350, 0, 64, 65], dtype=torch.int32)
    run, grid = attention.key_tile_counts(ext, 4, 2240, 2240)
    assert grid == 4 * 35 * 35
    assert int(run) == 35 * (6 + 35 + 1 + 2)
    assert attention.key_tile_counts(None, 4, 2240, 2240) == (grid, grid)
    before = attention.flash_masked_attention.key_tiles
    try:
        attention.flash_masked_attention.key_tiles = None
        with torch.inference_mode():   # the counter outlives the mode
            attention._count_key_tiles(ext, 4, 2240, 2240,
                                       torch.device("cpu"))
        attention._count_key_tiles(ext, 4, 2240, 2240, torch.device("cpu"))
        attention._count_key_tiles(None, 4, 2240, 2240, torch.device("cpu"))
        assert attention.flash_masked_attention.key_tiles.tolist() == [
            2 * int(run) + grid, 3 * grid]
    finally:
        attention.flash_masked_attention.key_tiles = before
