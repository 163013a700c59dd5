"""Port parity for the deformable KPConv and the backbone's other options
on the CPU: `kpconv_deformable` (plain and modulated) forward and
gradients, a deformable-architecture RegTR's forward and loss gradients
leaf by leaf through convert.py, the encoder's unary / unary2 / max_pool /
global_average blocks, `closest_pool`, `global_average`, `KPFDecoder`,
and per-block kernel dispositions from a `kernel_dispositions_file`.
JAX on the CPU is the oracle, on the JAX pyramid's own tables.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.nn.backbone import KPFDecoder as JaxKPFDecoder
from regtr_tpu.nn.backbone import KPFEncoder as JaxKPFEncoder
from regtr_tpu.ops import kpconv as jkp
from regtr_tpu.ops import pyramid as jpyr
from regtr_tpu.utils.kernel_points import load_kernel_points
from regtr_tpu.utils.kernel_points import \
    lookup_block_dispositions as jax_lookup
from regtr_tpu_torch.config import threedmatch_config, tiny_config
from regtr_tpu_torch.convert import (jax_params_from_state_dict,
                                     state_dict_from_jax)
from regtr_tpu_torch.models import create_model, init_parameters
from regtr_tpu_torch.nn.backbone import KPFDecoder, KPFEncoder
from regtr_tpu_torch.ops import kpconv
from regtr_tpu_torch.utils.kernel_points import lookup_block_dispositions
from tests.test_torch_kpconv import jax_levels, to_torch_levels
from tests.test_torch_model import flat_params
from tests.test_torch_train import golden_batch

# fp32 on both sides, the same arithmetic summed in another order:
# measured up to 1.2e-6 of the largest value (forward) and 6.3e-6
# relative L2 (gradients of a model's leaves, of a deformable op's
# features and weights).
TOL_FWD = 1e-4
TOL_GRAD = 1e-4
# A deformable op's offset weights and biases: their gradient goes through
# 1 / sqrt(d^2) of distances from the |rel|^2 - 2 rel.kp + |kp|^2
# expansion, whose cancellation near a kernel point amplifies the last-bit
# differences of the two backends' sums (measured 9.1e-5 relative L2).
TOL_GRAD_OFFSETS = 1e-3
DEFORMABLE_ARCH = ["simple", "resnetb", "resnetb",
                   "resnetb_deformable_strided", "resnetb_deformable",
                   "resnetb_deformable"]


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def empty_module(cls, *args):
    """A module made on the meta device and materialized, its kernel
    points filled and its parameters seeded, as create_model does."""
    with torch.device("meta"):
        mod = cls(*args)
    mod.to_empty(device="cpu")
    for m in mod.modules():
        if hasattr(m, "reset_kernel_points"):
            m.reset_kernel_points()
    init_parameters(mod, torch.Generator().manual_seed(0))
    return mod


@pytest.fixture(scope="module")
def levels():
    jl = jax_levels(threedmatch_config(), n0=256, b=2)
    return jl, to_torch_levels(jl)


@pytest.mark.parametrize("modulated", [False, True])
def test_kpconv_deformable_matches_jax(levels, modulated):
    """Forward and gradients (features, weights, offset weights and bias)
    on a level-0 conv table, offsets of ~0.3 extent."""
    jl, tl = levels
    rng = np.random.RandomState(2 + modulated)
    p, cin, cout = 15, 8, 6
    pts, table = tl[0].points, tl[0].neighbors
    x = rng.rand(*pts.shape[:2], cin).astype(np.float32)
    w = rng.randn(p, cin, cout).astype(np.float32)
    ow = (rng.randn(p, cin, (3 + modulated) * p) * 0.05).astype(np.float32)
    ob = (rng.randn((3 + modulated) * p) * 0.1).astype(np.float32)
    kp = load_kernel_points(0.0625, p)
    cot = rng.randn(*pts.shape[:2], cout).astype(np.float32)

    def jfn(x, w, ow, ob):
        out = jkp.kpconv_deformable(
            jl[0].points, jl[0].points, jl[0].neighbors, x, jnp.asarray(kp),
            w, ow, ob, 0.05, modulated=modulated)
        return jnp.sum(out * cot), out

    (_, jout), jgrads = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True))(
            *map(jnp.asarray, (x, w, ow, ob)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (x, w, ow, ob)]
    index = kpconv.GatherIndex(table, pts.shape[1] + 1)
    out = kpconv.kpconv_deformable(
        pts, pts, index, leaves[0], torch.from_numpy(kp), *leaves[1:], 0.05,
        modulated=modulated)
    (out * torch.from_numpy(cot)).sum().backward()
    ref = np.asarray(jout)
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=TOL_FWD,
                               atol=TOL_FWD * np.abs(ref).max())
    for name, leaf, jg in zip(("x", "weights", "offset_weights",
                               "offset_bias"), leaves, jgrads):
        g, jg = leaf.grad.numpy(), np.asarray(jg)
        tol = TOL_GRAD_OFFSETS if name.startswith("offset") else TOL_GRAD
        assert np.isfinite(g).all(), name
        assert rel_l2(g, jg) < tol, (name, rel_l2(g, jg))


def test_kpconv_deformable_gradient_at_zero_distance(levels):
    """Zero offsets: each query's own point sits on kernel point 0 (the
    center), sqrt's derivative is infinite there, and the gradients are
    non-finite exactly where JAX's are (no epsilon), finite elsewhere and
    within TOL_GRAD of JAX's."""
    jl, tl = levels
    rng = np.random.RandomState(7)
    p, cin, cout = 15, 4, 3
    pts, table = tl[0].points, tl[0].neighbors
    x = rng.rand(*pts.shape[:2], cin).astype(np.float32)
    w = rng.randn(p, cin, cout).astype(np.float32)
    ow = np.zeros((p, cin, 3 * p), np.float32)
    ob = np.zeros(3 * p, np.float32)
    kp = load_kernel_points(0.0625, p)

    def jfn(w, ow, ob):
        return jnp.sum(jkp.kpconv_deformable(
            jl[0].points, jl[0].points, jl[0].neighbors, jnp.asarray(x),
            jnp.asarray(kp), w, ow, ob, 0.05) ** 2)

    jgrads = jax.jit(jax.grad(jfn, argnums=(0, 1, 2)))(
        *map(jnp.asarray, (w, ow, ob)))
    leaves = [torch.tensor(a, requires_grad=True) for a in (w, ow, ob)]
    index = kpconv.GatherIndex(table, pts.shape[1] + 1)
    (kpconv.kpconv_deformable(pts, pts, index, torch.from_numpy(x),
                              torch.from_numpy(kp), *leaves, 0.05)
     ** 2).sum().backward()
    nonfinite = 0
    for leaf, jg in zip(leaves, jgrads):
        g, jg = leaf.grad.numpy(), np.asarray(jg)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(jg))
        np.testing.assert_array_equal(np.isposinf(g), np.isposinf(jg))
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(jg))
        fin = np.isfinite(jg)
        nonfinite += int((~fin).sum())
        if fin.any():
            assert rel_l2(g[fin], jg[fin]) < TOL_GRAD
    assert nonfinite > 0          # the case the test is for


@pytest.fixture(scope="module")
def deformable_model():
    """A tiny deformable (modulated) RegTR: JAX params and loss gradients
    on the golden pair, and the port's model on the same params."""
    batch = golden_batch()
    cfg = tiny_config(architecture=DEFORMABLE_ARCH, modulated=True)
    jmodel = jax_create_model(cfg, 96)
    params = init_model_params(jmodel, jax.random.PRNGKey(5))["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(prm):
        losses, out = jmodel.apply({"params": prm}, jb["points"], jb["mask"],
                                   jb["pose"], jb["overlap0"],
                                   method=jmodel.compute_loss)
        return losses["total"], (losses, out["corr"])

    grads, (losses, corr) = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    jlevels = jax.jit(lambda x, m: jpyr.build_pyramid(
        x, m, jmodel.spec, chunk=int(cfg["neighbor_chunk"])))(
            jb["points"], jb["mask"])
    flat = flat_params(params)
    model = create_model(cfg, 96, "cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return dict(batch=batch, flat=flat, grads=flat_params(grads),
                losses={k: float(v) for k, v in losses.items()},
                corr=np.asarray(corr), model=model,
                levels=to_torch_levels(jlevels))


def test_deformable_regtr_matches_jax(deformable_model):
    """Every loss term, the predicted correspondences and the gradient of
    the total for every parameter, leaf by leaf (the offset weights and
    biases of the three deformable blocks among them)."""
    d = deformable_model
    model, b = d["model"], {k: torch.from_numpy(v)
                            for k, v in d["batch"].items()}
    assert sum("offset_weights" in k for k in d["flat"]) == 3
    model.zero_grad()
    losses, out = model.loss_levels(d["levels"], b["pose"], b["overlap0"])
    losses["total"].backward()
    assert set(losses) == set(d["losses"])
    for key, ref in d["losses"].items():
        np.testing.assert_allclose(losses[key].item(), ref, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(out["corr"].detach().numpy(), d["corr"],
                               rtol=TOL_FWD, atol=TOL_FWD)
    ref_grads = state_dict_from_jax(d["grads"], model)
    for name, prm in model.named_parameters():
        ref = ref_grads[name].numpy()
        if np.linalg.norm(ref) < 1e-6:      # feature_un's W: weight 0
            np.testing.assert_allclose(prm.grad.numpy(), ref, atol=1e-7)
            continue
        assert rel_l2(prm.grad.numpy(), ref) < TOL_GRAD, name


def test_convert_round_trip_bitwise(deformable_model):
    """JAX params -> port -> JAX params, bitwise, the deformable leaves
    included; the port's own seeded params the other way round."""
    d = deformable_model
    back = jax_params_from_state_dict(d["model"])
    assert set(back) == set(d["flat"])
    for key, value in d["flat"].items():
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    model = create_model(tiny_config(architecture=DEFORMABLE_ARCH,
                                     modulated=True), 96, "cpu", seed=3)
    sd = state_dict_from_jax(jax_params_from_state_dict(model), model)
    for key, value in model.state_dict().items():
        assert torch.equal(sd[key], value), key


def test_encoder_option_blocks_match_jax(levels):
    """unary, unary2, max_pool and global_average blocks between KPConv
    blocks, fp32, on the same converted parameters."""
    jl, tl = levels
    cfg = threedmatch_config(
        first_feats_dim=16, remat=False,
        architecture=["simple", "unary", "unary2", "resnetb", "max_pool",
                      "resnetb", "global_average"])
    feats0 = np.asarray(jl[0].mask, np.float32)[..., None]
    jenc = JaxKPFEncoder(cfg)
    params = jax.jit(lambda k: jenc.init(k, jnp.asarray(feats0), jl))(
        jax.random.PRNGKey(4))
    jout, jskips = jax.jit(lambda prm: jenc.apply(prm, jnp.asarray(feats0),
                                                  jl))(params)
    enc = empty_module(KPFEncoder, cfg)
    enc.load_state_dict(state_dict_from_jax(flat_params(params["params"]),
                                            enc))
    assert not hasattr(enc, "block_4_max_pool")
    with torch.inference_mode():
        out, skips = enc(torch.from_numpy(feats0), tl)
    assert out.shape == np.asarray(jout).shape == (2, 32)   # (B, C)
    assert len(skips) == len(jskips) == 2
    for o, ref in zip((*skips, out), (*jskips, jout)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(o.numpy(), ref, rtol=TOL_FWD,
                                   atol=TOL_FWD * np.abs(ref).max())


def test_pooling_ops_match_jax(levels):
    """closest_pool (forward and its gather transpose) and global_average,
    bitwise on the forward."""
    jl, tl = levels
    rng = np.random.RandomState(9)
    x = rng.randn(*tl[1].points.shape[:2], 5).astype(np.float32)
    cot = rng.randn(*tl[0].points.shape[:2], 5).astype(np.float32)

    def jfn(x):
        out = jkp.closest_pool(x, jl[0].upsamples)
        return jnp.sum(out * cot), out

    (_, jout), jg = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(x))
    xt = torch.tensor(x, requires_grad=True)
    out = kpconv.closest_pool(xt, tl[0].upsamples)
    (out * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(), np.asarray(jout))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jg), rtol=1e-6,
                               atol=1e-6)
    avg = kpconv.global_average(torch.from_numpy(x), tl[1].mask)
    np.testing.assert_allclose(
        avg.numpy(), np.asarray(jkp.global_average(jnp.asarray(x),
                                                   jl[1].mask)),
        rtol=1e-6, atol=1e-7)


def test_kpf_decoder_matches_jax():
    """The nearest-upsample decoder (upsample, skip concat, unary) on an
    encoder with an upsample tail, against the JAX decoder on the same
    parameters and the same encoder outputs."""
    cfg = threedmatch_config(
        first_feats_dim=16, remat=False,
        architecture=["simple", "resnetb", "resnetb_strided", "resnetb",
                      "nearest_upsample", "unary"])
    jl = jax_levels(cfg, n0=128, b=2)
    tl = to_torch_levels(jl)
    assert len(jl) == 2 and jl[0].upsamples is not None
    rng = np.random.RandomState(11)
    x = rng.randn(*tl[1].points.shape[:2], 32).astype(np.float32)
    skip = rng.randn(*tl[0].points.shape[:2], 16).astype(np.float32)
    jdec = JaxKPFDecoder(cfg, (16,))
    params = jdec.init(jax.random.PRNGKey(6), jnp.asarray(x),
                       [jnp.asarray(skip)], jl)
    jout = jdec.apply(params, jnp.asarray(x), [jnp.asarray(skip)], jl)
    dec = empty_module(KPFDecoder, cfg, 32, [16])
    dec.load_state_dict(state_dict_from_jax(flat_params(params["params"]),
                                            dec))
    with torch.inference_mode():
        out = dec(torch.from_numpy(x), [torch.from_numpy(skip)], tl)
    ref = np.asarray(jout)
    assert out.shape == ref.shape == (2, 128, 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=TOL_FWD,
                               atol=TOL_FWD * np.abs(ref).max())


def test_kernel_dispositions_file(tmp_path):
    """The npz lookup equals the JAX package's; a model built with the file
    takes block 1's disposition from it and the others from the generator,
    and its forward equals the JAX model's with the same file."""
    disp = (np.random.RandomState(0).randn(15, 3) * 0.05).astype(np.float32)
    path = tmp_path / "kp.npz"
    np.savez(path, **{"kpf_encoder.encoder_blocks.1.KPConv.kernel_points":
                      disp})
    for idx in (0, 1, 2):
        got, ref = lookup_block_dispositions(path, idx), jax_lookup(path,
                                                                    idx)
        assert (got is None) == (ref is None)
        if ref is not None:
            np.testing.assert_array_equal(got, ref)
    cfg = tiny_config(kernel_dispositions_file=str(path))
    model = create_model(cfg, 96, "cpu")
    plain = create_model(tiny_config(), 96, "cpu")
    blocks = {n.split(".")[1]: m for n, m in model.named_modules()
              if n.endswith(".kpconv")}
    plain_blocks = {n.split(".")[1]: m for n, m in plain.named_modules()
                    if n.endswith(".kpconv")}
    for name, m in blocks.items():
        want = (torch.from_numpy(disp) if name.startswith("block_1_")
                else plain_blocks[name].kernel_points)
        assert torch.equal(m.kernel_points, want), name
    data = np.load(__import__("pathlib").Path(__file__).parent
                   / "golden_tiny.npz")
    jmodel = jax_create_model(cfg, 96)
    params = init_model_params(jmodel, jax.random.PRNGKey(1))["params"]
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    with torch.inference_mode():
        out = model(torch.from_numpy(data["points"]),
                    torch.from_numpy(data["mask"]))
    jout = jax.jit(lambda prm, x, m: jmodel.apply({"params": prm}, x, m))(
        params, jnp.asarray(data["points"]), jnp.asarray(data["mask"]))
    np.testing.assert_allclose(out["corr"].numpy(), np.asarray(jout["corr"]),
                               rtol=1e-3, atol=2e-4)
