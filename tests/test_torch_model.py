"""Port parity for the whole inference forward (slice 1) on the CPU:
the tiny golden, a narrowed 3DMatch-architecture forward in bf16 against
the JAX forward (Pallas attention in interpret mode), and register().
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.ops.pyramid import make_pyramid_spec as jax_make_spec
from regtr_tpu.train.checkpoints import _slash_key
from regtr_tpu_torch import register
from regtr_tpu_torch.config import threedmatch_config, tiny_config
from regtr_tpu_torch.convert import LOSS_ONLY_LEAVES, state_dict_from_jax
from regtr_tpu_torch.models import create_model
from tests.test_torch_pyramid import assert_tables_match

GOLDEN = Path(__file__).parent / "golden_tiny.npz"


def flat_params(params):
    return {_slash_key(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(params)[0]}


def jax_init(jmodel, seed):
    """Forward parameters of a JAX RegTR from PRNGKey(seed), initialized
    through a small-capacity clone (parameter shapes do not depend on the
    capacities)."""
    clone = type(jmodel)(cfg=jmodel.cfg, spec=jax_make_spec(jmodel.cfg, 64))
    pts = jnp.asarray(np.random.RandomState(0).rand(2, 64, 3), jnp.float32)
    return jax.jit(clone.init)(jax.random.PRNGKey(seed), pts,
                               jnp.ones((2, 64), bool))["params"]


def port_model(cfg, n0, flat):
    model = create_model(cfg, n0, "cpu")
    model.load_state_dict(state_dict_from_jax(flat, model))
    return model


def test_tiny_golden():
    """tiny_config at bucket 96, JAX params from PRNGKey(42): against the
    recorded golden with tests/test_golden.py's tolerances, and against the
    JAX forward itself."""
    data = np.load(GOLDEN)
    cfg = tiny_config()
    jmodel = jax_create_model(cfg, 96)
    params = init_model_params(jmodel, jax.random.PRNGKey(42))["params"]
    flat = flat_params(params)
    model = port_model(cfg, 96, flat)
    # The full JAX tree (loss path included): all but the two loss-only
    # InfoNCE matrices map onto the port, one leaf per port tensor.
    assert set(LOSS_ONLY_LEAVES) <= set(flat)
    assert len(flat) - len(LOSS_ONLY_LEAVES) == len(model.state_dict())
    with torch.inference_mode():
        out = model(torch.from_numpy(data["points"]),
                    torch.from_numpy(data["mask"]))
    jout = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))(
        params, jnp.asarray(data["points"]), jnp.asarray(data["mask"]))
    for key in ("pose", "overlap_logits", "corr"):
        np.testing.assert_allclose(out[key].numpy(), data[key], rtol=1e-3,
                                   atol=2e-4, err_msg=key)
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-3, atol=2e-4, err_msg=key)


def floor_scan(rng, n, spacing=0.03):
    """A meter-scale floor patch: a jittered grid in x, y and a z in
    [0, 3 mm), which keeps the floor inside one voxel layer at every level
    (the voxel origin is floor(min z / dl) * dl = 0).  One surface keeps
    every neighborhood near pi * (r / dl)^2 ~ 20 points at each level, below
    every K (checked in the test)."""
    side = int(np.ceil(np.sqrt(n)))
    u, v = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    pts = np.stack([u.ravel() * spacing, v.ravel() * spacing,
                    np.zeros(side * side)], 1)
    pts[:, :2] += rng.randn(len(pts), 2) * spacing * 0.1
    pts[:, 2] = rng.rand(len(pts)) * 0.003
    return pts[rng.permutation(len(pts))[:n]].astype(np.float32)


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_narrow_3dmatch_forward_matches_jax():
    """The 3DMatch architecture (4 levels, K = [32, 36, 40, 40], bf16
    compute) narrowed to first_feats_dim 32, d_embed 64, 4 heads and 2
    layers, at bucket 2048, against the JAX forward on the same params."""
    n0 = 2048
    cfg = threedmatch_config(
        first_feats_dim=32, d_embed=64, nhead=4, d_feedforward=128,
        num_encoder_layers=2, compute_dtype="bfloat16",
        attention_impl="pallas_interpret", remat=False)
    rng = np.random.RandomState(0)
    pts = np.zeros((4, n0, 3), np.float32)
    mask = np.zeros((4, n0), bool)
    for i in range(4):
        n = int(n0 * (0.85 + 0.05 * i))
        pts[i, :n] = floor_scan(rng, n)
        pts[i, :n, :2] += rng.randn(2).astype(np.float32)
        mask[i, :n] = True
    jmodel = jax_create_model(cfg, n0)
    params = jax_init(jmodel, 7)
    flat = flat_params(params)
    model = port_model(cfg, n0, flat)
    with torch.inference_mode():
        out = model(torch.from_numpy(pts), torch.from_numpy(mask))

    # Precondition: no neighborhood overflows K, so no row is cut at a bf16
    # tie; the tables may then differ only at the acceptance threshold.
    jout = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))(
        params, jnp.asarray(pts), jnp.asarray(mask))
    levels = out["levels"]
    for li, (lv, jl) in enumerate(zip(levels, jout["levels"])):
        np.testing.assert_array_equal(lv.points.numpy(),
                                      np.asarray(jl.points), f"level {li}")
        r = model.spec.radii[li]
        for name, q, s, radius in (("neighbors", li, li, r),
                                   ("pools", li + 1, li, r),
                                   ("upsamples", li, li + 1, 2 * r)):
            table = getattr(lv, name)
            if table is None:
                continue
            ns = levels[s].points.shape[1]
            assert int((table < ns).sum(-1).max()) < table.shape[-1], \
                (li, name)
            assert_tables_match(table.numpy(), np.asarray(getattr(jl, name)),
                                levels[q].points.numpy(),
                                levels[s].points.numpy(), radius)
    # bf16 rounds the operands of every KPConv contraction and of the
    # attention, and the rounding noise compounds over 11 backbone blocks
    # and 2 layers: JAX's own bf16 forward is 4-17 % (relative L2) from the
    # fp32 forward of the same model here, so elementwise bounds cannot
    # hold.  The port's bf16 forward must be about as near the fp32 forward
    # as JAX's is (measured at most 1.3x on two seeds), and nearer to JAX's
    # bf16 forward than either is to fp32 (measured at most 0.8x): both
    # round at the same points.  The port's fp32 forward stands in for the
    # fp32 reference; test_tiny_golden and test_torch_kpconv hold it to JAX.
    model32 = port_model(dict(cfg, compute_dtype="float32"), n0, flat)
    with torch.inference_mode():
        out32 = model32(torch.from_numpy(pts), torch.from_numpy(mask))
    for key in ("feats_un", "feats_cond", "corr", "overlap_logits", "pose"):
        port, ref32 = out[key].float().numpy(), out32[key].numpy()
        ref = np.asarray(jout[key], np.float32)
        jax_err = rel_l2(ref, ref32)
        assert rel_l2(port, ref32) <= 1.5 * jax_err, (key, jax_err)
        assert rel_l2(port, ref) <= 0.85 * jax_err, (key, jax_err)
    assert torch.isfinite(out["pose"]).all()


def test_register_on_cpu():
    rng = np.random.RandomState(5)
    src = floor_scan(rng, 500)
    rot = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                   np.float32)
    tgt = src @ rot.T + np.float32(0.2)
    result = register(src, tgt, cfg=tiny_config(), device="cpu")
    assert result["pose"].shape == (3, 4)
    assert np.all(np.isfinite(result["pose"]))
    r = result["pose"][:, :3]
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-5)
    n_kp = len(result["src_kp"])
    assert n_kp > 0
    assert result["src_kp_warped"].shape == (n_kp, 3)
    assert result["src_overlap"].shape == (n_kp,)
    assert np.all((result["src_overlap"] >= 0) & (result["src_overlap"] <= 1))


def test_register_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present here")
    with pytest.raises(RuntimeError, match="CUDA"):
        register(np.zeros((10, 3)), np.zeros((10, 3)))
