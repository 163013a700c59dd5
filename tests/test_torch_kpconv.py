"""Port parity: KPConv ops, blocks and the KPFEncoder, on the JAX pyramid's
own neighbor tables (converted to torch), so tie-breaks of the neighbor
search cannot enter.  fp32 and the bf16 compute dtype.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.nn.backbone import KPFEncoder as JaxKPFEncoder
from regtr_tpu.ops import kpconv as jkp
from regtr_tpu.ops import pyramid as jpyr
from regtr_tpu.train.checkpoints import _slash_key
from regtr_tpu.utils.kernel_points import load_kernel_points
from regtr_tpu_torch.config import threedmatch_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.models import init_parameters
from regtr_tpu_torch.nn.backbone import KPFEncoder
from regtr_tpu_torch.ops import kpconv
from regtr_tpu_torch.ops.pyramid import PyramidLevel
from tests.test_torch_pyramid import plane_scene

# fp32: the same arithmetic summed in another order (~1e-6 relative per
# contraction).  bf16: rel, the influences, the gathered features and the
# weights are rounded to bf16 (2^-8 relative); XLA may also keep excess
# precision between bf16 ops where torch rounds after each op.
TOL = {"float32": 1e-4, "bfloat16": 3e-2}


def jax_levels(cfg, n0=384, b=4, seed=0):
    rng = np.random.RandomState(seed)
    pts = np.zeros((b, n0, 3), np.float32)
    mask = np.zeros((b, n0), bool)
    for i in range(b):
        n = int(n0 * (0.75 + 0.25 * (i % 2)))
        pts[i, :n] = plane_scene(rng, n)
        mask[i, :n] = True
    spec = jpyr.make_pyramid_spec(cfg, n0)
    return jpyr.build_pyramid(jnp.asarray(pts), jnp.asarray(mask), spec)


def to_torch_levels(levels):
    def t(x):
        return None if x is None else torch.tensor(np.asarray(x))

    return [PyramidLevel(points=t(l.points), mask=t(l.mask),
                         neighbors=t(l.neighbors).long(),
                         pools=None if l.pools is None else t(l.pools).long(),
                         upsamples=None if l.upsamples is None
                         else t(l.upsamples).long(),
                         perm=None if l.perm is None else t(l.perm).long())
            for l in levels]


def close(out, ref, dtype):
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    scale = max(np.abs(ref).max(), 1e-6)
    np.testing.assert_allclose(out, ref, rtol=TOL[dtype],
                               atol=TOL[dtype] * scale)


@pytest.fixture(scope="module")
def levels():
    jl = jax_levels(threedmatch_config())
    return jl, to_torch_levels(jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("influence,aggregation,norm,extra", [
    ("linear", "sum", "valid", True),
    ("linear", "sum", "legacy", False),
    ("gaussian", "closest", "valid", False),
    ("constant", "sum", "valid", True),
])
def test_fused_gather_matches_jax(levels, dtype, influence, aggregation,
                                  norm, extra):
    jl, tl = levels
    rng = np.random.RandomState(1)
    cin, ce, cout = 16, 8, 12
    s_pts, q_pts, table = tl[0].points, tl[1].points, tl[0].pools
    x = rng.rand(s_pts.shape[0], s_pts.shape[1], cin).astype(np.float32)
    xe = rng.randn(s_pts.shape[0], s_pts.shape[1], ce).astype(np.float32)
    w = rng.randn(15, cin, cout).astype(np.float32)
    kp = load_kernel_points(0.0625, 15)
    cd_t = None if dtype == "float32" else torch.bfloat16
    cd_j = None if dtype == "float32" else jnp.bfloat16
    out, pooled, (infl, _) = kpconv.kpconv_fused_gather(
        q_pts, s_pts, table, torch.from_numpy(x),
        torch.from_numpy(xe) if extra else None, torch.from_numpy(kp),
        torch.from_numpy(w), 0.05, influence, aggregation, cd_t, norm)
    jout, jpooled, (jinfl, _) = jkp.kpconv_fused_gather(
        jl[1].points, jl[0].points, jl[0].pools, jnp.asarray(x),
        jnp.asarray(xe) if extra else None, jnp.asarray(kp), jnp.asarray(w),
        0.05, influence, aggregation, cd_j, norm)
    assert out.dtype == torch.float32
    close(out, jout, dtype)
    close(infl, jinfl, dtype)
    if extra:
        # a max over gathered values: exact in either dtype
        np.testing.assert_array_equal(pooled.float().numpy(),
                                      np.asarray(jpooled, np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cin", [1, 8])
def test_apply_with_shared_geometry_matches_jax(levels, dtype, cin):
    """kpconv_apply (including its Cin = 1 path) and max_pool on a reused
    geometry, as later blocks at a level run them."""
    jl, tl = levels
    rng = np.random.RandomState(2)
    pts, table = tl[1].points, tl[1].neighbors
    x = rng.rand(pts.shape[0], pts.shape[1], cin).astype(np.float32)
    w = rng.randn(15, cin, 6).astype(np.float32)
    kp = load_kernel_points(0.125, 15)
    cd_t = None if dtype == "float32" else torch.bfloat16
    cd_j = None if dtype == "float32" else jnp.bfloat16
    infl, inv_n = kpconv._influence_from_rel(
        kpconv.batched_row_gather(
            kpconv._pad_row(pts, kpconv.SHADOW_COORD),
            table.reshape(table.shape[0], -1)).reshape(*table.shape, 3)
        - pts[:, :, None], table, pts.shape[1], torch.from_numpy(kp), 0.1,
        compute_dtype=cd_t)
    jinfl, jinv = jkp.kpconv_geometry(jl[1].points, jl[1].points,
                                      jl[1].neighbors, jnp.asarray(kp), 0.1,
                                      compute_dtype=cd_j)
    close(infl, jinfl, dtype)
    out = kpconv.kpconv_apply(infl, inv_n, table, torch.from_numpy(x),
                              torch.from_numpy(w), cd_t)
    jout = jkp.kpconv_apply(jinfl, jinv, jl[1].neighbors, jnp.asarray(x),
                            jnp.asarray(w), cd_j)
    close(out, jout, dtype)
    pooled = kpconv.max_pool(torch.from_numpy(x), table, cd_t)
    jpooled = jkp.max_pool(jnp.asarray(x), jl[1].neighbors, cd_j)
    np.testing.assert_array_equal(pooled.float().numpy(),
                                  np.asarray(jpooled, np.float32))


@pytest.fixture(scope="module")
def encoders(levels):
    """JAX KPFEncoder outputs in fp32 and bf16 on one set of parameters,
    and the same parameters converted for the port."""
    jl, _ = levels
    feats0 = jnp.asarray(np.asarray(jl[0].mask, np.float32)[..., None])
    outs, params = {}, None
    for dtype in ("float32", "bfloat16"):
        cfg = threedmatch_config(first_feats_dim=32, compute_dtype=dtype,
                                 remat=False)
        jenc = JaxKPFEncoder(cfg)
        if params is None:
            params = jax.jit(lambda k: jenc.init(k, feats0, jl))(
                jax.random.PRNGKey(3))
        jout, jskips = jax.jit(lambda p: jenc.apply(p, feats0, jl))(params)
        outs[dtype] = [np.asarray(x) for x in (*jskips, jout)]
    flat = {_slash_key(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(params["params"])[0]}
    return np.asarray(feats0), flat, outs


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encoder_matches_jax(levels, encoders, dtype):
    """The full 11-block 3DMatch backbone (narrowed to 32 first features)
    over all four levels, on the same converted parameters."""
    cfg = threedmatch_config(first_feats_dim=32, compute_dtype=dtype)
    _, tl = levels
    feats0, flat, jax_outs = encoders
    with torch.device("meta"):
        enc = KPFEncoder(cfg)
    enc.to_empty(device="cpu")
    for m in enc.modules():
        if hasattr(m, "reset_kernel_points"):
            m.reset_kernel_points()
    init_parameters(enc, torch.Generator().manual_seed(0))
    enc.load_state_dict(state_dict_from_jax(flat, enc))
    with torch.inference_mode():
        out, skips = enc(torch.tensor(feats0), tl)
    outs = [x.numpy() for x in (*skips, out)]
    assert len(outs) == len(jax_outs[dtype]) == 5
    assert out.shape == (4, tl[-1].points.shape[1], 256)
    for i, (o, ref, ref32) in enumerate(zip(outs, jax_outs[dtype],
                                            jax_outs["float32"])):
        if dtype == "float32":
            close(o, ref, dtype)
            continue
        # bf16 rounding noise compounds over the blocks (instance norm
        # rescales it), so elementwise bounds do not hold at depth.  The
        # port's bf16 run must be as near the fp32 result as JAX's bf16 run
        # is (measured: 1.6 % after block 1 to 6 % at the end, for both),
        # and nearer still to JAX's bf16 run (measured 1.0 % to 3.6 %).
        jax_err = rel_l2(ref, ref32)
        assert rel_l2(o, ref32) <= 1.25 * jax_err, (i, jax_err)
        assert rel_l2(o, ref) <= 0.75 * jax_err, (i, jax_err)
