"""The JAX package's public helpers in the port, each held to its JAX
function on seeded numpy inputs: the model registry, `interleave_pairs`,
the SE(3) constructors, the masked reductions, and the unfused KPConv
(`kpconv_geometry`, `kpconv`) with its gradients."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu import models as jax_models
from regtr_tpu.core import masking as jmask
from regtr_tpu.core import pairs as jpairs
from regtr_tpu.core import se3 as jse3
from regtr_tpu.ops import kpconv as jkp
from regtr_tpu.utils.kernel_points import load_kernel_points
from regtr_tpu_torch import models
from regtr_tpu_torch.config import threedmatch_config, tiny_config
from regtr_tpu_torch.core import masking, pairs, se3
from regtr_tpu_torch.models.regtr import RegTR
from regtr_tpu_torch.ops import kpconv
from tests.test_torch_kpconv import TOL, close, jax_levels, to_torch_levels

# the float helpers: the same sums, perhaps in another order
TOL_FLOAT = 1e-6


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_model_registry():
    """register_model / get_model as in JAX, and create_model builds what
    get_model names."""
    assert models.get_model("regtr.RegTR") is RegTR
    assert jax_models.get_model("regtr.RegTR").__name__ == "RegTR"
    for get in (models.get_model, jax_models.get_model):
        with pytest.raises(ValueError, match="unknown model 'nope'"):
            get("nope")

    class Tagged(RegTR):
        pass

    models.register_model("test.Tagged", Tagged)
    try:
        assert models.get_model("test.Tagged") is Tagged
        model = models.create_model(tiny_config(model="test.Tagged"), 96,
                                    "cpu")
        assert type(model) is Tagged
    finally:
        del models._MODELS["test.Tagged"]


@pytest.mark.parametrize("dim", [0, 1, 2])
def test_interleave_pairs(dim):
    rng = np.random.RandomState(dim)
    src = rng.randn(3, 4, 5).astype(np.float32)
    tgt = rng.randn(3, 4, 5).astype(np.float32)
    got = pairs.interleave_pairs(torch.from_numpy(src),
                                 torch.from_numpy(tgt), dim=dim)
    want = jpairs.interleave_pairs(jnp.asarray(src), jnp.asarray(tgt),
                                   axis=dim)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = pairs.split_pairs(got, dim=dim)
    assert torch.equal(back[0], torch.from_numpy(src))
    assert torch.equal(back[1], torch.from_numpy(tgt))


@pytest.mark.parametrize("which", ["both", "rot", "trans", "trans31"])
def test_se3_init_and_rot_trans(which):
    rng = np.random.RandomState(4)
    rot = rng.randn(2, 3, 3, 3).astype(np.float32)
    trans = rng.randn(2, 3, 3).astype(np.float32)
    if which == "trans31":
        trans = trans[..., None]
    args = {"both": (rot, trans), "rot": (rot, None),
            "trans": (None, trans), "trans31": (None, trans)}[which]
    got = se3.se3_init(*(None if a is None else torch.from_numpy(a)
                         for a in args))
    want = jse3.se3_init(*(None if a is None else jnp.asarray(a)
                           for a in args))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for g, w in zip(se3.se3_rot_trans(got), jse3.se3_rot_trans(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        se3.se3_init()


@pytest.mark.parametrize("batch_shape", [(), (4,), (2, 3)])
def test_se3_identity(batch_shape):
    got = se3.se3_identity(batch_shape, torch.float64)
    want = jse3.se3_identity(batch_shape, jnp.float32)
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_lengths_to_mask():
    lengths = np.array([0, 3, 7, 5])
    got = masking.lengths_to_mask(torch.from_numpy(lengths), 7)
    want = jmask.lengths_to_mask(jnp.asarray(lengths), 7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def masked_inputs(seed=5):
    rng = np.random.RandomState(seed)
    x = rng.randn(3, 40, 6).astype(np.float32) * 3.0 + 1.0
    mask = rng.rand(3, 40) < 0.6
    mask[2] = False                 # a cloud with no valid point
    return x, mask


@pytest.mark.parametrize("fn", ["masked_mean", "masked_var"])
@pytest.mark.parametrize("dim,keepdim", [(1, False), (1, True),
                                         (-1, False), ((0, 1), False)])
def test_masked_mean_var(fn, dim, keepdim):
    x, mask = masked_inputs()
    m = mask[..., None]
    got = getattr(masking, fn)(torch.from_numpy(x), torch.from_numpy(m),
                               dim, keepdim=keepdim)
    want = getattr(jmask, fn)(jnp.asarray(x), jnp.asarray(m), dim,
                              keepdims=keepdim)
    assert got.shape == want.shape
    assert rel(got.numpy(), want) <= TOL_FLOAT


def test_masked_max():
    x, mask = masked_inputs()
    for dim in (1, 0):
        got = masking.masked_max(torch.from_numpy(x[..., 0]),
                                 torch.from_numpy(mask), dim, initial=-2.5)
        want = jmask.masked_max(jnp.asarray(x[..., 0]), jnp.asarray(mask),
                                dim, initial=-2.5)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got[-1]) != -2.5 and float(masking.masked_max(
        torch.from_numpy(x[..., 0]), torch.from_numpy(mask), 1,
        initial=-2.5)[2]) == -2.5


def test_masked_instance_norm_over_masked_mean():
    """Written over masked_mean, the norm is bitwise its inline form (the
    sums and the division as before), and JAX's within TOL_FLOAT."""
    x, mask = masked_inputs()
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    got = masking.masked_instance_norm(xt, mt)
    m = mt[..., None].to(xt.dtype)
    count = m.sum(dim=-2, keepdim=True).clamp_min(1e-12)
    mean = (xt * m).sum(dim=-2, keepdim=True) / count
    var = ((xt - mean) ** 2 * m).sum(dim=-2, keepdim=True) / count
    inline = torch.where(mt[..., None], (xt - mean) * torch.rsqrt(var + 1e-5),
                         0.0)
    assert torch.equal(got, inline)
    want = jmask.masked_instance_norm(jnp.asarray(x), jnp.asarray(mask))
    assert rel(got.numpy(), want) <= TOL_FLOAT


@pytest.fixture(scope="module")
def levels():
    jl = jax_levels(threedmatch_config(), n0=256, b=2)
    return jl, to_torch_levels(jl)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("influence,aggregation,norm", [
    ("linear", "sum", "valid"), ("gaussian", "closest", "legacy")])
def test_unfused_kpconv_matches_jax(levels, dtype, influence, aggregation,
                                    norm):
    """kpconv_geometry and kpconv on a pooling table (queries of level 1,
    supports of level 0), and the gradients of kpconv's output in its
    features and weights, against JAX's on the same tables."""
    jl, tl = levels
    rng = np.random.RandomState(3)
    cin, cout = 8, 6
    s_pts, q_pts, table = tl[0].points, tl[1].points, tl[0].pools
    x = rng.rand(s_pts.shape[0], s_pts.shape[1], cin).astype(np.float32)
    w = rng.randn(15, cin, cout).astype(np.float32)
    cot = rng.randn(q_pts.shape[0], q_pts.shape[1], cout).astype(np.float32)
    kp = load_kernel_points(0.0625, 15)
    cd_t = None if dtype == "float32" else torch.bfloat16
    cd_j = None if dtype == "float32" else jnp.bfloat16
    index = kpconv.GatherIndex(table, s_pts.shape[1] + 1)
    infl, inv_n = kpconv.kpconv_geometry(q_pts, s_pts, index,
                                         torch.from_numpy(kp), 0.05,
                                         influence, aggregation, cd_t)
    jinfl, jinv = jkp.kpconv_geometry(jl[1].points, jl[0].points,
                                      jl[0].pools, jnp.asarray(kp), 0.05,
                                      influence, aggregation, cd_j)
    close(infl, jinfl, dtype)
    np.testing.assert_array_equal(inv_n.numpy(), np.asarray(jinv))

    xt = torch.tensor(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    out = kpconv.kpconv(q_pts, s_pts, index, xt, torch.from_numpy(kp), wt,
                        0.05, influence, aggregation, cd_t, norm)
    (out * torch.from_numpy(cot)).sum().backward()

    def jfn(x_, w_):
        o = jkp.kpconv(jl[1].points, jl[0].points, jl[0].pools, x_,
                       jnp.asarray(kp), w_, 0.05, influence, aggregation,
                       cd_j, norm)
        return (o * cot).sum(), o

    (_, jout), jgrads = jax.value_and_grad(jfn, argnums=(0, 1),
                                           has_aux=True)(jnp.asarray(x),
                                                         jnp.asarray(w))
    assert out.dtype == torch.float32
    close(out.detach(), jout, dtype)
    for t, jg in zip((xt, wt), jgrads):
        close(t.grad, jg, dtype)
