"""Port parity of the protocol's forward nearer 3DMatch's scale: 2048
points per cloud with the shipped K = [32, 36, 40, 40], dense enough that
the level-0 neighborhoods fill their K.

At that density the neighbor search breaks bf16 ties at the K-th slot, and
XLA and PyTorch may break them differently, so the tables come from the
JAX forward itself (jitted, as the JAX protocol runs it: its output holds
its pyramid) and go through the port's `RegTR.forward_levels` on the same
converted parameters, in fp32 as the protocol runs.  Poses and overlap
scores are held to `test_run_test_matches_jax`'s tolerances.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.presets import threedmatch_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.models import create_model
from tests.test_torch_kpconv import to_torch_levels
from tests.test_torch_model import flat_params
from tests.test_torch_pyramid import plane_scene

N0 = 2048


def scan_pair(seed):
    """A floor and two walls on a 1.2 cm jittered grid (2048 points, the
    level-0 radius 6.25 cm holds ~80 of them), and the same scene rotated
    by 20 degrees, moved and re-sampled: (points (2, N0, 3), mask)."""
    rng = np.random.RandomState(seed)
    src = plane_scene(rng, N0, spacing=0.012)
    a = np.deg2rad(20.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    tgt = plane_scene(rng, N0, spacing=0.012) @ rot.T + [0.05, -0.02, 0.01]
    pts = np.stack([src, tgt]).astype(np.float32)
    return pts, np.ones((2, N0), bool)


def test_forward_at_2048_points_matches_jax():
    cfg = threedmatch_config(first_feats_dim=32, d_embed=32, nhead=4,
                             d_feedforward=64, num_encoder_layers=2,
                             compute_dtype="float32", buckets=[N0])
    assert list(cfg["neighborhood_limits"]) == [32, 36, 40, 40]
    pts, mask = scan_pair(0)
    jmodel = jax_create_model(cfg, N0)
    params = init_model_params(jmodel, jax.random.PRNGKey(0))["params"]
    jout = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))(
        params, jnp.asarray(pts), jnp.asarray(mask))
    levels = to_torch_levels(jout["levels"])
    # Precondition: the level-0 neighborhoods fill their K (no neighbor
    # cap goes unused), where ties at the K-th slot can arise.
    n0 = levels[0].points.shape[1]
    k0 = levels[0].neighbors.shape[-1]
    full = ((levels[0].neighbors < n0).sum(-1) == k0).float().mean()
    assert k0 == 32 and float(full) > 0.9

    model = create_model(cfg, N0, "cpu")
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    with torch.inference_mode():
        out = model.forward_levels(levels)
    # tests/test_torch_eval.py test_run_test_matches_jax's tolerances: the
    # forward sums in another order than XLA's; the pose is a weighted
    # Kabsch solve of the outputs
    np.testing.assert_allclose(out["pose"].numpy(), np.asarray(jout["pose"]),
                               rtol=1e-3, atol=2e-4)
    np.testing.assert_allclose(
        torch.sigmoid(out["overlap_logits"]).numpy(),
        np.asarray(jax.nn.sigmoid(jout["overlap_logits"])), rtol=1e-3,
        atol=2e-4)
