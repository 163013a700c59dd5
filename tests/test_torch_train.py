"""Port parity for the training step (slice 2) on the CPU: first-step
gradients of `compute_loss` against `jax.grad` of the JAX model (its
attention backward and gather transpose run as the Pallas kernels in
interpret mode), one clipped optimizer update against optax, the learning
rate schedules, and the skip of a non-finite step.
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.ops import kpconv as jax_kpconv
from regtr_tpu.ops import pyramid as jax_pyramid
from regtr_tpu.presets import tiny_config as jax_tiny_config
from regtr_tpu.train.optim import make_optimizer as jax_make_optimizer
from regtr_tpu.train.optim import make_schedule as jax_make_schedule
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.data.overlap import compute_overlap
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.train.optim import Optimizer, make_schedule
from regtr_tpu_torch.train.steps import make_eval_step, make_train_step
from tests.test_torch_kpconv import to_torch_levels
from tests.test_torch_model import flat_params

GOLDEN = Path(__file__).parent / "golden_tiny.npz"
# fp32 on both sides, the same arithmetic summed in another order through
# the pyramid, 2 KPConv blocks, 2 attention layers and their backward:
# measured up to 2.8e-5 relative L2 per leaf.
GRAD_TOL = 1e-4


def golden_batch():
    """The tiny golden pair with a GT pose (a 20 degree rotation about z and
    a shift) and overlap labels from compute_overlap at a radius that marks
    about half the points of these sparse unit-cube clouds."""
    data = np.load(GOLDEN)
    pts, mask = data["points"], data["mask"]
    a = np.deg2rad(20.0)
    rot = np.array([[np.cos(a), -np.sin(a), 0.0], [np.sin(a), np.cos(a), 0.0],
                    [0.0, 0.0, 1.0]], np.float32)
    pose = np.concatenate([rot, [[0.05], [-0.02], [0.01]]], 1)[None]
    src, tgt = pts[0][mask[0]], pts[1][mask[1]]
    src_ov, tgt_ov, _ = compute_overlap(src @ rot.T + pose[0, :, 3], tgt,
                                        0.15)
    overlap0 = np.zeros(mask.shape, np.float32)
    overlap0[0, mask[0]] = src_ov
    overlap0[1, mask[1]] = tgt_ov
    assert 0.2 < overlap0[mask].mean() < 0.8
    return {"points": pts, "mask": mask, "pose": pose.astype(np.float32),
            "overlap0": overlap0}


@pytest.fixture(scope="module")
def tiny():
    """JAX model, params and first-step grads (Pallas attention in
    interpret mode, the Pallas gather transpose), and the port's model on
    the same params."""
    batch = golden_batch()
    jcfg = jax_tiny_config(attention_impl="pallas_interpret")
    jmodel = jax_create_model(jcfg, 96)
    params = init_model_params(jmodel, jax.random.PRNGKey(42))["params"]
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(p):
        losses, _ = jmodel.apply({"params": p}, jb["points"], jb["mask"],
                                 jb["pose"], jb["overlap0"],
                                 method=jmodel.compute_loss)
        return losses["total"], losses

    jax_kpconv.set_segsum_impl("pallas")
    try:
        grads, losses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    finally:
        jax_kpconv.set_segsum_impl("auto")
    cfg = tiny_config()
    # jitted as inside compute_loss: the eager and the jitted neighbor
    # selection may break bf16 ties differently
    jlevels = jax.jit(lambda x, m: jax_pyramid.build_pyramid(
        x, m, jmodel.spec, chunk=int(jcfg["neighbor_chunk"]),
        recall_target=float(jcfg["neighbor_recall"])))(jb["points"],
                                                        jb["mask"])
    model = create_model(cfg, 96, "cpu")
    flat = flat_params(params)
    model.load_state_dict(state_dict_from_jax(flat, model))
    return {"batch": batch, "cfg": cfg, "jcfg": jcfg, "params": params,
            "flat": flat, "jgrads": grads, "grads": flat_params(grads),
            "losses": {k: float(v) for k, v in losses.items()},
            "model": model, "levels": to_torch_levels(jlevels)}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_first_step_gradients_match_jax(tiny):
    """On the JAX pyramid's own tables (so neighbor ties cannot enter):
    every loss term, and the gradient of the total for every parameter,
    leaf by leaf."""
    model, b = tiny["model"], torch_batch(tiny["batch"])
    model.zero_grad()
    losses, _ = model.loss_levels(tiny["levels"], b["pose"], b["overlap0"])
    losses["total"].backward()
    assert set(losses) == set(tiny["losses"])
    for key, ref in tiny["losses"].items():
        np.testing.assert_allclose(losses[key].item(), ref, rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    ref_grads = state_dict_from_jax(tiny["grads"], model)
    worst = {}
    for name, p in model.named_parameters():
        ref = ref_grads[name].numpy()
        assert p.grad is not None, name
        worst[name] = rel_l2(p.grad.numpy(), ref)
        if np.linalg.norm(ref) < 1e-6:      # e.g. feature_un's W, weight 0
            np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-7)
            continue
        assert worst[name] <= GRAD_TOL, (name, worst[name])
    assert len(worst) == len(ref_grads)


def test_full_step_matches_own_parts(tiny):
    """compute_loss (pyramid included) agrees with the loss on the JAX
    tables, and one step of make_train_step moves every parameter."""
    cfg = tiny["cfg"]
    model = create_model(cfg, 96, "cpu")
    model.load_state_dict(state_dict_from_jax(tiny["flat"], model))
    b = torch_batch(tiny["batch"])
    with torch.no_grad():
        losses, _ = model.compute_loss(b["points"], b["mask"], b["pose"],
                                       b["overlap0"])
    np.testing.assert_allclose(float(losses["total"]),
                               tiny["losses"]["total"], rtol=1e-3)
    before = [p.detach().clone() for p in model.parameters()]
    opt = Optimizer(model.parameters(), cfg)
    metrics = make_train_step(model, opt, cfg)(b)
    assert metrics["update_skipped"] == 0.0 and opt.count == 1
    assert np.isfinite(float(metrics["grad_norm"]))
    assert metrics["rot_err_deg"].shape == (cfg["num_encoder_layers"],)
    still = [n for (n, p), a in zip(model.named_parameters(), before)
             if torch.equal(a, p)]
    # feature_un's W has a zero gradient (its loss weight is 0), and its
    # decay, a factor 1 - lr * wd = 1 - 1e-8, rounds to 1 in fp32.
    assert still == ["feature_criterion_un.W"]
    ev = make_eval_step(model, cfg)(b)
    assert ev["hist/rot_err_deg"].shape == (1,)


@pytest.mark.parametrize("optimizer,scheduler,params", [
    ("AdamW", "step", [2, 0.5]),          # the shipped solver, decay at 2
    ("Adam", "warmup", [2, 10, 0.1]),
    ("SGD", "none", []),
])
def test_optimizer_matches_optax(tiny, optimizer, scheduler, params):
    """Three clipped updates from the same gradients (JAX's first-step
    grads, scaled per step) through optax and through the port."""
    over = dict(optimizer=optimizer, scheduler=scheduler,
                scheduler_param=params, base_lr=1e-3, weight_decay=1e-2)
    jcfg = dict(tiny["jcfg"], **over)
    cfg = dict(tiny["cfg"], **over)
    tx = jax_make_optimizer(jcfg)
    jparams, jgrads = tiny["params"], tiny["jgrads"]
    state = tx.init(jparams)
    model = create_model(cfg, 96, "cpu")
    model.load_state_dict(state_dict_from_jax(tiny["flat"], model))
    names = [n for n, _ in model.named_parameters()]
    tgrads = state_dict_from_jax(tiny["grads"], model)
    opt = Optimizer(model.parameters(), cfg)
    # scales 1, 0.01, 3: the clip (0.1) acts on the first and the third
    for scale in (1.0, 0.01, 3.0):
        g = jax.tree_util.tree_map(lambda x: x * scale, jgrads)
        upd, state = tx.update(g, state, jparams)
        jparams = optax.apply_updates(jparams, upd)
        grads = [tgrads[n] * scale for n in names]
        norm = float(torch.linalg.vector_norm(
            torch.stack([x.norm() for x in grads])))
        opt.update(grads, norm)
    ref = state_dict_from_jax(flat_params(jparams), model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), ref[name].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("scheduler,params", [
    ("none", []), ("step", [205860, 0.5]), ("step", [3, 0.5]),
    ("warmup", [5, 20, 0.1]), ("warmup", [4])])
def test_schedules_match_optax(scheduler, params):
    cfg = {"base_lr": 1e-4, "scheduler": scheduler,
           "scheduler_param": params}
    ours, ref = make_schedule(cfg), jax_make_schedule(cfg)
    for count in (0, 1, 2, 3, 4, 5, 6, 9, 25, 205860, 205861):
        want = float(ref(jnp.int32(count)) if callable(ref) else ref)
        # The JAX schedules evaluate gamma ** n in fp32, the port in fp64:
        # measured 1.4e-6 relative apart at n = 20.
        np.testing.assert_allclose(ours(count), want, rtol=1e-5,
                                   err_msg=str(count))


def test_nan_batch_skips_the_update(tiny):
    """A NaN point: the loss is NaN, the update is skipped, and the
    parameters, the moments and the step count stay bitwise as they
    were."""
    cfg = tiny["cfg"]
    model = create_model(cfg, 96, "cpu", seed=5)
    opt = Optimizer(model.parameters(), cfg)
    step = make_train_step(model, opt, cfg)
    b = torch_batch(tiny["batch"])
    step(b)
    before = [t.clone() for t in (*opt.params, *opt.mu, *opt.nu)]
    bad = dict(b, points=b["points"].clone())
    bad["points"][0, 3, 1] = float("nan")
    metrics = step(bad)
    assert metrics["update_skipped"] == 1.0
    assert not np.isfinite(float(metrics["total"]))
    assert opt.count == 1
    after = (*opt.params, *opt.mu, *opt.nu)
    assert all(torch.equal(a, c) for a, c in zip(before, after))
