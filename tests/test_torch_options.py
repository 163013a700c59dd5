"""Port parity for the model and training options off the shipped configs,
on the CPU: the attention decoder head (with and without its top-k mask),
the learned positional embedding, the circle losses and the sampler of
the sampled one, dropout, and gradient accumulation (optax's MultiSteps),
with the training step's refusal of dropout as the JAX step refuses it.
JAX on the CPU is the oracle.
"""
import sys

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from regtr_tpu.data import get_dataloader as jax_get_dataloader
from regtr_tpu.losses import feature as jfeat
from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.nn.heads import CorrespondenceDecoder as JaxDecoder
from regtr_tpu.nn.pos_embed import PositionEmbeddingLearned as JaxLearned
from regtr_tpu.ops.kpconv import batched_row_gather as jax_row_gather
from regtr_tpu.presets import tiny_config as jax_tiny_config
from regtr_tpu.train import steps as jax_steps
from regtr_tpu.train import trainer as jax_trainer
from regtr_tpu.train.optim import make_optimizer as jax_make_optimizer
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.data import get_dataloader
from regtr_tpu_torch.losses import feature
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.nn import transformer
from regtr_tpu_torch.nn.heads import CorrespondenceDecoder
from regtr_tpu_torch.nn.pos_embed import PositionEmbeddingLearned
from regtr_tpu_torch.ops.kpconv import GatherIndex, batched_row_gather
from regtr_tpu_torch.train import steps, trainer
from regtr_tpu_torch.train.checkpoints import CheckpointManager
from regtr_tpu_torch.train.optim import Optimizer
from tests.test_torch_model import flat_params, jax_init
from tests.test_torch_train import golden_batch
from tests.test_torch_trainer import DATA, N0, UPDATE_TOL

# fp32 on both sides, the same arithmetic in another order: measured up to
# 5.9e-7 of the largest value (forward) and 5.3e-7 relative L2 (gradients).
TOL = 1e-5
TOL_GRAD = 1e-4


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def port_module(cls, params, *args):
    mod = cls(*args)
    mod.load_state_dict(state_dict_from_jax(flat_params(params), mod))
    return mod


def close(out, ref, tol=TOL):
    ref = np.asarray(ref)
    out = out.detach().numpy() if torch.is_tensor(out) else out
    np.testing.assert_allclose(out, ref, rtol=tol,
                               atol=tol * np.abs(ref).max())


@pytest.mark.parametrize("num_neighbors,use_pos", [(0, True), (5, True),
                                                   (7, False)])
def test_correspondence_decoder_matches_jax(num_neighbors, use_pos):
    """(L, 2B, N, D) features of 2 layers and 2 pairs, a masked tail; with
    num_neighbors, a query keeps the scores at least its k-th largest."""
    rng = np.random.RandomState(num_neighbors)
    n, d = 24, 16
    feats = rng.randn(2, 4, n, d).astype(np.float32)
    xyz = rng.randn(4, n, 3).astype(np.float32)
    pos = rng.randn(4, n, d).astype(np.float32)
    mask = np.ones((4, n), bool)
    mask[1, 20:] = mask[2, 18:] = False
    jmod = JaxDecoder(d, use_pos, num_neighbors)
    args = tuple(map(jnp.asarray, (feats, xyz, pos, mask)))
    params = jmod.init(jax.random.PRNGKey(0), *args)["params"]
    jcorr, jov = jmod.apply({"params": params}, *args)
    mod = port_module(CorrespondenceDecoder, params, d, use_pos,
                      num_neighbors)
    corr, ov = mod(*map(torch.from_numpy, (feats, xyz, pos, mask)))
    close(corr, jcorr)
    close(ov, jov)


def test_correspondence_decoder_keeps_ties():
    """Equal scores at the k-th value are all kept (no scatter): with
    all-equal keys every partner point gets the same weight."""
    mod = CorrespondenceDecoder(4, use_pos_emb=False, num_neighbors=2)
    with torch.no_grad():
        mod.k_proj.weight.zero_()
    xyz = torch.arange(24, dtype=torch.float32).reshape(2, 4, 3)
    corr, _ = mod(torch.randn(1, 2, 4, 4), xyz, None,
                  torch.ones(2, 4, dtype=torch.bool))
    torch.testing.assert_close(corr[0, 0], xyz[1].mean(0).expand(4, 3))


def test_learned_embedding_matches_jax():
    rng = np.random.RandomState(3)
    xyz = rng.randn(2, 40, 3).astype(np.float32)
    jmod = JaxLearned(32)
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(xyz))["params"]
    assert sorted(params) == [f"Dense_{i}" for i in range(5)]
    mod = port_module(PositionEmbeddingLearned, params, 3, 32)
    close(mod(torch.from_numpy(xyz)),
          jmod.apply({"params": params}, jnp.asarray(xyz)))


def circle_inputs(seed, n=40, d=16):
    """Two pairs of clouds (the second half-masked) 0.4 m across, features
    near their partners' where the points correspond."""
    rng = np.random.RandomState(seed)
    xyz_a = (rng.rand(2, n, 3) * 0.4).astype(np.float32)
    xyz_b = (xyz_a + rng.randn(2, n, 3) * 0.02).astype(np.float32)
    feats_a = rng.randn(2, n, d).astype(np.float32)
    feats_b = (feats_a + rng.randn(2, n, d) * 0.5).astype(np.float32)
    mask_a = np.ones((2, n), bool)
    mask_b = np.ones((2, n), bool)
    mask_a[1, n // 2:] = mask_b[1, 3 * n // 4:] = False
    return feats_a, feats_b, xyz_a, xyz_b, mask_a, mask_b


@pytest.mark.parametrize("dist_type", ["euclidean", "cosine"])
def test_circle_loss_matches_jax(dist_type):
    """Value and gradients for both clouds' features; r_p 0.05, r_n 0.1."""
    fa, fb, xa, xb, ma, mb = circle_inputs(0)

    def jfn(fa, fb):
        return jfeat.circle_loss(fa, fb, jnp.asarray(xa), jnp.asarray(xb),
                                 jnp.asarray(ma), jnp.asarray(mb), 0.05, 0.1,
                                 dist_type=dist_type)

    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(fa), jnp.asarray(fb))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (fa, fb))
    val = feature.circle_loss(ta, tb, *map(torch.from_numpy, (xa, xb, ma,
                                                              mb)),
                              0.05, 0.1, dist_type=dist_type)
    val.backward()
    assert float(jval) > 0
    np.testing.assert_allclose(val.item(), float(jval), rtol=TOL)
    for t, jg in zip((ta, tb), jgrads):
        assert rel_l2(t.grad.numpy(), np.asarray(jg)) < TOL_GRAD


def test_sampled_circle_core_matches_jax():
    """circle_loss_sampled after its sampling, on the same indices: the
    gathers (the port's batched_row_gather, JAX's) and the loss, value and
    gradients; one pair's samples marked invalid."""
    fa, fb, xa, xb, ma, mb = circle_inputs(1)
    rng = np.random.RandomState(2)
    ia = rng.randint(0, 20, (2, 16)).astype(np.int32)
    ib = rng.randint(0, 30, (2, 16)).astype(np.int32)
    valid = np.array([[True] * 16, [False] * 16])

    def jfn(fa, fb):
        ga, gb = jax_row_gather(fa, ia), jax_row_gather(fb, ib)
        xa_, xb_ = (jax_row_gather(jnp.asarray(x), i)
                    for x, i in ((xa, ia), (xb, ib)))
        coords = jnp.sqrt(jfeat.pairwise_sqdist(xa_, xb_) + 1e-12)
        fd = jfeat._feature_dist(ga, gb, "euclidean")
        vm = valid[:, :, None] & valid[:, None, :]
        return jfeat._circle_core(coords, fd, jnp.asarray(vm), 0.05, 0.1,
                                  10.0, 0.1, 1.4)

    jval, jgrads = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1)))(
        jnp.asarray(fa), jnp.asarray(fb))
    ta, tb = (torch.tensor(x, requires_grad=True) for x in (fa, fb))
    index_a = GatherIndex(torch.from_numpy(ia), fa.shape[1])
    index_b = GatherIndex(torch.from_numpy(ib), fb.shape[1])
    val = feature.sampled_circle_core(
        batched_row_gather(ta, index_a), batched_row_gather(tb, index_b),
        batched_row_gather(torch.from_numpy(xa), index_a),
        batched_row_gather(torch.from_numpy(xb), index_b),
        torch.from_numpy(valid), 0.05, 0.1)
    val.backward()
    np.testing.assert_allclose(val.item(), float(jval), rtol=TOL)
    for t, jg in zip((ta, tb), jgrads):
        assert rel_l2(t.grad.numpy(), np.asarray(jg)) < TOL_GRAD


def test_sampler_contract():
    """Without replacement when a pair has enough candidates, with it when
    it has fewer; every sample a true candidate; `valid` False on a pair
    with none; repeatable with one seed, another seed draws others; a
    pair's draws its own (one generator per pair: the same alone as in a
    batch)."""
    _, _, xa, xb, ma, mb = circle_inputs(4, n=30)
    xa, xb = torch.from_numpy(xa), torch.from_numpy(xb)
    ma, mb = torch.from_numpy(ma), torch.from_numpy(mb)
    mb[1] = False                       # pair 1: no candidate at all
    r_p = 0.05
    cand = ((feature.pairwise_sqdist(xa, xb) < (r_p - 1e-3) ** 2)
            & ma[:, :, None] & mb[:, None, :])
    n_cand = int(cand[0].sum())
    assert 10 < n_cand

    def draw(seed, n, pairs=slice(None)):
        return feature.sample_correspondences(
            [torch.Generator().manual_seed(seed + i)
             for i in range(len(xa))][pairs],
            xa[pairs], xb[pairs], ma[pairs], mb[pairs], r_p, n)

    ia, ib, valid = draw(0, 10)
    assert valid[0].all() and not valid[1].any()
    assert cand[0, ia[0], ib[0]].all()
    assert len(set(zip(ia[0].tolist(), ib[0].tolist()))) == 10
    ia2, ib2, _ = draw(0, 10)
    assert torch.equal(ia, ia2) and torch.equal(ib, ib2)
    ia3, ib3, _ = draw(1, 10)
    assert not (torch.equal(ia, ia3) and torch.equal(ib, ib3))
    # more slots than candidates: every candidate first, then repeats
    ia, ib, _ = draw(0, n_cand + 20)
    assert cand[0, ia[0], ib[0]].all()
    pairs = list(zip(ia[0].tolist(), ib[0].tolist()))
    assert len(set(pairs[:n_cand])) == n_cand == len(set(pairs))
    # pair 0 drawn alone draws what it drew in the batch
    alone = draw(0, 10, slice(0, 1))
    for a, b in zip(alone, draw(0, 10)):
        assert torch.equal(a[0], b[0])


def test_dropout_function():
    """flax's train-mode dropout: the kept share near 1 - p, the kept
    values scaled by 1 / (1 - p), the rest 0; one seed, one mask."""
    x = torch.rand(200_000) + 0.5
    out = transformer.dropout(x, 0.25, torch.Generator().manual_seed(0))
    kept = out != 0
    assert abs(kept.float().mean().item() - 0.75) < 0.005
    torch.testing.assert_close(out[kept], x[kept] / 0.75)
    again = transformer.dropout(x, 0.25, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


@pytest.fixture(scope="module")
def dropout_models():
    cfg = tiny_config(dropout=0.1)
    jmodel = jax_create_model(jax_tiny_config(dropout=0.1), 96)
    params = jax_init(jmodel, 2)
    model = create_model(cfg, 96, "cpu")
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    batch = golden_batch()
    return cfg, jmodel, params, model, batch


def count_kernel_calls(monkeypatch):
    calls = []
    real = transformer.flash_masked_attention

    def counted(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(transformer, "flash_masked_attention", counted)
    return calls


def test_dropout_deterministic_and_rate_zero_match_jax(dropout_models,
                                                       monkeypatch):
    """dropout 0.1 with deterministic=True, and dropout 0 with
    deterministic=False, equal JAX's on the same params (the tiny golden's
    tolerances), attention through the kernel route; dropout in train mode
    takes the dense path (no kernel call) and needs a generator."""
    cfg, jmodel, params, model, batch = dropout_models
    pts, mask = (torch.from_numpy(batch[k]) for k in ("points", "mask"))
    calls = count_kernel_calls(monkeypatch)
    jout = jax.jit(lambda prm, x, m: jmodel.apply({"params": prm}, x, m))(
        params, jnp.asarray(batch["points"]), jnp.asarray(batch["mask"]))
    with torch.no_grad():
        out = model(pts, mask)
    assert len(calls) == 2 * cfg["num_encoder_layers"]
    for key in ("corr", "overlap_logits", "pose"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-3, atol=2e-4, err_msg=key)
    model0 = create_model(tiny_config(), 96, "cpu")
    model0.load_state_dict(model.state_dict())
    jmodel0 = jax_create_model(jax_tiny_config(), 96)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jlosses = jax.jit(lambda prm, b: jmodel0.apply(
        {"params": prm}, b["points"], b["mask"], b["pose"], b["overlap0"],
        method=jmodel0.compute_loss, deterministic=False)[0])(params, jb)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        losses, _ = model0.compute_loss(b["points"], b["mask"], b["pose"],
                                        b["overlap0"], deterministic=False)
    np.testing.assert_allclose(losses["total"].item(),
                               float(jlosses["total"]), rtol=1e-3)
    calls.clear()
    with torch.no_grad():
        model.compute_loss(b["points"], b["mask"], b["pose"], b["overlap0"],
                           generator=torch.Generator().manual_seed(0))
    assert not calls
    with pytest.raises(ValueError, match="Generator"):
        model.compute_loss(b["points"], b["mask"], b["pose"], b["overlap0"])


def test_dropout_training_seeded(dropout_models):
    """compute_loss and its gradients with dropout 0.1: finite, bitwise
    repeatable with one seed, different with another, different from the
    deterministic loss."""
    _, _, _, model, batch = dropout_models
    b = {k: torch.from_numpy(v) for k, v in batch.items()}

    def run(seed):
        model.zero_grad()
        losses, _ = model.compute_loss(
            b["points"], b["mask"], b["pose"], b["overlap0"],
            generator=None if seed is None
            else torch.Generator().manual_seed(seed),
            deterministic=seed is None)
        losses["total"].backward()
        return losses["total"].item(), [p.grad.clone() for p in
                                        model.parameters()
                                        if p.grad is not None]

    a, ga = run(0)
    a2, ga2 = run(0)
    c, _ = run(1)
    det, _ = run(None)
    assert np.isfinite(a) and all(torch.isfinite(g).all() for g in ga)
    assert a == a2 and all(torch.equal(x, y) for x, y in zip(ga, ga2))
    assert a != c and a != det


def test_training_refuses_dropout_as_jax_does(dropout_models, tmp_path):
    """The JAX training step calls compute_loss without a dropout rng, which
    flax refuses; the port's step and trainer refuse dropout > 0 too."""
    cfg, jmodel, params, model, batch = dropout_models
    jcfg = jax_tiny_config(dropout=0.1)
    state = jax_steps.TrainState.create(apply_fn=jmodel.apply, params=params,
                                        tx=jax_make_optimizer(jcfg))
    with pytest.raises(flax.errors.InvalidRngError):
        jax_steps.make_train_step(jmodel, donate=False)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
    with pytest.raises(ValueError, match="dropout"):
        steps.make_train_step(model, Optimizer(model.parameters(), cfg), cfg)
    with pytest.raises(ValueError, match="dropout"):
        trainer.Trainer(cfg, tmp_path, nb_sanity_val_steps=0).fit(
            model, [], None, niter=1)


def optimizer_cfg(**kw):
    return dict(optimizer="AdamW", base_lr=1e-2, weight_decay=1e-4,
                grad_clip=0.1, scheduler="step", scheduler_param=[1, 0.5],
                grad_accum_steps=2, **kw)


def test_grad_accumulation_matches_optax():
    """6 micro-steps of random gradients (clipped once accumulated), k = 2
    and 3: the parameters after each against optax.MultiSteps', unchanged
    between updates, the learning rate halving at each update (the
    schedule follows the updates, not the micro-steps)."""
    rng = np.random.RandomState(0)
    shapes = [(4, 3), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    grads = [[rng.randn(*s).astype(np.float32) for s in shapes]
             for _ in range(6)]
    for k in (2, 3):
        cfg = optimizer_cfg() | {"grad_accum_steps": k}
        tx = jax_make_optimizer(cfg)
        jp = [jnp.asarray(x) for x in init]
        jstate = tx.init(jp)
        params = [torch.tensor(x) for x in init]
        opt = Optimizer(params, cfg)
        for i, g in enumerate(grads):
            upd, jstate = tx.update([jnp.asarray(x) for x in g], jstate, jp)
            jp = optax.apply_updates(jp, upd)
            tg = [torch.tensor(x) for x in g]
            before = [p.clone() for p in params]
            opt.update(tg, float(torch.linalg.vector_norm(torch.stack(
                [t.norm() for t in tg]))))
            assert opt.position == ((i + 1) // k, (i + 1) % k)
            moved = any(not torch.equal(a, p) for a, p in zip(before,
                                                              params))
            assert moved == ((i + 1) % k == 0)
            for p, ref in zip(params, jp):
                np.testing.assert_allclose(p.numpy(), np.asarray(ref),
                                           rtol=1e-6, atol=1e-7)


def test_skipped_micro_step_leaves_state(tmp_path):
    """A non-finite micro-step leaves the parameters, moments, count,
    micro-step and mean as they were, as JAX's apply program does with its
    MultiSteps state; and a resume between micro-steps continues bitwise
    as the uninterrupted run."""
    cfg = optimizer_cfg()
    rng = np.random.RandomState(1)
    model = torch.nn.Linear(3, 2)
    grads = [[torch.tensor(rng.randn(*p.shape).astype(np.float32))
              for p in model.parameters()] for _ in range(3)]

    def micro(opt, g, total=1.0):
        g = [x.clone() for x in g]
        norm = torch.linalg.vector_norm(torch.stack([x.norm() for x in g]))
        return steps.apply(opt, g, norm, torch.tensor(total))

    opt = Optimizer(model.parameters(), cfg)
    assert not micro(opt, grads[0])
    snap = {k: [t.clone() for t in v] if isinstance(v, list) else v
            for k, v in opt.state_dict().items()}
    params = [p.detach().clone() for p in model.parameters()]
    assert micro(opt, [g * np.nan for g in grads[1]], total=float("nan"))
    for key, value in opt.state_dict().items():
        if isinstance(value, list):
            assert all(torch.equal(a, b) for a, b in zip(value, snap[key]))
        else:
            assert value == snap[key], key
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), params))

    # JAX: its apply program with a NaN loss keeps the MultiSteps state
    jparams = {"w": jnp.ones((3, 2)), "b": jnp.zeros(2)}
    state = jax_steps.TrainState.create(apply_fn=None, params=jparams,
                                        tx=jax_make_optimizer(cfg))
    jgrads = {"w": jnp.ones((3, 2)), "b": jnp.ones(2)}
    state = jax_steps.make_train_step(None, donate=False).apply_jit(
        state, jgrads, jnp.float32(1.0))[0]
    kept, skipped = jax_steps.make_train_step(None, donate=False).apply_jit(
        state, jgrads, jnp.float32(np.nan))
    assert float(skipped) == 1.0
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(
        lambda a, b: bool(jnp.array_equal(a, b, equal_nan=True)), kept,
        state))

    # a checkpoint after one micro-step, restored into a fresh optimizer
    saver = CheckpointManager(tmp_path / "ckpt")
    saver.save(1, model, opt)
    fresh = torch.nn.Linear(3, 2)
    fresh_opt = Optimizer(fresh.parameters(), cfg)
    assert saver.restore(fresh, fresh_opt) == 1
    assert fresh_opt.position == (0, 1)
    for o, m in ((opt, model), (fresh_opt, fresh)):
        assert not micro(o, grads[1]) and not micro(o, grads[2])
    assert opt.position == fresh_opt.position == (1, 1)
    for a, b in zip(list(model.parameters()) + opt.acc + opt.mu,
                    list(fresh.parameters()) + fresh_opt.acc + fresh_opt.mu):
        assert torch.equal(a, b)


def test_fit_with_grad_accumulation_matches_jax(tmp_path):
    """Both trainers over 4 micro-steps with grad_accum_steps 2 (2 updates;
    no validation) from JAX's initial parameters: the updates within the
    trainer tests' tolerance of JAX's (optax.MultiSteps)."""
    data = dict(DATA, grad_accum_steps=2)
    fit = dict(summary_every=2, validate_every=4, nb_sanity_val_steps=0)
    jcfg, cfg = jax_tiny_config(**data), tiny_config(**data)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(sys.modules, "tensorflow", None)
        jmodel = jax_create_model(jcfg, N0)
        state, jstep = jax_trainer.Trainer(jcfg, tmp_path / "jax", **fit).fit(
            jmodel, jax_get_dataloader(jcfg, "train", num_workers=0), None,
            niter=4)
        model = create_model(cfg, N0, "cpu")
        init = state_dict_from_jax(flat_params(jax_init(jmodel, 0)), model)
        model.load_state_dict(init)
        port = trainer.Trainer(cfg, tmp_path / "port", **fit)
        step = port.fit(model, get_dataloader(cfg, "train", num_workers=2),
                        None, niter=4)
    assert (jstep, step) == (4, 4)
    assert port.optimizer.position == (2, 0)
    ref = state_dict_from_jax(flat_params(state.params), model)
    num = sum(float((p.detach() - ref[n]).norm()) ** 2
              for n, p in model.named_parameters())
    den = sum(float((ref[n] - init[n]).norm()) ** 2
              for n, _ in model.named_parameters())
    assert den > 0 and (num / den) ** 0.5 <= UPDATE_TOL
