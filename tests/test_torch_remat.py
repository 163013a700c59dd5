"""Rematerialization in the port (the JAX package's `remat` and
`remat_transformer`): each KPConv block, and each transformer layer, under
a non-reentrant `torch.utils.checkpoint`.

Recomputing a block must change nothing: the losses and every gradient are
bitwise those without remat, the tables' gather transposes are built as
often, a caller's dropout generator ends where it would, and the forward
with remat is held to the JAX package's own `remat: True` forward and
gradients at test_torch_train.py's tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.ops import kpconv as jax_kpconv
from regtr_tpu.ops import pyramid as jax_pyramid
from regtr_tpu.presets import tiny_config as jax_tiny_config
from regtr_tpu_torch.config import threedmatch_config, tiny_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.nn import blocks, transformer
from regtr_tpu_torch.ops.kpconv import GatherIndex
from tests.test_torch_deformable import DEFORMABLE_ARCH
from tests.test_torch_kpconv import to_torch_levels
from tests.test_torch_model import flat_params
from tests.test_torch_train import GRAD_TOL, golden_batch, rel_l2


def batch():
    return {k: torch.from_numpy(v) for k, v in golden_batch().items()}


def count_calls(monkeypatch):
    """Count the calls of every conv block's body and transformer layer."""
    calls = {"block": 0, "layer": 0}

    def counted(kind, fn):
        def run(*args, **kwargs):
            calls[kind] += 1
            return fn(*args, **kwargs)
        return run

    for cls in (blocks.SimpleBlock, blocks.ResnetBottleneckBlock):
        monkeypatch.setattr(cls, "block", counted("block", cls.block))
    monkeypatch.setattr(transformer.CrossEncoderLayer, "forward", counted(
        "layer", transformer.CrossEncoderLayer.forward))
    return calls


def step(cfg, b, dropout_seed=None):
    """compute_loss and its backward -> (losses, gradients by name, gather
    transposes built, the dropout generator's final state)."""
    model = create_model(cfg, 96, "cpu", seed=3)
    gen = (torch.Generator().manual_seed(dropout_seed)
           if dropout_seed is not None else None)
    builds = GatherIndex.builds
    losses, _ = model.compute_loss(b["points"], b["mask"], b["pose"],
                                   b["overlap0"], generator=gen)
    losses["total"].backward()
    grads = {n: p.grad for n, p in model.named_parameters()
             if p.grad is not None}
    return (losses, grads, GatherIndex.builds - builds,
            None if gen is None else gen.get_state())


OPTIONS = {
    "default": {},
    "deformable": dict(architecture=DEFORMABLE_ARCH, modulated=True),
    "dropout": dict(dropout=0.1),
}


@pytest.mark.parametrize("transformer_remat", [False, True],
                         ids=["backbone", "backbone_and_transformer"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_remat_gradients_are_bitwise(monkeypatch, option, transformer_remat):
    """With remat each block (and each layer) runs twice, forward and
    recompute; the losses, every gradient, the transposes built and the
    generator's state are bitwise those without."""
    b = batch()
    seed = 5 if option == "dropout" else None
    off = step(tiny_config(remat=False, **OPTIONS[option]), b, seed)
    calls = count_calls(monkeypatch)
    on = step(tiny_config(remat=True, remat_transformer=transformer_remat,
                          **OPTIONS[option]), b, seed)
    n_blocks = sum("simple" in a or "resnetb" in a
                   for a in tiny_config(**OPTIONS[option])["architecture"])
    assert calls == {"block": 2 * n_blocks,
                     "layer": 2 * 2 if transformer_remat else 2}
    assert off[0].keys() == on[0].keys()
    for k in off[0]:
        assert torch.equal(off[0][k], on[0][k]), k
    assert off[1].keys() == on[1].keys() and len(off[1]) > 50
    for k in off[1]:
        assert torch.equal(off[1][k], on[1][k]), k
    assert off[2] == on[2] > 0
    if seed is not None:
        assert torch.equal(off[3], on[3])


def test_remat_is_off_without_autograd(monkeypatch):
    """Inference runs each block once, remat or not."""
    calls = count_calls(monkeypatch)
    model = create_model(tiny_config(remat_transformer=True), 96, "cpu")
    b = batch()
    with torch.no_grad():
        model(b["points"], b["mask"])
    assert calls == {"block": 6, "layer": 2}     # 6 conv blocks


def test_remat_defaults_follow_jax():
    """`remat` defaults to True (the backbone is recomputed where a config
    does not say), `remat_transformer` to False; conf/3dmatch.yaml turns
    the backbone's off."""
    for cfg, want in ((tiny_config(), True),
                      (threedmatch_config(first_feats_dim=16), False)):
        model = create_model(cfg, 96, "cpu")
        found = {m.remat for m in model.modules()
                 if isinstance(m, (blocks.SimpleBlock,
                                   blocks.ResnetBottleneckBlock))}
        assert found == {want}
        assert model.transformer_encoder.remat is False


def test_remat_matches_jax_remat():
    """The JAX package's `remat` and `remat_transformer` against the
    port's, on the JAX pyramid's tables: every loss and the gradient of
    every leaf within test_torch_train.py's tolerance."""
    data = golden_batch()
    jcfg = jax_tiny_config(attention_impl="pallas_interpret", remat=True,
                           remat_transformer=True)
    jmodel = jax_create_model(jcfg, 96)
    params = init_model_params(jmodel, jax.random.PRNGKey(42))["params"]
    jb = {k: jnp.asarray(v) for k, v in data.items()}

    def loss_fn(p):
        losses, _ = jmodel.apply({"params": p}, jb["points"], jb["mask"],
                                 jb["pose"], jb["overlap0"],
                                 method=jmodel.compute_loss)
        return losses["total"], losses

    jax_kpconv.set_segsum_impl("pallas")
    try:
        jgrads, jlosses = jax.jit(jax.grad(loss_fn, has_aux=True))(params)
    finally:
        jax_kpconv.set_segsum_impl("auto")
    jlevels = jax.jit(lambda x, m: jax_pyramid.build_pyramid(
        x, m, jmodel.spec, chunk=int(jcfg["neighbor_chunk"]),
        recall_target=float(jcfg["neighbor_recall"])))(jb["points"],
                                                        jb["mask"])
    model = create_model(tiny_config(remat=True, remat_transformer=True), 96,
                         "cpu")
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    b = batch()
    losses, _ = model.loss_levels(to_torch_levels(jlevels), b["pose"],
                                  b["overlap0"])
    losses["total"].backward()
    for k, v in jlosses.items():
        np.testing.assert_allclose(losses[k].item(), float(v), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    ref = state_dict_from_jax(flat_params(jgrads), model)
    for name, p in model.named_parameters():
        want = ref[name].numpy()
        if np.linalg.norm(want) < 1e-6:
            np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-7)
            continue
        assert rel_l2(p.grad.numpy(), want) <= GRAD_TOL, name
