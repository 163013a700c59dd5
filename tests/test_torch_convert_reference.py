"""An upstream RegTR checkpoint into the port without JAX
(regtr_tpu_torch/convert.py `state_dict_from_reference`,
`reference_kernel_points`; python -m regtr_tpu_torch.convert_checkpoint).

The mapping is held bitwise to the JAX package's tools/convert_torch_ckpt.py
followed by `state_dict_from_jax`, on state_dicts in the reference's layout
(chip_smoke.py `reference_state_dict`, tests/test_converter.py's scheme)
for the tiny config, its deformable and attention-decoder variants and the
full widths of conf/3dmatch.yaml.  The command line runs where JAX, flax,
PyYAML and the JAX package cannot be imported.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.utils import kernel_points as jax_kernel_points
from regtr_tpu_torch.config import load_config, tiny_config
from regtr_tpu_torch.convert import (reference_kernel_points,
                                     state_dict_from_jax,
                                     state_dict_from_reference)
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.nn.blocks import KPConvLayer
from regtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                               load_params_npz,
                                               save_params_npz)
from regtr_tpu_torch.utils import kernel_points
from tests.test_converter import synth_reference_state_dict
from tests.test_torch_deformable import DEFORMABLE_ARCH
from tests.test_torch_eval import yaml_text
from tests.test_torch_model import GOLDEN

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
from convert_torch_ckpt import convert_state_dict  # noqa: E402

VARIANTS = {
    "tiny": lambda: tiny_config(),
    "deformable": lambda: tiny_config(architecture=DEFORMABLE_ARCH,
                                      modulated=True),
    "decoder": lambda: tiny_config(direct_regress_coor=False),
    "3dmatch": lambda: load_config(ROOT / "conf" / "3dmatch.yaml"),
}


def tool_state_dict(sd, cfg, model):
    """tools/convert_torch_ckpt.py's flax tree, flattened to 'a/b/c' keys,
    then the port's state_dict by `state_dict_from_jax`."""
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
            else:
                flat["/".join(prefix + (k,))] = v

    walk(convert_state_dict(sd, cfg), ())
    return state_dict_from_jax(flat, model)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_mapping_is_the_tools_bitwise(variant):
    cfg = VARIANTS[variant]()
    sd = chip_smoke.reference_state_dict(cfg, seed=0)
    model = create_model(cfg, 96, "cpu")
    got = state_dict_from_reference(sd, cfg)
    want = tool_state_dict(sd, cfg, model)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got[k], v), k
    if variant == "3dmatch":
        n = sum(v.numel() for v in got.values())
        assert round(n / 1e6, 2) == 11.85, n
    if variant == "deformable":
        assert sum(k.endswith("offset_weights") for k in got) == 3


def test_reference_layout_is_test_converters():
    """chip_smoke.py's reference state_dict has the names and shapes of
    tests/test_converter.py's (the tiny config), kernel points included."""
    cfg = tiny_config()
    ours = chip_smoke.reference_state_dict(cfg, seed=0)
    theirs = synth_reference_state_dict(cfg)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}


def test_unknown_key_raises_and_missing_is_left_out():
    cfg = tiny_config()
    sd = chip_smoke.reference_state_dict(cfg, seed=0)
    with pytest.raises(KeyError, match="does not know"):
        state_dict_from_reference(dict(sd, **{"extra.weight":
                                              torch.zeros(2)}), cfg)
    del sd["feature_criterion.W"]
    got = state_dict_from_reference(sd, cfg)
    assert "feature_criterion.W" not in got
    assert "feature_criterion_un.W" in got


def test_converted_forward_matches_jax():
    """The tiny config's forward on the golden pair with the converted
    weights, against the JAX forward with the tool's params
    (tests/test_torch_model.py's tolerances)."""
    cfg = tiny_config()
    sd = chip_smoke.reference_state_dict(cfg, seed=1)
    model = create_model(cfg, 96, "cpu")
    model.load_state_dict(state_dict_from_reference(sd, cfg))
    params = jax.tree_util.tree_map(jnp.asarray, convert_state_dict(sd, cfg))
    jmodel = jax_create_model(cfg, 96)
    data = np.load(GOLDEN)
    with torch.inference_mode():
        out = model(torch.from_numpy(data["points"]),
                    torch.from_numpy(data["mask"]))
    jout = jax.jit(lambda p, x, m: jmodel.apply({"params": p}, x, m))(
        params, jnp.asarray(data["points"]), jnp.asarray(data["mask"]))
    for key in ("pose", "overlap_logits", "corr"):
        np.testing.assert_allclose(out[key].numpy(), np.asarray(jout[key]),
                                   rtol=1e-3, atol=2e-4, err_msg=key)


def test_dispositions_reach_every_block(tmp_path):
    """reference_kernel_points -> .npz -> kernel_dispositions_file -> each
    block's kernel_points buffer, bitwise (the deformable variant: its
    offset branch's own dispositions are not a block's)."""
    cfg = VARIANTS["deformable"]()
    sd = chip_smoke.reference_state_dict(cfg, seed=2)
    disp = reference_kernel_points(sd)
    assert set(disp) == {k for k in sd if k.endswith("kernel_points")}
    np.savez(tmp_path / "kp.npz", **disp)
    model = create_model(dict(cfg, kernel_dispositions_file=str(
        tmp_path / "kp.npz")), 96, "cpu")
    convs = [m for m in model.modules() if isinstance(m, KPConvLayer)]
    assert len(convs) == 6
    for m in convs:
        want = sd[f"kpf_encoder.encoder_blocks.{m.block_index}.KPConv."
                  f"kernel_points"]
        assert torch.equal(m.kernel_points, want)


def test_disposition_ply_round_trip(tmp_path):
    """The reference's disposition cache: written by the port, read by the
    port and by the JAX package bitwise, and the other way round."""
    disp = np.random.RandomState(3).randn(15, 3).astype(np.float32)
    kernel_points.write_dispositions_ply(tmp_path / "ours.ply", disp)
    jax_kernel_points.write_dispositions_ply(tmp_path / "theirs.ply", disp)
    for path in ("ours.ply", "theirs.ply"):
        got = kernel_points.read_dispositions_ply(tmp_path / path)
        want = jax_kernel_points.read_dispositions_ply(tmp_path / path)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, disp)
    assert (tmp_path / "ours.ply").read_bytes() == \
        (tmp_path / "theirs.ply").read_bytes()


def run_blocked(*args, cwd=ROOT):
    """python -m regtr_tpu_torch.convert_checkpoint ARGS in an interpreter
    where jax, flax, yaml, the JAX package and tools cannot be imported."""
    proc = subprocess.run([sys.executable, "-c", chip_smoke.NO_JAX,
                           *map(str, args)], cwd=cwd, capture_output=True,
                          text=True, timeout=300,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


def test_command_line_converts_without_jax(tmp_path):
    """The upstream checkpoint ({'state_dict': ...}, the loss's W of one
    criterion missing) to params.npz and kp.npz: the loaded model's
    parameters are the mapping's, bitwise; the missing W keeps its seeded
    initial value, with a warning."""
    cfg = tiny_config()
    sd = chip_smoke.reference_state_dict(cfg, seed=4)
    del sd["feature_criterion_un.W"]
    torch.save({"state_dict": sd, "epoch": 3}, tmp_path / "ckpt.pth")
    (tmp_path / "tiny.yaml").write_text(yaml_text(cfg))
    proc = run_blocked(tmp_path / "ckpt.pth", "--config",
                       tmp_path / "tiny.yaml", "--out",
                       tmp_path / "params.npz", "--kernel_points",
                       tmp_path / "kp.npz")
    assert "feature_criterion_un.W" in proc.stderr
    model = load_params_npz(tmp_path / "params.npz",
                            create_model(cfg, 96, "cpu", seed=9))
    got, want = model.state_dict(), state_dict_from_reference(sd, cfg)
    init = create_model(cfg, 96, "cpu").state_dict()
    assert set(got) == set(want) | {"feature_criterion_un.W"}
    assert all(torch.equal(got[k], v) for k, v in want.items())
    assert torch.equal(got["feature_criterion_un.W"],
                       init["feature_criterion_un.W"])
    with np.load(tmp_path / "kp.npz") as kp:
        assert sorted(kp.files) == sorted(reference_kernel_points(sd))
        for k in kp.files:
            np.testing.assert_array_equal(kp[k], sd[k].numpy())


def test_command_line_exports_a_trainer_checkpoint(tmp_path):
    """--export RUN (the config found next to it): the best checkpoint's
    parameters, bitwise save_params_npz of the model it restores; --latest
    the last one."""
    cfg = tiny_config()
    run = tmp_path / "logs" / "run"
    run.mkdir(parents=True)
    (run / "config.yaml").write_text(yaml_text(cfg))
    saver = CheckpointManager(run / "ckpt")
    models = {step: create_model(cfg, 96, "cpu", seed=step)
              for step in (2, 4)}
    saver.save(2, models[2], score=1.0)
    saver.save(4, models[4], score=0.5)
    for flag, step in (([], 2), (["--latest"], 4)):
        out = tmp_path / f"export{step}.npz"
        proc = run_blocked("--export", run, "--out", out, *flag)
        assert f"step {step}" in proc.stdout
        save_params_npz(tmp_path / "want.npz", models[step])
        with np.load(out) as got, np.load(tmp_path / "want.npz") as want:
            assert sorted(got.files) == sorted(want.files)
            for k in want.files:
                np.testing.assert_array_equal(got[k], want[k])
