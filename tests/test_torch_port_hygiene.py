"""The port's boundaries: what it imports, its config loader, and the
parameter conversion from the JAX package."""
import glob
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from regtr_tpu.config import load_config as jax_load_config
from regtr_tpu.presets import modelnet_config as jax_modelnet_config
from regtr_tpu.presets import threedmatch_config as jax_threedmatch_config
from regtr_tpu.presets import tiny_config as jax_tiny_config
from regtr_tpu_torch import config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.models import create_model

ROOT = Path(__file__).resolve().parent.parent
CONFS = sorted(glob.glob(str(ROOT / "conf" / "*.yaml")))


def test_port_imports_no_jax_flax_or_yaml():
    code = (
        "import sys\n"
        "import regtr_tpu_torch, regtr_tpu_torch.models, "
        "regtr_tpu_torch.convert, regtr_tpu_torch.config, "
        "regtr_tpu_torch.ops.attention, regtr_tpu_torch.ops.kpconv, "
        "regtr_tpu_torch.losses.feature, regtr_tpu_torch.losses.corr, "
        "regtr_tpu_torch.losses.overlap, regtr_tpu_torch.data.collate, "
        "regtr_tpu_torch.data.overlap, regtr_tpu_torch.train.steps, "
        "regtr_tpu_torch.ops.gather, regtr_tpu_torch.core.se3_np, "
        "regtr_tpu_torch.data, regtr_tpu_torch.benchmark.predator, "
        "regtr_tpu_torch.train.checkpoints, "
        "regtr_tpu_torch.train.logging_utils, regtr_tpu_torch.evaluation, "
        "regtr_tpu_torch.test, regtr_tpu_torch.train.trainer, "
        "regtr_tpu_torch.train.__main__, regtr_tpu_torch.data.transforms, "
        "regtr_tpu_torch.data.modelnet, regtr_tpu_torch.data.synthetic, "
        "regtr_tpu_torch.data.modelnet_transforms, "
        "regtr_tpu_torch.benchmark.modelnet, regtr_tpu_torch.benchmark.dgr, "
        "regtr_tpu_torch.utils.xlsx, regtr_tpu_torch.utils.ply, "
        "regtr_tpu_torch.utils.viz, regtr_tpu_torch.data.calibrate, "
        "regtr_tpu_torch.evaluate_3dmatch, regtr_tpu_torch.calibrate, "
        "regtr_tpu_torch.demo, regtr_tpu_torch.compute_overlap\n"
        "from regtr_tpu_torch.config import threedmatch_config\n"
        "from regtr_tpu_torch.models import create_model\n"
        "create_model(threedmatch_config(first_feats_dim=16, d_embed=32, "
        "nhead=2, d_feedforward=32, num_encoder_layers=1), 64, 'cpu')\n"
        "import numpy as np\n"
        "from regtr_tpu_torch.config import tiny_config\n"
        "regtr_tpu_torch.register(np.random.rand(50, 3), np.random.rand(50, "
        "3), cfg=tiny_config(), device='cpu')\n"
        "import chip_smoke\n"
        "chip_smoke.synthetic_pairs(1, 500, seed=0)\n"
        "import torch\n"
        "from regtr_tpu_torch.data.collate import collate_pairs\n"
        "from regtr_tpu_torch.train.optim import Optimizer\n"
        "from regtr_tpu_torch.train.steps import make_train_step\n"
        "cfg = threedmatch_config(first_feats_dim=16, d_embed=32, nhead=2, "
        "d_feedforward=32, num_encoder_layers=1, overlap_loss_on=[0], "
        "feature_loss_on=[0], corr_loss_on=[0])\n"
        "model = create_model(cfg, 512, 'cpu')\n"
        "batch, _ = collate_pairs(chip_smoke.synthetic_samples(1, 500, 0, "
        "cfg), [512])\n"
        "batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}\n"
        "m = make_train_step(model, Optimizer(model.parameters(), cfg), "
        "cfg)(batch_t)\n"
        "assert m['update_skipped'] == 0.0, m\n"
        "from regtr_tpu_torch.config import load_config\n"
        "from regtr_tpu_torch.data import get_dataset\n"
        "syn = load_config('conf/synthetic.yaml')\n"
        "syn.update(num_points=256, synthetic_items=2)\n"
        "assert get_dataset(syn, 'train')[1]['src_xyz'].shape == (180, 3)\n"
        # (tqdm is not listed: some torch builds import it themselves; the
        # source check below keeps the port's own imports of it local)
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'yaml', 'optax', 'orbax', 'regtr_tpu', "
        "'tools', 'h5py', 'matplotlib')]\n"
        "from regtr_tpu_torch.nn.transformer import record_attention\n"
        "with record_attention(model) as maps:\n"
        "    model(batch_t['points'], batch_t['mask'])\n"
        "assert len(maps) == 2, sorted(maps)\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imported_roots(path):
    for line in path.read_text().splitlines():
        words = line.replace(",", " ").split()
        if words[:1] in (["import"], ["from"]):
            yield line, words[1].split(".")[0]


def test_port_sources_do_not_name_jax():
    # The port keeps its own copies of what it needs from the JAX package,
    # even of modules there that import no JAX.
    sources = list((ROOT / "regtr_tpu_torch").rglob("*.py"))
    for module in ("ops/gather.py", "test.py", "evaluation.py", "demo.py",
                   "calibrate.py", "evaluate_3dmatch.py",
                   "compute_overlap.py", "utils/viz.py", "data/calibrate.py"):
        assert ROOT / "regtr_tpu_torch" / module in sources
    for path in sources:
        for line, root in _imported_roots(path):
            assert root not in ("jax", "flax", "optax", "yaml", "regtr_tpu",
                                "tools"), (path, line)
            # absent where the port runs: imported only where they are used
            assert line[:1].isspace() or root not in (
                "orbax", "tqdm", "h5py", "matplotlib"), (path, line)
    # chip_smoke.py, and kernel_variants.py which it imports, run
    # where only torch and numpy are installed: they use the port alone, not
    # the JAX package nor its tools.
    for script in ("chip_smoke.py", "kernel_variants.py"):
        for line, root in _imported_roots(ROOT / script):
            assert root not in ("jax", "flax", "optax", "yaml", "regtr_tpu",
                                "tools"), (script, line)


@pytest.mark.parametrize("path", CONFS, ids=lambda p: Path(p).stem)
def test_config_loader_matches_pyyaml(path):
    assert config.load_config(path) == jax_load_config(path)


def test_presets_match():
    assert config.threedmatch_config() == jax_threedmatch_config()
    assert config.modelnet_config() == jax_modelnet_config()
    assert config.tiny_config(compute_dtype="bfloat16") == \
        jax_tiny_config(compute_dtype="bfloat16")


@pytest.mark.parametrize("text", [
    "a: 1\n",                      # scalar at top level
    "s:\n  - 1\n",                 # block list
    "s:\n  k: [1, 2\n",            # unterminated flow list
    "s:\n  k: {a: 1}\n",           # flow mapping
])
def test_config_loader_rejects_unsupported_yaml(text):
    with pytest.raises(ValueError):
        config.parse_yaml_sections(text)


def _jax_style_params(model):
    """The flat 'a/b/c' dict save_params_npz would write for this model,
    built from the port's own state_dict by the inverse mapping."""
    flat = {}
    linear_weights = {f"{n}.weight" for n, m in model.named_modules()
                      if isinstance(m, torch.nn.Linear)}
    for name, t in model.state_dict().items():
        path, leaf = name.rsplit(".", 1)
        path = path.replace(".", "/")
        if name in linear_weights:
            flat[f"{path}/kernel"] = t.numpy().T.copy()
        elif leaf == "weight":
            flat[f"{path}/scale"] = t.numpy().copy()
        else:
            flat[f"{path}/{leaf}"] = t.numpy().copy()
    return flat


@pytest.fixture(scope="module")
def small_model():
    return create_model(config.tiny_config(), 96, "cpu", seed=3)


def test_convert_fills_every_forward_param(small_model):
    flat = _jax_style_params(small_model)
    sd = state_dict_from_jax(flat, small_model)
    assert set(sd) == set(small_model.state_dict())
    for name, t in small_model.state_dict().items():
        torch.testing.assert_close(sd[name], t, rtol=0, atol=0)
    # every leaf is carried, the two InfoNCE matrices of the loss included
    assert {"feature_criterion/W", "feature_criterion_un/W"} <= set(flat)
    assert len(flat) == len(sd)


def test_convert_refuses_missing_and_unknown(small_model):
    flat = _jax_style_params(small_model)
    missing = dict(flat)
    del missing["transformer_encoder/layer_0/self_attn/q_proj/kernel"]
    with pytest.raises(KeyError, match="missing"):
        state_dict_from_jax(missing, small_model)
    unknown = dict(flat, **{"head/extra/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="no counterpart"):
        state_dict_from_jax(unknown, small_model)
    bad_shape = dict(flat)
    bad_shape["feat_proj/bias"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        state_dict_from_jax(bad_shape, small_model)


def test_seeded_init_is_reproducible():
    cfg = config.tiny_config()
    a = create_model(cfg, 96, "cpu", seed=11).state_dict()
    b = create_model(cfg, 96, "cpu", seed=11).state_dict()
    c = create_model(cfg, 96, "cpu", seed=12).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)
