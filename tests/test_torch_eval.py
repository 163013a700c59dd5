"""Port parity for the 3DMatch test protocol on the CPU: se3_np, the
dataset, the loader, the Predator scorer, the .npz parameters, run_test
and the port's command line, against the JAX package on a miniature data
root in the real on-disk formats (tests/synth_threedmatch.py).
"""
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from regtr_tpu.benchmark import predator as jax_predator
from regtr_tpu.core import se3_np as jax_se3
from regtr_tpu.data import get_dataloader as jax_get_dataloader
from regtr_tpu.data.threedmatch import ThreeDMatchDataset as JaxDataset
from regtr_tpu.evaluation import run_test as jax_run_test
from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu.train import checkpoints as jax_checkpoints
from regtr_tpu_torch import test as port_cli
from regtr_tpu_torch.benchmark import predator
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.core import se3_np
from regtr_tpu_torch.data import get_dataloader, get_dataset
from regtr_tpu_torch.data.overlap import compute_overlap
from regtr_tpu_torch.data.prefetch import DataLoader
from regtr_tpu_torch.data.threedmatch import ThreeDMatchDataset
from regtr_tpu_torch.evaluation import run_test
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                               load_params_npz,
                                               save_params_npz)
from tests.synth_threedmatch import PAIRS, SCENE, build_root, tiny_cfg
from tests.test_torch_model import flat_params

ROOT = Path(__file__).resolve().parent.parent
# The model of the protocol tests is built for a level-0 capacity above
# the batches' bucket, as the command line builds it at the largest
# bucket: level 0 follows the batch, levels >= 1 the spec's capacities.
N0_MODEL = 1024


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_root(tmp_path_factory.mktemp("root"))


def protocol_cfg(root):
    """tiny_cfg on the root, cut to 512 points per cloud, on a 3 cm grid
    with K 40: no neighborhood fills its K (checked below), so the tables
    hold no bf16 tie at the K-th slot that XLA and PyTorch could break
    differently."""
    cfg = tiny_cfg(root, root / "meta")
    cfg.update(buckets=[512], first_subsampling_dl=0.03,
               neighborhood_limits=[40, 40, 40, 40], benchmark="3DMatch")
    return cfg


def assert_same(a, b):
    """Bitwise equal values of equal type (arrays, scalars, lists)."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    else:
        assert type(a) is type(b) and a == b, (a, b)


def test_se3_np_matches_jax():
    rng = np.random.RandomState(0)
    rot = np.stack([jax_se3.sample_uniform_rotation(rng) for _ in range(5)])
    trans = rng.randn(5, 3).astype(np.float32)
    for t in (trans, trans[..., None]):
        assert_same(se3_np.se3_init(rot, t), jax_se3.se3_init(rot, t))
    assert_same(se3_np.se3_init(), jax_se3.se3_init())
    a = jax_se3.se3_init(rot, trans)
    b = jax_se3.se3_init(rot[::-1].copy(), trans[::-1].copy())
    xyz = rng.randn(5, 40, 3).astype(np.float32)
    assert_same(se3_np.se3_cat(a, b), jax_se3.se3_cat(a, b))
    assert_same(se3_np.se3_inv(a), jax_se3.se3_inv(a))
    assert_same(se3_np.se3_transform(a, xyz), jax_se3.se3_transform(a, xyz))
    got, ref = se3_np.se3_compare(a, b), jax_se3.se3_compare(a, b)
    for key in ("rot_deg", "trans"):
        assert_same(got[key], ref[key])


def write_overlap_h5(root, cfg):
    """The precomputed masks, at another radius than the config's, so that
    a sample shows where its masks came from."""
    import h5py

    with open(root / "meta" / "test_3DMatch_info.pkl", "rb") as f:
        infos = pickle.load(f)
    with h5py.File(root / "test_3DMatch_pairs-overlapmask.h5", "w") as h5:
        for i in range(len(infos["rot"])):
            src = torch.load(root / infos["src"][i], weights_only=False)
            tgt = torch.load(root / infos["tgt"][i], weights_only=False)
            pose = jax_se3.se3_init(infos["rot"][i].astype(np.float32),
                                    infos["trans"][i].astype(np.float32))
            sm, tm, corr = compute_overlap(
                jax_se3.se3_transform(pose, src.numpy()), tgt.numpy(),
                2.0 * cfg["overlap_radius"])
            grp = h5.create_group(f"pair_{i:06d}")
            grp["src_mask"], grp["tgt_mask"] = sm, tm
            grp["src_tgt_corr"] = corr
    return infos


@pytest.mark.parametrize("h5", [False, True], ids=["on_the_fly", "h5"])
def test_dataset_samples_match_jax(root, tmp_path, h5):
    cfg = protocol_cfg(root)
    if h5:
        cfg = protocol_cfg(build_root(tmp_path / "root"))
        write_overlap_h5(Path(cfg["root"]), cfg)
    port = ThreeDMatchDataset(cfg, "test", metadata_dir=cfg["metadata_dir"])
    ref = JaxDataset(cfg, "test", metadata_dir=cfg["metadata_dir"])
    assert (port.pairs_data is not None) == h5
    assert len(port) == len(ref) == len(PAIRS)
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert got.keys() == want.keys()
        for key in want:
            assert_same(got[key], want[key])
        if h5:
            grp = port.pairs_data[f"pair_{i:06d}"]
            np.testing.assert_array_equal(got["src_overlap"],
                                          grp["src_mask"][()])


@pytest.mark.parametrize("phase,workers", [("test", 0), ("test", 2),
                                           ("val", 2)])
def test_loader_batches_match_jax(root, phase, workers):
    """Order and contents of every batch.  With buckets [3300, 3500] the
    second pair falls in the smaller bucket, so the size-grouped test
    loader sends pairs 0 and 2 first; val pads its last batch."""
    cfg = protocol_cfg(root)
    cfg["buckets"] = [3300, 3500]
    got = list(get_dataloader(cfg, phase, num_workers=workers))
    want = list(jax_get_dataloader(cfg, phase, num_workers=workers))
    assert len(got) == len(want) == 2
    for (gb, gm), (wb, wm) in zip(got, want):
        assert gb.keys() == wb.keys() and gm.keys() == wm.keys()
        for key in wb:
            assert_same(gb[key], wb[key])
        for key in wm:
            assert_same(gm[key], wm[key])
    first = [0, 2] if phase == "test" else [0, 1]
    assert got[0][1]["idx"] == first
    assert got[1][1]["idx"] == ([1] if phase == "test" else [2, 0])


def test_loader_and_dataset_refuse_what_is_not_ported(root):
    """A shard whose rank is not below its world raises (the shards are
    tests/test_torch_distributed.py's); unknown phases and datasets raise.
    (The 3DMatch train phase and the ModelNet and synthetic datasets are
    ported: tests/test_torch_train_data.py.)"""
    cfg = protocol_cfg(root)
    with pytest.raises(ValueError, match="rank not in"):
        DataLoader([], 1, list, shard=(2, 2))
    assert len(DataLoader(list(range(5)), 1, list, shard=(1, 2))) == 2
    with pytest.raises(ValueError, match="unknown phase"):
        get_dataset(cfg, "calibration")
    with pytest.raises(ValueError, match="unknown dataset"):
        get_dataset(dict(cfg, dataset="kitti"), "test")
    assert len(get_dataset(cfg, "train")) == len(PAIRS)


def write_est_folder(folder, gt_pairs, gt_traj, offsets):
    """est.log from the GT poses with each pair's translation moved by
    offsets[i] metres along x."""
    for (i, j, _), pose, off in zip(gt_pairs, gt_traj, offsets):
        moved = pose.copy()
        moved[0, 3] += off
        scene = folder / SCENE
        scene.mkdir(parents=True, exist_ok=True)
        predator.write_est_log(scene / "est.log", i, j, moved)


@pytest.mark.parametrize("offsets,recall", [
    ((0.0, 0.0, 0.0), 1.0),
    ((0.15, 0.19, 0.0), 1.0),       # error 0.0225, 0.0361 < 0.2 ** 2
    ((0.21, 0.25, 0.5), 0.0),       # above it
    ((0.0, 0.21, 0.19), 2 / 3),
])
def test_predator_scorer_matches_jax(root, tmp_path, offsets, recall):
    """gt.info is 100 * identity, so the error is the squared translation
    offset."""
    gt_dir = root / "benchmarks" / "3DMatch"
    gt_pairs, gt_traj = predator.read_trajectory(gt_dir / SCENE / "gt.log")
    for side in ("port", "jax"):
        write_est_folder(tmp_path / side, gt_pairs, gt_traj, offsets)
    assert ((tmp_path / "port" / SCENE / "est.log").read_text()
            == (tmp_path / "jax" / SCENE / "est.log").read_text())
    report, got = predator.benchmark(str(tmp_path / "port"), str(gt_dir))
    want_report, want = jax_predator.benchmark(str(tmp_path / "jax"),
                                               str(gt_dir))
    assert report == want_report
    assert got == want == pytest.approx(recall)
    for name in ("flag.npy", "errors.npy"):
        assert_same(np.load(tmp_path / "port" / SCENE / name),
                    np.load(tmp_path / "jax" / SCENE / name))
    assert_same(predator.read_trajectory_info(gt_dir / SCENE / "gt.info"),
                jax_predator.read_trajectory_info(gt_dir / SCENE / "gt.info"))


@pytest.fixture(scope="module")
def protocol_runs(root, tmp_path_factory):
    """run_test of the JAX package and of the port on the same params."""
    cfg = protocol_cfg(root)
    out = tmp_path_factory.mktemp("protocol")
    jmodel = jax_create_model(cfg, N0_MODEL)
    params = init_model_params(jmodel, jax.random.PRNGKey(0))["params"]
    jax_results = jax_run_test(
        cfg, jmodel, params, jax_get_dataloader(cfg, "test", num_workers=0),
        out / "jax", gt_benchmark_dir=str(root / "benchmarks"))
    model = create_model(cfg, N0_MODEL, "cpu")
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    results = run_test(cfg, model, get_dataloader(cfg, "test", num_workers=2),
                       out / "port", gt_benchmark_dir=str(root / "benchmarks"))
    return dict(cfg=cfg, out=out, params=params, model=model,
                results=results, jax_results=jax_results)


def test_run_test_matches_jax(protocol_runs, root):
    """The same pairs in the same order; poses and per-pair errors within
    tests/test_golden.py's fp32 tolerance (the forward sums in another
    order than XLA's; the pose is a weighted Kabsch solve of the
    outputs)."""
    runs = protocol_runs
    model, cfg = runs["model"], runs["cfg"]
    # Precondition: no neighborhood fills its K at any level.
    for batch, _ in get_dataloader(cfg, "test", num_workers=0):
        levels = model.preprocess(torch.from_numpy(batch["points"]),
                                  torch.from_numpy(batch["mask"]))
        assert levels[0].points.shape[1] < model.spec.capacities[0]
        for li, lv in enumerate(levels):
            for name in ("neighbors", "pools", "upsamples"):
                table = getattr(lv, name)
                if table is None:
                    continue
                ns = (levels[li + 1] if name == "upsamples"
                      else lv).points.shape[1]
                assert int((table < ns).sum(-1).max()) < table.shape[-1]

    est = "3DMatch/" + SCENE + "/est.log"
    pairs, poses = predator.read_trajectory(runs["out"] / "port" / est)
    jpairs, jposes = jax_predator.read_trajectory(runs["out"] / "jax" / est)
    np.testing.assert_array_equal(pairs, jpairs)
    assert [tuple(p[:2]) for p in pairs] == PAIRS
    np.testing.assert_allclose(poses, jposes, rtol=1e-3, atol=2e-4)
    _, gt = predator.read_trajectory(root / "benchmarks" / "3DMatch" / SCENE
                                     / "gt.log")
    err = se3_np.se3_compare(poses[:, :3], gt[:, :3])
    jerr = se3_np.se3_compare(jposes[:, :3], gt[:, :3])
    # a pose within 2e-4 moves the angle by at most ~1e-3 rad
    np.testing.assert_allclose(err["rot_deg"], jerr["rot_deg"], rtol=1e-3,
                               atol=0.06)
    np.testing.assert_allclose(err["trans"], jerr["trans"], rtol=1e-3,
                               atol=6e-4)
    results, want = runs["results"], runs["jax_results"]
    assert results.keys() == want.keys()
    assert results["reg_success"] == want["reg_success"]
    assert results["registration_recall"] == want["registration_recall"]
    for key in ("rot_err_deg_mean", "trans_err_mean"):
        assert results[key] == pytest.approx(want[key], rel=1e-3, abs=0.06)
    report = (runs["out"] / "port" / "benchmark_report.txt").read_text()
    assert report == (runs["out"] / "jax" / "benchmark_report.txt"
                      ).read_text()


def test_params_npz_round_trip(protocol_runs, tmp_path, caplog):
    """JAX save -> port load -> port save -> JAX load is bitwise, and the
    port refuses archives of another model."""
    params, model = protocol_runs["params"], protocol_runs["model"]
    jax_checkpoints.save_params_npz(tmp_path / "a.npz", params)
    model = create_model(protocol_runs["cfg"], N0_MODEL, "cpu", seed=5)
    load_params_npz(tmp_path / "a.npz", model)
    save_params_npz(tmp_path / "b.npz", model)
    back = jax_checkpoints.load_params_npz(tmp_path / "b.npz", params)
    for (_, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            jax.tree_util.tree_leaves(back)):
        assert_same(np.asarray(b), np.asarray(a))

    flat = dict(np.load(tmp_path / "a.npz"))
    one = sorted(flat)[0]
    np.savez(tmp_path / "c.npz", **{k: v for k, v in flat.items()
                                    if k != one})
    kept = {k: v.clone() for k, v in model.state_dict().items()}
    load_params_npz(tmp_path / "c.npz", model)
    assert "1 params not in" in caplog.text
    assert all(torch.equal(kept[k], v) for k, v in model.state_dict().items())
    np.savez(tmp_path / "d.npz", **dict(list(flat.items())[:3]))
    with pytest.raises(ValueError, match="matches only"):
        load_params_npz(tmp_path / "d.npz", model)
    np.savez(tmp_path / "e.npz", **flat, **{"head/extra/bias": np.zeros(2)})
    with pytest.raises(KeyError, match="no counterpart"):
        load_params_npz(tmp_path / "e.npz", model)


def yaml_text(cfg):
    """cfg as the two-level YAML subset the config loaders read."""
    def scalar(v):
        if v is None:
            return "null"
        if isinstance(v, bool):
            return "true" if v else "false"
        if isinstance(v, str):
            return "'" + v.replace("'", "''") + "'"
        return repr(v)

    lines = ["all:"]
    for key, v in cfg.items():
        text = ("[" + ", ".join(scalar(x) for x in v) + "]"
                if isinstance(v, list) else scalar(v))
        lines.append(f"    {key}: {text}")
    return "\n".join(lines) + "\n"


def test_cli_runs_on_cpu(protocol_runs, root, tmp_path):
    """python -m regtr_tpu_torch.test --device cpu: the config found next
    to the params, the metadata and the GT trajectories at their default
    places under the working directory, est.log and the report written."""
    cfg = {k: v for k, v in protocol_runs["cfg"].items()
           if k not in ("metadata_dir", "benchmark", "config_path")}
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.yaml").write_text(yaml_text(cfg))
    save_params_npz(ckpt / "params.npz", protocol_runs["model"])
    work = tmp_path / "work"
    meta = work / "datasets" / "3dmatch"
    meta.mkdir(parents=True)
    shutil.copy(root / "meta" / "test_3DMatch_info.pkl", meta)
    shutil.copytree(root / "benchmarks", meta / "benchmarks")
    proc = subprocess.run(
        [sys.executable, "-m", "regtr_tpu_torch.test", "--params",
         str(ckpt / "params.npz"), "--benchmark", "3DMatch", "--logdir",
         str(tmp_path / "logs"), "--device", "cpu", "--num_workers", "2"],
        cwd=work, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (logdir,) = (tmp_path / "logs").iterdir()
    pairs, poses = predator.read_trajectory(logdir / "3DMatch" / SCENE
                                            / "est.log")
    assert [tuple(p[:2]) for p in pairs] == PAIRS
    assert np.isfinite(poses).all()
    assert (logdir / "benchmark_report.txt").exists()
    assert "registration_recall" in (logdir / "log.txt").read_text()


def test_cli_resume_restores_the_best_checkpoint(protocol_runs, tmp_path):
    """--resume <run dir>: the checkpoint best.json names (step 2, the
    protocol's parameters, between two checkpoints of other parameters)
    gives the est.log that --params of the same weights gives."""
    cfg = {k: v for k, v in protocol_runs["cfg"].items()
           if k not in ("benchmark", "config_path")}
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text(yaml_text(cfg))
    saver = CheckpointManager(run / "ckpt")
    model = protocol_runs["model"]
    for step, seed, score in ((1, 5, 0.2), (2, None, 0.9), (3, 6, 0.5)):
        saver.save(step, model if seed is None else create_model(
            protocol_runs["cfg"], N0_MODEL, "cpu", seed=seed), score=score)
    save_params_npz(tmp_path / "params.npz", model)
    common = ["--benchmark", "3DMatch", "--device", "cpu", "--num_workers",
              "0"]
    port_cli.main(["--resume", str(run), "--logdir", str(tmp_path / "a"),
                   *common])
    port_cli.main(["--params", str(tmp_path / "params.npz"), "--config",
                   str(run / "config.yaml"), "--logdir",
                   str(tmp_path / "b"), *common])
    (a,), (b,) = (tmp_path / "a").iterdir(), (tmp_path / "b").iterdir()
    est = Path("3DMatch") / SCENE / "est.log"
    assert (a / est).read_text() == (b / est).read_text()
    assert "Loaded checkpoint at step 2" in (a / "log.txt").read_text()


def test_cli_refuses_what_is_not_ported(tmp_path):
    """No parameters; a benchmark on a config of another dataset (the
    ModelNet protocol is ported: tests/test_torch_modelnet_eval.py); the
    card where there is none."""
    with pytest.raises(SystemExit, match="one of --resume / --params"):
        port_cli.main([])
    for bench, conf, want in (("ModelNet", "3dmatch", "modelnet or synthetic"),
                              ("3DMatch", "modelnet", "3dmatch config")):
        with pytest.raises(SystemExit, match=want):
            port_cli.main(["--params", str(tmp_path / "p.npz"), "--config",
                           str(ROOT / "conf" / f"{conf}.yaml"),
                           "--benchmark", bench, "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            port_cli.main(["--params", str(tmp_path / "p.npz")])
