"""Port parity for the ModelNet / ModelLoNet test protocol on the CPU: the
pose metrics (benchmark/modelnet.py), the modelnet / synthetic branch of
run_test and `python -m regtr_tpu_torch.test --benchmark ModelNet |
ModelLoNet`, against the JAX package on the synthetic shapes (the
ModelNet HDF5 shards are not in the repository).
"""
import logging

import jax
import numpy as np
import pytest
import torch

import regtr_tpu_torch.data as port_data
from regtr_tpu import evaluation as jax_evaluation
from regtr_tpu.benchmark import modelnet as jax_modelnet
from regtr_tpu.core import se3_np as jax_se3
from regtr_tpu.data import get_dataloader as jax_get_dataloader
from regtr_tpu.data import get_dataset as jax_get_dataset
from regtr_tpu.evaluation import run_test as jax_run_test
from regtr_tpu.models import create_model as jax_create_model
from regtr_tpu.models import init_model_params
from regtr_tpu_torch import evaluation
from regtr_tpu_torch import test as port_cli
from regtr_tpu_torch.benchmark import modelnet
from regtr_tpu_torch.config import tiny_config
from regtr_tpu_torch.convert import state_dict_from_jax
from regtr_tpu_torch.data import get_dataloader, get_dataset
from regtr_tpu_torch.evaluation import run_test
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                               save_params_npz)
from tests.test_torch_eval import assert_same, yaml_text
from tests.test_torch_model import flat_params


def random_poses(rng, n):
    rot = np.stack([jax_se3.sample_uniform_rotation(rng) for _ in range(n)])
    return jax_se3.se3_init(rot, rng.randn(n, 3).astype(np.float32))


def test_metrics_match_jax():
    """compute_metrics on a batch and on ragged pairs, summarize_metrics
    and print_metrics: bitwise the JAX module's."""
    rng = np.random.RandomState(3)
    gt, pred = random_poses(rng, 4), random_poses(rng, 4)
    pred[1] = gt[1]                          # one exact pose: errors 0
    data = {"points_src": rng.randn(4, 50, 3).astype(np.float32),
            "points_ref": rng.randn(4, 40, 3).astype(np.float32),
            "points_raw": rng.randn(4, 70, 3).astype(np.float32),
            "transform_gt": gt}
    got = modelnet.compute_metrics(data, pred)
    want = jax_modelnet.compute_metrics(data, pred)
    assert tuple(got) == tuple(want) == modelnet.METRIC_KEYS \
        == jax_modelnet.METRIC_KEYS
    for key in want:
        assert_same(got[key], want[key])
    assert got["err_r_deg"][1] == 0.0 and got["err_t"][1] == 0.0
    assert_same(modelnet.dcm2euler(gt[:, :3, :3]),
                jax_modelnet.dcm2euler(gt[:, :3, :3]))
    summary = modelnet.summarize_metrics(got)
    assert summary == jax_modelnet.summarize_metrics(want)

    # ragged: a batch of 3 pairs whose clouds hold 30, 45 and 60 points
    counts = (30, 45, 60)
    batch = {"points": rng.randn(6, 64, 3).astype(np.float32),
             "mask": np.zeros((6, 64), bool), "pose": gt[:3]}
    for i, c in enumerate(counts):
        batch["mask"][2 * i, :c] = batch["mask"][2 * i + 1, :c + 3] = True
    meta = {"tgt_raw": [rng.randn(c + 9, 3).astype(np.float32)
                        for c in counts]}
    got = evaluation._modelnet_metrics_ragged(batch, meta, pred[:3])
    want = jax_evaluation._modelnet_metrics_ragged({
        "points_src": jax_evaluation._ragged_valid(batch, 0),
        "points_ref": jax_evaluation._ragged_valid(batch, 1),
        "points_raw": meta["tgt_raw"], "transform_gt": batch["pose"]},
        pred[:3])
    for key in want:
        assert_same(got[key], want[key])

    logs = []
    for module in (modelnet, jax_modelnet):
        logger = logging.getLogger(f"metrics_{module.__name__}")
        records = []
        handler = logging.Handler()
        handler.emit = records.append
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        module.print_metrics(logger, summary)
        logger.removeHandler(handler)
        logs.append([r.getMessage() for r in records])
    assert logs[0] == logs[1] and len(logs[0]) == 5


def protocol_cfg(**overrides):
    """The tiny config on the synthetic shapes at 256 points (180 after the
    crop), K 40: no neighborhood fills its K (checked below), so the
    tables hold no bf16 tie at the K-th slot that XLA and PyTorch could
    break differently."""
    cfg = tiny_config(dataset="synthetic", synthetic_items=4, num_points=256,
                      test_batch_size=2, buckets=[192, 256],
                      neighborhood_limits=[40, 40])
    cfg.update(overrides)
    return cfg


@pytest.fixture(scope="module")
def protocol_runs(tmp_path_factory):
    """run_test of the JAX package and of the port on the same params, the
    model at the largest bucket as the command line builds it."""
    cfg = protocol_cfg()
    out = tmp_path_factory.mktemp("modelnet_protocol")
    n0 = max(cfg["buckets"])
    jmodel = jax_create_model(cfg, n0)
    params = init_model_params(jmodel, jax.random.PRNGKey(0))["params"]
    jax_results = jax_run_test(cfg, jmodel, params,
                               jax_get_dataloader(cfg, "test", num_workers=0),
                               out / "jax")
    model = create_model(cfg, n0, "cpu")
    model.load_state_dict(state_dict_from_jax(flat_params(params), model))
    results = run_test(cfg, model, get_dataloader(cfg, "test", num_workers=2),
                       out / "port")
    return dict(cfg=cfg, out=out, model=model, results=results,
                jax_results=jax_results)


# Summary metrics, port vs JAX: (rtol, atol).  A pose within 2e-4 moves an
# angle by at most ~1e-3 rad (0.06 degrees) and a translation by ~2e-4.
SUMMARY_TOL = {
    "rot_err_deg_mean": (1e-3, 0.06), "err_r_deg_mean": (1e-3, 0.06),
    "err_r_deg_rmse": (1e-3, 0.06), "r_rmse": (1e-3, 0.06),
    "r_mae": (1e-3, 0.06), "trans_err_mean": (1e-3, 6e-4),
    "err_t_mean": (1e-3, 6e-4), "err_t_rmse": (1e-3, 6e-4),
    "t_rmse": (1e-3, 6e-4), "t_mae": (1e-3, 6e-4),
    "chamfer_dist": (1e-3, 1e-4), "reg_success": (0.0, 0.0),
}


def test_run_test_matches_jax(protocol_runs):
    """Poses in dataset order within tests/test_torch_eval.py's protocol
    tolerance, every summary metric within SUMMARY_TOL."""
    runs = protocol_runs
    model, cfg = runs["model"], runs["cfg"]
    # Precondition: no neighborhood fills its K at any level.
    for batch, _ in get_dataloader(cfg, "test", num_workers=0):
        levels = model.preprocess(torch.from_numpy(batch["points"]),
                                  torch.from_numpy(batch["mask"]))
        for li, lv in enumerate(levels):
            for name in ("neighbors", "pools", "upsamples"):
                table = getattr(lv, name)
                if table is None:
                    continue
                ns = (levels[li + 1] if name == "upsamples"
                      else lv).points.shape[1]
                assert int((table < ns).sum(-1).max()) < table.shape[-1]
    poses = np.load(runs["out"] / "port" / "pred_transforms.npy")
    jposes = np.load(runs["out"] / "jax" / "pred_transforms.npy")
    assert poses.shape == jposes.shape == (cfg["synthetic_items"], 3, 4)
    np.testing.assert_allclose(poses, jposes, rtol=1e-3, atol=2e-4)
    results, want = runs["results"], runs["jax_results"]
    assert results.keys() == want.keys() == SUMMARY_TOL.keys()
    for key, (rtol, atol) in SUMMARY_TOL.items():
        assert results[key] == pytest.approx(want[key], rel=rtol, abs=atol)


def test_pred_transforms_in_dataset_order(tmp_path, monkeypatch):
    """Pairs of alternating sizes in buckets 128 and 192: the size-grouped
    loader sends them out of dataset order, and pred_transforms.npy row i
    is still sample i's pose, grouped and ungrouped, bitwise the pose of
    the sample run alone at the same bucket.  (The bucket a pair is padded
    to moves its pose, in the JAX package as in the port: 0.044 on the
    first pair here between 128 and 192, so the grouped and ungrouped
    files are each held to runs at their own buckets.)"""
    cfg = protocol_cfg(synthetic_items=6, buckets=[128, 192])
    base = get_dataset(cfg, "test")
    sizes = [100, 180, 110, 170, 105, 175]

    class Varied:
        def __len__(self):
            return len(base)

        def __getitem__(self, i):
            s = dict(base[i])
            for key in ("src_xyz", "src_overlap", "tgt_xyz", "tgt_overlap"):
                s[key] = s[key][:sizes[i]]
            return s

    monkeypatch.setattr(port_data, "get_dataset", lambda c, p: Varied())
    model = create_model(cfg, 192, "cpu")
    poses = {}
    for name, grouped, batch_size, buckets in (
            ("grouped", True, 2, [128, 192]), ("plain", False, 2, [128, 192]),
            ("alone", True, 1, [128, 192]), ("alone at 192", True, 1, [192])):
        run_cfg = dict(cfg, bucket_grouped_test=grouped,
                       test_batch_size=batch_size, buckets=buckets)
        loader = get_dataloader(run_cfg, "test", num_workers=0)
        order = [i for _, meta in loader for i in meta["idx"]]
        assert (order == [0, 2, 1, 3, 4, 5]) == (name == "grouped"), order
        run_test(run_cfg, model, loader, tmp_path / name)
        poses[name] = np.load(tmp_path / name / "pred_transforms.npy")
    assert poses["grouped"].shape == (6, 3, 4)
    assert_same(poses["grouped"], poses["alone"])
    assert_same(poses["plain"], poses["alone at 192"])
    assert_same(poses["grouped"][1::2], poses["plain"][1::2])
    with pytest.raises(ValueError, match="kitti"):
        run_test(dict(cfg, dataset="kitti"), model, [], tmp_path / "kitti")


@pytest.mark.parametrize("partial,kept", [([0.7, 0.7], 180),
                                           ([0.5, 0.5], 128)],
                         ids=["ModelNet", "ModelLoNet"])
def test_crops_match_jax(partial, kept):
    """The test samples the CLI's crop gives, bitwise the JAX package's."""
    cfg = protocol_cfg(partial=partial)
    port, ref = get_dataset(cfg, "test"), jax_get_dataset(cfg, "test")
    assert len(port) == len(ref) == cfg["synthetic_items"]
    for i in range(len(ref)):
        got, want = port[i], ref[i]
        assert got.keys() == want.keys()
        for key in want:
            assert_same(got[key], want[key])
    # the crop keeps its fraction of the 256 points
    assert {len(port[i]["src_xyz"]) for i in range(len(port))} == {kept}


def write_params(protocol_runs, ckpt):
    cfg = {k: v for k, v in protocol_runs["cfg"].items()
           if k not in ("benchmark", "config_path")}
    ckpt.mkdir()
    (ckpt / "config.yaml").write_text(yaml_text(cfg))
    save_params_npz(ckpt / "params.npz", protocol_runs["model"])


@pytest.mark.parametrize("bench", ["ModelNet", "ModelLoNet"])
def test_cli_runs_modelnet_on_cpu(protocol_runs, tmp_path, bench):
    """--params with the config found next to it: ModelNet gives the
    protocol's poses (its partial is the config's), ModelLoNet those of
    run_test on the [0.5, 0.5] crop."""
    write_params(protocol_runs, tmp_path / "ckpt")
    results = port_cli.main([
        "--params", str(tmp_path / "ckpt" / "params.npz"), "--benchmark",
        bench, "--logdir", str(tmp_path / "logs"), "--device", "cpu",
        "--num_workers", "2"])
    (logdir,) = (tmp_path / "logs").iterdir()
    poses = np.load(logdir / "pred_transforms.npy")
    if bench == "ModelNet":
        want = np.load(protocol_runs["out"] / "port" / "pred_transforms.npy")
        assert results == protocol_runs["results"]
    else:
        cfg = protocol_cfg(partial=[0.5, 0.5])
        ref = run_test(cfg, protocol_runs["model"],
                       get_dataloader(cfg, "test", num_workers=0),
                       tmp_path / "lo")
        want = np.load(tmp_path / "lo" / "pred_transforms.npy")
        assert results == ref
    assert_same(poses, want)
    assert "chamfer_dist" in (logdir / "log.txt").read_text()


def test_cli_resume_modelnet(protocol_runs, tmp_path):
    """--resume <run dir> restores the best checkpoint (step 2, the
    protocol's parameters) and gives the --params run's poses."""
    cfg = {k: v for k, v in protocol_runs["cfg"].items()
           if k not in ("benchmark", "config_path")}
    run = tmp_path / "run"
    run.mkdir()
    (run / "config.yaml").write_text(yaml_text(cfg))
    saver = CheckpointManager(run / "ckpt")
    for step, seed, score in ((1, 5, 0.2), (2, None, 0.9), (3, 6, 0.5)):
        saver.save(step, protocol_runs["model"] if seed is None
                   else create_model(protocol_runs["cfg"], 256, "cpu",
                                     seed=seed), score=score)
    port_cli.main(["--resume", str(run), "--benchmark", "ModelNet",
                   "--logdir", str(tmp_path / "logs"), "--device", "cpu",
                   "--num_workers", "0"])
    (logdir,) = (tmp_path / "logs").iterdir()
    assert_same(np.load(logdir / "pred_transforms.npy"),
                np.load(protocol_runs["out"] / "port"
                        / "pred_transforms.npy"))
    assert "Loaded checkpoint at step 2" in (logdir / "log.txt").read_text()
