"""Port parity for the command lines beside train and test, on the CPU:
the DGR scorer, the xlsx and PLY files, the registration views,
`python -m regtr_tpu_torch.evaluate_3dmatch`, calibration and its command
line, the attention-map hook with `python -m regtr_tpu_torch.demo`, and
`python -m regtr_tpu_torch.compute_overlap`, each against the JAX package's
module or root script on the same inputs.
"""
import os
import shutil
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

import calibrate as jax_calibrate_cli
import compute_overlap_3dmatch as jax_overlap_cli
import demo as jax_demo_cli
import evaluate_3dmatch as jax_evaluate_cli
from regtr_tpu import native_bindings
from regtr_tpu.benchmark import dgr as jax_dgr
from regtr_tpu.config import load_config as jax_load_config
from regtr_tpu.data import overlap as jax_overlap
from regtr_tpu.data.calibrate import calibrate as jax_calibrate
from regtr_tpu.data.threedmatch import ThreeDMatchDataset as JaxDataset
from regtr_tpu.utils import jax_cache
from regtr_tpu.utils import ply as jax_ply
from regtr_tpu.utils import viz as jax_viz
from regtr_tpu.utils import xlsx as jax_xlsx
from regtr_tpu_torch import calibrate as calibrate_cli
from regtr_tpu_torch import compute_overlap as overlap_cli
from regtr_tpu_torch import demo as demo_cli
from regtr_tpu_torch import evaluate_3dmatch as evaluate_cli
from regtr_tpu_torch.benchmark import dgr, predator
from regtr_tpu_torch.config import (dump_yaml_sections, load_config,
                                    parse_yaml_sections, tiny_config)
from regtr_tpu_torch.data import calibrate
from regtr_tpu_torch.data.threedmatch import ThreeDMatchDataset
from regtr_tpu_torch.models import create_model
from regtr_tpu_torch.nn.transformer import record_attention
from regtr_tpu_torch.train.checkpoints import (CheckpointManager,
                                               load_params_npz,
                                               save_params_npz)
from regtr_tpu_torch.train.steps import make_forward
from regtr_tpu_torch.utils import ply, viz, xlsx
from tests.synth_threedmatch import PAIRS, SCENE, build_root, tiny_cfg
from tests.test_torch_eval import assert_same, yaml_text

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_root(tmp_path_factory.mktemp("root"))


def rot_z(deg):
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def write_est_tree(folder, root, offsets):
    """est.log files from the GT poses, pair i moved by offsets[i] = (x
    metres, degrees about z)."""
    pairs, traj = predator.read_trajectory(
        root / "benchmarks" / "3DMatch" / SCENE / "gt.log")
    (folder / SCENE).mkdir(parents=True)
    for (i, j, _), pose, (dx, deg) in zip(pairs, traj, offsets):
        moved = pose.copy()
        moved[0, 3] += dx
        moved[:3, :3] = rot_z(deg) @ moved[:3, :3]
        predator.write_est_log(folder / SCENE / "est.log", i, j, moved)
    return folder


@pytest.mark.parametrize("offsets,rate", [
    (((0.0, 0.0),) * 3, 1.0),
    (((0.29, 0.0), (0.0, 14.0), (0.1, 5.0)), 1.0),
    (((0.31, 0.0), (0.0, 16.0), (0.0, 0.0)), 1 / 3),
    (((0.5, 20.0),) * 3, 0.0),
])
def test_dgr_matches_jax(root, tmp_path, offsets, rate):
    """RTE < 0.3 m and RRE < 15 deg, per scene then across scenes: the
    report and the rate bitwise the JAX module's."""
    est = write_est_tree(tmp_path / "est", root, offsets)
    gt = root / "benchmarks" / "3DMatch"
    report, got = dgr.benchmark_dgr(str(est), str(gt))
    want_report, want = jax_dgr.benchmark_dgr(str(est), str(gt))
    assert report == want_report
    assert got == want == pytest.approx(rate)
    g, e = np.eye(3), rot_z(7.0)
    assert dgr.compute_rre(g, e) == jax_dgr.compute_rre(g, e)
    assert dgr.compute_rte(np.ones(3), np.zeros(3)) == \
        jax_dgr.compute_rte(np.ones(3), np.zeros(3))


XLSX_ROWS = [
    ["scene", "src", "tgt", "error", "flag"],
    ["a <b> & 'c'", 3, -4, 0.125, True],
    ["", 0, 2 ** 40, 1e-300, False],
    ["nan and inf", 1, 2, float("nan"), float("inf")],
]


def test_xlsx_matches_jax(tmp_path):
    """Files written by either read back to the same rows by both, and
    every part of the zip is the same bytes."""
    xlsx.write_xlsx(tmp_path / "port.xlsx", XLSX_ROWS, sheet_name="s & t")
    jax_xlsx.write_xlsx(tmp_path / "jax.xlsx", XLSX_ROWS, sheet_name="s & t")
    with zipfile.ZipFile(tmp_path / "port.xlsx") as a, \
            zipfile.ZipFile(tmp_path / "jax.xlsx") as b:
        assert a.namelist() == b.namelist()
        for name in a.namelist():
            assert a.read(name) == b.read(name), name
    rows = [reader(tmp_path / f"{side}.xlsx")
            for reader in (xlsx.read_xlsx, jax_xlsx.read_xlsx)
            for side in ("port", "jax")]
    want = [["scene", "src", "tgt", "error", "flag"],
            ["a <b> & 'c'", 3.0, -4.0, 0.125, True],
            ["", 0.0, float(2 ** 40), 1e-300, False],
            ["nan and inf", 1.0, 2.0, float("nan"), float("nan")]]
    for got in rows:
        assert repr(got) == repr(want)


def test_ply_matches_jax(tmp_path):
    """Binary files written by either are the same bytes and read back
    bitwise by both; an ascii file reads the same in both."""
    rng = np.random.RandomState(0)
    xyz = rng.randn(37, 3).astype(np.float32)
    arrays = [xyz, rng.randint(0, 255, (37, 3)).astype(np.uint8),
              rng.randn(37).astype(np.float64),
              rng.randint(-5, 5, 37).astype(np.int32)]
    names = ["x", "y", "z", "red", "green", "blue", "scalar", "label"]
    ply.write_ply(tmp_path / "port.ply", arrays, names)
    jax_ply.write_ply(tmp_path / "jax.ply", arrays, names)
    assert (tmp_path / "port.ply").read_bytes() == \
        (tmp_path / "jax.ply").read_bytes()
    for reader in (ply.read_ply, jax_ply.read_ply):
        got = reader(tmp_path / "port.ply")
        assert list(got) == names
        assert_same(np.stack([got["x"], got["y"], got["z"]], 1), xyz)
        assert_same(got["label"], arrays[3])
    assert_same(ply.read_ply_xyz(tmp_path / "jax.ply"),
                jax_ply.read_ply_xyz(tmp_path / "port.ply"))
    (tmp_path / "ascii.ply").write_text(
        "ply\nformat ascii 1.0\nelement vertex 2\nproperty float x\n"
        "property float y\nproperty float z\nproperty uchar red\n"
        "element face 0\nproperty list uchar int vertex_indices\n"
        "end_header\n0.5 1 -2 7\n3 4.25 5 255\n")
    got = ply.read_ply(tmp_path / "ascii.ply")
    want = jax_ply.read_ply(tmp_path / "ascii.ply")
    assert list(got) == list(want) == ["x", "y", "z", "red"]
    for key in want:
        assert_same(got[key], want[key])
    with pytest.raises(ValueError, match="columns"):
        ply.write_ply(tmp_path / "bad.ply", [xyz], ["x", "y"])


def test_visualize_registration_matches_jax(tmp_path, monkeypatch):
    """The four PLY panes are the JAX module's bytes; without matplotlib
    only the PNG is left out."""
    rng = np.random.RandomState(1)
    src, tgt = rng.randn(50, 3), rng.randn(60, 3)
    pose = np.concatenate([rot_z(30.0), [[0.1], [0.2], [0.3]]], 1)
    conf = rng.rand(50)
    args = dict(pose_gt=pose * 0.5, overlap_conf=conf, prefix="p")
    viz.visualize_registration(src, tgt, pose, tmp_path / "port", **args)
    jax_viz.visualize_registration(src, tgt, pose, tmp_path / "jax", **args)
    panes = sorted(p.name for p in (tmp_path / "jax").glob("*.ply"))
    assert panes == ["p_1_input.ply", "p_2_pred.ply", "p_3_gt.ply",
                     "p_4_overlap.ply"]
    assert sorted(os.listdir(tmp_path / "port")) == \
        sorted(os.listdir(tmp_path / "jax"))
    for name in panes:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    viz.visualize_registration(src, tgt, pose, tmp_path / "bare")
    assert sorted(os.listdir(tmp_path / "bare")) == ["reg_1_input.ply",
                                                     "reg_2_pred.ply"]


def test_evaluate_3dmatch_matches_jax(root, tmp_path, capsys):
    """The port's main against the root script's, in-process, on est.log
    trees with offsets: the same printed report, CSV and xlsx rows, for
    Predator (recall) and DGR (success rate)."""
    offsets = ((0.15, 0.0), (0.0, 3.0), (0.3, 0.0))
    gt = str(root / "benchmarks")
    printed, rows = {}, {}
    for side, cli in (("port", evaluate_cli), ("jax", jax_evaluate_cli)):
        est = write_est_tree(tmp_path / side, root, offsets)
        cli.main([str(est), "--gt_dir", gt, "--errors_csv",
                  str(tmp_path / f"{side}.csv")])
        out = capsys.readouterr().out
        printed[side] = out.replace(str(tmp_path / side), "<est>").replace(
            str(tmp_path), "<tmp>")
        rows[side] = jax_xlsx.read_xlsx(est / "individual_errors.xlsx")
        assert xlsx.read_xlsx(est / "individual_errors.xlsx") == rows[side]
        cli.main([str(est), "--gt_dir", gt, "--method", "dgr"])
        printed[side] += capsys.readouterr().out
    assert printed["port"] == printed["jax"].replace("jax.csv", "port.csv")
    assert "Mean registration recall: 0.6667" in printed["port"]
    assert "Mean success rate: 0.6667" in printed["port"]
    assert (tmp_path / "port.csv").read_text() == \
        (tmp_path / "jax.csv").read_text()
    assert repr(rows["port"]) == repr(rows["jax"])
    assert len(rows["port"]) == 1 + len(PAIRS)
    evaluate_cli.main([str(tmp_path / "port"), "--gt_dir", gt,
                       "--errors_xlsx", "none"])
    assert "wrote" not in capsys.readouterr().out


def calibration_cfg(root):
    """conf/3dmatch.yaml on the miniature root at a 0.08 grid (as
    tests/test_cli.py sets up the JAX command line's test)."""
    cfg = tiny_cfg(root, root / "meta")
    cfg["first_subsampling_dl"] = 0.08
    return cfg


def test_calibrate_matches_jax(root):
    """calibrate() on the test pairs equals the JAX function (the native
    library's counts), and so do its parts: the level-0 neighbor counts,
    the barycenters of the next level and the largest cell."""
    cfg = calibration_cfg(root)
    port = calibrate.calibrate(
        ThreeDMatchDataset(cfg, "test", metadata_dir=cfg["metadata_dir"]),
        cfg, num_samples=3, device="cpu")
    want = jax_calibrate(JaxDataset(cfg, "test",
                                    metadata_dir=cfg["metadata_dir"]),
                         cfg, num_samples=3)
    assert port == want and port["num_samples"] == 3
    pts = torch.load(root / "test" / SCENE / "cloud_bin_1.pth",
                     weights_only=False).numpy().astype(np.float32)
    r = float(cfg["first_subsampling_dl"]) * float(cfg["conv_radius"])
    idx = native_bindings.radius_neighbors(pts, pts, r, calibrate.HIST_MAX)
    counts = np.clip((idx < len(pts)).sum(1), 0, calibrate.HIST_MAX - 1)
    got = calibrate.neighbor_counts(torch.from_numpy(pts), r).numpy()
    assert_same(got, counts.astype(np.int64))
    assert counts.max() > 40           # neighborhoods of many sizes
    cell = 2.0 * r / cfg["conv_radius"]
    sub = calibrate.grid_subsample(torch.from_numpy(pts), cell).numpy()
    ref = native_bindings.grid_subsample(pts, cell)

    def rows(a):
        return a[np.lexsort(a.T[::-1])]

    assert_same(rows(sub), rows(ref))
    cells = np.floor(pts / r).astype(np.int64)
    assert calibrate.max_cell_count(torch.from_numpy(pts), r) == int(
        np.unique(cells, axis=0, return_counts=True)[1].max())


def test_calibrate_cli_matches_jax(root, tmp_path, capsys):
    """The command line's YAML loads, under PyYAML and under the port's
    loader, to what the JAX command line's loads to; --dry-run prints the
    same YAML without PyYAML."""
    with open(ROOT / "conf" / "3dmatch.yaml") as f:
        raw = yaml.safe_load(f)
    raw["dataset"]["root"] = str(root)
    raw["dataset"]["metadata_dir"] = str(root / "meta")
    raw["kpconv_options"]["first_subsampling_dl"] = 0.08
    paths = {}
    for side, cli, extra in (("port", calibrate_cli, ["--device", "cpu"]),
                             ("jax", jax_calibrate_cli, [])):
        paths[side] = tmp_path / f"{side}.yaml"
        # in the subset conf/*.yaml are written in (block sections, flow
        # lists), which both loaders read
        paths[side].write_text(dump_yaml_sections(raw))
        args = ["--config", str(paths[side]), "--phase", "test",
                "--num_samples", "3", *extra]
        cli.main(args + ["--dry-run"])
        paths[side + " dry"] = capsys.readouterr().out
        cli.main(args)
    assert yaml.safe_load(paths["port dry"]) == \
        yaml.safe_load(paths["jax dry"])
    assert parse_yaml_sections(paths["port dry"]) == \
        yaml.safe_load(paths["jax dry"])
    got = yaml.safe_load(paths["port"].read_text())
    want = yaml.safe_load(paths["jax"].read_text())
    assert got == want
    assert list(got) == list(want)
    assert parse_yaml_sections(paths["port"].read_text()) == want
    assert want["tpu_options"]["cell_capacity"] >= 1
    strip = ("config_path",)
    assert ({k: v for k, v in load_config(paths["port"]).items()
             if k not in strip}
            == {k: v for k, v in jax_load_config(paths["jax"]).items()
                if k not in strip})
    # the placement rule: a section that defines neighborhood_limits keeps
    # it, and a config without one gets kpconv_options / tpu_options
    assert calibrate_cli.update_yaml({"a": {"neighborhood_limits": [1]}}, {
        "neighborhood_limits": [2], "level_capacities": [3],
        "cell_capacity": 4}) == jax_calibrate_cli.update_yaml(
        {"a": {"neighborhood_limits": [1]}}, {
            "neighborhood_limits": [2], "level_capacities": [3],
            "cell_capacity": 4})
    assert dump_yaml_sections(calibrate_cli.update_yaml({"s": {"k": 1}}, {
        "neighborhood_limits": [5], "level_capacities": [6],
        "cell_capacity": 7})) == ("s:\n  k: 1\nkpconv_options:\n"
                                  "  neighborhood_limits: [5]\n"
                                  "tpu_options:\n  level_capacities: [6]\n"
                                  "  cell_capacity: 7\n")


DEMO_CFG = dict(num_encoder_layers=6, buckets=[256],
                neighborhood_limits=[40, 40])


@pytest.fixture(scope="module")
def demo_runs(tmp_path_factory):
    """The root demo.py (JAX, --save_attn) and the port's demo with and
    without --save_attn, in-process, on one pair written as .ply, with the
    same parameters (.npz) and a 6-layer tiny config."""
    tmp = tmp_path_factory.mktemp("demo")
    rng = np.random.RandomState(4)
    src = (rng.randn(200, 3) * 0.3).astype(np.float32)
    tgt = (src[:190] @ rot_z(20.0).T.astype(np.float32) + 0.05).astype(
        np.float32)
    for name, cloud in (("src", src), ("tgt", tgt)):
        ply.write_ply(tmp / f"{name}.ply", cloud, ["x", "y", "z"])
    cfg = tiny_config(**DEMO_CFG)
    (tmp / "cfg.yaml").write_text(yaml_text(
        {k: v for k, v in cfg.items() if k != "config_path"}))
    save_params_npz(tmp / "p.npz", create_model(cfg, 256, "cpu", seed=3))
    common = ["--src", str(tmp / "src.ply"), "--tgt", str(tmp / "tgt.ply"),
              "--config", str(tmp / "cfg.yaml"), "--params",
              str(tmp / "p.npz")]
    with pytest.MonkeyPatch.context() as mp:
        # the JAX demo's persistent compilation cache stays off
        mp.setattr(jax_cache, "enable_compilation_cache", lambda: None)
        jax_demo_cli.main([*common, "--out", str(tmp / "jax"), "--save_attn",
                           "--platform", "cpu"])
    port = {flag: demo_cli.main([*common, "--out", str(tmp / flag),
                                 "--device", "cpu"]
                                + (["--save_attn"] if flag == "attn" else []))
            for flag in ("attn", "plain")}
    return dict(tmp=tmp, cfg=cfg, src=src, tgt=tgt, port=port,
                common=common)


def test_demo_attention_maps_match_jax(demo_runs):
    """attn.npz: the JAX demo's 12 names and shapes (clouds, heads, N, N at
    the padded capacity), the probabilities within fp32 noise of the JAX
    package's sown maps, each row summing to 1."""
    tmp = demo_runs["tmp"]
    got, want = np.load(tmp / "attn" / "attn.npz"), np.load(
        tmp / "jax" / "attn.npz")
    assert sorted(got.files) == sorted(want.files)
    assert len(want.files) == 12 and {
        f"transformer_encoder/layer_{i}/{kind}" for i in range(6)
        for kind in ("self_attn", "cross_attn")} == set(want.files)
    n = demo_runs["port"]["attn"]["outputs"]["kp"].shape[1]
    for name in want.files:
        assert got[name].shape == want[name].shape == (2, 4, n, n), name
        assert got[name].dtype == want[name].dtype == np.float32
        np.testing.assert_allclose(got[name], want[name], rtol=1e-3,
                                   atol=2e-5, err_msg=name)
        np.testing.assert_allclose(got[name].sum(-1), 1.0, atol=1e-5)
    # the maps follow each cloud's valid keys: cross-attention reads the
    # partner's
    mask = demo_runs["port"]["attn"]["outputs"]["kp_mask"].numpy()
    cross = got["transformer_encoder/layer_0/cross_attn"]
    assert (cross[0][..., ~mask[1]] == 0).all()
    assert (got["transformer_encoder/layer_0/self_attn"][1][..., ~mask[1]]
            == 0).all()


def test_demo_matches_jax_and_a_direct_forward(demo_runs):
    """The hook changes nothing: every output bitwise the same with and
    without --save_attn; the pose a direct forward's; before.ply the JAX
    demo's bytes, after.ply its points within the protocol tolerance."""
    tmp, port = demo_runs["tmp"], demo_runs["port"]
    with_maps, plain = port["attn"]["outputs"], port["plain"]["outputs"]
    assert port["plain"]["maps"] is None
    for key, value in plain.items():
        if key == "levels":
            continue
        assert torch.equal(with_maps[key], value), key
    model = create_model(demo_runs["cfg"], 256, "cpu", seed=7)
    load_params_npz(tmp / "p.npz", model)
    points = np.zeros((2, 256, 3), np.float32)
    mask = np.zeros((2, 256), bool)
    for slot, cloud in enumerate((demo_runs["src"], demo_runs["tgt"])):
        points[slot, :len(cloud)] = cloud
        mask[slot, :len(cloud)] = True
    with record_attention(model) as maps:
        direct = make_forward(model)(torch.from_numpy(points),
                                     torch.from_numpy(mask))
    assert torch.equal(direct["pose"], plain["pose"])
    assert maps.keys() == port["attn"]["maps"].keys()
    assert all(torch.equal(maps[k], port["attn"]["maps"][k]) for k in maps)
    assert all(m.record_to is None for m in model.modules()
               if hasattr(m, "record_to"))
    for name in ("before.ply", "after.ply"):
        assert (tmp / "attn" / name).read_bytes() == \
            (tmp / "plain" / name).read_bytes()
    assert (tmp / "attn" / "before.ply").read_bytes() == \
        (tmp / "jax" / "before.ply").read_bytes()
    got = ply.read_ply(tmp / "attn" / "after.ply")
    want = jax_ply.read_ply(tmp / "jax" / "after.ply")
    assert list(got) == list(want)
    for key in ("x", "y", "z"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, atol=2e-4)
    for key in ("red", "green", "blue"):
        assert_same(got[key], want[key])


def test_demo_loads_every_cloud_format(demo_runs, tmp_path):
    """.pth (a pickled numpy array) and .bin (float32 rows of 6) give the
    .ply's points; the port's run directory restores with --ckpt."""
    src = demo_runs["src"]
    torch.save(src, tmp_path / "a.pth")
    np.concatenate([src, np.ones_like(src)], 1).astype(np.float32).tofile(
        tmp_path / "a.bin")
    for name in ("a.pth", "a.bin"):
        assert_same(demo_cli.load_cloud(tmp_path / name), src)
    assert_same(demo_cli.load_cloud(demo_runs["tmp"] / "src.ply"), src)
    with pytest.raises(ValueError, match="unsupported"):
        demo_cli.load_cloud(tmp_path / "a.xyz")
    model = create_model(demo_runs["cfg"], 256, "cpu", seed=7)
    load_params_npz(demo_runs["tmp"] / "p.npz", model)
    CheckpointManager(tmp_path / "run" / "ckpt").save(1, model, score=0.5)
    common = [a for a in demo_runs["common"]
              if a not in ("--params", str(demo_runs["tmp"] / "p.npz"))]
    run = demo_cli.main([*common, "--ckpt", str(tmp_path / "run"), "--out",
                         str(tmp_path / "out"), "--device", "cpu"])
    assert torch.equal(run["outputs"]["pose"],
                       demo_runs["port"]["plain"]["outputs"]["pose"])
    assert all(not p.startswith("/") for pair in demo_cli.DEMO_EXAMPLES
               for p in pair)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            demo_cli.main(demo_runs["common"])
        with pytest.raises(RuntimeError, match="CUDA"):
            calibrate_cli.main(["--config", str(ROOT / "conf" /
                                                 "3dmatch.yaml")])


def test_compute_overlap_matches_jax(root, tmp_path):
    """The h5 file: the JAX command line's groups (its native search), the
    JAX package's k-d tree function's masks, and read by the port's
    dataset, the on-the-fly sample."""
    import h5py

    data = tmp_path / "data"
    shutil.copytree(root, data)
    args = ["--root", str(data), "--phase", "train", "--metadata_dir",
            str(data / "meta")]
    jax_overlap_cli.main(args)
    (data / "train_pairs-overlapmask.h5").rename(data / "jax.h5")
    cfg = tiny_cfg(data)
    fly = ThreeDMatchDataset(cfg, "train", metadata_dir=str(data / "meta"))
    overlap_cli.main(args)
    with h5py.File(data / "train_pairs-overlapmask.h5", "r") as got, \
            h5py.File(data / "jax.h5", "r") as want:
        assert sorted(got) == sorted(want) == [
            f"pair_{i:06d}" for i in range(len(PAIRS))]
        for i, name in enumerate(sorted(want)):
            for key in ("src_mask", "tgt_mask", "src_tgt_corr"):
                assert_same(got[name][key][()], want[name][key][()])
            info = fly.infos
            pose = np.concatenate([info["rot"][i], info["trans"][i]],
                                  1).astype(np.float32)
            src = torch.load(data / info["src"][i], weights_only=False)
            tgt = torch.load(data / info["tgt"][i], weights_only=False)
            ref = jax_overlap.compute_overlap(
                src.numpy() @ pose[:, :3].T + pose[:, 3], tgt.numpy(),
                cfg["overlap_radius"])
            assert_same(got[name]["src_mask"][()], ref[0])
            assert_same(got[name]["tgt_mask"][()], ref[1])
            assert got[name]["src_mask"][()].sum() > 0
    # the dataset reads the file to the on-the-fly sample (the
    # correspondences as int32, as the file holds them)
    h5 = ThreeDMatchDataset(cfg, "train", metadata_dir=str(data / "meta"))
    assert h5.pairs_data is not None and fly.pairs_data is None
    np.random.seed(0)
    a = h5[1]
    np.random.seed(0)
    b = fly[1]
    for key in b:
        if key == "correspondences":
            assert a[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])
        else:
            assert_same(a[key], b[key])
    h5.pairs_data.close()
