"""Data parallelism of the port on the CPU (regtr_tpu_torch/parallel/dist.py):
two Gloo ranks, each a process of its own, against one process.

The ranks run this file as a script (`python tests/test_torch_distributed.py
SCENARIO WORKDIR`, with RANK, WORLD_SIZE and MASTER_PORT set), read their
inputs from WORKDIR/args.pt and write WORKDIR/rank{r}.pt; the tests compare
those with the same work done in one process.  Each launch has its own time
limit and the ranks' process group a timeout, so that a hang fails fast.
The command lines run under `python -m torch.distributed.run`.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from regtr_tpu_torch.config import tiny_config  # noqa: E402
from regtr_tpu_torch.data.overlap import compute_overlap  # noqa: E402
from regtr_tpu_torch.models import create_model  # noqa: E402
from regtr_tpu_torch.parallel import dist  # noqa: E402
from regtr_tpu_torch.train.optim import Optimizer  # noqa: E402
from regtr_tpu_torch.train.steps import (  # noqa: E402
    backward, forward_loss, global_losses, make_train_step,
    registration_metrics)

WORLD = 2
LAUNCH_TIMEOUT_S = 120      # each launch of the ranks
GROUP_TIMEOUT_S = 60        # a collective one rank never reaches
# fp32 on both sides, the global batch's sums in another order: measured
# up to 1.6e-6 relative L2 per leaf; a plain mean of the ranks' own
# gradients misses by 0.24
GRAD_TOL = 1e-5
SEED = 7
N0 = 96


# -- the ranks' side ---------------------------------------------------------

def rank_batch(batch, r):
    """Rank r's share of a global batch of one pair per rank."""
    return {"points": batch["points"][2 * r:2 * r + 2],
            "mask": batch["mask"][2 * r:2 * r + 2],
            "pose": batch["pose"][r:r + 1],
            "overlap0": batch["overlap0"][2 * r:2 * r + 2]}


def step_outputs(model, optimizer, cfg, batch):
    """One step's reduced gradients, global losses and registration
    metrics, without an update."""
    losses, out = forward_loss(model, batch)
    grads, grad_norm = backward(optimizer, losses["total"])
    return {"grads": [g.clone() for g in grads], "grad_norm": grad_norm,
            "losses": global_losses(losses),
            "metrics": registration_metrics(out["pose"], batch["pose"], cfg,
                                             per_pair=True)}


def recorded_samples(cfg, batch):
    """The sampled circle loss's global losses on `batch` from a model of
    SEED, and every draw of its sampler (idx_a, idx_b, valid), in order."""
    from regtr_tpu_torch.losses import feature

    draws = []
    real = feature.sample_correspondences

    def recorded(*args):
        draws.append(real(*args))
        return draws[-1]

    model = create_model(cfg, N0, "cpu", seed=SEED)
    feature.sample_correspondences = recorded
    try:
        losses, _ = model.compute_loss(batch["points"], batch["mask"],
                                       batch["pose"], batch["overlap0"])
    finally:
        feature.sample_correspondences = real
    return global_losses(losses), draws


def scenario_step(args, r):
    from regtr_tpu_torch.train.logging_utils import StatsMeter
    from regtr_tpu_torch.train.trainer import Trainer

    cfg, batch = args["cfg"], rank_batch(args["batch"], r)
    model = create_model(cfg, N0, "cpu", seed=SEED)
    opt = Optimizer(model.parameters(), cfg)
    res = step_outputs(model, opt, cfg, batch)
    step = make_train_step(model, opt, cfg)
    res["train_metrics"] = [step(batch) for _ in range(2)]
    res["params"] = [p.detach().clone() for p in model.parameters()]

    # a NaN on rank 1 only skips the update on both ranks
    bad = {k: v.clone() for k, v in batch.items()}
    if r == 1:
        bad["points"][0, 3, 1] = float("nan")
    before = [t.clone() for t in (*opt.params, *opt.mu, *opt.nu)]
    res["nan_metrics"] = step(bad)
    res["nan_kept"] = (opt.count == 2 and all(
        torch.equal(a, b) for a, b in zip(before, (*opt.params, *opt.mu,
                                                   *opt.nu))))

    # validation meters that differ by rank (a non-finite value skipped)
    meters = StatsMeter()
    for i in range(3 + r):
        meters.update({"a": 1.5 * r + i, "b": np.array([0.0, 2.0 ** -i + r]),
                       "c": float("nan") if i == 1 else r - i})
    res["sums_counts"] = meters.sums_counts(sorted(meters.meters))
    res["averages"] = Trainer._global_averages(meters)
    res["ragged"] = dist.allgather_ragged(np.arange(3 * r + 1.0) + 10 * r)

    # the sampled circle loss: each pair draws from its own generator
    res["circle_losses"], res["circle_draws"] = recorded_samples(
        dict(cfg, feature_loss_type="circle_sampled", circle_n_sample=32),
        batch)
    return res


def scenario_protocol(args, r):
    from regtr_tpu_torch.data import get_dataloader
    from regtr_tpu_torch.evaluation import run_test

    out = {}
    for name, cfg in args["cfgs"].items():
        model = create_model(cfg, max(cfg["buckets"]), "cpu", seed=SEED)
        loader = get_dataloader(cfg, "test", num_workers=0,
                                shard=(r, WORLD))
        out[name] = run_test(cfg, model, loader, args["out"] / name,
                             gt_benchmark_dir=args["gt_dir"])
    return out


def rank_main(scenario, workdir):
    workdir = Path(workdir)
    r = int(os.environ["RANK"])
    made = dist.init_distributed("gloo", "cpu", timeout=GROUP_TIMEOUT_S)
    assert made and dist.world_size() == WORLD and dist.rank() == r
    try:
        args = torch.load(workdir / "args.pt", weights_only=False)
        res = {"step": scenario_step,
               "protocol": scenario_protocol}[scenario](args, r)
        torch.save(res, workdir / f"rank{r}.pt")
        dist.barrier()
    finally:
        dist.shutdown()


# -- the tests' side ---------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def hidden_tensorflow(tmp_path) -> str:
    """A directory whose tensorflow.py refuses to import, for PYTHONPATH:
    TensorBoard imports TensorFlow where it is installed (tens of seconds)
    and falls back to its own stub without it."""
    stub = tmp_path / "no_tensorflow"
    stub.mkdir(exist_ok=True)
    (stub / "tensorflow.py").write_text("raise ImportError('hidden')\n")
    return str(stub)


def spawn(scenario, workdir, args):
    """Run the scenario on WORLD ranks; -> their results, in rank order."""
    torch.save(args, workdir / "args.pt")
    env = dict(os.environ, MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()), WORLD_SIZE=str(WORLD),
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for r in range(WORLD):
        log = open(workdir / f"rank{r}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, scenario, str(workdir)],
            env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
            stdout=log, stderr=subprocess.STDOUT), log))
    failed = []
    for r, (p, log) in enumerate(procs):
        try:
            rc = p.wait(timeout=LAUNCH_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            for q, _ in procs:
                q.kill()
            rc = "timeout"
        log.close()
        if rc != 0:
            failed.append(f"rank {r}: {rc}\n"
                          + (workdir / f"rank{r}.log").read_text()[-3000:])
    assert not failed, "\n".join(failed)
    return [torch.load(workdir / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def launch(module, args, cwd, tmp_path):
    """python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    module args, on the CPU over Gloo."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [hidden_tensorflow(tmp_path), str(ROOT)]))
    env.pop("WORLD_SIZE", None)
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(WORLD), "-m", module, *args,
         "--device", "cpu", "--dist_backend", "gloo", "--dist_timeout",
         str(GROUP_TIMEOUT_S)],
        cwd=cwd, env=env, capture_output=True, text=True,
        timeout=LAUNCH_TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc


def two_pairs():
    """The tiny golden pair and a copy of it with fewer valid points (70
    of 96 source points, 61 of 80 target points) under another pose: one
    pair per rank, with unequal valid counts (every loss's denominator
    differs by rank)."""
    data = np.load(ROOT / "tests" / "golden_tiny.npz")
    pts = np.concatenate([data["points"], data["points"]])      # (4, N, 3)
    mask = np.concatenate([data["mask"], data["mask"]])
    mask[2, 70:] = False
    mask[3, 61:] = False
    pts[~mask] = 0.0
    poses = []
    for i, deg in enumerate((20.0, -35.0)):
        a = np.deg2rad(deg)
        rot = np.array([[np.cos(a), -np.sin(a), 0.0],
                        [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
        poses.append(np.concatenate([rot, [[0.05], [-0.02 * i], [0.01]]],
                                    1))
    overlap0 = np.zeros(mask.shape, np.float32)
    for i, pose in enumerate(poses):
        src, tgt = pts[2 * i][mask[2 * i]], pts[2 * i + 1][mask[2 * i + 1]]
        s_ov, t_ov, _ = compute_overlap(src @ pose[:, :3].T + pose[:, 3],
                                        tgt, 0.15)
        overlap0[2 * i, mask[2 * i]] = s_ov
        overlap0[2 * i + 1, mask[2 * i + 1]] = t_ov
    return {"points": torch.from_numpy(pts.astype(np.float32)),
            "mask": torch.from_numpy(mask),
            "pose": torch.from_numpy(np.stack(poses).astype(np.float32)),
            "overlap0": torch.from_numpy(overlap0)}


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b).clamp_min(1e-30))


def one_process(cfg, batch):
    model = create_model(cfg, N0, "cpu", seed=SEED)
    return step_outputs(model, Optimizer(model.parameters(), cfg), cfg,
                        batch)


def step_runs(tmp_path_factory):
    cfg = tiny_config()
    batch = two_pairs()
    ranks = spawn("step", tmp_path_factory.mktemp("step"),
                  {"cfg": cfg, "batch": batch})
    return dict(cfg=cfg, batch=batch, ranks=ranks,
                one=one_process(cfg, batch),
                halves=[one_process(cfg, rank_batch(batch, r))
                        for r in range(WORLD)])


@pytest.fixture(scope="module")
def steps(tmp_path_factory):
    return step_runs(tmp_path_factory)

def test_step_matches_one_process_on_the_global_batch(steps):
    """Unequal valid counts: the two ranks' reduced gradients, their
    global losses and metrics are the one-process step's on the
    concatenated batch, leaf by leaf; a plain mean of the ranks' own
    gradients (DDP's) is not."""
    one = steps["one"]
    # the key projections' biases have a gradient of 0 in exact
    # arithmetic: held to an absolute tolerance, as in test_torch_train.py
    small = [float(torch.linalg.vector_norm(w)) < 1e-6 for w in one["grads"]]
    assert 0 < sum(small) < len(small) // 4
    for res in steps["ranks"]:
        worst = max(rel_l2(g, w) for g, w, s in zip(
            res["grads"], one["grads"], small) if not s)
        assert worst <= GRAD_TOL, worst
        for g, w, s in zip(res["grads"], one["grads"], small):
            if s:
                torch.testing.assert_close(g, w, rtol=0, atol=1e-7)
        assert rel_l2(res["grad_norm"], one["grad_norm"]) <= GRAD_TOL
        assert res["losses"].keys() == one["losses"].keys()
        for k, v in one["losses"].items():
            assert rel_l2(res["losses"][k], v.detach()) <= GRAD_TOL, k
        for k, v in one["metrics"].items():
            assert torch.allclose(res["metrics"][k], v, rtol=GRAD_TOL,
                                  atol=1e-6), k
    halves = steps["halves"]
    plain = max(rel_l2((a + b) / 2, w) for a, b, w, s in zip(
        halves[0]["grads"], halves[1]["grads"], one["grads"], small)
        if not s)
    assert plain > 100 * GRAD_TOL, plain

def test_ranks_stay_bitwise_equal(steps):
    """Two updates: every parameter bitwise equal across the ranks, as
    are the metrics the steps report."""
    a, b = steps["ranks"]
    assert all(torch.equal(x, y) for x, y in zip(a["params"],
                                                 b["params"]))
    for ma, mb in zip(a["train_metrics"], b["train_metrics"]):
        assert ma.keys() == mb.keys()
        for k in ma:
            assert torch.equal(torch.as_tensor(ma[k]),
                               torch.as_tensor(mb[k])), k
        assert ma["update_skipped"] == 0.0

def test_a_nan_on_one_rank_skips_the_update_on_both(steps):
    for res in steps["ranks"]:
        assert res["nan_metrics"]["update_skipped"] == 1.0
        assert not np.isfinite(float(res["nan_metrics"]["total"]))
        assert res["nan_kept"]

def test_validation_averages_combine_as_jax(steps):
    """`Trainer._global_averages` over the two ranks' meters is the JAX
    package's combine_process_sums of the same (sum, count)s; the
    ragged all-gather is the concatenation in rank order."""
    from regtr_tpu.train.logging_utils import combine_process_sums

    ranks = steps["ranks"]
    gathered = np.stack([r["sums_counts"] for r in ranks])
    want = dict(zip(["a", "b", "c"],
                    combine_process_sums(gathered).tolist()))
    for res in ranks:
        assert res["averages"] == want
        np.testing.assert_array_equal(res["ragged"], np.concatenate(
            [np.arange(3 * r + 1.0) + 10 * r for r in range(WORLD)]))

def test_sampled_circle_loss_matches_one_process(steps):
    """The sampled circle loss on two ranks: each pair draws alone, from a
    generator seeded from its own points, so every rank draws for its pair
    the samples one process draws for that pair on the concatenated
    batch, bitwise, and every term is the one process's."""
    cfg = dict(steps["cfg"], feature_loss_type="circle_sampled",
               circle_n_sample=32)
    one, one_draws = recorded_samples(cfg, steps["batch"])
    assert len(one_draws) == 2          # feature_{last layer}, feature_un
    for r, res in enumerate(steps["ranks"]):
        assert len(res["circle_draws"]) == len(one_draws)
        for got, want in zip(res["circle_draws"], one_draws):
            assert got[2].all()         # every pair has candidates
            for g, w in zip(got, want):
                assert torch.equal(g[0], w[r])
        assert res["circle_losses"].keys() == one.keys()
        for k, v in one.items():
            assert rel_l2(res["circle_losses"][k], v.detach()) <= GRAD_TOL, k

@pytest.mark.parametrize("phase", ["train", "val"])
@pytest.mark.parametrize("items", [7, 8])
def test_loader_shards_match_jax(phase, items):
    """Every rank's batches, shard_pad and pad_last_batch included,
    bitwise the JAX loader's."""
    from regtr_tpu.data import get_dataloader as jax_get_dataloader
    from regtr_tpu_torch.data import get_dataloader
    from tests.test_torch_eval import assert_same

    cfg = tiny_config(dataset="synthetic", root="",
                      synthetic_items=items, synthetic_val_items=items,
                      train_batch_size=2, val_batch_size=3,
                      num_points=128, buckets=[128])
    lengths = set()
    for r in range(3):
        got = get_dataloader(cfg, phase, num_workers=0, shard=(r, 3))
        want = jax_get_dataloader(cfg, phase, num_workers=0,
                                  shard=(r, 3))
        got.set_epoch(1)
        want.set_epoch(1)
        assert got._indices().tolist() == want._indices().tolist()
        got, want = list(got), list(want)
        lengths.add(len(got))
        assert len(got) == len(want) > 0
        for (gb, gm), (wb, wm) in zip(got, want):
            for key in wb:
                assert_same(gb[key], wb[key])
            assert gm["idx"] == wm["idx"]
    assert len(lengths) == 1        # every rank as many batches

@pytest.fixture(scope="module")
def protocols(tmp_path_factory):
    """run_test of two ranks and of one process: the 3DMatch protocol
    on tests/synth_threedmatch.py's root and the ModelNet protocol on
    the synthetic shapes, one pair a batch."""
    from regtr_tpu_torch.data import get_dataloader
    from regtr_tpu_torch.evaluation import run_test
    from tests.synth_threedmatch import build_root
    from tests.test_torch_eval import protocol_cfg
    from tests.test_torch_modelnet_eval import \
        protocol_cfg as modelnet_cfg

    root = build_root(tmp_path_factory.mktemp("root"))
    cfgs = {"3dmatch": dict(protocol_cfg(root), test_batch_size=1),
            "modelnet": modelnet_cfg(test_batch_size=1)}
    work = tmp_path_factory.mktemp("protocol")
    gt_dir = str(root / "benchmarks")
    ranks = spawn("protocol", work, {"cfgs": cfgs, "out": work / "two",
                                     "gt_dir": gt_dir})
    one = {}
    for name, cfg in cfgs.items():
        model = create_model(cfg, max(cfg["buckets"]), "cpu", seed=SEED)
        one[name] = run_test(cfg, model,
                             get_dataloader(cfg, "test", num_workers=0),
                             work / "one" / name, gt_benchmark_dir=gt_dir)
    return dict(work=work, ranks=ranks, one=one)

def trajectory(path):
    from regtr_tpu_torch.benchmark.predator import read_trajectory

    pairs, poses = read_trajectory(path)
    return {tuple(int(x) for x in p[:2]): pose
            for p, pose in zip(pairs, poses)}

def test_run_test_on_two_ranks_matches_one_process(protocols):
    """The merged est.log holds the one process's pairs, each pose
    equal (their order within the scene is free); the per-pair errors
    are gathered (their means and the recall are one process's); the
    rank trees stay beside the merged one."""
    from tests.synth_threedmatch import SCENE

    work = protocols["work"]
    est = Path("3DMatch") / SCENE / "est.log"
    got = trajectory(work / "two" / "3dmatch" / est)
    want = trajectory(work / "one" / "3dmatch" / est)
    assert got.keys() == want.keys() and len(got) == 3
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for r in range(WORLD):
        assert (work / "two" / "3dmatch" / f"est_rank{r}" / est).exists()
    assert not (work / "one" / "3dmatch" / "est_rank0").exists()
    one = protocols["one"]["3dmatch"]
    for res in protocols["ranks"]:
        for k in ("rot_err_deg_mean", "trans_err_mean"):
            assert res["3dmatch"][k] == pytest.approx(one[k], rel=1e-12)
        assert res["3dmatch"]["reg_success"] == one["reg_success"]
    # only rank 0 scores
    assert protocols["ranks"][0]["3dmatch"]["registration_recall"] == \
        one["registration_recall"]
    assert "registration_recall" not in protocols["ranks"][1]["3dmatch"]

def test_modelnet_protocol_on_two_ranks_matches_one_process(protocols):
    """pred_transforms.npy in dataset order, bitwise one process's, and
    the same metric summary on both ranks."""
    work = protocols["work"]
    got = np.load(work / "two" / "modelnet" / "pred_transforms.npy")
    want = np.load(work / "one" / "modelnet" / "pred_transforms.npy")
    assert got.dtype == want.dtype and got.shape == want.shape == (
        4, 3, 4)
    np.testing.assert_array_equal(got, want)
    one = protocols["one"]["modelnet"]
    for res in protocols["ranks"]:
        assert res["modelnet"].keys() == one.keys()
        for k, v in one.items():
            assert res["modelnet"][k] == pytest.approx(v, rel=1e-12), k

def test_merge_raises_on_a_missing_rank_tree(tmp_path):
    from regtr_tpu_torch.evaluation import merge_est_log_dirs

    (tmp_path / "est_rank0" / "scene").mkdir(parents=True)
    (tmp_path / "est_rank0" / "scene" / "est.log").write_text("a\n")
    with pytest.raises(FileNotFoundError, match="1 are missing"):
        merge_est_log_dirs([tmp_path / "est_rank0",
                            tmp_path / "est_rank1"], tmp_path / "merged")
    (tmp_path / "est_rank1" / "scene").mkdir(parents=True)
    (tmp_path / "est_rank1" / "scene" / "est.log").write_text("b\n")
    merge_est_log_dirs([tmp_path / "est_rank0", tmp_path / "est_rank1"],
                       tmp_path / "merged")
    assert (tmp_path / "merged" / "scene" / "est.log").read_text() == \
        "a\nb\n"

def test_command_lines_under_the_launcher(tmp_path):
    """torch.distributed.run -m regtr_tpu_torch.train for 2 steps: one
    run directory with rank 1's log beside rank 0's, one checkpoint and
    best.json, and every rank's metrics the global batch's; then -m
    regtr_tpu_torch.test on it: pred_transforms.npy bitwise the one
    process's command line's."""
    from regtr_tpu_torch import test as test_cli
    from tests.test_torch_eval import yaml_text

    cfg = {k: v for k, v in tiny_config(
        dataset="synthetic", root="", synthetic_items=8,
        synthetic_val_items=2, train_batch_size=1, val_batch_size=1,
        test_batch_size=1, num_points=128, buckets=[128],
        num_encoder_layers=1, overlap_loss_on=[0], feature_loss_on=[0],
        corr_loss_on=[0], niter=2).items() if k != "config_path"}
    (tmp_path / "mini.yaml").write_text(yaml_text(cfg))
    launch("regtr_tpu_torch.train",
           ["--config", "mini.yaml", "--logdir", "logs",
            "--num_workers", "0", "--summary_every", "1",
            "--validate_every", "2", "--nb_sanity_val_steps", "1"],
           tmp_path, tmp_path)
    (run,) = (tmp_path / "logs").iterdir()
    assert (run / "log.txt").exists() and (run / "log.rank1.txt").exists()
    assert "rank 1 of 2" in (run / "log.rank1.txt").read_text()
    assert sorted(p.name for p in (run / "ckpt").iterdir()) == [
        "2", "best.json"]
    for name in ("train", "val"):
        ours = (run / f"metrics_{name}.jsonl").read_text()
        assert ours and ours == (run / f"metrics_{name}.rank1.jsonl"
                                 ).read_text()
    train = [json.loads(x) for x in
             (run / "metrics_train.jsonl").read_text().splitlines()]
    assert [r["step"] for r in train] == [1, 2]

    launch("regtr_tpu_torch.test",
           ["--resume", str(run), "--benchmark", "ModelNet", "--logdir",
            "eval", "--num_workers", "0"], tmp_path, tmp_path)
    (two,) = (tmp_path / "eval").iterdir()
    assert (two / "log.rank1.txt").exists()
    test_cli.main(["--resume", str(run), "--benchmark", "ModelNet",
                   "--logdir", str(tmp_path / "eval1"), "--device",
                   "cpu", "--num_workers", "0"])
    (one,) = (tmp_path / "eval1").iterdir()
    got = np.load(two / "pred_transforms.npy")
    np.testing.assert_array_equal(got,
                                  np.load(one / "pred_transforms.npy"))
    shutil.rmtree(tmp_path / "logs")


if __name__ == "__main__":
    rank_main(*sys.argv[1:])
