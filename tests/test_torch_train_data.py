"""The port's training data on the CPU, bitwise against the JAX package on
the same seeds: the so3 helpers and pose samplers of se3_np, the ModelNet
pair pipelines, the synthetic shapes, the 3DMatch train phase with its
augmentation, ModelNetHdf on a small HDF5 file, and the train loader's
batches over two epochs.
"""
import numpy as np
import pytest

from regtr_tpu.core import se3_np as jax_se3
from regtr_tpu.data import get_dataloader as jax_get_dataloader
from regtr_tpu.data import get_dataset as jax_get_dataset
from regtr_tpu.data import modelnet_transforms as jax_mt
from regtr_tpu.data import transforms as jax_transforms
from regtr_tpu.data.modelnet import make_modelnet_datasets as jax_modelnet
from regtr_tpu.data.modelnet import (
    modelnet_sample_to_pair as jax_sample_to_pair)
from regtr_tpu_torch.config import modelnet_config
from regtr_tpu_torch.core import se3_np
from regtr_tpu_torch.data import get_dataloader, get_dataset, transforms
from regtr_tpu_torch.data import modelnet_transforms as mt
from regtr_tpu_torch.data.modelnet import (make_modelnet_datasets,
                                           modelnet_sample_to_pair)
from regtr_tpu_torch.data.synthetic import SyntheticShapeDataset
from tests.synth_threedmatch import build_root, tiny_cfg
from tests.test_torch_eval import assert_same


def assert_samples_equal(got, want):
    assert got.keys() == want.keys()
    for key in want:
        assert_same(got[key], want[key])


def synthetic_cfg(**over):
    """The synthetic 3DMatch-scale recipe's data keys at a small size: the
    crop pipeline with a per-sample crop range, base clouds of 2048
    points."""
    cfg = modelnet_config(dataset="synthetic", root="", num_points=512,
                          partial_range=[0.5, 0.85], synthetic_items=4,
                          synthetic_val_items=4, train_batch_size=2,
                          val_batch_size=2, buckets=[512])
    cfg.update(over)
    return cfg


def test_se3_np_so3_and_samplers_match_jax():
    rng = np.random.RandomState(3)
    omega = rng.randn(6, 3).astype(np.float32)
    assert_same(se3_np.so3_hat(omega), jax_se3.so3_hat(omega))
    assert_same(se3_np.so3_exp(omega), jax_se3.so3_exp(omega))
    for max_deg in (None, 30.0):
        a, b = np.random.RandomState(7), np.random.RandomState(7)
        for _ in range(3):
            assert_same(se3_np.sample_uniform_rotation(a, max_deg),
                        jax_se3.sample_uniform_rotation(b, max_deg))
    a, b = np.random.RandomState(8), np.random.RandomState(8)
    assert_same(se3_np.sample_small_se3(a, 0.2, 0.05),
                jax_se3.sample_small_se3(b, 0.2, 0.05))
    a, b = np.random.RandomState(9), np.random.RandomState(9)
    assert_same(transforms.sample_small_pose(a),
                jax_transforms.sample_small_pose(b))
    assert_same(transforms.sample_large_pose(a),
                jax_transforms.sample_large_pose(b))


@pytest.mark.parametrize("phase", ["train", "val"])
def test_synthetic_items_match_jax(phase):
    cfg = synthetic_cfg()
    port, ref = make_modelnet_datasets(cfg, phase), jax_modelnet(cfg, phase)
    assert isinstance(port, SyntheticShapeDataset)
    assert port.n_points == ref.n_points == 2048
    assert (port.seed, len(port)) == (ref.seed, len(ref))
    sizes = set()
    for i in range(4):
        got, want = port[i], ref[i]
        assert_samples_equal(got, want)
        assert_samples_equal(port[i], got)       # seeded per item
        sizes.add(got["src_xyz"].shape[0])
    # train draws each item's crop from partial_range, val keeps 0.7
    assert len(sizes) > 1 if phase == "train" else sizes == {359}


@pytest.mark.parametrize("noise_type", ["clean", "jitter", "crop"])
@pytest.mark.parametrize("predator_compat", [False, True])
def test_modelnet_pipelines_match_jax(noise_type, predator_compat):
    cloud = np.random.RandomState(0).rand(700, 6).astype(np.float32)
    kwargs = dict(rot_mag=45.0, trans_mag=0.5, num_points=512,
                  partial_p_keep=[0.7, 0.7], predator_compat=predator_compat)
    port = mt.get_transforms(noise_type, **kwargs)
    ref = jax_mt.get_transforms(noise_type, **kwargs)
    for pipe, jpipe in zip(port, ref):          # train, then test
        for seed in (1, 2):
            def sample():
                return {"points": cloud.copy(), "label": np.int64(3),
                        "idx": np.int32(5)}

            got = pipe(sample(), np.random.RandomState(seed))
            want = jpipe(sample(), np.random.RandomState(seed))
            assert_samples_equal(got, want)
            assert_samples_equal(modelnet_sample_to_pair(got),
                                 jax_sample_to_pair(want))
    # the test pipeline's clouds: crop keeps 0.7 of 512 points, or the
    # upstream 717 with predator_compat
    expected = 512 if noise_type != "crop" else (
        717 if predator_compat else 359)
    assert modelnet_sample_to_pair(got)["tgt_xyz"].shape[0] == expected


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return build_root(tmp_path_factory.mktemp("root"))


@pytest.mark.parametrize("perturb", ["small", "large"])
def test_threedmatch_train_phase_matches_jax(root, perturb):
    """Each sample's augmentation is seeded from numpy's global state:
    the same global seed before each side gives the same samples."""
    cfg = tiny_cfg(root, root / "meta")
    cfg["perturb_pose"] = perturb
    port, ref = get_dataset(cfg, "train"), jax_get_dataset(cfg, "train")
    assert [type(t).__name__ for t in port.transforms.transforms] == [
        "RigidPerturb", "Jitter", "ShufflePoints", "RandomSwap"]
    swapped = set()
    for i in range(len(ref)):
        for seed in (11, 12):
            np.random.seed(seed)
            got = port[i]
            np.random.seed(seed)
            want = ref[i]
            assert_samples_equal(got, want)
            swapped.add(got["src_path"] == ref.infos["src"][i])
    assert swapped == {True, False}     # RandomSwap went both ways


def write_modelnet_h5(base, n_shapes=6, n_points=300):
    import h5py

    rng = np.random.RandomState(4)
    (base / "shape_names.txt").write_text("airplane\nbathtub\nbed\n")
    for subset in ("train", "test"):
        name = f"ply_data_{subset}0.h5"
        (base / f"{subset}_files.txt").write_text(
            f"data/modelnet40_ply_hdf5_2048/{name}\n")
        with h5py.File(base / name, "w") as f:
            f["data"] = rng.rand(n_shapes, n_points, 3).astype(np.float32)
            f["normal"] = rng.randn(n_shapes, n_points, 3).astype(np.float32)
            f["label"] = (np.arange(n_shapes) % 3)[:, None].astype(np.uint8)
    (base / "half1.txt").write_text("bed\nairplane\n")


@pytest.mark.parametrize("phase", ["train", "test"])
def test_modelnet_hdf_matches_jax(tmp_path, phase):
    pytest.importorskip("h5py")
    write_modelnet_h5(tmp_path)
    cfg = modelnet_config(root=str(tmp_path), num_points=256,
                          train_categoryfile=str(tmp_path / "half1.txt"),
                          test_categoryfile=None)
    port, ref = make_modelnet_datasets(cfg, phase), jax_modelnet(cfg, phase)
    assert type(port).__name__ == "ModelNetHdf"
    assert len(port) == len(ref) == (4 if phase == "train" else 6)
    for i in range(len(ref)):
        np.random.seed(20 + i)
        got = port[i]
        np.random.seed(20 + i)
        assert_samples_equal(got, ref[i])
    assert_same(port._labels, ref._labels)


def test_train_loader_batches_match_jax():
    cfg = synthetic_cfg(synthetic_items=6)
    port = get_dataloader(cfg, "train", num_workers=2)
    ref = jax_get_dataloader(cfg, "train", num_workers=2)
    assert len(port) == len(ref) == 3
    orders = []
    for epoch in (0, 1):
        port.set_epoch(epoch)
        ref.set_epoch(epoch)
        got = [b for _, b in zip(range(2), port)]
        want = [b for _, b in zip(range(2), ref)]
        for (gb, gm), (wb, wm) in zip(got, want):
            assert_samples_equal(gb, wb)
            assert_samples_equal(gm, wm)
        orders.append([gm["idx"] for _, gm in got])
    assert orders[0] != orders[1]       # the shuffle follows seed + epoch
