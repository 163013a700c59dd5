"""The port's small helpers against the JAX package's on the same inputs:
utils/misc.py, utils/profiling.py (the timings.txt line format), and the
ModelNet adapters to other methods' tuples (Dict2DcpList,
Dict2PointnetLKList)."""
import json
import random
from collections import namedtuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from regtr_tpu.data import modelnet_transforms as jax_mt
from regtr_tpu.utils import misc as jax_misc
from regtr_tpu.utils import profiling as jax_profiling
from regtr_tpu_torch.data import modelnet_transforms as mt
from regtr_tpu_torch.utils import misc, profiling
from tests.test_torch_eval import assert_same

Pair = namedtuple("Pair", "a b")


def tree(seed=0):
    rng = np.random.RandomState(seed)
    return {"x": torch.from_numpy(rng.randn(3, 2).astype(np.float32)),
            "n": [torch.arange(4), (torch.ones(2, dtype=torch.float64),
                                    "label")],
            "p": Pair(rng.randn(2).astype(np.float32), 7.5)}


def same_tree(got, want, leaf=assert_same):
    """Equal structures (dicts by key: JAX sorts them) and leaves."""
    if isinstance(got, (dict, list, tuple)):
        assert type(got) is type(want)
    if isinstance(got, dict):
        assert sorted(got) == sorted(want)
        for k in got:
            same_tree(got[k], want[k], leaf)
    elif isinstance(got, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            same_tree(g, w, leaf)
    else:
        leaf(got, want)


def test_to_numpy_matches_jax():
    got = misc.to_numpy(tree())
    same_tree(got, jax_misc.to_numpy(tree()))
    assert isinstance(got["p"], Pair)
    bf16 = misc.to_numpy(torch.ones(2, dtype=torch.bfloat16))
    assert bf16.dtype == np.float32


def test_all_to_device_moves_tensors_and_arrays():
    """Tensors and arrays become tensors on the device, holding what the
    JAX package's device_put holds; other leaves stay (JAX refuses a
    string, so its tree has none)."""
    t = tree()
    got = misc.all_to_device(t, "cpu")
    assert got["n"][1][1] == "label" and got["p"].b == 7.5
    t["n"][1] = t["n"][1][:1]
    got["n"][1] = got["n"][1][:1]
    want = jax_misc.all_to_device(misc.to_numpy(t), None)

    def leaf(g, w):
        if isinstance(g, float):
            assert g == float(w)
            return
        assert torch.is_tensor(g)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))

    same_tree(got, want, leaf)


@pytest.mark.parametrize("bad", [None, "nan", "inf", "int"])
def test_all_isfinite_matches_jax(bad):
    t = tree()
    if bad == "nan":
        t["x"][1, 1] = float("nan")
    elif bad == "inf":
        t["p"] = Pair(t["p"].a, float("inf"))
    elif bad == "int":
        t["n"][0][2] = -1          # integer leaves are not judged
    want = jax_misc.all_isfinite(misc.to_numpy(t))
    assert misc.all_isfinite(t) == want == (bad in (None, "int"))


def test_setup_seed_seeds_the_host_generators_as_jax():
    misc.setup_seed(11)
    got = (random.random(), np.random.rand(3))
    torch_draw = torch.rand(2)
    jax_misc.setup_seed(11)
    want = (random.random(), np.random.rand(3))
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    misc.setup_seed(11)
    random.random(), np.random.rand(3)
    assert torch.equal(torch.rand(2), torch_draw)


def test_metrics_to_string_and_batch_indices_match_jax():
    metrics = {"loss": torch.tensor(0.123456), "rot": torch.ones(3),
               "n": 4, "acc": np.float32(0.5)}
    jmetrics = {k: np.asarray(v) for k, v in misc.to_numpy(metrics).items()}
    for prefix in ("", "val"):
        assert misc.metrics_to_string(metrics, prefix) == \
            jax_misc.metrics_to_string(jmetrics, prefix)
    lengths = [3, 0, 2]
    want = jax_misc.lengths_to_batch_indices(lengths)
    assert_same(misc.lengths_to_batch_indices(lengths), want)
    np.testing.assert_array_equal(
        misc.lengths_to_batch_indices(torch.tensor(lengths)).numpy(), want)


def test_timings_file_matches_jax(tmp_path):
    """The same records give the same timings.txt lines; stages keep their
    first-use order and report their means."""
    records = [("preproc", 0.25), ("encoder", 1.0), ("preproc", 0.5),
               ("attention", 1e-6), ("pose", 12345.678901)]
    for module, name in ((profiling, "port.txt"), (jax_profiling, "jax.txt")):
        timer = module.StageTimer(tmp_path / name)
        for _ in range(2):
            for stage, s in records:
                timer.record(stage, s)
            timer.dump()
    text = (tmp_path / "port.txt").read_text()
    assert text == (tmp_path / "jax.txt").read_text()
    assert text.splitlines()[0].split("\t")[0].strip() == "0.375000"
    st = profiling.StageTimer()
    assert st.summary() == {} and st.dump() is None


def test_timers_and_force_on_the_cpu(tmp_path):
    x = torch.arange(10.0)
    assert profiling.force([x, torch.ones(2)]) == float(
        jax_profiling.force([jnp.arange(10.0)])) == 28.0
    timer = profiling.StageTimer(tmp_path / "t.txt", device="cpu")
    with timer.stage("a", lambda: x * 2):
        (x @ x).item()
    with timer.stage("a"):
        pass
    assert timer.timers["a"].calls == 2 and timer.summary()["a"] >= 0.0
    calls = []
    first, per = profiling.bench(lambda v: calls.append(1) or v + 1, x,
                                 iters=4)
    assert len(calls) == 5 and first >= 0.0 and per >= 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    with profiling.device_trace(tmp_path / "trace"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])


@pytest.mark.parametrize("noise_type", ["clean", "crop"])
def test_dict2_adapters_match_jax(noise_type):
    """A ModelNet sample through each adapter, bitwise the JAX one's."""
    cloud = np.random.RandomState(0).rand(700, 6).astype(np.float32)
    kwargs = dict(rot_mag=45.0, trans_mag=0.5, num_points=512)
    train, _ = mt.get_transforms(noise_type, **kwargs)
    jtrain, _ = jax_mt.get_transforms(noise_type, **kwargs)

    def sample():
        return {"points": cloud.copy(), "label": np.int64(3),
                "idx": np.int32(5)}

    pair = train(sample(), np.random.RandomState(1))
    jpair = jtrain(sample(), np.random.RandomState(1))
    raw = sample()
    for port, ref in ((mt.Dict2DcpList(), jax_mt.Dict2DcpList()),
                      (mt.Dict2PointnetLKList(),
                       jax_mt.Dict2PointnetLKList())):
        if isinstance(port, mt.Dict2DcpList) and "points" in pair:
            continue        # a clean pipeline's sample is split already
        got, want = port(dict(pair)), ref(dict(jpair))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_same(np.asarray(g), np.asarray(w))
    got = mt.Dict2PointnetLKList()(raw)
    want = jax_mt.Dict2PointnetLKList()(sample())
    assert_same(got[0], want[0])
    assert got[1] == want[1]
