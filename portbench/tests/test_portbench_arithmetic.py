"""The harness's arithmetic on hand-made inputs: percentiles, the device's
busy and idle time from intervals, the readers, and counts.py against
hand counts."""
from __future__ import annotations

import pytest
import torch

from portbench import counts, readings, run, trace
from portbench.families import regtr
from portbench.reference import pyramid


def test_percentile_matches_linear_interpolation():
    xs = [5.0, 1.0, 4.0, 2.0, 3.0]
    assert run.percentile(xs, 50) == 3.0
    assert run.percentile(xs, 95) == pytest.approx(4.8)
    assert run.percentile(xs, 0) == 1.0 and run.percentile(xs, 100) == 5.0
    assert run.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_union_and_gaps():
    spans = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert trace.union_length(spans) == pytest.approx(4.0)
    assert trace.idle_gaps(spans, 0.0, 8.0) == [(2.0, 3.0), (4.0, 6.0),
                                                (7.0, 8.0)]


def test_summary_busy_idle_and_breakdown():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("k1", 5.0, 6.0)]
    host = [("aten::mm", 0.0, 8.0), ("cudaStreamSynchronize", 3.0, 4.9)]
    s = trace.summarize(dev, host)
    assert s["busy_s"] == pytest.approx(3.0)
    assert s["window_s"] == pytest.approx(8.0)
    assert s["ops"] == {"k1": pytest.approx(2.0), "k2": pytest.approx(1.5)}
    # the longest gap first, named by the innermost host op around it
    assert s["gaps"][0] == ("cudaStreamSynchronize", pytest.approx(2.0))
    assert readings.idle({"summary": s}) == pytest.approx(62.5)
    b = trace.breakdown(s)
    assert b["device_ops"][0] == ["k1", pytest.approx(2.0)]
    assert len(b["idle_gaps"]) == 3


def test_roofline_and_mfu_readers():
    peaks = {"flops": 100.0, "bytes": 10.0, "exps": 1e9}
    t = {"summary": {"ops": {"void flash_fwd_f32_kernel<32>": 4.0,
                             "other": 1.0}, "window_s": 10.0,
                     "busy_s": 5.0},
         "runs": [0, 1, 0],
         "counts": [{"k1": {"flops": 100.0, "bytes": 5.0},
                     "forward": {"flops": 200.0}},
                    {"k1": {"flops": 50.0, "bytes": 40.0},
                     "forward": {"flops": 100.0}}],
         "peaks": peaks, "stages": {"pyramid": [3.0, 1.0, 2.0]}}
    # work summed over the runs: 250 flops (2.5 s), 50 bytes (5 s)
    assert readings.roofline(t, "k1", readings.K1) == pytest.approx(125.0)
    assert readings.mfu(t, "forward") == pytest.approx(100 * 500 / 1000)
    assert readings.stage_ms(t, "pyramid") == 2.0
    assert readings.roofline(t, "k1", ("absent",)) is None


def test_attention_counts_by_hand():
    n = [3, 2, 4, 1]          # clouds 0/1 and 2/3 are pairs
    assert counts.attention_pairs(n, cross=False) == 9 + 4 + 16 + 1
    assert counts.attention_pairs(n, cross=True) == 6 + 6 + 4 + 4
    w = counts.attention_work(n, d=8, heads=2, cross=True)
    assert w == {"flops": 4 * 8 * 20, "bytes": 4 * 8 * 4 * 10,
                 "exps": 2 * 20}
    wb = counts.attention_work(n, d=8, heads=2, cross=False, backward=True)
    assert wb == {"flops": 8 * 8 * 30, "bytes": 4 * 8 * 8 * 10 + 4 * 2 * 10}


def test_search_counts_by_hand():
    q = torch.tensor([[[0.0, 0, 0], [1.0, 0, 0], [5.0, 0, 0]]])
    qm = torch.tensor([[True, True, False]])
    s = torch.tensor([[[0.0, 0, 0], [0.5, 0, 0], [3.0, 0, 0]]])
    sm = torch.tensor([[True, True, True]])
    # within 0.6: (0, 0), (0, 0.5), (1, 0.5); the masked query counts not
    assert pyramid.pairs_within(q, qm, s, sm, 0.6) == 3
    w = counts.search_work(2, 3, 3, 3, k=4, pairs=3)
    assert w == {"bytes": 12 * 5 + 6 + 4 * 4 * 2, "flops": 24}
    assert counts.bound_s({"flops": 10.0, "bytes": 30.0},
                          {"flops": 1.0, "bytes": 10.0, "exps": 1.0}) == 10


def test_batch_counts_on_a_tiny_pyramid():
    from portbench.tests.tiny import tiny_config

    cfg = tiny_config()
    gen = torch.Generator().manual_seed(0)
    pts = torch.rand(2, 256, 3, generator=gen)
    mask = torch.ones(2, 256, dtype=torch.bool)
    mask[1, 200:] = False
    spec = pyramid.make_spec(cfg, 256)
    levels = pyramid.build(pts, mask, spec)
    c = regtr.batch_counts(cfg, levels, spec, pyramid.pairs_within)
    coarse = [int(x) for x in levels[-1].mask.sum(1)]
    d, layers = cfg["d_embed"], cfg["num_encoder_layers"]
    pairs = (sum(x * x for x in coarse) + 2 * coarse[0] * coarse[1])
    assert c["k1"]["flops"] == 4 * d * pairs * layers
    # three searches per level but the last
    assert len(levels) == 2
    assert c["k6"]["flops"] % 8 == 0 and c["k6"]["flops"] > 0
    assert c["train"]["flops"] > 3 * c["forward"]["flops"]
    # KPConv's products dominate the backbone: the first block by hand
    p = cfg["num_kernel_points"]
    entries = int((levels[0].neighbors < 256).sum())
    first = 2 * entries * p * 1 + 2 * (256 + 200) * p * 1 * (cfg[
        "first_feats_dim"] // 2)
    assert c["forward"]["flops"] > first
