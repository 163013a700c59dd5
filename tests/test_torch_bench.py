"""`python -m regtr_tpu_torch.bench`, the counterpart of the root bench.py,
on the CPU at a small size: one JSON line with bench.py's keys."""
import json
import subprocess
import sys
from pathlib import Path

from regtr_tpu_torch import bench

ROOT = Path(__file__).resolve().parent.parent
# bench.py's printed keys
KEYS = {"metric", "value", "unit", "vs_baseline", "init_s", "compile_s",
        "lower_compile_s", "first_exec_s", "tflops", "mfu"}


def test_bench_prints_one_json_line_with_bench_py_keys(capsys):
    record = bench.main(["1", "512", "--device", "cpu"], iters=1,
                        n_points=500)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == record
    assert set(record) == KEYS
    assert record["metric"] == "3dmatch_inference_throughput"
    assert record["unit"] == "pairs/sec" and record["value"] > 0
    assert abs(record["vs_baseline"] - record["value"] / 10.0) <= 1e-3
    assert record["tflops"] is None and record["mfu"] is None
    assert record["lower_compile_s"] == 0.0          # nothing built on a CPU
    assert abs(record["compile_s"] - record["first_exec_s"]) <= 0.11
    assert "device: cpu" in err
    for stage in ("pyramid", "backbone", "transformer", "head_pose"):
        assert stage in err


def test_bench_without_a_card_refuses_the_default_device():
    # the default device is the card: a machine without one exits non-zero
    # (on a machine with a card the default runs, and the test returns)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import torch, sys\n"
         "if torch.cuda.is_available(): sys.exit(3)\n"
         "from regtr_tpu_torch import bench\n"
         "bench.main(['1', '512'], iters=1, n_points=500)\n"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    if proc.returncode == 3:
        return
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
    assert proc.stdout == ""
