"""Offline re-scoring of saved est.log files (the port's counterpart of the
root evaluate_3dmatch.py; host only, it runs no model).

    python -m regtr_tpu_torch.evaluate_3dmatch RESULTS_DIR \\
        [--benchmark 3DMatch|3DLoMatch] [--method predator|dgr] \\
        [--gt_dir datasets/3dmatch/benchmarks] [--errors_csv errors.csv] \\
        [--errors_xlsx PATH|none]

RESULTS_DIR holds <scene>/est.log files.  The Predator protocol (RMSE <
0.2 m) prints the report and the mean registration recall and writes the
per-pair errors to RESULTS_DIR/individual_errors.xlsx (or --errors_xlsx;
'none' skips it) and to --errors_csv; the DGR protocol (RRE < 15 deg, RTE <
0.3 m) prints its report and the mean success rate.  The default --gt_dir
is the groundtruth trajectories' place in the upstream sources, relative to
their src/ directory.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from .benchmark.dgr import benchmark_dgr
from .benchmark.predator import benchmark, read_trajectory
from .evaluation import DEFAULT_GT_BENCHMARK_DIR
from .utils.xlsx import write_xlsx


def _error_table(results_dir, gt_dir):
    """Per-pair error rows, header first, as individual_errors.xlsx holds
    them."""
    rows = [["scene", "src", "tgt", "error", "flag"]]
    for scene in sorted(os.listdir(gt_dir)):
        pairs, _ = read_trajectory(
            os.path.join(results_dir, scene, "est.log"))
        errs = np.load(os.path.join(results_dir, scene, "errors.npy"))
        flags = np.load(os.path.join(results_dir, scene, "flag.npy"))
        for (i, j, _n), e, fl in zip(pairs, errs, flags):
            rows.append([scene, int(i), int(j), float(e), int(fl)])
    return rows


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("results_dir", type=str,
                   help="Directory containing <scene>/est.log files")
    p.add_argument("--benchmark", type=str, default="3DMatch",
                   choices=["3DMatch", "3DLoMatch"])
    p.add_argument("--method", type=str, default="predator",
                   choices=["predator", "dgr"])
    p.add_argument("--gt_dir", type=str, default=DEFAULT_GT_BENCHMARK_DIR)
    p.add_argument("--errors_csv", type=str,
                   help="also write per-pair transformation errors to CSV")
    p.add_argument("--errors_xlsx", type=str, default=None,
                   help="path for the per-pair error spreadsheet (default: "
                        "<results_dir>/individual_errors.xlsx; 'none' "
                        "skips it)")
    opt = p.parse_args(argv)

    gt = os.path.join(opt.gt_dir, opt.benchmark)
    if opt.method == "dgr":
        report, rate = benchmark_dgr(opt.results_dir, gt)
        print(report)
        print(f"Mean success rate: {rate:.4f}")
        return

    report, recall = benchmark(opt.results_dir, gt)
    print(report)
    print(f"Mean registration recall: {recall:.4f}")
    rows = _error_table(opt.results_dir, gt)
    if opt.errors_csv:
        with open(opt.errors_csv, "w", newline="") as f:
            csv.writer(f).writerows(rows)
        print(f"wrote {opt.errors_csv}")
    xlsx_path = opt.errors_xlsx
    if xlsx_path is None:
        xlsx_path = os.path.join(opt.results_dir, "individual_errors.xlsx")
    if xlsx_path.lower() != "none":
        write_xlsx(xlsx_path, rows, sheet_name="individual_errors")
        print(f"wrote {xlsx_path}")


if __name__ == "__main__":
    main()
