"""Benchmark harness of the port: one module per paper table/figure, the
serving integration and the roofline analysis.  Prints
``name,us_per_call,derived`` CSV rows (us_per_call = harness wall time per
run; derived = the figure's metrics).

  PYTHONPATH=src:. python -m benchmarks_torch.run [NAME] [--device cpu]

NAME keeps the modules whose name contains it; the tick-simulator rows
and the serving engine run on the card unless ``--device cpu``.  A module
that fails prints its traceback and an ``<name>.ERROR`` row, the others
still run, and the exit code is 1.

Port of ``benchmarks/run.py``.
"""
from __future__ import annotations

import argparse
import sys
import traceback

from benchmarks_torch.common import emit


def main(argv=None) -> int:
    from benchmarks_torch import (
        fig3_overhead,
        fig5_static,
        fig6_window,
        fig7_cluster,
        fig8_cdfs,
        fig9_colocation,
        fig10_overhead,
        fig11_baselines,
        roofline,
        serving_lags,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("only", nargs="?", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = args.device

    rows = []
    modules = [
        ("fig3", lambda: fig3_overhead.main()),
        ("fig3-cluster", lambda: fig3_overhead.main(cluster_mode=True)),
        ("fig5", fig5_static.main),
        ("fig6", fig6_window.main),
        ("fig7", lambda: fig7_cluster.main(device=dev)),
        ("fig8", fig8_cdfs.main),
        ("fig9", fig9_colocation.main),
        ("fig10", fig10_overhead.main),
        ("fig11", lambda: fig11_baselines.main(device=dev)),
        ("serving", lambda: serving_lags.main(device=dev)),
        ("roofline", roofline.main),
    ]
    failed = 0
    for name, fn in modules:
        if args.only and args.only not in name:
            continue
        try:
            rows.extend(fn())
        except Exception as e:  # noqa: BLE001 — report and continue
            failed += 1
            traceback.print_exc(file=sys.stderr)
            rows.append((f"{name}.ERROR", 0.0, repr(e)[:120]))
    emit(rows)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
