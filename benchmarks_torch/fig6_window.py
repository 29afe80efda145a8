"""Fig 6: Load Credit EMA window sweep (100 fns, cluster mode).

The paper finds ~1000 ticks (4 s at CONFIG_HZ=250) best; too small degrades
toward CFS (no run-to-completion), too large staves off heavy groups.

Port of ``benchmarks/fig6_window.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import emit, run_sim

WINDOWS = (10, 100, 500, 1000, 2500, 5000)


def main() -> list:
    rows = []
    for w in WINDOWS:
        t0 = time.time()
        r = run_sim("azure2021", 100, "lags", depth=5.0, burst_us=280.0,
                    exec_s=0.2, window=w)
        rows.append((
            f"fig6.window{w}",
            (time.time() - t0) * 1e6,
            f"p50={r.pct(50):.3f};p95={r.pct(95):.3f};"
            f"thr_slo={r.throughput_slo():.1f}",
        ))
    return rows


if __name__ == "__main__":
    emit(main())
