"""Fig 9: throughput + median/tail latency as colocation increases
(azure2021), CFS vs CFS-LAGS.  The paper's headline: CFS's ideal density is
8x; LAGS accommodates at least +12 more functions at the 1 s target and
holds overload degradation to <10 % (vs 35 %).

Port of ``benchmarks/fig9_colocation.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import DUR, N_CORES, emit, run_sim

DENSITIES = (3, 6, 8, 9, 10, 11, 13, 16, 19)


def main() -> list:
    rows = []
    peak = {}
    for pol in ("cfs", "lags"):
        for d in DENSITIES:
            t0 = time.time()
            r = run_sim("azure2021", d * N_CORES, pol)
            thr = r.throughput_slo()
            peak[pol] = max(peak.get(pol, 0.0), thr)
            rows.append((
                f"fig9.{pol}.d{d}",
                (time.time() - t0) * 1e6,
                f"thr_slo={thr:.1f};p50={r.pct(50):.3f};p95={r.pct(95):.3f}",
            ))
        last = [float(x[2].split("thr_slo=")[1].split(";")[0])
                for x in rows if x[0].startswith(f"fig9.{pol}.d19")][0]
        rows.append((
            f"fig9.{pol}.degradation",
            0.0,
            f"peak={peak[pol]:.1f};at19x={last:.1f};"
            f"drop={100*(1-last/max(peak[pol],1e-9)):.0f}%",
        ))
    return rows


if __name__ == "__main__":
    emit(main())
