"""Fig 5: CFS-LAGS-static (SCHED_RR for the lowest demand bands) vs CFS —
per-group latency CDFs under 100-function cluster-mode colocation (§4.1).

Checks the paper's counter-intuitive result: prioritising group-low also
improves group-high, via >75 % less run-queue waiting overall.

Port of ``benchmarks/fig5_static.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import emit, run_sim
from repro_torch.core.traces import demand_band_of, lightest_band_fns

N_FNS = 100


def main() -> list:
    rows = []
    static = lightest_band_fns(N_FNS, n_bands_low=3)
    band = demand_band_of(N_FNS)
    for pol in ("cfs", "lags-static"):
        t0 = time.time()
        r = run_sim("azure2021", N_FNS, pol, depth=5.0, burst_us=280.0,
                    exec_s=0.2, static_rt=static)
        is_low = np.isin(r.fn_of, static)
        lo = r.latencies[is_low]
        hi = r.latencies[~is_low]
        rows.append((
            f"fig5.{pol}",
            (time.time() - t0) * 1e6,
            (
                f"low_p50={np.median(lo) if len(lo) else -1:.3f};"
                f"low_p95={np.percentile(lo,95) if len(lo) else -1:.3f};"
                f"high_p50={np.median(hi) if len(hi) else -1:.3f};"
                f"high_p95={np.percentile(hi,95) if len(hi) else -1:.3f}"
            ),
        ))
    return rows


if __name__ == "__main__":
    emit(main())
