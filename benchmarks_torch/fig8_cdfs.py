"""Fig 8: latency CDFs at low (3x) / high (11x) / overload (19x) colocation
for azure2021 / resctl / random, CFS vs CFS-LAGS.

Port of ``benchmarks/fig8_cdfs.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

from benchmarks_torch.common import N_CORES, emit, run_sim

DENSITIES = (3, 11, 19)
KINDS = ("azure2021", "resctl", "random")


def main() -> list:
    rows = []
    for kind in KINDS:
        for d in DENSITIES:
            for pol in ("cfs", "lags"):
                t0 = time.time()
                r = run_sim(kind, d * N_CORES, pol)
                rows.append((
                    f"fig8.{kind}.d{d}.{pol}",
                    (time.time() - t0) * 1e6,
                    f"p50={r.pct(50):.3f};p95={r.pct(95):.3f};"
                    f"p99={r.pct(99):.3f}",
                ))
    return rows


if __name__ == "__main__":
    emit(main())
