"""Fig 10: scheduling overhead with increasing colocation — CFS vs LAGS.
Paper: LAGS cuts mean switch cost 21 -> ~13 us and rate by ~13 %.

Telemetry is on for every run: the summary row is schedstat-backed (per-
switch cost tails and switch-time share per policy), and ``--obs-dir DIR``
records one run record per (policy, density) so any pair can be diffed with
``python -m repro_torch.obs.report --diff``.

Port of ``benchmarks/fig10_overhead.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import os
import sys
import time

import repro_torch.obs as obs
from benchmarks_torch.common import DUR, N_CORES, emit, run_sim

DENSITIES = (9, 13, 19)


def main(obs_dir: str = "") -> list:
    obs.enable()
    rows = []
    ref = {}
    for d in DENSITIES:
        for pol in ("cfs", "lags"):
            t0 = time.time()
            rec = os.path.join(obs_dir, f"{pol}_d{d}") if obs_dir else None
            r = run_sim("azure2021", d * N_CORES, pol, record_dir=rec)
            ref[(pol, d)] = r
            s = r.sched_summary()
            rows.append((
                f"fig10.{pol}.d{d}",
                (time.time() - t0) * 1e6,
                f"ovh={r.overhead_frac*100:.1f}%;"
                f"switch_us={r.mean_switch_cost_us:.1f};"
                f"sw_per_s={r.switches/DUR:.0f};"
                f"p99sw_us={s.switch_cost_us.pct(99):.1f}",
            ))
    c, l = ref[("cfs", 19)], ref[("lags", 19)]
    sc, sl = c.sched_summary(), l.sched_summary()
    rows.append((
        "fig10.summary.d19",
        0.0,
        (
            f"cost_cfs={c.mean_switch_cost_us:.1f}us;"
            f"cost_lags={l.mean_switch_cost_us:.1f}us;"
            f"rate_drop={100*(1-l.switches/max(c.switches,1)):.0f}%;"
            f"share_cfs={sc.switch_share*100:.1f}%;"
            f"share_lags={sl.switch_share*100:.1f}%"
        ),
    ))
    return rows


if __name__ == "__main__":
    argv = sys.argv[1:]
    out = argv[argv.index("--obs-dir") + 1] if "--obs-dir" in argv else ""
    emit(main(obs_dir=out))
