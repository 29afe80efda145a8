"""Fig 3: impact of workload colocation on throughput and scheduling overhead.

(a) throughput@1s vs density; (b) overhead % of CPU; (c) mean switch cost.
``--cluster-mode`` reproduces §3.2 (Knative node: depth-5 hierarchy, 100
pods, longer bursts -> ~20 % overhead at ~48 us/switch).

Runs with telemetry on: derived columns include schedstat-backed tail stats
(p99 per-switch cost, peak run-queue depth), and ``--obs-dir DIR`` records
one diffable run record per configuration for ``repro_torch.obs.report``.

Port of ``benchmarks/fig3_overhead.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import os
import sys
import time

import repro_torch.obs as obs
from benchmarks_torch.common import DUR, N_CORES, emit, run_sim


def _rec(obs_dir: str, name: str):
    return os.path.join(obs_dir, name) if obs_dir else None


def main(cluster_mode: bool = False, densities=(3, 9, 13, 19),
         obs_dir: str = "") -> list:
    obs.enable()
    rows = []
    if cluster_mode:
        t0 = time.time()
        r = run_sim("azure2021", 100, "cfs", depth=5.0, burst_us=280.0,
                    exec_s=0.2, record_dir=_rec(obs_dir, "cluster_cfs"))
        s = r.sched_summary()
        rows.append((
            "fig3.cluster_mode.cfs",
            (time.time() - t0) * 1e6,
            f"ovh={r.overhead_frac*100:.1f}%;switch_us={r.mean_switch_cost_us:.1f};"
            f"p99sw_us={s.switch_cost_us.pct(99):.1f}",
        ))
        return rows
    for kind in ("azure2021", "resctl"):
        for d in densities:
            t0 = time.time()
            r = run_sim(kind, d * N_CORES, "cfs",
                        record_dir=_rec(obs_dir, f"{kind}_d{d}"))
            s = r.sched_summary()
            rows.append((
                f"fig3.{kind}.d{d}",
                (time.time() - t0) * 1e6,
                (
                    f"thr_slo={r.throughput_slo():.1f}rps;"
                    f"ovh={r.overhead_frac*100:.1f}%;"
                    f"switch_us={r.mean_switch_cost_us:.1f};"
                    f"sw_per_s={r.switches/DUR:.0f};"
                    f"p99sw_us={s.switch_cost_us.pct(99):.1f};"
                    f"runq_peak={s.runq_peak():.0f}"
                ),
            ))
    return rows


if __name__ == "__main__":
    argv = sys.argv[1:]
    out = ""
    if "--obs-dir" in argv:
        out = argv[argv.index("--obs-dir") + 1]
    emit(main(cluster_mode="--cluster-mode" in argv, obs_dir=out))
