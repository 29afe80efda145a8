"""Reproduce the paper's core claim on one simulated worker node:
CFS collapses under dense colocation; CFS-LAGS keeps the median flat and
completes more requests within the 1 s SLO (Figs 3/8/9).

  PYTHONPATH=src python examples_torch/node_scheduler_sim.py

Port of ``examples/node_scheduler_sim.py`` on the port's copy of the numpy
engine (host code, as in the reference).
"""
import sys

sys.path.insert(0, "src")

from repro_torch.core.policies import make_policy  # noqa: E402
from repro_torch.core.simkernel import SimConfig, simulate  # noqa: E402
from repro_torch.core.traces import make_workload  # noqa: E402

for density in (9, 19):
    n_fns = density * 12
    print(f"--- density {density}x ({n_fns} functions on 12 HT) ---")
    for pol in ("cfs", "lags"):
        wl = make_workload("azure2021", n_fns, duration_s=30.0, seed=1)
        r = simulate(wl, make_policy(pol), SimConfig())
        print(
            f"  {pol:4s}: thr@1s={r.throughput_slo():6.1f} rps  "
            f"p50={r.pct(50):6.3f}s  p95={r.pct(95):7.3f}s  "
            f"sched_overhead={r.overhead_frac*100:4.1f}%  "
            f"switch={r.mean_switch_cost_us:4.1f}us"
        )
