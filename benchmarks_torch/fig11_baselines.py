"""Fig 11: cgroup-aware task completion vs tuned baselines.

120 functions of identical work under resctl / resctl-parallel / resctl-mix,
comparing CFS, tuned CFS (100 ms slice), SCHED_RR, EEVDF, tuned EEVDF and
CFS-LAGS, plus the 12-function uncontended reference.

The second block repeats the sweep on the tick simulator
(``fig11.torch.*`` rows): every protocol policy kind runs through
``repro_torch.sched.torch_backend`` in one tick loop on the card.

Port of ``benchmarks/fig11_baselines.py``: the numpy rows are the
reference's; its JAX rows (``fig11.jax.*``) become ``fig11.torch.*``, on
the card unless ``--device cpu``.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from benchmarks_torch.common import device_arg, emit, run_sim, run_sim_torch
from repro_torch.core.traces import lightest_band_fns
from repro_torch.device import resolve

POLICIES = ("cfs", "cfs-tuned", "rr", "eevdf", "eevdf-tuned", "lags")
KINDS = ("resctl", "resctl-parallel", "resctl-mix")
# the five policy kinds on the tick simulator (tuned variants share kinds)
TORCH_POLICIES = ("cfs", "eevdf", "rr", "lags", "lags-static")


def torch_rows(device=None, policies=TORCH_POLICIES) -> list:
    """The ``fig11.torch.120fn-<policy>`` rows on the open-loop trace (the
    tick simulator replays recorded arrivals; closed-loop resctl load
    generation stays numpy-only), one for each of ``policies``."""
    rows = []
    static = lightest_band_fns(120, n_bands_low=3)
    for pol in policies:
        t0 = time.time()
        lat, _ = run_sim_torch(
            "azure2021", 120, pol,
            static_rt=static if pol == "lags-static" else None,
            device=device,
        )
        rows.append((
            f"fig11.torch.120fn-{pol}",
            (time.time() - t0) * 1e6,
            f"p50={np.median(lat) if len(lat) else -1:.3f};"
            f"p95={np.percentile(lat, 95) if len(lat) else -1:.3f};"
            f"n={len(lat)}",
        ))
    return rows


def main(device=None) -> list:
    device = resolve(device)  # before the host rows: no card, no run
    rows = []
    for kind in KINDS:
        t0 = time.time()
        base = run_sim(kind, 12, "cfs")
        rows.append((
            f"fig11.{kind}.12fn-cfs",
            (time.time() - t0) * 1e6,
            f"p50={base.pct(50):.3f};p95={base.pct(95):.3f}",
        ))
        for pol in POLICIES:
            t0 = time.time()
            r = run_sim(kind, 120, pol)
            rows.append((
                f"fig11.{kind}.120fn-{pol}",
                (time.time() - t0) * 1e6,
                f"p50={r.pct(50):.3f};p95={r.pct(95):.3f};"
                f"thr_slo={r.throughput_slo():.1f}",
            ))
    return rows + torch_rows(device)


if __name__ == "__main__":
    emit(main(device_arg(sys.argv[1:])))
