"""Beyond-paper: LAGS admission in the multi-tenant serving engine.

Density sweep over tenant count on one serving slice: LAGS vs fair vs fifo
admission under bursty heavy-tailed tenant demand, measuring SLO
attainment, median latency and engine switch overhead (weight-swap
residency misses + batch re-formation).

Port of ``benchmarks/serving_lags.py`` on ``repro_torch.serving.engine``,
whose device is the card unless ``--device cpu``.  The engine's credit
tick launches the CUDA ``lags_cluster_select`` only from
``EngineConfig.pallas_threshold`` (256) tenants, as the reference's gate
on its Pallas tick does; at this sweep's 24 to 96 tenants it runs on the
host in both packages.
"""
from __future__ import annotations

import sys
import time

import numpy as np

from benchmarks_torch.common import device_arg, emit
from repro_torch.core.traces import _mmpp_arrivals
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.serving.engine import Engine, EngineConfig


def run_engine(policy: str, n_tenants: int, seed: int = 0, dur: float = 60.0,
               device=None):
    rng = np.random.default_rng(seed)
    tenants = {
        i: Tenant(i, weight_mb=float(rng.uniform(32, 256)))
        for i in range(n_tenants)
    }
    rates = np.logspace(-1, 0.8, n_tenants)
    rates *= 28.0 / rates.sum()
    arrivals, rid = [], 0
    for t in range(n_tenants):
        for a in _mmpp_arrivals(rates[t], dur, rng, burst_on=1.0, burst_off=9.0):
            arrivals.append(
                Request(rid, t, int(rng.integers(64, 512)),
                        int(rng.integers(16, 128)), float(a))
            )
            rid += 1
    eng = Engine(EngineConfig(policy=policy, max_resident=12), tenants,
                 device=device)
    st = eng.run(dur, arrivals)
    lat = np.asarray([r.latency for r in st.completed])
    return st, lat, rid


def main(densities=(24, 48, 96), device=None) -> list:
    rows = []
    for n in densities:
        for pol in ("fifo", "fair", "lags"):
            t0 = time.time()
            st, lat, total = run_engine(pol, n, device=device)
            rows.append((
                f"serving.t{n}.{pol}",
                (time.time() - t0) * 1e6,
                (
                    f"done={len(st.completed)}/{total};"
                    f"p50={np.median(lat) if len(lat) else -1:.2f};"
                    f"slo2s={100*np.mean(lat<2.0) if len(lat) else 0:.0f}%;"
                    f"ovh={st.overhead_frac*100:.1f}%"
                ),
            ))
    return rows


if __name__ == "__main__":
    emit(main(device=device_arg(sys.argv[1:])))
