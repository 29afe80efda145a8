"""Azure-Functions-style trace synthesis (paper §3, Fig 2).

The paper segments the Azure Functions Invocation Trace into 5-minute
windows, keeps the busiest segment per function, sorts the per-function
request rates, and splits them into 10 equal-size *demand bands* (heavily
skewed: tens of req/s for most functions, thousands for the busiest).
Colocation benchmarks draw functions equally from each band and scale the
count as ``density x n_cores``.

We synthesise the same structure: band rates follow a log-spaced heavy tail
calibrated so that at the paper's peak-throughput density (9x on 12 HT with
~100 ms mean execution) aggregate demand matches node capacity.  Workloads:

  * ``azure2021`` — bursty arrivals: per-function on/off (Markov-modulated
    Poisson) with rate drawn from the function's band.
  * ``resctl``    — closed-loop constant load (self-tuning concurrency).
  * ``random``    — worst case: every function uniform 0-5 req/s, aggregate
    peak matched to azure2021.
  * ``resctl-parallel`` — each invocation = 2 worker threads, both must
    finish (fig 11b).
  * ``resctl-mix`` — Alibaba mix: 30% 10 ms, 40% 100 ms, 30% 1000 ms (fig 11c).

Copy of ``repro.core.traces``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simkernel import Workload

N_BANDS = 10
MEAN_EXEC_S = 0.100  # Fibonacci microbenchmark calibrated to ~100 ms
PEAK_DENSITY = 9  # paper: azure2021 peak throughput at 9x on 12 HT


def band_rates(n_cores: int = 12, mean_exec_s: float = MEAN_EXEC_S) -> np.ndarray:
    """Per-band mean request rate (req/s), heavy-tailed across 10 bands.

    Calibrated so that ``PEAK_DENSITY * n_cores`` functions drawn equally
    from all bands offer ~100% of node CPU capacity.
    """
    raw = np.logspace(0.0, 2.6, N_BANDS)  # 1 .. ~400 relative (heavier tail)
    # Mean aggregate demand at the 9x peak sits well below raw capacity: the
    # trace is bursty (ON/OFF duty ~0.16), so the node saturates during burst
    # overlaps while mean load is ~55% — matching the paper's Fig 3 shape
    # (peak at 9x, graceful 35% CFS degradation at 19x rather than collapse).
    capacity_rps = 0.60 * n_cores / mean_exec_s
    n_fns = PEAK_DENSITY * n_cores
    per_band = n_fns / N_BANDS
    total_raw = per_band * raw.sum()
    return raw * (capacity_rps / total_raw)


def fn_rates(n_fns: int, n_cores: int = 12, seed: int = 0) -> np.ndarray:
    """Assign each function a rate by drawing equally from each band."""
    rng = np.random.default_rng(seed)
    bands = band_rates(n_cores)
    rates = np.empty(n_fns)
    for i in range(n_fns):
        b = i % N_BANDS
        rates[i] = bands[b] * rng.uniform(0.6, 1.4)
    return rates


def _mmpp_arrivals(rate, duration, rng, burst_on=1.5, burst_off=10.0):
    """Markov-modulated Poisson: ON (bursty) / OFF periods, mean ``rate``."""
    if rate <= 0:
        return np.empty(0)
    frac_on = burst_on / (burst_on + burst_off)
    on_rate = rate / frac_on
    out = []
    t = 0.0
    on = rng.uniform() < frac_on
    while t < duration:
        seg = rng.exponential(burst_on if on else burst_off)
        seg = min(seg, duration - t)
        if on and on_rate > 0:
            n = rng.poisson(on_rate * seg)
            out.append(t + np.sort(rng.uniform(0, seg, n)))
        t += seg
        on = not on
    return np.concatenate(out) if out else np.empty(0)


def make_workload(
    kind: str,
    n_fns: int,
    duration_s: float = 60.0,
    n_cores: int = 12,
    seed: int = 0,
    threads_per_fn: int = 0,
    exec_s: float = MEAN_EXEC_S,
    rates: np.ndarray = None,
    fn_ids: np.ndarray = None,
    extra: np.ndarray = None,
) -> Workload:
    """Synthesise a workload; see the module docstring.

    ``rates`` (azure2021 only) overrides the band-model draw with explicit
    per-function request rates — used by the fleet chaos layer, where a
    node's offered load must follow the *actual functions assigned to it*
    (regenerating by count alone loses the heavy-band demand mass of
    migrated functions).

    ``fn_ids`` (with ``rates``) draws each function's arrival stream from
    its own generator keyed on ``(seed, global fn id)`` instead of one
    shared stream.  These are common random numbers across placements: a
    function keeps the *same* arrival realization no matter which node it
    sits on, so comparing a rebalanced fleet against a fault-free
    reference measures failover cost, not workload-redraw noise.

    ``extra`` (with ``rates``) adds exactly ``extra[f]`` additional
    arrivals per function, spread uniformly over the window.  This is the
    replay channel for *known pending requests* (a failover retry backlog,
    work carried over an epoch boundary): feeding a backlog through the
    MMPP as added rate would realize with burst-modulated variance — a
    replayed backlog could draw several times its mass, or almost none —
    so replays inject by count, not by rate.
    """
    rng = np.random.default_rng(seed)
    if rates is not None and kind != "azure2021":
        raise ValueError("explicit rates are only supported for azure2021")
    if fn_ids is not None and rates is None:
        raise ValueError("fn_ids requires explicit rates")
    if extra is not None and rates is None:
        raise ValueError("extra arrivals require explicit rates")
    arrivals, service = [], []
    # Open-loop serverless functions spawn a handler thread per invocation
    # (paper §3: unlike resctl, azure2021 does not limit contending threads —
    # every arrival contends in the run queues immediately); closed-loop
    # resctl needs only a small pool.
    if threads_per_fn <= 0:
        threads_per_fn = 4 if kind.startswith("resctl") else 192

    if kind == "azure2021":
        if rates is None:
            rates = fn_rates(n_fns, n_cores, seed)
        else:
            rates = np.asarray(rates, float)
            assert rates.shape == (n_fns,), (
                f"rates must have one entry per function: "
                f"{rates.shape} != ({n_fns},)")
        if fn_ids is not None:
            fn_ids = np.asarray(fn_ids, np.int64)
            assert fn_ids.shape == (n_fns,), (
                f"fn_ids must have one entry per function: "
                f"{fn_ids.shape} != ({n_fns},)")
        if extra is not None:
            extra = np.asarray(extra, np.int64)
            assert extra.shape == (n_fns,), (
                f"extra must have one entry per function: "
                f"{extra.shape} != ({n_fns},)")
        for f in range(n_fns):
            rf = (rng if fn_ids is None
                  else np.random.default_rng((seed, int(fn_ids[f]))))
            a = _mmpp_arrivals(rates[f], duration_s, rf)
            if extra is not None and extra[f] > 0:
                replay = rf.uniform(0.0, duration_s, int(extra[f]))
                a = np.sort(np.concatenate([a, replay]))
            arrivals.append(a)
            service.append(np.full(len(a), exec_s))
        return Workload(n_fns, arrivals, service, threads_per_fn, duration_s=duration_s)

    if kind == "random":
        # worst case: uniform 0-5 req/s; aggregate peak matched to azure2021
        az_total = fn_rates(n_fns, n_cores, seed).sum()
        raw = rng.uniform(0.0, 5.0, n_fns)
        rates = raw * (az_total / max(raw.sum(), 1e-9))
        for f in range(n_fns):
            n = rng.poisson(rates[f] * duration_s)
            a = np.sort(rng.uniform(0, duration_s, n))
            arrivals.append(a)
            service.append(np.full(len(a), MEAN_EXEC_S))
        return Workload(n_fns, arrivals, service, threads_per_fn, duration_s=duration_s)

    if kind in ("resctl", "resctl-parallel", "resctl-mix"):
        par = 2 if kind == "resctl-parallel" else 1
        if kind == "resctl-mix":
            # Alibaba: 30% 10ms, 40% 100ms, 30% 1000ms
            svc = rng.choice([0.010, 0.100, 1.000], size=512, p=[0.3, 0.4, 0.3])
        else:
            svc = np.full(512, MEAN_EXEC_S)
        for f in range(n_fns):
            arrivals.append(np.empty(0))
            service.append(svc.copy())
        return Workload(
            n_fns,
            arrivals,
            service,
            threads_per_fn,
            parallelism=par,
            closed_loop_slots=(3 * n_cores) // 2,
            duration_s=duration_s,
        )

    raise ValueError(f"unknown workload kind {kind!r}")


def demand_band_of(n_fns: int) -> np.ndarray:
    """Band index per function (0 = lightest), matching ``fn_rates`` layout."""
    return np.arange(n_fns) % N_BANDS


def lightest_band_fns(n_fns: int, n_bands_low: int = 2) -> np.ndarray:
    """Function ids in the lowest demand bands (for CFS-LAGS-static)."""
    band = demand_band_of(n_fns)
    return np.where(band < n_bands_low)[0]
