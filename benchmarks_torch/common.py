"""Shared helpers for the per-figure benchmarks of the port.

Port of ``benchmarks/common.py``: ``run_sim`` on the port's copy of the
numpy engine (host code, as in the reference), ``run_sim_torch`` on the
tick simulator ``repro_torch.core.simkernel_torch`` (the reference's
``run_sim_jax``), on the card unless ``device="cpu"``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager

from repro_torch.core.policies import make_policy
from repro_torch.core.simkernel import SimConfig, simulate
from repro_torch.core.traces import make_workload

N_CORES = 12
DUR = 30.0  # seconds of simulated time per run (fast mode)


def run_sim(kind: str, n_fns: int, policy: str, *, duration=DUR, seed=1,
            depth=2.0, burst_us=120.0, window=1000, static_rt=None,
            exec_s=0.1, record_dir=None):
    wl = make_workload(kind, n_fns, duration_s=duration, n_cores=N_CORES,
                       seed=seed, exec_s=exec_s)
    pol = make_policy(policy, credit_window=window) if policy != "lags-static" \
        else make_policy(policy, static_rt_fns=static_rt)
    cfg = SimConfig(n_cores=N_CORES, hierarchy_depth=depth, burst_us=burst_us)
    r = simulate(wl, pol, cfg)
    if record_dir:
        from repro_torch.obs.recorder import record_run

        record_run(
            record_dir,
            meta={"layer": "simkernel", "kind": kind, "n_fns": n_fns,
                  "policy": policy, "duration_s": duration, "seed": seed,
                  "depth": depth, "burst_us": burst_us},
            sched=r.sched_summary(),
            include_registry=False,
        )
    return r


def run_sim_torch(kind: str, n_fns: int, policy: str, *, duration=DUR,
                  seed=1, depth=2.0, burst_us=120.0, window=1000,
                  static_rt=None, exec_s=0.1, threads_per_fn=4,
                  n_cores=N_CORES, device=None):
    """The same sweep on the tick simulator (any registered policy), on
    ``device`` (default cuda).

    Returns ``(latencies, outputs)``; policy names resolve through
    ``repro_torch.sched.torch_backend.CODE_OF``.
    """
    from repro_torch.core import simkernel_torch as st
    from repro_torch.sched.torch_backend import CODE_OF

    wl = make_workload(kind, n_fns, duration_s=duration, n_cores=n_cores,
                       seed=seed, exec_s=exec_s, threads_per_fn=threads_per_fn)
    trace = st.build_slot_trace(wl, n_fns, threads_per_fn, device=device)
    p = st.SimParams(
        n_cores=n_cores, n_fns=n_fns, n_ticks=int(duration / st.TICK),
        policy=CODE_OF[policy], burst_us=burst_us, depth=depth,
        window_ticks=window,
        rt_fns=() if static_rt is None
        else tuple(int(f) for f in static_rt),
    )
    out = st.simulate(trace, p)
    return st.latencies_from(trace, out["done_tick"]), out


def device_arg(argv) -> str | None:
    """The value of ``--device`` in ``argv`` (None: the card)."""
    return argv[argv.index("--device") + 1] if "--device" in argv else None


@contextmanager
def timed(rows: list, name: str, derived: str = ""):
    t0 = time.time()
    yield
    rows.append((name, (time.time() - t0) * 1e6, derived))


def emit(rows):
    print("name,us_per_call,derived")
    for name, us, derived in rows:
        print(f"{name},{us:.0f},{derived}")
