"""Multi-node fleet simulation over the ``repro_torch.sched`` backends.

Runs one tick simulation per fleet node under a placement
(:class:`repro_torch.fleet.placement.Assignment`) and aggregates the results:

  * ``backend="numpy"`` — the exact per-node loop through
    ``core.simkernel.simulate`` (float64 reference).  Nodes whose
    (function count, seed) coincide share one simulation — under the
    default shared seed, equal-count nodes are *statistically identical*
    (the paper's banded-placement assumption), so a balanced fleet costs
    one node-sim, not ``n_nodes``.
  * ``backend="torch"`` — all nodes of a configuration batched into **one**
    tick loop of ``core.simkernel_torch``: per-node slot traces are padded
    to a common shape and stacked along a leading node dimension, so a
    14-node sweep is one loop of batched ops on the card (``device=None``)
    or, when the caller asks for it, the CPU.

Per-node demand is regenerated from the band model at the node's assigned
function count (``traces.make_workload``), which keeps the differential
contract with the legacy representative-node path: a placement handing
every node ``k`` functions reproduces ``simulate_node_share(policy, k*n,
n)`` exactly (``tests/test_fleet.py``).  Pass ``distinct_seeds=True`` to
decorrelate nodes instead.

Fleet observability: ``record_dir`` makes every simulated node emit a run
record (``node<i>/run.json``); render the merged fleet view with

  python -m repro_torch.obs.report --merge RECORD_DIR/node*

Copy of ``repro.fleet.simulate``, with ``backend="torch"`` in place of
``backend="jax"``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch.core import simkernel_torch as st
from repro_torch.core.simkernel import SimConfig, SimResult, simulate
from repro_torch.core.simkernel_torch import BIG
from repro_torch.core.traces import make_workload
from repro_torch.device import resolve
from repro_torch.fleet.placement import Assignment
from repro_torch.obs.schedstats import SchedStats
from repro_torch.sched.numpy_backend import make_policy
from repro_torch.sched.torch_backend import CODE_OF


@dataclass
class FleetResult:
    """Aggregated fleet run: one :class:`SimResult` per node."""

    policy: str
    placement: str
    nodes: List[SimResult]
    counts: np.ndarray  # per-node function counts
    duration_s: float
    n_cores: int
    backend: str = "numpy"

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    @property
    def latencies(self) -> np.ndarray:
        xs = [r.latencies for r in self.nodes if len(r.latencies)]
        return np.concatenate(xs) if xs else np.empty(0)

    @property
    def n_arrived(self) -> int:
        return sum(r.n_arrived for r in self.nodes)

    @property
    def n_completed(self) -> int:
        return sum(r.n_completed for r in self.nodes)

    def pct(self, q: float) -> float:
        lat = self.latencies
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    def throughput_slo(self, slo: float = 1.0) -> float:
        return float(np.sum(self.latencies <= slo)) / self.duration_s

    @property
    def util_effective(self) -> float:
        cap = self.n_nodes * self.n_cores * self.duration_s
        return sum(r.busy_time_s for r in self.nodes) / cap

    @property
    def util_perceived(self) -> float:
        cap = self.n_nodes * self.n_cores * self.duration_s
        return sum(r.busy_time_s + r.switch_time_s for r in self.nodes) / cap

    @property
    def overhead_frac(self) -> float:
        cap = self.n_nodes * self.n_cores * self.duration_s
        return sum(r.switch_time_s for r in self.nodes) / cap

    # -- fleet observability ------------------------------------------------
    def node_p95s(self) -> np.ndarray:
        return np.asarray([r.pct(95) for r in self.nodes])

    def imbalance(self) -> dict:
        """Per-node load-imbalance report: p95 spread across nodes and the
        max/mean overhead-fraction ratio (1.0 = perfectly balanced)."""
        p95 = self.node_p95s()
        ovh = np.asarray([r.overhead_frac for r in self.nodes])
        ok = p95 == p95  # drop NaN (empty nodes)
        return {
            "p95_min": float(p95[ok].min()) if ok.any() else float("nan"),
            "p95_max": float(p95[ok].max()) if ok.any() else float("nan"),
            "p95_spread": (
                float(p95[ok].max() - p95[ok].min()) if ok.any()
                else float("nan")
            ),
            "ovh_max_over_mean": float(
                ovh.max() / max(ovh.mean(), 1e-12)
            ),
        }

    def merged_sched(self) -> SchedStats:
        """One fleet-wide :class:`SchedStats` (entity stats summed)."""
        out = SchedStats(f"fleet.{self.policy}.{self.placement}")
        for r in self.nodes:
            out.merge(r.sched_summary())
        return out


def _empty_node(policy_name: str, duration_s: float, n_cores: int,
                backend: str) -> SimResult:
    """A node the placement left idle (``pack`` drains the tail nodes)."""
    return SimResult(
        policy=policy_name, latencies=np.empty(0),
        fn_of=np.empty(0, np.int64), arrival_of=np.empty(0),
        n_arrived=0, n_completed=0, switches=0, switch_time_s=0.0,
        busy_time_s=0.0, duration_s=duration_s, n_cores=n_cores,
    )


def _node_sim_numpy(policy_name: str, n_fns: int, duration_s: float,
                    n_cores: int, seed: int, exec_s: float,
                    threads_per_fn: int,
                    rates: Optional[np.ndarray] = None,
                    fn_ids: Optional[np.ndarray] = None,
                    extra: Optional[np.ndarray] = None) -> SimResult:
    wl = make_workload(
        "azure2021", n_fns, duration_s=duration_s, n_cores=n_cores,
        seed=seed, exec_s=exec_s,
        threads_per_fn=threads_per_fn, rates=rates, fn_ids=fn_ids,
        extra=extra,
    )
    return simulate(
        wl, make_policy(policy_name),
        SimConfig(n_cores=n_cores, hierarchy_depth=5.0, burst_us=280.0,
                  seed=seed),
    )


def _pad_trace(trace, T: int, R: int):
    """Pad a SlotTrace to (T, R) with never-arriving requests.

    Padding slots carry the sentinel arrival (never runnable) and fn id 0
    (never dispatched, so the mapping is inert); the simulation of a padded
    trace is bit-identical to the unpadded one.  The padded tensors lie on
    the trace's device.
    """
    at0, de0, fn0 = trace
    t0, r0 = at0.shape
    at = at0.new_full((T, R), BIG)
    de = de0.new_zeros((T, R))
    fn = fn0.new_zeros(T)
    at[:t0, :r0] = at0
    de[:t0, :r0] = de0
    fn[:t0] = fn0
    return type(trace)(at, de, fn)


def _fleet_sim_torch(policy_name: str, counts: np.ndarray, duration_s: float,
                     n_cores: int, seeds: List[int], exec_s,
                     threads_per_fn: int,
                     rates: Optional[List[Optional[np.ndarray]]] = None,
                     fn_ids: Optional[List[Optional[np.ndarray]]] = None,
                     extra: Optional[List[Optional[np.ndarray]]] = None,
                     device=None) -> List[SimResult]:
    """All nodes of one configuration in a single batched tick loop.

    ``exec_s`` is a scalar or one per-node execution time (chaos slowdowns);
    ``rates`` optionally carries explicit per-node request-rate vectors,
    ``fn_ids`` the matching global function ids (common random numbers)
    and ``extra`` per-node exact-count replay arrivals.  The traces are
    built and padded on the host and moved to ``device`` once, stacked.
    """
    dev = resolve(device)
    execs = ([float(exec_s)] * len(counts) if np.isscalar(exec_s)
             else [float(e) for e in exec_s])
    node_rates = rates if rates is not None else [None] * len(counts)
    node_fids = fn_ids if fn_ids is not None else [None] * len(counts)
    node_extra = extra if extra is not None else [None] * len(counts)
    traces = []
    for k, seed, ex, r, fids, xt in zip(counts, seeds, execs, node_rates,
                                        node_fids, node_extra):
        wl = make_workload(
            "azure2021", int(k), duration_s=duration_s, n_cores=n_cores,
            seed=seed, exec_s=ex, threads_per_fn=threads_per_fn, rates=r,
            fn_ids=fids, extra=xt,
        )
        traces.append(st.build_slot_trace(wl, int(k), threads_per_fn,
                                          device="cpu"))
    max_fns = int(max(counts))
    T = max_fns * threads_per_fn
    R = max(int(t.arrival_tick.shape[1]) for t in traces)
    padded = [_pad_trace(t, T, R) for t in traces]
    stacked = st.SlotTrace(*(torch.stack(xs).to(dev) for xs in zip(*padded)))
    p = st.SimParams(
        n_cores=n_cores, n_fns=max_fns,
        n_ticks=int(duration_s / st.TICK), policy=CODE_OF[policy_name],
        burst_us=280.0, depth=5.0,
    )
    out = st.simulate(stacked, p)
    done_all = out["done_tick"].cpu().numpy()
    busy = out["busy_s"].cpu().numpy()
    ovh = out["overhead_s"].cpu().numpy()

    results = []
    for i, trace in enumerate(padded):
        done = done_all[i]
        lat = st.latencies_from(trace, done)
        at = trace.arrival_tick.numpy()
        ok = (done >= 0) & (at < BIG)
        fn_of = np.broadcast_to(trace.slot_fn.numpy()[:, None], at.shape)[ok]
        results.append(SimResult(
            policy=policy_name,
            latencies=lat,
            fn_of=fn_of,
            arrival_of=at[ok] * st.TICK,
            n_arrived=int((at < BIG).sum()),
            n_completed=len(lat),
            switches=0,
            switch_time_s=float(ovh[i]),
            busy_time_s=float(busy[i]),
            duration_s=duration_s,
            n_cores=n_cores,
        ))
    return results


def simulate_fleet(
    policy_name: str,
    assignment: Assignment,
    duration_s: float = 30.0,
    n_cores: int = 12,
    seed: int = 7,
    exec_s: float = 0.2,
    backend: str = "numpy",
    distinct_seeds: bool = False,
    threads_per_fn: int = 0,
    record_dir: Optional[str] = None,
    node_exec_mult: Optional[np.ndarray] = None,
    dead: Optional[np.ndarray] = None,
    node_rates: Optional[List[Optional[np.ndarray]]] = None,
    node_extra: Optional[List[Optional[np.ndarray]]] = None,
    device=None,
) -> FleetResult:
    """Simulate every node of a placed fleet; see the module docstring.

    Chaos hooks (used by :mod:`repro_torch.fleet.rebalance`):
    ``node_exec_mult`` scales each node's per-request execution time (a
    degraded/slow node serves the same demand more slowly), ``dead`` marks
    crashed nodes — they are not simulated and appear as explicit zero-work nodes (their
    stranded arrivals are accounted by the chaos controller, not here) —
    and ``node_rates`` gives each node explicit per-function request
    rates, so a node's offered load follows the functions *assigned* to
    it (after a migration the regenerate-by-count band model would lose
    the moved functions' demand mass).  Rate-based nodes draw each
    function's arrival stream from ``(seed, global fn id)`` — common
    random numbers, so a function keeps its realization across
    placements — and bypass the equal-count cache (their workloads are
    no longer statistically identical).  ``node_extra`` (requires
    ``node_rates``) adds exact-count replay arrivals per function — the
    chaos layer's retry-backlog and epoch-carryover channel.

    ``device`` (``backend="torch"`` only; ``None``: the card) is where the
    batched tick loop runs.  The numpy backend runs on the host.
    """
    counts = assignment.counts
    assert int(counts.sum()) == int(assignment.shares.shape[0]), (
        "placement dropped functions"  # Assignment already guards this
    )
    seeds = [seed + i if distinct_seeds else seed
             for i in range(assignment.n_nodes)]
    mult = (np.ones(assignment.n_nodes) if node_exec_mult is None
            else np.asarray(node_exec_mult, float))
    is_dead = (np.zeros(assignment.n_nodes, bool) if dead is None
               else np.asarray(dead, bool))
    rate_of = (node_rates if node_rates is not None
               else [None] * assignment.n_nodes)
    extra_of = (node_extra if node_extra is not None
                else [None] * assignment.n_nodes)
    live = [(i, int(k)) for i, k in enumerate(counts)
            if k > 0 and not is_dead[i]]
    fids_of = [
        np.asarray(assignment.node_fns[i], np.int64)
        if rate_of[i] is not None else None
        for i in range(assignment.n_nodes)
    ]
    if backend == "torch":
        tpf = threads_per_fn or 8
        sims = _fleet_sim_torch(
            policy_name, np.asarray([k for _, k in live]), duration_s,
            n_cores, [seeds[i] for i, _ in live],
            [exec_s * float(mult[i]) for i, _ in live], tpf,
            rates=[rate_of[i] for i, _ in live],
            fn_ids=[fids_of[i] for i, _ in live],
            extra=[extra_of[i] for i, _ in live],
            device=device,
        )
        by_node = {i: r for (i, _), r in zip(live, sims)}
    elif backend == "numpy":
        tpf = threads_per_fn or 192
        cache: Dict[Tuple, SimResult] = {}
        by_node = {}
        for i, k in live:
            r = rate_of[i]
            key = (k, int(seeds[i]), float(mult[i]),
                   None if r is None else hash(np.asarray(r).tobytes()),
                   None if fids_of[i] is None
                   else hash(fids_of[i].tobytes()),
                   None if extra_of[i] is None
                   else hash(np.asarray(extra_of[i], np.int64).tobytes()))
            if key not in cache:
                cache[key] = _node_sim_numpy(
                    policy_name, k, duration_s, n_cores, int(seeds[i]),
                    exec_s * float(mult[i]), tpf, rates=r,
                    fn_ids=fids_of[i], extra=extra_of[i],
                )
            by_node[i] = cache[key]
    else:
        raise ValueError(f"unknown backend {backend!r}")
    nodes = [
        by_node.get(i) or _empty_node(policy_name, duration_s, n_cores,
                                      backend)
        for i in range(assignment.n_nodes)
    ]

    fleet = FleetResult(
        policy=policy_name,
        placement=assignment.placement,
        nodes=nodes,
        counts=counts,
        duration_s=duration_s,
        n_cores=n_cores,
        backend=backend,
    )
    if record_dir:
        record_fleet(fleet, record_dir)
    return fleet


def record_fleet(fleet: FleetResult, out_dir: str) -> List[str]:
    """Emit one run record per simulated node (``node<i>/run.json``).

    Uses each node's ``sched_summary()`` so records exist telemetry-on or
    -off; merge them back into one fleet view with
    ``python -m repro_torch.obs.report --merge out_dir/node*``.
    """
    from repro_torch.obs.recorder import record_run

    paths = []
    for i, r in enumerate(fleet.nodes):
        paths.append(record_run(
            os.path.join(out_dir, f"node{i}"),
            meta={
                "layer": "fleet", "policy": fleet.policy,
                "placement": fleet.placement, "node": i,
                "n_nodes": fleet.n_nodes, "n_fns": int(fleet.counts[i]),
                "duration_s": fleet.duration_s, "backend": fleet.backend,
            },
            sched=r.sched_summary(),
            include_registry=False,
        ))
    return paths
