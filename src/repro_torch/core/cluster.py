"""Cluster consolidation — compatibility shim over :mod:`repro_torch.fleet`.

The consolidation study lives in the placement-aware fleet layer
(``repro_torch.fleet.consolidate`` hosts the sweep and the min-nodes
search; ``repro_torch.fleet.simulate`` runs real multi-node fleets, numpy
or batched torch).  This module keeps the historical entry points
importable:

  * :func:`consolidation_sweep` / :func:`min_nodes_meeting_slo` /
    :class:`ClusterResult` re-export the fleet implementations.
  * :func:`simulate_node_share` / :func:`simulate_node_share_torch` remain
    the legacy *single representative node* paths (one node simulated and
    scaled).  Note their known approximation: the share split floors to
    ``max(1, total_fns // n_nodes)``, dropping up to ``n_nodes - 1``
    functions from the cluster total — fleet placements conserve the
    function count instead (``repro_torch.fleet.placement.Assignment``
    asserts it).

Port of ``repro.core.cluster``: ``simulate_node_share`` is copied and
``simulate_node_share_torch`` replaces ``simulate_node_share_jax``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.simkernel import SimConfig, SimResult, simulate
from repro_torch.core.traces import make_workload
from repro_torch.core.policies import make_policy
from repro_torch.fleet.consolidate import (  # noqa: F401  (compat re-exports)
    ClusterResult,
    consolidation_sweep,
    min_nodes_meeting_slo,
)

__all__ = [
    "ClusterResult", "consolidation_sweep", "min_nodes_meeting_slo",
    "simulate_node_share", "simulate_node_share_torch",
]


def simulate_node_share(
    policy_name: str,
    total_fns: int,
    n_nodes: int,
    duration_s: float = 30.0,
    n_cores: int = 12,
    seed: int = 7,
) -> SimResult:
    """Simulate one representative node holding its share of the cluster.

    Legacy approximation (see module docstring): the per-node function
    count floors, so the simulated cluster can under-count by up to
    ``n_nodes - 1`` functions.  Use ``repro_torch.fleet.simulate_fleet``
    for the conserving multi-node path; when ``total_fns`` divides evenly
    the two agree exactly.
    """
    fns_per_node = max(1, total_fns // n_nodes)
    wl = make_workload(
        "azure2021", fns_per_node, duration_s=duration_s, n_cores=n_cores,
        seed=seed, exec_s=0.2,  # cluster-mode PyTorch-class requests (§3.2)
    )
    return simulate(
        wl, make_policy(policy_name),
        SimConfig(n_cores=n_cores, hierarchy_depth=5.0, burst_us=280.0,
                  seed=seed),
    )


def simulate_node_share_torch(
    policy_name: str,
    total_fns: int,
    n_nodes: int,
    duration_s: float = 30.0,
    n_cores: int = 12,
    seed: int = 7,
    threads_per_fn: int = 8,
    device=None,
) -> SimResult:
    """One representative node on the tensor tick simulator.

    Same share split as :func:`simulate_node_share`, but through
    ``repro_torch.core.simkernel_torch`` — any registered policy, on
    ``device`` (``None``: the card).  Returned as a :class:`SimResult` so
    the SLO search is backend-blind (the tensor backend folds switch time
    into ``overhead_s``; discrete switch counts stay numpy-only).
    ``repro_torch.fleet.simulate_fleet`` with ``backend="torch"`` batches
    *all* nodes of a configuration into one tick loop instead of scaling
    this single node.
    """
    from repro_torch.core import simkernel_torch as st
    from repro_torch.sched.torch_backend import CODE_OF

    fns_per_node = max(1, total_fns // n_nodes)
    wl = make_workload(
        "azure2021", fns_per_node, duration_s=duration_s, n_cores=n_cores,
        seed=seed, exec_s=0.2, threads_per_fn=threads_per_fn,
    )
    trace = st.build_slot_trace(wl, fns_per_node, threads_per_fn,
                                device=device)
    p = st.SimParams(
        n_cores=n_cores, n_fns=fns_per_node,
        n_ticks=int(duration_s / st.TICK), policy=CODE_OF[policy_name],
        burst_us=280.0, depth=5.0,
    )
    out = st.simulate(trace, p)
    at = trace.arrival_tick.cpu().numpy()
    dt = out["done_tick"].cpu().numpy()
    lat = st.latencies_from(trace, dt)
    ok = (dt >= 0) & (at < st.BIG)
    fn_of = np.broadcast_to(
        trace.slot_fn.cpu().numpy()[:, None], at.shape
    )[ok]
    return SimResult(
        policy=policy_name,
        latencies=lat,
        fn_of=fn_of,
        arrival_of=at[ok] * st.TICK,
        n_arrived=int((at < st.BIG).sum()),
        n_completed=len(lat),
        switches=0,
        switch_time_s=float(out["overhead_s"]),
        busy_time_s=float(out["busy_s"]),
        duration_s=duration_s,
        n_cores=n_cores,
    )
