"""``repro_torch.fleet`` — placement-aware multi-node cluster simulation.

The orchestrator layer the paper's cluster study (§5.1, Fig 7) implies but
the single-node simulators cannot express: *which functions land on which
node* (placement), *what each node then pays* (per-node tick simulation
through the ``repro_torch.sched`` backends), and *what the fleet looks like
as a whole* (consolidation search, per-node imbalance).

Quick start::

    from repro_torch.fleet import place, simulate_fleet, make_policy

    asg = place("switch-aware", total_fns=800, n_nodes=10,
                policy=make_policy("lags"))
    fleet = simulate_fleet("lags", asg, duration_s=30.0)
    print(fleet.pct(95), fleet.overhead_frac, fleet.imbalance())

    # all nodes in one batched tick loop on the card (device="cpu" for
    # the host):
    fleet_torch = simulate_fleet("lags", asg, backend="torch")

Consolidation (the Fig 7 headline)::

    from repro_torch.fleet import consolidation_sweep, min_nodes_meeting_slo
    res = consolidation_sweep(total_fns=800, node_counts=(14, 12, 10))
    print(min_nodes_meeting_slo(res, "cfs"), min_nodes_meeting_slo(res, "lags"))

Placement strategies (``repro_torch.fleet.placement.PLACEMENTS``):
``round-robin`` (band-striped, the paper's banded placement), ``pack``
(first-fit decreasing by reserved share), ``spread`` (least-loaded),
``rack-spread`` and ``switch-aware`` (least load *plus* the policy's
voluntary-switch overhead estimate).  Every strategy conserves the
function count — each global fn id is assigned to exactly one node.

Port of ``repro.fleet``, trimmed to what is ported: placement, the fleet
simulation and the consolidation study.  The chaos layer (``chaos.py``,
``topology.py``, ``rebalance.py`` and ``distributed/fault.py``, with
``simulate_fleet_chaos``) and the fleet run records (``record_fleet``,
which needs ``obs/recorder.py``) are not ported yet.
"""
from repro_torch.fleet.consolidate import (
    CLUSTER_DURATION_S,
    CLUSTER_EXEC_S,
    ClusterResult,
    cluster_result,
    consolidation_sweep,
    min_nodes_meeting_slo,
    placement_comparison,
)
from repro_torch.fleet.placement import (
    PLACEMENTS,
    Assignment,
    fn_shares,
    place,
    switch_penalty,
)
from repro_torch.fleet.simulate import FleetResult, simulate_fleet
from repro_torch.sched.numpy_backend import make_policy

__all__ = [
    "CLUSTER_DURATION_S", "CLUSTER_EXEC_S",
    "PLACEMENTS", "Assignment", "ClusterResult", "FleetResult",
    "cluster_result", "consolidation_sweep", "fn_shares", "make_policy",
    "min_nodes_meeting_slo", "place", "placement_comparison",
    "simulate_fleet", "switch_penalty",
]
