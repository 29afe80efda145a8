"""``repro_torch.fleet`` — placement-aware multi-node cluster simulation.

The orchestrator layer the paper's cluster study (§5.1, Fig 7) implies but
the single-node simulators cannot express: *which functions land on which
node* (placement), *what each node then pays* (per-node tick simulation
through the ``repro_torch.sched`` backends), and *what the fleet looks
like as a whole* (merged observability, consolidation search).

Quick start::

    from repro_torch.fleet import place, simulate_fleet, make_policy

    asg = place("switch-aware", total_fns=800, n_nodes=10,
                policy=make_policy("lags"))
    fleet = simulate_fleet("lags", asg, duration_s=30.0)
    print(fleet.pct(95), fleet.overhead_frac, fleet.imbalance())

    # all nodes in one batched tick loop on the card (device="cpu" for
    # the host):
    fleet_torch = simulate_fleet("lags", asg, backend="torch")

    # per-node run records + merged fleet view:
    simulate_fleet("lags", asg, record_dir="/tmp/fleet")
    #   python -m repro_torch.obs.report --merge /tmp/fleet/node*

Chaos / failover (fault injection + mid-run rebalancing)::

    from repro_torch.fleet import FaultSchedule, simulate_fleet_chaos
    sched = FaultSchedule.single_crash(node=3, t=20.0, n_nodes=10)
    res = simulate_fleet_chaos("lags", asg, sched, duration_s=60.0,
                               epoch_s=5.0)
    print(res.done_ratio, res.recovery_s(), len(res.migrations))

Topology-aware chaos (correlated rack failures, network faults,
proactive drain)::

    from repro_torch.fleet import (Topology, FaultSchedule,
                                   simulate_fleet_chaos)
    topo = Topology.uniform(n_nodes=10, rack_size=5)
    sched = FaultSchedule.single_rack_crash(rack=1, t=20.0, topology=topo)
    res = simulate_fleet_chaos("lags", asg, sched, duration_s=60.0,
                               epoch_s=5.0, strategy="rack-spread",
                               proactive_drain=True)
    print(res.recovery_s(), res.reconciled, res.report())

    # every epoch's fleet in one batched tick loop on the card:
    res = simulate_fleet_chaos("lags", asg, sched, duration_s=60.0,
                               epoch_s=5.0, backend="torch")

Consolidation (the Fig 7 headline)::

    from repro_torch.fleet import consolidation_sweep, min_nodes_meeting_slo
    res = consolidation_sweep(total_fns=800, node_counts=(14, 12, 10))
    print(min_nodes_meeting_slo(res, "cfs"), min_nodes_meeting_slo(res, "lags"))

Placement strategies (``repro_torch.fleet.placement.PLACEMENTS``):
``round-robin`` (band-striped, the paper's banded placement), ``pack``
(first-fit decreasing by reserved share), ``spread`` (least-loaded),
``rack-spread`` (least-loaded, ties toward the least-loaded rack), and
``switch-aware`` (least load *plus* the policy's voluntary-switch overhead
estimate, so dense cgroup stacking is penalised under CFS but tolerated
under run-to-completion LAGS).  Every strategy conserves the function
count — each global fn id is assigned to exactly one node.

Port of ``repro.fleet``, with ``backend="torch"`` where the reference has
``backend="jax"``: the port imports nothing of ``repro``.
"""
from repro_torch.fleet.chaos import (
    FLEET,
    FaultEvent,
    FaultSchedule,
    NodeState,
)
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
from repro_torch.fleet.rebalance import (
    ChaosFleetResult,
    Migration,
    migration_cost_s,
    record_chaos,
    simulate_fleet_chaos,
)
from repro_torch.fleet.simulate import (
    FleetResult,
    record_fleet,
    simulate_fleet,
)
from repro_torch.fleet.topology import Topology
from repro_torch.sched.numpy_backend import make_policy

__all__ = [
    "CLUSTER_DURATION_S", "CLUSTER_EXEC_S", "FLEET",
    "PLACEMENTS", "Assignment", "ChaosFleetResult", "ClusterResult",
    "FaultEvent", "FaultSchedule", "FleetResult", "Migration", "NodeState",
    "cluster_result", "consolidation_sweep", "fn_shares", "make_policy",
    "migration_cost_s", "min_nodes_meeting_slo", "place",
    "placement_comparison", "record_chaos", "record_fleet", "simulate_fleet",
    "simulate_fleet_chaos", "switch_penalty", "Topology",
]
