"""Topology-aware chaos: rack crashes, partitions, proactive drain.

Extends ``fig_failover`` with the correlated/network failure patterns the
ROADMAP lists as the open chaos-coverage gap, on the same consolidated
800-fn/10-node LAGS fleet (Fig 7).  Three stories:

  * **rack crash, proactive vs reactive** — rack 2's two nodes start
    trending degraded (1.8x slowdown, *below* the straggler watchdog's
    ``min_ratio`` so reactive quarantine never fires) before the whole
    rack loses power at t=30s.  The topology-aware config
    (``rack-spread`` placement + proactive drain) notices the trend and
    evacuates both nodes *before* the crash, so nothing is stranded when
    the rack dies: strictly lower ``recovery_s`` and higher
    degraded-window SLO attainment than the reactive config, which can
    only rebalance after detecting the crash.  (Heartbeat delay/loss on
    a later-crashing node would fence it and correctly *veto* the drain
    — a fenced node's functions must not be moved; that interaction is
    pinned by the unit tests, not swept here.)
  * **pure partition** — rack 1's nodes stop heartbeating for 10s but
    keep serving.  The evidence-based tracker holds them at SUSPECT, the
    controller *fences* them (defers their new arrivals, lets in-flight
    work complete) instead of double-placing their functions: zero
    migrations, per-epoch conservation holds throughout, and every
    deferred arrival is replayed after the heal (``lost == 0``).
  * **differential** — an empty schedule with no topology still delegates
    bit-identically to ``simulate_fleet`` (the topology layer costs
    nothing when unused).

Acceptance is encoded in the verdict rows (all must be PASS).

Port of ``benchmarks/fig_chaos_topology.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import emit
from repro_torch.fleet import (
    CLUSTER_EXEC_S,
    FaultEvent,
    FaultSchedule,
    Topology,
    place,
    simulate_fleet,
    simulate_fleet_chaos,
)

TOTAL_FNS = 800
N_NODES = 10  # the consolidated LAGS fleet (Fig 7)
RACK_SIZE = 2  # 5 racks of 2
DURATION_S = 60.0
EPOCH_S = 5.0
CRASH_RACK = 2  # nodes 4, 5
CRASH_T = 30.0
PART_NODES = (2, 3)  # rack 1
PART_T = 20.0
PART_DUR = 10.0


def _rack_story_schedule(topo: Topology) -> FaultSchedule:
    """Rack 2 trends degraded (a moderate slowdown, below the reactive
    watchdog's trigger) and then loses power outright."""
    evs = [FaultEvent(5.0, "node_slow", n, factor=1.8)
           for n in topo.nodes_in(CRASH_RACK)]
    evs.append(FaultEvent(CRASH_T, "rack_crash", rack=CRASH_RACK))
    return FaultSchedule(evs, N_NODES, topo)


def main() -> list:
    rows = []
    topo = Topology.uniform(N_NODES, RACK_SIZE)

    # (c) differential: no topology + empty schedule == simulate_fleet
    asg = place("round-robin", TOTAL_FNS, N_NODES, exec_s=CLUSTER_EXEC_S)
    base = simulate_fleet("lags", asg, duration_s=12.0, exec_s=CLUSTER_EXEC_S)
    chaos0 = simulate_fleet_chaos(
        "lags", asg, FaultSchedule.empty(N_NODES), duration_s=12.0,
        exec_s=CLUSTER_EXEC_S,
    )
    identical = (
        np.array_equal(base.latencies, chaos0.latencies)
        and base.n_arrived == chaos0.n_arrived
        and base.n_completed == chaos0.n_completed
    )
    rows.append((
        "fig_chaos_topology.differential", 0.0,
        f"no_topology_bit_identical={'PASS' if identical else 'FAIL'}",
    ))

    # (a) rack crash: rack-spread + proactive drain vs reactive rebalance
    sched = _rack_story_schedule(topo)
    kw = dict(duration_s=DURATION_S, epoch_s=EPOCH_S, exec_s=CLUSTER_EXEC_S,
              topology=topo)
    asg_topo = place("rack-spread", TOTAL_FNS, N_NODES,
                     exec_s=CLUSTER_EXEC_S, racks=topo.racks())
    asg_flat = place("spread", TOTAL_FNS, N_NODES, exec_s=CLUSTER_EXEC_S)
    t0 = time.time()
    # enter at 1.35x the fleet mean: with *both* rack-2 nodes slowed the
    # non-draining fleet mean is itself inflated by the other slow node,
    # so the default 1.6x ratio would not trip until after the crash
    pro = simulate_fleet_chaos("lags", asg_topo, sched,
                               proactive_drain=True,
                               drain_enter_ratio=1.35,
                               drain_exit_ratio=1.15, **kw)
    rea = simulate_fleet_chaos("lags", asg_flat, sched,
                               proactive_drain=False, **kw)
    us = (time.time() - t0) * 1e6 / 2
    pro_rec, rea_rec = pro.max_recovery_s(), rea.max_recovery_s()
    pro_slo = pro.degraded_slo_attainment()
    rea_slo = rea.degraded_slo_attainment()
    drained = sorted({n for e in pro.epochs for n in e.draining})
    rows.append((
        "fig_chaos_topology.rack.proactive", us,
        f"completed={pro.n_completed};recovery_s={pro_rec};"
        f"slo_degraded={pro_slo * 100:.2f}%;"
        f"drained={drained};"
        f"migrations={len(pro.migrations)};lost={pro.lost_arrivals}",
    ))
    rows.append((
        "fig_chaos_topology.rack.reactive", us,
        f"completed={rea.n_completed};recovery_s={rea_rec};"
        f"slo_degraded={rea_slo * 100:.2f}%;"
        f"migrations={len(rea.migrations)};lost={rea.lost_arrivals}",
    ))
    rack_ok = (
        pro_rec is not None and rea_rec is not None and pro_rec < rea_rec
        and pro_slo > rea_slo
    )
    rows.append((
        "fig_chaos_topology.verdict.rack", 0.0,
        f"proactive_strictly_faster={'PASS' if rack_ok else 'FAIL'};"
        f"recovery_s={pro_rec}vs{rea_rec};"
        f"slo={pro_slo * 100:.2f}%vs{rea_slo * 100:.2f}%",
    ))

    # (b) pure partition: fencing, conservation, reconcile-on-heal
    part = FaultSchedule.single_partition(
        PART_NODES, PART_T, PART_DUR, N_NODES, topo)
    t0 = time.time()
    res = simulate_fleet_chaos("lags", asg_topo, part, **kw)
    us = (time.time() - t0) * 1e6
    conserved = all(sum(e.counts) == TOTAL_FNS for e in res.epochs)
    reconciled = (res.lost_arrivals == 0
                  and res.replayed_arrivals >= res.deferred_arrivals > 0)
    suspects = sorted({n for e in res.epochs for n in e.suspects})
    fenced = sorted({n for e in res.epochs for n in e.fenced})
    rows.append((
        "fig_chaos_topology.partition", us,
        f"completed={res.n_completed};done={res.done_ratio * 100:.2f}%;"
        f"suspects={suspects};"
        f"fenced={fenced};"
        f"deferred={res.deferred_arrivals};"
        f"replayed={res.replayed_arrivals};"
        f"reconciled={res.reconciled_completions};"
        f"migrations={len(res.migrations)};lost={res.lost_arrivals}",
    ))
    rows.append((
        "fig_chaos_topology.verdict.partition", 0.0,
        f"no_double_placement={'PASS' if not res.migrations else 'FAIL'};"
        f"conserved_every_epoch={'PASS' if conserved else 'FAIL'};"
        f"reconciled_on_heal={'PASS' if reconciled else 'FAIL'}",
    ))
    return rows


if __name__ == "__main__":
    emit(main())
