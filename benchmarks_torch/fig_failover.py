"""Failover: chaos-driven fault injection on the consolidated fleet.

The operational counterpart of the Fig 7 consolidation headline: packing
800 functions onto the 10-node LAGS fleet is only a win if the fleet
*recovers* when a node dies mid-run.  The scenario:

  * a single ``node_crash`` at t=20s of a 60s run (5s controller epochs);
  * with rebalancing, the controller detects the crash via missed
    heartbeats within one epoch, re-places the dead node's 80 functions
    onto the survivors (conservation-checked every epoch) and replays
    their stranded retry backlog on the new homes;
  * the static-placement baseline strands them for the remaining 40s —
    its backlog never drains (``lost_arrivals``).

All three runs (fault-free reference, crash+rebalance, crash+static) go
through the *same* epoched, work-conserving pipeline (unfinished work
carries across epoch boundaries) so boundary effects cancel out of the
comparison.  Acceptance (the repo's burst-recovery
SLO, ``tail_factor=1.4`` as in ``repro_torch.fleet.consolidate``):

  * the rebalanced LAGS run recovers >= 99 % of the fault-free
    completions and keeps p95 within 1.4x the fault-free p95;
  * the static baseline breaches (loses ~40/60 * 1/10 ~ 6.7 % of
    completions);
  * an empty schedule is bit-identical to ``simulate_fleet`` (the
    chaos layer costs nothing when unused).

Also swept: CFS vs LAGS migration pricing (a migration pays the policy's
own voluntary-switch cost at the destination density — CFS migrations
into dense survivors are costlier) and a random multi-fault schedule.

Port of ``benchmarks/fig_failover.py``: the same rows, on the
port's copies of the host code (``repro_torch``).
"""
from __future__ import annotations

import time

import numpy as np

from benchmarks_torch.common import emit
from repro_torch.fleet import (
    CLUSTER_EXEC_S,
    FaultSchedule,
    make_policy,
    migration_cost_s,
    place,
    simulate_fleet,
    simulate_fleet_chaos,
)

TOTAL_FNS = 800
N_NODES = 10  # the consolidated LAGS fleet (Fig 7)
DURATION_S = 60.0
EPOCH_S = 5.0
CRASH_T = 20.0
CRASH_NODE = 3
SLO_TAIL_FACTOR = 1.4  # burst-recovery SLO (consolidate.min_nodes_meeting_slo)
RECOVER_FRAC = 0.99


def _chaos(policy: str, asg, schedule, rebalance: bool):
    return simulate_fleet_chaos(
        policy, asg, schedule, duration_s=DURATION_S, epoch_s=EPOCH_S,
        exec_s=CLUSTER_EXEC_S, rebalance=rebalance,
    )


def main() -> list:
    rows = []

    # differential: empty schedule + no epoching == simulate_fleet, bit-exact
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
        "fig_failover.differential", 0.0,
        f"empty_schedule_bit_identical={'PASS' if identical else 'FAIL'}",
    ))

    # crash scenario on the consolidated fleet under ``spread`` — the
    # load-balanced placement the rebalancer itself uses, so pre- and
    # post-failover placement quality match
    asg_c = place("spread", TOTAL_FNS, N_NODES, exec_s=CLUSTER_EXEC_S)
    crash = FaultSchedule.single_crash(CRASH_NODE, CRASH_T, N_NODES)
    for policy in ("lags", "cfs"):
        t0 = time.time()
        ref = _chaos(policy, asg_c, FaultSchedule.empty(N_NODES), True)
        reb = _chaos(policy, asg_c, crash, True)
        stat = _chaos(policy, asg_c, crash, False)
        us = (time.time() - t0) * 1e6 / 3

        p95_slo = SLO_TAIL_FACTOR * ref.pct(95)
        rows.append((
            f"fig_failover.ref.{policy}", us,
            f"completed={ref.n_completed};p95={ref.pct(95):.3f};"
            f"done={ref.done_ratio * 100:.1f}%",
        ))
        rec = reb.recovery_s().get(CRASH_NODE)
        rows.append((
            f"fig_failover.crash.rebalance.{policy}", us,
            f"completed={reb.n_completed};p95={reb.pct(95):.3f};"
            f"recovered={reb.n_completed / ref.n_completed * 100:.2f}%;"
            f"recovery_s={rec if rec is not None else 'never'};"
            f"migrations={len(reb.migrations)};"
            f"migration_s={reb.migration_s:.4f};"
            f"stranded={reb.stranded_arrivals};"
            f"replayed={reb.replayed_arrivals};"
            f"lost={reb.lost_arrivals};"
            f"slo_degraded={reb.degraded_slo_attainment() * 100:.1f}%",
        ))
        srec = stat.recovery_s().get(CRASH_NODE)
        rows.append((
            f"fig_failover.crash.static.{policy}", us,
            f"completed={stat.n_completed};p95={stat.pct(95):.3f};"
            f"recovered={stat.n_completed / ref.n_completed * 100:.2f}%;"
            f"recovery_s={srec if srec is not None else 'never'};"
            f"stranded={stat.stranded_arrivals};"
            f"lost={stat.lost_arrivals};"
            f"slo_degraded={stat.degraded_slo_attainment() * 100:.1f}%",
        ))
        # the SLO verdict is about the consolidated LAGS fleet (Fig 7);
        # the CFS sweep is the comparison point — its rebalanced run lands
        # just under the bar because migrations and context switches both
        # price higher at the post-failover density of ~89 cgroups/node,
        # the same per-switch asymmetry the paper measures
        if policy == "lags":
            reb_ok = (
                reb.n_completed >= RECOVER_FRAC * ref.n_completed
                and reb.pct(95) <= p95_slo
            )
            stat_breach = stat.n_completed < RECOVER_FRAC * ref.n_completed
            rows.append((
                f"fig_failover.verdict.{policy}", 0.0,
                f"rebalance_meets_slo={'PASS' if reb_ok else 'FAIL'};"
                f"static_breaches={'PASS' if stat_breach else 'FAIL'};"
                f"p95_slo={p95_slo:.3f}",
            ))

    # migration pricing asymmetry: the policy's own switch-cost model at
    # the destination density (88 colocated cgroups post-failover)
    dens = TOTAL_FNS // N_NODES + TOTAL_FNS // N_NODES // (N_NODES - 1)
    c_cfs = migration_cost_s(make_policy("cfs"), dens)
    c_lags = migration_cost_s(make_policy("lags"), dens)
    ratio = ("inf" if c_lags < 1e-9
             else f"{c_cfs / c_lags:.1f}x")  # LAGS run-to-completion: ~free
    rows.append((
        "fig_failover.migration_cost", 0.0,
        f"dest_groups={dens};cfs_s={c_cfs:.5f};lags_s={c_lags:.5f};"
        f"ratio={ratio}",
    ))

    # robustness: a random multi-fault schedule (crashes + slowdowns +
    # storm) still conserves functions and keeps serving
    t0 = time.time()
    rnd = FaultSchedule.random(seed=11, n_nodes=N_NODES,
                               duration_s=DURATION_S, n_events=5)
    res = _chaos("lags", asg_c, rnd, True)
    us = (time.time() - t0) * 1e6
    rows.append((
        "fig_failover.random.lags", us,
        f"events={len(rnd)};migrations={len(res.migrations)};"
        f"done={res.done_ratio * 100:.1f}%;"
        f"completed={res.n_completed};lost={res.lost_arrivals}",
    ))
    return rows


if __name__ == "__main__":
    emit(main())
