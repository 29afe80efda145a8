"""Epoch-driven failover controller: detect, re-place, charge, recover.

The missing operational half of the consolidation headline (Fig 7): a
densely packed 10-node LAGS fleet carries 40 % more functions per node
than the 14-node CFS baseline, so a crashed or degraded node strands more
work — recovery behaviour is part of the claim.  This module splits a
fleet run into controller epochs and closes the loop each epoch:

  1. **inject** — apply the :class:`~repro_torch.fleet.chaos.FaultSchedule`
     events that fall in the epoch (crash / slow / storm / recover);
  2. **observe** — simulate the epoch over the live nodes
     (:func:`repro_torch.fleet.simulate.simulate_fleet` with per-node
     slowdown multipliers and a dead mask) and feed the per-epoch
     schedstats into the detection stack: heartbeats into
     :class:`repro_torch.distributed.fault.HealthTracker`, per-request
     service time into
     :class:`repro_torch.distributed.fault.StragglerWatchdog`;
  3. **re-place** — migrate the detected victims' functions onto the
     survivors through the existing placement registry (``spread`` /
     ``switch-aware`` / ... warm-started with the survivors' current
     load), producing a new conservation-checked
     :class:`~repro_torch.fleet.placement.Assignment` — every live function
     on exactly one live node, every epoch;
  4. **charge** — failover is never free: each migrated function pays a
     migration cost priced through the policy's own
     ``Policy.voluntary_switch`` cost model at the *destination* density
     (C-Balancer-style migration, priced à la constraint-based repacking
     — see PAPERS.md), folded into the merged schedstats as switch
     overhead.

Functions assigned to a dead node are *stranded*: their would-be arrivals
accumulate in a retry backlog (clients re-issue failed invocations).  The
first epoch in which a stranded function is live again — re-placed onto a
survivor, or its node recovered — replays its backlog on top of the
nominal offered load, injected as **exact-count** arrivals spread over
the epoch (``make_workload(extra=...)``): a backlog is known pending
requests, and routing it through the bursty MMPP rate process instead
would replay a random multiple of its mass.  Under ``rebalance=False`` (the static-placement
baseline ``benchmarks/fig_failover.py`` compares against) a crashed
node's backlog is never drained and is reported as ``lost_arrivals``.

Epoch boundaries are **work-conserving** (``carry_unfinished``): arrivals
a live node admitted but did not complete inside its epoch are re-offered
in the next epoch, to whichever node their function then lives on.  The
un-epoched simulator drains its queues over the whole horizon; censoring
queued work at every boundary instead would systematically penalise
exactly the runs that queue more — the post-failover survivors carrying a
dead node's functions — and bias any recovery comparison against them.
Progress is conserved alongside the arrivals: the partial service a
node performed on still-in-flight requests (busy seconds beyond the cost
of its completed requests, in request-equivalents) is credited against
the carried counts, so boundary-spanning requests complete from
conserved progress instead of restarting from zero.  Without the credit
every boundary levies a restart tax proportional to in-flight inventory
— positive feedback that drives precisely the loaded survivors into
runaway backlog the continuous simulator would never show.

A run with an **empty schedule and no epoch override is bit-identical to
:func:`simulate_fleet`** (it delegates — the differential test in
``tests/test_chaos.py`` pins this), so the chaos layer costs nothing when
unused.

**Topology-aware failure handling.** With a
:class:`~repro_torch.fleet.topology.Topology` the schedule can crash whole
racks and inject *network* faults — partitions, delayed and lossy
heartbeats — that today's crash detector would misread as node death. The
controller therefore models the heartbeat network explicitly (an in-flight
queue with per-node delay and seeded loss; a delivered heartbeat is
evidence of the node at its *send* time, not its arrival time) and feeds a
second evidence channel, ``HealthTracker.observe_progress``, from
completions it can see in the epoch results. Detection becomes a ladder: a
node whose heartbeats are overdue but whose work keeps landing is
**SUSPECT** and gets *fenced* — its nominal arrivals are deferred into the
retry backlog (replayed on heal: reconciliation), it serves only its
in-flight carryover, and it is excluded as a migration destination — while
only heartbeat-silent, progress-stale nodes are CONFIRMED-DEAD and failed
over. Fencing never re-places, so the conservation invariant (every fn on
exactly one node) holds even when the controller's liveness view is wrong.
With ``proactive_drain=True`` a
:class:`~repro_torch.distributed.fault.TrendDetector` watches each node's
per-request service time against the healthy-fleet mean and migrates load
off nodes *trending* degraded before the watchdog would quarantine them —
hysteresis (enter/exit ratio band + persistence) guarantees the drain
decision never flaps. When a victim is failed over under a topology,
destinations avoid the failing rack(s) when any other rack has capacity,
and the ``rack-spread`` strategy keeps the re-placed share balanced across
the surviving domains.

Copy of ``repro.fleet.rebalance``, with one change: ``device`` is handed to
:func:`simulate_fleet`, so ``backend="torch"`` runs every epoch's fleet in
one batched tick loop on the card (``device=None``) or, when the caller
asks for it, the CPU.  The port imports nothing of ``repro``.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.switch_cost import switch_cost_us
from repro_torch.core.traces import make_workload
from repro_torch.distributed.fault import (
    HealthTracker,
    StragglerWatchdog,
    TrendDetector,
)
from repro_torch.fleet.chaos import FLEET, FaultSchedule, NodeState
from repro_torch.fleet.placement import (
    PLACEMENTS,
    Assignment,
    _DensityProbe,
)
from repro_torch.fleet.simulate import FleetResult, simulate_fleet
from repro_torch.fleet.topology import Topology
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.schedstats import SchedStats
from repro_torch.sched.numpy_backend import Policy, make_policy

#: one migration ~ this many cross-cgroup handoffs at the destination
#: density (cgroup freeze + state transfer + cache warmup dwarf a single
#: context switch)
MIGRATION_COLD_MULT = 400.0

_EPOCH_SEED_STRIDE = 104729  # decorrelates per-epoch band workloads

#: heartbeat sends per control epoch — cadence finer than the control
#: interval so a sub-epoch delivery delay shifts staleness by the actual
#: delay rather than quantizing it up to a full epoch (which would trip
#: the suspect timeout for arbitrarily small delays)
HB_PER_EPOCH = 3


def migration_cost_s(
    policy: Policy,
    n_groups_dest: int,
    n_cores: int = 12,
    depth: float = 5.0,
    cold_mult: float = MIGRATION_COLD_MULT,
) -> float:
    """Seconds charged for migrating one function cgroup onto a node that
    will host ``n_groups_dest`` colocated cgroups.

    Priced through the same ``Policy.voluntary_switch`` model placement
    uses (:func:`repro_torch.fleet.placement.switch_penalty`): CFS pays its
    log-growing cross-cgroup cost at the destination density, LAGS's
    run-to-completion handoffs keep migrations comparatively cheap — the
    same asymmetry the paper measures per switch, scaled by a cold-move
    multiplier.
    """
    if n_groups_dest <= 0:
        return 0.0
    st = _DensityProbe(n_groups_dest)
    sibs = np.ones(n_groups_dest)
    c_same = switch_cost_us(
        True, siblings=sibs, groups=n_groups_dest, depth=depth)
    c_cross = switch_cost_us(
        False, siblings=sibs, groups=n_groups_dest, depth=depth)
    p_preempt = min(1.0, max(n_groups_dest - n_cores, 0) / (2.0 * n_cores))
    cost_us, spb = policy.voluntary_switch(
        st, st.th_fn, sibs, c_same, c_cross, c_cross, p_preempt
    )
    return float(np.mean(cost_us)) * 1e-6 * spb * cold_mult


@dataclass(frozen=True)
class Migration:
    """One function moved off a victim node during failover."""

    epoch: int
    fn: int  # global fn id
    src: int
    dst: int
    cost_s: float


@dataclass
class EpochRecord:
    """One controller epoch: what ran, what was lost, what moved."""

    epoch: int
    t0: float
    t1: float
    fleet: FleetResult
    counts: List[int]  # per-node fn counts *during* this epoch
    alive: List[bool]  # ground-truth liveness during this epoch
    detected_dead: List[int] = field(default_factory=list)
    stragglers: List[int] = field(default_factory=list)
    lost_arrivals: int = 0  # newly stranded this epoch
    replayed: int = 0  # backlog drained into this epoch's offered load
    carried: int = 0  # prior epochs' unfinished work re-offered here
    credited: int = 0  # in-flight work completed from conserved progress
    migrations: int = 0
    migration_s: float = 0.0
    degraded: bool = False
    # topology-aware liveness ladder (all empty on plain crash runs)
    suspects: List[int] = field(default_factory=list)  # detected at t1
    fenced: List[int] = field(default_factory=list)  # fenced *during* epoch
    draining: List[int] = field(default_factory=list)  # trend-drained nodes
    deferred: int = 0  # arrivals deferred off fenced nodes (in lost_arrivals)
    reconciled: int = 0  # completions that landed on fenced nodes


class ChaosFleetResult:
    """A fleet run under fault injection: per-epoch results + failover
    accounting.  Mirrors the :class:`FleetResult` query surface
    (``latencies`` / ``pct`` / ``n_arrived`` / ``n_completed``) so SLO
    checks run unchanged on faulted runs."""

    def __init__(self, policy: str, placement: str,
                 schedule: FaultSchedule, epochs: List[EpochRecord],
                 migrations: List[Migration], duration_s: float,
                 epoch_s: float, n_cores: int, n_nodes: int,
                 rebalanced: bool, slo_s: float = 1.0,
                 proactive: bool = False):
        self.policy = policy
        self.placement = placement
        self.schedule = schedule
        self.epochs = epochs
        self.migrations = migrations
        self.duration_s = duration_s
        self.epoch_s = epoch_s
        self.n_cores = n_cores
        self.n_nodes = n_nodes
        self.rebalanced = rebalanced
        self.slo_s = slo_s
        self.proactive = proactive

    # -- FleetResult-compatible queries ------------------------------------
    @property
    def latencies(self) -> np.ndarray:
        xs = [e.fleet.latencies for e in self.epochs
              if len(e.fleet.latencies)]
        return np.concatenate(xs) if xs else np.empty(0)

    @property
    def n_completed(self) -> int:
        """In-epoch completions plus boundary-spanning ones: requests whose
        partial service at an epoch boundary was credited as conserved
        progress completed too — they just have no latency sample."""
        return sum(e.fleet.n_completed + e.credited for e in self.epochs)

    @property
    def stranded_arrivals(self) -> int:
        """Arrivals that hit a dead node and went into the retry backlog."""
        return sum(e.lost_arrivals for e in self.epochs)

    @property
    def replayed_arrivals(self) -> int:
        """Backlog drained back into live epochs after failover/recovery."""
        return sum(e.replayed for e in self.epochs)

    @property
    def lost_arrivals(self) -> int:
        """Stranded arrivals never replayed — demand lost for good (a
        static placement never drains a crashed node's backlog)."""
        return self.stranded_arrivals - self.replayed_arrivals

    @property
    def carried_arrivals(self) -> int:
        """Unfinished work re-offered across epoch boundaries (each
        carried arrival is re-counted by the epoch it re-enters)."""
        return sum(e.carried for e in self.epochs)

    @property
    def credited_arrivals(self) -> int:
        """Boundary-spanning requests completed from conserved partial
        progress rather than re-served from scratch."""
        return sum(e.credited for e in self.epochs)

    @property
    def deferred_arrivals(self) -> int:
        """Arrivals deferred off fenced (SUSPECT) nodes into the backlog
        — a subset of ``stranded_arrivals``; replayed on heal."""
        return sum(e.deferred for e in self.epochs)

    @property
    def reconciled_completions(self) -> int:
        """Completions that landed on fenced nodes — work the controller
        could not route to but still observed and credits (reconciliation
        of a partitioned-but-alive node's progress)."""
        return sum(e.reconciled for e in self.epochs)

    @property
    def n_arrived(self) -> int:
        """Served arrivals plus the backlog still stranded at run end —
        an unrecovered outage is demand the fleet failed to see.  Carried
        re-offers are netted out so a request that spans epoch boundaries
        counts as one arrival."""
        return sum(e.fleet.n_arrived for e in self.epochs) \
            + self.lost_arrivals - self.carried_arrivals

    @property
    def done_ratio(self) -> float:
        return self.n_completed / max(self.n_arrived, 1)

    def pct(self, q: float) -> float:
        lat = self.latencies
        return float(np.percentile(lat, q)) if len(lat) else float("nan")

    @property
    def migration_s(self) -> float:
        return sum(m.cost_s for m in self.migrations)

    def cumulative_completions(self) -> List[int]:
        out, tot = [], 0
        for e in self.epochs:
            tot += e.fleet.n_completed + e.credited
            out.append(tot)
        return out

    def per_epoch_counts(self) -> List[List[int]]:
        return [list(e.counts) for e in self.epochs]

    def per_epoch_liveness(self) -> List[Dict[str, int]]:
        """Controller-view liveness ladder per epoch: ground-truth live
        nodes, and how many the controller held as suspect / fenced /
        draining — the trajectory the topology fingerprint pins."""
        return [
            {
                "live": int(sum(e.alive)),
                "suspect": len(e.suspects),
                "fenced": len(e.fenced),
                "draining": len(e.draining),
            }
            for e in self.epochs
        ]

    # -- failover metrics --------------------------------------------------
    def _crashed_nodes(self) -> List[Tuple[int, float]]:
        """(node, crash time) for every node a ``node_crash`` or expanded
        ``rack_crash`` event takes down."""
        out: List[Tuple[int, float]] = []
        topo = self.schedule.topology
        for ev in self.schedule.events:
            if ev.kind == "node_crash":
                out.append((ev.node, ev.t))
            elif ev.kind == "rack_crash" and topo is not None:
                out.extend((n, ev.t) for n in topo.nodes_in(ev.rack))
        return out

    def recovery_s(self) -> Dict[int, Optional[float]]:
        """Per crashed node (including nodes taken down by a rack-scoped
        crash): seconds from the crash event until every function it held
        was being served on a live node again (``None`` = never recovered
        within the run)."""
        out: Dict[int, Optional[float]] = {}
        for node, ct in self._crashed_nodes():
            out[node] = None
            for e in self.epochs:
                if e.t1 <= ct:
                    continue
                # recovered in the first epoch where node holds no
                # functions while dead (all re-placed), or is alive again
                held = e.counts[node]
                if (held == 0 and not e.alive[node]) or e.alive[node]:
                    out[node] = max(e.t0 - ct, 0.0)
                    break
        return out

    def max_recovery_s(self) -> Optional[float]:
        """Worst-case per-node recovery, ``None`` when any crashed node
        never recovered (or no node crashed at all)."""
        rec = self.recovery_s()
        if not rec or any(v is None for v in rec.values()):
            return None
        return max(rec.values())

    def degraded_slo_attainment(self, slo_s: Optional[float] = None) -> float:
        """Inside degraded windows (epochs with an active fault or
        stranded work): completions within the SLO / total demand
        (served + stranded arrivals).  NaN when no epoch was degraded."""
        slo = self.slo_s if slo_s is None else slo_s
        ok = arrived = 0
        for e in self.epochs:
            if not e.degraded:
                continue
            lat = e.fleet.latencies
            ok += int(np.sum(lat <= slo)) if len(lat) else 0
            arrived += e.fleet.n_arrived + e.lost_arrivals - e.carried
        return ok / arrived if arrived else float("nan")

    def merged_sched(self) -> SchedStats:
        """Fleet-wide schedstats across all epochs, with every migration
        charged as switch overhead against the moved function."""
        out = SchedStats(f"chaos.{self.policy}.{self.placement}")
        for e in self.epochs:
            out.merge(e.fleet.merged_sched())
        for m in self.migrations:
            out.account_switch(m.fn, m.cost_s)
        return out

    def report(self) -> dict:
        """The failover summary ``repro_torch.obs.report`` renders as its
        ``failover:`` section."""
        rec = self.recovery_s()
        return {
            "events": [ev.to_dict() for ev in self.schedule.events],
            "epochs": len(self.epochs),
            "epoch_s": self.epoch_s,
            "rebalanced": self.rebalanced,
            "crashes": sum(1 for ev in self.schedule.events
                           if ev.kind == "node_crash"),
            "rack_crashes": sum(1 for ev in self.schedule.events
                                if ev.kind == "rack_crash"),
            "partitions": sum(1 for ev in self.schedule.events
                              if ev.kind == "partition"),
            "migrations": len(self.migrations),
            "migration_s": round(self.migration_s, 6),
            "stranded_arrivals": self.stranded_arrivals,
            "replayed_arrivals": self.replayed_arrivals,
            "carried_arrivals": self.carried_arrivals,
            "credited_arrivals": self.credited_arrivals,
            "lost_arrivals": self.lost_arrivals,
            "deferred_arrivals": self.deferred_arrivals,
            "reconciled": self.reconciled_completions,
            "completed": self.n_completed,
            "arrived": self.n_arrived,
            "done_ratio": round(self.done_ratio, 6),
            "recovery_s": {str(k): v for k, v in rec.items()},
            "degraded_slo_attainment": self.degraded_slo_attainment(),
            "stragglers_drained": sorted(
                {s for e in self.epochs for s in e.stragglers}),
            "suspect_nodes": sorted(
                {s for e in self.epochs for s in e.suspects}),
            "fenced_nodes": sorted(
                {s for e in self.epochs for s in e.fenced}),
            "drained_nodes": sorted(
                {s for e in self.epochs for s in e.draining}),
            "proactive_drain": self.proactive,
            "per_epoch_counts": self.per_epoch_counts(),
            "per_epoch_liveness": self.per_epoch_liveness(),
        }


def _node_service_time(r) -> Optional[float]:
    """Observable the watchdog consumes: mean per-request CPU seconds
    (busy / completed) — tracks a node's slowdown factor but, unlike
    latency, is insensitive to queueing, so a node that merely *inherited*
    migrated load is not misflagged as degraded."""
    if r.n_completed <= 0:
        return None
    return r.busy_time_s / r.n_completed


def _count_arrivals(rates: np.ndarray, fn_ids: np.ndarray,
                    duration_s: float, n_cores: int,
                    seed: int, exec_s: float,
                    cache: Dict[Tuple, np.ndarray],
                    extra: Optional[np.ndarray] = None) -> np.ndarray:
    """Per-function arrivals the given functions would have offered (the
    demand stranded on a dead node) — same rate-based, per-function-seeded
    synthesiser the live nodes use, so the stranded counts equal exactly
    what a fault-free run would have served for those functions."""
    fn_ids = np.asarray(fn_ids, np.int64)
    key = (hash(np.asarray(rates).tobytes()), hash(fn_ids.tobytes()),
           round(duration_s, 9), seed,
           None if extra is None
           else hash(np.asarray(extra, np.int64).tobytes()))
    if key not in cache:
        wl = make_workload(
            "azure2021", len(rates), duration_s=duration_s,
            n_cores=n_cores, seed=seed, exec_s=exec_s, rates=rates,
            fn_ids=fn_ids, extra=extra,
        )
        cache[key] = np.asarray([len(a) for a in wl.arrivals], np.int64)
    return cache[key]


def _replace_victims(
    asg: Assignment,
    victims: List[int],
    dests: List[int],
    strategy: str,
    policy: Policy,
    n_cores: int,
    epoch: int,
    depth: float = 5.0,
    cold_mult: float = MIGRATION_COLD_MULT,
    racks: Optional[np.ndarray] = None,
) -> Tuple[Assignment, List[Migration]]:
    """Re-place every function held by ``victims`` onto ``dests`` via the
    placement registry, warm-started with the survivors' current load.
    ``racks`` (per-node, global index space) gives rack-aware strategies
    their failure domains, remapped onto the destination list."""
    victim_fns = np.concatenate(
        [np.asarray(asg.node_fns[v], np.int64) for v in victims])
    src_of = {int(f): v for v in victims for f in asg.node_fns[v]}
    strat = PLACEMENTS[strategy]
    init_load = np.asarray(
        [float(asg.shares[asg.node_fns[d]].sum()) for d in dests])
    init_groups = np.asarray([len(asg.node_fns[d]) for d in dests], np.int64)
    local = strat(
        asg.shares[victim_fns], len(dests), policy=policy, n_cores=n_cores,
        init_load=init_load, init_groups=init_groups,
        racks=None if racks is None else np.asarray(racks, np.int64)[dests],
    )
    node_fns = [np.asarray(f, np.int64) for f in asg.node_fns]
    for v in victims:
        node_fns[v] = np.empty(0, np.int64)
    migrations: List[Migration] = []
    for j, d in enumerate(dests):
        moved = victim_fns[np.asarray(local[j], np.int64)]
        if not len(moved):
            continue
        node_fns[d] = np.sort(np.concatenate([node_fns[d], moved]))
        cost = migration_cost_s(
            policy, len(node_fns[d]), n_cores, depth, cold_mult)
        for f in moved:
            migrations.append(
                Migration(epoch, int(f), src_of[int(f)], d, cost))
    new_asg = Assignment(
        placement=asg.placement, node_fns=tuple(node_fns), shares=asg.shares
    )  # __post_init__ re-checks conservation: every fn on exactly one node
    return new_asg, migrations


def simulate_fleet_chaos(
    policy_name: str,
    assignment: Assignment,
    schedule: FaultSchedule,
    duration_s: float = 30.0,
    epoch_s: Optional[float] = None,
    n_cores: int = 12,
    seed: int = 7,
    exec_s: float = 0.2,
    backend: str = "numpy",
    distinct_seeds: bool = False,
    threads_per_fn: int = 0,
    rebalance: bool = True,
    rebalance_placement: Optional[str] = None,
    health_timeout_s: Optional[float] = None,
    watchdog_warmup: int = 2,
    watchdog_k_sigma: float = 3.0,
    migration_cold_mult: float = MIGRATION_COLD_MULT,
    slo_s: float = 1.0,
    carry_unfinished: bool = True,
    record_dir: Optional[str] = None,
    topology: Optional[Topology] = None,
    proactive_drain: bool = False,
    drain_enter_ratio: float = 1.6,
    drain_exit_ratio: float = 1.2,
    drain_persist: int = 2,
    device=None,
) -> ChaosFleetResult:
    """Run a placed fleet under a fault schedule; see the module docstring.

    With an empty ``schedule`` and no ``epoch_s`` override this delegates
    straight to :func:`simulate_fleet` — bit-identical results, one epoch.
    Otherwise the run is split into ``epoch_s`` controller epochs (default
    ``duration_s / 12``); events snap to the start of the epoch they fall
    in.  ``rebalance=False`` keeps the detection stack running but never
    re-places — the static-placement baseline.  Arrivals stranded on dead
    nodes accumulate in a retry backlog and are replayed in the first
    epoch their function is live again; with a static placement a crashed
    node's backlog is never drained (reported as ``lost_arrivals``).

    ``carry_unfinished`` keeps epoch boundaries work-conserving: a live
    node's admitted-but-uncompleted arrivals re-enter the next epoch's
    offered load (see the module docstring).  Disable it to get
    memoryless epochs, e.g. to observe one epoch's nominal demand in
    isolation.

    ``topology`` (defaults to ``schedule.topology``) enables rack-scoped
    events and rack-avoiding failover; ``proactive_drain`` turns on the
    :class:`TrendDetector` drain loop with hysteresis knobs
    ``drain_enter_ratio`` / ``drain_exit_ratio`` / ``drain_persist`` (see
    the module docstring for the suspect/fenced/drain semantics).

    ``device`` is where ``backend="torch"`` runs (``None``: the card).
    """
    if schedule.n_nodes != assignment.n_nodes:
        raise ValueError(
            f"schedule is for {schedule.n_nodes} nodes, assignment has "
            f"{assignment.n_nodes}")
    n_nodes = assignment.n_nodes
    if topology is None:
        topology = schedule.topology
    if topology is not None and topology.n_nodes != n_nodes:
        raise ValueError(
            f"topology covers {topology.n_nodes} nodes, assignment has "
            f"{n_nodes}")

    if not schedule and epoch_s is None:
        fleet = simulate_fleet(
            policy_name, assignment, duration_s=duration_s, n_cores=n_cores,
            seed=seed, exec_s=exec_s, backend=backend,
            distinct_seeds=distinct_seeds, threads_per_fn=threads_per_fn,
            device=device,
        )
        res = ChaosFleetResult(
            policy_name, assignment.placement, schedule,
            [EpochRecord(0, 0.0, duration_s, fleet,
                         assignment.counts.tolist(), [True] * n_nodes)],
            [], duration_s, duration_s, n_cores, n_nodes,
            rebalanced=rebalance, slo_s=slo_s,
        )
        if record_dir:
            record_chaos(res, record_dir)
        return res

    epoch_s = epoch_s or duration_s / 12.0
    policy = make_policy(policy_name)
    # each function's actual request rate, recovered from the assignment's
    # reserved shares (shares = rates * exec_s / n_cores): epoch workloads
    # are generated from the functions *assigned* to each node, so a
    # migration moves real demand mass — the count-based band model would
    # regenerate survivors' workloads without the moved functions' rates
    global_rates = assignment.shares * n_cores / exec_s
    reb_name = rebalance_placement or (
        assignment.placement if assignment.placement in PLACEMENTS
        else "spread")
    tracker = HealthTracker(
        n_nodes,
        timeout_s=(health_timeout_s if health_timeout_s is not None
                   else 0.9 * epoch_s),
    )
    for i in range(n_nodes):
        tracker.register(i, now=0.0)
    watchdog = StragglerWatchdog(
        n_nodes, warmup=watchdog_warmup, k_sigma=watchdog_k_sigma)
    trend = TrendDetector(
        n_nodes, enter_ratio=drain_enter_ratio, exit_ratio=drain_exit_ratio,
        persist=drain_persist)
    state = NodeState(n_nodes)
    quarantined: set = set()  # drained stragglers stay out of rotation
    fenced: set = set()  # SUSPECT nodes: alive by evidence, unreachable
    asg = assignment
    epochs: List[EpochRecord] = []
    migrations: List[Migration] = []
    arr_cache: Dict[Tuple, np.ndarray] = {}
    tracing = obs_tracing.active()
    # per-function retry backlog: arrivals stranded on dead nodes, replayed
    # in the first epoch the function is live again (re-placed or recovered)
    backlog = np.zeros(len(assignment.shares), np.int64)
    # per-function carryover: admitted-but-unfinished arrivals from the
    # previous epoch, re-offered wherever the function lives next
    carry = np.zeros(len(assignment.shares), np.int64)
    # the heartbeat network: in-flight heartbeats as (arrive_t, node,
    # sent_t) — a delivered heartbeat proves the node was alive at *send*
    # time, so ``hb_delay`` makes a live node's evidence stale (SUSPECT)
    # without faking freshness.  The loss RNG is only ever drawn for nodes
    # under an active ``heartbeat_loss`` event, so fault-free and
    # crash-only runs consume no randomness (bit-compat with the pinned
    # failover fingerprint).
    hb_pending: List[Tuple[float, int, float]] = []
    hb_rng = np.random.default_rng(np.random.SeedSequence([seed, 0x4Bb]))

    t0 = 0.0
    epoch = 0
    while t0 < duration_s - 1e-9:
        eps = min(epoch_s, duration_s - t0)
        t1 = t0 + eps
        seed_e = seed + _EPOCH_SEED_STRIDE * epoch

        # 1. inject: events in [t0, t1) fire at epoch start
        for ev in schedule.events_in(t0, t1):
            state.apply(ev, topology)
            obs_metrics.counter(f"chaos.{ev.kind}").inc()
            if tracing:
                obs_tracing.tracer().emit(
                    f"fault.{ev.kind}", "chaos", t0 * 1e6, 0.0,
                    {"node": ev.node, "factor": ev.factor,
                     "scheduled_t": ev.t}, ph="i",
                )

        # 2. observe: simulate the epoch over the live nodes.  Offered
        # load follows the assigned functions' rates (storms scale the
        # arrival rate fleet-wide); node slowdowns scale service time.
        # A live node also drains its functions' retry backlog and epoch
        # carryover — *known pending requests*, injected as exact-count
        # arrivals spread over the epoch (feeding them back through the
        # bursty rate process would replay a random multiple of the
        # backlog instead of the backlog itself).
        node_rates = []
        node_extra = []
        replayed_e = 0
        carried_e = 0
        deferred_e = 0
        fenced_e = sorted(fenced)  # the fence applied to *this* epoch
        for i in range(n_nodes):
            fns = asg.node_fns[i]
            base = global_rates[fns] * float(state.storm)
            ext = None
            if state.alive[i] and i in fenced and len(fns):
                # fenced (SUSPECT): no new arrivals are routed — the
                # nominal demand is deferred into the retry backlog and
                # replayed when the node heals (or its functions fail
                # over), while the in-flight carryover it already
                # admitted still completes on the node.  Its parked
                # backlog stays parked: replaying it into an unreachable
                # node would lose the replay.
                counts = _count_arrivals(
                    base, fns, eps, n_cores, seed_e, exec_s, arr_cache)
                backlog[fns] += counts
                deferred_e += int(counts.sum())
                cr = carry[fns]
                if cr.any():
                    carried_e += int(cr.sum())
                    ext = cr
                    carry[fns] = 0
                base = np.zeros_like(base)
            elif state.alive[i] and len(fns):
                bl = backlog[fns]
                cr = carry[fns]
                if bl.any() or cr.any():
                    replayed_e += int(bl.sum())
                    carried_e += int(cr.sum())
                    ext = bl + cr
                    backlog[fns] = 0
                    carry[fns] = 0
            node_rates.append(base)
            node_extra.append(ext)
        if replayed_e:
            obs_metrics.counter("chaos.replayed_arrivals").inc(replayed_e)
        if carried_e:
            obs_metrics.counter("chaos.carried_arrivals").inc(carried_e)
        if deferred_e:
            obs_metrics.counter("chaos.deferred_arrivals").inc(deferred_e)
        fleet_e = simulate_fleet(
            policy_name, asg, duration_s=eps, n_cores=n_cores, seed=seed_e,
            exec_s=exec_s, backend=backend, distinct_seeds=distinct_seeds,
            threads_per_fn=threads_per_fn, node_exec_mult=state.slow,
            dead=~state.alive, node_rates=node_rates,
            node_extra=node_extra, device=device,
        )

        # stranded demand: functions parked on dead nodes still *arrive* —
        # clients retry, so the counts join the per-function backlog
        lost = 0
        for i in range(n_nodes):
            if not state.alive[i] and len(asg.node_fns[i]):
                counts = _count_arrivals(
                    node_rates[i], asg.node_fns[i], eps, n_cores, seed_e,
                    exec_s, arr_cache,
                )
                backlog[asg.node_fns[i]] += counts
                lost += int(counts.sum())
        if lost:
            obs_metrics.counter("chaos.lost_arrivals").inc(lost)

        # work conservation across the boundary: whatever a live node
        # admitted but did not finish inside this epoch is re-offered in
        # the next one (the arrival counts regenerate deterministically —
        # common random numbers — so arrived - completed is exact).
        # Progress is conserved too: re-serving every carried request
        # from scratch would throw away the partial service it received
        # before the boundary — a restart tax proportional to in-flight
        # inventory, which compounds into runaway backlog on exactly the
        # loaded post-failover survivors the comparison is about.  The
        # aggregate partial work (busy seconds beyond completed-request
        # cost, in request-equivalents) is therefore credited against the
        # carried counts: those requests complete from conserved progress
        # and are counted as boundary-spanning completions (no latency
        # sample — their latency straddles two epochs).
        credited_e = 0
        if carry_unfinished:
            for i in range(n_nodes):
                fns = asg.node_fns[i]
                if not state.alive[i] or not len(fns):
                    continue
                r = fleet_e.nodes[i]
                arr = _count_arrivals(
                    node_rates[i], fns, eps, n_cores, seed_e, exec_s,
                    arr_cache, extra=node_extra[i],
                )
                done = np.bincount(
                    np.asarray(r.fn_of, np.int64), minlength=len(fns),
                )[:len(fns)]
                unfinished = np.maximum(arr - done, 0)
                equiv = int(r.busy_time_s
                            / (exec_s * float(state.slow[i]))) \
                    - int(done.sum())
                for f in np.argsort(-unfinished):
                    if equiv <= 0 or unfinished[f] == 0:
                        break
                    take = min(int(unfinished[f]), equiv)
                    unfinished[f] -= take
                    equiv -= take
                    credited_e += take
                carry[fns] += unfinished
        if credited_e:
            obs_metrics.counter("chaos.credited_arrivals").inc(credited_e)

        # evidence + detection: observed completions are progress evidence
        # (they land in shared results, so they survive partitions) and
        # heartbeats ride the modelled network — sent a few times per
        # epoch (real heartbeat cadence is finer than the control
        # interval; with a single send at the epoch end, any sub-epoch
        # delivery delay would quantize up to a full epoch of staleness
        # and trip the detector) unless the node is partitioned at send
        # time or the seeded loss drops them, delivered once their delay
        # elapses, and timestamped at *send* time (a late heartbeat
        # proves the node was alive when it sent, not now — that
        # staleness is exactly what makes it SUSPECT).  Routed-work notes
        # tell the tracker which silences it may hold against a host:
        # fenced nodes get nothing routed, so their progress silence is
        # the controller's own doing and must not escalate to failure.
        reconciled_e = 0
        stragglers: List[int] = []
        hb_times = [t0 + eps * k / HB_PER_EPOCH
                    for k in range(1, HB_PER_EPOCH + 1)]
        part_at = [state.partitioned(ts) for ts in hb_times]
        for i in range(n_nodes):
            if i not in fenced and len(asg.node_fns[i]):
                tracker.note_routed(i, now=t1)
        for i in range(n_nodes):
            if not state.alive[i]:
                continue
            r = fleet_e.nodes[i]
            if r.n_completed > 0:
                tracker.observe_progress(i, now=t1)
                if i in fenced:
                    reconciled_e += int(r.n_completed)
            for ts, part in zip(hb_times, part_at):
                if part[i]:
                    continue
                p_loss = float(state.hb_loss[i])
                if p_loss <= 0.0 or hb_rng.random() >= p_loss:
                    hb_pending.append(
                        (ts + float(state.hb_delay[i]), i, ts))
            svc = _node_service_time(r)
            if svc is not None and watchdog.observe(i, svc):
                if i not in quarantined:
                    stragglers.append(i)
        if reconciled_e:
            obs_metrics.counter("chaos.reconciled").inc(reconciled_e)
        still_pending: List[Tuple[float, int, float]] = []
        for arrive_t, node, sent_t in hb_pending:
            if arrive_t <= t1 + 1e-9:
                # never let an older in-flight heartbeat regress the
                # freshness a newer (faster) one already established
                if tracker.last_seen.get(node, -1e18) < sent_t:
                    tracker.heartbeat(node, now=sent_t)
            else:
                still_pending.append((arrive_t, node, sent_t))
        hb_pending = still_pending
        detected_dead = tracker.failed_hosts(now=t1)
        suspects = tracker.suspect_hosts(now=t1)

        # proactive drain: trend-detect nodes drifting away from the
        # healthy-fleet service time and migrate their load *before* the
        # watchdog quarantines them.  Idle nodes (no completions — e.g.
        # already fully drained) are observed through a synthetic probe
        # at the node's slowdown multiplier, the sim stand-in for a real
        # drainer's probe requests — without it a drained node could
        # never demonstrate recovery and the hysteresis could not exit.
        draining_now: List[int] = []
        if proactive_drain:
            for i in range(n_nodes):
                if not state.alive[i]:
                    trend.forget(i)
                    continue
                if i in quarantined:
                    continue
                svc = _node_service_time(fleet_e.nodes[i])
                if svc is None:
                    svc = exec_s * float(state.slow[i])
                trend.observe(i, svc)
            draining_now = [i for i in trend.drain_hosts()
                            if i not in quarantined]

        degraded = bool(
            lost or deferred_e or replayed_e or detected_dead or suspects
            or fenced_e or draining_now or stragglers or quarantined
            or (~state.alive).any() or (state.slow > 1.0).any()
            or state.storm > 1.0
        )
        rec = EpochRecord(
            epoch, t0, t1, fleet_e, asg.counts.tolist(),
            state.alive.tolist(), list(detected_dead), stragglers,
            lost + deferred_e,
            replayed=replayed_e, carried=carried_e, credited=credited_e,
            degraded=degraded, suspects=list(suspects), fenced=fenced_e,
            draining=draining_now, deferred=deferred_e,
            reconciled=reconciled_e,
        )
        # the fence follows the *latest* suspicion verdict: newly suspect
        # nodes stop receiving work next epoch, healed nodes (heartbeats
        # flowing again) are unfenced and their deferred backlog replays
        fenced = set(suspects)

        # 3./4. re-place the victims' functions and charge the migrations.
        # Fenced nodes are neither victims nor destinations: their work is
        # not failed over (that would double-place a probably-alive node's
        # functions) and no new load lands on them.  Trend-drained nodes
        # *are* victims — their load migrates early at the priced cost —
        # but unlike quarantine the drain is reversible: once the trend
        # detector's hysteresis exits, the node rejoins the destinations.
        if rebalance:
            quarantined |= set(stragglers)
            unavailable = set(detected_dead) | quarantined
            drain_set = set(draining_now)
            victims = sorted(
                v for v in (unavailable | drain_set) - fenced
                if len(asg.node_fns[v])
            )
            dests = [d for d in range(n_nodes)
                     if d not in unavailable | drain_set | fenced]
            if topology is not None and dests:
                # steer failover traffic out of failing racks: a rack with
                # a confirmed-dead member is suspect as a domain (shared
                # power/ToR), so prefer destinations elsewhere — a soft
                # constraint, waived when every surviving node shares a
                # failing rack
                bad_racks = {topology.rack_of(v) for v in detected_dead}
                safe = [d for d in dests
                        if topology.rack_of(d) not in bad_racks]
                if safe:
                    dests = safe
            if victims and dests:
                asg, moved = _replace_victims(
                    asg, victims, dests, reb_name, policy, n_cores, epoch,
                    cold_mult=migration_cold_mult,
                    racks=None if topology is None else topology.racks(),
                )
                migrations.extend(moved)
                rec.migrations = len(moved)
                rec.migration_s = sum(m.cost_s for m in moved)
                obs_metrics.counter("chaos.migrations").inc(len(moved))
                if tracing:
                    obs_tracing.tracer().emit(
                        "rebalance.migrate", "chaos", t1 * 1e6, 0.0,
                        {"victims": victims, "moved": len(moved),
                         "cost_s": rec.migration_s}, ph="i",
                    )
                # every live function on exactly one live node (the
                # Assignment already guarantees exactly-one-node overall)
                for v in victims:
                    assert len(asg.node_fns[v]) == 0, (
                        f"victim node {v} still holds functions")

        epochs.append(rec)
        t0 = t1
        epoch += 1

    res = ChaosFleetResult(
        policy_name, assignment.placement, schedule, epochs, migrations,
        duration_s, epoch_s, n_cores, n_nodes, rebalanced=rebalance,
        slo_s=slo_s, proactive=proactive_drain,
    )
    if record_dir:
        record_chaos(res, record_dir)
    return res


def record_chaos(res: ChaosFleetResult, out_dir: str) -> List[str]:
    """Persist a chaos run: one merged-over-epochs record per node
    (``node<i>/run.json`` — render with ``repro_torch.obs.report --merge``)
    plus a top-level record carrying the failover report
    (``repro_torch.obs.report out_dir`` shows the ``failover:`` section)."""
    from repro_torch.obs.recorder import record_run

    paths = []
    for i in range(res.n_nodes):
        node_sched = SchedStats(f"chaos.node{i}")
        for e in res.epochs:
            node_sched.merge(e.fleet.nodes[i].sched_summary())
        paths.append(record_run(
            os.path.join(out_dir, f"node{i}"),
            meta={
                "layer": "chaos-fleet", "policy": res.policy,
                "placement": res.placement, "node": i,
                "n_nodes": res.n_nodes, "epochs": len(res.epochs),
                "duration_s": res.duration_s,
            },
            sched=node_sched,
            include_registry=False,
        ))
    paths.append(record_run(
        out_dir,
        meta={
            "layer": "chaos-fleet", "policy": res.policy,
            "placement": res.placement, "n_nodes": res.n_nodes,
            "epochs": len(res.epochs), "duration_s": res.duration_s,
            "rebalance": res.rebalanced,
        },
        sched=res.merged_sched(),
        chaos=res.report(),
        include_registry=False,
    ))
    return paths
