"""Fault tolerance & elasticity control plane (host-level logic).

On a real cluster these hooks run in the launcher process per host; here the
logic is pure and unit-tested with virtual hosts:

  * ``HealthTracker`` — heartbeat bookkeeping with an evidence-based
    failure ladder: SUSPECT (heartbeats overdue) is distinct from
    CONFIRMED-DEAD (heartbeats overdue *and* no observed progress), so a
    partitioned-but-alive host is fenced rather than declared failed;
  * ``plan_remesh`` — given surviving hosts, pick the largest valid
    (pod, data, model) mesh <= survivors and the checkpoint-resume plan
    (elastic rescale via ``checkpoint.restore(..., sharding_tree)``);
  * ``StragglerWatchdog`` — step-time EWMA; flags hosts slower than
    ``k`` sigma for hot-spare replacement (straggler mitigation);
  * ``TrendDetector`` — hysteresis band over a per-host observable vs the
    healthy-fleet mean; flags hosts *trending* degraded (for proactive
    drain) and never flaps: a host enters draining above ``enter_ratio``
    (debounced) and leaves only below the lower ``exit_ratio``;
  * preemption-safe training is provided by atomic checkpoints
    (``train.checkpoint``) + deterministic data (``train.data``):
    restart = restore(latest) and continue at the stored step (in the
    reference; the port's training modules are not written yet).

Copy of ``repro.distributed.fault``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class HealthTracker:
    """Heartbeat bookkeeping with a SUSPECT tier between healthy and failed.

    Heartbeats ride the network; progress observations come from a second
    channel (the controller *sees* completed work in sim results or shared
    storage).  A host whose heartbeats stopped but whose work keeps
    landing is partitioned/delayed, not dead — conflating the two
    double-places its functions.  The ladder:

      healthy  — heartbeat within ``timeout_s``;
      SUSPECT  — heartbeat overdue, but progress observed recently (or
                 never confirmed dead): fence it — route no new work,
                 let in-flight work complete, reconcile on heal;
      failed   — heartbeat overdue AND progress stale too.  Hosts that
                 never produced a progress observation fall back to the
                 heartbeat-only verdict (the pre-SUSPECT behaviour, so
                 plain crash detection keeps its exact timing).
    """

    n_hosts: int
    timeout_s: float = 60.0
    # a freshly registered host gets this long to send its *first* heartbeat
    # before it can be declared failed (it used to be failed from t=0: the
    # old ``last_seen`` default of -1e18 made every never-heartbeated host
    # exceed the timeout immediately).  ``None`` means "same as timeout_s".
    grace_s: Optional[float] = None
    # staleness horizon for progress evidence; ``None`` = same as timeout_s
    progress_timeout_s: Optional[float] = None
    last_seen: Dict[int, float] = field(default_factory=dict)
    registered_at: Dict[int, float] = field(default_factory=dict)
    last_progress: Dict[int, float] = field(default_factory=dict)
    last_routed: Dict[int, float] = field(default_factory=dict)

    def register(self, host: int, now: Optional[float] = None):
        """Start the grace window for a host that has not heartbeated yet."""
        self.registered_at[host] = time.monotonic() if now is None else now

    def heartbeat(self, host: int, now: Optional[float] = None):
        self.last_seen[host] = time.monotonic() if now is None else now

    def observe_progress(self, host: int, now: Optional[float] = None):
        """Record out-of-band evidence the host is doing work (completions
        observed in sim results / shared storage) — independent of the
        heartbeat network, so it survives partitions and delays."""
        self.last_progress[host] = time.monotonic() if now is None else now

    def note_routed(self, host: int, now: Optional[float] = None):
        """Record that the controller routed work to this host (and has
        thus *earned* the right to expect progress).  Without it, fencing
        a suspect would starve its progress channel and the silence — the
        controller's own doing — would escalate a live partitioned host
        to CONFIRMED-DEAD."""
        self.last_routed[host] = time.monotonic() if now is None else now

    def _hb_overdue(self, host: int, now: float) -> bool:
        grace = self.timeout_s if self.grace_s is None else self.grace_s
        seen = self.last_seen.get(host)
        if seen is not None:
            return now - seen > self.timeout_s
        # never heartbeated: overdue only once the registration grace
        # expires (unregistered hosts date from t=0)
        return now - self.registered_at.get(host, 0.0) > grace

    def failed_hosts(self, now: Optional[float] = None) -> List[int]:
        """CONFIRMED-DEAD hosts: heartbeat overdue and, when the host has
        ever shown progress, that evidence is stale as well.  When work
        routing is tracked (``note_routed``), stale progress only damns a
        host that was handed work *after* its last observed progress — a
        host that answered everything it was ever given and then received
        nothing (because the controller fenced it) stays SUSPECT."""
        now = time.monotonic() if now is None else now
        pt = (self.timeout_s if self.progress_timeout_s is None
              else self.progress_timeout_s)
        out = []
        for h in range(self.n_hosts):
            if not self._hb_overdue(h, now):
                continue
            prog = self.last_progress.get(h)
            if prog is None:  # never progressed: heartbeat-only fallback
                out.append(h)
                continue
            if now - prog <= pt:
                continue
            routed = self.last_routed.get(h)
            if routed is None or routed > prog:
                out.append(h)
        return out

    def suspect_hosts(self, now: Optional[float] = None) -> List[int]:
        """Hosts whose heartbeats are overdue but that are *not* confirmed
        dead — recent progress contradicts the silence.  These should be
        fenced (no new arrivals) rather than failed over."""
        now = time.monotonic() if now is None else now
        dead = set(self.failed_hosts(now))
        return [h for h in range(self.n_hosts)
                if h not in dead and self._hb_overdue(h, now)]

    def healthy_hosts(self, now: Optional[float] = None) -> List[int]:
        bad = set(self.failed_hosts(now))
        return [h for h in range(self.n_hosts) if h not in bad]


def plan_remesh(
    n_healthy_chips: int,
    model_parallel: int = 16,
    prefer_pods: int = 2,
) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """Largest (pod, data, model) mesh fitting the surviving chips.

    Model parallelism is preserved (weights shard layout unchanged); data
    parallelism shrinks — batch is re-spread and optimizer state re-sharded
    from the checkpoint.  Examples: 512 chips -> (2,16,16); lose a host of
    8 chips -> 504 chips -> (1,31,16) = 496 used.
    """
    if n_healthy_chips < model_parallel:
        raise ValueError("fewer chips than model-parallel degree")
    groups = n_healthy_chips // model_parallel
    for pods in range(min(prefer_pods, groups), 0, -1):
        if groups % pods == 0:
            data = groups // pods
            if pods > 1:
                return (pods, data, model_parallel), ("pod", "data", "model")
            return (data, model_parallel), ("data", "model")
    return (groups, model_parallel), ("data", "model")


@dataclass
class StragglerWatchdog:
    """Flags hosts whose step time exceeds mean + k*sigma (EWMA)."""

    n_hosts: int
    alpha: float = 0.1
    k_sigma: float = 3.0
    warmup: int = 8
    # a host is flagged only when its step time ALSO exceeds this multiple
    # of the fleet mean: the k-sigma test alone misfires on heterogeneous
    # fleets (per-host EWMA variance can be tiny while host means honestly
    # differ by tens of percent), and one false flag drains a healthy host
    min_ratio: float = 2.0
    # weight applied to the EWMA update of a sample that was *flagged* as a
    # straggler.  Flagged samples used to feed back at full weight into the
    # host's own mean/var (and hence the fleet mean), so a persistent 3x
    # straggler raised its own baseline until it looked normal again; 0.0
    # excludes flagged samples entirely, small values down-weight them.
    flagged_weight: float = 0.0
    # consecutive suspect observations required before ``observe`` reports
    # a straggler.  A single sample cannot separate a genuinely slow host
    # from a transient spike in the observable (e.g. an epoched observer's
    # busy/completed ratio right after a burst leaves censored in-flight
    # work) — a real slowdown persists, a spike does not, and one false
    # flag drains a healthy host.
    persist: int = 2
    mean: Dict[int, float] = field(default_factory=dict)
    var: Dict[int, float] = field(default_factory=dict)
    count: Dict[int, int] = field(default_factory=dict)
    streak: Dict[int, int] = field(default_factory=dict)

    def observe(self, host: int, step_s: float) -> bool:
        """Record a step time; returns True if host is now a straggler."""
        m = self.mean.get(host, step_s)
        v = self.var.get(host, 0.0)
        self.count[host] = self.count.get(host, 0) + 1
        suspect = False
        if self.count[host] > self.warmup:
            sigma = max(v, 1e-12) ** 0.5
            fleet_mean = sum(self.mean.values()) / max(len(self.mean), 1)
            if (step_s > fleet_mean * self.min_ratio
                    and step_s > fleet_mean
                    + self.k_sigma * max(sigma, 0.05 * fleet_mean)):
                suspect = True
        # suspect samples stay out of the baseline even while debouncing,
        # else a real straggler would normalise itself before persisting
        a = self.alpha * (self.flagged_weight if suspect else 1.0)
        d = step_s - m
        self.mean[host] = m + a * d
        self.var[host] = (1 - a) * (v + a * d * d)
        self.streak[host] = self.streak.get(host, 0) + 1 if suspect else 0
        return suspect and self.streak[host] >= self.persist


@dataclass
class TrendDetector:
    """Flags hosts *trending* degraded, with hysteresis so it never flaps.

    The ``StragglerWatchdog`` answers "is this host an outlier right
    now?"; proactive draining needs the earlier, stickier question "is
    this host's per-request service time drifting away from the fleet,
    and has it stayed there?".  Each host keeps an EWMA of its observable
    (e.g. busy seconds per completed request) that is compared against
    the mean EWMA of the *non-draining* hosts:

      * a host enters the draining set once its ratio has exceeded
        ``enter_ratio`` for ``persist`` consecutive observations (a
        single burst does not trigger a migration storm);
      * it leaves only once the ratio drops below ``exit_ratio`` —
        with ``exit_ratio < enter_ratio`` the band between the two is
        dead zone in both directions, so a host oscillating around the
        threshold cannot flap in and out of draining.
    """

    n_hosts: int
    alpha: float = 0.35
    enter_ratio: float = 1.6
    exit_ratio: float = 1.2
    persist: int = 2
    warmup: int = 2
    ewma: Dict[int, float] = field(default_factory=dict)
    count: Dict[int, int] = field(default_factory=dict)
    streak: Dict[int, int] = field(default_factory=dict)
    draining: Dict[int, bool] = field(default_factory=dict)

    def __post_init__(self):
        if not (0.0 < self.exit_ratio <= self.enter_ratio):
            raise ValueError(
                f"need 0 < exit_ratio <= enter_ratio for hysteresis, got "
                f"exit={self.exit_ratio} enter={self.enter_ratio}")

    def _fleet_mean(self, exclude: int) -> float:
        # baseline = healthy (non-draining) hosts, so a degraded host's own
        # EWMA cannot drag the fleet mean up and mask itself; the observed
        # host is excluded from its own baseline
        vals = [v for h, v in self.ewma.items()
                if h != exclude and not self.draining.get(h, False)]
        if not vals:  # everyone else drains: fall back to all other hosts
            vals = [v for h, v in self.ewma.items() if h != exclude]
        return sum(vals) / len(vals) if vals else 0.0

    def observe(self, host: int, value: float) -> bool:
        """Record one observation; returns True while ``host`` should be
        draining (new work steered away, load migrated off)."""
        m = self.ewma.get(host, value)
        self.ewma[host] = m + self.alpha * (value - m)
        self.count[host] = self.count.get(host, 0) + 1
        fleet = self._fleet_mean(host)
        if self.count[host] <= self.warmup or fleet <= 0.0:
            self.streak[host] = 0
            return self.draining.get(host, False)
        ratio = self.ewma[host] / fleet
        if self.draining.get(host, False):
            if ratio < self.exit_ratio:
                self.draining[host] = False
                self.streak[host] = 0
        else:
            if ratio > self.enter_ratio:
                self.streak[host] = self.streak.get(host, 0) + 1
                if self.streak[host] >= self.persist:
                    self.draining[host] = True
            else:
                self.streak[host] = 0
        return self.draining.get(host, False)

    def drain_hosts(self) -> List[int]:
        return sorted(h for h, d in self.draining.items() if d)

    def forget(self, host: int):
        """Drop a host's state (it crashed or was replaced — its history
        must not poison the baseline when a fresh node takes the slot)."""
        for d in (self.ewma, self.count, self.streak, self.draining):
            d.pop(host, None)
