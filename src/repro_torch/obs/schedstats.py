"""Per-tenant/per-function scheduling accounting (the paper's measurement model).

Mirrors what ``/proc/schedstat`` + perf gave the paper (§3, Figs 3-10), for
every execution layer in this repo: useful vs switch-overhead seconds, switch
rate and per-switch cost, run delay (runnable -> running wait), and a bounded
run-queue-depth timeline.  One ``SchedStats`` instance per run; the DES
oracle, the tick simulator, and the serving engine all publish into it, so
``repro_torch.obs.report`` can summarize and diff runs across layers and policies.

Accounting identity (asserted by tests for the engine, where every second is
attributed): ``useful_s + switch_s + idle_s == time_s``.

Copy of ``repro.obs.schedstats``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.obs.metrics import Histogram

_TIMELINE_CAP = 4096  # runq samples kept; halved (decimated) when exceeded


@dataclass
class EntityStats:
    """One scheduled entity: a function cgroup (sim) or a tenant (serving)."""

    useful_s: float = 0.0
    switch_s: float = 0.0
    switches: float = 0.0
    same_group_switches: float = 0.0
    run_delay_s: float = 0.0
    runs: int = 0  # times dispatched after a wait
    arrived: int = 0
    completed: int = 0

    def merge(self, other: "EntityStats") -> "EntityStats":
        self.useful_s += other.useful_s
        self.switch_s += other.switch_s
        self.switches += other.switches
        self.same_group_switches += other.same_group_switches
        self.run_delay_s += other.run_delay_s
        self.runs += other.runs
        self.arrived += other.arrived
        self.completed += other.completed
        return self

    def to_dict(self) -> dict:
        return {
            "useful_s": self.useful_s,
            "switch_s": self.switch_s,
            "switches": self.switches,
            "same_group_switches": self.same_group_switches,
            "run_delay_s": self.run_delay_s,
            "runs": self.runs,
            "arrived": self.arrived,
            "completed": self.completed,
        }


class SchedStats:
    """Incremental scheduling accountant with per-entity breakdown."""

    def __init__(self, name: str = ""):
        self.name = name
        self.entities: Dict[int, EntityStats] = {}
        self.time_s = 0.0  # total accounted time (sim seconds)
        self.idle_s = 0.0
        self.useful_s = 0.0
        self.switch_s = 0.0
        self.switches = 0.0
        self.capacity_s = 0.0  # core-seconds offered (0 if 1-slot semantics)
        # seconds spent fenced (SUSPECT): serving in-flight work only, no
        # new admissions.  An annotation parallel to the conservation
        # identity, not a term in it — fenced time is still accounted as
        # useful/switch/idle by whatever ran during it.
        self.fenced_s = 0.0
        self.switch_cost_us = Histogram("switch_cost_us", lo=1e-3)
        self.run_delay = Histogram("run_delay_s")
        self.latency = Histogram("latency_s")
        self.runq_timeline: List[Tuple[float, float]] = []
        self._stride = 1
        self._tick = 0

    def _ent(self, entity: int) -> EntityStats:
        e = self.entities.get(entity)
        if e is None:
            e = self.entities[entity] = EntityStats()
        return e

    # -- accounting --------------------------------------------------------
    def account_time(self, s: float) -> None:
        self.time_s += s

    def account_idle(self, s: float) -> None:
        self.idle_s += s

    def account_useful(self, entity: int, s: float) -> None:
        self.useful_s += s
        self._ent(entity).useful_s += s

    def account_switch(self, entity: int, cost_s: float, n: float = 1.0,
                       same_group: bool = False) -> None:
        self.switches += n
        self.switch_s += cost_s
        e = self._ent(entity)
        e.switches += n
        e.switch_s += cost_s
        if same_group:
            e.same_group_switches += n
        if n > 0:
            self.switch_cost_us.record(1e6 * cost_s / n, weight=n)

    def account_fenced(self, s: float) -> None:
        """Accumulate wall time spent fenced (no-new-admissions mode)."""
        self.fenced_s += s

    def account_run_delay(self, entity: int, s: float) -> None:
        e = self._ent(entity)
        e.run_delay_s += s
        e.runs += 1
        self.run_delay.record(s)

    def account_arrival(self, entity: int, n: int = 1) -> None:
        self._ent(entity).arrived += n

    def account_completion(self, entity: int, latency_s: float) -> None:
        self._ent(entity).completed += 1
        self.latency.record(latency_s)

    def sample_runq(self, t: float, depth: float) -> None:
        """Bounded timeline: record every ``stride``-th sample; on overflow
        decimate by 2x so memory stays O(cap) over arbitrarily long runs."""
        self._tick += 1
        if self._tick % self._stride:
            return
        tl = self.runq_timeline
        tl.append((t, depth))
        if len(tl) >= _TIMELINE_CAP:
            del tl[::2]
            self._stride *= 2

    # -- derived -----------------------------------------------------------
    @property
    def switch_share(self) -> float:
        """Switch time as a share of accounted time (or of core capacity
        when the layer reported one, as the simulator does)."""
        denom = self.capacity_s if self.capacity_s > 0 else self.time_s
        return self.switch_s / max(denom, 1e-12)

    @property
    def mean_switch_cost_us(self) -> float:
        return 1e6 * self.switch_s / max(self.switches, 1e-12)

    def switch_rate(self) -> float:
        return self.switches / max(self.time_s, 1e-12)

    def conservation_error(self) -> float:
        """|useful + switch + idle - time| — ~0 for layers that attribute
        every accounted second (the serving engine)."""
        return abs(self.useful_s + self.switch_s + self.idle_s - self.time_s)

    def runq_peak(self) -> float:
        return max((d for _, d in self.runq_timeline), default=0.0)

    # -- aggregation -------------------------------------------------------
    def merge(self, other: "SchedStats") -> "SchedStats":
        """Fold another run's accounting into this one (fleet aggregation).

        Totals and per-entity stats sum; histograms merge bucket-wise
        (``Histogram.merge``).  Entity ids are summed by key — for fleet
        nodes these are per-node function ids, i.e. function *classes*
        under the banded placement; for serve shards they are global
        tenant ids.  ``time_s`` sums too: for parallel shards the merged
        view accounts aggregate shard-seconds, which keeps the
        conservation identity (``useful + switch + idle == time``) and
        makes ``switch_share`` the fleet-wide share.
        """
        self.time_s += other.time_s
        self.idle_s += other.idle_s
        self.useful_s += other.useful_s
        self.switch_s += other.switch_s
        self.switches += other.switches
        self.capacity_s += other.capacity_s
        self.fenced_s += other.fenced_s
        self.switch_cost_us.merge(other.switch_cost_us)
        self.run_delay.merge(other.run_delay)
        self.latency.merge(other.latency)
        for k, e in other.entities.items():
            self._ent(k).merge(e)
        if other.runq_timeline:
            tl = sorted(self.runq_timeline + other.runq_timeline)
            while len(tl) >= _TIMELINE_CAP:
                tl = tl[::2]
            self.runq_timeline = tl
        if not self.name:
            self.name = other.name
        elif other.name and other.name != self.name:
            self.name = f"{self.name}+{other.name}"
        return self

    @classmethod
    def merged(cls, stats, name: str = "") -> "SchedStats":
        """One fleet-wide view from an iterable of per-shard stats."""
        out = cls(name)
        for st in stats:
            out.merge(st)
        return out

    # -- (de)serialization -------------------------------------------------
    def snapshot(self) -> dict:
        return {
            "name": self.name,
            "time_s": self.time_s,
            "idle_s": self.idle_s,
            "useful_s": self.useful_s,
            "switch_s": self.switch_s,
            "switches": self.switches,
            "capacity_s": self.capacity_s,
            "fenced_s": self.fenced_s,
            "switch_share": self.switch_share,
            "mean_switch_cost_us": self.mean_switch_cost_us,
            "switch_cost_us": self.switch_cost_us.to_dict(),
            "run_delay": self.run_delay.to_dict(),
            "latency": self.latency.to_dict(),
            "runq_timeline": [[t, d] for t, d in self.runq_timeline],
            "entities": {str(k): e.to_dict() for k, e in self.entities.items()},
        }

    @classmethod
    def from_snapshot(cls, d: dict) -> "SchedStats":
        st = cls(d.get("name", ""))
        st.time_s = d["time_s"]
        st.idle_s = d["idle_s"]
        st.useful_s = d["useful_s"]
        st.switch_s = d["switch_s"]
        st.switches = d["switches"]
        st.capacity_s = d.get("capacity_s", 0.0)
        st.fenced_s = d.get("fenced_s", 0.0)  # absent in pre-fence records
        st.switch_cost_us = Histogram.from_dict(
            d["switch_cost_us"], "switch_cost_us")
        st.run_delay = Histogram.from_dict(d["run_delay"], "run_delay_s")
        st.latency = Histogram.from_dict(d["latency"], "latency_s")
        st.runq_timeline = [tuple(x) for x in d.get("runq_timeline", [])]
        for k, e in d.get("entities", {}).items():
            st.entities[int(k)] = EntityStats(**e)
        return st


def from_sim_result(r) -> "SchedStats":
    """Summary SchedStats for a ``simkernel.SimResult`` (the simulator also
    attaches a richer one on ``r.schedstats`` when telemetry is enabled)."""
    st = SchedStats(f"simkernel.{r.policy}")
    st.time_s = r.duration_s
    st.capacity_s = r.n_cores * r.duration_s
    st.useful_s = r.busy_time_s
    st.switch_s = r.switch_time_s
    st.switches = float(r.switches)
    st.idle_s = max(st.capacity_s - r.busy_time_s - r.switch_time_s, 0.0)
    st.latency.record_many(r.latencies)
    return st
