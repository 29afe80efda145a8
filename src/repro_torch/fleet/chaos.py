"""Deterministic fault injection for the fleet (chaos schedule).

A :class:`FaultSchedule` is an up-front-validated, time-ordered list of
:class:`FaultEvent`\\ s injected into a fleet run by the rebalancing
controller (:mod:`repro_torch.fleet.rebalance`).  The grammar:

  * ``node_crash(node)``        — the node stops heartbeating and serving;
    its functions are stranded until the controller re-places them (or
    forever, under a static placement).
  * ``node_slow(node, factor)`` — the node degrades: every execution on it
    takes ``factor``x longer (thermal throttling, noisy neighbour, failing
    disk).  Detected by the
    :class:`~repro_torch.distributed.fault.StragglerWatchdog`.
  * ``burst_storm(factor)``     — fleet-wide demand multiplier (a traffic
    storm): offered load scales by ``factor`` until the storm recovers.
  * ``recover(node)``           — the node (or, with ``node=-1``, the
    storm) returns to nominal.

Topology-aware, correlated and *network* faults (these need a
:class:`repro_torch.fleet.topology.Topology` attached to the schedule, except
the heartbeat events, which are per-node):

  * ``rack_crash(rack)``        — correlated crash: every node in the rack
    dies at once (rack power / ToR failure).  Nodes recover individually
    via ``recover(node)``.
  * ``partition(nodes, duration)`` — network partition: the listed nodes
    stop heartbeating for ``duration`` seconds but are *alive* — their
    in-flight work keeps completing.  The controller must fence them
    (SUSPECT), not declare them dead; the partition heals by itself.
  * ``heartbeat_delay(node, delay_s)`` — the node's heartbeats arrive
    ``delay_s`` late (slow control network, distinct from a slow node).
    Persistent until ``recover(node)``.
  * ``heartbeat_loss(node, p)`` — each heartbeat is dropped i.i.d. with
    probability ``p`` (lossy control network).  Persistent until
    ``recover(node)``; the drop stream is seeded by the controller.

Schedules are deterministic and replayable byte-for-byte: events are
normalised to a canonical sorted order, ``to_json``/``from_json`` round-trip
exactly (including the attached topology), and :meth:`FaultSchedule.random`
derives a schedule purely from a seed.  Event times snap to controller
epoch boundaries (the controller applies every event with ``t < epoch_end``
at the start of that epoch), so a schedule plus an epoch length fully
determines the fleet timeline.

Copy of ``repro.fleet.chaos``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from repro_torch.fleet.topology import Topology

#: recognised event kinds and whether they carry a factor argument
#: (for the network events the "factor" is the delay in seconds /
#: the drop probability — validated per kind, see ``_validate``)
KINDS = {
    "node_crash": False,
    "node_slow": True,
    "burst_storm": True,
    "recover": False,
    "rack_crash": False,
    "partition": False,
    "heartbeat_delay": True,
    "heartbeat_loss": True,
}

#: ``node`` value meaning "the fleet as a whole" (burst_storm / its recover)
FLEET = -1


@dataclass(frozen=True, order=True)
class FaultEvent:
    """One timed injection.  ``node`` is ``FLEET`` (-1) for fleet-wide
    events; ``factor`` is the slowdown / rate multiplier (>= 1) — for
    ``heartbeat_delay`` it is the delay in seconds (> 0), for
    ``heartbeat_loss`` the drop probability (0 < p <= 1).  ``rack``
    addresses ``rack_crash``; ``nodes``/``duration`` describe a
    ``partition`` window ``[t, t + duration)``."""

    t: float
    kind: str
    node: int = FLEET
    factor: float = 1.0
    rack: int = -1
    nodes: Tuple[int, ...] = ()
    duration: float = 0.0

    def to_dict(self) -> dict:
        d = {"t": self.t, "kind": self.kind, "node": self.node,
             "factor": self.factor}
        # optional fields stay out of the encoding at their defaults, so
        # pre-topology schedules keep their exact historical bytes
        if self.rack >= 0:
            d["rack"] = self.rack
        if self.nodes:
            d["nodes"] = list(self.nodes)
        if self.duration:
            d["duration"] = self.duration
        return d


class FaultSchedule:
    """Validated, time-ordered fault schedule for ``n_nodes`` fleet nodes.

    ``topology`` (optional) attaches the failure-domain map; rack-scoped
    events (``rack_crash``) require it and are validated against it.
    """

    def __init__(self, events: Iterable[FaultEvent], n_nodes: int,
                 topology: Optional[Topology] = None):
        self.n_nodes = int(n_nodes)
        self.topology = topology
        if topology is not None and topology.n_nodes != self.n_nodes:
            raise ValueError(
                f"topology covers {topology.n_nodes} nodes, schedule is "
                f"for {self.n_nodes}")
        self.events: Tuple[FaultEvent, ...] = tuple(sorted(events))
        self._validate()

    # -- construction ------------------------------------------------------
    @classmethod
    def empty(cls, n_nodes: int,
              topology: Optional[Topology] = None) -> "FaultSchedule":
        return cls((), n_nodes, topology)

    @classmethod
    def single_crash(cls, node: int, t: float, n_nodes: int) -> "FaultSchedule":
        """The fig_failover scenario: one node dies and stays dead."""
        return cls([FaultEvent(t, "node_crash", node)], n_nodes)

    @classmethod
    def single_rack_crash(cls, rack: int, t: float,
                          topology: Topology) -> "FaultSchedule":
        """Correlated failure: every node in ``rack`` dies at ``t``."""
        return cls([FaultEvent(t, "rack_crash", rack=rack)],
                   topology.n_nodes, topology)

    @classmethod
    def single_partition(cls, nodes: Iterable[int], t: float,
                         duration: float, n_nodes: int,
                         topology: Optional[Topology] = None,
                         ) -> "FaultSchedule":
        """Pure network fault: ``nodes`` stop heartbeating for
        ``duration`` seconds but keep serving their in-flight work."""
        return cls(
            [FaultEvent(t, "partition", nodes=tuple(int(n) for n in nodes),
                        duration=float(duration))],
            n_nodes, topology)

    @classmethod
    def random(cls, seed: int, n_nodes: int, duration_s: float,
               n_events: int = 4,
               topology: Optional[Topology] = None) -> "FaultSchedule":
        """Seed-deterministic schedule: crashes, slowdowns, storms and
        matched recoveries, never crashing the whole fleet.  With a
        ``topology`` the draw also includes the correlated and network
        events (rack crashes, partitions, heartbeat delay/loss); without
        one the byte sequence is identical to the pre-topology grammar.
        """
        if topology is not None and topology.n_nodes != int(n_nodes):
            raise ValueError(
                f"topology covers {topology.n_nodes} nodes, asked for "
                f"{n_nodes}")
        rng = np.random.default_rng(seed)
        events: List[FaultEvent] = []
        dead: set = set()
        slow: set = set()
        netty: set = set()  # nodes with an active heartbeat delay/loss
        part_until: Dict[int, float] = {}  # node -> partition window end
        storm = False
        # draw times pre-sorted so the state tracked during generation is
        # the state in *time* order (events are time-sorted on construction)
        times = np.sort(rng.uniform(0.05, 0.95, int(n_events))) * duration_s
        for t in times:
            t = float(t)
            roll = rng.uniform()
            alive = [n for n in range(n_nodes) if n not in dead]
            if topology is not None:
                # topology-aware extension: a slice of the roll space goes
                # to correlated / network faults, the rest falls through to
                # the legacy grammar (rescaled)
                if roll < 0.12:
                    live_racks = [
                        r for r in range(topology.n_racks)
                        if not any(n in dead for n in topology.nodes_in(r))
                        and len(dead) + len(topology.nodes_in(r)) < n_nodes
                    ]
                    if live_racks:
                        rack = int(rng.choice(live_racks))
                        for n in topology.nodes_in(rack):
                            dead.add(n)
                            slow.discard(n)
                            netty.discard(n)
                        events.append(FaultEvent(t, "rack_crash", rack=rack))
                        continue
                elif roll < 0.24:
                    cand = [n for n in alive
                            if part_until.get(n, -1.0) <= t]
                    if cand:
                        k = int(rng.integers(1, min(len(cand), 3) + 1))
                        ns = tuple(sorted(
                            int(x) for x in rng.choice(cand, k, replace=False)
                        ))
                        dur = float(rng.uniform(0.05, 0.25) * duration_s)
                        for n in ns:
                            part_until[n] = t + dur
                        events.append(FaultEvent(
                            t, "partition", nodes=ns, duration=dur))
                        continue
                elif roll < 0.36:
                    cand = [n for n in alive if n not in netty]
                    if cand:
                        node = int(rng.choice(cand))
                        netty.add(node)
                        if rng.uniform() < 0.5:
                            events.append(FaultEvent(
                                t, "heartbeat_delay", node,
                                float(rng.uniform(0.02, 0.3) * duration_s)))
                        else:
                            events.append(FaultEvent(
                                t, "heartbeat_loss", node,
                                float(rng.uniform(0.3, 1.0))))
                        continue
                roll = rng.uniform()  # fresh roll for the legacy grammar
            if roll < 0.35 and len(dead) + 1 < n_nodes:
                node = int(rng.choice(alive))
                dead.add(node)
                slow.discard(node)
                netty.discard(node)
                events.append(FaultEvent(t, "node_crash", node))
            elif roll < 0.65:
                cand = [n for n in range(n_nodes) if n not in dead]
                node = int(rng.choice(cand))
                slow.add(node)
                events.append(FaultEvent(
                    t, "node_slow", node, float(rng.uniform(1.5, 4.0))))
            elif roll < 0.85 and not storm:
                storm = True
                events.append(FaultEvent(
                    t, "burst_storm", FLEET, float(rng.uniform(1.2, 2.5))))
            elif slow or netty or storm:
                if storm and (not (slow or netty) or rng.uniform() < 0.5):
                    storm = False
                    events.append(FaultEvent(t, "recover", FLEET))
                else:
                    node = int(rng.choice(sorted(slow | netty)))
                    slow.discard(node)
                    netty.discard(node)
                    events.append(FaultEvent(t, "recover", node))
        return cls(events, n_nodes, topology)

    # -- validation --------------------------------------------------------
    def _validate(self) -> None:
        dead: set = set()
        slow: set = set()
        netty: set = set()  # active heartbeat delay/loss
        parts: List[Tuple[float, float, frozenset]] = []  # (t0, t1, nodes)
        storm = False
        for ev in self.events:
            if ev.kind not in KINDS:
                raise ValueError(
                    f"unknown fault kind {ev.kind!r}; have {sorted(KINDS)}")
            if ev.t < 0.0:
                raise ValueError(f"event time must be >= 0, got {ev.t}")
            if ev.kind in ("node_slow", "burst_storm") and ev.factor < 1.0:
                raise ValueError(
                    f"{ev.kind} factor must be >= 1, got {ev.factor}")
            if ev.kind == "burst_storm":
                if ev.node != FLEET:
                    raise ValueError("burst_storm is fleet-wide (node=-1)")
                storm = True
                continue
            if ev.kind == "recover" and ev.node == FLEET:
                if not storm:
                    raise ValueError(
                        f"recover(fleet) at t={ev.t} with no active storm")
                storm = False
                continue
            if ev.kind == "rack_crash":
                if self.topology is None:
                    raise ValueError(
                        "rack_crash needs a topology attached to the "
                        "schedule")
                if not (0 <= ev.rack < self.topology.n_racks):
                    raise ValueError(
                        f"rack_crash rack {ev.rack} out of range "
                        f"[0, {self.topology.n_racks})")
                members = self.topology.nodes_in(ev.rack)
                hit = [n for n in members if n in dead]
                if hit:
                    raise ValueError(
                        f"rack_crash(rack={ev.rack}) at t={ev.t} overlaps "
                        f"already-crashed node(s) {hit}")
                for n in members:
                    dead.add(n)
                    slow.discard(n)
                    netty.discard(n)
                continue
            if ev.kind == "partition":
                if not ev.nodes:
                    raise ValueError("partition needs a non-empty node set")
                if len(set(ev.nodes)) != len(ev.nodes):
                    raise ValueError(
                        f"partition node set has duplicates: {ev.nodes}")
                bad = [n for n in ev.nodes
                       if not (0 <= n < self.n_nodes)]
                if bad:
                    raise ValueError(
                        f"partition node(s) {bad} out of range "
                        f"[0, {self.n_nodes})")
                if ev.duration <= 0.0:
                    raise ValueError(
                        f"partition duration must be > 0, got {ev.duration}")
                crashed = [n for n in ev.nodes if n in dead]
                if crashed:
                    raise ValueError(
                        f"partition of already-crashed node(s) {crashed} "
                        f"at t={ev.t}")
                ns = frozenset(ev.nodes)
                for (p0, p1, pn) in parts:
                    if ev.t < p1 and ns & pn:
                        raise ValueError(
                            f"overlapping partitions of node(s) "
                            f"{sorted(ns & pn)}: [{p0}, {p1}) and "
                            f"[{ev.t}, {ev.t + ev.duration})")
                parts.append((ev.t, ev.t + ev.duration, ns))
                continue
            if not (0 <= ev.node < self.n_nodes):
                raise ValueError(
                    f"{ev.kind} node {ev.node} out of range "
                    f"[0, {self.n_nodes})")
            if ev.kind == "node_crash":
                if ev.node in dead:
                    raise ValueError(f"node {ev.node} crashed twice")
                dead.add(ev.node)
                slow.discard(ev.node)
                netty.discard(ev.node)
            elif ev.kind == "node_slow":
                if ev.node in dead:
                    raise ValueError(
                        f"node_slow on already-crashed node {ev.node}")
                slow.add(ev.node)
            elif ev.kind == "heartbeat_delay":
                if ev.factor <= 0.0:
                    raise ValueError(
                        f"heartbeat_delay must be > 0 s, got {ev.factor}")
                if ev.node in dead:
                    raise ValueError(
                        f"heartbeat_delay on already-crashed node "
                        f"{ev.node} (a dead node sends no heartbeats)")
                netty.add(ev.node)
            elif ev.kind == "heartbeat_loss":
                if not (0.0 < ev.factor <= 1.0):
                    raise ValueError(
                        f"heartbeat_loss probability must be in (0, 1], "
                        f"got {ev.factor}")
                if ev.node in dead:
                    raise ValueError(
                        f"heartbeat_loss on already-crashed node {ev.node}")
                netty.add(ev.node)
            elif ev.kind == "recover":
                if ev.node in dead:
                    dead.discard(ev.node)
                    netty.discard(ev.node)
                elif ev.node in slow or ev.node in netty:
                    slow.discard(ev.node)
                    netty.discard(ev.node)
                else:
                    raise ValueError(
                        f"recover(node={ev.node}) at t={ev.t}: node is "
                        "neither crashed nor slow nor degraded on the "
                        "heartbeat network")
        if len(dead) >= self.n_nodes:
            raise ValueError("schedule crashes every node")

    # -- queries -----------------------------------------------------------
    def __len__(self) -> int:
        return len(self.events)

    def __bool__(self) -> bool:
        return bool(self.events)

    def events_in(self, t0: float, t1: float) -> List[FaultEvent]:
        """Events with ``t0 <= t < t1`` (the controller applies these at
        the start of the epoch covering ``[t0, t1)``)."""
        return [e for e in self.events if t0 <= e.t < t1]

    # -- replayable serialisation -----------------------------------------
    def to_json(self) -> str:
        """Canonical (sorted, fixed key order) encoding — byte-for-byte
        stable for identical schedules.  Pre-topology schedules keep
        their historical bytes (no new keys at default values)."""
        obj = {"n_nodes": self.n_nodes,
               "events": [e.to_dict() for e in self.events]}
        if self.topology is not None:
            obj["topology"] = self.topology.to_obj()
        return json.dumps(obj, sort_keys=True, separators=(",", ":"))

    @classmethod
    def from_json(cls, text: str) -> "FaultSchedule":
        obj = json.loads(text)
        topo = (Topology.from_obj(obj["topology"])
                if "topology" in obj else None)
        return cls(
            [FaultEvent(e["t"], e["kind"], e.get("node", FLEET),
                        e.get("factor", 1.0), e.get("rack", -1),
                        tuple(e.get("nodes", ())), e.get("duration", 0.0))
             for e in obj["events"]],
            obj["n_nodes"], topo,
        )


@dataclass
class NodeState:
    """Ground-truth fleet condition: which nodes are up, each node's
    current slowdown factor, the active demand multiplier, and the
    *network* condition per node (partition window, heartbeat delay,
    heartbeat drop probability).  Mutated by :meth:`apply` as events
    fire.  Note the controller never reads this directly — its view of
    liveness comes from the heartbeat/progress evidence the network
    faults distort."""

    n_nodes: int
    alive: Optional[np.ndarray] = None
    slow: Optional[np.ndarray] = None
    storm: float = 1.0
    part_until: Optional[np.ndarray] = None  # partition active while t <
    hb_delay: Optional[np.ndarray] = None  # seconds each heartbeat is late
    hb_loss: Optional[np.ndarray] = None  # P(drop) per heartbeat

    def __post_init__(self):
        if self.alive is None:
            self.alive = np.ones(self.n_nodes, bool)
        if self.slow is None:
            self.slow = np.ones(self.n_nodes)
        if self.part_until is None:
            self.part_until = np.zeros(self.n_nodes)
        if self.hb_delay is None:
            self.hb_delay = np.zeros(self.n_nodes)
        if self.hb_loss is None:
            self.hb_loss = np.zeros(self.n_nodes)

    def apply(self, ev: FaultEvent,
              topology: Optional[Topology] = None) -> None:
        if ev.kind == "node_crash":
            self._crash(ev.node)
        elif ev.kind == "rack_crash":
            if topology is None:
                raise ValueError("rack_crash needs a topology to expand")
            for n in topology.nodes_in(ev.rack):
                self._crash(n)
        elif ev.kind == "partition":
            for n in ev.nodes:
                self.part_until[n] = max(
                    float(self.part_until[n]), ev.t + ev.duration)
        elif ev.kind == "heartbeat_delay":
            self.hb_delay[ev.node] = ev.factor
        elif ev.kind == "heartbeat_loss":
            self.hb_loss[ev.node] = ev.factor
        elif ev.kind == "node_slow":
            self.slow[ev.node] = ev.factor
        elif ev.kind == "burst_storm":
            self.storm = ev.factor
        elif ev.kind == "recover":
            if ev.node == FLEET:
                self.storm = 1.0
            else:
                self.alive[ev.node] = True
                self.slow[ev.node] = 1.0
                self.hb_delay[ev.node] = 0.0
                self.hb_loss[ev.node] = 0.0

    def _crash(self, node: int) -> None:
        self.alive[node] = False
        self.slow[node] = 1.0
        # a dead node sends no heartbeats at all; its link state is moot
        self.hb_delay[node] = 0.0
        self.hb_loss[node] = 0.0

    def partitioned(self, t: float) -> np.ndarray:
        """Mask of nodes inside an active partition window at time ``t``."""
        return (self.part_until > t) & self.alive

    def snapshot(self) -> Dict[str, object]:
        snap = {
            "alive": self.alive.astype(int).tolist(),
            "slow": [round(float(x), 6) for x in self.slow],
            "storm": round(float(self.storm), 6),
        }
        if (self.part_until > 0).any():
            snap["part_until"] = [round(float(x), 6)
                                  for x in self.part_until]
        if (self.hb_delay > 0).any():
            snap["hb_delay"] = [round(float(x), 6) for x in self.hb_delay]
        if (self.hb_loss > 0).any():
            snap["hb_loss"] = [round(float(x), 6) for x in self.hb_loss]
        return snap
