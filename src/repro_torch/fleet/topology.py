"""Fleet fault topology: which nodes share a failure domain.

Real failures are correlated: a rack loses power or its ToR switch and
every node in it goes dark together; a zone-level event takes several
racks at once.  The single-node ``node_crash`` grammar cannot express
that, so the chaos layer carries a :class:`Topology` — a node -> rack
mapping (optionally rack -> zone) — that

  * lets :class:`repro_torch.fleet.chaos.FaultSchedule` validate and expand
    rack-scoped events (``rack_crash``),
  * gives the ``rack-spread`` placement strategy its balance domains, and
  * lets the rebalancing controller steer failover traffic *away* from a
    failing rack (replicas of a victim's functions avoid its rack).

Topologies are validated up front (contiguous rack ids, no empty rack),
deterministic, and round-trip through JSON byte-for-byte — the same
replayability contract the fault schedules keep.

Copy of ``repro.fleet.topology``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np


@dataclass(frozen=True)
class Topology:
    """Node -> rack (and optional rack -> zone) failure-domain mapping."""

    rack_of_node: Tuple[int, ...]  # node i lives in rack rack_of_node[i]
    zone_of_rack: Tuple[int, ...] = ()  # optional: rack r lives in zone [r]

    def __post_init__(self):
        object.__setattr__(
            self, "rack_of_node",
            tuple(int(r) for r in self.rack_of_node))
        object.__setattr__(
            self, "zone_of_rack",
            tuple(int(z) for z in self.zone_of_rack))
        if not self.rack_of_node:
            raise ValueError("topology must cover at least one node")
        racks = sorted(set(self.rack_of_node))
        if racks != list(range(len(racks))):
            raise ValueError(
                f"rack ids must be contiguous 0..{len(racks) - 1} with no "
                f"empty rack, got {racks}")
        if any(r < 0 for r in self.rack_of_node):
            raise ValueError("rack ids must be >= 0")
        if self.zone_of_rack:
            if len(self.zone_of_rack) != len(racks):
                raise ValueError(
                    f"zone_of_rack must have one entry per rack: "
                    f"{len(self.zone_of_rack)} != {len(racks)}")
            zones = sorted(set(self.zone_of_rack))
            if zones != list(range(len(zones))):
                raise ValueError(
                    f"zone ids must be contiguous 0..{len(zones) - 1}, "
                    f"got {zones}")

    # -- construction ------------------------------------------------------
    @classmethod
    def uniform(cls, n_nodes: int, rack_size: int,
                zone_racks: int = 0) -> "Topology":
        """``rack_size`` consecutive nodes per rack (last rack may be
        short); with ``zone_racks`` > 0, that many consecutive racks per
        zone."""
        if rack_size <= 0:
            raise ValueError("rack_size must be positive")
        rack_of = tuple(i // rack_size for i in range(int(n_nodes)))
        zones: Tuple[int, ...] = ()
        if zone_racks > 0:
            n_racks = max(rack_of) + 1
            zones = tuple(r // zone_racks for r in range(n_racks))
        return cls(rack_of, zones)

    @classmethod
    def flat(cls, n_nodes: int) -> "Topology":
        """Every node its own rack — no correlated failure domains (the
        degenerate topology, equivalent to having none)."""
        return cls(tuple(range(int(n_nodes))))

    # -- queries -----------------------------------------------------------
    @property
    def n_nodes(self) -> int:
        return len(self.rack_of_node)

    @property
    def n_racks(self) -> int:
        return max(self.rack_of_node) + 1

    @property
    def n_zones(self) -> int:
        return (max(self.zone_of_rack) + 1) if self.zone_of_rack else 0

    def rack_of(self, node: int) -> int:
        return self.rack_of_node[node]

    def zone_of(self, rack: int) -> int:
        return self.zone_of_rack[rack] if self.zone_of_rack else 0

    def nodes_in(self, rack: int) -> List[int]:
        if not (0 <= rack < self.n_racks):
            raise ValueError(
                f"rack {rack} out of range [0, {self.n_racks})")
        return [i for i, r in enumerate(self.rack_of_node) if r == rack]

    def racks(self) -> np.ndarray:
        """Per-node rack ids as an array (placement strategies consume
        this rather than the object, so mid-run rebalancing can remap a
        survivors-only node subset)."""
        return np.asarray(self.rack_of_node, np.int64)

    def rack_members(self) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {r: [] for r in range(self.n_racks)}
        for i, r in enumerate(self.rack_of_node):
            out[r].append(i)
        return out

    # -- replayable serialisation -----------------------------------------
    def to_obj(self) -> dict:
        obj = {"rack_of_node": list(self.rack_of_node)}
        if self.zone_of_rack:
            obj["zone_of_rack"] = list(self.zone_of_rack)
        return obj

    def to_json(self) -> str:
        return json.dumps(self.to_obj(), sort_keys=True,
                          separators=(",", ":"))

    @classmethod
    def from_obj(cls, obj: dict) -> "Topology":
        return cls(tuple(obj["rack_of_node"]),
                   tuple(obj.get("zone_of_rack", ())))

    @classmethod
    def from_json(cls, text: str) -> "Topology":
        return cls.from_obj(json.loads(text))
