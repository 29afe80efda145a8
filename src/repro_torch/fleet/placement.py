"""Placement registry: assign function cgroups to fleet nodes.

The orchestrator-side half of the paper's cluster study (§5.1): before any
node schedules anything, *placement* decides which function lands where.
Each strategy partitions the global function ids ``0..total_fns-1`` —
every function carries a *reserved share* (its band-model mean demand as a
fraction of one node's cores, see :func:`fn_shares`) — into per-node
assignments:

  * ``round-robin``  — fn ``i`` -> node ``i % n_nodes``; band-striped, the
    paper's banded placement (nodes statistically identical).
  * ``pack``         — first-fit decreasing by reserved share against a
    per-node share cap: fills nodes densely, leaves the tail nodes light
    (the consolidation-friendly but switch-hostile extreme; cf. the
    constraint-based pod-packing line of work, arXiv:2511.08373).
  * ``spread``       — least-loaded (LPT greedy): each function goes to the
    node with the smallest reserved-share sum (cf. C-Balancer's
    profile-driven rebalancing, arXiv:2009.08912).
  * ``switch-aware`` — least *cost*: greedy like ``spread``, but the
    objective adds the scheduling-policy voluntary-switch overhead the
    node would pay for one more colocated cgroup, estimated through the
    numpy :class:`repro_torch.sched.numpy_backend.Policy` cost model — dense
    cgroup stacking is penalised super-linearly, and run-to-completion
    policies (LAGS) tolerate density that CFS cannot.
  * ``rack-spread``  — least-loaded node, ties broken toward the
    least-loaded *rack*: balances reserved share like ``spread`` while
    steering equal-load choices across failure domains (pass the per-node
    ``racks`` array from :meth:`repro_torch.fleet.topology.Topology.racks`), so
    a rack-scoped crash strands the smallest possible share and failover
    replicas do not re-concentrate in one domain.  Without ``racks`` it
    degrades to ``spread`` exactly (every node its own rack).

Every strategy must *conserve the function count*: each global fn id is
assigned to exactly one node (``Assignment.__post_init__`` asserts it).
The legacy representative-node path (``core.cluster.simulate_node_share``)
silently floored to ``max(1, total // n_nodes)`` functions per node,
dropping up to ``n_nodes - 1`` functions from the cluster total — the
regression tests in ``tests/test_fleet.py`` pin the fix.

Copy of ``repro.fleet.placement``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.switch_cost import switch_cost_us
from repro_torch.sched.numpy_backend import Policy, make_policy

PLACEMENTS: Dict[str, Callable] = {}


def fn_shares(
    total_fns: int,
    n_cores: int = 12,
    exec_s: float = 0.2,
    seed: int = 7,
) -> np.ndarray:
    """Per-function reserved share: band-model mean demand / node capacity.

    The same heavy-tailed band rates the workload synthesiser draws from
    (``traces.fn_rates``), converted to the fraction of one node's cores a
    function's mean demand reserves.  Deterministic given ``seed``.
    """
    from repro_torch.core.traces import fn_rates

    rates = fn_rates(total_fns, n_cores, seed)
    return rates * exec_s / n_cores


@dataclass(frozen=True)
class Assignment:
    """A placement decision: global fn ids partitioned over nodes."""

    placement: str
    node_fns: Tuple[np.ndarray, ...]  # per-node global fn ids
    shares: np.ndarray  # (total_fns,) reserved share per global fn

    def __post_init__(self):
        total = int(self.shares.shape[0])
        seen = np.concatenate([np.asarray(f, np.int64) for f in self.node_fns]) \
            if self.node_fns else np.empty(0, np.int64)
        # conservation: every function exactly once — the cluster total
        # must not silently shrink (the old // floor dropped functions)
        assert len(seen) == total and len(np.unique(seen)) == total, (
            f"{self.placement}: assigned {len(seen)} of {total} functions "
            f"({total - len(np.unique(seen))} dropped/duplicated)"
        )

    @property
    def n_nodes(self) -> int:
        return len(self.node_fns)

    @property
    def counts(self) -> np.ndarray:
        return np.asarray([len(f) for f in self.node_fns], np.int64)

    @property
    def node_shares(self) -> np.ndarray:
        return np.asarray([float(self.shares[f].sum()) for f in self.node_fns])

    def share_imbalance(self) -> float:
        """max/mean reserved-share ratio across nodes (1.0 = perfect)."""
        s = self.node_shares
        return float(s.max() / max(s.mean(), 1e-12))


def _register(name: str):
    def deco(fn):
        PLACEMENTS[name] = fn
        return fn
    return deco


@_register("round-robin")
def _round_robin(shares: np.ndarray, n_nodes: int, **_kw) -> List[np.ndarray]:
    total = shares.shape[0]
    return [np.arange(total, dtype=np.int64)[i::n_nodes]
            for i in range(n_nodes)]


@_register("pack")
def _pack(shares: np.ndarray, n_nodes: int, headroom: float = 1.25,
          init_load: Optional[np.ndarray] = None,
          **_kw) -> List[np.ndarray]:
    """First-fit decreasing by reserved share against a per-node cap.

    ``init_load`` warm-starts the per-node loads (mid-run rebalancing:
    survivors already carry their placed share; only the new functions in
    ``shares`` are assigned).
    """
    load = (np.zeros(n_nodes) if init_load is None
            else np.asarray(init_load, float).copy())
    cap = headroom * (shares.sum() + load.sum()) / n_nodes
    out: List[list] = [[] for _ in range(n_nodes)]
    for f in np.argsort(-shares, kind="stable"):
        fits = np.where(load + shares[f] <= cap)[0]
        # overflow (cap too tight for the tail): least-loaded fallback so
        # conservation always holds
        n = int(fits[0]) if len(fits) else int(np.argmin(load))
        out[n].append(int(f))
        load[n] += shares[f]
    return [np.asarray(sorted(g), np.int64) for g in out]


@_register("spread")
def _spread(shares: np.ndarray, n_nodes: int,
            init_load: Optional[np.ndarray] = None,
            **_kw) -> List[np.ndarray]:
    """Least-loaded (LPT greedy) by reserved share.  ``init_load``
    warm-starts per-node loads for mid-run rebalancing."""
    load = (np.zeros(n_nodes) if init_load is None
            else np.asarray(init_load, float).copy())
    out: List[list] = [[] for _ in range(n_nodes)]
    for f in np.argsort(-shares, kind="stable"):
        n = int(np.argmin(load))
        out[n].append(int(f))
        load[n] += shares[f]
    return [np.asarray(sorted(g), np.int64) for g in out]


@_register("rack-spread")
def _rack_spread(shares: np.ndarray, n_nodes: int,
                 racks: Optional[np.ndarray] = None,
                 init_load: Optional[np.ndarray] = None,
                 **_kw) -> List[np.ndarray]:
    """Least-loaded node, least-loaded rack as tiebreak (two-level LPT
    greedy by reserved share).

    ``racks[i]`` is node ``i``'s failure domain (``Topology.racks()``, or
    any subset of it remapped onto a destination list for mid-run
    rebalancing).  ``init_load`` warm-starts per-node loads, and the rack
    loads are derived from it, so failover placement sees the survivors'
    *current* rack occupancy.  With ``racks=None`` every node is its own
    rack and the strategy reduces to ``spread`` exactly.
    """
    load = (np.zeros(n_nodes) if init_load is None
            else np.asarray(init_load, float).copy())
    if racks is None:
        racks = np.arange(n_nodes, dtype=np.int64)
    else:
        racks = np.asarray(racks, np.int64)
        if racks.shape[0] != n_nodes:
            raise ValueError(
                f"racks has {racks.shape[0]} entries for {n_nodes} nodes")
    rack_load = np.zeros(int(racks.max()) + 1)
    np.add.at(rack_load, racks, load)
    out: List[list] = [[] for _ in range(n_nodes)]
    for f in np.argsort(-shares, kind="stable"):
        s = float(shares[f])
        # primary key: the node's own load; secondary: its rack load; ties
        # broken by node index (lexsort is stable).  Node load must lead:
        # were rack load primary, a rack left with a single live node
        # (e.g. its sibling just drained) would have the smallest rack
        # load and swallow an entire failover wave onto that one node —
        # rack diversity is the tiebreak among equally loaded nodes, not
        # an excuse to overload one.
        n = int(np.lexsort((rack_load[racks], load))[0])
        out[n].append(int(f))
        load[n] += s
        rack_load[racks[n]] += s
    return [np.asarray(sorted(g), np.int64) for g in out]


class _DensityProbe:
    """Minimal ``simkernel._State`` facade for ``Policy.voluntary_switch``.

    Models a node at placement time: one representative runnable thread per
    colocated cgroup, uniform Load Credit (steady state), every thread
    waiting — exactly the dense-stacking regime the paper measures.
    """

    def __init__(self, n_groups: int):
        self.credit = np.zeros(n_groups)
        self.th_fn = np.arange(n_groups, dtype=np.int64)
        self._wait = np.ones(n_groups, bool)

    def waiting_mask(self) -> np.ndarray:
        return self._wait


def switch_penalty(
    policy: Policy,
    n_groups: int,
    util: float,
    n_cores: int = 12,
    depth: float = 5.0,
    burst_us: float = 280.0,
) -> float:
    """Estimated voluntary-switch overhead fraction of a node hosting
    ``n_groups`` cgroups at reserved utilisation ``util``.

    Runs the policy's own voluntary-handoff cost model (the same
    ``Policy.voluntary_switch`` the tick simulator charges each tick, §3.2
    steady-state: useful fraction = burst / (burst + spb * cost)) on a
    density probe, so a placement sees CFS's log-growing cross-cgroup cost
    while LAGS's in-order run-to-completion handoffs stay near-free.
    """
    if n_groups <= 0:
        return 0.0
    st = _DensityProbe(n_groups)
    run_fn = st.th_fn
    sibs = np.ones(n_groups)
    c_same = switch_cost_us(True, siblings=sibs, groups=n_groups, depth=depth)
    c_cross = switch_cost_us(False, siblings=sibs, groups=n_groups, depth=depth)
    p_preempt = min(1.0, max(n_groups - n_cores, 0) / (2.0 * n_cores))
    cost_us, spb = policy.voluntary_switch(
        st, run_fn, sibs, c_same, c_cross, c_cross, p_preempt
    )
    cost_s = float(np.mean(cost_us)) * 1e-6 * spb
    burst_s = burst_us * 1e-6
    return min(util, 1.0) * cost_s / (burst_s + cost_s)


@_register("switch-aware")
def _switch_aware(shares: np.ndarray, n_nodes: int,
                  policy: Optional[Policy] = None, n_cores: int = 12,
                  depth: float = 5.0,
                  init_load: Optional[np.ndarray] = None,
                  init_groups: Optional[np.ndarray] = None,
                  **_kw) -> List[np.ndarray]:
    """Greedy least-(load + switch-overhead) placement.  ``init_load`` /
    ``init_groups`` warm-start the survivors' reserved load and colocated
    cgroup counts for mid-run rebalancing, so the switch-cost objective
    prices the *post-migration* density of each candidate node."""
    policy = policy or make_policy("cfs")
    load = (np.zeros(n_nodes) if init_load is None
            else np.asarray(init_load, float).copy())
    groups = (np.zeros(n_nodes, np.int64) if init_groups is None
              else np.asarray(init_groups, np.int64).copy())
    out: List[list] = [[] for _ in range(n_nodes)]
    for f in np.argsort(-shares, kind="stable"):
        s = float(shares[f])
        cost = np.asarray([
            load[n] + s + switch_penalty(
                policy, int(groups[n]) + 1, load[n] + s, n_cores, depth
            )
            for n in range(n_nodes)
        ])
        n = int(np.argmin(cost))
        out[n].append(int(f))
        load[n] += s
        groups[n] += 1
    return [np.asarray(sorted(g), np.int64) for g in out]


def place(
    name: str,
    total_fns: int,
    n_nodes: int,
    shares: Optional[np.ndarray] = None,
    policy: Optional[Policy] = None,
    n_cores: int = 12,
    exec_s: float = 0.2,
    seed: int = 7,
    **kw,
) -> Assignment:
    """Run a registered placement strategy; returns a conservation-checked
    :class:`Assignment`."""
    try:
        strat = PLACEMENTS[name]
    except KeyError:
        raise ValueError(
            f"unknown placement {name!r}; have {sorted(PLACEMENTS)}"
        ) from None
    if shares is None:
        shares = fn_shares(total_fns, n_cores, exec_s, seed)
    node_fns = strat(shares, n_nodes, policy=policy, n_cores=n_cores, **kw)
    return Assignment(placement=name, node_fns=tuple(node_fns), shares=shares)
