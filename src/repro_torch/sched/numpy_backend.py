"""numpy backend of the scheduling-policy protocol (float64 reference).

Absorbed ``repro_torch.core.policies`` (which now re-exports from here).  The
:class:`Policy` object is what ``core.simkernel`` (vectorised tick engine)
and ``core.des`` (exact event-driven oracle) consume:

  * ``keys(state)``          — per-thread composite key (lower runs first):
                               the protocol *primary* key scaled by 1e9 plus
                               this backend's secondary tie-break, the
                               thread-vruntime rank in [0, 1);
  * ``slice_ticks``          — how long an assigned thread keeps its core;
  * ``preempt_cores(state)`` — cores to release early this tick (wakeup /
                               credit / RT preemption, shared hysteresis
                               rule ``protocol.credit_preempt``);
  * ``voluntary_switch(...)``— the per-policy voluntary handoff cost model
                               (run-to-completion vs vruntime-ordered picks)
                               that ``simkernel`` charges every tick.

:func:`primary_key` is the protocol-level key on an :class:`EntityView`;
the torch backend (``torch_backend``) implements the identical formulas
in PyTorch and the differential tests pin both to the same picked sets.

Copy of ``repro.sched.numpy_backend``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.sched.protocol import (
    CFS_DEFAULT_SLICE_TICKS,
    CREDIT_EPS,
    EEVDF_INELIGIBLE,
    RT_BASE,
    TUNED_SLICE_TICKS,
    PolicySpec,
    credit_preempt,
    spec as get_spec,
)

__all__ = [
    "CFS_DEFAULT_SLICE_TICKS", "TUNED_SLICE_TICKS",
    "EntityView", "Policy", "make_policy", "pick_k", "primary_key",
]


@dataclass
class EntityView:
    """Per-entity scheduling state, the protocol's input contract.

    One row per schedulable entity (simulator thread / serving request
    slot); group-level arrays are indexed by ``ent_group``.
    """

    ent_group: np.ndarray  # (T,) int — group (cgroup/function/tenant) id
    group_vrt: np.ndarray  # (G,) group vruntime (seconds of service)
    group_credit: np.ndarray  # (G,) Load Credit
    last_pick_tick: np.ndarray  # (T,) tick of last core/slot assignment
    runnable: np.ndarray  # (T,) bool
    group_runnable: np.ndarray  # (G,) bool — any runnable member
    is_rt_group: np.ndarray  # (G,) bool — pinned SCHED_RR (lags-static)
    tick_sec: float = 0.004
    slice_ticks: int = 1


def primary_key(spec: PolicySpec, v: EntityView) -> np.ndarray:
    """(T,) float64 protocol primary key; lower runs first.

    This is *the* policy definition.  ``torch_backend.primary_key`` mirrors
    it in torch; keep the two in lockstep (tests/test_torch_sched_backend.py).
    """
    g = v.ent_group
    if spec.kind == "lags":
        return v.group_credit[g].astype(np.float64)
    if spec.kind == "rr":
        # FIFO by last pick: round robin across all entities
        return v.last_pick_tick.astype(np.float64)
    if spec.kind == "lags-static":
        is_rt = v.is_rt_group[g]
        return np.where(is_rt, RT_BASE + v.last_pick_tick,
                        v.group_vrt[g]).astype(np.float64)
    if spec.kind == "eevdf":
        # eligible (vruntime not ahead of the runnable mean) first, then
        # earliest virtual deadline
        vrt = v.group_vrt[g]
        if v.group_runnable.any():
            vmean = float(np.mean(v.group_vrt[v.group_runnable]))
        else:
            vmean = 0.0
        deadline = vrt + spec.slice_ticks * v.tick_sec
        inel = (vrt > vmean + CREDIT_EPS).astype(np.float64)
        return inel * EEVDF_INELIGIBLE + deadline
    # CFS: hierarchical — group vruntime is the primary
    return v.group_vrt[g].astype(np.float64)


def pick_k(keys: np.ndarray, runnable: np.ndarray, k: int) -> np.ndarray:
    """Indices of the k lowest-key runnable entities (stable order)."""
    cand = np.where(runnable)[0]
    return cand[np.argsort(keys[cand], kind="stable")][:k]


@dataclass
class Policy:
    """A :class:`PolicySpec` bound to this backend (+ runtime RT set)."""

    spec: PolicySpec
    static_rt_fns: Optional[np.ndarray] = None

    # -- compat surface (the old repro_torch.core.policies.Policy fields) -------
    @property
    def name(self) -> str:
        return self.spec.name

    @property
    def slice_ticks(self) -> int:
        return self.spec.slice_ticks

    @property
    def credit_window(self) -> int:
        return self.spec.credit_window

    @property
    def lags(self) -> bool:
        return self.spec.kind == "lags"

    @property
    def eevdf(self) -> bool:
        return self.spec.kind == "eevdf"

    @property
    def rr(self) -> bool:
        return self.spec.kind == "rr"

    @property
    def run_to_completion(self) -> bool:
        """Credit-ordered policies hand off within the group (paper §4.3)."""
        return self.spec.kind in ("lags", "lags-static")

    def _rt_mask(self, n_groups: int) -> np.ndarray:
        m = np.zeros(n_groups, bool)
        if self.spec.kind == "lags-static" and self.static_rt_fns is not None:
            m[np.asarray(self.static_rt_fns, np.int64)] = True
        return m

    def view_of(self, st) -> EntityView:
        """Adapt simulator ``_State`` to the protocol's entity view."""
        runnable = st.runnable_mask()
        group_runnable = np.zeros(st.fn_vrt.shape[0], bool)
        group_runnable[np.unique(st.th_fn[runnable])] = True
        return EntityView(
            ent_group=st.th_fn,
            group_vrt=st.fn_vrt,
            group_credit=st.credit,
            last_pick_tick=st.th_last_run / st.tick_sec,
            runnable=runnable,
            group_runnable=group_runnable,
            is_rt_group=self._rt_mask(st.fn_vrt.shape[0]),
            tick_sec=st.tick_sec,
            slice_ticks=self.spec.slice_ticks,
        )

    def keys(self, st) -> np.ndarray:
        """(T,) float64 composite key; lower runs first.

        Protocol primary * 1e9 plus the thread-vruntime rank in [0, 1) as
        secondary, so a single argsort gives hierarchical order.
        """
        T = st.th_fn.shape[0]
        order = np.argsort(st.th_vrt, kind="stable")
        rank = np.empty(T)
        rank[order] = np.arange(T) / max(T, 1)
        return primary_key(self.spec, self.view_of(st)) * 1e9 + rank

    def preempt_cores(self, st) -> np.ndarray:
        """Indices of cores to release for a waiting lower-key thread."""
        running = st.core_thread >= 0
        if not running.any():
            return np.empty(0, np.int64)
        wait_mask = st.waiting_mask()
        if not wait_mask.any():
            return np.empty(0, np.int64)
        run_fn = st.th_fn[np.maximum(st.core_thread, 0)]
        if self.spec.kind == "lags":
            # paper §4.3 global path: a waking task of a lighter cgroup
            # takes the core running the heaviest-credit task, subject to
            # the configured hysteresis gap.
            wait_credit = float(st.credit[st.th_fn[wait_mask]].min())
            run_credit = np.where(running, st.credit[run_fn], -np.inf)
            worst = int(np.argmax(run_credit))
            if credit_preempt(wait_credit, float(run_credit[worst]),
                              self.spec.preempt_hysteresis):
                return np.asarray([worst])
            return np.empty(0, np.int64)
        is_rt = self._rt_mask(st.fn_vrt.shape[0])
        if is_rt.any():
            # RT tasks preempt CFS tasks immediately
            if is_rt[st.th_fn[wait_mask]].any():
                run_is_cfs = running & ~is_rt[run_fn]
                idx = np.where(run_is_cfs)[0]
                return idx[:1]
            return np.empty(0, np.int64)
        # CFS / EEVDF wakeup preemption: waiting group vrt far behind running
        gran = st.tick_sec  # wakeup_granularity ~ one tick
        wait_v = st.fn_vrt[st.th_fn[wait_mask]].min()
        run_v = np.where(running, st.fn_vrt[run_fn], -np.inf)
        worst = int(np.argmax(run_v))
        if wait_v + gran < run_v[worst]:
            return np.asarray([worst])
        return np.empty(0, np.int64)

    def voluntary_switch(self, st, run_fn, sibs, c_same, c_cross, cost_cfs,
                         p_preempt):
        """Per-policy voluntary (block/wake) handoff cost and switch rate.

        Returns ``(cost_us, spb)``: the per-handoff cost for each running
        core and the switches-per-burst multiplier.  Under run-to-completion
        policies, cores serving the current lightest groups hand off within
        the group (leaf-rq-only re-insert; a sole runnable sibling is
        re-picked switch-free) and credit-ordered picking fires wakeup
        preemption less often than CFS's vruntime ordering.
        """
        if self.run_to_completion:
            run_credit = st.credit[run_fn]
            wait_m = st.waiting_mask()
            if wait_m.any():
                w_cmin = st.credit[st.th_fn[wait_m]].min()
            else:
                w_cmin = np.inf
            in_order = run_credit <= w_cmin + CREDIT_EPS
            solo = sibs <= 1.0
            cost = np.where(in_order & solo, 0.0,
                            np.where(in_order, c_same, cost_cfs))
            return cost, 1.0 + 0.85 * p_preempt
        return cost_cfs, 1.0 + p_preempt

    def request_key(self, credit, fn_vrt, fn: int, arrival: float, idx: int):
        """Request-granularity key for the exact DES oracle."""
        if self.spec.kind == "lags":
            return (credit[fn], arrival, idx)
        if self.spec.kind == "rr":
            return (arrival, idx)
        return (fn_vrt[fn], arrival, idx)


def make_policy(name: str, **kw) -> Policy:
    """Registry-backed factory (the former if/elif chain)."""
    static_rt = kw.pop("static_rt_fns", None)
    spec = get_spec(name, **kw)
    if static_rt is not None:
        spec = spec.with_overrides(
            static_rt_fns=tuple(int(f) for f in np.asarray(static_rt).ravel())
        )
        static_rt = np.asarray(static_rt, np.int64)
    return Policy(spec=spec, static_rt_fns=static_rt)
