"""Vectorised tick-level node simulator (numpy fast path).

Models one worker node: ``n_cores`` hardware threads, ``n_fns`` colocated
function cgroups each with a bounded thread pool, per-policy scheduling with
sticky core assignment, wakeup/credit preemption, and the calibrated
context-switch cost model.  One tick = 4 ms (CONFIG_HZ = 250).

This is the engine behind every paper figure (3, 5, 6, 8, 9, 10, 11) and the
cluster consolidation study.  ``des.py`` is the exact event-driven oracle used
to validate it on small cases (not ported yet); ``simkernel_torch.py`` is the
tensor port that runs the nodes of a fleet batched on the card.

Copy of ``repro.core.simkernel``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core import load_credit as lc
from repro_torch.core.switch_cost import switch_cost_us
from repro_torch.sched import Policy
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.schedstats import EntityStats, SchedStats

TICK_SEC = lc.TICK_SEC


@dataclass
class Workload:
    """Per-function arrival processes + service demand."""

    n_fns: int
    arrivals: List[np.ndarray]  # per-fn sorted arrival times (sec); open loop
    service_s: List[np.ndarray]  # per-fn per-request CPU demand (sec)
    threads_per_fn: int = 4
    parallelism: int = 1  # threads per request (resctl-parallel: 2)
    closed_loop_slots: int = 0  # >0: resctl-style closed loop, global slots
    duration_s: float = 60.0


@dataclass
class SimConfig:
    n_cores: int = 12
    hierarchy_depth: float = 2.0  # 2 standalone, 5 Knative cluster node
    latency_slo_s: float = 1.0
    seed: int = 0
    model_switch_cost: bool = True
    # Mean CPU-burst length between voluntary switches (block/wake handoffs
    # in the service's thread pools).  100 us reproduces the paper's
    # standalone switch rates; ~280 us the Knative cluster node (§3.2: longer
    # PyTorch bursts, fewer concurrently active functions).
    burst_us: float = 120.0


@dataclass
class SimResult:
    policy: str
    latencies: np.ndarray  # completed-request latencies (sec)
    fn_of: np.ndarray  # function id per completed request (aligned)
    arrival_of: np.ndarray  # arrival time per completed request (aligned)
    n_arrived: int
    n_completed: int
    switches: int
    switch_time_s: float
    busy_time_s: float  # useful work
    duration_s: float
    n_cores: int
    # rich per-fn schedstats (populated only when repro_torch.obs is enabled, so
    # the disabled-telemetry hot path stays unchanged)
    schedstats: Optional[SchedStats] = None

    @property
    def overhead_frac(self) -> float:
        cap = self.n_cores * self.duration_s
        return self.switch_time_s / cap

    @property
    def util_effective(self) -> float:
        return self.busy_time_s / (self.n_cores * self.duration_s)

    @property
    def util_perceived(self) -> float:
        return (self.busy_time_s + self.switch_time_s) / (
            self.n_cores * self.duration_s
        )

    @property
    def mean_switch_cost_us(self) -> float:
        return 1e6 * self.switch_time_s / max(self.switches, 1)

    def throughput_slo(self, slo: float = 1.0) -> float:
        return float(np.sum(self.latencies <= slo)) / self.duration_s

    def pct(self, q: float) -> float:
        return float(np.percentile(self.latencies, q)) if len(self.latencies) else float("nan")

    def sched_summary(self) -> SchedStats:
        """The attached rich schedstats, or a totals-only one derived from
        this result (always available, telemetry on or off)."""
        if self.schedstats is not None:
            return self.schedstats
        from repro_torch.obs.schedstats import from_sim_result

        return from_sim_result(self)


class _State:
    """Mutable simulator state exposed to policies."""

    def __init__(self, wl: Workload, cfg: SimConfig, window: int):
        T = wl.n_fns * wl.threads_per_fn
        self.tick_sec = TICK_SEC
        self.th_fn = np.repeat(np.arange(wl.n_fns), wl.threads_per_fn)
        self.th_state = np.zeros(T, np.int8)  # 0 idle, 1 runnable/running
        self.th_rem = np.zeros(T)
        self.th_req = np.full(T, -1, np.int64)
        self.th_vrt = np.zeros(T)
        self.th_last_run = np.zeros(T)
        self.fn_vrt = np.zeros(wl.n_fns)
        self.core_thread = np.full(cfg.n_cores, -1, np.int64)
        self.core_slice = np.zeros(cfg.n_cores, np.int64)
        self.tracker = lc.LoadCreditTracker(wl.n_fns, window_ticks=window)
        self.credit = self.tracker.credit
        self.now = 0.0
        self.vrt_floor = 0.0

    def runnable_mask(self):
        return self.th_state == 1

    def waiting_mask(self):
        m = self.th_state == 1
        running = self.core_thread[self.core_thread >= 0]
        m[running] = False
        return m


def simulate(
    wl: Workload,
    policy: Policy,
    cfg: SimConfig | None = None,
) -> SimResult:
    cfg = cfg or SimConfig()
    rng = np.random.default_rng(cfg.seed)
    st = _State(wl, cfg, policy.credit_window)
    n_ticks = int(round(wl.duration_s / TICK_SEC))
    C = cfg.n_cores

    # request bookkeeping (grow-able python lists, vector ops per tick)
    req_arrival: list = []
    req_parts: list = []
    req_latency: list = []
    req_fn: list = []
    n_arrived = 0

    # pending per-fn queues + free thread slots
    pending = [deque() for _ in range(wl.n_fns)]
    free_threads = [
        deque(range(f * wl.threads_per_fn, (f + 1) * wl.threads_per_fn))
        for f in range(wl.n_fns)
    ]

    # pre-bucket open-loop arrivals by tick
    arr_tick: dict = {}
    for f in range(wl.n_fns):
        for t_a, s_d in zip(wl.arrivals[f], wl.service_s[f]):
            k = int(t_a / TICK_SEC)
            arr_tick.setdefault(k, []).append((f, t_a, s_d))

    # closed loop: global generator slots, round-robin over functions
    cl_next_fn = 0
    cl_service = (
        np.concatenate(wl.service_s).mean() if wl.closed_loop_slots else 0.1
    )

    # obs instrumentation (per-fn schedstats, switch-cost histogram, runq
    # timeline, run delay).  All per-tick recording is gated on ``obs_on``
    # captured once here, so disabled telemetry adds no hot-loop work.
    obs_on = obs_metrics.enabled()
    sched: Optional[SchedStats] = None
    if obs_on:
        sched = SchedStats(f"simkernel.{policy.name}")
        fn_busy = np.zeros(wl.n_fns)
        fn_switches = np.zeros(wl.n_fns)
        fn_switch_time = np.zeros(wl.n_fns)
        th_wait_start = np.full(wl.n_fns * wl.threads_per_fn, -1.0)

    def submit(f: int, t_a: float, demand: float) -> None:
        nonlocal n_arrived
        rid = len(req_arrival)
        req_arrival.append(t_a)
        req_parts.append(wl.parallelism)
        req_latency.append(-1.0)
        req_fn.append(f)
        n_arrived += 1
        per = demand / wl.parallelism
        for _ in range(wl.parallelism):
            if free_threads[f]:
                th = free_threads[f].popleft()
                st.th_state[th] = 1
                st.th_rem[th] = per
                st.th_req[th] = rid
                if obs_on:
                    th_wait_start[th] = t_a  # runnable from arrival
                # CFS wakeup placement: a waking group's vruntime is clamped
                # to (min runnable group vrt - sched_latency) so long-idle
                # groups run soon but cannot monopolise with ancient lag.
                st.fn_vrt[f] = max(st.fn_vrt[f], st.vrt_floor - 0.024)
            else:
                pending[f].append((rid, per))

    switches = 0
    switch_time = 0.0
    busy_time = 0.0

    if wl.closed_loop_slots:
        for s in range(wl.closed_loop_slots):
            f = cl_next_fn
            cl_next_fn = (cl_next_fn + 1) % wl.n_fns
            d = float(wl.service_s[f % wl.n_fns][s % len(wl.service_s[f % wl.n_fns])])
            submit(f, 0.0, d)

    for tick in range(n_ticks):
        st.now = tick * TICK_SEC
        runnable0 = st.runnable_mask()
        if runnable0.any():
            st.vrt_floor = float(st.fn_vrt[np.unique(st.th_fn[runnable0])].min())
        # 1. arrivals
        for (f, t_a, s_d) in arr_tick.get(tick, ()):  # open loop
            submit(f, t_a, s_d)

        # 2. release cores: completed/idle threads, expired slices, preemption
        for c in range(C):
            th = st.core_thread[c]
            if th >= 0 and st.th_state[th] != 1:
                st.core_thread[c] = -1
        st.core_slice = np.maximum(st.core_slice - 1, 0)
        expired = (st.core_thread >= 0) & (st.core_slice == 0)
        # expired threads go back to the pool (may be re-picked immediately)
        for c in np.where(expired)[0]:
            st.core_thread[c] = -1
        if st.waiting_mask().any():
            for c in policy.preempt_cores(st):
                st.core_thread[c] = -1

        # 3. fill free cores in policy-key order
        free_cores = np.where(st.core_thread < 0)[0]
        if len(free_cores):
            wait = st.waiting_mask()
            n_waiting = int(wait.sum())
            if n_waiting:
                keys = policy.keys(st)
                cand = np.where(wait)[0]
                cand = cand[np.argsort(keys[cand], kind="stable")]
                take = list(cand[: len(free_cores)])
                # prefer re-assigning a thread to the core it last ran on:
                # a re-picked leftmost task is NOT a context switch in CFS.
                prev = getattr(st, "_prev_assign", None)
                assigned = {}
                if prev is not None:
                    take_set = set(take)
                    for c in free_cores:
                        if prev[c] in take_set:
                            assigned[c] = prev[c]
                            take_set.discard(prev[c])
                    take = [t for t in take if t in take_set]
                rest = [c for c in free_cores if c not in assigned]
                for c, th in list(assigned.items()) + list(zip(rest, take)):
                    st.core_thread[c] = th
                    st.core_slice[c] = policy.slice_ticks
                    st.th_last_run[th] = st.now
                    if obs_on and th_wait_start[th] >= 0:
                        sched.account_run_delay(
                            int(st.th_fn[th]),
                            max(st.now - th_wait_start[th], 0.0),
                        )
                        th_wait_start[th] = -1.0

        # 4. progress running threads, charge switch costs
        running = st.core_thread >= 0
        eff = np.full(C, TICK_SEC)
        runnable = st.runnable_mask()
        sib_count = np.bincount(st.th_fn[runnable], minlength=wl.n_fns)
        n_groups_runnable = max(int((sib_count > 0).sum()), 1)
        n_runnable = max(int(runnable.sum()), 1)

        # 4a. involuntary: core's thread changed since last tick (slice
        # expiry, wakeup/credit preemption, load balancing)
        if not hasattr(st, "_prev_assign"):
            st._prev_assign = np.full(C, -2, np.int64)
            st._prev_fn = np.full(C, -2, np.int64)
        changed = running & (st.core_thread != st._prev_assign)
        if cfg.model_switch_cost and changed.any():
            new_fn = np.where(running, st.th_fn[np.maximum(st.core_thread, 0)], -1)
            same = (new_fn == st._prev_fn) & (st._prev_fn >= 0)
            sibs = sib_count[np.maximum(new_fn, 0)]
            cost_us = switch_cost_us(
                same[changed],
                siblings=sibs[changed],
                groups=n_groups_runnable,
                depth=cfg.hierarchy_depth,
            )
            cost_s = np.minimum(cost_us * 1e-6, TICK_SEC)
            eff[changed] -= cost_s
            switches += int(changed.sum())
            switch_time += float(cost_s.sum())
            if obs_on:
                ch_fn = new_fn[changed]
                np.add.at(fn_switches, ch_fn, 1.0)
                np.add.at(fn_switch_time, ch_fn, cost_s)
                sched.switch_cost_us.record_many(cost_s * 1e6)
        st._prev_assign = st.core_thread.copy()
        st._prev_fn = np.where(
            running, st.th_fn[np.maximum(st.core_thread, 0)], -1
        )

        # 4b. voluntary: block/wake handoffs every ~burst_us of CPU time.
        # In steady state a core alternates burst + schedule(): useful
        # fraction = burst/(burst + spb*cost) where spb (switches-per-burst)
        # also accounts for wakeup-preemption storms: at high contention a
        # woken task usually preempts another core, doubling the effective
        # switch rate (this is the paper's "rate" growth term, Fig 10).
        # The per-policy handoff cost (vruntime-ordered picks vs LAGS
        # run-to-completion) lives in the policy protocol —
        # ``repro_torch.sched.numpy_backend.Policy.voluntary_switch``; this engine
        # only supplies the calibrated same/cross-cgroup cost samples.
        if cfg.model_switch_cost and running.any():
            burst_s = cfg.burst_us * 1e-6
            run_th_all = st.core_thread[running]
            run_fn = st.th_fn[run_th_all]
            sibs = sib_count[run_fn].astype(np.float64)
            n_waiting = max(n_runnable - int(running.sum()), 0)
            p_preempt = min(1.0, n_waiting / (2.0 * C))
            c_same = switch_cost_us(
                True, siblings=sibs, groups=n_groups_runnable,
                depth=cfg.hierarchy_depth,
            )
            c_cross = switch_cost_us(
                False, siblings=sibs, groups=n_groups_runnable,
                depth=cfg.hierarchy_depth,
            )
            p_same_cfs = np.clip((sibs - 1.0) / max(n_runnable - 1.0, 1.0), 0, 1)
            cost_cfs = p_same_cfs * c_same + (1.0 - p_same_cfs) * c_cross
            cost_v, spb = policy.voluntary_switch(
                st, run_fn, sibs, c_same, c_cross, cost_cfs, p_preempt
            )
            cost_v_s = cost_v * 1e-6 * spb
            frac_ovh = cost_v_s / (burst_s + cost_v_s)
            e = eff[running]
            v_ovh = e * frac_ovh
            n_sw = e / (burst_s + cost_v_s) * spb * (cost_v_s > 0)
            eff[running] = e - v_ovh
            switches += int(np.round(n_sw.sum()))
            switch_time += float(v_ovh.sum())
            if obs_on:
                np.add.at(fn_switches, run_fn, n_sw)
                np.add.at(fn_switch_time, run_fn, v_ovh)
                # per-switch cost, weighted by this core's switch count
                for i in np.where(n_sw > 0)[0]:
                    sched.switch_cost_us.record(
                        1e6 * v_ovh[i] / n_sw[i], weight=float(n_sw[i])
                    )

        run_th = st.core_thread[running]
        eff_run = eff[running]
        work = np.minimum(st.th_rem[run_th], eff_run)
        busy_time += float(work.sum())
        if obs_on:
            np.add.at(fn_busy, st.th_fn[run_th], work)
            sched.sample_runq(st.now, n_runnable)
        st.th_rem[run_th] -= eff_run
        st.th_vrt[run_th] += eff_run
        np.add.at(st.fn_vrt, st.th_fn[run_th], eff_run)

        # 5. completions
        done = run_th[st.th_rem[run_th] <= 0.0]
        for th in done:
            rid = int(st.th_req[th])
            f = int(st.th_fn[th])
            req_parts[rid] -= 1
            if req_parts[rid] == 0:
                req_latency[rid] = (st.now + TICK_SEC) - req_arrival[rid]
                if wl.closed_loop_slots:  # closed loop: next request now
                    f2 = cl_next_fn
                    cl_next_fn = (cl_next_fn + 1) % wl.n_fns
                    d = float(
                        wl.service_s[f2][rid % len(wl.service_s[f2])]
                    )
                    submit(f2, st.now + TICK_SEC, d)
            st.th_state[th] = 0
            st.th_req[th] = -1
            if pending[f]:
                rid2, per = pending[f].popleft()
                st.th_state[th] = 1
                st.th_rem[th] = per
                st.th_req[th] = rid2
                st.th_vrt[th] = max(st.th_vrt[th], st.fn_vrt[f])
                if obs_on:
                    th_wait_start[th] = st.now  # runnable from slot pickup
            else:
                free_threads[f].append(th)

        # 6. load-credit tick: per-fn share of core time this tick
        run_frac = np.zeros(wl.n_fns)
        np.add.at(run_frac, st.th_fn[run_th], eff_run / TICK_SEC)
        st.credit = st.tracker.tick(run_frac)

    done_idx = [i for i, l in enumerate(req_latency) if l >= 0.0]
    lat = np.asarray([req_latency[i] for i in done_idx])
    if obs_on:
        sched.time_s = wl.duration_s
        sched.capacity_s = C * wl.duration_s
        sched.useful_s = busy_time
        sched.switch_s = switch_time
        sched.switches = float(switches)
        sched.idle_s = max(sched.capacity_s - busy_time - switch_time, 0.0)
        sched.latency.record_many(lat)
        arrived_per_fn = np.bincount(
            np.asarray(req_fn, np.int64), minlength=wl.n_fns
        ) if req_fn else np.zeros(wl.n_fns, np.int64)
        done_per_fn = np.bincount(
            np.asarray([req_fn[i] for i in done_idx], np.int64),
            minlength=wl.n_fns,
        ) if done_idx else np.zeros(wl.n_fns, np.int64)
        for f in range(wl.n_fns):
            e = sched.entities.get(f)
            if e is None:
                e = sched.entities[f] = EntityStats()
            e.useful_s = float(fn_busy[f])
            e.switch_s = float(fn_switch_time[f])
            e.switches = float(fn_switches[f])
            e.arrived = int(arrived_per_fn[f])
            e.completed = int(done_per_fn[f])
    return SimResult(
        policy=policy.name,
        latencies=lat,
        fn_of=np.asarray([req_fn[i] for i in done_idx], np.int64),
        arrival_of=np.asarray([req_arrival[i] for i in done_idx]),
        n_arrived=n_arrived,
        n_completed=len(lat),
        switches=switches,
        switch_time_s=switch_time,
        busy_time_s=busy_time,
        duration_s=wl.duration_s,
        n_cores=C,
        schedstats=sched,
    )
