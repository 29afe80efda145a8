"""Multi-tenant continuous-batching engine with LAGS admission.

The TPU-native integration of the paper (DESIGN.md §2): many function-like
tenants share one serving slice; every engine step decodes one token for each
running request (plus chunked prefills for newly admitted ones).  Changing
batch *membership* is the engine's context switch — it costs weight/adapter
HBM swaps, KV-page (re)allocation and dispatch overhead, and its frequency
and cost grow with tenant colocation exactly like ``schedule()`` in §3 of
the paper.  LAGS admission (lowest Load Credit, run-to-completion) reduces
both the rate and the per-switch cost versus fair round-robin admission.

Two execution backends:
  * ``step_cost_model`` (default) — calibrated analytic step times (CPU-fast;
    used by benchmarks to sweep density like Fig 3/9).
  * a real ``decode_step`` (``attach_model``): one token for every slot per
    engine step, on the decoder in ``repro_torch.models``.

Port of ``repro.serving.engine``.  ``Engine(cfg, tenants, device=...)`` runs
on the card unless ``device="cpu"`` is asked for.  At ``pallas_threshold``
tenants or more the per-step credit tick runs on the CUDA kernel
``lags_select`` (``_kernel_tick``, the counterpart of the reference's
``_pallas_tick``); on the CPU it runs the kernel's plain version.  The
reference's gate on ``pallas_backend.available()`` has no counterpart: the
kernel path is always there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import tracing as obs_tracing
from repro_torch.obs.schedstats import SchedStats
from repro_torch.device import resolve
from repro_torch.sched import cuda_backend
from repro_torch.scheduler.admission import pick_admissions, should_preempt
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.serving.kvcache import PagedAllocator


@dataclass
class EngineConfig:
    n_slots: int = 16  # concurrent decode streams
    n_pages: int = 4096
    page_tokens: int = 128
    policy: str = "lags"  # any repro_torch.sched.serving admission policy
    # LAGS preemption hysteresis (repro_torch.sched.protocol.credit_preempt): a
    # waiting tenant evicts a running one only when its credit is below
    # hysteresis * victim_credit.  The engine default demands a clear gap
    # (0.5) because a batch membership change is far costlier than the
    # kernel task switch the node simulators model with hysteresis 1.0.
    preempt_hysteresis: float = 0.5
    # route the per-step Load-Credit tick through the fused CUDA credit
    # kernel (repro_torch.sched.cuda_backend, kernels.lags_select) once the
    # tenant count reaches this threshold; 0 disables the kernel path
    # entirely.  The name is the reference's, so run scripts carry over.
    pallas_threshold: int = 256
    # step cost model (seconds)
    base_step_s: float = 0.010  # one decode step for a full batch
    per_prefill_tok_s: float = 2.0e-6
    swap_s_per_mb: float = 0.2e-3  # HBM weight/adapter swap on residency miss
    dispatch_s_per_member_change: float = 0.4e-3  # batch re-formation
    max_resident: int = 24  # tenants whose weights fit in HBM (LRU)
    credit_window: int = 256
    # -- graceful degradation (each knob 0 = off) ------------------------
    # admission deadline: a request still queued (never admitted) this many
    # sim-seconds after arrival is expired instead of served late
    admission_timeout_s: float = 0.0
    # out-of-pages rejections park the request with exponential backoff
    # (base * 2**(rejections-1), capped) instead of silently re-queueing it
    # at the head where it re-fails every step
    backoff_base_s: float = 0.02
    backoff_max_s: float = 0.5
    # overload shedding: when total queued work (tenant queues + parked)
    # exceeds the watermark, shed from the *highest-credit* tenants — the
    # most-served, i.e. lowest-priority work under LAGS admission (the
    # issue's "lowest-credit work" in admission-order terms: the work
    # admitted last).  ``drop`` discards newest requests; ``truncate``
    # halves ``max_new`` once per request instead of dropping.
    shed_watermark: int = 0
    shed_mode: str = "drop"  # "drop" | "truncate"


class EngineStats:
    """Engine accounting, backed by ``repro_torch.obs.schedstats.SchedStats``.

    The old ad-hoc fields survive as views onto the schedstats so existing
    callers (benchmarks, examples) keep working; the full per-tenant
    breakdown, latency/run-delay histograms and run-queue timeline live on
    ``.sched`` and are what ``repro_torch.obs.report`` consumes.
    """

    def __init__(self):
        self.sched = SchedStats("engine")
        self.time_s = 0.0
        self.steps = 0
        # steps that found no running request: they advance the clock and
        # tick no credit, so credit ticks == steps - idle_steps
        self.idle_steps = 0
        self.completed: List[Request] = []
        # graceful-degradation counters (also published as obs metrics
        # ``engine.shed`` / ``engine.expired`` / ``engine.backoff``)
        self.shed = 0
        self.expired = 0
        self.backoffs = 0
        # fencing counters (``engine.fenced_steps`` / ``engine.deferred``):
        # steps taken while fenced, and requests that arrived during a
        # fence — queued for later, not admitted (reconciled on unfence)
        self.fenced_steps = 0
        self.deferred = 0

    @property
    def fenced_s(self) -> float:
        return self.sched.fenced_s

    @property
    def useful_s(self) -> float:
        return self.sched.useful_s

    @property
    def switch_s(self) -> float:
        return self.sched.switch_s

    @property
    def membership_changes(self) -> int:
        return int(self.sched.switches)

    @property
    def overhead_frac(self) -> float:
        return self.switch_s / max(self.time_s, 1e-12)


class Engine:
    def __init__(self, cfg: EngineConfig, tenants: Dict[int, Tenant],
                 device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self.tenants = tenants
        self.alloc = PagedAllocator(cfg.n_pages, cfg.page_tokens)
        self.running: List[Request] = []
        self.stats = EngineStats()
        self._prev_members: set = set()
        self._resident: List[int] = []  # LRU order, most recent last
        self._parked: List[Request] = []  # backing off after page rejection
        self._fenced = False
        self._model = None

    # -- fencing ----------------------------------------------------------
    # The serving-side half of the controller's SUSPECT tier: while a node
    # is suspected (heartbeats overdue, progress still observed) no new
    # work is admitted, in-flight requests run to completion, and arrivals
    # queue up to reconcile once the fence lifts — the engine is *drained
    # of admissions*, not killed, so nothing is double-placed elsewhere.
    def fence(self):
        if not self._fenced:
            self._fenced = True
            obs_metrics.counter("engine.fence").inc()
            if obs_tracing.active():
                obs_tracing.tracer().emit(
                    "engine.fence", "engine", self.stats.time_s * 1e6, 0.0,
                    {"queued": sum(len(t.queue)
                                   for t in self.tenants.values())}, ph="i")

    def unfence(self):
        if self._fenced:
            self._fenced = False
            obs_metrics.counter("engine.unfence").inc()
            if obs_tracing.active():
                obs_tracing.tracer().emit(
                    "engine.unfence", "engine", self.stats.time_s * 1e6,
                    0.0,
                    {"queued": sum(len(t.queue)
                                   for t in self.tenants.values())}, ph="i")

    @property
    def fenced(self) -> bool:
        return self._fenced

    # -- optional real-model backend ------------------------------------
    def attach_model(self, model_cfg, params, max_len: int = 256):
        """Decode one token for every slot on each busy engine step.
        ``params`` come from ``repro_torch.models.params`` on this engine's
        device; the cache is made there too and updated in place."""
        from repro_torch.models import model as model_lib

        self._model = (model_cfg, params, max_len)
        self._cache = model_lib.init_cache(
            model_cfg, self.cfg.n_slots, max_len, device=self.device)
        self._tokens = torch.zeros((self.cfg.n_slots, 1), dtype=torch.int32,
                                   device=self.device)
        self._cache_len = 0
        self._decode = model_lib.decode_step

    def submit(self, req: Request):
        self.tenants[req.tenant].queue.append(req)
        self.stats.sched.account_arrival(req.tenant)
        if self._fenced:
            # arrivals during a fence are deferred, not dropped: they sit
            # in their tenant queue and reconcile once the fence lifts
            self.stats.deferred += 1
            obs_metrics.counter("engine.deferred").inc()

    # -- one engine step --------------------------------------------------
    def step(self):
        cfg = self.cfg
        st = self.stats

        # complete finished requests, free their pages
        still = []
        for r in self.running:
            if r.done:
                r.finish_time = st.time_s
                st.completed.append(r)
                st.sched.account_completion(r.tenant, r.latency)
                self.alloc.free(r.rid)
            else:
                still.append(r)
        self.running = still

        # graceful degradation: return parked requests whose backoff
        # expired, expire requests past their admission deadline, shed
        # overload beyond the queue-depth watermark.  A fenced engine does
        # none of it: parked/queued work is deferred inventory that must
        # survive the fence to reconcile afterwards, and admission is
        # closed anyway.
        if not self._fenced:
            if self._parked:
                self._unpark()
            if cfg.admission_timeout_s > 0:
                self._expire_queued()
            if cfg.shed_watermark > 0:
                self._shed_overload()

        # LAGS global path: lighter waiting tenant may evict a heavy one.
        # Fenced: no preemption (suspending a request would strand it
        # behind the closed admission door) and no admissions — in-flight
        # requests run to completion on the remaining steps.
        running_tids = {r.tenant for r in self.running}
        if not self._fenced:
            preempt, victim = should_preempt(
                cfg.policy, self.tenants, running_tids,
                cfg.preempt_hysteresis
            )
            if preempt and len(self.running) >= cfg.n_slots:
                # suspend one running request of the victim tenant: pages
                # and prefill state are KEPT (the Linux analogue: a
                # preempted thread resumes where it stopped; only the slot
                # is yielded)
                for i, r in enumerate(self.running):
                    if r.tenant == victim:
                        self.tenants[victim].queue.appendleft(r)
                        del self.running[i]
                        break

        # admit into free slots (page-limited)
        free = cfg.n_slots - len(self.running)
        admitted = [] if self._fenced else pick_admissions(
            cfg.policy, self.tenants, free, running_tids
        )
        prefill_toks = 0
        for idx, r in enumerate(admitted):
            if r.rid not in self.alloc.owner:  # resumed requests keep pages
                pages = self.alloc.allocate(r.rid, r.prompt_len + r.max_new)
                if pages is None:
                    # out of pages: park the rejected request with
                    # exponential backoff (the old silent ``appendleft``
                    # made it re-fail at the queue head every step), put
                    # the not-yet-tried admissions back, stop admitting
                    r.rejections += 1
                    r.backoff_until = st.time_s + min(
                        cfg.backoff_base_s * 2.0 ** (r.rejections - 1),
                        cfg.backoff_max_s,
                    )
                    self._parked.append(r)
                    st.backoffs += 1
                    obs_metrics.counter("engine.backoff").inc()
                    for later in reversed(admitted[idx + 1:]):
                        self.tenants[later.tenant].queue.appendleft(later)
                    break
            if r.start_time < 0:
                r.start_time = st.time_s
                # schedstat run delay: queued (runnable) -> first admission
                st.sched.account_run_delay(
                    r.tenant, max(st.time_s - r.arrival, 0.0)
                )
            prefill_toks += 0 if r.prefilled else r.prompt_len
            r.prefilled = True
            self.tenants[r.tenant].last_admit = st.time_s
            self.running.append(r)

        st.sched.sample_runq(
            st.time_s, sum(len(t.queue) for t in self.tenants.values())
        )
        if not self.running:
            st.time_s += cfg.base_step_s  # idle tick
            st.sched.account_time(cfg.base_step_s)
            st.sched.account_idle(cfg.base_step_s)
            st.steps += 1
            st.idle_steps += 1
            if self._fenced:
                st.fenced_steps += 1
                st.sched.account_fenced(cfg.base_step_s)
                obs_metrics.counter("engine.fenced_steps").inc()
            return

        # engine context switch: batch membership changed.  Weight swaps hit
        # only on a residency miss (HBM LRU) — LAGS's run-to-completion
        # clusters a tenant's work in time, raising the hit rate, exactly as
        # same-cgroup switches are cheap in the kernel (§3 / Fig 10).
        members = {r.tenant for r in self.running}
        change = members.symmetric_difference(self._prev_members)
        switch_s = 0.0
        if change:
            swap_mb = 0.0
            swapped: set = set()
            evicted: List[int] = []
            for t in members - self._prev_members:
                if t in self._resident:
                    self._resident.remove(t)  # refresh LRU position
                else:
                    swap_mb += self.tenants[t].weight_mb
                    swapped.add(t)
                self._resident.append(t)
            while len(self._resident) > cfg.max_resident:
                victim_t = next(
                    (x for x in self._resident if x not in members), None
                )
                if victim_t is None:
                    break
                self._resident.remove(victim_t)
                evicted.append(victim_t)
            switch_s = (
                cfg.swap_s_per_mb * swap_mb
                + cfg.dispatch_s_per_member_change * len(change)
            )
            if obs_tracing.active():
                self._trace_residency(swapped, evicted)
            # schedstat switch accounting: one "context switch" per changed
            # member; a residency hit is the cheap same-group analogue
            per_change = switch_s / len(change)
            for t in change:
                st.sched.account_switch(
                    t, per_change, same_group=t not in swapped
                )
            obs_metrics.counter("engine.membership_changes").inc(len(change))
        self._prev_members = members

        # step time: decode for the batch + chunked prefill work
        compute_s = cfg.base_step_s * (len(self.running) / cfg.n_slots) ** 0.5
        compute_s += cfg.per_prefill_tok_s * prefill_toks
        if self._model is not None:
            self._real_decode()

        step_s = compute_s + switch_s
        st.time_s += step_s
        st.sched.account_time(step_s)
        st.steps += 1
        if self._fenced:
            st.fenced_steps += 1
            st.sched.account_fenced(step_s)
            obs_metrics.counter("engine.fenced_steps").inc()
        if obs_tracing.active():
            # trace on the sim clock: one complete event per engine step
            obs_tracing.tracer().emit(
                "engine.step", "engine", (st.time_s - step_s) * 1e6,
                step_s * 1e6,
                {"batch": len(self.running), "switch_ms": switch_s * 1e3,
                 "prefill_toks": prefill_toks},
            )

        # progress: one token per running request
        service_per_req = compute_s / max(len(self.running), 1)
        served: Dict[int, float] = {}
        for r in self.running:
            r.generated += 1
            served[r.tenant] = served.get(r.tenant, 0.0) + service_per_req
        for tid, s in served.items():
            st.sched.account_useful(tid, s)
        if cfg.pallas_threshold and len(self.tenants) >= cfg.pallas_threshold:
            self._kernel_tick(served, step_s)
        else:
            for tid, t in self.tenants.items():
                t.tick(served.get(tid, 0.0), step_s, cfg.credit_window)

    # -- graceful degradation ---------------------------------------------
    def _unpark(self):
        """Return parked requests whose backoff expired to the head of
        their tenant queue (they were at the head when rejected); parked
        requests past the admission deadline expire in place."""
        cfg, st = self.cfg, self.stats
        now = st.time_s
        still: List[Request] = []
        for r in self._parked:
            if r.backoff_until > now:
                still.append(r)
            elif (cfg.admission_timeout_s > 0
                  and now - r.arrival > cfg.admission_timeout_s):
                st.expired += 1
                obs_metrics.counter("engine.expired").inc()
            else:
                self.tenants[r.tenant].queue.appendleft(r)
        self._parked = still

    def _expire_queued(self):
        """Drop queued requests whose admission deadline passed.  Requests
        that already ran (preempted, ``start_time >= 0``) are kept — the
        deadline bounds time-to-first-service, not total residence."""
        cfg, st = self.cfg, self.stats
        now = st.time_s
        dropped = 0
        for t in self.tenants.values():
            if not t.queue:
                continue
            keep = [r for r in t.queue
                    if r.start_time >= 0
                    or now - r.arrival <= cfg.admission_timeout_s]
            if len(keep) != len(t.queue):
                dropped += len(t.queue) - len(keep)
                t.queue.clear()
                t.queue.extend(keep)
        if dropped:
            st.expired += dropped
            obs_metrics.counter("engine.expired").inc(dropped)
            if obs_tracing.active():
                obs_tracing.tracer().emit(
                    "engine.expire", "engine", now * 1e6, 0.0,
                    {"dropped": dropped}, ph="i",
                )

    def _shed_overload(self):
        """Past the queue-depth watermark, shed from the highest-credit
        (most-served — the lowest-priority work under LAGS admission
        order) tenants: ``drop`` discards their newest queued requests
        until the depth is back at the watermark; ``truncate`` halves
        ``max_new`` (once per request) on the same number of requests."""
        cfg, st = self.cfg, self.stats
        depth = sum(len(t.queue) for t in self.tenants.values()) \
            + len(self._parked)
        excess = depth - cfg.shed_watermark
        if excess <= 0:
            return
        shed = 0
        order = sorted(self.tenants.values(),
                       key=lambda t: (-t.credit, -t.tid))
        if cfg.shed_mode == "drop":
            for t in order:
                while shed < excess and t.queue:
                    # newest first: requests already waiting keep their turn
                    if t.queue[-1].start_time >= 0:
                        break  # preempted mid-flight work is never shed
                    t.queue.pop()
                    shed += 1
                if shed >= excess:
                    break
        elif cfg.shed_mode == "truncate":
            for t in order:
                for r in t.queue:
                    if shed >= excess:
                        break
                    if not r.truncated and r.generated == 0 and r.max_new > 1:
                        r.max_new = max(1, r.max_new // 2)
                        r.truncated = True
                        shed += 1
                if shed >= excess:
                    break
        else:
            raise ValueError(
                f"unknown shed_mode {cfg.shed_mode!r} (drop|truncate)")
        if shed:
            st.shed += shed
            obs_metrics.counter("engine.shed").inc(shed)
            if obs_tracing.active():
                obs_tracing.tracer().emit(
                    "engine.shed", "engine", st.time_s * 1e6, 0.0,
                    {"mode": cfg.shed_mode, "shed": shed, "depth": depth},
                    ph="i",
                )

    def _kernel_tick(self, served: Dict[int, float], step_s: float):
        """Per-step Load-Credit tick via the fused CUDA kernel.

        The counterpart of the reference's ``_pallas_tick``.  One kernel
        launch replaces the O(T) Python PELT/EMA loop at high tenant counts.
        Same update rule as ``Tenant.tick``, in f32: the tenant state goes
        f64 -> f32 -> f64 at the same points as in the reference, so the two
        engines' credits do not drift apart over many steps.  The picks are
        discarded, as the reference does: ``pick_admissions`` orders the
        admissions next step.
        """
        cfg = self.cfg
        tids = sorted(self.tenants)
        load = np.asarray([self.tenants[t].load_avg for t in tids])
        cred = np.asarray([self.tenants[t].credit for t in tids])
        frac = np.asarray(
            [served.get(t, 0.0) / max(step_s, 1e-9) for t in tids]
        )
        runnable = np.asarray(
            [bool(self.tenants[t].queue) for t in tids], bool
        )
        new_load, new_cred, _picks = cuda_backend.tick_and_pick(
            load, cred, frac, runnable, cfg.n_slots,
            window=cfg.credit_window, device=self.device,
        )
        for i, tid in enumerate(tids):
            t = self.tenants[tid]
            t.load_avg = float(new_load[i])
            t.credit = float(new_cred[i])
            t.served_s += served.get(tid, 0.0)

    def _trace_residency(self, swapped: set, evicted: List[int]):
        """Perfetto events for HBM residency churn, on the sim clock:
        one instant per weight swap (tenant + bytes) and a counter track
        sampling HBM occupancy after the LRU update."""
        tr = obs_tracing.tracer()
        now_us = self.stats.time_s * 1e6
        for t in sorted(swapped):
            tr.emit(
                "hbm.swap_in", "residency", now_us, 0.0,
                {"tenant": t, "mb": self.tenants[t].weight_mb}, ph="i",
            )
        for t in evicted:
            tr.emit(
                "hbm.evict", "residency", now_us, 0.0,
                {"tenant": t, "mb": self.tenants[t].weight_mb}, ph="i",
            )
        tr.emit(
            "hbm.resident", "counter", now_us, 0.0,
            {
                "tenants": len(self._resident),
                "mb": sum(self.tenants[x].weight_mb for x in self._resident),
            },
            ph="C",
        )
        obs_metrics.counter("engine.hbm_swaps").inc(len(swapped))
        obs_metrics.counter("engine.hbm_evictions").inc(len(evicted))

    def _real_decode(self):
        model_cfg, params, max_len = self._model
        if self._cache_len >= max_len - 1:
            return
        logits, self._cache = self._decode(
            params, model_cfg, {"tokens": self._tokens}, self._cache,
            self._cache_len, device=self.device,
        )
        self._tokens = torch.argmax(logits, -1)[:, None].to(torch.int32)
        self._cache_len += 1

    def run(self, until_s: float, arrivals: Optional[List[Request]] = None,
            checkpoint_every_s: float = 0.0, on_checkpoint=None,
            fence_windows: Optional[List] = None):
        """Drive the engine until ``until_s`` sim-seconds, feeding arrivals.

        ``on_checkpoint(stats)`` fires every ``checkpoint_every_s``
        sim-seconds (when both are given) so a live run can stream
        schedstats snapshots — e.g. periodic ``record_run`` checkpoints a
        ``repro_torch.obs.report`` invocation can watch while the run is going.

        ``fence_windows`` is a list of ``(t0, t1)`` sim-second intervals
        during which the engine is fenced (suspected by its controller):
        no admissions, in-flight work completes, arrivals defer — the
        single-engine rehearsal of the fleet controller's SUSPECT tier.
        """
        arrivals = sorted(arrivals or [], key=lambda r: r.arrival)
        windows = sorted(
            (float(a), float(b)) for a, b in (fence_windows or []))
        for a, b in windows:
            if b <= a:
                raise ValueError(f"empty fence window [{a}, {b})")
        ai = 0
        next_ckpt = (
            checkpoint_every_s
            if checkpoint_every_s > 0 and on_checkpoint is not None
            else float("inf")
        )
        while self.stats.time_s < until_s:
            now = self.stats.time_s
            if windows:
                in_fence = any(a <= now < b for a, b in windows)
                if in_fence and not self._fenced:
                    self.fence()
                elif not in_fence and self._fenced:
                    self.unfence()
            while ai < len(arrivals) and arrivals[ai].arrival <= self.stats.time_s:
                self.submit(arrivals[ai])
                ai += 1
            self.step()
            if self.stats.time_s >= next_ckpt:
                on_checkpoint(self.stats)
                while next_ckpt <= self.stats.time_s:
                    next_ckpt += checkpoint_every_s
        if windows and self._fenced:
            self.unfence()
        return self.stats
