"""Exact event-driven node simulator — the oracle for ``simkernel``.

Event granularity: arrivals, completions, quantum expiries.  No statistical
burst model (use ``simkernel`` for overhead studies); this engine validates
scheduling ORDER and latency semantics of each policy on small cases:
work conservation, group fairness under CFS, run-to-completion order under
LAGS, RT preemption under LAGS-static.

Copy of ``repro.core.des``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.core import load_credit as lc
from repro_torch.obs.schedstats import SchedStats
from repro_torch.sched import Policy

TICK = lc.TICK_SEC


@dataclass(order=True)
class _Event:
    time: float
    seq: int
    kind: str = field(compare=False)  # arrive | quantum | tick
    payload: tuple = field(compare=False, default=())


@dataclass
class Request:
    fn: int
    arrival: float
    demand: float
    remaining: float
    completion: float = -1.0
    first_run: float = -1.0


class EventSim:
    """Single run queue, ``n_cores`` cores, exact preemptive scheduling."""

    def __init__(self, n_fns: int, n_cores: int, policy: Policy,
                 window: int = 1000):
        self.n_fns = n_fns
        self.n_cores = n_cores
        self.policy = policy
        self.tracker = lc.LoadCreditTracker(n_fns, window_ticks=window)
        self.fn_vrt = np.zeros(n_fns)
        self.requests: List[Request] = []
        self.running: dict = {}  # core -> request idx
        self.runnable: set = set()
        self.now = 0.0
        self._seq = 0
        self.events: list = []
        # schedstats-backed accounting (order switches, run delay, useful
        # seconds per function); the DES models switch cost as zero — it is
        # the ORDER oracle — so switch_s stays 0 here by design.
        self.sched = SchedStats("des")

    @property
    def switches(self) -> int:
        return int(self.sched.switches)

    def submit(self, fn: int, t: float, demand: float):
        i = len(self.requests)
        self.requests.append(Request(fn, t, demand, demand))
        self.sched.account_arrival(fn)
        self._push(t, "arrive", (i,))

    def _push(self, t, kind, payload=()):
        self._seq += 1
        heapq.heappush(self.events, _Event(t, self._seq, kind, payload))

    # --- policy keys on request granularity -------------------------------
    def _key(self, i: int):
        r = self.requests[i]
        return self.policy.request_key(
            self.tracker.credit, self.fn_vrt, r.fn, r.arrival, i
        )

    def _reschedule(self):
        """Assign cores to the |cores| best runnable requests (preemptive)."""
        cand = sorted(self.runnable, key=self._key)
        chosen = cand[: self.n_cores]
        prev = dict(self.running)
        self.running = {}
        used_cores = set()
        # keep requests on their previous cores when still chosen
        for c, i in prev.items():
            if i in chosen:
                self.running[c] = i
                used_cores.add(c)
                chosen.remove(i)
        free = [c for c in range(self.n_cores) if c not in used_cores]
        for c, i in zip(free, chosen):
            self.running[c] = i
            r = self.requests[i]
            if prev.get(c) != i:
                same = prev.get(c) is not None and \
                    self.requests[prev[c]].fn == r.fn
                self.sched.account_switch(r.fn, 0.0, same_group=same)
            if r.first_run < 0:
                r.first_run = self.now
                self.sched.account_run_delay(r.fn, self.now - r.arrival)
        self.sched.sample_runq(self.now, len(self.runnable))

    def _advance(self, dt: float):
        if dt <= 0:
            return
        for c, i in self.running.items():
            r = self.requests[i]
            r.remaining -= dt
            self.fn_vrt[r.fn] += dt
            self.sched.account_useful(r.fn, dt)
        frac = np.zeros(self.n_fns)
        for c, i in self.running.items():
            frac[self.requests[i].fn] += 1.0
        # fractional-tick PELT update
        steps = dt / TICK
        y = lc.pelt_decay() ** steps
        a = 1.0 - (1.0 - 2.0 / (self.tracker.window_ticks + 1.0)) ** steps
        self.tracker.load_avg = y * self.tracker.load_avg + (1 - y) * frac
        self.tracker.credit = (
            (1 - a) * self.tracker.credit + a * self.tracker.load_avg
        )

    def run(self, until: float):
        self._push(until, "end")
        while self.events:
            ev = heapq.heappop(self.events)
            # next completion may occur before the next event
            while True:
                t_next = ev.time
                soonest, who = np.inf, None
                for c, i in self.running.items():
                    t_done = self.now + self.requests[i].remaining
                    if t_done < soonest:
                        soonest, who = t_done, i
                if who is None or soonest > t_next + 1e-12:
                    break
                self._advance(soonest - self.now)
                self.now = soonest
                r = self.requests[who]
                r.remaining = 0.0
                r.completion = self.now
                self.sched.account_completion(r.fn, self.now - r.arrival)
                self.runnable.discard(who)
                self._reschedule()
            self._advance(ev.time - self.now)
            self.now = ev.time
            if ev.kind == "end":
                break
            if ev.kind == "arrive":
                (i,) = ev.payload
                self.runnable.add(i)
                self._reschedule()
            elif ev.kind == "quantum":
                self._reschedule()
            # time-slice rotation whenever the node is oversubscribed
            if len(self.runnable) > self.n_cores:
                self._push(
                    self.now + self.policy.slice_ticks * TICK, "quantum"
                )
        self.sched.account_time(self.now - self.sched.time_s)
        self.sched.capacity_s = self.n_cores * self.now
        self.sched.idle_s = max(
            self.sched.capacity_s - self.sched.useful_s, 0.0
        )
        lat = np.asarray(
            [r.completion - r.arrival for r in self.requests if r.completion >= 0]
        )
        return lat
