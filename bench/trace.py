"""The traced window: ``torch.profiler`` over it, reduced to device time.

``Trace`` holds the device's kernels, copies and sets (start, end, name)
inside the window, and the host's operations.  From them:

* ``busy_s``: the union of the device's intervals, in seconds;
* ``kernel_s(names)``: the summed device time of the kernels whose name
  holds one of ``names``;
* ``device_ops``: the ten device operations that took most time, by name;
* ``idle_gaps``: the gaps between the device's intervals, each labelled by
  the innermost host operation running at its middle, summed by label,
  the ten longest.
"""
from __future__ import annotations

import heapq
from collections import defaultdict

#: the span that marks the window in the trace
WINDOW = "bench.window"


def _events(prof):
    """[(name, start_us, end_us, on_device)] of every event."""
    out = []
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() / 1e3
        out.append((e.name(), s, s + e.duration_ns() / 1e3,
                    "CUDA" in str(e.device_type())))
    return out


class Trace:
    """``spans``: the names of the harness's own spans, which the
    profiler also shows on the device's timeline; they are left out of it."""

    def __init__(self, prof, spans=()):
        evs = _events(prof)
        win = [e for e in evs if e[0] == WINDOW and not e[3]]
        if not win:
            raise RuntimeError(f"the trace holds no {WINDOW!r} span")
        self.t0, self.t1 = win[0][1], win[0][2]
        self.window_s = (self.t1 - self.t0) / 1e6
        skip = {WINDOW, *spans}
        self.device = sorted((s, e, n) for n, s, e, d in evs
                             if d and n not in skip and e > self.t0
                             and s < self.t1)
        self.host = [(s, e, n) for n, s, e, d in evs
                     if not d and n != WINDOW and e > self.t0 and s < self.t1]
        self.merged = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if self.merged and s <= self.merged[-1][1]:
                self.merged[-1][1] = max(self.merged[-1][1], e)
            else:
                self.merged.append([s, e])
        self.busy_s = sum(e - s for s, e in self.merged) / 1e6

    def kernel_s(self, names) -> float:
        return sum(e - s for s, e, n in self.device
                   if any(k in n for k in names)) / 1e6

    def device_ops(self, top: int = 10):
        by = defaultdict(float)
        for s, e, n in self.device:
            by[n[:160]] += (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]

    def idle_gaps(self, top: int = 10):
        gaps, prev = [], self.t0
        for s, e in self.merged:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        host = sorted(self.host)
        by = defaultdict(float)
        active, i = [], 0  # a heap of the host operations open at mid
        for a, b in gaps:
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                s, e, n = host[i]
                heapq.heappush(active, (e, e - s, n))
                i += 1
            while active and active[0][0] < mid:
                heapq.heappop(active)
            label = (min(active, key=lambda x: x[1])[2] if active
                     else "host, outside any operation")
            by[label[:160]] += (b - a) / 1e6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda x: -x[1])[:top]
