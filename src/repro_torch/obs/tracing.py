"""Bounded ring-buffer event tracer with Chrome trace-event JSON export.

Spans are recorded as complete ("ph": "X") trace events into a fixed-size
ring; ``export()`` writes the Chrome trace-event format that Perfetto /
chrome://tracing load directly.  ``fenced_span`` is the device-aware timer:
the caller registers output tensors on the fence and, when one of them lies
on a card, the span closes only after ``torch.cuda.synchronize()`` —
otherwise asynchronous launches make a CUDA step look ~free.

The tracer is off unless installed (``install()``); the module-level
``span``/``fenced_span`` helpers degrade to no-ops, so instrumented hot
paths cost one check per call when tracing is disabled.

Port of ``repro.obs.tracing``: a copy apart from the fence in
``Span.__exit__``.
"""
from __future__ import annotations

import json
import time
from collections import deque
from typing import Deque, List, Optional

import torch

from repro_torch.obs import metrics as _metrics


def _on_cuda(x) -> bool:
    """True when ``x`` (a tensor, or a list/tuple/dict of them) holds a
    tensor on a CUDA device."""
    if isinstance(x, torch.Tensor):
        return x.is_cuda
    if isinstance(x, dict):
        return any(_on_cuda(v) for v in x.values())
    if isinstance(x, (list, tuple)):
        return any(_on_cuda(v) for v in x)
    return False


class Span:
    """Context manager for one complete trace event.

    Also usable as the fence for device work: call the span with the output
    tensors to wait on (``fence(x)`` returns ``x``), and the duration is
    measured after ``torch.cuda.synchronize()`` when one of them is on a
    card.  ``dur_s`` is valid after exit
    even when the owning tracer is a no-op, so callers can feed metrics.
    """

    __slots__ = ("tracer", "name", "cat", "args", "fenced", "_pending",
                 "_t0_ns", "dur_s")

    def __init__(self, tracer: Optional["Tracer"], name: str, cat: str,
                 fenced: bool = False, **args):
        self.tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self.fenced = fenced
        self._pending: List[object] = []
        self._t0_ns = 0
        self.dur_s = 0.0

    def __call__(self, x):
        if self.fenced:
            self._pending.append(x)
        return x

    def __enter__(self) -> "Span":
        self._t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> None:
        if self._pending:
            # ``jax.block_until_ready`` in the reference; it does not wait on
            # a torch tensor, so a CUDA tensor fences the whole device
            if _on_cuda(self._pending):
                torch.cuda.synchronize()
            self._pending.clear()
        dt_ns = time.perf_counter_ns() - self._t0_ns
        self.dur_s = dt_ns * 1e-9
        if self.tracer is not None:
            self.tracer.emit(
                self.name, self.cat,
                (self._t0_ns - self.tracer._t0_ns) / 1e3, dt_ns / 1e3,
                self.args,
            )


class Tracer:
    """Fixed-capacity ring buffer of Chrome trace events (oldest dropped)."""

    def __init__(self, capacity: int = 65536, pid: int = 0):
        self.capacity = capacity
        self.pid = pid
        self._events: Deque[dict] = deque(maxlen=capacity)
        self._t0_ns = time.perf_counter_ns()
        self.dropped = 0

    def __len__(self) -> int:
        return len(self._events)

    def now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def emit(self, name: str, cat: str, ts_us: float, dur_us: float,
             args: Optional[dict] = None, ph: str = "X", tid: int = 0) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        ev = {
            "name": name, "cat": cat, "ph": ph,
            "ts": ts_us, "pid": self.pid, "tid": tid,
        }
        if ph == "X":
            ev["dur"] = dur_us
        if args:
            ev["args"] = dict(args)
        self._events.append(ev)

    def span(self, name: str, cat: str = "obs", **args) -> Span:
        return Span(self, name, cat, **args)

    def fenced_span(self, name: str, cat: str = "cuda", **args) -> Span:
        return Span(self, name, cat, fenced=True, **args)

    def instant(self, name: str, cat: str = "obs", **args) -> None:
        self.emit(name, cat, self.now_us(), 0.0, args, ph="i")

    def counter(self, name: str, **series: float) -> None:
        """Chrome counter-track sample (renders as a stacked area chart)."""
        self.emit(name, "counter", self.now_us(), 0.0, series, ph="C")

    def events(self) -> List[dict]:
        return sorted(self._events, key=lambda e: e["ts"])

    def export(self, path: Optional[str] = None) -> dict:
        obj = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": self.dropped},
        }
        if path is not None:
            with open(path, "w") as f:
                json.dump(obj, f)
        return obj


_TRACER: Optional[Tracer] = None

_NULL_SPAN_ARGS = dict(tracer=None, name="", cat="")


def install(capacity: int = 65536) -> Tracer:
    """Install (or replace) the process tracer and enable telemetry."""
    global _TRACER
    _TRACER = Tracer(capacity)
    _metrics.enable()
    return _TRACER


def uninstall() -> None:
    global _TRACER
    _TRACER = None


def tracer() -> Optional[Tracer]:
    return _TRACER


def active() -> bool:
    return _TRACER is not None and _metrics.enabled()


def span(name: str, cat: str = "obs", **args) -> Span:
    t = _TRACER if active() else None
    return Span(t, name, cat, **args)


def fenced_span(name: str, cat: str = "cuda", **args) -> Span:
    # Fence only when telemetry is on: an unconditional synchronize
    # would serialize async dispatch even with observability disabled.
    t = _TRACER if active() else None
    return Span(t, name, cat, fenced=_metrics.enabled(), **args)
