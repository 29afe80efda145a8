"""repro_torch.obs — shared observability: metrics, tracing, schedstats,
reports.

One subsystem backs every execution layer's accounting (DES oracle, tick
simulator, serving engine, train loop) so policy comparisons are exportable
and diffable instead of hand-rolled printouts:

  * ``metrics``    — process-wide counters/gauges/log-bucketed histograms
  * ``tracing``    — bounded ring-buffer tracer, Chrome trace-event export
  * ``schedstats`` — per-tenant/per-function scheduling accounting
  * ``recorder``   — persist a run as a diffable ``run.json`` (+ trace)
  * ``report``     — ``python -m repro_torch.obs.report`` summaries and run
    diffs

Telemetry is opt-in: ``obs.enable()`` turns on the registry helpers;
``obs.install_tracer()`` additionally captures trace events.  Disabled-path
cost is one branch per instrumented call site.

Copy of ``repro.obs``: the port imports nothing of ``repro``.
"""
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    counter,
    disable,
    enable,
    enabled,
    gauge,
    histogram,
    registry,
)
from repro_torch.obs.schedstats import EntityStats, SchedStats  # noqa: F401
from repro_torch.obs.tracing import (  # noqa: F401
    Tracer,
    fenced_span,
    span,
    tracer,
)
from repro_torch.obs.tracing import install as install_tracer  # noqa: F401
from repro_torch.obs.tracing import uninstall as uninstall_tracer  # noqa: F401

__all__ = [
    "Counter", "Gauge", "Histogram", "SchedStats", "EntityStats", "Tracer",
    "counter", "gauge", "histogram", "registry", "enable", "disable",
    "enabled", "span", "fenced_span", "tracer", "install_tracer",
    "uninstall_tracer",
]
