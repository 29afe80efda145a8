"""Run recording: persist one run's telemetry as a diffable artifact.

A *run record* is a directory holding ``run.json`` (meta + schedstats +
metrics-registry snapshot) and optionally ``trace.json`` (Chrome trace
events).  ``repro_torch.obs.report`` consumes these to summarize a run or
diff two
(e.g. a lags run against a fair run of ``launch/serve.py``).

Copy of ``repro.obs.recorder``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

import json
import os
from typing import Optional

from repro_torch.obs import metrics as metrics_mod
from repro_torch.obs import tracing as tracing_mod
from repro_torch.obs.schedstats import SchedStats

RUN_FILE = "run.json"
TRACE_FILE = "trace.json"


def record_run(
    out_dir: str,
    meta: dict,
    sched: Optional[SchedStats] = None,
    include_registry: bool = True,
    tracer: Optional[tracing_mod.Tracer] = None,
    chaos: Optional[dict] = None,
) -> str:
    """Write a run record; returns the path of ``run.json``.

    ``tracer`` defaults to the installed process tracer (if any); pass a
    tracer explicitly to export one you drove by hand.  ``chaos`` attaches
    a failover report (``repro_torch.fleet.rebalance.ChaosFleetResult.report()``)
    that ``repro_torch.obs.report`` renders as the ``failover:`` section.
    """
    os.makedirs(out_dir, exist_ok=True)
    obj = {
        "version": 1,
        "meta": dict(meta),
        "schedstats": sched.snapshot() if sched is not None else None,
        "metrics": (
            metrics_mod.registry().snapshot() if include_registry else {}
        ),
    }
    if chaos is not None:
        obj["chaos"] = dict(chaos)
    if tracer is None:
        tracer = tracing_mod.tracer()
    if tracer is not None and len(tracer):
        tracer.export(os.path.join(out_dir, TRACE_FILE))
        obj["trace_file"] = TRACE_FILE
    path = os.path.join(out_dir, RUN_FILE)
    with open(path, "w") as f:
        json.dump(obj, f)
    return path


def load_run(path: str) -> dict:
    """Load a run record from a directory or a run.json path.  The parsed
    schedstats snapshot is rehydrated under the ``"sched"`` key."""
    if os.path.isdir(path):
        path = os.path.join(path, RUN_FILE)
    with open(path) as f:
        obj = json.load(f)
    snap = obj.get("schedstats")
    obj["sched"] = SchedStats.from_snapshot(snap) if snap else None
    obj["path"] = path
    return obj
