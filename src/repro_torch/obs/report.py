"""Run summaries, run-vs-run diffs and fleet merges over recorded telemetry.

  PYTHONPATH=src python -m repro_torch.obs.report RUNDIR            # summarize
  PYTHONPATH=src python -m repro_torch.obs.report --diff A B        # compare runs
  PYTHONPATH=src python -m repro_torch.obs.report RUNDIR --top 5    # busiest tenants
  PYTHONPATH=src python -m repro_torch.obs.report --merge D1 D2 ... # one fleet view

The diff is the paper's evaluation loop in one command: record a lags run
and a fair run of ``launch/serve.py`` (``--obs-dir``), then diff them to get
per-policy switch-time share, switch rate/cost, and latency-tail deltas.

``--merge`` folds many per-node / per-shard run records (fleet node
records from ``repro_torch.fleet.simulate_fleet(record_dir=...)``, or
several
``launch/serve.py --obs-dir`` shards) into a single fleet view: totals and
per-entity stats summed, histograms merged bucket-wise, plus a per-shard
breakdown table.

Copy of ``repro.obs.report``: the port imports nothing of ``repro``; for
the same records it prints the same text.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from repro_torch.obs.recorder import load_run
from repro_torch.obs.schedstats import SchedStats


def _fmt(v: Optional[float], unit: str = "") -> str:
    if v is None or v != v:  # NaN
        return "-"
    if unit == "%":
        return f"{100.0 * v:.2f}%"
    if unit == "us":
        return f"{v:.1f}us"
    if unit == "s":
        return f"{v:.3f}s"
    return f"{v:.3f}"


def _table(headers: List[str], rows: List[List[str]]) -> str:
    widths = [max(len(h), *(len(r[i]) for r in rows)) if rows else len(h)
              for i, h in enumerate(headers)]
    def line(cells):
        return "  ".join(c.ljust(w) for c, w in zip(cells, widths)).rstrip()
    sep = "  ".join("-" * w for w in widths)
    return "\n".join([line(headers), sep] + [line(r) for r in rows])


def _key_rows(sched: SchedStats) -> List[tuple]:
    lat, rdel = sched.latency, sched.run_delay
    return [
        ("time_s", sched.time_s, "s"),
        ("useful_s", sched.useful_s, "s"),
        ("switch_s", sched.switch_s, "s"),
        ("fenced_s", sched.fenced_s, "s"),
        ("switch_share", sched.switch_share, "%"),
        ("switches", sched.switches, ""),
        ("switch_rate_hz", sched.switch_rate(), ""),
        ("mean_switch_cost", 1e-6 * sched.mean_switch_cost_us, "s"),
        ("p99_switch_cost", 1e-6 * sched.switch_cost_us.pct(99), "s"),
        ("p50_latency", lat.pct(50), "s"),
        ("p95_latency", lat.pct(95), "s"),
        ("p99_latency", lat.pct(99), "s"),
        ("completed", lat.count, ""),
        ("p95_run_delay", rdel.pct(95), "s"),
        ("runq_peak", sched.runq_peak(), ""),
    ]


def _fault_node(e: dict) -> str:
    """Render a fault event's scope: a node, a rack, a node set or fleet."""
    if e.get("rack", -1) >= 0:
        return f"rack{e['rack']}"
    nodes = e.get("nodes") or []
    if nodes:
        return ",".join(str(n) for n in nodes)
    return "fleet" if e.get("node", -1) < 0 else str(e.get("node"))


def _failover_section(ch: dict) -> List[str]:
    """Render a chaos/failover report (attached by
    ``repro_torch.fleet.record_chaos``): what was injected, what moved, how fast
    the fleet recovered, and SLO attainment inside degraded windows.

    A fault-free chaos record (empty schedule) renders ``∅`` for every
    fault-derived metric instead of degenerate zeros — 0 migrations after
    an injected crash and 0 migrations because nothing was injected are
    different facts, and recovery/SLO math over no faults is meaningless.
    """
    evs = ch.get("events", [])
    if not evs:
        rows = [
            ["injected events", "∅ (fault-free run)"],
            ["epochs",
             f"{ch.get('epochs')} x {_fmt(ch.get('epoch_s'), 's')}"],
            ["migrations", "∅"],
            ["stranded/replayed", "∅"],
            ["recovery", "∅"],
            ["degraded_slo_attainment", "∅"],
            ["completed/arrived",
             f"{ch.get('completed')}/{ch.get('arrived')} "
             f"({_fmt(ch.get('done_ratio'), '%')})"],
        ]
        return ["", "failover: ∅", _table(["metric", "value"], rows)]
    erows = [
        [_fmt(e.get("t"), "s"), str(e.get("kind")), _fault_node(e),
         _fmt(e.get("factor"))]
        for e in evs
    ]
    rec = ch.get("recovery_s", {}) or {}
    rec_txt = ", ".join(
        f"node{n}={'never' if v is None else _fmt(v, 's')}"
        for n, v in sorted(rec.items())
    ) or "∅ (no node crashed)"
    rows = [
        ["epochs", f"{ch.get('epochs')} x {_fmt(ch.get('epoch_s'), 's')}"],
        ["rebalanced", str(ch.get("rebalanced"))],
        ["migrations", str(ch.get("migrations", 0))],
        ["migration_s", _fmt(ch.get("migration_s"), "s")],
        ["stranded/replayed",
         f"{ch.get('stranded_arrivals', 0)}/{ch.get('replayed_arrivals', 0)}"],
        ["lost_arrivals", str(ch.get("lost_arrivals", 0))],
        ["completed/arrived",
         f"{ch.get('completed')}/{ch.get('arrived')} "
         f"({_fmt(ch.get('done_ratio'), '%')})"],
        ["recovery", rec_txt],
        ["degraded_slo_attainment",
         _fmt(ch.get("degraded_slo_attainment"), "%")],
    ]
    drained = ch.get("stragglers_drained") or []
    if drained:
        rows.append(["stragglers_drained",
                     ", ".join(str(s) for s in drained)])
    # topology-aware liveness ladder: only rendered when the run exercised
    # it (suspects seen, arrivals deferred off fenced nodes, or the
    # proactive drainer touched a node)
    suspects = ch.get("suspect_nodes") or []
    if suspects:
        rows.append(["suspect_nodes",
                     ", ".join(str(s) for s in suspects)])
    fenced = ch.get("fenced_nodes") or []
    if fenced:
        rows.append(["fenced_nodes", ", ".join(str(s) for s in fenced)])
        rows.append(["deferred/reconciled",
                     f"{ch.get('deferred_arrivals', 0)}"
                     f"/{ch.get('reconciled', 0)}"])
    pro_drained = ch.get("drained_nodes") or []
    if ch.get("proactive_drain"):
        rows.append(["proactive_drained",
                     ", ".join(str(s) for s in pro_drained) or "∅"])
    out = ["", "failover:", _table(["metric", "value"], rows)]
    out += ["", "injected events:",
            _table(["t", "kind", "node", "factor"], erows)]
    counts = ch.get("per_epoch_counts") or []
    if counts:
        out += ["", "per-epoch node fn counts:"]
        out += [f"  epoch {i}: {c}" for i, c in enumerate(counts)]
    live = ch.get("per_epoch_liveness") or []
    if live and (suspects or fenced or pro_drained):
        out += ["", "per-epoch liveness (live/suspect/fenced/draining):"]
        out += [f"  epoch {i}: {lv['live']}/{lv['suspect']}"
                f"/{lv['fenced']}/{lv['draining']}"
                for i, lv in enumerate(live)]
    return out


def summarize(run: dict, top: int = 0) -> str:
    meta = run.get("meta", {})
    sched: Optional[SchedStats] = run.get("sched")
    chaos = run.get("chaos")
    head = " ".join(f"{k}={v}" for k, v in sorted(meta.items()))
    out = [f"run: {head}" if head else "run: (no meta)"]
    if sched is None:
        out.append("(no schedstats recorded)")
        if chaos:
            out.extend(_failover_section(chaos))
        return "\n".join(out)
    rows = [[name, _fmt(val, unit)] for name, val, unit in _key_rows(sched)]
    out.append(_table(["metric", "value"], rows))
    if chaos:
        out.extend(_failover_section(chaos))
    if top > 0 and sched.entities:
        ents = sorted(sched.entities.items(),
                      key=lambda kv: kv[1].useful_s, reverse=True)[:top]
        erows = [
            [str(tid), _fmt(e.useful_s, "s"), _fmt(e.switch_s, "s"),
             _fmt(e.switches), _fmt(e.run_delay_s, "s"),
             f"{e.completed}/{e.arrived}" if e.arrived else str(e.completed)]
            for tid, e in ents
        ]
        out.append("")
        out.append(f"top {len(ents)} entities by useful_s:")
        out.append(_table(
            ["entity", "useful_s", "switch_s", "switches", "run_delay_s",
             "done"], erows))
    return "\n".join(out)


def merge(runs: List[dict]) -> str:
    """One fleet view over many per-node/per-shard run records."""
    scheds = [r.get("sched") for r in runs]
    missing = [r.get("path", "?") for r, s in zip(runs, scheds) if s is None]
    if missing:
        return f"merge requires schedstats in every run; missing in {missing}"
    merged = SchedStats.merged(scheds)
    metas = [r.get("meta", {}) for r in runs]
    policies = sorted({str(m.get("policy")) for m in metas if "policy" in m})
    head = [f"fleet view: {len(runs)} run records merged"]
    if policies:
        head.append(f"policies: {', '.join(policies)}")
    srows = []
    for r, s, m in zip(runs, scheds, metas):
        label = str(
            m.get("shard", m.get("node", os.path.basename(
                os.path.dirname(r.get("path", "run")))))
        )
        srows.append([
            label, str(m.get("policy", "-")), _fmt(s.time_s, "s"),
            _fmt(s.switch_share, "%"), _fmt(s.latency.pct(95), "s"),
            _fmt(s.latency.count),
        ])
    out = [
        " | ".join(head),
        "",
        "per-shard:",
        _table(["shard", "policy", "time_s", "switch_share", "p95_latency",
                "completed"], srows),
        "",
        "merged:",
        _table(["metric", "value"],
               [[name, _fmt(val, unit)]
                for name, val, unit in _key_rows(merged)]),
    ]
    # a chaos fleet's top-level record carries the failover report — keep
    # it visible in the merged fleet view too
    for r in runs:
        if r.get("chaos"):
            out.extend(_failover_section(r["chaos"]))
            break
    return "\n".join(out)


def diff(run_a: dict, run_b: dict) -> str:
    """Side-by-side comparison; delta column is B - A (negative = B lower)."""
    sa, sb = run_a.get("sched"), run_b.get("sched")
    if sa is None or sb is None:
        return "diff requires schedstats in both runs"
    la = str(run_a.get("meta", {}).get("policy", "A"))
    lb = str(run_b.get("meta", {}).get("policy", "B"))
    if la == lb:
        la, lb = f"{la}(A)", f"{lb}(B)"
    rows = []
    for (name, va, unit), (_, vb, _) in zip(_key_rows(sa), _key_rows(sb)):
        d = vb - va if va == va and vb == vb else float("nan")
        rows.append([name, _fmt(va, unit), _fmt(vb, unit), _fmt(d, unit)])
    out = [
        f"diff: {la} -> {lb}",
        _table(["metric", la, lb, f"delta({lb}-{la})"], rows),
    ]
    if sa.switch_share == sa.switch_share and sb.switch_share == sb.switch_share:
        lo = la if sa.switch_share <= sb.switch_share else lb
        out.append(f"lower switch-time share: {lo}")
    return "\n".join(out)


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize or diff recorded obs runs.",
    )
    ap.add_argument("runs", nargs="*", help="run dir(s) or run.json path(s)")
    ap.add_argument("--diff", action="store_true",
                    help="compare exactly two runs (delta = second - first)")
    ap.add_argument("--merge", action="store_true",
                    help="merge all given runs into one fleet view")
    ap.add_argument("--top", type=int, default=0,
                    help="also list the N busiest entities (summary mode)")
    args = ap.parse_args(argv)
    if args.diff and args.merge:
        ap.error("--diff and --merge are mutually exclusive")

    def _load(path):
        try:
            return load_run(path)
        except FileNotFoundError:
            ap.error(f"no run record at {path!r} (expected a dir with "
                     f"run.json, or a run.json path)")
        except (OSError, ValueError) as e:
            ap.error(f"could not read run record {path!r}: {e}")

    if args.diff:
        if len(args.runs) != 2:
            ap.error("--diff takes exactly two run paths")
        text = diff(_load(args.runs[0]), _load(args.runs[1]))
    elif args.merge:
        if len(args.runs) < 2:
            ap.error("--merge takes at least two run paths")
        text = merge([_load(p) for p in args.runs])
    else:
        if not args.runs:
            ap.error("give at least one run path")
        text = "\n\n".join(
            summarize(_load(p), top=args.top) for p in args.runs
        )
    try:
        print(text)
    except BrokenPipeError:  # e.g. `report ... | head`
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    return text


if __name__ == "__main__":
    main()
