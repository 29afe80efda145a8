"""Serving driver: multi-tenant continuous batching with LAGS admission.

  PYTHONPATH=src python -m repro_torch.launch.serve --policy lags \
      --tenants 40 --duration 30 --real-model

Port of ``repro.launch.serve``.  The run goes on the card; ``--device cpu``
runs it on the CPU instead, with the kernels' plain versions.  Without a card
and without ``--device cpu`` it stops with an error.

``--real-model`` attaches the reference's reduced decoder
(``reduced(qwen3-8b, n_layers=2)``, random weights from seed 0) so every
engine step also runs a decode over the shared KV cache (proving the engine
drives real compute); without it the calibrated step-cost model is used (fast
sweeps).  At ``--pallas-threshold`` tenants or more, the per-step credit tick
runs on the CUDA ``lags_select`` kernel.

Telemetry: ``--obs-dir DIR`` records the run (schedstats + metrics) as a
diffable run record; ``--trace`` additionally captures a Chrome trace-event
file (open in Perfetto).  Compare policies with

  python -m repro_torch.launch.serve --policy lags --obs-dir /tmp/r/lags
  python -m repro_torch.launch.serve --policy fair --obs-dir /tmp/r/fair
  python -m repro_torch.obs.report --diff /tmp/r/fair /tmp/r/lags

Long runs can be *watched live*: ``--checkpoint-every S`` rewrites the run
record every S sim-seconds, so ``python -m repro_torch.obs.report DIR`` in
another shell always renders the latest snapshot.  Multiple engine shards
merge post-hoc into one fleet view:

  python -m repro_torch.launch.serve --policy lags --shard s0 \
      --obs-dir /tmp/f/s0
  python -m repro_torch.launch.serve --policy lags --shard s1 --seed 1 \
      --obs-dir /tmp/f/s1
  python -m repro_torch.obs.report --merge /tmp/f/s0 /tmp/f/s1
"""
from __future__ import annotations

import argparse

import numpy as np

import torch

import repro_torch.obs as obs
from repro_torch.core.traces import _mmpp_arrivals
from repro_torch.obs import report as obs_report
from repro_torch.obs.recorder import record_run
from repro_torch.sched import serving as sched_serving
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.serving.engine import Engine, EngineConfig


def build_workload(n_tenants: int, duration: float, seed: int = 0):
    rng = np.random.default_rng(seed)
    tenants = {
        i: Tenant(i, weight_mb=float(rng.uniform(32, 256)))
        for i in range(n_tenants)
    }
    rates = np.logspace(-1, 0.8, n_tenants)
    rates *= 28.0 / rates.sum()
    arrivals, rid = [], 0
    for t in range(n_tenants):
        for a in _mmpp_arrivals(rates[t], duration, rng, 1.0, 9.0):
            arrivals.append(
                Request(rid, t, int(rng.integers(64, 512)),
                        int(rng.integers(16, 128)), float(a))
            )
            rid += 1
    return tenants, arrivals


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--policy", default="lags",
                    choices=sorted(sched_serving.ADMISSION))
    ap.add_argument("--tenants", type=int, default=48)
    ap.add_argument("--duration", type=float, default=30.0)
    ap.add_argument("--slots", type=int, default=16)
    ap.add_argument("--max-resident", type=int, default=12,
                    help="tenants whose weights fit in HBM (residency LRU)")
    ap.add_argument("--hysteresis", type=float, default=0.5,
                    help="LAGS preemption hysteresis: a waiting tenant "
                         "evicts only when credit < hysteresis * victim's")
    ap.add_argument("--pallas-threshold", type=int, default=256,
                    help="tenant count at which the credit tick moves onto "
                         "the fused CUDA credit kernel (0 = never)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--real-model", action="store_true")
    ap.add_argument("--obs-dir", default="",
                    help="record schedstats/metrics run record here")
    ap.add_argument("--trace", action="store_true",
                    help="capture a Chrome trace (needs --obs-dir to persist)")
    ap.add_argument("--checkpoint-every", type=float, default=0.0,
                    metavar="S",
                    help="stream live schedstats: rewrite the run record "
                         "every S sim-seconds (needs --obs-dir)")
    ap.add_argument("--shard", default="",
                    help="shard label recorded in the run meta, for "
                         "post-hoc `report --merge` of parallel shards")
    ap.add_argument("--admission-timeout", type=float, default=0.0,
                    metavar="S",
                    help="graceful degradation: expire requests still "
                         "queued S sim-seconds after arrival (0 = off)")
    ap.add_argument("--backoff-base", type=float, default=0.02,
                    metavar="S",
                    help="first out-of-pages backoff; doubles per "
                         "rejection (capped at 0.5s)")
    ap.add_argument("--shed-watermark", type=int, default=0,
                    help="overload shedding: total queue depth past which "
                         "the highest-credit tenants' work is shed (0 = "
                         "off)")
    ap.add_argument("--shed-mode", default="drop",
                    choices=("drop", "truncate"),
                    help="shed by dropping newest requests or by halving "
                         "their max_new once")
    ap.add_argument("--fence-window", action="append", default=[],
                    metavar="T0:T1",
                    help="fence the engine (serve in-flight only, defer new "
                         "admissions) over [T0, T1) sim-seconds; repeatable, "
                         "models a SUSPECT verdict from the health tracker")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the engine's tensors live: the card "
                         "(default; an error without one) or the CPU")
    args = ap.parse_args(argv)

    fence_windows = []
    for w in args.fence_window:
        try:
            a, b = w.split(":")
            fence_windows.append((float(a), float(b)))
        except ValueError:
            ap.error(f"--fence-window expects T0:T1, got {w!r}")

    if args.obs_dir or args.trace:
        obs.enable()
    if args.trace:
        obs.install_tracer()

    tenants, arrivals = build_workload(args.tenants, args.duration, args.seed)
    eng = Engine(
        EngineConfig(policy=args.policy, n_slots=args.slots,
                     max_resident=args.max_resident,
                     preempt_hysteresis=args.hysteresis,
                     pallas_threshold=args.pallas_threshold,
                     admission_timeout_s=args.admission_timeout,
                     backoff_base_s=args.backoff_base,
                     shed_watermark=args.shed_watermark,
                     shed_mode=args.shed_mode),
        tenants, device=args.device,
    )
    if args.real_model:
        from repro_torch.configs.base import get_config, reduced
        from repro_torch.models import params as params_lib

        cfg = reduced(get_config("qwen3-8b"), n_layers=2)
        gen = torch.Generator(device=eng.device).manual_seed(0)
        params = params_lib.init_params(cfg, gen, device=eng.device)
        eng.attach_model(cfg, params, max_len=64)

    meta = {
        "layer": "serving", "policy": args.policy,
        "tenants": args.tenants, "duration_s": args.duration,
        "slots": args.slots, "seed": args.seed,
        "arrivals": len(arrivals),
    }
    if args.admission_timeout or args.shed_watermark:
        meta["degradation"] = {
            "admission_timeout_s": args.admission_timeout,
            "shed_watermark": args.shed_watermark,
            "shed_mode": args.shed_mode,
        }
    if fence_windows:
        meta["fence_windows"] = [[a, b] for a, b in fence_windows]
    if args.shard:
        meta["shard"] = args.shard

    n_ckpt = 0

    def _checkpoint(stats):
        # live schedstats stream: rewrite the run record in place so a
        # concurrent `repro_torch.obs.report` sees the latest partial totals
        nonlocal n_ckpt
        n_ckpt += 1
        record_run(
            args.obs_dir,
            meta={**meta, "checkpoint": n_ckpt,
                  "progress_s": round(stats.time_s, 3), "live": True},
            sched=stats.sched,
        )

    st = eng.run(
        args.duration, arrivals,
        checkpoint_every_s=args.checkpoint_every if args.obs_dir else 0.0,
        on_checkpoint=_checkpoint if args.obs_dir else None,
        fence_windows=fence_windows or None,
    )
    lat = np.asarray([r.latency for r in st.completed])
    print(
        f"policy={args.policy} completed={len(st.completed)}/{len(arrivals)} "
        f"p50={np.median(lat) if len(lat) else -1:.2f}s "
        f"p95={np.percentile(lat, 95) if len(lat) else -1:.2f}s "
        f"switch_overhead={st.overhead_frac*100:.1f}% "
        f"membership_changes={st.membership_changes}"
        + (f" shed={st.shed} expired={st.expired} backoffs={st.backoffs}"
           if (st.shed or st.expired or st.backoffs) else "")
        + (f" fenced_steps={st.fenced_steps} deferred={st.deferred}"
           if (st.fenced_steps or st.deferred) else "")
        + (f" checkpoints={n_ckpt}" if n_ckpt else "")
    )
    if args.obs_dir:
        path = record_run(
            args.obs_dir,
            meta={**meta, "checkpoints": n_ckpt} if n_ckpt else meta,
            sched=st.sched,
        )
        print(f"run record -> {path}")
        print(obs_report.summarize({"meta": {"policy": args.policy},
                                    "sched": st.sched}))
    return st


if __name__ == "__main__":
    main()
