"""Fig 7 / §5.1: cluster consolidation — CFS vs CFS-LAGS minimum node count.

Paper: 14 nodes (CFS, static reservation) -> 10 nodes (LAGS), a 28 %
reduction; safe utilisation 45 % -> 55 %; perceived-vs-effective CPU gap
+100 % (CFS) -> +10 % (LAGS).

Thin driver over :mod:`repro_torch.fleet`: the consolidation search,
placement strategies and multi-node simulation (numpy per-node loop and
the batched tick loop) all live there, as does the workload calibration
that anchors the 14-node static-reservation baseline at the paper's
~45-50 % utilisation (see ``repro_torch.fleet.consolidate``).  Reported
here:

  * the headline sweep (round-robin placement, conserving the full 800
    functions);
  * pack vs spread vs round-robin vs switch-aware at the LAGS minimum
    node count, with per-node imbalance columns;
  * a cross-check on the tick simulator where each configuration's nodes
    run as one batched loop on the card (``fig7.torch.*``).

Port of ``benchmarks/fig7_cluster.py``: its JAX cross-check
(``fig7.jax.*``) becomes ``fig7.torch.*``, on the card unless
``--device cpu``.
"""
from __future__ import annotations

import sys
import time

from benchmarks_torch.common import device_arg, emit
from repro_torch.device import resolve
from repro_torch.fleet import (
    consolidation_sweep,
    min_nodes_meeting_slo,
    placement_comparison,
)


def main(device=None) -> list:
    device = resolve(device)  # before the host rows: no card, no run
    rows = []
    t0 = time.time()
    res = consolidation_sweep(total_fns=800,
                              node_counts=(15, 14, 13, 12, 11, 10, 9, 8))
    us = (time.time() - t0) * 1e6
    for r in res:
        rows.append((
            f"fig7.{r.policy}.n{r.n_nodes}",
            us / len(res),
            (
                f"p50={r.p50:.3f};p95={r.p95:.3f};"
                f"done={r.done_ratio*100:.1f}%;"
                f"util_eff={r.util_effective*100:.0f}%;"
                f"util_perc={r.util_perceived*100:.0f}%;"
                f"ovh={r.overhead_frac*100:.1f}%"
            ),
        ))
    n_cfs = min_nodes_meeting_slo(res, "cfs")
    n_lags = min_nodes_meeting_slo(res, "lags")
    rows.append((
        "fig7.consolidation",
        0.0,
        (
            f"min_nodes_cfs={n_cfs};min_nodes_lags={n_lags};"
            f"reduction={100*(1-n_lags/max(n_cfs,1)):.1f}%"
        ),
    ))

    # placement quality at the consolidated node count: same workload and
    # policy, different packing — per-node imbalance is the story
    t0 = time.time()
    pres = placement_comparison(total_fns=800, n_nodes=n_lags, policy="lags")
    us = (time.time() - t0) * 1e6
    for r in pres:
        rows.append((
            f"fig7.place.{r.placement}.n{r.n_nodes}",
            us / len(pres),
            (
                f"p95={r.p95:.3f};p95_spread={r.p95_spread:.3f};"
                f"ovh={r.overhead_frac*100:.1f}%;"
                f"ovh_imb={r.ovh_max_over_mean:.2f}"
            ),
        ))
    return rows + torch_rows(device)


def torch_rows(device=None) -> list:
    """Cross-check on the tick simulator: every node of a configuration in
    one batched loop; the same SLO search runs over the per-node
    SimResults."""
    rows = []
    t0 = time.time()
    res_torch = consolidation_sweep(
        total_fns=800, node_counts=(14, 12, 10), backend="torch",
        duration_s=30.0, device=device,
    )
    us = (time.time() - t0) * 1e6
    for r in res_torch:
        rows.append((
            f"fig7.torch.{r.policy}.n{r.n_nodes}",
            us / len(res_torch),
            f"p50={r.p50:.3f};p95={r.p95:.3f};ovh={r.overhead_frac*100:.1f}%",
        ))
    return rows


if __name__ == "__main__":
    emit(main(device_arg(sys.argv[1:])))
