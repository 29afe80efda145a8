"""Paper §5.1: consolidate a serverless cluster with CFS-LAGS fleet nodes.

  PYTHONPATH=src python examples_torch/cluster_consolidation.py
  PYTHONPATH=src python examples_torch/cluster_consolidation.py \
      --placements round-robin pack spread switch-aware --nodes 10
  PYTHONPATH=src python examples_torch/cluster_consolidation.py --backend torch

Runs the consolidation sweep through ``repro_torch.fleet`` (placement-aware
multi-node simulation), then compares placement strategies at the
consolidated node count and renders one *merged fleet view* from the
per-node run records via ``repro_torch.obs.report --merge``.

Port of ``examples/cluster_consolidation.py``: ``--backend torch`` (the
reference's ``jax``) runs each configuration's nodes in one batched tick
loop, on the card unless ``--device cpu``.
"""
import argparse
import glob
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.fleet import (  # noqa: E402
    consolidation_sweep,
    min_nodes_meeting_slo,
    placement_comparison,
)
from repro_torch.obs import report as obs_report  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--total-fns", type=int, default=800)
ap.add_argument("--node-counts", type=int, nargs="+",
                default=(14, 12, 10, 9))
ap.add_argument("--nodes", type=int, default=0,
                help="node count for the placement sweep "
                     "(default: the LAGS minimum found)")
ap.add_argument("--placements", nargs="+",
                default=("round-robin", "pack", "spread", "switch-aware"))
ap.add_argument("--duration", type=float, default=0.0,
                help="sweep horizon in sim-seconds (default: the "
                     "calibrated fleet horizon)")
ap.add_argument("--backend", default="numpy", choices=("numpy", "torch"))
ap.add_argument("--device", default="cuda",
                help="cuda (default) or cpu, for --backend torch")
args = ap.parse_args()

from repro_torch.fleet import CLUSTER_DURATION_S  # noqa: E402

dur = args.duration or CLUSTER_DURATION_S

# 1. consolidation: smallest node count per policy that holds the SLO
res = consolidation_sweep(
    total_fns=args.total_fns, node_counts=tuple(args.node_counts),
    duration_s=dur, backend=args.backend, device=args.device,
)
for r in res:
    print(
        f"{r.policy:4s} nodes={r.n_nodes:2d}  p95={r.p95:7.3f}s  "
        f"done={r.done_ratio*100:5.1f}%  "
        f"util={r.util_effective*100:4.0f}%eff/{r.util_perceived*100:4.0f}%perc"
        f"  overhead={r.overhead_frac*100:4.1f}%"
    )
n_cfs = min_nodes_meeting_slo(res, "cfs")
n_lags = min_nodes_meeting_slo(res, "lags")
print(f"min nodes: CFS={n_cfs}  LAGS={n_lags} "
      f"({100*(1-n_lags/max(n_cfs,1)):.0f}% reduction)")

# 2. placement sweep at the consolidated count: same functions, different
#    packing — watch the per-node p95 spread and overhead imbalance
n_sweep = args.nodes or n_lags
print(f"\nplacement sweep (lags, {n_sweep} nodes):")
rec_dir = tempfile.mkdtemp(prefix="fleet_records_")
pres = placement_comparison(
    total_fns=args.total_fns, n_nodes=n_sweep, policy="lags",
    placements=tuple(args.placements),
    duration_s=args.duration or 30.0,  # imbalance shows fine at 30 s
    record_dir=rec_dir,
)
for r in pres:
    print(
        f"{r.placement:12s}  p95={r.p95:7.3f}s  "
        f"p95_spread={r.p95_spread:6.3f}s  "
        f"ovh={r.overhead_frac*100:4.1f}%  ovh_imb={r.ovh_max_over_mean:.2f}"
    )

# 3. merged fleet view: every node emitted a run record; fold them into one
best = min(pres, key=lambda r: r.p95)
node_records = sorted(glob.glob(f"{rec_dir}/{best.placement}/node*"))
print(f"\nmerged fleet view ({best.placement}, {len(node_records)} node "
      f"records from {rec_dir}):")
obs_report.main(["--merge", *node_records])
