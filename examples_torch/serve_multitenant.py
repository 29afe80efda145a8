"""Serve batched multi-tenant requests, comparing the paper's LAGS
admission against fair round-robin.

  PYTHONPATH=src python examples_torch/serve_multitenant.py  # the card
  PYTHONPATH=src python examples_torch/serve_multitenant.py --device cpu

Port of ``examples/serve_multitenant.py`` on
``repro_torch.serving.engine.Engine`` (on the card unless ``--device
cpu``).  At 48 tenants, below ``EngineConfig.pallas_threshold`` (256), the
engine's credit tick runs on the host, as the reference's does.
"""
import argparse
import sys

sys.path.insert(0, "src")

import numpy as np  # noqa: E402

from repro_torch.launch.serve import build_workload  # noqa: E402
from repro_torch.serving.engine import Engine, EngineConfig  # noqa: E402

DURATION = 40.0

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
args = ap.parse_args()

for policy in ("fair", "lags"):
    tenants, arrivals = build_workload(48, DURATION, seed=3)
    eng = Engine(EngineConfig(policy=policy, max_resident=12), tenants,
                 device=args.device)
    st = eng.run(DURATION, arrivals)
    lat = np.asarray([r.latency for r in st.completed])
    print(
        f"{policy:5s}: completed={len(st.completed):4d} "
        f"p50={np.median(lat):5.2f}s slo@2s={np.mean(lat < 2)*100:3.0f}% "
        f"switch_overhead={st.overhead_frac*100:4.1f}%"
    )
print("LAGS should show lower p50 / higher SLO attainment at similar or "
      "lower switch overhead.")
