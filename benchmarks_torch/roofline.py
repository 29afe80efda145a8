"""Roofline analysis per (arch x shape x mesh) from the dry-run report, on
one NVIDIA H100's published figures (``repro_torch.launch.hlo_analysis.CHIP``).

Three terms per cell:

  compute_s    = FLOPs_per_device / peak_FLOPs       (dense bf16)
  memory_s     = HBM_bytes_per_device / HBM_bw
  collective_s = wire_bytes_per_device / (links * link_bw)

FLOPs and HBM bytes come from the analytic per-arch model in
``flops_model``, as in the reference; the wire bytes from the dry run's
report: the collectives its executed step issued on rank 0
(``repro_torch.launch.dryrun``).

MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE); the ratio
MODEL_FLOPS / executed FLOPs shows how much compute is useful (remat
recompute, attention, MoE dispatch).

Port of ``benchmarks/roofline.py``.
"""
from __future__ import annotations

import json
import sys
import time

from benchmarks_torch.flops_model import cell_flops, model_flops
from benchmarks_torch.hlo_stats import CHIP, roofline_terms


def main(report_path: str = "dryrun_report.json") -> list:
    rows = []
    try:
        with open(report_path) as f:
            cells = json.load(f)
    except FileNotFoundError:
        print(f"# {report_path} missing - run: "
              "PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out "
              "dryrun_report.json", file=sys.stderr)
        return [("roofline.skipped", 0.0, "no dryrun_report.json")]
    for c in cells:
        if c.get("status") != "ok":
            continue
        t0 = time.time()
        terms = roofline_terms(c)
        hlo_f = cell_flops(c["arch"], c["shape"])
        mf = model_flops(c["arch"], c["shape"])
        n_dev = 512 if c["mesh"] == "2x16x16" else 256
        comp_s = hlo_f / n_dev / CHIP.peak_flops
        dom = max(
            ("compute", comp_s),
            ("memory", terms["memory_s"]),
            ("collective", terms["collective_s"]),
            key=lambda kv: kv[1],
        )[0]
        rows.append((
            f"roofline.{c['arch']}.{c['shape']}.{c['mesh']}",
            (time.time() - t0) * 1e6,
            (
                f"compute_s={comp_s:.4f};memory_s={terms['memory_s']:.4f};"
                f"collective_s={terms['collective_s']:.4f};dominant={dom};"
                f"model_flops={mf:.3e};hlo_flops={hlo_f:.3e};"
                f"useful={mf/max(hlo_f,1e-9)*100:.0f}%"
            ),
        ))
    return rows


if __name__ == "__main__":
    from benchmarks_torch.common import emit

    emit(main(sys.argv[1] if len(sys.argv) > 1 else "dryrun_report.json"))
