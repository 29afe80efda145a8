"""Roofline terms per dry-run cell (re-exports the HLO parser and the
card's constants from ``repro_torch.launch.hlo_analysis``).

Port of ``benchmarks/hlo_stats.py``.
"""
from __future__ import annotations

from repro_torch.launch.hlo_analysis import (  # noqa: F401
    CHIP,
    Chip,
    COLLECTIVE_FACTOR,
    DTYPE_BYTES,
    collective_stats_attributed,
    parse_computations,
)


def roofline_terms(cell: dict) -> dict:
    """memory_s and collective_s for one dry-run report cell."""
    coll = cell.get("collectives", {})
    wire = float(coll.get("total_bytes", 0.0))
    collective_s = wire / (CHIP.link_bw * CHIP.n_links)
    from benchmarks_torch.flops_model import memory_bytes

    mem = memory_bytes(cell["arch"], cell["shape"],
                       n_dev=512 if cell["mesh"] == "2x16x16" else 256)
    memory_s = mem / CHIP.hbm_bw
    return {"memory_s": memory_s, "collective_s": collective_s,
            "wire_bytes": wire, "hbm_bytes": mem}
