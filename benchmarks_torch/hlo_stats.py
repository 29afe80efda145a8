"""Roofline terms per dry-run cell (re-exports the HLO parser and the
card's constants from ``repro_torch.launch.hlo_analysis``).

Port of ``benchmarks/hlo_stats.py``.  A cell whose ``collectives`` is
``null`` (the port's dry run executes no sharded step) has no collective
term: ``collective_s`` is None.
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
    """memory_s and collective_s (None without collectives) for one
    dry-run report cell."""
    coll = cell.get("collectives")
    wire = None if coll is None else float(coll.get("total_bytes", 0.0))
    collective_s = (None if wire is None
                    else wire / (CHIP.link_bw * CHIP.n_links))
    from benchmarks_torch.flops_model import memory_bytes

    mem = memory_bytes(cell["arch"], cell["shape"],
                       n_dev=512 if cell["mesh"] == "2x16x16" else 256)
    memory_s = mem / CHIP.hbm_bw
    return {"memory_s": memory_s, "collective_s": collective_s,
            "wire_bytes": wire, "hbm_bytes": mem}
