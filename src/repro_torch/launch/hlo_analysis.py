"""Partitioned-HLO analysis: collective wire bytes with while-loop trip
attribution, and the card's roofline constants.

Port of ``repro.launch.hlo_analysis``.  The parser is a copy of the
reference's: it reads the text of a partitioned HLO module (XLA's
``compiled.as_text()``) and imports nothing.  XLA prints each computation
once; a collective inside a scan-over-layers while body executes
``trip_count`` times.  We build the computation graph, read each while loop's trip count
from the integer constant in its condition computation, and multiply
collective volumes through nested loops.

``CHIP`` holds one NVIDIA H100 SXM's published figures, where the
reference's ``Chip`` holds a TPU's.
"""
from __future__ import annotations

import re
from dataclasses import dataclass


@dataclass(frozen=True)
class Chip:
    # NVIDIA H100 SXM data sheet: dense bf16 tensor-core rate, no sparsity
    peak_flops: float = 989e12  # FLOP/s
    # the same data sheet: HBM3 bandwidth and capacity
    hbm_bw: float = 3.35e12  # bytes/s
    hbm_bytes: float = 80e9
    # NVLink 4: 18 links of 25 GB/s each way, 900 GB/s both ways together
    link_bw: float = 25e9  # bytes/s, one link, one direction
    n_links: int = 18


CHIP = Chip()

DTYPE_BYTES = {
    "f32": 4, "bf16": 2, "f16": 2, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "f64": 8, "s64": 8, "u64": 8,
    "f8e4m3fn": 1, "f8e5m2": 1,
}

# wire-bytes factor per element of the op result (ring algorithms)
COLLECTIVE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

_COMP_NAME = re.compile(r"^(?:ENTRY\s+)?%?([\w.\-]+)\s*\(")
_COLLECTIVE = re.compile(
    r"=\s*(\(?[a-z0-9\[\],\s{}:]+\)?)\s+(all-gather|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute)(?:-start)?\("
)
_WHILE = re.compile(
    r"while\(.*?\),\s*condition=%?([\w.\-]+),\s*body=%?([\w.\-]+)"
)
_SHAPE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_CONST = re.compile(r"s(?:32|64)\[\]\s+constant\((\d+)\)")


def _tensor_bytes(type_str: str) -> int:
    total = 0
    for dt, dims in _SHAPE.findall(type_str):
        if dt not in DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                if d:
                    n *= int(d)
        total += n * DTYPE_BYTES[dt]
    return total


def parse_computations(hlo_text: str) -> dict:
    """name -> {"collectives": [(kind, bytes)], "whiles": [(cond, body)],
    "consts": [int], "entry": bool}."""
    comps: dict = {}
    cur = None
    for line in hlo_text.splitlines():
        # computation headers start at column 0 and end with "{"; parameter
        # lists may contain nested tuple types, so match only the name.
        header = (
            line
            and not line[0].isspace()
            and line.rstrip().endswith("{")
            and "->" in line
        )
        m = _COMP_NAME.match(line) if header else None
        if m:
            cur = m.group(1)
            comps[cur] = {
                "collectives": [],
                "whiles": [],
                "consts": [],
                "entry": line.startswith("ENTRY"),
            }
            continue
        if cur is None:
            continue
        if line.startswith("}"):
            cur = None
            continue
        mc = _COLLECTIVE.search(line)
        if mc:
            comps[cur]["collectives"].append(
                (mc.group(2), _tensor_bytes(mc.group(1)))
            )
        mw = _WHILE.search(line)
        if mw:
            comps[cur]["whiles"].append((mw.group(1), mw.group(2)))
        for mk in _CONST.finditer(line):
            comps[cur]["consts"].append(int(mk.group(1)))
    return comps


def collective_stats_attributed(hlo_text: str) -> dict:
    """Per-device wire bytes by kind, with while-loop trip multipliers."""
    comps = parse_computations(hlo_text)
    entry = next((n for n, c in comps.items() if c["entry"]), None)
    out = {k: {"count": 0, "bytes": 0.0} for k in COLLECTIVE_FACTOR}

    def trip_count(cond_name: str) -> int:
        c = comps.get(cond_name)
        if not c or not c["consts"]:
            return 1
        return max(1, max(c["consts"]))

    seen: set = set()

    def walk(name: str, mult: float):
        if name not in comps:
            return
        key = (name, mult)
        if key in seen:  # guard pathological recursion
            return
        seen.add(key)
        c = comps[name]
        for kind, b in c["collectives"]:
            out[kind]["count"] += 1
            out[kind]["bytes"] += b * COLLECTIVE_FACTOR[kind] * mult
        for cond, body in c["whiles"]:
            walk(body, mult * trip_count(cond))

    if entry:
        walk(entry, 1.0)
    else:  # fallback: flat sum
        for c in comps.values():
            for kind, b in c["collectives"]:
                out[kind]["count"] += 1
                out[kind]["bytes"] += b * COLLECTIVE_FACTOR[kind]
    out["total_bytes"] = sum(
        v["bytes"] for k, v in out.items() if isinstance(v, dict)
    )
    return out
