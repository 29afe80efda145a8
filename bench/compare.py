"""The numbers that decide ``correct``, and their limits.

Each cell's limits are in ``bench/limits/<workload>.json``: {number: limit},
each set from the program's readings over a dozen seeds and the control's
(PERF.md gives both).  A number is within its limit when it is finite and
not above it; ``correct`` is every number within its limit.
"""
from __future__ import annotations

import json
import math
import statistics

import torch

from bench.modelcfg import ROOT


def limits(workload: str) -> dict:
    return json.loads((ROOT / "limits" / f"{workload}.json").read_text())


def judge(numbers: dict, lim: dict):
    """(correct, {name: {"value", "limit"}}) of the numbers that ``lim``
    names; a limit without its number is a fault."""
    missing = set(lim) - set(numbers)
    if missing:
        raise KeyError(f"no number for the limits {sorted(missing)}")
    out = {k: {"value": float(numbers[k]), "limit": float(lim[k])}
           for k in sorted(lim)}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out


class RelErr:
    """sqrt(sum |x - ref|^2 / sum |ref|^2) accumulated over pieces."""

    def __init__(self):
        self.num = self.den = 0.0

    def add(self, x, ref):
        ref = ref.double()
        self.num += float((x.double() - ref).square().sum())
        self.den += float(ref.square().sum())

    @property
    def value(self) -> float:
        return math.sqrt(self.num / self.den) if self.den > 0 else (
            0.0 if self.num == 0 else math.inf)


def row_errors(x, ref) -> list:
    """Each row's (leading index's) |x - ref| / |ref|."""
    d = (x.double() - ref.double()).flatten(1).norm(dim=1)
    return (d / ref.double().flatten(1).norm(dim=1)).tolist()


def logit_gap(logits, ref) -> torch.Tensor:
    """(rows,) how far below the reference's best logit the reference puts
    the token that ``logits`` puts first (the greedy served token)."""
    ref = ref.double()
    pick = logits.float().argmax(-1)
    return ref.max(-1).values - ref.gather(-1, pick[:, None])[:, 0]


def norm_gap(prog: list, ref: list, keep=None) -> float:
    """The worst leaf's |norm(program) - norm(reference)|, over the larger
    of that leaf's reference norm and the median leaf's; ``keep`` picks
    the leaves that count."""
    idx = [i for i in range(len(ref)) if keep is None or keep[i]]
    if not idx:
        return math.inf
    med = statistics.median(ref[i] for i in idx)
    return max(abs(prog[i] - ref[i]) / max(ref[i], med, 1e-30) for i in idx)
