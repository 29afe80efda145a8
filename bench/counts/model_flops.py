"""MODEL_FLOPS: the standard count of a step's useful work, frozen here.

The rule of the program's ``benchmarks_torch/flops_model.py``
(``step_model_flops``), copied so that a change there cannot move the
benchmark: 2 N_active FLOPs a token of a forward pass (prefill), 6
N_active a token of a train step; N_active is every parameter of the
configuration less the routed experts a token does not use (all but
top-k of each MoE layer).  Attention's score and value products are not
counted, as in that rule.  The parameters are counted from the
configuration's own leaf list (``bench/weights.py``), never from the
program.
"""
from __future__ import annotations

import math

from bench.modelcfg import Arch
from bench.weights import leaf_specs


def param_count(a: Arch) -> int:
    return sum(math.prod(shape) for _, shape, _, _, _ in leaf_specs(a))


def active_param_count(a: Arch) -> int:
    """Parameters a token touches: the routed experts beyond top-k left
    out of every MoE layer."""
    n_moe = sum(1 for _, mlp in a.layers if mlp == "moe")
    inactive = n_moe * (a.n_experts - a.top_k) * 3 * a.d_model * a.d_ff_expert
    return param_count(a) - inactive


def step_flops(a: Arch, step: str, tokens: int) -> float:
    """MODEL_FLOPS of ``tokens`` tokens of a "prefill" or "train" step."""
    per = {"prefill": 2.0, "train": 6.0}[step]
    return per * active_param_count(a) * tokens
