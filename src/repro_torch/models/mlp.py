"""Dense SwiGLU MLP.

Port of ``repro.models.mlp``, with its sharding constraints (no-ops
without a mesh).  Under a mesh it is column-parallel in (the input gathered
over the sequence, w_gate and w_up split over "mlp") and row-parallel out
(w_down's partial sums reduced onto the sequence-split residual), the
weights' FSDP split gathered first.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, gathered,
                                               whole_on_one_rank)


def mlp(params: dict, x):
    """x: (B, S, M) -> (B, S, M); weights w_gate, w_up (M, F), w_down (F, M)."""
    x = constrain(x, "batch", "seq", None)  # gather the sequence-split rows
    w = {n: gathered(params[n]).to(x.dtype)
         for n in ("w_gate", "w_up", "w_down")}
    g = x @ w["w_gate"]
    u = x @ w["w_up"]
    h = constrain(F.silu(g) * u, "batch", "seq", "mlp")
    y = whole_on_one_rank(h) @ w["w_down"]  # as w_down, gathered
    return constrain(y, "batch", "seq_sp", None)
