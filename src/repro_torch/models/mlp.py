"""Dense SwiGLU MLP.

Port of ``repro.models.mlp``, with its sharding constraints (no-ops
without a mesh).
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.distributed.sharding import constrain


def mlp(params: dict, x):
    """x: (B, S, M) -> (B, S, M); weights w_gate, w_up (M, F), w_down (F, M)."""
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    h = constrain(F.silu(g) * u, "batch", "seq", "mlp")
    y = h @ params["w_down"].to(x.dtype)
    return constrain(y, "batch", "seq_sp", None)
