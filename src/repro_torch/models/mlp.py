"""Dense SwiGLU MLP.

Port of ``repro.models.mlp``.
"""
from __future__ import annotations

import torch.nn.functional as F


def mlp(params: dict, x):
    """x: (B, S, M) -> (B, S, M); weights w_gate, w_up (M, F), w_down (F, M)."""
    g = x @ params["w_gate"].to(x.dtype)
    u = x @ params["w_up"].to(x.dtype)
    return (F.silu(g) * u) @ params["w_down"].to(x.dtype)
