"""Shared building blocks: norms and rotary embeddings.

Port of ``repro.models.common`` for the decode path: ``rms_norm`` with f32
statistics and ``apply_rope`` in the GPT-NeoX convention, with cos/sin cast
to the activation dtype as the reference casts them.  M-RoPE and the loss
come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def param_dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def rms_norm(x, weight, eps: float = 1e-6):
    """RMSNorm with fp32 statistics (matches production LM stacks)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (..., S) int -> f32 cos/sin of shape (..., S, head_dim//2)."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / float(half)
    freqs = 1.0 / (theta ** exponent)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """Rotate pairs (x[..., :half], x[..., half:]) — GPT-NeoX convention.

    x: (B, S, H, D); cos, sin: (B, S, D//2) from ``rope_angles``.
    """
    half = x.shape[-1] // 2
    cos = cos[:, :, None, :].to(x.dtype)  # (B, S, 1, half)
    sin = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
