"""Shared building blocks: norms and rotary embeddings.

Port of ``repro.models.common`` for the forward path: ``rms_norm`` with f32
statistics and ``apply_rope`` in the GPT-NeoX convention, with cos/sin cast
to the activation dtype as the reference casts them.  The reference's
``apply_rope`` computes its angles inside; the port splits them out
(``rope_angles``, M-RoPE's sections included) so that a forward computes
them once for every layer.  The loss comes with a later slice.
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


def rope_angles(positions, head_dim: int, theta: float, mrope_sections=None):
    """f32 cos/sin of shape (B, S, head_dim//2) for positions (B, S), or for
    M-RoPE's (B, S, 3) streams (temporal, height, width).

    With ``mrope_sections`` the head_dim//2 rotary frequencies are cut into
    three sections in order, each turned by its own position stream; (B, S,
    3) positions without sections turn every frequency by stream 0, as the
    reference does for a default-RoPE layer."""
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=positions.device) / float(half)
    freqs = 1.0 / (theta ** exponent)
    if positions.dim() == 3 and mrope_sections is not None:
        # frequency j reads the stream of the section it falls in
        stream = torch.repeat_interleave(
            torch.arange(3, device=positions.device),
            torch.tensor(mrope_sections, device=positions.device))
        ang = positions.float()[..., stream] * freqs
    else:
        if positions.dim() == 3:
            positions = positions[..., 0]
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
