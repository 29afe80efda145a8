"""Shared building blocks: norms and rotary embeddings.

Port of ``repro.models.common`` for the forward path: ``rms_norm`` with f32
statistics and ``apply_rope`` in the GPT-NeoX convention, with cos/sin cast
to the activation dtype as the reference casts them.  The reference's
``apply_rope`` computes its angles inside; the port splits them out
(``rope_angles``, M-RoPE's sections included) so that a forward computes
them once for every layer.  The reference's ``softmax_cross_entropy`` is
the ratio of ``masked_nll``'s (sum, count), which the chunked loss sums
over its chunks; ``masked_nll`` takes logits split over the vocab across
ranks, the unsplit logits being its one-rank case.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh


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
            torch.tensor(mrope_sections, device=positions.device),
            output_size=sum(mrope_sections))
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


def masked_nll(logits, labels, mask=None, vocab=(), v0=0):
    """(sum of the NLL over masked positions, sum of the mask), f32; logits
    (..., V) promoted to f32.  No mask counts every position.

    The logits may be the rank's columns v0.. of logits split over the mesh
    axes ``vocab`` of the active mesh, the labels and mask its rows: the
    log-sum-exp takes its shift, the largest logit of every rank, without
    a gradient, and sums the exponentials over the ranks with one
    (``sharding.psum``); each label's logit comes from the rank that holds
    its column.  Unsplit (no axes, v0 = 0) every sum is the rank's own.
    The sums are over the rank's rows."""
    logits = logits.float()
    m = sh.pmax(logits.detach().amax(dim=-1), vocab)
    lse = torch.log(sh.psum(torch.exp(logits - m[..., None]).sum(dim=-1),
                            vocab)) + m
    idx = labels.long() - v0
    hit = (idx >= 0) & (idx < logits.shape[-1])
    ll = torch.gather(logits, -1, idx.clamp(
        0, logits.shape[-1] - 1)[..., None])[..., 0]
    ll = sh.psum(torch.where(hit, ll, torch.zeros_like(ll)), vocab)
    nll = lse - ll
    if mask is None:
        return nll.sum(), torch.tensor(float(nll.numel()), device=nll.device)
    mask = mask.float()
    return (nll * mask).sum(), mask.sum()

