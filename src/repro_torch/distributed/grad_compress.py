"""Gradient compression: int8 quantisation with a per-tensor scale and error
feedback, and top-k sparsification.

Port of ``repro.distributed.grad_compress`` for its in-step pair:

  * ``compress``/``decompress`` — the numerics-faithful pair used inside the
    train step when ``TrainConfig.compress_grads`` is set; models exactly
    what the wire sees (int8 payload + f32 scale);
  * ``compress_with_feedback`` — error feedback (the residual carried
    between steps);
  * ``topk_compress``/``topk_decompress`` — keep the top ``frac`` of the
    entries by magnitude.

The reference's collectives (``compressed_psum``, ``sparse_psum``) need a
process group and are not ported yet.
"""
from __future__ import annotations

import torch


def compress(g, bits: int = 8):
    """Returns (payload int8, scale f32)."""
    g32 = g.float()
    absmax = torch.max(torch.abs(g32))
    qmax = 2.0 ** (bits - 1) - 1.0
    scale = torch.clamp(absmax / qmax, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -qmax, qmax)
    return q.to(torch.int8), scale


def decompress(q, scale, dtype=torch.float32):
    return (q.float() * scale).to(dtype)


def compress_with_feedback(g, residual, bits: int = 8):
    """Error-feedback compression: returns (payload, scale, new_residual)."""
    g32 = g.float() + residual
    q, scale = compress(g32, bits)
    deq = decompress(q, scale)
    return q, scale, g32 - deq


def topk_compress(g, frac: float = 0.01):
    """Deep-Gradient-Compression-style sparsification: keep the top ``frac``
    of entries by magnitude.  Returns (values, flat_indices); pair with
    error feedback so dropped mass is carried to the next step."""
    flat = g.float().reshape(-1)
    k = max(1, int(flat.shape[0] * frac))
    _, idx = torch.topk(torch.abs(flat), k)
    return flat[idx], idx


def topk_decompress(values, idx, shape):
    n = 1
    for d in shape:
        n *= int(d)
    flat = torch.zeros(n, dtype=torch.float32, device=values.device)
    return flat.index_add(0, idx, values).reshape(tuple(shape))
