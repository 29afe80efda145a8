"""Gradient compression: int8 quantisation with a per-tensor scale and error
feedback, and top-k sparsification.

Port of ``repro.distributed.grad_compress`` for its in-step pair:

  * ``compress``/``decompress`` — the numerics-faithful pair used inside the
    train step when ``TrainConfig.compress_grads`` is set; models exactly
    what the wire sees (int8 payload + f32 scale);
  * ``compress_with_feedback`` — error feedback (the residual carried
    between steps);
  * ``topk_compress``/``topk_decompress`` — keep the top ``frac`` of the
    entries by magnitude;
  * ``compressed_psum`` and ``sparse_psum`` — the reference's collectives
    over a mesh axis, here over a ``torch.distributed`` process group
    (``group``, e.g. ``mesh.get_group("data")``) in place of the
    reference's ``axis_name`` inside ``shard_map``.

Divisions take a tensor divisor: a Python number would let PyTorch's CUDA
kernel multiply by its reciprocal, which can differ from the reference's
quotient in the last bit.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _scale(absmax, bits: int):
    """(qmax, the shared scale max(absmax / qmax, 1e-12)) in f32."""
    qmax = 2.0 ** (bits - 1) - 1.0
    q = torch.full((), qmax, dtype=torch.float32, device=absmax.device)
    return qmax, torch.clamp(absmax / q, min=1e-12)


def compress(g, bits: int = 8):
    """Returns (payload int8, scale f32)."""
    g32 = g.float()
    qmax, scale = _scale(torch.max(torch.abs(g32)), bits)
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


def compressed_psum(g, group, bits: int = 8):
    """Quantised all-reduce over the ranks of ``group``; returns the f32
    mean.

    All ranks agree on a shared scale (an all-reduce MAX of the f32
    absmax), quantise with round-half-to-even, sum the payload, and
    dequantise: ``total * scale / n``, n the world size, in the reference's
    order.  The reference sums an int16 payload (2 bytes an element on the
    wire); neither gloo nor NCCL sums int16, so the port sums int32 (4
    bytes an element) and casts the total to int16 before the f32
    conversion, which gives the reference's value, its wrap past 258 ranks
    included.
    """
    g32 = g.float()
    absmax = torch.max(torch.abs(g32))
    dist.all_reduce(absmax, op=dist.ReduceOp.MAX, group=group)
    qmax, scale = _scale(absmax, bits)
    q = torch.clamp(torch.round(g32 / scale), -qmax, qmax)
    total = q.to(torch.int32)
    dist.all_reduce(total, group=group)
    n = torch.full((), float(dist.get_world_size(group)),
                   dtype=torch.float32, device=g32.device)
    return total.to(torch.int16).float() * scale / n


def sparse_psum(g, group, frac: float = 0.01):
    """Top-k sparse gradient exchange over the ranks of ``group``: each
    rank contributes its top-k (value, index) pairs through an all-gather
    and the union is summed locally, divided by the world size.  Wire bytes
    are 12 * k a rank (f32 values, int64 indices) against 4 * g.numel() for
    an f32 all-reduce."""
    vals, idx = topk_compress(g, frac)
    n = dist.get_world_size(group)
    all_vals = [torch.empty_like(vals) for _ in range(n)]
    all_idx = [torch.empty_like(idx) for _ in range(n)]
    dist.all_gather(all_vals, vals, group=group)
    dist.all_gather(all_idx, idx, group=group)
    flat = torch.zeros(g.numel(), dtype=torch.float32, device=vals.device)
    flat.index_add_(0, torch.cat(all_idx), torch.cat(all_vals))
    nt = torch.full((), float(n), dtype=torch.float32, device=vals.device)
    return (flat / nt).reshape(g.shape)
