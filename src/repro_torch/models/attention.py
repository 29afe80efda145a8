"""GQA attention: prefill over a prompt, and decode against the KV cache.

Port of ``repro.models.attention.multihead_attention``.  Both paths compute
the q/k/v projections, qk-norm and NeoX rope (M-RoPE's sections are in the
cos/sin the model hands in), and write k, v into the cache in the
reference's layout, {"k", "v"} of (B, L, Hkv, D), in place.

* Prefill (``prefill_attention``) starts at cache_len 0: it writes the S new
  keys and values at ``[:, :S]`` and attends with the CUDA
  ``flash_attention`` kernel (its plain version on the CPU) over those fresh
  keys, causal as ``cfg.causal`` says and windowed where the layer has a
  window.  The reference attends over the whole zeroed cache masked at
  kv_len = S with keys repeated G times; that is the same function.  The
  kernel reads the (B, S, Hkv, D) projections through strides, query head h
  reading KV head h // G: no repeat, no copy.  The encoder-only forward has
  no cache (``cache`` None) and writes none.
* Decode (``decode_attention``, S = 1) writes at ``cache_len`` and runs the
  CUDA ``decode_attention`` kernel over the cache, read through a permuted
  (B, Hkv, L, D) view.  A windowed layer keeps the keys at positions
  > cache_len - window (reference attention.py:57-58): every row of the
  batch shares cache_len, so they are the cache's rows r0..cache_len with
  r0 = max(0, cache_len + 1 - window), and the kernel reads a view that
  starts at row r0, with kv_len cut by r0.  Nothing is copied.
* Given positions (``pos``, stream 0 of ``batch["positions"]``, (B, S)):
  the reference's mask compares key positions with the query's stream 0
  (attention.py:122-129).  With a cache the keys' positions are the cache
  rows, so prefill hands the kernel q_pos = pos over the row index, and
  decode attends over rows [max(0, pos - window + 1), min(cache_len + 1,
  pos + 1)) of the whole cache (``kv_start``, ``kv_len`` per row).  Without
  a cache (training, the encoder-only forward) the keys' positions are the
  given ones: q_pos = k_pos = pos.
* Training calls ``prefill_attention`` with no cache and gradients on: on a
  card ``flash_attention`` runs its forward kernel with the backward kernel
  as its gradient.

The reference casts p to the value dtype before P.V; the flash kernel does
the same, the decode kernel keeps p in f32.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm


def _qkv(params: dict, x, cfg: ModelConfig, rope):
    """q (B, S, H, D), k and v (B, S, Hkv, D), after qk-norm and rope."""
    B, S, M = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ params["wq"].to(x.dtype).reshape(M, H * D)).view(B, S, H, D)
    k = (x @ params["wk"].to(x.dtype).reshape(M, Hkv * D)).view(B, S, Hkv, D)
    v = (x @ params["wv"].to(x.dtype).reshape(M, Hkv * D)).view(B, S, Hkv, D)
    if cfg.qk_norm:
        q = rms_norm(q, params["q_norm"], cfg.norm_eps)
        k = rms_norm(k, params["k_norm"], cfg.norm_eps)
    if rope is not None:
        q = apply_rope(q, *rope)
        k = apply_rope(k, *rope)
    return q, k, v


def _out(params: dict, out, x):
    """out: (B, S, H, D) -> y (B, S, M)."""
    B, S, H, D = out.shape
    return out.reshape(B, S, H * D) @ params["wo"].to(x.dtype).reshape(
        H * D, x.shape[-1])


def prefill_attention(params: dict, x, cfg: ModelConfig, rope, cache,
                      window=None, pos=None):
    """x: (B, S, M); rope: (cos, sin) of (B, S, D/2) or None; pos: (B, S)
    int32 positions of the mask, or None for the row index.  Writes k, v
    into ``cache`` at [:, :S] (unless it is None) and returns y (B, S, M)."""
    S = x.shape[1]
    q, k, v = _qkv(params, x, cfg, rope)
    if cache is not None:
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    out = ops.flash_attention(
        q.permute(0, 2, 1, 3), k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3),
        causal=cfg.causal, window=window or 0, q_pos=pos,
        k_pos=pos if cache is None else None)  # (B, H, S, D)
    return _out(params, out.permute(0, 2, 1, 3), x)


def decode_attention(params: dict, x, cfg: ModelConfig, rope, cache: dict,
                     cache_len: int, kv_len, window=None, pos=None):
    """x: (B, 1, M); rope: (cos, sin) of (B, 1, D/2) or None; kv_len: (B,)
    int32 = cache_len + 1; pos: (B, 1) int32 positions of the mask, or None
    for the row index.  Writes the new k, v into ``cache`` at ``cache_len``
    and returns y (B, 1, M)."""
    if x.shape[1] != 1:
        raise NotImplementedError("decode takes one token a step (S = 1)")
    q, k, v = _qkv(params, x, cfg, rope)
    ck, cv = cache["k"], cache["v"]
    ck[:, cache_len] = k[:, 0].to(ck.dtype)
    cv[:, cache_len] = v[:, 0].to(cv.dtype)
    kv_start = None
    if pos is not None:
        qp = pos[:, 0].to(kv_len.dtype)
        if cfg.causal:
            kv_len = torch.minimum(kv_len, qp + 1)
        if window:
            kv_start = (qp - window + 1).clamp_min(0)
    elif window:
        r0 = max(0, cache_len + 1 - window)
        ck, cv, kv_len = ck[:, r0:], cv[:, r0:], kv_len - r0
    out = ops.decode_attention(
        q[:, 0], ck.to(x.dtype).permute(0, 2, 1, 3),
        cv.to(x.dtype).permute(0, 2, 1, 3), kv_len,
        kv_start=kv_start)  # (B, H, D)
    return _out(params, out[:, None], x)
