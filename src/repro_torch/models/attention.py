"""GQA attention, decode path: one new token against the KV cache.

Port of ``repro.models.attention.multihead_attention`` for the case the
engine runs: a cache is given and S = 1.  q/k/v projections, qk-norm, NeoX
rope, the cache write at ``cache_len``, then the CUDA ``decode_attention``
kernel (its plain version on the CPU) over the cache with GQA.  The
reference computes this attention in XLA (``_attend_chunk``); the kernel
computes the same function with p kept in f32 where the reference casts it
to the cache dtype before P.V.

The cache is the reference's layout, {"k", "v"} of (B, L, Hkv, D), and is
updated in place; the kernel reads it through a permuted (B, Hkv, L, D) view.
Prefill, sliding windows and M-RoPE come with later slices.
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.common import apply_rope, rms_norm


def decode_attention(params: dict, x, cfg: ModelConfig, rope, cache: dict,
                     cache_len: int, kv_len, window=None):
    """x: (B, 1, M); rope: (cos, sin) of (B, 1, D/2) or None; kv_len: (B,)
    int32 = cache_len + 1.  Writes the new k, v into ``cache`` at
    ``cache_len`` and returns y (B, 1, M)."""
    if window is not None:
        raise NotImplementedError("sliding-window attention is not ported yet")
    B, S, M = x.shape
    if S != 1:
        raise NotImplementedError("the port has the decode path only (S = 1)")
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
    ck, cv = cache["k"], cache["v"]
    ck[:, cache_len] = k[:, 0].to(ck.dtype)
    cv[:, cache_len] = v[:, 0].to(cv.dtype)
    out = ops.decode_attention(
        q[:, 0], ck.to(x.dtype).permute(0, 2, 1, 3),
        cv.to(x.dtype).permute(0, 2, 1, 3), kv_len)  # (B, H, D)
    return out.reshape(B, S, H * D) @ params["wo"].to(x.dtype).reshape(H * D, M)
