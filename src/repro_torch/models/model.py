"""Top-level decoder, decode path: embeddings, the stack, the unembedding.

Port of ``repro.models.model`` for ``init_cache`` and ``decode_step``; the
parameters come from ``repro_torch.models.params``.  Prefill, ``train_loss``
and the chunked loss come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_specs
from repro_torch.device import resolve
from repro_torch.models import blocks
from repro_torch.models.common import dtype_of, rms_norm, rope_angles


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """One {"k", "v"} of zeros, (batch, max_len, Hkv, D) in ``cfg.dtype``,
    per layer, on ``device`` (default cuda)."""
    dev = resolve(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    cache = []
    for spec in layer_specs(cfg):
        if spec.kind != "attn":
            raise NotImplementedError(f"{spec.kind} caches are not ported yet")
        cache.append({"k": torch.zeros(shape, dtype=dtype_of(cfg), device=dev),
                      "v": torch.zeros(shape, dtype=dtype_of(cfg), device=dev)})
    return cache


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T  # (M, V)
    return params["unembed"]


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache, cache_len: int,
                device=None):
    """One incremental token.  batch["tokens"]: (B, 1).  Returns (logits
    (B, V), cache).

    Runs on ``device`` (default cuda), where ``params`` and ``cache`` must
    lie.  The cache is updated in place (the reference returns a new one)
    and returned for the reference's call shape.
    """
    dev = resolve(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, not {dev}")
    # PyTorch's default, set here so that a caller's TF32 choice cannot
    # loosen f32 configs: TF32 keeps about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    B, S = tokens.shape
    x = params["embed"][tokens].to(dtype_of(cfg))
    rope = None
    if cfg.rope_kind == "default":
        pos = torch.full((B, S), cache_len, dtype=torch.int32, device=dev)
        rope = rope_angles(pos, cfg.head_dim, cfg.rope_theta)
    elif cfg.rope_kind != "none":
        raise NotImplementedError(f"{cfg.rope_kind} rope is not ported yet")
    kv_len = torch.full((B,), cache_len + S, dtype=torch.int32, device=dev)
    x = blocks.apply_stack(cfg, params["layers"], x, rope, cache, cache_len,
                           kv_len)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ unembed_matrix(params, cfg).to(x.dtype)
    return logits[:, 0], cache
