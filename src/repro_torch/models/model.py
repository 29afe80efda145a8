"""Top-level decoder: embeddings, the stack, the unembedding; prefill and
decode.

Port of ``repro.models.model`` for ``init_cache``, ``prefill`` and
``decode_step``; the parameters come from ``repro_torch.models.params``.
Both entry points run on ``device`` (default cuda), where ``params`` must
lie, and keep f32 products in full f32 (no TF32).  The cache is a list with
one dict per layer and is updated in place (the reference returns a new
one).  Positions are start..start+S-1 for every row; M-RoPE, positions
given in ``batch["positions"]``, the vision and audio frontends, the
encoder-only forward, ``train_loss`` and the chunked loss come with later
slices and raise NotImplementedError.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, layer_specs
from repro_torch.device import resolve
from repro_torch.models import blocks
from repro_torch.models.common import dtype_of, rms_norm, rope_angles


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeros on ``device`` (default cuda), one dict per layer: {"k", "v"} of
    (batch, max_len, Hkv, D) in ``cfg.dtype`` for attention, {"h":
    (batch, I, N) f32, "conv": (batch, W-1, I) in ``cfg.dtype``} for Mamba."""
    dev = resolve(device)
    dt = dtype_of(cfg)
    cache = []
    for spec in layer_specs(cfg):
        if spec.kind == "attn":
            shape = (batch, max_len, cfg.n_kv_heads, cfg.head_dim)
            cache.append({"k": torch.zeros(shape, dtype=dt, device=dev),
                          "v": torch.zeros(shape, dtype=dt, device=dev)})
        elif spec.kind == "mamba":
            cache.append({
                "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                    dtype=dt, device=dev)})
        else:
            raise NotImplementedError(f"{spec.kind} caches are not ported yet")
    return cache


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T  # (M, V)
    return params["unembed"]


def _start(params, cfg: ModelConfig, batch: dict, device):
    """The device, the tokens, and the checks both entry points share."""
    dev = resolve(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, not {dev}")
    for name, what in (("frontend", cfg.frontend != "none"),
                       ("encoder-only", cfg.encoder_only),
                       ("mrope", cfg.rope_kind == "mrope"),
                       ("batch['positions']", "positions" in batch)):
        if what:
            raise NotImplementedError(
                f"{cfg.name}: the {name} path is not ported yet")
    # PyTorch's default, set here so that a caller's TF32 choice cannot
    # loosen f32 configs: TF32 keeps about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev, torch.as_tensor(batch["tokens"], device=dev)


def _rope(cfg: ModelConfig, B: int, S: int, start: int, dev):
    """cos/sin of the positions start..start+S-1 for every row, or None."""
    if cfg.rope_kind == "none":
        return None
    pos = torch.arange(start, start + S, dtype=torch.int32, device=dev)
    return rope_angles(pos.expand(B, S), cfg.head_dim, cfg.rope_theta)


def _logits(params, cfg: ModelConfig, x):
    """(B, 1, M) -> (B, V) after the final norm."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ unembed_matrix(params, cfg).to(x.dtype))[:, 0]


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, max_len: int | None = None,
            device=None):
    """Forward over a prompt, filling a new cache.  batch["tokens"]: (B, S),
    any S >= 1.  Returns (last_logits (B, V), cache of ``max_len`` rows,
    default S)."""
    dev, tokens = _start(params, cfg, batch, device)
    B, S = tokens.shape
    max_len = max_len or S
    if S < 1 or max_len < S:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    x = params["embed"][tokens].to(dtype_of(cfg))
    rope = _rope(cfg, B, S, 0, dev)
    cache = init_cache(cfg, B, max_len, device=dev)
    x = blocks.apply_stack(cfg, params["layers"], x, rope, cache)
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache, cache_len: int,
                device=None):
    """One incremental token.  batch["tokens"]: (B, 1).  Returns (logits
    (B, V), cache), the cache written at ``cache_len``."""
    dev, tokens = _start(params, cfg, batch, device)
    B, S = tokens.shape
    x = params["embed"][tokens].to(dtype_of(cfg))
    rope = _rope(cfg, B, S, cache_len, dev)
    kv_len = torch.full((B,), cache_len + S, dtype=torch.int32, device=dev)
    x = blocks.apply_stack(cfg, params["layers"], x, rope, cache, cache_len,
                           kv_len)
    return _logits(params, cfg, x), cache
