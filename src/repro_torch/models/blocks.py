"""Decoder layers: a plain loop over depth.

Port of ``repro.models.blocks``.  The reference scans over stacked layer
periods to bound XLA compile time; PyTorch runs eagerly, so the port loops
over its per-layer parameter dicts.  Attention and Mamba layers with a dense
MLP (or none) run; MoE layers raise ``NotImplementedError`` until their
slice.

``cache_len`` None means prefill: the tokens are the whole context and the
cache starts empty.  Otherwise it is a decode step at ``cache_len``, with
``kv_len`` (B,) = cache_len + 1.
"""
from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_specs
from repro_torch.models import attention, mamba, mlp
from repro_torch.models.common import rms_norm


def apply_layer(cfg: ModelConfig, spec: LayerSpec, params: dict, x, rope,
                cache: dict, cache_len=None, kv_len=None):
    """Pre-norm residual layer; ``cache`` is updated in place.  Returns x."""
    if spec.mlp not in ("dense", "none"):
        raise NotImplementedError(f"{spec.mlp} MLPs are not ported yet")
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if spec.kind == "mamba":
        y = mamba.mamba_mixer(params["mamba"], h, cfg, cache)
    elif spec.kind != "attn":
        raise NotImplementedError(f"{spec.kind} layers are not ported yet")
    elif cache_len is None:
        y = attention.prefill_attention(params["attn"], h, cfg, rope, cache,
                                        window=spec.window)
    else:
        y = attention.decode_attention(params["attn"], h, cfg, rope, cache,
                                       cache_len, kv_len, window=spec.window)
    x = x + y
    if spec.mlp == "dense":
        x = x + mlp.mlp(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    return x


def apply_stack(cfg: ModelConfig, layers: list, x, rope, cache: list,
                cache_len=None, kv_len=None):
    """Every layer in order; ``cache[i]`` is layer i's cache."""
    for spec, p, c in zip(layer_specs(cfg), layers, cache, strict=True):
        x = apply_layer(cfg, spec, p, x, rope, c, cache_len, kv_len)
    return x
