"""Decoder layers, decode path: a plain loop over depth.

Port of ``repro.models.blocks``.  The reference scans over stacked layer
periods to bound XLA compile time; PyTorch runs eagerly, so the port loops
over its per-layer parameter dicts.  Attention layers with a dense MLP (or
none) run; Mamba and MoE layers raise ``NotImplementedError`` until their
slices.
"""
from __future__ import annotations

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_specs
from repro_torch.models import attention, mlp
from repro_torch.models.common import rms_norm


def apply_layer(cfg: ModelConfig, spec: LayerSpec, params: dict, x, rope,
                cache: dict, cache_len: int, kv_len):
    """Pre-norm residual layer.  Returns x."""
    if spec.kind != "attn":
        raise NotImplementedError(f"{spec.kind} layers are not ported yet")
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    x = x + attention.decode_attention(
        params["attn"], h, cfg, rope, cache, cache_len, kv_len,
        window=spec.window)
    if spec.mlp == "dense":
        x = x + mlp.mlp(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    elif spec.mlp != "none":
        raise NotImplementedError(f"{spec.mlp} MLPs are not ported yet")
    return x


def apply_stack(cfg: ModelConfig, layers: list, x, rope, cache: list,
                cache_len: int, kv_len):
    """Every layer in order; ``cache[i]`` is layer i's {"k", "v"}."""
    for spec, p, c in zip(layer_specs(cfg), layers, cache, strict=True):
        x = apply_layer(cfg, spec, p, x, rope, c, cache_len, kv_len)
    return x
