"""Decoder layers: a plain loop over depth.

Port of ``repro.models.blocks``.  The reference scans over stacked layer
periods to bound XLA compile time; PyTorch runs eagerly, so the port loops
over its per-layer parameter dicts.  A layer is an attention or a Mamba
mixer, followed by a dense MLP, an MoE MLP or none (Jamba puts MoE after
Mamba mixers too).

``cache_len`` None means a forward over the whole context: the cache starts
empty, or is None for the encoder-only forward, which keeps none.
Otherwise it is a decode step at ``cache_len``, with ``kv_len`` (B,) =
cache_len + 1.  ``pos`` (B, S) int32 is stream 0 of given positions, which
the attention masks compare (None: the row index).  Both functions return
the MoE layers' summed aux loss beside x, as the reference does: 0.0 where
no layer is MoE.

``remat`` (training) recomputes each layer in the backward pass instead of
keeping its activations, the reference's per-layer ``jax.checkpoint``: the
layer runs under ``torch.utils.checkpoint`` (non-reentrant), which keeps
only the layer's input, and gives the gradients of ``remat=False``.
Under a mesh the recomputation issues the layer's collectives again, in the
same order on every rank, with the sharding context made active again
(``sharding.recompute_context``: on a card autograd recomputes in its own
thread).
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import LayerSpec, ModelConfig, layer_specs
from repro_torch.distributed.sharding import constrain, recompute_context
from repro_torch.models import attention, mamba, mlp, moe
from repro_torch.models.common import rms_norm


def apply_layer(cfg: ModelConfig, spec: LayerSpec, params: dict, x, rope,
                cache, cache_len=None, kv_len=None, pos=None):
    """Pre-norm residual layer; ``cache`` is updated in place.  Returns
    (x, aux).  Under a mesh the residual and each branch's output are laid
    out alike before each sum, so the sum moves nothing."""
    x = constrain(x, "batch", "seq_sp", None)
    h = rms_norm(x, params["ln1"], cfg.norm_eps)
    if spec.kind == "mamba":
        y = mamba.mamba_mixer(params["mamba"], h, cfg, cache)
    elif cache_len is None:
        y = attention.prefill_attention(params["attn"], h, cfg, rope, cache,
                                        window=spec.window, pos=pos)
    else:
        y = attention.decode_attention(params["attn"], h, cfg, rope, cache,
                                       cache_len, kv_len, window=spec.window,
                                       pos=pos)
    x = x + constrain(y, "batch", "seq_sp", None)
    aux = 0.0
    if spec.mlp == "dense":
        x = x + mlp.mlp(params["mlp"], rms_norm(x, params["ln2"], cfg.norm_eps))
    elif spec.mlp == "moe":
        y2, aux = moe.moe(params["moe"],
                          rms_norm(x, params["ln2"], cfg.norm_eps), cfg)
        x = x + y2
    return constrain(x, "batch", "seq_sp", None), aux


def apply_stack(cfg: ModelConfig, layers: list, x, rope, cache,
                cache_len=None, kv_len=None, pos=None, remat=False):
    """Every layer in order; ``cache[i]`` is layer i's cache (``cache``
    None: no layer keeps one).  Returns (x, aux summed over the layers)."""
    specs = layer_specs(cfg)
    cache = [None] * len(specs) if cache is None else cache
    aux = 0.0
    for spec, p, c in zip(specs, layers, cache, strict=True):
        if remat:
            x, a = checkpoint(apply_layer, cfg, spec, p, x, rope, c,
                              cache_len, kv_len, pos, use_reentrant=False,
                              context_fn=recompute_context())
        else:
            x, a = apply_layer(cfg, spec, p, x, rope, c, cache_len, kv_len,
                               pos)
        aux = aux + a
    return x, aux
