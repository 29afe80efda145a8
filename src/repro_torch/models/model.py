"""Top-level model: embeddings and frontends, the stack, the unembedding;
prefill, decode and the training loss.

Port of ``repro.models.model`` for ``init_cache``, ``prefill``,
``decode_step``, ``chunked_lm_loss`` and ``train_loss``; the parameters
come from ``repro_torch.models.params``.  The entry points run on
``device`` (default cuda), where ``params`` must lie, and keep f32 products
in full f32 (no TF32).  The cache is a list with one dict per layer and is
updated in place (the reference returns a new one).

* Frontends: ``audio_frames`` takes ``batch["frames"]`` (B, S, M) as the
  embeddings; ``vision`` overwrites the first rows of the token embeddings
  with ``batch["vision_embeds"]`` (B, n, M) where it is given.
* Positions: start..start+S-1 for every row (three equal streams for
  M-RoPE), or ``batch["positions"]``, (B, S) or M-RoPE's (B, S, 3).  The
  reference's masks compare key positions with stream 0 of the positions
  (attention.py:56, 103, 122-129); where stream 0 is not the row index
  start..start+S-1 the attention layers get it as ``pos`` and hand it to
  the kernels' position masks (``models/attention.py``).  Where it is the
  row index, the index masks are the same function and ``pos`` is None.
* The encoder-only forward (``cfg.encoder_only``) is ``prefill`` without a
  cache: it returns (logits of the last row, None) and has no decode step.
* ``train_loss`` is the forward without a cache, with gradients: on a card
  the attention and Mamba layers run their forward kernels with hand-written
  backward kernels as their gradients (``kernels/flash_attention.py``,
  ``kernels/ssm_scan.py``).  ``chunked_lm_loss`` takes the loss over
  chunks of 512 rows, each recomputed in the backward pass, so no (B, S, V)
  logits are kept.
* The sharding constraints sit at the reference's sites (model.py:71, 102,
  114, 146) and, like those of the layers, do nothing without a mesh
  (``repro_torch.distributed.sharding``).
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, layer_specs
from repro_torch.device import resolve
from repro_torch.distributed.sharding import constrain
from repro_torch.models import blocks
from repro_torch.models.common import (dtype_of, masked_nll, rms_norm,
                                       rope_angles, softmax_cross_entropy)


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
        else:
            cache.append({
                "h": torch.zeros((batch, cfg.d_inner, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner),
                                    dtype=dt, device=dev)})
    return cache


def unembed_matrix(params, cfg: ModelConfig):
    if cfg.tie_embeddings:
        return params["embed"].T  # (M, V)
    return params["unembed"]


def _start(params, cfg: ModelConfig, device):
    """The device both entry points run on, after their shared checks."""
    dev = resolve(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, not {dev}")
    # PyTorch's default, set here so that a caller's TF32 choice cannot
    # loosen f32 configs: TF32 keeps about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def _embed(params, cfg: ModelConfig, batch: dict, dev):
    """(B, S, M) in ``cfg.dtype``: the frames, or the token embeddings with
    the vision embeddings over their first rows."""
    dt = dtype_of(cfg)
    if cfg.frontend == "audio_frames":
        x = torch.as_tensor(batch["frames"], device=dev).to(dt)
        return constrain(x, "batch", "seq", None)
    x = params["embed"][torch.as_tensor(batch["tokens"], device=dev)].to(dt)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        v = torch.as_tensor(batch["vision_embeds"], device=dev)
        if v.shape[1] > x.shape[1]:
            raise ValueError(f"{v.shape[1]} vision embeddings do not fit "
                             f"{x.shape[1]} positions")
        x[:, :v.shape[1]] = v.to(dt)
    return constrain(x, "batch", "seq", None)


def _rope(cfg: ModelConfig, batch: dict, B: int, S: int, start: int, dev):
    """(cos/sin of the positions, or None where the config has no rope;
    stream 0 of given positions as (B, S) int32 where it is not the row
    index start..start+S-1, else None)."""
    index = torch.arange(start, start + S, dtype=torch.int32, device=dev)
    mask_pos = None
    if "positions" in batch:
        pos = torch.as_tensor(batch["positions"], device=dev)
        stream0 = (pos[..., 0] if pos.dim() == 3 else pos).to(torch.int32)
        if not torch.equal(stream0, index.expand(B, S)):
            mask_pos = stream0.contiguous()
    else:
        pos = index.expand(B, S)
        if cfg.rope_kind == "mrope":
            pos = pos[..., None].expand(B, S, 3)
    if cfg.rope_kind == "none":
        return None, mask_pos
    return rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                       cfg.mrope_sections if cfg.rope_kind == "mrope"
                       else None), mask_pos


def _logits(params, cfg: ModelConfig, x):
    """(B, 1, M) -> (B, V) after the final norm."""
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ unembed_matrix(params, cfg).to(x.dtype))[:, 0]


@torch.no_grad()
def prefill(params, cfg: ModelConfig, batch: dict, max_len: int | None = None,
            device=None):
    """Forward over a prompt, filling a new cache.  batch["tokens"]: (B, S),
    any S >= 1 (``batch["frames"]`` (B, S, M) for the audio frontend).
    Returns (last_logits (B, V), cache of ``max_len`` rows, default S); the
    encoder-only forward returns no cache."""
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev)
    B, S = x.shape[:2]
    max_len = max_len or S
    if S < 1 or max_len < S:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    rope, pos = _rope(cfg, batch, B, S, 0, dev)
    cache = None if cfg.encoder_only else init_cache(cfg, B, max_len,
                                                     device=dev)
    x, _ = blocks.apply_stack(cfg, params["layers"], x, rope, cache, pos=pos)
    return _logits(params, cfg, x[:, -1:]), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache, cache_len: int,
                device=None):
    """One incremental token.  batch["tokens"]: (B, 1).  Returns (logits
    (B, V), cache), the cache written at ``cache_len``."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev)
    B, S = x.shape[:2]
    rope, pos = _rope(cfg, batch, B, S, cache_len, dev)
    kv_len = torch.full((B,), cache_len + S, dtype=torch.int32, device=dev)
    x, _ = blocks.apply_stack(cfg, params["layers"], x, rope, cache, cache_len,
                              kv_len, pos=pos)
    return _logits(params, cfg, x), cache


def _chunk_nll(xc, w, tc, mc):
    """``masked_nll`` of one chunk; its (B, chunk, V) logits in f32 live
    only inside this call."""
    return masked_nll(constrain(xc @ w, "batch", "seq", "vocab"), tc, mc)


def chunked_lm_loss(params, cfg: ModelConfig, x, targets, mask,
                    chunk: int = 512):
    """Mean masked NLL of the unembedded x (B, S, M); above ``chunk`` rows S
    must be a multiple of it, and each chunk's logits are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint``)."""
    B, S, M = x.shape
    w = unembed_matrix(params, cfg).to(x.dtype)
    if S <= chunk:
        return softmax_cross_entropy(
            constrain(x @ w, "batch", "seq", "vocab"), targets, mask)
    if S % chunk:
        raise ValueError(f"S={S} must be a multiple of the loss chunk {chunk}")
    tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        t, n = checkpoint(_chunk_nll, x[:, sl], w, targets[:, sl], mask[:, sl],
                          use_reentrant=False)
        tot, cnt = tot + t, cnt + n
    return tot / cnt.clamp_min(1.0)


def train_loss(params, cfg: ModelConfig, batch: dict, remat: bool = True,
               device=None):
    """Causal-LM (or masked-prediction for encoder archs) training loss.
    batch: "tokens" (B, S) (or "frames" (B, S, M)), "targets" (B, S), and
    optionally "loss_mask" (B, S), "positions", "vision_embeds".  Returns
    (loss = nll + 0.01 aux, {"nll", "aux"}) as 0-dim f32 tensors; with
    ``remat`` each layer is recomputed in the backward pass."""
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev)
    B, S = x.shape[:2]
    rope, pos = _rope(cfg, batch, B, S, 0, dev)
    x, aux = blocks.apply_stack(cfg, params["layers"], x, rope, None, pos=pos,
                                remat=remat)
    x = constrain(rms_norm(x, params["final_norm"], cfg.norm_eps), "batch",
                  "seq_sp", None)
    targets = torch.as_tensor(batch["targets"], device=dev)
    mask = (torch.as_tensor(batch["loss_mask"], device=dev)
            if "loss_mask" in batch
            else torch.ones((B, S), dtype=torch.float32, device=dev))
    nll = chunked_lm_loss(params, cfg, x, targets, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}
