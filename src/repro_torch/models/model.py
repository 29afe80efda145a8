"""Top-level model: embeddings and frontends, the stack, the unembedding;
prefill, decode and the training loss.

Port of ``repro.models.model`` for ``init_cache``, ``prefill``,
``decode_step``, ``chunked_lm_loss`` and ``train_loss``; the parameters
come from ``repro_torch.models.params``.  ``abstract_params`` and
``cache_specs`` give the :class:`ParamSpec` trees of the parameters and of
``init_cache``'s output (shape, dtype, the reference's logical axes), with
one entry per layer where the reference stacks them.  The entry points run on
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
* Under a mesh (``sharding_ctx(mesh, rules)``, parameters placed by
  ``distribute``: ``launch/specs.py::build_lowerable`` gives both) prefill
  and decode run sharded.  The batch is distributed by its spec, each rank
  looks the tokens up in its shard of the vocab-split table and the ranks'
  rows are summed (``_embed``), every activation is a DTensor from
  there on, the cache holds only each rank's shards (``init_cache``), and
  the logits come back vocab-sharded as DTensors (``sharding.full``
  gathers them).  Every config runs so: the frames, the vision
  embeddings and the positions are distributed by ("batch", None, None),
  each rank writes the vision rows of its batch rows and builds cos and
  sin from its rows' positions, and the MoE layers run each rank's
  experts (``models/moe.py``).
* Training runs sharded too, for every config: the gradients flow back
  through the same collectives (``sharding.redistribute``'s transposes),
  and the loss is taken over logits split by vocab and rows split by batch
  (``common.masked_nll``, ``chunked_lm_loss``), summed over the batch
  ranks before the division.  The frames carry no gradient to the
  embedding table, whose gradient is then zero as ``jax.grad`` gives it
  (``train_loop``); the vision rows replace the token embeddings of the
  rank's rows out of place, so the overwritten rows' tokens get no
  gradient, as the reference's ``dynamic_update_slice`` gives.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, layer_specs
from repro_torch.device import resolve
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.models import blocks
from repro_torch.models.common import (dtype_of, masked_nll, rms_norm,
                                       rope_angles)
from repro_torch.models.params import ParamSpec, param_specs
from repro_torch.train.tree import map_tree


def abstract_params(cfg: ModelConfig) -> dict:
    """The ParamSpec tree of the parameters (``params.param_specs``)."""
    return param_specs(cfg)


def cache_specs(cfg: ModelConfig, batch: int, max_len: int) -> list:
    """The ParamSpec tree of ``init_cache(cfg, batch, max_len)``: one dict a
    layer, with the logical axes of the reference's
    ``blocks.layer_cache_specs`` (its stacked leaves have one more,
    leading, unnamed axis)."""
    dt = dtype_of(cfg)
    out = []
    for spec in layer_specs(cfg):
        if spec.kind == "attn":
            kv = ParamSpec((batch, max_len, cfg.n_kv_heads, cfg.head_dim), dt,
                           ("batch", "kv_seq", "kv_heads", None))
            out.append({"k": kv, "v": kv})
        else:
            out.append({
                "h": ParamSpec((batch, cfg.d_inner, cfg.ssm_state),
                               torch.float32,
                               ("batch", "ssm_inner", "ssm_state")),
                "conv": ParamSpec((batch, cfg.d_conv - 1, cfg.d_inner), dt,
                                  ("batch", None, "ssm_inner"))})
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    """Zeros on ``device`` (default cuda), one dict per layer: {"k", "v"} of
    (batch, max_len, Hkv, D) in ``cfg.dtype`` for attention, {"h":
    (batch, I, N) f32, "conv": (batch, W-1, I) in ``cfg.dtype``} for Mamba
    (``cache_specs``).  Under a mesh of several devices each leaf is a
    DTensor laid out by its logical axes under the active rules, of which
    each rank allocates only its shard."""
    mesh = sh.active_mesh()
    return _new_cache(cfg, batch, max_len, resolve(device),
                      mesh is not None and mesh.size() > 1)


def _new_cache(cfg: ModelConfig, batch: int, max_len: int, dev, sharded):
    if sharded:
        return map_tree(lambda s: sh.zeros(s.shape, s.dtype, s.logical, dev),
                        cache_specs(cfg, batch, max_len))
    return map_tree(lambda s: torch.zeros(s.shape, dtype=s.dtype, device=dev),
                    cache_specs(cfg, batch, max_len))


def unembed_matrix(params, cfg: ModelConfig):
    """(M, V); sharded, its FSDP split gathered."""
    if cfg.tie_embeddings:
        return sh.gathered(params["embed"]).T  # (M, V)
    return sh.gathered(params["unembed"])


def _mesh_check(params) -> bool:
    """Whether the entry point runs sharded: the parameters are DTensors
    (placed by ``distribute``), under an active mesh."""
    sharded = sh.is_dtensor(params["embed"])
    if sharded and sh.active_mesh() is None:
        raise ValueError("DTensor parameters need an active mesh "
                         "(sharding_ctx(mesh, rules))")
    return sharded


def _batch_tensor(a, dev, sharded: bool, *logical):
    """A batch entry on ``dev``; sharded, a DTensor laid out by the logical
    axes (one that is already a DTensor is kept)."""
    if sh.is_dtensor(a):
        return a
    t = torch.as_tensor(a, device=dev)
    if not sharded:
        return t
    return sh.distribute(t, sh.to_pspec(logical, shape=tuple(t.shape)),
                         sh.active_mesh())


def _start(params, cfg: ModelConfig, device):
    """The device both entry points run on, after their shared checks."""
    dev = resolve(device)
    if params["embed"].device.type != dev.type:
        raise ValueError(f"params lie on {params['embed'].device}, not {dev}")
    # PyTorch's default, set here so that a caller's TF32 choice cannot
    # loosen f32 configs: TF32 keeps about three decimal digits
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev


def _embed(params, cfg: ModelConfig, batch: dict, dev, sharded=False):
    """(B, S, M) in ``cfg.dtype``: the frames, or the token embeddings with
    the vision embeddings over their first rows; sharded, each rank writes
    the vision embeddings of its batch rows.

    Sharded, the lookup runs on the rank's shard of the table as the
    reference's compiled ``jnp.take`` does (``_embed_split``): under
    ``TRAIN_RULES`` (prefill, training) the table's width is split over
    "data" ("embed_p", FSDP), and the rows are summed over the "vocab"
    axes at that width, then moved to the activation's batch split by one
    all-to-all over "data" (``redistribute``); the table's gradient comes
    back on the rank's own shard.  Under ``DECODE_RULES`` "embed_p" splits
    nothing, so decode sums whole rows and each rank keeps its batch rows
    (a local chunk).  These collectives are listed as "lookup" in
    ``sharding.recording``'s calls."""
    dt = dtype_of(cfg)
    if cfg.frontend == "audio_frames":
        x = _batch_tensor(batch["frames"], dev, sharded, "batch", None, None)
        return constrain(x.to(dt), "batch", "seq", None)
    tokens = _batch_tensor(batch["tokens"], dev, sharded, "batch", None)
    if sharded:
        with sh.labelled("lookup"):
            x = constrain(_embed_split(tokens, params["embed"]).to(dt),
                          "batch", "seq", None)
    else:
        x = constrain(F.embedding(tokens, params["embed"]).to(dt), "batch",
                      "seq", None)
    if cfg.frontend == "vision" and "vision_embeds" in batch:
        v = _batch_tensor(batch["vision_embeds"], dev, sharded, "batch", None,
                          None)
        if v.shape[1] > x.shape[1]:
            raise ValueError(f"{v.shape[1]} vision embeddings do not fit "
                             f"{x.shape[1]} positions")
        # x and v split their batch rows alike: each rank writes its own,
        # out of place, so the overwritten rows' tokens get no gradient
        v = sh.local(constrain(v, "batch", None, None)).to(dt)
        xl = sh.local(x)
        xl = torch.cat([v, xl[:, v.shape[1]:]], dim=1)
        x = sh.from_local(xl, x.shape, "batch", "seq", None) if sharded else xl
    return x


def _embed_split(tokens, table):
    """The embedding from the rank's shard of a table whose rows and
    columns may be split over the ranks: every rank looks up every token of
    the batch in its rows, at its columns (zero where another rank holds
    the token's row), and the sum over the ranks that split the rows keeps
    each token's one row, exactly.  Returns a (B, S, M) DTensor split by
    columns as the table is (over its axes of more than one rank),
    replicated over the others."""
    from torch.distributed.tensor import Replicate, Shard

    tokens = sh.local(constrain(tokens, None, None))
    rows, r0 = sh.local(table), sh.local_offset(table, 0)
    idx = tokens.long() - r0
    hit = (idx >= 0) & (idx < rows.shape[0])
    x = F.embedding(idx.clamp(0, rows.shape[0] - 1), rows) * hit[..., None]
    x = sh.psum(x, sh.shard_axes(table, 0))
    mesh = table.device_mesh
    cols = sh.shard_axes(table, 1)
    return sh.wrap_local(x, mesh, [
        Shard(2) if name in cols and mesh.size(m) > 1 else Replicate()
        for m, name in enumerate(mesh.mesh_dim_names)],
        shape=(*x.shape[:2], table.shape[1]))


def _off_index(stream0, index, rows) -> bool:
    """Whether some rank's (b, S) positions ``stream0`` are off the row
    index ``index`` (decided over the mesh axes ``rows``, so that every
    rank takes the same branch).  On the meta device (the dry run) no data
    decides it, and the positions are taken as given: the reference's
    traced mask always compares them."""
    if stream0.device.type == "meta":
        return True
    off = torch.tensor([float(not torch.equal(
        stream0, index.expand_as(stream0)))], device=stream0.device)
    return bool(sh.pmax(off, rows)[0] > 0)


def _rope(cfg: ModelConfig, batch: dict, B: int, S: int, start: int, dev,
          sharded=False):
    """(cos/sin of the positions, or None where the config has no rope;
    stream 0 of given positions as (B, S) int32 where it is not the row
    index start..start+S-1, else None).  Sharded, each rank builds cos and
    sin from the positions of its batch rows, and all of them DTensors
    split as the batch; whether stream 0 is the row index is decided over
    every rank's rows, so that all ranks take the same branch."""
    index = torch.arange(start, start + S, dtype=torch.int32, device=dev)
    mask_pos = None
    if "positions" in batch:
        given = batch["positions"]
        pos = _batch_tensor(given, dev, sharded, "batch",
                            *(None,) * (len(given.shape) - 1))
        rows = sh.shard_axes(pos, 0)
        pos = sh.local(pos)
        stream0 = (pos[..., 0] if pos.dim() == 3 else pos).to(torch.int32)
        if _off_index(stream0, index, rows):
            mask_pos = stream0.contiguous()
            if sharded:
                mask_pos = sh.from_local(mask_pos, (B, S), "batch", None)
    else:
        pos = index.expand(B, S)
        if cfg.rope_kind == "mrope":
            pos = pos[..., None].expand(B, S, 3)
    if cfg.rope_kind == "none":
        return None, mask_pos
    rope = rope_angles(pos, cfg.head_dim, cfg.rope_theta,
                       cfg.mrope_sections if cfg.rope_kind == "mrope"
                       else None)
    if sharded and "positions" in batch:  # the rank's rows
        rope = tuple(sh.from_local(t, (B, S, t.shape[-1]), "batch", "seq",
                                   None) for t in rope)
    elif sharded:  # every rank built the whole index's
        rope = sh.distribute(rope, sh.to_pspec(
            ("batch", "seq", None), shape=tuple(rope[0].shape)),
            sh.active_mesh())
    return rope, mask_pos


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
    encoder-only forward returns no cache.  Sharded (DTensor parameters
    under a mesh), the logits are vocab-sharded and the cache holds each
    rank's shards, both DTensors."""
    sharded = _mesh_check(params)
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev, sharded)
    B, S = x.shape[:2]
    max_len = max_len or S
    if S < 1 or max_len < S:
        raise ValueError(f"prefill of {S} tokens into a cache of {max_len}")
    rope, pos = _rope(cfg, batch, B, S, 0, dev, sharded)
    cache = None if cfg.encoder_only else _new_cache(cfg, B, max_len, dev,
                                                     sharded)
    x, _ = blocks.apply_stack(cfg, params["layers"], x, rope, cache, pos=pos)
    # the residual's rows may be split over the ranks: gather, keep the last
    last = constrain(x, "batch", "seq", None)[:, -1:]
    return _logits(params, cfg, last), cache


@torch.no_grad()
def decode_step(params, cfg: ModelConfig, batch: dict, cache, cache_len: int,
                device=None):
    """One incremental token.  batch["tokens"]: (B, 1).  Returns (logits
    (B, V), cache), the cache written at ``cache_len``; sharded, as
    ``prefill``."""
    if cfg.encoder_only:
        raise ValueError(f"{cfg.name} is encoder-only: it has no decode step")
    sharded = _mesh_check(params)
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev, sharded)
    B, S = x.shape[:2]
    rope, pos = _rope(cfg, batch, B, S, cache_len, dev, sharded)
    kv_len = torch.full((B,), cache_len + S, dtype=torch.int32, device=dev)
    x, _ = blocks.apply_stack(cfg, params["layers"], x, rope, cache, cache_len,
                              kv_len, pos=pos)
    return _logits(params, cfg, x), cache


def _chunk_nll(xc, w, tc, mc, vocab, v0):
    """``masked_nll`` of one chunk, every argument the rank's local shard
    (the logits split over the mesh axes ``vocab``, columns v0.. of the
    whole); its (B, chunk, V) logits in f32 live only inside this call."""
    return masked_nll(xc @ w, tc, mc, vocab=vocab, v0=v0)


def chunked_lm_loss(params, cfg: ModelConfig, x, targets, mask,
                    chunk: int = 512):
    """Mean masked NLL of the unembedded x (B, S, M); above ``chunk`` rows S
    must be a multiple of it, and each chunk's logits are recomputed in the
    backward pass instead of kept (the reference's ``jax.checkpoint``).

    On DTensors x is gathered over the sequence, so that each rank holds
    whole rows of its batch shard, times its columns of the vocab-split
    (M, V) unembedding; each chunk's NLL is taken on the rank's shards
    (``masked_nll`` over the vocab axes), and the masked sum and the count
    are summed over the batch axes before the division, as the
    reference's global mean.  x's gradient on each rank is its columns'
    term (summed over the vocab axes by the gather's transpose), the
    unembedding's its rows' term (summed over the batch axes by the FSDP
    gather's).  Plain tensors are the one-rank case: no axes, every sum
    the rank's own."""
    B, S, M = x.shape
    if S > chunk and S % chunk:
        raise ValueError(f"S={S} must be a multiple of the loss chunk {chunk}")
    w = unembed_matrix(params, cfg).to(x.dtype)
    x = constrain(x, "batch", "seq", None)
    vocab, rows = sh.shard_axes(w, 1), sh.shard_axes(x, 0)
    if sh.shard_axes(targets, 0) != rows or sh.shard_axes(mask, 0) != rows:
        raise ValueError("the targets and the mask must split their rows as "
                         "the activations do")
    xl, wl = sh.local(x, partial=vocab), sh.local(w, partial=rows)
    tl, ml = sh.local(targets), sh.local(mask)
    v0 = sh.local_offset(w, 1)
    tot = cnt = torch.zeros((), dtype=torch.float32, device=xl.device)
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        args = (xl[:, sl], wl, tl[:, sl], ml[:, sl], vocab, v0)
        if S <= chunk:
            t, n = _chunk_nll(*args)
        else:  # every rank recomputes its chunks' collectives in order
            t, n = checkpoint(_chunk_nll, *args, use_reentrant=False,
                              context_fn=sh.recompute_context())
        tot, cnt = tot + t, cnt + n
    tot, cnt = sh.psum(torch.stack([tot, cnt]), rows)
    return tot / cnt.clamp_min(1.0)


def train_loss(params, cfg: ModelConfig, batch: dict, remat: bool = True,
               device=None):
    """Causal-LM (or masked-prediction for encoder archs) training loss.
    batch: "tokens" (B, S) (or "frames" (B, S, M)), "targets" (B, S), and
    optionally "loss_mask" (B, S), "positions", "vision_embeds".  Returns
    (loss = nll + 0.01 aux, {"nll", "aux"}) as 0-dim f32 tensors; with
    ``remat`` each layer is recomputed in the backward pass.  Sharded
    (DTensor parameters under a mesh), the batch entries are placed by
    their logical axes unless they are DTensors already, and the loss is
    replicated: every rank's the same."""
    sharded = _mesh_check(params)
    dev = _start(params, cfg, device)
    x = _embed(params, cfg, batch, dev, sharded)
    B, S = x.shape[:2]
    rope, pos = _rope(cfg, batch, B, S, 0, dev, sharded)
    x, aux = blocks.apply_stack(cfg, params["layers"], x, rope, None, pos=pos,
                                remat=remat)
    x = constrain(rms_norm(x, params["final_norm"], cfg.norm_eps), "batch",
                  "seq_sp", None)
    targets = _batch_tensor(batch["targets"], dev, sharded, "batch", None)
    mask = _batch_tensor(batch["loss_mask"] if "loss_mask" in batch else
                         torch.ones((B, S), dtype=torch.float32, device=dev),
                         dev, sharded, "batch", None)
    nll = chunked_lm_loss(params, cfg, x, targets, mask)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=dev)
    loss = nll + 0.01 * aux
    return loss, {"nll": nll, "aux": aux}
