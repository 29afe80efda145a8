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

The sharding constraints sit at the reference's sites (attention.py:91-93,
118-119, 149-151, 183) and do nothing without a mesh.  Its constraint on the
decode scores (:66) has no tensor here: the kernel keeps the scores; and
the keys and values are not repeated to H heads (:149-151), so only q
takes that site's constraint.

Under a mesh (DTensor activations; ``launch/specs.py``) both paths run on
each rank's shards:

* Prefill.  The projections' input is gathered over the sequence (the
  residual between layers is sequence-sharded), q, k and v come out split
  by heads, and ``flash_attention`` runs on each rank's heads, query head h
  reading its KV head through the kernel's own GQA mapping.  Where the
  "model" axis splits the query heads but not the KV heads, each rank pairs
  its query heads with the slice of the replicated KV heads they read
  (``_paired``).  Where it does not divide the query heads, the reference
  repeats K and V to H heads and pads q, K and V with zero heads to the
  next multiple (attention.py:140-148): so does ``_padded``, on each rank's
  slice of the padded heads, and the padded heads are cut off before
  ``wo``.  The new keys and values are written into the rank's shard of
  the cache (``_write_rows``).
* Decode under ``DECODE_RULES``: the cache's rows are split over "model".
  The new row is written by the rank whose rows hold ``cache_len``; q is
  gathered over "model"; each rank runs ``decode_attention`` over the part
  of its own rows that the token attends to: the rows [start, end) of the
  unsharded mask (``_decode_rows``: up to cache_len, from cache_len + 1 -
  window in a windowed layer, and under given positions [max(0, pos -
  window + 1), min(cache_len + 1, pos + 1))), as kv_start and kv_len
  shifted by the rank's first row and clamped to its rows.  A rank with no
  row of the range has log-sum-exp -inf and weight 0, and the ranks'
  outputs are merged exactly from their log-sum-exps by all-reduces over
  "model" in f32 (``merge_partials``).  A cache whose rows are not split
  (their count not divisible) is split by heads, and decode then runs on
  heads as prefill, the same range given as kv_start and kv_len.
* Windows and given positions in prefill need nothing more: the kernel
  takes the window, and the positions (B, S) split by batch as q is.
* Training (no cache) runs prefill's path with gradients: they come back
  through the kernel's backward on each rank's shards and through the
  gathers of ``_qkv`` and ``_out`` (``sharding.redistribute``'s
  transposes).  Where a rank reads its slice of KV heads replicated over
  "model" beside its own query heads (``_paired``), its gradient of k and
  v is its term of a sum over "model", as its query heads' is, and the
  gather's transpose sums them together; where it reads its slice of the
  padded heads (``_padded``), the gradients of q, k and v are summed over
  "model" (``sharding.reduce_grad``), and the padded heads' gradients are
  dropped with them.  No DTensor operation mixes placements that DTensor
  would reconcile by itself (tests/test_torch_dtensor_placements.py).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import active_mesh, axis_sizes, constrain
from repro_torch.kernels import ops
from repro_torch.kernels.decode_attention import NEG_INF
from repro_torch.models.common import apply_rope, rms_norm


def _tp_size() -> int:
    mesh = active_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return 1
    return axis_sizes(mesh)["model"]


def _qkv(params: dict, x, cfg: ModelConfig, rope):
    """q (B, S, H, D), k and v (B, S, Hkv, D), after qk-norm and rope."""
    x = constrain(x, "batch", "seq", None)  # gather the sequence-split rows
    B, S, M = x.shape
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w = {n: sh.gathered(params[n]).to(x.dtype) for n in ("wq", "wk", "wv")}
    q = (x @ w["wq"].reshape(M, H * D)).view(B, S, H, D)
    k = (x @ w["wk"].reshape(M, Hkv * D)).view(B, S, Hkv, D)
    v = (x @ w["wv"].reshape(M, Hkv * D)).view(B, S, Hkv, D)
    q = constrain(q, "batch", "seq", "heads", None)
    k = constrain(k, "batch", "seq", "kv_heads", None)
    v = constrain(v, "batch", "seq", "kv_heads", None)
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
    out = sh.whole_on_one_rank(out)  # as wo, gathered
    y = out.reshape(B, S, H * D) @ sh.gathered(params["wo"]).to(
        x.dtype).reshape(H * D, x.shape[-1])
    return constrain(y, "batch", "seq_sp", None)


def prefill_attention(params: dict, x, cfg: ModelConfig, rope, cache,
                      window=None, pos=None):
    """x: (B, S, M); rope: (cos, sin) of (B, S, D/2) or None; pos: (B, S)
    int32 positions of the mask, or None for the row index.  Writes k, v
    into ``cache`` at [:, :S] (unless it is None) and returns y (B, S, M)."""
    S, H = x.shape[1], cfg.n_heads
    q, k, v = _qkv(params, x, cfg, rope)
    if cache is not None:
        for name, t in (("k", k), ("v", v)):
            _write_rows(cache[name], t, 0)
            cache[name] = constrain(cache[name], "batch", "kv_seq",
                                    "kv_heads", None)
    pad = S > 1 and cfg.q_per_kv > 1 and H % _tp_size()
    if S > 1 and cfg.q_per_kv > 1 and not pad:
        q = constrain(q, "batch", "seq", "heads", None)
    q, k, v = (t.permute(0, 2, 1, 3) for t in (q, k, v))  # heads first
    if pad:
        q, k, v = _padded(q, k, v, cfg)
    elif sh.is_dtensor(q):
        k, v = _paired(q, k, v, cfg)
    out = ops.flash_attention(
        q, k, v, causal=cfg.causal, window=window or 0, q_pos=pos,
        k_pos=pos if cache is None else None)  # (B, H, S, D)
    out = out.permute(0, 2, 1, 3)
    if pad:  # gather the padded heads and cut them off
        out = constrain(out, "batch", "seq", None, None)[:, :, :H]
    return _out(params, out, x)


def _model_rank(x) -> tuple:
    """(the "model" axis' size, this rank's index on it) of a DTensor's
    mesh."""
    mesh = x.device_mesh
    if "model" not in mesh.mesh_dim_names:
        return 1, 0
    return axis_sizes(mesh)["model"], mesh.get_local_rank("model")


def _heads_dtensor(t, tp: int, B: int):
    """The rank's local (b, h, S, D) ``t`` as its shard of a (B, tp * h, S,
    D) DTensor split over batch and heads."""
    return sh.from_local(t, (B, tp * t.shape[1], *t.shape[2:]), "batch",
                         "heads", None, None)


def _kv_for(k, heads, G: int):
    """The KV heads that query heads ``heads`` (a range) read, from the
    local (B, S, Hkv, D) ``k``: a slice where the range holds whole groups
    (or lies in one), else one KV head per query head (index h // G)."""
    idx = torch.arange(heads.start, heads.stop) // G
    first, n = int(idx[0]), int(idx[-1] - idx[0]) + 1
    g = len(idx) // n
    if len(idx) % n == 0 and torch.equal(
            idx, first + torch.arange(len(idx)) // g):
        return k[:, :, first:first + n]
    return k[:, :, idx.to(k.device)]


def _paired(q, k, v, cfg: ModelConfig):
    """k, v for q split over "model" by heads: as they are where "model"
    splits the KV heads alike; where it splits only the query heads, each
    rank's slice of the replicated KV heads, paired with its query heads.

    Each rank's gradient of k and v is then its term of a sum over "model"
    (``Partial()``), as the gradient of the layer's input through its query
    heads is, so that autograd sums terms of one placement.  The heads are
    picked in the projections' (B, S, Hkv, D) layout, and their gradient is
    made contiguous there (``_ContiguousGrad``): DTensor reduces a partial
    sum that it must copy (the reshape of a strided gradient) instead of
    keeping it partial.  A slice of every KV head (one KV head, say) is an
    alias, whose gradient is the attention's own: strided on the CPU, where
    autograd runs through the plain attention (the kernels' and the meta
    routes' come back contiguous)."""
    tp, r = _model_rank(q)
    if tp == 1 or sh.shard_axes(k, 1) or not sh.shard_axes(q, 1):
        return k, v
    hl = cfg.n_heads // tp
    heads = range(r * hl, (r + 1) * hl)
    return tuple(_heads_dtensor(_ContiguousGrad.apply(_kv_for(
        sh.local(t, partial=("model",)).transpose(1, 2), heads,
        cfg.q_per_kv)).transpose(1, 2), tp, q.shape[0]) for t in (k, v))


class _ContiguousGrad(torch.autograd.Function):
    """The identity; its gradient made contiguous (a copy where it is
    strided, the values unchanged)."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _padded(q, k, v, cfg: ModelConfig):
    """The reference's head padding (attention.py:140-148) on each rank's
    slice: q (B, H, S, D) and k, v (B, Hkv, S, D), replicated over "model",
    become this rank's Hp / tp of the Hp = H rounded up to a multiple of tp
    heads, K and V repeated to one head per query head, the padded heads
    zero."""
    tp, r = _model_rank(q)
    H, hl = cfg.n_heads, -(-cfg.n_heads // tp)
    heads = range(r * hl, min((r + 1) * hl, H))
    # each rank reads its own heads: their gradients summed over "model"
    ql, kl, vl = (sh.reduce_grad(sh.local(t), ("model",)) for t in (q, k, v))
    idx = torch.tensor([h // cfg.q_per_kv for h in heads], dtype=torch.long,
                       device=kl.device)

    def pad(t):
        z = t.new_zeros((t.shape[0], hl - len(heads), *t.shape[2:]))
        return torch.cat([t, z], dim=1)

    return tuple(_heads_dtensor(pad(t), tp, q.shape[0]) for t in (
        ql[:, heads.start:heads.stop], kl[:, idx], vl[:, idx]))


def _write_rows(cache, rows, start: int):
    """Write ``rows`` (B, S, Hkv, D) into ``cache`` (B, L, Hkv, D) at rows
    start..start+S-1, in place.  Sharded, into the rank's shard of the
    cache: the rows are laid out as the cache but not split over its rows,
    and each rank writes those that fall in its own rows (none, some or
    all)."""
    if sh.is_dtensor(cache):
        from torch.distributed.tensor import Replicate

        rows = sh.redistribute(rows, [
            Replicate() if p.is_shard() and p.dim % 4 == 1 else p
            for p in cache.placements])
    c, t = sh.local(cache), sh.local(rows)
    r0, S = sh.local_offset(cache, 1), t.shape[1]
    a, b = max(start, r0), min(start + S, r0 + c.shape[1])
    if a < b:
        c[:, a - r0:b - r0] = t[:, a - start:b - start].to(c.dtype)


def decode_attention(params: dict, x, cfg: ModelConfig, rope, cache: dict,
                     cache_len: int, kv_len, window=None, pos=None):
    """x: (B, 1, M); rope: (cos, sin) of (B, 1, D/2) or None; kv_len: (B,)
    int32 = cache_len + 1; pos: (B, 1) int32 positions of the mask, or None
    for the row index.  Writes the new k, v into ``cache`` at ``cache_len``
    and returns y (B, 1, M)."""
    if x.shape[1] != 1:
        raise NotImplementedError("decode takes one token a step (S = 1)")
    q, k, v = _qkv(params, x, cfg, rope)
    for name, t in (("k", k), ("v", v)):
        _write_rows(cache[name], t, cache_len)
    ck = cache["k"] = constrain(cache["k"], "batch", "kv_seq", "kv_heads",
                                None)
    cv = cache["v"] = constrain(cache["v"], "batch", "kv_seq", "kv_heads",
                                None)
    if sh.is_dtensor(ck):
        if sh.shard_axes(ck, 1):
            return _decode_split_rows(params, x, q, ck, cv, cache_len, cfg,
                                      window, pos)
        q = q.permute(0, 2, 1, 3)
        k, v = _paired(q, ck.permute(0, 2, 1, 3), cv.permute(0, 2, 1, 3), cfg)
        ql = sh.local(q)
        start, end = _decode_rows(_full_len(ql, cache_len), cache_len, cfg,
                                  window, pos)
        kv_len, kv_start = (None if t is None else sh.from_local(
            t, (q.shape[0],), "batch") for t in (end, start))
        out = ops.decode_attention(q[:, :, 0], k.to(x.dtype), v.to(x.dtype),
                                   kv_len, kv_start=kv_start)  # (B, H, D)
        return _out(params, out[:, None], x)
    kv_start, kv_len = _decode_rows(kv_len, cache_len, cfg, window, pos)
    if window and pos is None:  # every row's window starts at r0: a view
        r0 = max(0, cache_len + 1 - window)
        ck, cv, kv_start, kv_len = ck[:, r0:], cv[:, r0:], None, kv_len - r0
    out = ops.decode_attention(
        q[:, 0], ck.to(x.dtype).permute(0, 2, 1, 3),
        cv.to(x.dtype).permute(0, 2, 1, 3), kv_len,
        kv_start=kv_start)  # (B, H, D)
    return _out(params, out[:, None], x)


def _full_len(q, cache_len: int):
    """(B,) int32 = cache_len + 1 for the local (B, ...) ``q``'s rows."""
    return torch.full((q.shape[0],), cache_len + 1, dtype=torch.int32,
                      device=q.device)


def _decode_rows(end, cache_len: int, cfg: ModelConfig, window, pos):
    """(first row or None, end row), (B,) each: the cache rows [start, end)
    the new token attends to, from ``end`` = cache_len + 1 (B,) int32: cut
    at pos + 1 under given positions (causal), and from cache_len + 1 -
    window, or pos + 1 - window under given positions, in a windowed layer;
    ``pos`` is the (B, 1) stream 0 of the rows (a rank's), or None."""
    start = None
    if pos is not None:
        qp = sh.local(pos)[:, 0].to(end.dtype)
        if cfg.causal:
            end = torch.minimum(end, qp + 1)
        if window:
            start = (qp - window + 1).clamp_min(0)
    elif window:
        start = torch.full_like(end, max(0, cache_len + 1 - window))
    return start, end


def _decode_split_rows(params: dict, x, q, ck, cv, cache_len: int,
                       cfg: ModelConfig, window=None, pos=None):
    """Decode against a cache whose rows are split over the mesh axes
    ``shard_axes(ck, 1)``: q gathered over them, ``decode_attention`` over
    the part of each rank's rows that the token attends to (kv_start and
    kv_len shifted by the rank's first row and clamped to its rows: a rank
    that holds none of them gives log-sum-exp -inf), the outputs merged
    exactly."""
    axes = sh.shard_axes(ck, 1)
    q = constrain(q, "batch", None, None, None)  # every head on every rank
    ql, kl, vl = (sh.local(t) for t in (q, ck, cv))
    r0, n = sh.local_offset(ck, 1), kl.shape[1]
    start, end = _decode_rows(_full_len(ql, cache_len), cache_len, cfg,
                              window, pos)
    kv_len = (end - r0).clamp(0, n)
    kv_start = None if start is None else (start - r0).clamp(0, n)
    out, lse = ops.decode_attention(
        ql[:, 0], kl.to(ql.dtype).permute(0, 2, 1, 3),
        vl.to(ql.dtype).permute(0, 2, 1, 3), kv_len, kv_start=kv_start,
        with_lse=True)
    out = merge_partials([out], [lse], axes).to(ql.dtype)  # (B, H, D)
    out = sh.from_local(out[:, None], q.shape, "batch", None, None, None)
    # each rank's heads of wo's split (a chunk, no collective)
    return _out(params, constrain(out, "batch", None, "heads", None), x)


def merge_partials(outs, lses, axes=()):
    """The attention over the union of disjoint row ranges from each
    range's output (B, H, D) and log-sum-exp (B, H) (``decode_attention``'s
    ``with_lse``), the ranges in the lists and, with ``axes``, on the ranks
    of those mesh axes: with m the largest log-sum-exp, w = exp(lse - m),
    out = sum w out / sum w, in f32, by all-reduces over ``axes``.  A range
    with no valid row has lse -inf and weight 0; a row with none anywhere
    gives 0."""
    lse = torch.stack([x.float() for x in lses])
    m = sh.pmax(lse.amax(dim=0), axes).clamp_min(NEG_INF)
    w = torch.exp(lse - m)[..., None]
    out = torch.stack([o.float() for o in outs])
    acc = sh.psum(torch.cat([w * out, w], dim=-1).sum(dim=0), axes)
    return acc[..., :-1] / acc[..., -1:].clamp_min(1e-30)
