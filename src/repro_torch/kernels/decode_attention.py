"""Decode attention: one query row per (b, h) against a length-masked cache.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel).  The CUDA
kernel is ``csrc/decode_attention.cu``; ``decode_attention_plain`` beside it
is its plain PyTorch version.  ``decode_attention`` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a card; there
is no fallback from one to the other.

The signature keeps the TPU kernel's, q (B, H, D), k/v (B, Hkv, L, D),
kv_len (B,), and adds grouped-query attention and an optional kv_start
(B,), the first row a query attends to (the reference's decode mask under
given positions): query head h reads KV head
h // G with G = H // Hkv up to 16 (G = 1 is the TPU kernel's function; the
kernel is built for groups of up to 8 and of up to 16).  k and v may be
strided views, so the model hands in its (B, L, Hkv, D) cache permuted, or
a window's view of it that starts at a later row, and copies nothing.  Scores, softmax and the P.V sum are f32; the output is
cast to q's dtype.  The TPU kernel's 8-row query padding is TPU layout and is
not carried over.

``with_lse=True`` also returns the log-sum-exp, f32 (B, H): ln of the sum of
exp(scale * q.k) over the attended rows, -inf where a row attends to none.
Calls that attend over disjoint row ranges of one cache (the ranks of a
sequence-sharded cache) merge to the call over their union with it
(``models/attention.py::merge_partials``).  Without it, the default, the
kernel writes nothing more.

DTensor arguments (the model under a mesh of several devices) may be
sharded over batch and heads only: the kernel runs on each rank's local
shard and its output is that rank's shard of the result
(``kernels/_dtensor.py``).

On a card the kernel reads K and V 16 bytes a load: k and v need 16-byte
aligned data, strides in multiples of 16 bytes, and a head dim in
``HEAD_DIMS`` (powers of two up to 256), as the model's cache has.  The
cache rows are split across blocks by ``split_plan``; each split writes f32
partials and the last block of each (b, KV head) merges them, counting on a
per-device buffer of counters that the kernel leaves zero.  Calls on one
device run on one stream at a time, as the model issues them.

For tensors on the meta device (the dry run) ``decode_attention`` takes
the shape-only route of ``kernels/_meta.py``: the card route's checks and
outputs, no kernel, the call's ``cost`` recorded.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build, _dtensor, _meta

NEG_INF = -1e30

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the CUDA kernel is built for (the switch of its launch)
HEAD_DIMS = {torch.float32: (8, 16, 32, 64, 128, 256),
             torch.bfloat16: (16, 32, 64, 128, 256)}

#: query heads a KV head, at most: the kernel's larger group bound
MAX_GROUP = 16
SMS = 132  # streaming multiprocessors of an H100 SXM
MIN_BLOCK_BYTES = 256 << 10  # K and V bytes a block moves, at least
ROW_GRAIN = 64  # a split's rows are a multiple of this


def _scale(D: int, scale):
    # the reference's 1/sqrt(D), computed in f32
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)) \
        if scale is None else float(scale)


def route(dtype: torch.dtype) -> str:
    """The kernel that runs a call on the card: bf16 on the tensor cores,
    f32 on the CUDA cores."""
    if dtype == torch.bfloat16:
        return "dec_mma"
    if dtype == torch.float32:
        return "dec_split"
    raise ValueError(f"decode_attention takes float32 or bfloat16, not {dtype}")


def cost(B: int, H: int, Hkv: int, L: int, D: int, esize: int,
         rows: int | None = None, lse: bool = False,
         starts: bool = False) -> tuple:
    """(FLOPs, HBM bytes) of one call over a cache of L rows: q.k and p.v,
    2 flops a multiply-add, over ``rows`` attended cache rows summed over
    the batch (default B * L: every row of the cache, as the dry run
    counts it, where ``kv_len`` lies on the meta device and no data says
    how many are valid); bytes: q in and out (H heads), the attended K and
    V rows once (Hkv heads), ``kv_len`` (with ``starts``, ``kv_start``)
    read, and with ``lse`` the f32 (B, H) log-sum-exp written."""
    n_rows = B * L if rows is None else rows
    n_bytes = (2 * B * H * D * esize + 2 * n_rows * Hkv * D * esize
               + B * 4 * (1 + bool(starts)) + B * H * 4 * bool(lse))
    return 4 * n_rows * H * D, n_bytes


def split_plan(B: int, Hkv: int, L: int, D: int, esize: int):
    """(rows a split, splits) for a cache of L rows: as many splits as give
    each SM one block of the B * Hkv heads, but no full split that moves
    less than 256 KB of K and V, in multiples of 64 rows.  One block an SM
    keeps two tiles a warp in flight, enough to stream from HBM; more
    blocks only add partials to merge and blocks that wait for a second
    wave.  The splits cover [0, L); with one split the kernel writes the
    output and no partials."""
    row = 2 * D * esize  # K and V bytes a cache row
    n_split = max(1, min(SMS // (B * Hkv), L * row // MIN_BLOCK_BYTES))
    chunk = -(-L // n_split)
    chunk = -(-chunk // ROW_GRAIN) * ROW_GRAIN
    n_split = -(-L // chunk)
    return (L, 1) if n_split == 1 else (chunk, n_split)


_COUNTERS: dict = {}


def _counters(dev: torch.device, n: int) -> torch.Tensor:
    """At least n zeroed int32 counters on dev, kept across calls."""
    buf = _COUNTERS.get(dev)
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _COUNTERS[dev] = buf
    return buf


def decode_attention_plain(q, k, v, kv_len, *, scale=None, kv_start=None,
                           with_lse=False):
    """Plain PyTorch version, in the kernel's numerics: f32 scores masked
    outside rows [kv_start, kv_len) with -1e30, f32 softmax (an empty range
    gives 0, as the reference's clamped softmax does), f32 P.V, output in
    q's dtype; with ``with_lse`` also the f32 (B, H) log-sum-exp of the
    attended scores (-inf for an empty range)."""
    B, Hkv, L, D = k.shape
    H = q.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhld->bhgl", qf, k.float()) * _scale(D, scale)
    rows = torch.arange(L, device=q.device)[None, :]
    valid = rows < kv_len.reshape(B, 1)
    if kv_start is not None:
        valid &= rows >= kv_start.reshape(B, 1)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2)
    p = torch.exp(s - m)
    den = p.sum(dim=-1, keepdim=True)
    p = p / den.clamp_min(1e-30)
    o = torch.einsum("bhgl,bhld->bhgd", p, v.float())
    o = o.reshape(B, H, D).to(q.dtype)
    if not with_lse:
        return o
    lse = torch.where(den > 0, m + torch.log(den),
                      torch.full_like(den, -math.inf))
    return o, lse.reshape(B, H)



_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "decode_attention_launch": (
        [_I] + [_P] * 11 + [_I] * 7 + [_L] * 8 + [_F, _P], _I),
    "decode_attention_max_group": ([], _I),
}


#: the dims each argument may be sharded over, by role; the outputs' roles
_SHARDS = ({0: "batch", 1: "heads"}, {0: "batch", 1: "heads"},
           {0: "batch", 1: "heads"}, {0: "batch"}, {0: "batch"})
_OUT_SHARDS = ({0: "batch", 1: "heads"}, {0: "batch", 1: "heads"})


def _check(q, k, v, kv_len, kv_start):
    """The shared checks of a call on the card (or the meta device);
    returns (B, H, Hkv, L, D)."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,D) and k, v (B,Hkv,L,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hkv, L, D = k.shape
    H = q.shape[1]
    if q.shape != (B, H, D) or H % Hkv or L < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(2) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if kv_len.shape != (B,) or (kv_start is not None
                                and kv_start.shape != (B,)):
        raise ValueError(f"kv_len and kv_start must be ({B},), got "
                         f"{tuple(kv_len.shape)}")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {D} is not built into the kernel "
                         f"({HEAD_DIMS[q.dtype]} for {q.dtype})")
    if H // Hkv > MAX_GROUP:
        raise ValueError(f"G={H // Hkv} exceeds the kernel's {MAX_GROUP}")
    return B, H, Hkv, L, D


def decode_attention(q, k, v, kv_len, *, scale=None, kv_start=None,
                     with_lse=False):
    """q: (B, H, D); k, v: (B, Hkv, L, D), any strides with the last one 1;
    kv_len: (B,) valid prefix length; kv_start: optional (B,) first valid
    row.  Returns (B, H, D) in q's dtype, and with ``with_lse`` also the
    f32 (B, H) log-sum-exp."""
    global launches
    if _dtensor.any_dtensor(q, k, v, kv_len, kv_start):
        return _dtensor.on_shards(
            "decode_attention",
            lambda *a: decode_attention(*a[:4], scale=scale, kv_start=a[4],
                                        with_lse=with_lse),
            (q, k, v, kv_len, kv_start), _SHARDS,
            _OUT_SHARDS if with_lse else _OUT_SHARDS[0])
    dev = _build.device_of(*(t for t in (q, k, v, kv_len, kv_start)
                             if t is not None))
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, scale=scale,
                                      kv_start=kv_start, with_lse=with_lse)
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"decode_attention runs on cuda or cpu, not {dev}")
    B, H, Hkv, L, D = _check(q, k, v, kv_len, kv_start)
    esize = q.element_size()
    if not (all(t.stride(i) * esize % 16 == 0 for t in (k, v) for i in range(3)
                if t.shape[i] > 1)
            and (dev.type == "meta"
                 or all(t.data_ptr() % 16 == 0 for t in (k, v)))):
        raise ValueError("k and v need strides that are multiples of 16 bytes "
                         "and 16-byte aligned data")
    if dev.type == "meta":
        _meta.record("decode_attention", route(q.dtype), cost(
            B, H, Hkv, L, D, esize, lse=with_lse,
            starts=kv_start is not None), q, k)
        out = _meta.empty((B, H, D), q.dtype)
        return (out, _meta.empty((B, H), torch.float32)) if with_lse else out
    lib = _build.library("decode_attention", _SIGNATURES)
    G = H // Hkv
    if G > lib.decode_attention_max_group():
        raise ValueError(f"G={G} exceeds the kernel's "
                         f"{lib.decode_attention_max_group()}")
    kv_len = kv_len.to(torch.int32).contiguous()
    if kv_start is not None:
        kv_start = kv_start.to(torch.int32).contiguous()
    chunk, n_split = split_plan(B, Hkv, L, D, esize)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if with_lse else None)
    m_part = l_part = acc_part = counters = None
    if n_split > 1:
        # one f32 scratch: m and l (B, H, n_split) each, acc (B, H, n_split, D)
        part = B * H * n_split
        scratch = torch.empty(part * (D + 2), dtype=torch.float32, device=dev)
        m_part = scratch.data_ptr()
        l_part = m_part + 4 * part
        acc_part = l_part + 4 * part
        counters = _counters(dev, B * Hkv).data_ptr()
    status = lib.decode_attention_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr(), 0 if kv_start is None else kv_start.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), m_part,
        l_part, acc_part,
        counters, B, H, G, L, D, chunk, n_split,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), _scale(D, scale),
        _build.stream_ptr(dev))
    _build.check_status("decode_attention", status)
    launches += 1
    return out if lse is None else (out, lse)
