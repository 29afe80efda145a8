"""Decode attention: one query row per (b, h) against a length-masked cache.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel).  The CUDA
kernel is ``csrc/decode_attention.cu``; ``decode_attention_plain`` beside it
is its plain PyTorch version.  ``decode_attention`` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a card; there
is no fallback from one to the other.

The signature keeps the TPU kernel's, q (B, H, D), k/v (B, Hkv, L, D),
kv_len (B,), and adds grouped-query attention: query head h reads KV head
h // G with G = H // Hkv up to 16 (G = 1 is the TPU kernel's function; the
kernel is built for groups of up to 8 and of up to 16).  k and v may be
strided views, so the model hands in its (B, L, Hkv, D) cache permuted, or
a window's view of it that starts at a later row, and copies nothing.  Scores, softmax and the P.V sum are f32; the output is
cast to q's dtype.  The TPU kernel's 8-row query padding is TPU layout and is
not carried over.

On a card the kernel reads K and V 16 bytes a load: k and v need 16-byte
aligned data, strides in multiples of 16 bytes, and a head dim in
``HEAD_DIMS`` (powers of two up to 256), as the model's cache has.  The
cache rows are split across blocks by ``split_plan``; each split writes f32
partials and the last block of each (b, KV head) merges them, counting on a
per-device buffer of counters that the kernel leaves zero.  Calls on one
device run on one stream at a time, as the model issues them.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
#: the head dims the CUDA kernel is built for (the switch of its launch)
HEAD_DIMS = {torch.float32: (8, 16, 32, 64, 128, 256),
             torch.bfloat16: (16, 32, 64, 128, 256)}

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


def decode_attention_plain(q, k, v, kv_len, *, scale=None):
    """Plain PyTorch version, in the kernel's numerics: f32 scores masked at
    kv_len with -1e30, f32 softmax, f32 P.V, output in q's dtype."""
    B, Hkv, L, D = k.shape
    H = q.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, D)
    s = torch.einsum("bhgd,bhld->bhgl", qf, k.float()) * _scale(D, scale)
    valid = torch.arange(L, device=q.device)[None, :] < kv_len.reshape(B, 1)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgl,bhld->bhgd", p, v.float())
    return o.reshape(B, H, D).to(q.dtype)


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "decode_attention_launch": (
        [_I] + [_P] * 9 + [_I] * 7 + [_L] * 8 + [_F, _P], _I),
    "decode_attention_max_group": ([], _I),
}


def decode_attention(q, k, v, kv_len, *, scale=None):
    """q: (B, H, D); k, v: (B, Hkv, L, D), any strides with the last one 1;
    kv_len: (B,) valid prefix length.  Returns (B, H, D) in q's dtype."""
    global launches
    dev = _build.device_of(q, k, v, kv_len)
    if dev.type == "cpu":
        return decode_attention_plain(q, k, v, kv_len, scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {dev}")
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
    if kv_len.shape != (B,):
        raise ValueError(f"kv_len must be ({B},), got {tuple(kv_len.shape)}")
    if D not in HEAD_DIMS[q.dtype]:
        raise ValueError(f"head_dim {D} is not built into the kernel "
                         f"({HEAD_DIMS[q.dtype]} for {q.dtype})")
    esize = q.element_size()
    if not (all(t.stride(i) * esize % 16 == 0 for t in (k, v) for i in range(3)
                if t.shape[i] > 1)
            and all(t.data_ptr() % 16 == 0 for t in (k, v))):
        raise ValueError("k and v need strides that are multiples of 16 bytes "
                         "and 16-byte aligned data")
    lib = _build.library("decode_attention", _SIGNATURES)
    G = H // Hkv
    if G > lib.decode_attention_max_group():
        raise ValueError(f"G={G} exceeds the kernel's "
                         f"{lib.decode_attention_max_group()}")
    kv_len = kv_len.to(torch.int32).contiguous()
    chunk, n_split = split_plan(B, Hkv, L, D, esize)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
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
        kv_len.data_ptr(), out.data_ptr(), m_part, l_part, acc_part,
        counters, B, H, G, L, D, chunk, n_split,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), _scale(D, scale),
        _build.stream_ptr(dev))
    _build.check_status("decode_attention", status)
    launches += 1
    return out
