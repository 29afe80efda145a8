"""Decode attention: one query row per (b, h) against a length-masked cache.

Port of ``repro.kernels.decode_attention`` (the Pallas TPU kernel).  The CUDA
kernel is ``csrc/decode_attention.cu``; ``decode_attention_plain`` beside it
is its plain PyTorch version.  ``decode_attention`` runs the plain version
for tensors on the CPU and launches the kernel for tensors on a card; there
is no fallback from one to the other.

The signature keeps the TPU kernel's, q (B, H, D), k/v (B, Hkv, L, D),
kv_len (B,), and adds grouped-query attention: query head h reads KV head
h // G with G = H // Hkv (G = 1 is the TPU kernel's function).  k and v may
be strided views, so the model hands in its (B, L, Hkv, D) cache permuted
and copies nothing.  Scores, softmax and the P.V sum are f32; the output is
cast to q's dtype.  The TPU kernel's 8-row query padding is TPU layout and is
not carried over.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30

#: kernel launches so far (plain-version calls are not counted)
launches = 0

SMS = 132  # streaming multiprocessors of an H100 SXM
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(D: int, scale):
    # the reference's 1/sqrt(D), computed in f32
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)) \
        if scale is None else float(scale)


def chunk_rows(B: int, Hkv: int, L: int) -> int:
    """Cache rows per block: the smallest power of two from 32 to 256 whose
    split of L gives at most about 16 blocks per SM.  With one query row a
    block has little work, so a small grid (B * Hkv blocks) leaves SMs idle;
    on an H100 at B=16, Hkv=8, L=512, 32 rows a block beat 128 and 256."""
    want_splits = -(-16 * SMS // (B * Hkv))
    chunk = 32
    while chunk < 256 and -(-L // chunk) > want_splits:
        chunk *= 2
    return chunk


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
        [_I, _P, _P, _P, _P, _P, _P, _P, _P] + [_I] * 7 + [_L] * 8 + [_F, _P],
        _I),
    "decode_attention_max_group": ([], _I),
    "decode_attention_max_dim": ([], _I),
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
    lib = _build.library("decode_attention", _SIGNATURES)
    G = H // Hkv
    if G > lib.decode_attention_max_group() or D > lib.decode_attention_max_dim():
        raise ValueError(f"G={G}, D={D} exceed the kernel's "
                         f"{lib.decode_attention_max_group()}, "
                         f"{lib.decode_attention_max_dim()}")
    kv_len = kv_len.to(torch.int32).contiguous()
    chunk = chunk_rows(B, Hkv, L)
    n_split = -(-L // chunk)
    out = torch.empty((B, H, D), dtype=q.dtype, device=dev)
    m_part = torch.empty((B, H, n_split), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    acc_part = torch.empty((B, H, n_split, D), dtype=torch.float32, device=dev)
    status = lib.decode_attention_launch(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), m_part.data_ptr(),
        l_part.data_ptr(), acc_part.data_ptr(), B, H, G, L, D, chunk, n_split,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), _scale(D, scale),
        _build.stream_ptr(dev))
    _build.check_status("decode_attention", status)
    launches += 1
    return out
