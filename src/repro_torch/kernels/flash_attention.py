"""Flash attention (forward): causal, windowed or full, with GQA.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).  The CUDA
kernel is ``csrc/flash_attention.cu``; ``flash_attention_plain`` beside it is
its plain PyTorch version.  ``flash_attention`` runs the plain version for
tensors on the CPU and launches the kernel for tensors on a card; there is no
fallback from one to the other.

The signature keeps the TPU kernel's, q (B, H, S, D) -> (B, H, S, D), and
adds grouped-query attention: k and v are (B, Hkv, S, D) and query head h
reads KV head h // G with G = H // Hkv (G = 1 is the TPU kernel's function).
q, k and v may be strided views with a contiguous last dimension, so the
model hands in its (B, S, H, D) projections permuted and copies nothing; the
kernel's output is written in that (B, S, H, D) layout and returned as a
(B, H, S, D) view.  The causal mask keeps k <= q, a window > 0 keeps
k > q - window; scores, softmax and the P.V sums are f32, p is rounded to
v's dtype before P.V as the reference rounds it, and the output is cast to
q's dtype.  Any S is taken: the TPU kernel's S % block == 0 is a TPU tiling
rule.

On a card the kernel is a pure function of (dtype, D), ``route``:

* ``fa_wgmma`` (``csrc/flash_attention_wgmma.cu``) for bf16 at D in
  ``WGMMA_DIMS`` (64 and 128, every attention config of the port):
  warp-specialised, TMA loads and ``wgmma`` products;
* ``fa_mma`` (``csrc/flash_attention.cu``) for bf16 at the other head dims
  of ``HEAD_DIMS``: ``mma.sync`` with 16-byte loads;
* ``fa_fwd`` (``csrc/flash_attention.cu``) for f32, on the CUDA cores, at any
  strides.

Both bf16 kernels read 16 bytes at a time (TMA needs 16-byte aligned data and
strides): their inputs' strides must be multiples of 8 elements, as the
model's projections are, and anything else is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
#: the head dims the CUDA libraries are built for (the switches of their
#: launch functions)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
#: the bf16 head dims ``fa_wgmma`` takes
WGMMA_DIMS = (64, 128)

#: kernel launches so far (plain-version calls are not counted)
launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(D: int, scale):
    # the reference's 1/sqrt(D), computed in f32
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)) \
        if scale is None else float(scale)


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None):
    """Plain PyTorch version, in the kernel's numerics: f32 scores masked
    with -1e30, f32 softmax, p rounded to v's dtype, f32 P.V sums, output in
    q's dtype."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * _scale(D, scale)
    qi = torch.arange(S, device=q.device)[:, None]
    ki = torch.arange(S, device=q.device)[None, :]
    keep = torch.ones((S, S), dtype=torch.bool, device=q.device)
    if causal:
        keep &= ki <= qi
    if window:
        keep &= ki > qi - window
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def route(dtype: torch.dtype, D: int) -> str:
    """The kernel that runs a call on the card, from its dtype and head dim."""
    if dtype == torch.float32:
        return "fa_fwd"
    if dtype == torch.bfloat16:
        return "fa_wgmma" if D in WGMMA_DIMS else "fa_mma"
    raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}")


def _strides(t):
    """t's strides of (B, heads, S); a dimension of length 1 has no stride
    of its own, so it gets the tensor's span, which the kernels never use."""
    span = max([t.stride(i) * t.shape[i] for i in range(3) if t.shape[i] > 1],
               default=8)
    return [t.stride(i) if t.shape[i] > 1 else span for i in range(3)]


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attention": {"flash_attention_launch": (
        [_I, _P, _P, _P, _P] + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P], _I)},
    "flash_attention_wgmma": {"flash_attention_wgmma_launch": (
        [_P, _P, _P, _P] + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P], _I)},
}


def flash_attention(q, k, v, *, causal=True, window=0, scale=None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D), any strides with the last one
    1.  Returns (B, H, S, D) in q's dtype (on a card, a view of a
    (B, S, H, D) tensor)."""
    global launches
    dev = _build.device_of(q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B,H,S,D) and k, v (B,Hkv,S,D); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != (B, Hkv, S, D) or H % Hkv or S < 1:
        raise ValueError(f"q {tuple(q.shape)} does not fit k {tuple(k.shape)}")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share float32 or bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("the last dimension of q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} is not built into the kernel "
                         f"({HEAD_DIMS})")
    strides = [_strides(t) for t in (q, k, v)]
    if q.dtype == torch.bfloat16 and not (
            all(st % 8 == 0 for sts in strides for st in sts)
            and all(t.data_ptr() % 16 == 0 for t in (q, k, v))):
        raise ValueError("bf16 q, k, v need strides that are multiples of 8 "
                         "elements and 16-byte aligned data")
    (qsb, qsh, qss), (ksb, ksh, kss), (vsb, vsh, vss) = strides
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, H,
            H // Hkv, S, D, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
            out.stride(0), out.stride(2), out.stride(1), _scale(D, scale),
            int(bool(causal)), int(window), _build.stream_ptr(dev))
    if route(q.dtype, D) == "fa_wgmma":
        lib = _build.library("flash_attention_wgmma",
                             _SIGNATURES["flash_attention_wgmma"])
        status = lib.flash_attention_wgmma_launch(*args)
    else:
        lib = _build.library("flash_attention", _SIGNATURES["flash_attention"])
        status = lib.flash_attention_launch(_DTYPE_CODE[q.dtype], *args)
    _build.check_status("flash_attention", status)
    launches += 1
    return out.permute(0, 2, 1, 3)
