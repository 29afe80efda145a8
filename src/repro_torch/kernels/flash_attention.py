"""Flash attention, forward and backward: causal, windowed or full, by index
or by given positions, with GQA.

Port of ``repro.kernels.flash_attention`` (the Pallas TPU kernel).  The CUDA
kernels are ``csrc/flash_attention*.cu``; ``flash_attention_plain`` beside
them is the forward's plain PyTorch version, ``flash_attention_lse_plain``
that of the log-sum-exp L the training forward also writes, and
``flash_attention_bwd_plain`` the backward's.  ``flash_attention`` runs the
plain version for tensors on the CPU (autograd differentiates it there) and
launches a kernel for tensors on a card; there is no fallback from one to
the other.  Where a gradient is wanted on a card it goes through
``FlashAttentionFn``, whose backward pass is a backward kernel: the TPU
kernel has no backward, and the reference trains through plain ``jnp``
(``repro.models.attention._attend_chunk``) differentiated by XLA, whose
gradient the kernels compute.

Positions (``q_pos``, ``k_pos``: (B, S) integers, either may be None for the
row index) replace the indices in the masks: key j is kept for query i when
k_pos[b, j] <= q_pos[b, i] (causal) and k_pos[b, j] > q_pos[b, i] - window,
the reference's ``_attend_chunk`` mask; a query row with no kept key gives
0 and has zero gradient, as the reference's clamped softmax gives them.

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

On a card the forward kernel is a pure function of (dtype, D, whether
positions are given), ``route``:

* ``fa_wgmma`` (``csrc/flash_attention_wgmma.cu``) for bf16 at D in
  ``WGMMA_DIMS`` (64 and 128, every attention config of the port):
  warp-specialised, TMA loads and ``wgmma`` products;
* ``fa_mma`` (``csrc/flash_attention.cu``) for bf16 at the other head dims
  of ``HEAD_DIMS``, and for bf16 with positions: ``mma.sync`` with 16-byte
  loads;
* ``fa_fwd`` (``csrc/flash_attention.cu``) for f32, on the CUDA cores, at any
  strides.

The backward kernels are a pure function of the same three, ``bwd_route``:

* ``fa_bwd_wgmma`` (``csrc/flash_attention_bwd_wgmma.cu``) where the
  forward is ``fa_wgmma``: a dQ kernel, then a dK/dV kernel, warp-
  specialised on TMA and ``wgmma``, reading the L that ``fa_wgmma``'s
  L-writing build saved in ``FlashAttentionFn.forward``;
* ``fa_bwd_mma`` (``csrc/flash_attention_bwd.cu``) for the other bf16
  calls (positions, other head dims): ``mma.sync``, L recomputed;
* ``fa_bwd_f32`` (``csrc/flash_attention_bwd.cu``) for f32, on the CUDA
  cores, L recomputed.

L is each (b, head, row)'s log-sum-exp of its kept scaled scores in log2
units (the scale times log2 e, as the bf16 kernels compute exp2), 0 for a
row with no kept key.

The bf16 kernels read 16 bytes at a time (TMA needs 16-byte aligned data and
strides): their inputs' strides must be multiples of 8 elements, as the
model's projections are, and anything else is refused.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

NEG_INF = -1e30
LOG2E = 1.4426950408889634
#: the head dims the CUDA libraries are built for (the switches of their
#: launch functions)
HEAD_DIMS = (16, 32, 64, 80, 96, 128)
#: the bf16 head dims ``fa_wgmma`` takes
WGMMA_DIMS = (64, 128)

#: the backward kernels' routes (``bwd_route``)
BWD_ROUTES = ("fa_bwd_wgmma", "fa_bwd_mma", "fa_bwd_f32")

#: kernel launches so far (plain-version calls are not counted): the
#: forward, the backward (one per call of its two kernels), and the
#: backward by route
launches = 0
bwd_launches = 0
bwd_wgmma_launches = 0
bwd_mma_launches = 0
bwd_f32_launches = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def _scale(D: int, scale):
    # the reference's 1/sqrt(D), computed in f32
    return float(torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)) \
        if scale is None else float(scale)


def _positions(pos, B, S, device):
    """(B, S) int64 positions, or the row index where ``pos`` is None."""
    if pos is None:
        return torch.arange(S, device=device).expand(B, S)
    return torch.as_tensor(pos, device=device).long().expand(B, S)


def _keep(q_pos, k_pos, B, S, causal, window, device):
    """(B, 1, 1, S, S) bool: key j is kept for query i, the reference's
    ``_attend_chunk`` mask over positions (the row index where none are
    given)."""
    qp = _positions(q_pos, B, S, device)[:, :, None]
    kp = _positions(k_pos, B, S, device)[:, None, :]
    keep = torch.ones((B, S, S), dtype=torch.bool, device=device)
    if causal:
        keep &= kp <= qp
    if window:
        keep &= kp > qp - window
    return keep[:, None, None]


def flash_attention_plain(q, k, v, *, causal=True, window=0, scale=None,
                          q_pos=None, k_pos=None):
    """Plain PyTorch version, in the kernel's numerics: f32 scores masked
    with -1e30, the softmax of the reference (max clamped at -1e30 / 2, sum
    at 1e-30, so a row with no kept key gives 0), p rounded to v's dtype,
    f32 P.V sums, output in q's dtype.  Differentiable: autograd through it
    is the reference's gradient."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    qf = q.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * _scale(D, scale)
    keep = _keep(q_pos, k_pos, B, S, causal, window, q.device)
    s = torch.where(keep, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2).detach()
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bhgqk,bhkd->bhgqd", p.to(v.dtype).float(), v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def _masked_scores(q, k, causal, window, scale, q_pos, k_pos):
    """(B, Hkv, G, S, S) f32 scaled scores, -inf where the mask drops a
    key."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    qf = q.float().reshape(B, Hkv, H // Hkv, S, D)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * _scale(D, scale)
    keep = _keep(q_pos, k_pos, B, S, causal, window, q.device)
    return torch.where(keep, s, torch.full_like(s, -math.inf))


def _lse(s):
    """The log-sum-exp over the last axis of masked scores, 0 for a row
    with no kept key (the reference's clamped softmax gives it 0)."""
    lse = torch.logsumexp(s, dim=-1, keepdim=True)
    return torch.where(torch.isfinite(lse), lse, torch.zeros_like(lse))


def flash_attention_lse_plain(q, k, *, causal=True, window=0, scale=None,
                              q_pos=None, k_pos=None):
    """Plain PyTorch version of the L that ``fa_wgmma``'s L-writing build
    saves for the backward: f32 (B, H, S), each row's log-sum-exp of its
    kept scaled scores in log2 units, 0 for a row with no kept key."""
    B, H, S, _ = q.shape
    s = _masked_scores(q, k, causal, window, scale, q_pos, k_pos)
    return (_lse(s) * LOG2E).reshape(B, H, S)


def flash_attention_bwd_plain(q, k, v, o, do, *, causal=True, window=0,
                              scale=None, q_pos=None, k_pos=None, lse=None):
    """Plain PyTorch version of the backward kernels, in their numerics: P =
    exp(S * scale - L) from the row's log-sum-exp L over kept keys (0 where
    masked), dV = P^T dO with P rounded to v's dtype, dP = dO V^T, dS = P *
    (dP - Delta) with Delta = rowsum(dO * O) from the forward's output O,
    dS rounded to q's dtype before dQ = dS K * scale and dK = dS^T Q *
    scale; dK and dV summed over each KV group in f32.  ``lse``: L as
    ``flash_attention_lse_plain`` gives it (log2 units), used as given, as
    the wgmma route uses the forward's (P = exp2(S * scale * log2 e - L));
    None recomputes it.  Returns (dq, dk, dv) in the inputs' dtypes and
    shapes."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    sc = _scale(D, scale)
    qf = q.float().reshape(B, Hkv, G, S, D)
    kf, vf = k.float(), v.float()
    dof = do.float().reshape(B, Hkv, G, S, D)
    s = _masked_scores(q, k, causal, window, scale, q_pos, k_pos)
    if lse is None:
        p = torch.exp(s - _lse(s))  # exp(-inf) = 0 where masked
    else:
        lse = lse.float().reshape(B, Hkv, G, S, 1)
        p = torch.exp2(s * LOG2E - lse)
    delta = (dof * o.float().reshape(B, Hkv, G, S, D)).sum(-1, keepdim=True)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(v.dtype).float(), dof)
    dp = torch.einsum("bhgqd,bhkd->bhgqk", dof, vf)
    ds = (p * (dp - delta)).to(q.dtype).float()
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds, kf) * sc
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds, qf) * sc
    return (dq.reshape(B, H, S, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def route(dtype: torch.dtype, D: int, positions: bool = False) -> str:
    """The forward kernel that runs a call on the card, from its dtype, head
    dim and whether it has positions (``fa_wgmma`` masks by index only)."""
    if dtype == torch.float32:
        return "fa_fwd"
    if dtype == torch.bfloat16:
        return "fa_wgmma" if D in WGMMA_DIMS and not positions else "fa_mma"
    raise ValueError(f"flash_attention takes float32 or bfloat16, not {dtype}")


def bwd_route(dtype: torch.dtype, D: int, positions: bool = False) -> str:
    """The backward kernels that run a call on the card: ``fa_bwd_wgmma``
    wherever the forward is ``fa_wgmma``, else ``fa_bwd_mma`` (bf16) or
    ``fa_bwd_f32``."""
    return {"fa_wgmma": "fa_bwd_wgmma", "fa_mma": "fa_bwd_mma",
            "fa_fwd": "fa_bwd_f32"}[route(dtype, D, positions)]


def _lse_rows(S: int) -> int:
    """Rows of a (b, head) in the L and Delta buffers of the wgmma route: S
    rounded up to 128, so each tile's slice is an aligned bulk copy."""
    return -(-S // 128) * 128


def _strides(t):
    """t's strides of (B, heads, S); a dimension of length 1 has no stride
    of its own, so it gets the tensor's span, which the kernels never use."""
    span = max([t.stride(i) * t.shape[i] for i in range(3) if t.shape[i] > 1],
               default=8)
    return [t.stride(i) if t.shape[i] > 1 else span for i in range(3)]


_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "flash_attention": {"flash_attention_launch": (
        [_I, _P, _P, _P, _P] + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P, _P, _P],
        _I)},
    "flash_attention_wgmma": {"flash_attention_wgmma_launch": (
        [_P] * 5 + [_I] * 5 + [_L] * 12 + [_F, _I, _I, _P], _I)},
    "flash_attention_bwd": {"flash_attention_bwd_launch": (
        [_I] + [_P] * 12 + [_I] * 5 + [_P, _F, _I, _I, _P], _I)},
    "flash_attention_bwd_wgmma": {"flash_attention_bwd_wgmma_launch": (
        [_P] * 10 + [_I] * 6 + [_P, _F, _I, _I, _P], _I)},
}


def _check(q, k, v, window):
    """The shared checks of a call on the card; returns (B, H, Hkv, S, D)."""
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
    return B, H, Hkv, S, D


def _aligned(tensors):
    """bf16 kernels read 16 bytes at a time: strides in multiples of 8
    elements and 16-byte aligned data."""
    return all(st % 8 == 0 for t in tensors for st in _strides(t)) and all(
        t.data_ptr() % 16 == 0 for t in tensors)


def _pos_arg(pos, B, S, dev):
    """(tensor kept alive, pointer) of (B, S) int32 positions, or None, 0."""
    if pos is None:
        return None, 0
    pos = torch.as_tensor(pos, device=dev).to(torch.int32).expand(B, S)
    pos = pos.contiguous()
    return pos, pos.data_ptr()


def _forward_kernel(q, k, v, causal, window, scale, q_pos, k_pos,
                    with_lse=False):
    """One launch of the forward kernel that ``route`` names; with
    ``with_lse`` (the ``fa_wgmma`` route only), of its L-writing build, and
    then (out, L), L a (B, H, S) view of f32 (B, H, ``_lse_rows(S)``)."""
    global launches
    dev = q.device
    B, H, Hkv, S, D = _check(q, k, v, window)
    if q.dtype == torch.bfloat16 and not _aligned((q, k, v)):
        raise ValueError("bf16 q, k, v need strides that are multiples of 8 "
                         "elements and 16-byte aligned data")
    qp, qp_ptr = _pos_arg(q_pos, B, S, dev)
    kp, kp_ptr = _pos_arg(k_pos, B, S, dev)
    fwd_route = route(q.dtype, D, qp is not None or kp is not None)
    if with_lse and fwd_route != "fa_wgmma":
        raise ValueError(f"only fa_wgmma writes L; this call runs {fwd_route}")
    (qsb, qsh, qss), (ksb, ksh, kss), (vsb, vsh, vss) = map(_strides,
                                                            (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, _lse_rows(S)), dtype=torch.float32, device=dev)
           if with_lse else None)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    args = (B, H, H // Hkv, S, D, qsb, qsh, qss, ksb, ksh, kss, vsb, vsh, vss,
            out.stride(0), out.stride(2), out.stride(1), _scale(D, scale),
            int(bool(causal)), int(window))
    if fwd_route == "fa_wgmma":
        lib = _build.library("flash_attention_wgmma",
                             _SIGNATURES["flash_attention_wgmma"])
        status = lib.flash_attention_wgmma_launch(
            *ptrs, None if lse is None else lse.data_ptr(), *args,
            _build.stream_ptr(dev))
    else:
        lib = _build.library("flash_attention", _SIGNATURES["flash_attention"])
        status = lib.flash_attention_launch(_DTYPE_CODE[q.dtype], *ptrs, *args,
                                            qp_ptr, kp_ptr,
                                            _build.stream_ptr(dev))
    _build.check_status("flash_attention", status)
    launches += 1
    out = out.permute(0, 2, 1, 3)
    return out if lse is None else (out, lse[..., :S])


def flash_attention_with_lse(q, k, v, *, causal=True, window=0, scale=None):
    """(out, L): the forward and its log-sum-exp L, f32 (B, H, S) in log2
    units (``flash_attention_lse_plain``), the L the ``fa_bwd_wgmma``
    backward reads.  On the CPU the plain versions; on a card one launch of
    ``fa_wgmma``'s L-writing build (bf16 at D in ``WGMMA_DIMS``; other
    calls raise), whose out equals the plain build's bit for bit."""
    dev = _build.device_of(q, k, v)
    if dev.type == "cpu":
        return (flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale),
                flash_attention_lse_plain(q, k, causal=causal, window=window,
                                          scale=scale))
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    return _forward_kernel(q, k, v, causal, window, scale, None, None,
                           with_lse=True)


def _lse_arg(lse, B, H, S):
    """The forward's L as the wgmma route reads it: f32 with ``_lse_rows(S)``
    rows a (b, head), 16-byte aligned.  L as ``_forward_kernel`` returns it
    is used in place; any other (B, H, S) tensor is copied into that
    layout."""
    if lse.shape != (B, H, S):
        raise ValueError(f"lse {tuple(lse.shape)} must be (B, H, S) = "
                         f"{(B, H, S)}")
    rows = _lse_rows(S)
    if (lse.dtype == torch.float32 and lse.stride() == (H * rows, rows, 1)
            and lse.data_ptr() % 16 == 0
            and lse.untyped_storage().nbytes()
            >= 4 * (lse.storage_offset() + B * H * rows)):
        return lse
    buf = torch.empty((B, H, rows), dtype=torch.float32, device=lse.device)
    buf[..., :S] = lse
    return buf


def flash_attention_bwd(q, k, v, o, do, *, causal=True, window=0, scale=None,
                        q_pos=None, k_pos=None, lse=None, route=None):
    """The backward kernels that ``bwd_route`` names, for tensors on a card:
    (dq, dk, dv) of the forward's output o and its gradient do, in the
    shapes and dtypes of q, k and v (views of (B, S, heads, D) tensors).
    Two kernels, one launch counted, under ``bwd_launches`` and its
    route's counter.  ``lse``: the forward's L ((B, H, S), log2 units, as
    ``flash_attention_with_lse`` gives it), taken by the ``fa_bwd_wgmma``
    route only; where that route is given none (a direct call), it gets L
    from one more forward launch, the L-writing build of ``fa_wgmma``.  The
    other routes recompute L themselves and refuse one.  ``route``: None
    for ``bwd_route``'s, or a route named to compare kernels on one call
    (``fa_bwd_mma`` runs any bf16 call, the others only their own)."""
    global bwd_launches, bwd_wgmma_launches, bwd_mma_launches, bwd_f32_launches
    dev = _build.device_of(q, k, v, o, do)
    if dev.type != "cuda":
        raise ValueError(f"the backward kernel runs on cuda, not {dev}")
    B, H, Hkv, S, D = _check(q, k, v, window)
    if o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and do {tuple(do.shape)} must "
                         f"be q's {tuple(q.shape)}")
    r = bwd_route(q.dtype, D, q_pos is not None or k_pos is not None)
    if route is not None and route != r and not (
            route == "fa_bwd_mma" and q.dtype == torch.bfloat16):
        raise ValueError(f"route {route} cannot run this call ({r} does)")
    r = route or r
    if lse is not None and r != "fa_bwd_wgmma":
        raise ValueError(f"lse is taken by the fa_bwd_wgmma route only; this "
                         f"call runs {r}, which recomputes L")
    # the gradient arrives in any layout: the kernels read (B, S, H, D) rows
    o, do = (t.to(q.dtype).permute(0, 2, 1, 3).contiguous().permute(0, 2, 1, 3)
             if t.stride(3) != 1 or t.dtype != q.dtype or not _aligned((t,))
             else t for t in (o, do))
    if q.dtype == torch.bfloat16 and not _aligned((q, k, v, o, do)):
        raise ValueError("bf16 q, k, v need strides that are multiples of 8 "
                         "elements and 16-byte aligned data")
    dq = torch.empty((B, S, H, D), dtype=q.dtype, device=dev)
    dk = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=dev)
    dv = torch.empty((B, S, Hkv, D), dtype=q.dtype, device=dev)
    dq, dk, dv = (t.permute(0, 2, 1, 3) for t in (dq, dk, dv))
    strides = (ctypes.c_longlong * 24)(*(
        st for t in (q, k, v, o, do, dq, dk, dv) for st in _strides(t)))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    tail = (_scale(D, scale), int(bool(causal)), int(window),
            _build.stream_ptr(dev))
    if r == "fa_bwd_wgmma":
        if lse is None:
            lse = _forward_kernel(q, k, v, causal, window, scale, None, None,
                                  with_lse=True)[1]
        lse = _lse_arg(lse, B, H, S)
        # each (b, h, row)'s Delta, from the dq kernel to the dkdv kernel
        delta = torch.empty((B, H, _lse_rows(S)), dtype=torch.float32,
                            device=dev)
        lib = _build.library("flash_attention_bwd_wgmma",
                             _SIGNATURES["flash_attention_bwd_wgmma"])
        status = lib.flash_attention_bwd_wgmma_launch(
            *ptrs, lse.data_ptr(), delta.data_ptr(), B, H, H // Hkv, S,
            _lse_rows(S), D, strides, *tail)
        _build.check_status("flash_attention_bwd_wgmma", status)
        bwd_wgmma_launches += 1
    else:
        qp, qp_ptr = _pos_arg(q_pos, B, S, dev)
        kp, kp_ptr = _pos_arg(k_pos, B, S, dev)
        # each (b, h, row)'s log-sum-exp and Delta, from the first kernel to
        # the second
        stats = torch.empty((2, B, H, S), dtype=torch.float32, device=dev)
        lib = _build.library("flash_attention_bwd",
                             _SIGNATURES["flash_attention_bwd"])
        status = lib.flash_attention_bwd_launch(
            _DTYPE_CODE[q.dtype], *ptrs, stats[0].data_ptr(),
            stats[1].data_ptr(), qp_ptr, kp_ptr, B, H, H // Hkv, S, D,
            strides, *tail)
        _build.check_status("flash_attention_bwd", status)
        if r == "fa_bwd_mma":
            bwd_mma_launches += 1
        else:
            bwd_f32_launches += 1
    bwd_launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """The forward kernel, with the backward kernels as its gradient
    (tensors on a card only; on the CPU autograd runs through the plain
    version).  On the ``fa_bwd_wgmma`` route the forward is ``fa_wgmma``'s
    L-writing build and its L is saved for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, scale):
        lse = None
        if bwd_route(q.dtype, q.shape[-1],
                     q_pos is not None or k_pos is not None) == "fa_bwd_wgmma":
            out, lse = _forward_kernel(q, k, v, causal, window, scale, q_pos,
                                       k_pos, with_lse=True)
        else:
            out = _forward_kernel(q, k, v, causal, window, scale, q_pos, k_pos)
        ctx.save_for_backward(q, k, v, out, q_pos, k_pos, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, q_pos, k_pos, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, do, causal=causal, window=window, scale=scale,
            q_pos=q_pos, k_pos=k_pos, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, *, causal=True, window=0, scale=None,
                    q_pos=None, k_pos=None):
    """q: (B, H, S, D); k, v: (B, Hkv, S, D), any strides with the last one
    1; q_pos, k_pos: optional (B, S) integer positions that the masks
    compare in place of the row index.  Returns (B, H, S, D) in q's dtype
    (on a card, a view of a (B, S, H, D) tensor).  Where a gradient is
    wanted on a card, the call goes through ``FlashAttentionFn``."""
    dev = _build.device_of(q, k, v)
    if dev.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale, q_pos=q_pos, k_pos=k_pos)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttentionFn.apply(q, k, v, q_pos, k_pos, causal, window,
                                      scale)
    return _forward_kernel(q, k, v, causal, window, scale, q_pos, k_pos)
