"""Mamba-1 selective scan: h_t = dA_t * h_{t-1} + dBx_t, y_t = h_t . C_t.

Port of ``repro.kernels.ssm_scan`` (the Pallas TPU kernel).  The CUDA kernel
is ``csrc/ssm_scan.cu``; ``ssm_scan_plain`` beside it is its plain PyTorch
version.  ``ssm_scan`` runs the plain version for tensors on the CPU
(autograd differentiates it there) and launches the kernel for tensors on a
card; there is no fallback from one to the other.  Where a gradient is
wanted on a card it goes through ``SSMScanFn``.  Its forward is the
kernel's checkpoint-writing build (``ssm_scan_with_ckpt``; plain version of
the checkpoints ``ssm_scan_ckpt_plain``), which also keeps the state at the
start of every segment of ``SEG`` steps.  Its backward is the kernel of
``csrc/ssm_scan_bwd.cu`` (plain version ``ssm_scan_bwd_plain``), which
recomputes each segment's states from those checkpoints.  The TPU kernel
has no backward: the reference trains through its ``jnp`` scan
(``repro.models.mamba._ssm_chunk``), differentiated by XLA.

The signature is the TPU kernel's: dA, dBx (B, S, I, N); C (B, S, N);
h0 (B, I, N) -> (y (B, S, I) in dA's dtype, h_last (B, I, N) f32).  The state
is carried in f32 across all of S; the TPU kernel's time chunks and channel
blocks are VMEM tiling and are not carried over.  On a card the kernel takes
f32 inputs only: the Mamba mixer builds dA and dBx in f32.

For tensors on the meta device (the dry run) ``ssm_scan`` and
``ssm_scan_with_ckpt`` take the shape-only route of ``kernels/_meta.py``:
the card route's checks and outputs, no kernel, the call's ``cost``
recorded; under autograd the forward is ``ssm_fwd<true>`` with its
checkpoints, and the backward records ``ssm_bwd_tma + ssm_bwd_dc``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, _dtensor, _meta

#: steps a checkpointed segment: the states at t = 0, SEG, 2 SEG, ... are kept
SEG = 16

#: kernel launches so far (plain-version calls are not counted): the
#: forward (either build), its checkpoint-writing build alone, and the
#: backward (one per call of its two kernels)
launches = 0
ckpt_launches = 0
bwd_launches = 0


#: the card's kernels: the forward's two builds and the backward's pair
FWD, FWD_CKPT, BWD = "ssm_fwd<false>", "ssm_fwd<true>", "ssm_bwd_tma + ssm_bwd_dc"


def cost(B: int, S: int, I: int, N: int, *, ckpt: bool = False,
         backward: bool = False) -> tuple:
    """(FLOPs, HBM bytes) of one call, all f32.  The forward: dA, dBx, C,
    h0 in, y, h_last out, 4 flops an element of (B, S, I, N) (h = a h + b,
    y += h c); with ``ckpt`` (``ssm_fwd<true>``) also the checkpoints
    written, (B, ceil(S / SEG), I, N).  The backward: dA, dBx, C, h0, dy,
    dh_last in, d(dA), d(dBx), dC, dh0 out, 6 flops an element (dh's
    multiply-add, d(dA), the carried dA dh, dC's multiply-add); with
    ``ckpt`` also the checkpoints read."""
    big, ck = B * S * I * N, B * -(-S // SEG) * I * N * bool(ckpt)
    if backward:
        return 6 * big, 4 * (4 * big + 2 * B * S * N + 3 * B * I * N
                             + B * S * I + ck)
    return 4 * big, 4 * (2 * big + B * S * N + 2 * B * I * N + B * S * I
                         + ck)


def ssm_scan_plain(dA, dBx, C, h0):
    """Plain PyTorch version: the recurrence step by step in f32."""
    S = dA.shape[1]
    h = h0.float()
    ys = []
    for t in range(S):
        h = dA[:, t].float() * h + dBx[:, t].float()
        ys.append(torch.einsum("bin,bn->bi", h, C[:, t].float()))
    y = torch.stack(ys, dim=1) if ys else dA.new_zeros(dA.shape[:3])
    return y.to(dA.dtype), h


def ssm_scan_ckpt_plain(dA, dBx, h0):
    """Plain PyTorch version of the checkpoints that the forward's training
    build writes: the state before steps 0, SEG, 2 SEG, ..., f32 (B,
    ceil(S / SEG), I, N), ``[:, 0]`` = h0."""
    h = h0.float()
    hck = []
    for t in range(dA.shape[1]):
        if t % SEG == 0:
            hck.append(h)
        h = dA[:, t].float() * h + dBx[:, t].float()
    return torch.stack(hck, dim=1)


def ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh_last, hck=None):
    """Plain PyTorch version of the backward kernel: the recurrence of dh
    run backward step by step in f32, dh_t = dA_{t+1} dh_{t+1} + dy_t C_t;
    d(dA)_t = dh_t h_{t-1}, d(dBx)_t = dh_t, dC_t = sum_i dy_t[i] h_t[i],
    dh0 = dA_1 dh_1.  dy or dh_last may be None (zero).  ``hck``: the
    states at the segment starts, as ``ssm_scan_ckpt_plain`` gives them,
    used as given: as in the kernel, each segment's states run from its
    own checkpoint.  With None they run from h0.  Returns (d_dA, d_dBx, dC,
    dh0) in f32."""
    B, S, I, N = dA.shape
    before, after = [], []  # the state before and after each step
    h = h0.float()
    for t in range(S):
        if hck is not None and t % SEG == 0:
            h = hck[:, t // SEG].float()
        before.append(h)
        h = dA[:, t].float() * h + dBx[:, t].float()
        after.append(h)
    g = torch.zeros_like(h) if dh_last is None else dh_last.float()
    dy = torch.zeros((B, S, I), device=dA.device) if dy is None else dy.float()
    d_dA = torch.empty((B, S, I, N), dtype=torch.float32, device=dA.device)
    d_dBx = torch.empty_like(d_dA)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=dA.device)
    for t in reversed(range(S)):
        dh = g + dy[:, t, :, None] * C[:, t, None, :].float()
        d_dBx[:, t] = dh
        d_dA[:, t] = dh * before[t]
        dC[:, t] = torch.einsum("bi,bin->bn", dy[:, t], after[t])
        g = dA[:, t].float() * dh
    return d_dA, d_dBx, dC, g


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssm_scan_launch": ([_P] * 7 + [_I] * 4 + [_P], _I),
}
_BWD_SIGNATURES = {
    "ssm_scan_bwd_launch": ([_P] * 11 + [_I] * 4 + [_P], _I),
    "ssm_scan_bwd_blocks": ([_I, _I], _I),
}


def _check(dA, dBx, C, h0):
    """The shared checks of a call on the card; returns (B, S, I, N)."""
    if dA.dim() != 4 or dBx.shape != dA.shape:
        raise ValueError(f"want dA, dBx (B,S,I,N); got {tuple(dA.shape)}, "
                         f"{tuple(dBx.shape)}")
    B, S, I, N = dA.shape
    if C.shape != (B, S, N) or h0.shape != (B, I, N):
        raise ValueError(f"C {tuple(C.shape)} or h0 {tuple(h0.shape)} does "
                         f"not fit dA {tuple(dA.shape)}")
    if not dA.dtype == dBx.dtype == C.dtype == torch.float32:
        raise ValueError(f"the kernel takes float32 dA, dBx, C, got "
                         f"{dA.dtype}, {dBx.dtype}, {C.dtype}")
    if N < 1 or 32 % N or I % (32 // N):
        raise ValueError(f"the kernel takes N dividing 32 and I a multiple "
                         f"of 32 / N; got N={N}, I={I}")
    return B, S, I, N


def _forward_kernel(dA, dBx, C, h0, with_ckpt=False):
    """One launch of the forward kernel; with ``with_ckpt``, of its
    checkpoint-writing build, and then (y, h_last, hck)."""
    global launches, ckpt_launches
    dev = dA.device
    B, S, I, N = _check(dA, dBx, C, h0)
    lib = _build.library("ssm_scan", _SIGNATURES)
    dA, dBx, C = dA.contiguous(), dBx.contiguous(), C.contiguous()
    h0 = h0.float().contiguous()
    y = torch.empty((B, S, I), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, I, N), dtype=torch.float32, device=dev)
    hck = (torch.empty((B, -(-S // SEG), I, N), dtype=torch.float32,
                       device=dev) if with_ckpt else None)
    status = lib.ssm_scan_launch(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), h0.data_ptr(),
        y.data_ptr(), h_last.data_ptr(), None if hck is None else
        hck.data_ptr(), B, S, I, N, _build.stream_ptr(dev))
    _build.check_status("ssm_scan", status)
    launches += 1
    if hck is None:
        return y, h_last
    ckpt_launches += 1
    return y, h_last, hck


def ssm_scan_with_ckpt(dA, dBx, C, h0):
    """(y, h_last, hck): the forward and its checkpoints, the states before
    steps 0, SEG, 2 SEG, ... (f32 (B, ceil(S / SEG), I, N)), which the
    backward kernel reads.  On the CPU the plain versions; on a card one
    launch of the kernel's checkpoint-writing build, whose y and h_last
    equal the plain build's bit for bit."""
    dev = _build.device_of(dA, dBx, C, h0)
    if dev.type == "cpu":
        return (*ssm_scan_plain(dA, dBx, C, h0),
                ssm_scan_ckpt_plain(dA, dBx, h0))
    if dev.type == "meta":
        return _meta_forward(dA, dBx, C, h0, with_ckpt=True)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dev}")
    return _forward_kernel(dA, dBx, C, h0, with_ckpt=True)


def ssm_scan_bwd(dA, dBx, C, h0, dy, dh_last, hck=None):
    """The backward kernels (``csrc/ssm_scan_bwd.cu``) for tensors on a
    card: (d_dA, d_dBx, dC, dh0) in f32 from dy (B, S, I) and dh_last (B,
    I, N), either of which may be None.  ``hck``: the forward's checkpoints
    as ``ssm_scan_with_ckpt`` gives them; where a caller has none, they
    come from one launch of that build (counted as a forward).  Two
    kernels, one launch counted under ``bwd_launches``."""
    global bwd_launches
    dev = _build.device_of(*(t for t in (dA, dBx, C, h0, dy, dh_last, hck)
                             if t is not None))
    if dev.type != "cuda":
        raise ValueError(f"the backward kernel runs on cuda, not {dev}")
    B, S, I, N = _check(dA, dBx, C, h0)
    if dy is not None and dy.shape != (B, S, I):
        raise ValueError(f"dy {tuple(dy.shape)} must be {(B, S, I)}")
    if dh_last is not None and dh_last.shape != (B, I, N):
        raise ValueError(f"dh_last {tuple(dh_last.shape)} must be {(B, I, N)}")
    if hck is None:
        hck = _forward_kernel(dA, dBx, C, h0, with_ckpt=True)[2]
    if hck.shape != (B, -(-S // SEG), I, N) or hck.dtype != torch.float32:
        raise ValueError(f"hck {tuple(hck.shape)} {hck.dtype} must be f32 "
                         f"{(B, -(-S // SEG), I, N)}")
    lib = _build.library("ssm_scan_bwd", _BWD_SIGNATURES)
    dA, dBx = dA.contiguous(), dBx.contiguous()
    if dA.data_ptr() % 16 or dBx.data_ptr() % 16:
        raise ValueError("the backward kernel reads dA and dBx through TMA, "
                         "which wants their data 16-byte aligned")
    C, hck = C.contiguous(), hck.contiguous()
    dy = None if dy is None else dy.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    d_dA = torch.empty_like(dA)
    d_dBx = torch.empty_like(dA)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, I, N), dtype=torch.float32, device=dev)
    part = torch.empty((B, S, lib.ssm_scan_bwd_blocks(I, N), N),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    status = lib.ssm_scan_bwd_launch(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), hck.data_ptr(), ptr(dy),
        ptr(dh_last), d_dA.data_ptr(), d_dBx.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), part.data_ptr(), B, S, I, N, _build.stream_ptr(dev))
    _build.check_status("ssm_scan_bwd", status)
    bwd_launches += 1
    return d_dA, d_dBx, dC, dh0


def _meta_forward(dA, dBx, C, h0, with_ckpt=False):
    """The shape-only route (``kernels/_meta.py``): the card route's checks
    and outputs (y, h_last, and with ``with_ckpt`` the checkpoints), the
    call's ``cost`` recorded under the kernel the card would launch.  Under
    autograd the forward is ``ssm_fwd<true>``, and the backward records
    ``ssm_bwd_tma + ssm_bwd_dc`` and returns meta gradients."""
    B, S, I, N = _check(dA, dBx, C, h0)
    grad = _meta.wants_grad(dA, dBx, C, h0)
    ckpt = with_ckpt or grad

    def forward(dA, dBx, C, h0):
        _meta.record("ssm_scan", FWD_CKPT if ckpt else FWD,
                     cost(B, S, I, N, ckpt=ckpt), dA, dBx)
        out = (_meta.empty((B, S, I), torch.float32),
               _meta.empty((B, I, N), torch.float32))
        if with_ckpt:
            out += (_meta.empty((B, -(-S // SEG), I, N), torch.float32),)
        return out

    if not grad:
        return forward(dA, dBx, C, h0)

    def backward(dy, *_):
        _meta.record("ssm_scan_grad", BWD,
                     cost(B, S, I, N, ckpt=True, backward=True), dy)
        f32 = torch.float32
        return (_meta.empty((B, S, I, N), f32), _meta.empty((B, S, I, N), f32),
                _meta.empty((B, S, N), f32), _meta.empty((B, I, N), h0.dtype))

    return _meta.MetaFn.apply(forward, backward, dA, dBx, C, h0)


class SSMScanFn(torch.autograd.Function):
    """The forward kernel's checkpoint-writing build, with the backward
    kernels as its gradient (tensors on a card only; on the CPU autograd
    runs through the plain version).  The checkpoints go through
    ``save_for_backward``, so that a non-reentrant activation checkpoint
    drops them with the other saved tensors and recomputes them."""

    @staticmethod
    def forward(ctx, dA, dBx, C, h0):
        y, h_last, hck = _forward_kernel(dA, dBx, C, h0, with_ckpt=True)
        ctx.save_for_backward(dA, dBx, C, h0, hck)
        return y, h_last

    @staticmethod
    def backward(ctx, dy, dh_last):
        dA, dBx, C, h0, hck = ctx.saved_tensors
        d_dA, d_dBx, dC, dh0 = ssm_scan_bwd(dA, dBx, C, h0, dy, dh_last, hck)
        return d_dA, d_dBx, dC, dh0.to(h0.dtype)


#: the dims each argument may be sharded over, by role (dA, dBx, C, h0),
#: and the outputs' (y, h_last)
_SHARDS = ({0: "batch", 2: "inner"}, {0: "batch", 2: "inner"}, {0: "batch"},
           {0: "batch", 1: "inner"})
_OUT_SHARDS = ({0: "batch", 2: "inner"}, {0: "batch", 1: "inner"})


def ssm_scan(dA, dBx, C, h0):
    """dA, dBx: (B, S, I, N); C: (B, S, N); h0: (B, I, N).  Returns
    (y (B, S, I) in dA's dtype, h_last (B, I, N) f32); on a card, f32
    inputs only.  Where a gradient is wanted on a card, the call goes
    through ``SSMScanFn``.  DTensors may be sharded over batch and the
    inner channels: each rank runs the kernel on its shard
    (``kernels/_dtensor.py``)."""
    if _dtensor.any_dtensor(dA, dBx, C, h0):
        return _dtensor.on_shards("ssm_scan", ssm_scan, (dA, dBx, C, h0),
                                  _SHARDS, _OUT_SHARDS)
    dev = _build.device_of(dA, dBx, C, h0)
    if dev.type == "cpu":
        return ssm_scan_plain(dA, dBx, C, h0)
    if dev.type == "meta":
        return _meta_forward(dA, dBx, C, h0)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dA, dBx, C, h0)):
        return SSMScanFn.apply(dA, dBx, C, h0)
    return _forward_kernel(dA, dBx, C, h0)
