"""Mamba-1 selective scan: h_t = dA_t * h_{t-1} + dBx_t, y_t = h_t . C_t.

Port of ``repro.kernels.ssm_scan`` (the Pallas TPU kernel).  The CUDA kernel
is ``csrc/ssm_scan.cu``; ``ssm_scan_plain`` beside it is its plain PyTorch
version.  ``ssm_scan`` runs the plain version for tensors on the CPU
(autograd differentiates it there) and launches the kernel for tensors on a
card; there is no fallback from one to the other.  Where a gradient is
wanted on a card it goes through ``SSMScanFn``, whose backward pass is the
kernel of ``csrc/ssm_scan_bwd.cu`` (plain version ``ssm_scan_bwd_plain``):
the TPU kernel has no backward, and the reference trains through its
``jnp`` scan (``repro.models.mamba._ssm_chunk``) differentiated by XLA.

The signature is the TPU kernel's: dA, dBx (B, S, I, N); C (B, S, N);
h0 (B, I, N) -> (y (B, S, I) in dA's dtype, h_last (B, I, N) f32).  The state
is carried in f32 across all of S; the TPU kernel's time chunks and channel
blocks are VMEM tiling and are not carried over.  On a card the kernel takes
f32 inputs only: the Mamba mixer builds dA and dBx in f32.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: kernel launches so far (plain-version calls are not counted): the
#: forward, and the backward (one per call of its three kernels)
launches = 0
bwd_launches = 0


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


def ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh_last):
    """Plain PyTorch version of the backward kernel: the recurrence of dh
    run backward step by step in f32, dh_t = dA_{t+1} dh_{t+1} + dy_t C_t;
    d(dA)_t = dh_t h_{t-1}, d(dBx)_t = dh_t, dC_t = sum_i dy_t[i] h_t[i],
    dh0 = dA_1 dh_1.  dy or dh_last may be None (zero).  Returns (d_dA,
    d_dBx, dC, dh0) in f32."""
    B, S, I, N = dA.shape
    hs = [h0.float()]
    for t in range(S):
        hs.append(dA[:, t].float() * hs[-1] + dBx[:, t].float())
    g = (torch.zeros_like(hs[0]) if dh_last is None else dh_last.float())
    dy = torch.zeros((B, S, I), device=dA.device) if dy is None else dy.float()
    d_dA = torch.empty((B, S, I, N), dtype=torch.float32, device=dA.device)
    d_dBx = torch.empty_like(d_dA)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=dA.device)
    for t in reversed(range(S)):
        dh = g + dy[:, t, :, None] * C[:, t, None, :].float()
        d_dBx[:, t] = dh
        d_dA[:, t] = dh * hs[t]
        dC[:, t] = torch.einsum("bi,bin->bn", dy[:, t], hs[t + 1])
        g = dA[:, t].float() * dh
    return d_dA, d_dBx, dC, g


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssm_scan_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
}
_BWD_SIGNATURES = {
    "ssm_scan_bwd_launch": ([_P] * 12 + [_I] * 4 + [_P], _I),
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


def _forward_kernel(dA, dBx, C, h0):
    global launches
    dev = dA.device
    B, S, I, N = _check(dA, dBx, C, h0)
    lib = _build.library("ssm_scan", _SIGNATURES)
    dA, dBx, C = dA.contiguous(), dBx.contiguous(), C.contiguous()
    h0 = h0.float().contiguous()
    y = torch.empty((B, S, I), dtype=torch.float32, device=dev)
    h_last = torch.empty((B, I, N), dtype=torch.float32, device=dev)
    status = lib.ssm_scan_launch(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(),
        h0.data_ptr(), y.data_ptr(), h_last.data_ptr(), B, S, I, N,
        _build.stream_ptr(dev))
    _build.check_status("ssm_scan", status)
    launches += 1
    return y, h_last


def ssm_scan_bwd(dA, dBx, C, h0, dy, dh_last):
    """The backward kernel (``csrc/ssm_scan_bwd.cu``) for tensors on a card:
    (d_dA, d_dBx, dC, dh0) in f32 from dy (B, S, I) and dh_last (B, I, N),
    either of which may be None.  Three kernels, one launch counted."""
    global bwd_launches
    dev = _build.device_of(*(t for t in (dA, dBx, C, h0, dy, dh_last)
                             if t is not None))
    if dev.type != "cuda":
        raise ValueError(f"the backward kernel runs on cuda, not {dev}")
    B, S, I, N = _check(dA, dBx, C, h0)
    if dy is not None and dy.shape != (B, S, I):
        raise ValueError(f"dy {tuple(dy.shape)} must be {(B, S, I)}")
    if dh_last is not None and dh_last.shape != (B, I, N):
        raise ValueError(f"dh_last {tuple(dh_last.shape)} must be {(B, I, N)}")
    lib = _build.library("ssm_scan_bwd", _BWD_SIGNATURES)
    dA, dBx, C = dA.contiguous(), dBx.contiguous(), C.contiguous()
    h0 = h0.float().contiguous()
    dy = None if dy is None else dy.float().contiguous()
    dh_last = None if dh_last is None else dh_last.float().contiguous()
    d_dA = torch.empty_like(dA)
    d_dBx = torch.empty_like(dA)
    dC = torch.empty((B, S, N), dtype=torch.float32, device=dev)
    dh0 = torch.empty((B, I, N), dtype=torch.float32, device=dev)
    n_seg = -(-S // 16)
    hck = torch.empty((B, n_seg, I, N), dtype=torch.float32, device=dev)
    part = torch.empty((B, S, lib.ssm_scan_bwd_blocks(I, N), N),
                       dtype=torch.float32, device=dev)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    status = lib.ssm_scan_bwd_launch(
        dA.data_ptr(), dBx.data_ptr(), C.data_ptr(), h0.data_ptr(), ptr(dy),
        ptr(dh_last), d_dA.data_ptr(), d_dBx.data_ptr(), dC.data_ptr(),
        dh0.data_ptr(), hck.data_ptr(), part.data_ptr(), B, S, I, N,
        _build.stream_ptr(dev))
    _build.check_status("ssm_scan_bwd", status)
    bwd_launches += 1
    return d_dA, d_dBx, dC, dh0


class SSMScanFn(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient (tensors
    on a card only; on the CPU autograd runs through the plain version)."""

    @staticmethod
    def forward(ctx, dA, dBx, C, h0):
        ctx.save_for_backward(dA, dBx, C, h0)
        return _forward_kernel(dA, dBx, C, h0)

    @staticmethod
    def backward(ctx, dy, dh_last):
        dA, dBx, C, h0 = ctx.saved_tensors
        d_dA, d_dBx, dC, dh0 = ssm_scan_bwd(dA, dBx, C, h0, dy, dh_last)
        return d_dA, d_dBx, dC, dh0.to(h0.dtype)


def ssm_scan(dA, dBx, C, h0):
    """dA, dBx: (B, S, I, N); C: (B, S, N); h0: (B, I, N).  Returns
    (y (B, S, I) in dA's dtype, h_last (B, I, N) f32); on a card, f32
    inputs only.  Where a gradient is wanted on a card, the call goes
    through ``SSMScanFn``."""
    dev = _build.device_of(dA, dBx, C, h0)
    if dev.type == "cpu":
        return ssm_scan_plain(dA, dBx, C, h0)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (dA, dBx, C, h0)):
        return SSMScanFn.apply(dA, dBx, C, h0)
    return _forward_kernel(dA, dBx, C, h0)
