"""Mamba-1 selective scan: h_t = dA_t * h_{t-1} + dBx_t, y_t = h_t . C_t.

Port of ``repro.kernels.ssm_scan`` (the Pallas TPU kernel).  The CUDA kernel
is ``csrc/ssm_scan.cu``; ``ssm_scan_plain`` beside it is its plain PyTorch
version.  ``ssm_scan`` runs the plain version for tensors on the CPU and
launches the kernel for tensors on a card; there is no fallback from one to
the other.

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

#: kernel launches so far (plain-version calls are not counted)
launches = 0


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


_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ssm_scan_launch": ([_P] * 6 + [_I] * 4 + [_P], _I),
}


def ssm_scan(dA, dBx, C, h0):
    """dA, dBx: (B, S, I, N); C: (B, S, N); h0: (B, I, N).  Returns
    (y (B, S, I) in dA's dtype, h_last (B, I, N) f32); on a card, f32
    inputs only."""
    global launches
    dev = _build.device_of(dA, dBx, C, h0)
    if dev.type == "cpu":
        return ssm_scan_plain(dA, dBx, C, h0)
    if dev.type != "cuda":
        raise ValueError(f"ssm_scan runs on cuda or cpu, not {dev}")
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
