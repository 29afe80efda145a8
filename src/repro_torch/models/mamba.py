"""Mamba-1 selective SSM block (the falcon-mamba mixer).

Port of ``repro.models.mamba``.  The conv is the reference's causal
depthwise conv as shifted adds (not a cuDNN convolution).  Prefill (S > 1)
builds dA = exp(dt * A) and dBx = dt * B * x as the reference does and runs
the scan on ``ops.ssm_scan``: the CUDA kernel on a card, its plain version
on the CPU.  It walks the sequence in chunks of ``CHUNK`` = 256 tokens with
the state carried from one to the next, as the reference does, which bounds
the (B, chunk, I, N) f32 temporaries (0.5 GiB each at falcon-mamba's width
and B = 4); the last chunk may be shorter, so any S is taken.  Decode
(S = 1) is the reference's single recurrence step in PyTorch.

The reference rounds ``xc``, ``Bm`` and ``Cm`` to the activation dtype
before casting them to f32; the port keeps those casts in the same places.
The cache {"h": (B, I, N) f32, "conv": (B, W-1, I)} is updated in place
(the reference returns a new one).  Without a cache (training, as the
reference's ``cache`` None) the state starts at zero, the conv is padded
with zeros, and nothing is written, so autograd sees no in-place update; on
a card each chunk's scan then runs ``ssm_scan``'s forward kernel with its
backward kernel as the gradient, the chunks chained through h0's gradient.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

CHUNK = 256  # tokens per scan in prefill: the reference's chunk


def mamba_specs(cfg: ModelConfig) -> dict:
    """{leaf: (shape, init, dtype name)} of one layer, the reference's."""
    M, I, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                     cfg.dt_rank_resolved, cfg.d_conv)
    pd = cfg.param_dtype
    return {
        "in_proj": ((M, 2 * I), "dense", pd),
        "conv_w": ((W, I), "dense", pd),
        "conv_b": ((I,), "zeros", pd),
        "x_proj": ((I, R + 2 * N), "dense", pd),
        "dt_proj": ((R, I), "dense", pd),
        "dt_bias": ((I,), "zeros", "float32"),
        "A_log": ((I, N), "ssm_a", "float32"),
        "D": ((I,), "ones", "float32"),
        "out_proj": ((I, M), "dense", pd),
    }


def _conv_shift(x_pad, w, b, S: int):
    """Causal depthwise conv via shifted adds.  x_pad: (B, S+W-1, I)."""
    W = w.shape[0]
    y = None
    for j in range(W):
        term = x_pad[:, j:j + S, :] * w[j]
        y = term if y is None else y + term
    return y + b


def mamba_mixer(params: dict, x, cfg: ModelConfig, cache: dict | None):
    """x: (B, S, M) -> y (B, S, M); ``cache`` = {"h", "conv"} is read as the
    initial state and overwritten with the final one; None starts from zero
    and keeps nothing."""
    B, S, M = x.shape
    I, N, R, W = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved, cfg.d_conv
    dt_ = x.dtype

    xz = x @ params["in_proj"].to(dt_)
    xin, z = xz[..., :I], xz[..., I:]
    conv0 = (torch.zeros((B, W - 1, I), dtype=dt_, device=x.device)
             if cache is None else cache["conv"].to(dt_))
    x_pad = torch.cat([conv0, xin], dim=1)
    new_conv = x_pad[:, -(W - 1):, :]
    xc = F.silu(_conv_shift(x_pad, params["conv_w"].to(dt_),
                            params["conv_b"].to(dt_), S))

    xdb = xc @ params["x_proj"].to(dt_)
    dt_raw, Bm, Cm = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    dt = F.softplus((dt_raw @ params["dt_proj"].to(dt_)).float()
                    + params["dt_bias"])  # (B, S, I) f32
    A = -torch.exp(params["A_log"])  # (I, N) f32
    Bm32, Cm32, xc32 = Bm.float(), Cm.float(), xc.float()
    h0 = (torch.zeros((B, I, N), dtype=torch.float32, device=x.device)
          if cache is None else cache["h"].float())

    if S == 1:  # decode: a single recurrence step
        dA = torch.exp(dt[:, 0, :, None] * A)  # (B, I, N)
        dBx = dt[:, 0, :, None] * Bm32[:, 0, None, :] * xc32[:, 0, :, None]
        h = dA * h0 + dBx
        y = torch.einsum("bin,bn->bi", h, Cm32[:, 0])[:, None, :]
        h_last = h
    else:
        ys, h_last = [], h0
        for c0 in range(0, S, CHUNK):
            sl = slice(c0, min(c0 + CHUNK, S))
            dt_c = dt[:, sl]
            dA = torch.exp(dt_c[..., None] * A)  # (B, cs, I, N)
            dBx = dt_c[..., None] * Bm32[:, sl, None, :] * xc32[:, sl, :, None]
            y_c, h_last = ops.ssm_scan(dA, dBx, Cm32[:, sl].contiguous(),
                                       h_last)
            ys.append(y_c)
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    y = (y + xc32 * params["D"]).to(dt_) * F.silu(z)
    out = y @ params["out_proj"].to(dt_)
    if cache is not None:
        cache["h"].copy_(h_last)
        cache["conv"].copy_(new_conv)
    return out
