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
a card each chunk's scan then runs ``ssm_scan``'s forward kernel (its build
that keeps a state every 16 steps) with its backward kernel as the gradient,
the chunks chained through h0's gradient.

Under a mesh (DTensor activations) the inner channels are split over
"model" as the reference's rules place them.  ``in_proj`` is one (M, 2I)
leaf split over its columns, so at tp 2 one rank holds the x half and the
other the z half: its output is gathered before the split at I, as in the
reference's partitioned program, and x and z are each split over the inner
channels again.  The conv, the gate and the scan run on each rank's
channels (the parameters' shards); ``x_proj`` contracts over the inner
channels, so its partial output is summed over the ranks (an explicit
all-reduce) before the dt, B and C split; ``ssm_scan`` gets DTensors split
over batch and inner channels and runs on each rank's shard; ``out_proj``
is row-parallel, its partial sums reduced by the output's constraint.

In training the gradients take the same way back: ``in_proj``'s gathered
output takes the rank's chunk of the gradient of x and z, the FSDP gathers
reduce-scatter the weights' gradients, and the scan's backward runs on
each rank's shards.  Inside the rank's channels, a tensor that is the same
on every rank of "model" (x_proj's summed output and its dt, B and C
parts) carries each rank's term of its gradient, summed once where the sum
was taken (``sharding.reduce_grad``); the parameters replicated over the
batch axes carry the rank's rows' term, which the train step's constraint
of the gradients sums.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels import ops

CHUNK = 256  # tokens per scan in prefill: the reference's chunk


def mamba_specs(cfg: ModelConfig) -> dict:
    """{leaf: (shape, init, dtype name, logical axes)} of one layer, the
    reference's."""
    M, I, N, R, W = (cfg.d_model, cfg.d_inner, cfg.ssm_state,
                     cfg.dt_rank_resolved, cfg.d_conv)
    pd = cfg.param_dtype
    return {
        "in_proj": ((M, 2 * I), "dense", pd, ("embed_p", "ssm_inner")),
        "conv_w": ((W, I), "dense", pd, ("conv", "ssm_inner")),
        "conv_b": ((I,), "zeros", pd, ("ssm_inner",)),
        "x_proj": ((I, R + 2 * N), "dense", pd, ("ssm_inner", None)),
        "dt_proj": ((R, I), "dense", pd, ("dt_rank", "ssm_inner")),
        "dt_bias": ((I,), "zeros", "float32", ("ssm_inner",)),
        "A_log": ((I, N), "ssm_a", "float32", ("ssm_inner", "ssm_state")),
        "D": ((I,), "ones", "float32", ("ssm_inner",)),
        "out_proj": ((I, M), "dense", pd, ("ssm_inner", "embed_p")),
    }


def _conv_shift(x_pad, w, b, S: int):
    """Causal depthwise conv via shifted adds.  x_pad: (B, S+W-1, I)."""
    W = w.shape[0]
    y = None
    for j in range(W):
        term = x_pad[:, j:j + S, :] * w[j]
        y = term if y is None else y + term
    return y + b


def _scan(dA, dBx, C, h0, B: int, I: int, sharded: bool):
    """``ops.ssm_scan`` on the rank's shards: sharded, handed over as
    DTensors split over batch and inner channels (global batch B, I
    channels); returns local tensors."""
    if not sharded:
        return ops.ssm_scan(dA, dBx, C, h0)
    S, N = dA.shape[1], dA.shape[3]
    dA, dBx = (sh.from_local(t, (B, S, I, N), "batch", "seq", "ssm_inner",
                             "ssm_state") for t in (dA, dBx))
    y, h = ops.ssm_scan(
        dA, dBx,
        # the same C on every rank of the inner axes, read for the rank's
        # channels: its gradient stays each rank's term (see mamba_mixer)
        sh.from_local(C, (B, S, N), "batch", "seq", "ssm_state",
                      partial_grad=sh.shard_axes(dA, 2)),
        sh.from_local(h0, (B, I, N), "batch", "ssm_inner", "ssm_state"))
    return sh.local(y), sh.local(h)


def mamba_mixer(params: dict, x, cfg: ModelConfig, cache: dict | None):
    """x: (B, S, M) -> y (B, S, M); ``cache`` = {"h", "conv"} is read as the
    initial state and overwritten with the final one; None starts from zero
    and keeps nothing."""
    B, S, M = x.shape
    I, N, R, W = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_resolved, cfg.d_conv
    dt_ = x.dtype

    x = constrain(x, "batch", "seq", None)  # gather the sequence-split rows
    # in_proj's columns are split over the ranks: gather before the split
    xz = constrain(x @ sh.gathered(params["in_proj"]).to(dt_), "batch", "seq",
                   None)
    xin = constrain(xz[..., :I], "batch", "seq", "ssm_inner")
    z = constrain(xz[..., I:], "batch", "seq", "ssm_inner")
    # from here on each rank's inner channels, with the parameters' shards;
    # a parameter replicated over the batch axes takes the gradient of the
    # rank's rows only, which the gradients' constraint sums
    sharded, inner = sh.is_dtensor(xin), sh.shard_axes(xin, 2)
    rows = sh.shard_axes(xin, 0)
    p = {k: sh.local(v, partial=rows) for k, v in params.items()
         if k not in ("in_proj", "out_proj")}
    xin, z = sh.local(xin), sh.local(z)
    Bl, Il = xin.shape[0], xin.shape[2]
    conv0 = (torch.zeros((Bl, W - 1, Il), dtype=dt_, device=xin.device)
             if cache is None else sh.local(cache["conv"]).to(dt_))
    x_pad = torch.cat([conv0, xin], dim=1)
    new_conv = x_pad[:, -(W - 1):, :]
    xc = F.silu(_conv_shift(x_pad, p["conv_w"].to(dt_), p["conv_b"].to(dt_),
                            S))

    # partial over inner; then the same on every rank, but each reads it
    # for its own channels (dt_proj, dBx and the scan's C): its gradient,
    # each rank's term, is summed over inner
    xdb = sh.reduce_grad(sh.psum(xc @ p["x_proj"].to(dt_), inner), inner)
    dt_raw, Bm, Cm = xdb[..., :R], xdb[..., R:R + N], xdb[..., R + N:]
    dt = F.softplus((dt_raw @ p["dt_proj"].to(dt_)).float()
                    + p["dt_bias"])  # (B, S, I) f32
    A = -torch.exp(p["A_log"])  # (I, N) f32
    Bm32, Cm32, xc32 = Bm.float(), Cm.float(), xc.float()
    h0 = (torch.zeros((Bl, Il, N), dtype=torch.float32, device=xin.device)
          if cache is None else sh.local(cache["h"]).float())

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
            y_c, h_last = _scan(dA, dBx, Cm32[:, sl].contiguous(), h_last,
                                B, I, sharded)
            ys.append(y_c)
        y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)

    y = (y + xc32 * p["D"]).to(dt_) * F.silu(z)
    if sharded:
        y = sh.from_local(y, (B, S, I), "batch", "seq", "ssm_inner")
    w_out = sh.gathered(params["out_proj"]).to(dt_)
    out = sh.whole_on_one_rank(y) @ w_out  # sharded: partial
    if cache is not None:
        sh.local(cache["h"]).copy_(h_last)
        sh.local(cache["conv"]).copy_(new_conv)
    return constrain(out, "batch", "seq", None)
