"""The selective scan's own work: the least that any implementation of it
must read, write and compute, from its shapes alone.

One call is one Mamba layer's scan over a whole batch of B sequences of S
steps, I channels and N states; how a program cuts it (chunks of steps,
the materialised dA = exp(dt A) and dBx = dt B x, checkpoints) does not
change the count.

Forward.  In: x and dt (B, S, I), B and C (B, S, N) in the activation
dtype; A (I, N) and h0 (B, I, N) in f32.  Out: y (B, S, I) in the
activation dtype, h_last (B, I, N) f32.  The gate z and the skip D x are
left out: a scan kernel need not do them.  FLOPs, per element of (B, S, I,
N): dt A and its exp (2), (dt x) B (1), h = dA h + dBx (2), y += h C (2);
and dt x once per (B, S, I) (1).

Backward.  In: the forward's inputs and dy (B, S, I).  Out: dx and d(dt)
(B, S, I), dB and dC (B, S, N) in the activation dtype, dA (I, N) and dh0
(B, I, N) in f32.  FLOPs, per element of (B, S, I, N): the state again
(5), dh = g + dy C (2), s = dh h_prev (1), d(dt) += s dA A (3), dA += s dA
dt (2), dB += dh (dt x) (2), d(dt x) += dh B (2), dC += dy h (2), g = dA dh
(1): 20; and dx, d(dt) from d(dt x) per (B, S, I) (4).
"""
from __future__ import annotations

FWD_FLOPS, FWD_FLOPS_BSI = 7, 1
BWD_FLOPS, BWD_FLOPS_BSI = 20, 4


def forward(B: int, S: int, I: int, N: int, act_bytes: int = 2):
    """(FLOPs, bytes) of one forward call."""
    bsi, bsn, bin_ = B * S * I, B * S * N, B * I * N
    flops = FWD_FLOPS * bsi * N + FWD_FLOPS_BSI * bsi
    nbytes = (act_bytes * (2 * bsi + 2 * bsn) + 4 * (I * N + bin_)
              + act_bytes * bsi + 4 * bin_)
    return flops, nbytes


def backward(B: int, S: int, I: int, N: int, act_bytes: int = 2):
    """(FLOPs, bytes) of one backward call."""
    bsi, bsn, bin_ = B * S * I, B * S * N, B * I * N
    flops = BWD_FLOPS * bsi * N + BWD_FLOPS_BSI * bsi
    reads = act_bytes * (3 * bsi + 2 * bsn) + 4 * (I * N + bin_)
    writes = act_bytes * (2 * bsi + 2 * bsn) + 4 * (I * N + bin_)
    return flops, reads + writes


def least_seconds(flops: float, nbytes: float, peak_flops: float,
                  peak_bytes: float) -> float:
    """The least time of a call: the larger of its two bounds."""
    return max(flops / peak_flops, nbytes / peak_bytes)
