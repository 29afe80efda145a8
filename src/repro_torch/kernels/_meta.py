"""The kernel wrappers' shape-only route, for tensors on the meta device.

The dry run (``launch/dryrun.py``) executes each cell's sharded step on
meta tensors: shapes and dtypes, no storage.  There a wrapper makes its
card route's checks and returns ``torch.empty(..., device="meta")``
outputs with the card route's shapes and dtypes; neither a kernel nor a
plain version runs (the plain scan loops over every step, the plain
attention builds S x S scores).  Each call adds one entry to the active
record (``recording``): the wrapper, the kernel the card would launch, its
(FLOPs, HBM bytes) from the kernel module's ``cost``, and the shapes of
its first two arguments (of the gradient, for a backward).  The launch
counters (``ops.launch_counts``) count launches on a card and are not
touched.  Under autograd the route goes through ``MetaFn``, whose
backward records the backward kernel the card would run and returns meta
gradients.

This is not a fallback: a CUDA tensor still launches its kernel or
raises, and a CPU tensor runs the plain version.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import NamedTuple

import torch


class Call(NamedTuple):
    """One meta-route call: ``wrapper`` ("flash_attention",
    "flash_attention_grad", "decode_attention", "ssm_scan",
    "ssm_scan_grad"), the card's kernel, its FLOPs and HBM bytes, and the
    shapes it ran on."""
    wrapper: str
    kernel: str
    flops: int
    bytes: int
    shapes: list


_RECORD: list | None = None


@contextmanager
def recording():
    """Collect the meta routes' calls into the list it yields."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def record(wrapper: str, kernel: str, cost: tuple, *tensors) -> None:
    if _RECORD is not None:
        _RECORD.append(Call(wrapper, kernel, int(cost[0]), int(cost[1]),
                            [list(t.shape) for t in tensors]))


def empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class MetaFn(torch.autograd.Function):
    """``forward(*inputs)`` with ``backward(*output gradients)`` as its
    gradient; each returns what the card route's would, on the meta
    device.  ``backward`` returns one gradient (or None) per input."""

    @staticmethod
    def forward(ctx, forward, backward, *inputs):
        ctx.backward_fn = backward
        return forward(*inputs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.backward_fn(*grads))
