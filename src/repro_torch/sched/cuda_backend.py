"""CUDA backend: fused Load-Credit tick + k-lowest-credit selection.

Port of ``repro.sched.pallas_backend``.  Wraps the kernel
``repro_torch.kernels.lags_select`` (PELT + Load Credit EMA update followed by
top-k-lowest selection — ``pick_next_task_fair`` vectorised).  The serving
engine routes its per-step credit tick through this path once the tenant
count reaches ``EngineConfig.pallas_threshold``.

``tick_and_pick`` keeps the reference's signature and returns, with
``device`` in place of ``interpret``: the tick runs on the card by default,
and on the CPU (the kernel's plain version) only when ``device="cpu"`` is
asked for.  ``numpy_reference`` is the float64 oracle, copied.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core.load_credit import (
    DEFAULT_EMA_WINDOW,
    PELT_HALFLIFE_TICKS,
    ema_update,
    pelt_update,
)
from repro_torch.device import resolve
from repro_torch.kernels import ops


def tick_and_pick(load_avg, credit, running_frac, runnable, k: int, *,
                  window: int = DEFAULT_EMA_WINDOW,
                  halflife: int = PELT_HALFLIFE_TICKS,
                  device=None):
    """One scheduler tick over T groups on the kernel.

    Inputs are host arrays; they go to ``device`` as float32 (bool for
    ``runnable``), as the reference casts them to f32 for its kernel.
    Returns ``(new_load (T,), new_credit (T,), picked_idx (k,) int32)``
    numpy arrays, with -1 padding when fewer than k groups are runnable.
    Picked order is ascending key ``new_credit + index*1e-12`` in f32, ties
    to the lower index — the Pallas kernel's order.
    """
    dev = resolve(device)
    as_f32 = lambda x: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.float32), device=dev)
    nl, nc, idx = ops.lags_select(
        as_f32(load_avg), as_f32(credit), as_f32(running_frac),
        torch.as_tensor(np.asarray(runnable, bool), device=dev),
        k, window=window, halflife=halflife,
    )
    return nl.cpu().numpy(), nc.cpu().numpy(), idx.cpu().numpy()


def numpy_reference(load_avg, credit, running_frac, runnable, k: int, *,
                    window: int = DEFAULT_EMA_WINDOW,
                    halflife: int = PELT_HALFLIFE_TICKS
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """float64 oracle: same tick + selection via the numpy protocol path."""
    y = 0.5 ** (1.0 / halflife)
    new_load = pelt_update(np.asarray(load_avg, np.float64),
                           np.asarray(running_frac, np.float64), y)
    new_credit = ema_update(np.asarray(credit, np.float64), new_load, window)
    runnable = np.asarray(runnable, bool)
    order = [i for i in np.lexsort((np.arange(len(new_credit)), new_credit))
             if runnable[i]][:k]
    picked = np.full(k, -1, np.int32)
    picked[: len(order)] = order
    return new_load, new_credit, picked
