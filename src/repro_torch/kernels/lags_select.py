"""The LAGS scheduler tick: PELT + Load Credit EMA, then k-lowest selection.

Port of ``repro.kernels.lags_select`` (the Pallas TPU kernel).  The CUDA
kernel is ``csrc/lags_select.cu``; ``lags_select_plain`` beside it is its
plain PyTorch version.  ``lags_select`` runs the plain version for tensors on
the CPU and launches the kernel for tensors on a card; there is no fallback
from one to the other.

Pick order.  Both the Pallas kernel and ``repro.kernels.ref`` pick by the f32
key ``new_credit + lane*1e-12`` and take the first lane on equal keys.  Once
credits are below about 1e-4 the lane term reorders picks against a plain
(credit, index) sort, so the port reproduces the key bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.load_credit import DEFAULT_EMA_WINDOW, PELT_HALFLIFE_TICKS
from repro_torch.kernels import _build

#: kernel launches so far (plain-version calls are not counted)
launches = 0

# merge-pass candidates live in 48 KB of shared memory, with room to spare
_MAX_CANDIDATES = 5120


def coefficients(window: int, halflife: int):
    """(y, 1-y, alpha, 1-alpha) as Python doubles; both versions round each
    to f32 once, as JAX does with a Python scalar against an f32 array."""
    y = 0.5 ** (1.0 / halflife)
    alpha = 2.0 / (window + 1.0)
    return y, 1.0 - y, alpha, 1.0 - alpha


def lags_select_plain(load_avg, credit, running_frac, runnable, k, *,
                      window=DEFAULT_EMA_WINDOW,
                      halflife=PELT_HALFLIFE_TICKS):
    """Plain PyTorch version: the same f32 arithmetic, one op per product
    and per sum, and a stable sort of the same key (ties to the lower
    lane).  ``torch.topk`` is not used: its order among ties is unset."""
    dev = load_avg.device
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    y, omy, alpha, oma = map(f32, coefficients(window, halflife))
    new_load = y * load_avg + omy * running_frac
    new_credit = oma * credit + alpha * new_load
    T = new_credit.shape[0]
    lane = torch.arange(T, device=dev)
    key = torch.where(runnable, new_credit + lane.to(torch.float32) * f32(1e-12),
                      f32(float("inf")))
    sorted_key, order = torch.sort(key, stable=True)
    n = min(k, T)
    picked = torch.full((k,), -1, dtype=torch.int32, device=dev)
    picked[:n] = torch.where(torch.isfinite(sorted_key[:n]),
                             order[:n].to(torch.int32), -1)
    return new_load, new_credit, picked


_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "lags_select_launch": ([_P] * 11 + [_I, _I, _F, _F, _F, _F, _P], _I),
    "lags_select_scratch": ([_I, _I], _I),
}


def lags_select(load_avg, credit, running_frac, runnable, k, *,
                window=DEFAULT_EMA_WINDOW, halflife=PELT_HALFLIFE_TICKS):
    """One scheduler tick over T tenants.  Inputs (T,): three float32 and a
    bool ``runnable``, all on one device.

    Returns (new_load (T,), new_credit (T,), picked (k,) int32), the picks in
    ascending key order with -1 padding when fewer than k are runnable.
    """
    global launches
    dev = _build.device_of(load_avg, credit, running_frac, runnable)
    if dev.type == "cpu":
        return lags_select_plain(load_avg, credit, running_frac, runnable, k,
                                 window=window, halflife=halflife)
    if dev.type != "cuda":
        raise ValueError(f"lags_select runs on cuda or cpu, not {dev}")
    T = load_avg.shape[0]
    for name, t, dt in (("load_avg", load_avg, torch.float32),
                        ("credit", credit, torch.float32),
                        ("running_frac", running_frac, torch.float32),
                        ("runnable", runnable, torch.bool)):
        if t.dtype != dt or t.shape != (T,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({T},) {dt} tensor, "
                             f"got {tuple(t.shape)} {t.dtype}")
    if T == 0 or k <= 0:
        raise ValueError(f"lags_select needs T >= 1 and k >= 1 (T={T}, k={k})")
    lib = _build.library("lags_select", _SIGNATURES)
    n_cand = lib.lags_select_scratch(T, k)
    if n_cand > _MAX_CANDIDATES:
        raise ValueError(f"T={T}, k={k} needs {n_cand} merge candidates "
                         f"(at most {_MAX_CANDIDATES})")
    new_load = torch.empty_like(load_avg)
    new_credit = torch.empty_like(credit)
    picked = torch.empty(k, dtype=torch.int32, device=dev)
    cand_key = torch.empty(n_cand, dtype=torch.float32, device=dev)
    cand_lane = torch.empty(n_cand, dtype=torch.int32, device=dev)
    out_key = torch.empty(k, dtype=torch.float32, device=dev)
    out_lane = torch.empty(k, dtype=torch.int32, device=dev)
    y, omy, alpha, oma = coefficients(window, halflife)
    status = lib.lags_select_launch(
        load_avg.data_ptr(), credit.data_ptr(), running_frac.data_ptr(),
        runnable.data_ptr(), new_load.data_ptr(), new_credit.data_ptr(),
        picked.data_ptr(), cand_key.data_ptr(), cand_lane.data_ptr(),
        out_key.data_ptr(), out_lane.data_ptr(), T, k, y, omy, alpha, oma,
        _build.stream_ptr(dev))
    _build.check_status("lags_select", status)
    launches += 1
    return new_load, new_credit, picked
