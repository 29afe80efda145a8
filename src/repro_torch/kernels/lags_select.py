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

#: the reference's stated limit (src/repro/kernels/lags_select.py:8), and the
#: most lanes one cluster of 8 CTAs x 1024 threads x 8 lanes holds
MAX_T = 65536
#: the most survivors, min(k, T), that CTA 0 sorts in shared memory
MAX_PICKS = 2048

_checked_occupancy = False


def check_domain(T: int, k: int) -> None:
    """Raise ``ValueError`` for a (T, k) the kernel does not take: T above
    65536, or more than 2048 real picks, min(k, T) (k > T pads with -1)."""
    if T < 1 or k < 1:
        raise ValueError(f"lags_select needs T >= 1 and k >= 1 (T={T}, k={k})")
    if T > MAX_T:
        raise ValueError(f"lags_select takes T <= {MAX_T} tenants, the "
                         f"reference kernel's stated limit (T={T})")
    if min(k, T) > MAX_PICKS:
        raise ValueError(f"lags_select sorts at most {MAX_PICKS} picks in "
                         f"shared memory (T={T}, k={k})")


def plan(T: int):
    """(ctas, threads, lanes a thread) of the cluster launch for T lanes:
    one CTA up to 8192 lanes (4 a thread up to 4096), else ceil(T/8192)
    CTAs of up to 1024 threads, 8 lanes each."""
    ceil = lambda a, b: -(-a // b)  # noqa: E731
    ctas, per = (1, 4) if T <= 4096 else (ceil(T, 8192), 8)
    return ctas, 32 * ceil(ceil(ceil(T, ctas), per), 32), per


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
    "lags_select_launch": ([_P] * 7 + [_I] * 6 + [_F] * 4 + [_P], _I),
    "lags_select_max_clusters": ([], _I),
    "lags_select_empty_launch": ([_P], _I),
}


def _library():
    """The kernel's library; at first load, raise if the card cannot hold
    one cluster of the largest launch (8 CTAs of 1024 threads)."""
    global _checked_occupancy
    lib = _build.library("lags_select", _SIGNATURES)
    if not _checked_occupancy:
        n = lib.lags_select_max_clusters()
        if n < 0:
            _build.check_status("lags_select occupancy query", -n)
        if n == 0:
            raise RuntimeError("lags_select: the card cannot hold a cluster "
                               "of 8 CTAs of 1024 threads")
        _checked_occupancy = True
    return lib


def empty_launch(device) -> None:
    """Launch an empty kernel: the floor of one launch, for timing only."""
    _build.check_status("lags_select empty kernel",
                        _library().lags_select_empty_launch(
                            _build.stream_ptr(torch.device(device))))


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
    check_domain(T, k)
    lib = _library()
    new_load = torch.empty_like(load_avg)
    new_credit = torch.empty_like(credit)
    picked = torch.empty(k, dtype=torch.int32, device=dev)
    ctas, threads, per = plan(T)
    vec = (all(t.data_ptr() % 16 == 0 for t in (load_avg, credit, running_frac,
                                                new_load, new_credit))
           and runnable.data_ptr() % per == 0)
    y, omy, alpha, oma = coefficients(window, halflife)
    status = lib.lags_select_launch(
        load_avg.data_ptr(), credit.data_ptr(), running_frac.data_ptr(),
        runnable.data_ptr(), new_load.data_ptr(), new_credit.data_ptr(),
        picked.data_ptr(), T, k, ctas, threads, per, int(vec), y, omy, alpha,
        oma, _build.stream_ptr(dev))
    _build.check_status("lags_select", status)
    launches += 1
    return new_load, new_credit, picked
