"""The Load Credit metric (paper §4.2, Appendix A.2).

Load Credit is tracked per cgroup (= serverless function = serving tenant):

  1. PELT-style load average: geometric decay with a 32 ms half-life
     (Linux's ``tg->load_avg``), updated every scheduler tick with the
     fraction of CPU the group consumed during that tick.
  2. Load Credit = exponential moving average of the PELT load over a much
     larger window (``tg_load_avg_ema_window`` ticks; paper Fig 6 best value
     1000 ticks = 4 s at CONFIG_HZ=250) — Linux's new ``tg->load_avg_ema``.

CFS-LAGS orders group scheduling entities by *ascending* Load Credit: the
group that has consumed the least CPU recently runs first and keeps running
until a lighter group wakes (Least-Attained-Service over the credit window).

A numpy implementation (the serving engine's control plane) and a PyTorch
one (``torch_tick``, the counterpart of the reference's ``jax_tick``) are
provided; they are bit-identical in float64 and allclose in float32.

Port of ``repro.core.load_credit``: the constants, ``pelt_update``,
``ema_update`` and ``LoadCreditTracker`` are copied; ``torch_tick`` replaces
``jax_tick``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TICK_SEC = 0.004  # CONFIG_HZ = 250
PELT_HALFLIFE_TICKS = 8  # 32 ms
DEFAULT_EMA_WINDOW = 1000  # ticks  (paper Fig 6: best latency at 1000)


def pelt_decay(halflife_ticks: int = PELT_HALFLIFE_TICKS) -> float:
    return 0.5 ** (1.0 / halflife_ticks)


def pelt_update(load_avg, running_frac, y: float | None = None):
    """One tick of PELT: load <- y*load + (1-y)*running_frac.

    running_frac: fraction of one CPU the group consumed this tick (can
    exceed 1.0 on multicore — Linux sums per-CPU contributions).
    """
    y = pelt_decay() if y is None else y
    return y * load_avg + (1.0 - y) * running_frac


def ema_update(ema, load_avg, window_ticks: int = DEFAULT_EMA_WINDOW):
    """One tick of the Load Credit EMA (tg->load_avg_ema)."""
    alpha = 2.0 / (window_ticks + 1.0)
    return (1.0 - alpha) * ema + alpha * load_avg


@dataclass
class LoadCreditTracker:
    """Vectorised Load Credit state over ``n_groups`` cgroups."""

    n_groups: int
    window_ticks: int = DEFAULT_EMA_WINDOW
    pelt_halflife: int = PELT_HALFLIFE_TICKS

    def __post_init__(self):
        self.load_avg = np.zeros(self.n_groups)
        self.credit = np.zeros(self.n_groups)
        self._y = pelt_decay(self.pelt_halflife)

    def tick(self, running_frac: np.ndarray) -> np.ndarray:
        """Advance one tick given per-group CPU consumption; returns credit."""
        self.load_avg = pelt_update(self.load_avg, running_frac, self._y)
        self.credit = ema_update(self.credit, self.load_avg, self.window_ticks)
        return self.credit


# --- PyTorch mirror -----------------------------------------------------------


def torch_tick(state, running_frac, window_ticks: int = DEFAULT_EMA_WINDOW,
               halflife: int = PELT_HALFLIFE_TICKS):
    """state = (load_avg, credit) tensors; one functional tick.

    The same expression as ``jax_tick``: each product and sum is a separate
    op in the tensors' dtype, with the coefficients as Python floats.
    """
    load_avg, credit = state
    y = 0.5 ** (1.0 / halflife)
    alpha = 2.0 / (window_ticks + 1.0)
    load_avg = y * load_avg + (1.0 - y) * running_frac
    credit = (1.0 - alpha) * credit + alpha * load_avg
    return (load_avg, credit), credit
