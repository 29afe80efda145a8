"""Arrival synthesis for the serving driver.

Port of ``repro.core.traces``, trimmed to ``_mmpp_arrivals``: the serving
driver is its only user in this package.  The body is a copy.
"""
from __future__ import annotations

import numpy as np


def _mmpp_arrivals(rate, duration, rng, burst_on=1.5, burst_off=10.0):
    """Markov-modulated Poisson: ON (bursty) / OFF periods, mean ``rate``."""
    if rate <= 0:
        return np.empty(0)
    frac_on = burst_on / (burst_on + burst_off)
    on_rate = rate / frac_on
    out = []
    t = 0.0
    on = rng.uniform() < frac_on
    while t < duration:
        seg = rng.exponential(burst_on if on else burst_off)
        seg = min(seg, duration - t)
        if on and on_rate > 0:
            n = rng.poisson(on_rate * seg)
            out.append(t + np.sort(rng.uniform(0, seg, n)))
        t += seg
        on = not on
    return np.concatenate(out) if out else np.empty(0)
