"""Tenant (serving-side cgroup analogue) and request state.

A tenant is a hosted function/model variant; its Load Credit is the EMA of
*attained accelerator service* (device-seconds), updated once per engine
step — the direct analogue of ``tg->load_avg_ema`` with engine steps as
scheduler ticks (DESIGN.md §2 table).

Copy of ``repro.scheduler.tenant``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Optional

from repro_torch.core.load_credit import ema_update, pelt_update


@dataclass
class Request:
    rid: int
    tenant: int
    prompt_len: int
    max_new: int
    arrival: float
    generated: int = 0
    prefilled: bool = False
    start_time: float = -1.0
    finish_time: float = -1.0
    # graceful-degradation state (repro_torch.serving.engine): out-of-pages
    # rejections so far, the engine time before which the request is parked
    # (exponential backoff), and whether overload shedding already halved
    # its ``max_new`` (truncation is applied at most once per request)
    rejections: int = 0
    backoff_until: float = 0.0
    truncated: bool = False

    @property
    def done(self) -> bool:
        return self.generated >= self.max_new

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival if self.finish_time >= 0 else -1.0


@dataclass
class Tenant:
    tid: int
    name: str = ""
    weight_mb: float = 64.0  # adapter/weight bytes swapped in on admission
    queue: Deque[Request] = field(default_factory=deque)
    load_avg: float = 0.0
    credit: float = 0.0
    resident: bool = False  # weights currently on device
    served_s: float = 0.0
    last_admit: float = -1.0  # round-robin pointer for the fair policy

    def tick(self, service_s: float, step_s: float, window: int = 256):
        """Update Load Credit with this step's attained service."""
        frac = service_s / max(step_s, 1e-9)
        self.load_avg = pelt_update(self.load_avg, frac)
        self.credit = ema_update(self.credit, self.load_avg, window)
        self.served_s += service_s
