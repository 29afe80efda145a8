"""Admission entry points for the continuous-batching engine.

Thin facade over the unified policy core: the actual admission policies
(``fifo`` / ``fair`` / ``lags``) live in ``repro_torch.sched.serving`` and are
resolved by registry lookup — no policy-specific branching here.  The
LAGS credit ordering and hysteresis preemption are the same protocol
rules the node simulators use (``repro_torch.sched.protocol.credit_preempt``);
the hysteresis is a caller-supplied config value
(``EngineConfig.preempt_hysteresis``), not a constant.

Copy of ``repro.scheduler.admission``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.obs import metrics as obs_metrics
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.sched.serving import admission_policy

#: engine default: demand a clear credit gap before paying a membership
#: change (an engine batch re-formation is far costlier than a kernel
#: task switch, so the engine is more reluctant than the node's 1.0)
DEFAULT_PREEMPT_HYSTERESIS = 0.5


def pick_admissions(
    policy: str,
    tenants: Dict[int, Tenant],
    free_slots: int,
    running_tenants: set,
) -> List[Request]:
    """Choose queued requests to admit into the free batch slots."""
    out = admission_policy(policy).pick(tenants, free_slots, running_tenants)
    if out:
        obs_metrics.counter(f"admission.{policy}.admitted").inc(len(out))
    return out


def should_preempt(
    policy: str,
    tenants: Dict[int, Tenant],
    running_tenants: set,
    hysteresis: float = DEFAULT_PREEMPT_HYSTERESIS,
) -> Tuple[bool, int]:
    """LAGS global path: a waiting tenant lighter than a running one (by
    more than the hysteresis gap) may claim a slot
    (returns (True, victim_tid))."""
    fire, victim = admission_policy(policy).preempt(
        tenants, running_tenants, hysteresis
    )
    if fire:
        obs_metrics.counter(f"admission.{policy}.preemptions").inc()
    return fire, victim
