"""Admission-policy backends for the continuous-batching serving engine.

The engine's "context switch" is a batch-membership change; these policies
decide which queued requests claim free batch slots and when a waiting
tenant may evict a running one.  The LAGS credit ordering and hysteresis
preemption here are the *same protocol rules* the node simulators use
(``protocol.credit_preempt``; ascending Load Credit, run-to-completion) —
previously ``scheduler/admission.py`` carried its own copy with a magic
0.5 constant, now a config field (``EngineConfig.preempt_hysteresis``).

``scheduler.admission`` keeps the stable entry points and delegates here
via :func:`admission_policy` (registry lookup, no string dispatch in the
consumer).

Copy of ``repro.sched.serving``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.sched.protocol import credit_preempt


class AdmissionPolicy:
    """Protocol: order waiting tenants, fill slots, decide preemption."""

    name = "base"
    #: drain a chosen tenant's whole queue before moving on (LAGS
    #: run-to-completion) instead of admitting round-robin
    drain = False

    def order(self, waiting: List) -> List:
        raise NotImplementedError

    def pick(self, tenants: Dict[int, object], free_slots: int,
             running_tenants: set) -> List:
        """Choose queued requests to admit into the free batch slots."""
        waiting = [t for t in tenants.values() if t.queue]
        if not waiting or free_slots <= 0:
            return []
        order = self.order(waiting)
        out: List = []
        if self.drain:
            for t in order:
                while t.queue and len(out) < free_slots:
                    out.append(t.queue.popleft())
                if len(out) >= free_slots:
                    break
        else:
            # round-robin one per tenant until slots exhausted
            while len(out) < free_slots:
                progressed = False
                for t in order:
                    if t.queue and len(out) < free_slots:
                        out.append(t.queue.popleft())
                        progressed = True
                if not progressed:
                    break
        return out

    def preempt(self, tenants: Dict[int, object], running_tenants: set,
                hysteresis: float) -> Tuple[bool, int]:
        return False, -1


class FifoAdmission(AdmissionPolicy):
    """Arrival order, no tenant-awareness (baseline)."""

    name = "fifo"

    def pick(self, tenants, free_slots, running_tenants):
        waiting = [t for t in tenants.values() if t.queue]
        if not waiting or free_slots <= 0:
            return []
        reqs = sorted((t.queue[0] for t in waiting), key=lambda r: r.arrival)
        out = []
        for r in reqs[:free_slots]:
            tenants[r.tenant].queue.popleft()
            out.append(r)
        return out


class FairAdmission(AdmissionPolicy):
    """CFS analogue: least-recently-admitted round robin — maximal
    fairness, maximal batch churn."""

    name = "fair"

    def order(self, waiting):
        return sorted(waiting, key=lambda t: (t.last_admit, t.tid))


class LagsAdmission(AdmissionPolicy):
    """The paper's policy: lowest Load Credit first, run-to-completion.

    Admit the lightest-credit tenant and drain its queue before moving on;
    evict a running tenant only on a clear credit gap (hysteresis), else
    keep running to completion over the credit window.  Fewer membership
    changes -> fewer engine context switches (weight swaps, page churn,
    re-dispatch).
    """

    name = "lags"
    drain = True

    def order(self, waiting):
        return sorted(waiting, key=lambda t: (t.credit, t.tid))

    def preempt(self, tenants, running_tenants, hysteresis):
        """LAGS global path: a waiting tenant lighter than a running one
        (by more than the hysteresis gap) may claim a slot."""
        waiting = [t for t in tenants.values() if t.queue]
        if not waiting or not running_tenants:
            return False, -1
        lightest_wait = min(waiting, key=lambda t: (t.credit, t.tid))
        heaviest_run = max(
            (tenants[tid] for tid in running_tenants),
            key=lambda t: (t.credit, -t.tid),
        )
        if credit_preempt(lightest_wait.credit, heaviest_run.credit,
                          hysteresis):
            return True, heaviest_run.tid
        return False, -1


ADMISSION: Dict[str, AdmissionPolicy] = {
    p.name: p for p in (FifoAdmission(), FairAdmission(), LagsAdmission())
}


def admission_policy(name: str) -> AdmissionPolicy:
    try:
        return ADMISSION[name]
    except KeyError:
        raise ValueError(f"unknown admission policy {name!r}") from None
