"""Back-compat shim: the policy core moved to ``repro_torch.sched``.

CFS, EEVDF, SCHED_RR, CFS-LAGS and CFS-LAGS-static are defined once in
the unified scheduling package — ``repro_torch.sched.protocol`` for the spec
registry and shared preemption rule, ``repro_torch.sched.numpy_backend`` for
the float64 reference backend this module used to implement.  Import
from ``repro_torch.sched`` in new code; this module only preserves the old
import path for existing consumers.

Copy of ``repro.core.policies``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from repro_torch.sched.numpy_backend import (  # noqa: F401
    CFS_DEFAULT_SLICE_TICKS,
    TUNED_SLICE_TICKS,
    Policy,
    make_policy,
)

__all__ = [
    "CFS_DEFAULT_SLICE_TICKS", "TUNED_SLICE_TICKS", "Policy", "make_policy",
]
