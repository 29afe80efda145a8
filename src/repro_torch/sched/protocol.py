"""The unified scheduling-policy protocol (paper §4, one definition).

Every scheduler in this repo — the numpy tick simulator, the exact DES
oracle, the ``lax.scan`` cluster simulator and the serving engine's
admission scheduler — used to carry its own copy of the policy logic.
This module is the single source of truth they now share.

A *policy* is described by a :class:`PolicySpec` and consists of:

  * per-entity state arrays owned by the caller (group vruntime, Load
    Credit, last-pick time, runnable/running masks);
  * a composite **key** — lower runs first — whose *primary* component is
    defined once per policy kind (see the backend modules; each backend may
    add its own deterministic secondary tie-break);
  * a **slice length** in scheduler ticks (how long a picked entity keeps
    its core / batch slot);
  * a **preemption rule** — for credit-based policies the shared
    :func:`credit_preempt` hysteresis comparison.

Backends in this package:

  * ``repro_torch.sched.numpy_backend`` — the float64 reference ``Policy``
    used by ``core.simkernel`` (absorbed ``core.policies``);
  * ``repro_torch.sched.torch_backend`` — tensor key / voluntary-cost
    functions driving ``core.simkernel_torch`` for **all** policy kinds;
  * ``repro_torch.sched.cuda_backend`` — the fused Load-Credit tick +
    k-lowest-credit selection CUDA kernel (``kernels.lags_select``) behind
    the serving engine's admission path at high tenant counts;
  * ``repro_torch.sched.serving``       — admission-policy registry (fifo /
    fair / lags) for the continuous-batching engine.

``tests/test_sched_backends.py`` is the reference's cross-backend gate:
numpy, JAX and Pallas must agree on scheduling decisions (identical
picked / preempted sets) on randomized small cases.

Copy of ``repro.sched.protocol``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

from repro_torch.core.load_credit import DEFAULT_EMA_WINDOW

# scheduler tick = 4 ms (CONFIG_HZ = 250)
CFS_DEFAULT_SLICE_TICKS = 1  # min_granularity ~3 ms -> 1 tick under load
TUNED_SLICE_TICKS = 25  # 100 ms (fig 11 "tuned" baselines / SCHED_RR quantum)

# Policy kinds: the primary-key families.
KINDS = ("cfs", "eevdf", "rr", "lags", "lags-static")

# Key-composition constants shared by every backend.  RT entities sort at
# RT_BASE + last-pick-tick: far below any CFS vruntime, FIFO within RT.
RT_BASE = -1e7
# EEVDF: ineligible entities (vruntime ahead of the runnable mean) sort
# after every eligible one by this offset on the primary key.  Kept small
# enough (>> any virtual deadline in seconds, << 1e6) that the composite
# key primary*1e9 + rank still resolves the secondary tie-break in
# float64 — the old 1e15-scale offset quantized it away at the ulp.
EEVDF_INELIGIBLE = 1e4
# Strict-inequality slack for credit comparisons (float noise guard).
CREDIT_EPS = 1e-12


@dataclass(frozen=True)
class PolicySpec:
    """Declarative policy description consumed by every backend."""

    name: str
    kind: str  # one of KINDS
    slice_ticks: int = CFS_DEFAULT_SLICE_TICKS
    credit_window: int = DEFAULT_EMA_WINDOW
    # LAGS preemption hysteresis: a waiting group preempts a running one
    # only when wait_credit < hysteresis * run_credit.  The node simulators
    # use 1.0 (paper §4.3 global path: any strictly lighter waker wins);
    # the serving engine defaults to 0.5 (EngineConfig.preempt_hysteresis)
    # because an engine membership change is far costlier than a kernel
    # task switch, so it demands a clear credit gap.
    preempt_hysteresis: float = 1.0
    # lags-static: function/tenant ids pinned under SCHED_RR priority
    static_rt_fns: Optional[Tuple[int, ...]] = None

    def with_overrides(self, **kw) -> "PolicySpec":
        return replace(self, **kw)


_REGISTRY: Dict[str, PolicySpec] = {}


def register(spec: PolicySpec) -> PolicySpec:
    if spec.kind not in KINDS:
        raise ValueError(f"unknown policy kind {spec.kind!r}")
    _REGISTRY[spec.name] = spec
    return spec


def spec(name: str, **overrides) -> PolicySpec:
    """Registry lookup (the former string dispatch, in one place)."""
    try:
        base = _REGISTRY[name.lower()]
    except KeyError:
        raise ValueError(f"unknown policy {name!r}") from None
    return base.with_overrides(**overrides) if overrides else base


def names() -> Tuple[str, ...]:
    return tuple(_REGISTRY)


register(PolicySpec("cfs", "cfs"))
register(PolicySpec("cfs-tuned", "cfs", slice_ticks=TUNED_SLICE_TICKS))
register(PolicySpec("eevdf", "eevdf"))
register(PolicySpec("eevdf-tuned", "eevdf", slice_ticks=TUNED_SLICE_TICKS))
register(PolicySpec("rr", "rr", slice_ticks=TUNED_SLICE_TICKS))
register(PolicySpec("lags", "lags"))
register(PolicySpec("lags-static", "lags-static",
                    slice_ticks=TUNED_SLICE_TICKS))


def credit_preempt(wait_min_credit: float, run_max_credit: float,
                   hysteresis: float) -> bool:
    """The one LAGS preemption rule (paper §4.3 global path).

    A waking entity of the lightest waiting group claims a core/slot held
    by the heaviest running group iff its credit is below
    ``hysteresis * run_max_credit`` by more than float noise.  Hysteresis
    1.0 = preempt on any strictly lighter waiter (node scheduler);
    < 1.0 = demand a clear gap before paying a membership change (engine).
    """
    return wait_min_credit < hysteresis * run_max_credit - CREDIT_EPS
