"""PyTorch backend of the scheduling-policy protocol.

Tensor mirrors of ``numpy_backend.primary_key`` plus the per-policy
voluntary switch-cost model, consumed by ``core.simkernel_torch`` so that
**all** policy kinds — CFS, EEVDF, SCHED_RR, CFS-LAGS, CFS-LAGS-static
(and the tuned-slice variants) — run in its tick loop, on the card or the
CPU.  Policy codes are plain Python ints, so dispatch is plain Python on
the code: the tick body holds no tensor branches.

Every tensor of a :class:`PolicyView` may carry a leading node dimension
N: entity arrays are (T,) or (N, T), group arrays (G,) or (N, G), and the
reductions over entities or groups are taken per node.  ``is_rt_group``
may stay (G,) when every node shares it.

Secondary tie-break in this backend: the slot id (added as ``idx * eps``
by the simulator); the numpy backend uses thread-vruntime rank instead.

Port of ``repro.sched.jax_backend``: the codes, ``spec_of``,
``PolicyView``, ``primary_key``, ``sticky_mask``, ``voluntary_switch`` and
``key_fn`` compute the same f32 functions.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core.xla_f32 import fma
from repro_torch.sched.protocol import (
    CREDIT_EPS,
    EEVDF_INELIGIBLE,
    RT_BASE,
    PolicySpec,
    spec as get_spec,
)

# Policy codes.  CFS/LAGS keep their historical values from the two-policy
# simulator; the values equal the reference's.
CFS, LAGS, EEVDF, RR, LAGS_STATIC, CFS_TUNED, EEVDF_TUNED = range(7)

CODE_OF = {
    "cfs": CFS, "lags": LAGS, "eevdf": EEVDF, "rr": RR,
    "lags-static": LAGS_STATIC, "cfs-tuned": CFS_TUNED,
    "eevdf-tuned": EEVDF_TUNED,
}
NAME_OF = {v: k for k, v in CODE_OF.items()}

_F32_085 = float(np.float32(0.85))


def spec_of(code: int, **overrides) -> PolicySpec:
    return get_spec(NAME_OF[code], **overrides)


class PolicyView(NamedTuple):
    """Per-tick scheduling state handed to the key functions.

    Entity-level tensors are ([N,] T) over request slots; group-level
    tensors are ([N,] G) over function/tenant cgroups, gathered through
    ``ent_group`` (int64).
    """

    ent_group: torch.Tensor  # ([N,] T) int64
    group_vrt: torch.Tensor  # ([N,] G)
    group_credit: torch.Tensor  # ([N,] G)
    last_pick_tick: torch.Tensor  # ([N,] T)
    runnable: torch.Tensor  # ([N,] T) bool
    group_runnable: torch.Tensor  # ([N,] G) bool
    is_rt_group: torch.Tensor  # (G,) or (N, G) bool
    tick_sec: float  # python scalar
    slice_ticks: int  # python scalar


def _by_entity(group_arr: torch.Tensor, ent_group: torch.Tensor
              ) -> torch.Tensor:
    """``group_arr[..., ent_group]`` node by node: a (G,) array is shared by
    every node, an (N, G) one is gathered along its last dimension."""
    if group_arr.dim() == 1:
        return torch.take(group_arr, ent_group)
    return torch.gather(group_arr, -1, ent_group.expand(
        *group_arr.shape[:-1], ent_group.shape[-1]))


def primary_key(code: int, v: PolicyView) -> torch.Tensor:
    """([N,] T) primary key, lower runs first — mirror of numpy_backend."""
    g = v.ent_group
    if code == LAGS:
        return _by_entity(v.group_credit, g)
    if code == RR:
        return v.last_pick_tick.to(torch.float32)
    if code == LAGS_STATIC:
        is_rt = _by_entity(v.is_rt_group, g)
        return torch.where(is_rt, RT_BASE + v.last_pick_tick,
                           _by_entity(v.group_vrt, g))
    if code in (EEVDF, EEVDF_TUNED):
        vrt = _by_entity(v.group_vrt, g)
        n_run = v.group_runnable.sum(-1, keepdim=True).clamp_min(1)
        vmean = torch.where(v.group_runnable, v.group_vrt, 0.0).sum(
            -1, keepdim=True) / n_run
        deadline = vrt + v.slice_ticks * v.tick_sec
        inel = (vrt > vmean + CREDIT_EPS).to(vrt.dtype)
        return inel * EEVDF_INELIGIBLE + deadline
    # CFS / CFS_TUNED
    return _by_entity(v.group_vrt, g)


def sticky_mask(code: int, v: PolicyView, continuing: torch.Tensor
                ) -> torch.Tensor:
    """Which slice-holding slots keep their core this tick.

    ``continuing`` = picked last tick, slice not expired, still runnable.
    Credit preemption (LAGS) and RT wakeups (LAGS-static) break slices:
    a strictly lighter waiting group / a waiting RT task voids stickiness
    so the top-k pick can reclaim the core — the same rules the numpy
    backend applies in ``Policy.preempt_cores``.
    """
    if code == LAGS:
        waiting = v.runnable & ~continuing
        credit = _by_entity(v.group_credit, v.ent_group)
        wait_cmin = torch.where(waiting, credit, torch.inf).amin(
            -1, keepdim=True)
        lighter_waits = credit > wait_cmin + CREDIT_EPS
        return continuing & ~lighter_waits
    if code == LAGS_STATIC:
        is_rt = _by_entity(v.is_rt_group, v.ent_group)
        rt_waiting = (v.runnable & ~continuing & is_rt).any(-1, keepdim=True)
        return continuing & (is_rt | ~rt_waiting)
    # CFS/EEVDF slices are one tick by default; tuned variants and RR hold
    # the full quantum (wakeup preemption is folded into the burst model).
    return continuing


def voluntary_switch(code: int, *, c_same, c_cross, cost_cfs, run_credit,
                     wait_cmin, sibs, p_preempt
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-policy voluntary handoff cost + switches-per-burst multiplier.

    Mirror of ``numpy_backend.Policy.voluntary_switch``: under
    run-to-completion (LAGS kinds) cores serving in credit order hand off
    within the group, a sole runnable sibling is re-picked switch-free,
    and credit-based wakeup preemption fires less often than CFS's.
    """
    if code in (LAGS, LAGS_STATIC):
        in_order = run_credit <= wait_cmin + CREDIT_EPS
        solo = sibs <= 1.0
        cost = torch.where(in_order & solo, 0.0,
                           torch.where(in_order, c_same, cost_cfs))
        # 1 + 0.85 * p_preempt, one rounding as the compiled reference has it
        return cost, fma(p_preempt, _F32_085, 1.0)
    return cost_cfs, 1.0 + p_preempt


def key_fn(code: int) -> Callable[[PolicyView], torch.Tensor]:
    if code not in NAME_OF:
        raise ValueError(f"unknown policy code {code!r}")
    return lambda v: primary_key(code, v)
