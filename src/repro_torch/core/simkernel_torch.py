"""Tensor tick simulator: the paper's scheduler as a PyTorch module.

A tensor port of ``simkernel`` that runs on the card (or the CPU, when the
caller asks for it).  The tick loop is a Python loop over the ticks; every
tick is a fixed sequence of tensor ops with no host synchronisation, so
the host only issues work.  The state carries a leading node dimension N,
so the fleet layer runs every node of a configuration in one loop (see
``repro_torch.fleet.simulate``); one node is N = 1.

Policy logic lives entirely in ``repro_torch.sched.torch_backend``: the
policy code in :class:`SimParams` is a Python int resolved to key /
stickiness / voluntary-cost functions, so **every** policy kind — CFS,
EEVDF, SCHED_RR, CFS-LAGS, CFS-LAGS-static and the tuned-slice variants —
runs through this one tick body with no policy branching here.

Modelling simplifications vs the numpy engine (validated against it in
``tests/test_torch_simkernel.py``): requests are pre-assigned round-robin
to a fixed per-function slot pool (FIFO within a slot), core assignment is
a per-tick top-C selection with slice stickiness (sticky-core switch
accounting is statistical, as in the numpy engine's burst model).

Port of ``repro.core.simkernel_jax``.  Where the reference's f32 result
rests on an operation whose tensor counterpart is defined differently, the
port writes the reference's rule out:

  * the pick takes the C lowest keys, ties to the lower slot (``lax.top_k``
    does so; ``torch.topk`` does not promise it), through a stable sort;
  * the picked-slot mask copies the reference's scatter, whose last write
    wins: where fewer than C slots are picked, the trailing entries write
    False into slot 0, so slot 0 is unpicked even when it was picked;
  * a slot past its last request gathers a sentinel column of
    never-arriving requests (the reference gathers a fill value and masks
    it with ``ptr < R``);
  * the f32 arithmetic is the reference's as XLA compiles it for the CPU
    (read in its optimized HLO and LLVM IR; see ``core.xla_f32``):
    constants are folded (a division by a constant is a product with its
    f32 reciprocal, ``PUT_US * log2(x)`` is ``log(x) * f32(PUT_US / ln 2)``,
    ``BASE_US + leaf + SET_US * depth`` is ``leaf + f32(BASE_US + SET_US *
    depth)``, ``cost * 1e-6 * spb`` is ``cost * (spb * 1e-6)``), products
    feeding an add are fused multiply-adds, ``log`` is XLA's, and the
    vruntime sum adds into ``vrt_fn`` itself.  Written the way the Python
    source reads instead, the last bits differ and move completions (Fig. 7
    at 10 nodes moves its p95).  The same expressions run on the card and
    the CPU;
  * XLA's CPU code flushes subnormal f32 results to zero; the PELT load
    of a group idle for about 1000 ticks decays below the smallest normal
    f32, so the load and the credit are flushed after each update (both
    are non-negative), on the card as on the CPU;
  * the per-group sums use ``scatter_add_``: the values summed into one
    group are equal (or zero), so the order of the adds does not change
    the sum.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import load_credit as lc
from repro_torch.core import xla_f32
from repro_torch.core.xla_f32 import fma
from repro_torch.core.switch_cost import BASE_US, CROSS_US, PUT_US, SET_US
from repro_torch.device import resolve
from repro_torch.sched import torch_backend as tb

TICK = lc.TICK_SEC
BIG = np.iinfo(np.int32).max // 2  # arrival tick of a padding request
TINY = float(np.finfo(np.float32).tiny)  # 2**-126, the smallest normal f32

# historical two-policy codes; the full set lives in torch_backend
CFS, LAGS = tb.CFS, tb.LAGS


class SlotTrace(NamedTuple):
    """Per-slot request queues, preassigned (see module docstring).

    Shapes as below, or with a leading node dimension N for a fleet.
    """

    arrival_tick: torch.Tensor  # (T, R) int32, padded with BIG
    demand: torch.Tensor  # (T, R) float32 seconds
    slot_fn: torch.Tensor  # (T,) int32


class SimParams(NamedTuple):
    n_cores: int
    n_fns: int
    n_ticks: int
    policy: int = CFS  # repro_torch.sched.torch_backend code
    burst_us: float = 120.0
    depth: float = 2.0
    window_ticks: int = 1000
    rt_fns: Tuple[int, ...] = ()  # lags-static: fn ids under SCHED_RR


def flush(x: torch.Tensor) -> torch.Tensor:
    """Non-negative ``x`` with its subnormal values flushed to zero."""
    return x.masked_fill(x < TINY, 0.0)


def _recip(c: float) -> float:
    """The f32 reciprocal of ``c``, exact as a Python float."""
    return float(np.float32(1.0) / np.float32(c))


def _f32(v: float) -> float:
    return float(np.float32(v))


INV_TICK = _recip(TICK)
# PUT_US * log2(x) as XLA folds it: log(x) times one f32 constant
K_LEAF = float(np.float32(PUT_US) * np.float32(_recip(np.log(np.float32(2)))))


def build_slot_trace(workload, n_fns: int, threads_per_fn: int,
                     device=None) -> SlotTrace:
    """Pack a ``simkernel.Workload``-style arrival list into fixed slots,
    on ``device`` (``None``: the card)."""
    dev = resolve(device)
    per_slot: list = [[] for _ in range(n_fns * threads_per_fn)]
    for f in range(n_fns):
        arr = workload.arrivals[f]
        dem = workload.service_s[f]
        for j, (t, d) in enumerate(zip(arr, dem)):
            slot = f * threads_per_fn + (j % threads_per_fn)
            per_slot[slot].append((int(t / TICK), float(d)))
    R = max(1, max(len(q) for q in per_slot))
    T = len(per_slot)
    at = np.full((T, R), BIG, np.int32)
    de = np.zeros((T, R), np.float32)
    for s, q in enumerate(per_slot):
        for j, (t, d) in enumerate(q):
            at[s, j] = t
            de[s, j] = d
    slot_fn = np.repeat(np.arange(n_fns, dtype=np.int32), threads_per_fn)
    return SlotTrace(*(torch.from_numpy(a).to(dev) for a in (at, de, slot_fn)))


def pick(key: torch.Tensor, C: int):
    """The C lowest finite keys of each node's (N, T) ``key``, ties to the
    lower slot, as ``lax.top_k(-key, C)`` orders them.

    Returns ``run_slot`` (N, C): the picked slots in key order, 0 where an
    entry is unpicked (``key`` +inf); ``picked`` (N, C) bool; and
    ``picked_slot`` (N, T) bool, the reference's scatter of ``picked`` at
    ``run_slot``, whose last write wins: each unpicked entry writes False
    into slot 0 after the picks, so slot 0 reads unpicked whenever fewer
    than C slots are picked.
    """
    low, order = torch.sort(key, dim=-1, stable=True)
    idx = order[:, :C]
    picked = torch.isfinite(low[:, :C])
    picked_slot = torch.zeros_like(key, dtype=torch.bool).scatter_(
        1, idx, picked)
    picked_slot[:, 0] &= picked.all(-1)
    return torch.where(picked, idx, 0), picked, picked_slot


@torch.inference_mode()
def simulate(trace: SlotTrace, p: SimParams):
    """Returns dict of per-request completion ticks + node-level counters
    (and the final per-group ``load`` and ``credit``), on the trace's
    device.  A trace with a leading node dimension runs
    every node in one loop and returns results with that dimension."""
    batched = trace.arrival_tick.dim() == 3
    at, de, slot_fn = (x if batched else x[None] for x in trace)
    N, T, R = at.shape
    C, G = p.n_cores, p.n_fns
    if C > T:
        raise ValueError(f"{C} cores for {T} slots: top-C needs C <= T")
    dev = at.device
    f32 = torch.float32
    slot_fn = slot_fn.long()
    code = p.policy
    slice_ticks = tb.spec_of(code).slice_ticks
    is_rt_fn = torch.zeros(G, dtype=torch.bool, device=dev)
    if p.rt_fns:
        is_rt_fn[torch.tensor(p.rt_fns, device=dev)] = True
    tie = torch.arange(T, dtype=f32, device=dev) * 1e-12
    burst = p.burst_us * 1e-6
    burst32 = _f32(burst)
    work_tick = torch.tensor(TICK * burst, dtype=f32, device=dev)
    inv_2c = _recip(2.0 * C)
    k_upper = _f32(K_LEAF * max(p.depth - 1.0, 1.0))
    k_same = float(np.float32(BASE_US) + np.float32(SET_US * p.depth))
    # the switch costs (``core.switch_cost``) of a count k <= T of runnable
    # siblings or groups: the same-group cost and the cross-group term
    log_k = xla_f32.log(1 + np.maximum(np.arange(T + 1, dtype=np.float32), 1))
    c_same_of = torch.from_numpy(
        xla_f32.fma_np(log_k, K_LEAF, k_same)).to(dev)
    upper_of = torch.from_numpy(
        xla_f32.fma_np(log_k, k_upper, CROSS_US)).to(dev)
    # the PELT and EMA coefficients of ``lc.torch_tick``
    y = 0.5 ** (1.0 / lc.PELT_HALFLIFE_TICKS)
    alpha = 2.0 / (p.window_ticks + 1.0)
    y32, keep32 = _f32(y), _f32(1.0 - alpha)

    zero = torch.zeros((), dtype=f32, device=dev)
    inf = torch.full((), torch.inf, dtype=f32, device=dev)
    at = torch.cat([at, at.new_full((N, T, 1), BIG)], 2)
    de = torch.cat([de, de.new_zeros((N, T, 1))], 2)

    ptr = torch.zeros(N, T, 1, dtype=torch.int64, device=dev)
    rem = torch.zeros(N, T, dtype=f32, device=dev)
    vrt_fn = torch.zeros(N, G, dtype=f32, device=dev)
    load = torch.zeros(N, G, dtype=f32, device=dev)
    credit = torch.zeros(N, G, dtype=f32, device=dev)
    busy = torch.zeros(N, dtype=f32, device=dev)
    ovh = torch.zeros(N, dtype=f32, device=dev)
    done = torch.full((N, T, R + 1), -1, dtype=torch.int64, device=dev)
    last_pick = torch.zeros(N, T, dtype=f32, device=dev)
    slice_left = torch.zeros(N, T, dtype=torch.int64, device=dev)
    prev_picked = torch.zeros(N, T, dtype=torch.bool, device=dev)

    for tick in range(p.n_ticks):
        # activate: slot idle (rem<=0, i.e. between requests) whose next
        # request has arrived
        next_arr = at.gather(2, ptr).squeeze(-1)
        can_start = (rem <= 0.0) & (next_arr <= tick)
        rem = torch.where(can_start, de.gather(2, ptr).squeeze(-1), rem)
        runnable = rem > 0.0

        # group stats (shared mechanism, not policy)
        sib_count = torch.zeros(N, G, dtype=f32, device=dev).scatter_add_(
            1, slot_fn, runnable.to(f32))
        fn_runnable = sib_count > 0

        # policy key via the protocol backend; deterministic tie-break by
        # slot id is this backend's secondary
        view = tb.PolicyView(
            ent_group=slot_fn, group_vrt=vrt_fn, group_credit=credit,
            last_pick_tick=last_pick, runnable=runnable,
            group_runnable=fn_runnable, is_rt_group=is_rt_fn,
            tick_sec=TICK, slice_ticks=slice_ticks,
        )
        key = torch.where(runnable, tb.primary_key(code, view), inf)
        key = key + tie

        # slice stickiness: a slot that holds an unexpired slice keeps its
        # core unless the policy's preemption rule voids it
        continuing = prev_picked & (slice_left > 0) & runnable
        sticky = tb.sticky_mask(code, view, continuing)
        key = torch.where(sticky, key - 1e18, key)

        # pick C best runnable
        run_slot, picked, picked_slot = pick(key, C)

        # slice bookkeeping
        slice_left = torch.where(
            picked_slot,
            torch.where(continuing, slice_left - 1, slice_ticks - 1), 0)
        last_pick = torch.where(picked_slot, float(tick), last_pick)

        n_grp = fn_runnable.sum(-1, keepdim=True)
        n_run = runnable.sum(-1, keepdim=True, dtype=f32)

        run_fn = slot_fn.gather(1, run_slot)
        sibs = sib_count.gather(1, run_fn)
        n_wait = (n_run - picked.sum(-1, keepdim=True, dtype=f32)).clamp_min(0)
        p_pre = (n_wait * inv_2c).clamp_max(1.0)

        # switch cost of a same-group and of a cross-group switch
        c_same = torch.take(c_same_of, sibs.long())
        c_cross = c_same + torch.take(upper_of, n_grp)
        p_same_cfs = ((sibs - 1.0) / (n_run - 1.0).clamp_min(1.0)).clamp(0, 1)
        cost_cfs = fma(p_same_cfs, c_same, (1 - p_same_cfs) * c_cross)

        run_credit = credit.gather(1, run_fn)
        wait_cmin = torch.where(fn_runnable, credit, inf).amin(
            -1, keepdim=True)
        cost_us, spb = tb.voluntary_switch(
            code, c_same=c_same, c_cross=c_cross, cost_cfs=cost_cfs,
            run_credit=run_credit, wait_cmin=wait_cmin, sibs=sibs,
            p_preempt=p_pre,
        )
        den = fma(cost_us, spb * 1e-6, burst32)  # burst + cost_us * 1e-6 * spb
        eff = torch.where(picked, work_tick / den, zero)
        ovh = ovh + torch.where(picked, TICK - eff, zero).sum(-1)
        busy = busy + torch.minimum(
            eff, rem.gather(1, run_slot) * picked).sum(-1)

        # progress
        new_rem = rem - torch.zeros_like(rem).scatter_add_(1, run_slot, eff)
        completed = (rem > 0.0) & (new_rem <= 0.0)
        # record completion tick for the slot's current request (the entry
        # at ``ptr`` is -1 until its request completes)
        completed = completed.unsqueeze(-1)
        done.scatter_reduce_(2, ptr, torch.where(completed, tick, -1), "amax")
        ptr = ptr + completed
        rem = new_rem

        # load credit: ``lc.torch_tick`` with each product fused into its add,
        # and each result flushed to zero below the smallest normal f32
        frac = torch.zeros_like(credit).scatter_add_(1, run_fn, eff * INV_TICK)
        load = flush(fma(load, y32, (1.0 - y) * frac))
        credit = flush(fma(credit, keep32, alpha * load))

        # fn vruntime advances by group core-time
        vrt_fn = vrt_fn.scatter_add(1, run_fn, eff)
        prev_picked = picked_slot

    out = {"done_tick": done[..., :R].to(torch.int32), "busy_s": busy,
           "overhead_s": ovh, "credit": credit, "load": load}
    return out if batched else {k: v[0] for k, v in out.items()}


def latencies_from(trace: SlotTrace, done_tick) -> np.ndarray:
    """Completed-request latencies in seconds."""
    at = np.asarray(torch.as_tensor(trace.arrival_tick).cpu())
    dt = np.asarray(torch.as_tensor(done_tick).cpu())
    ok = (dt >= 0) & (at < BIG)
    return ((dt[ok] + 1) - at[ok]) * TICK
