#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` only (no JAX, nothing of ``repro``):

1. card: name and power limit from ``nvidia-smi``;
2. build: the eight CUDA sources from ``src/repro_torch/kernels/csrc``, in
   parallel, with the compiler's register, shared memory and spill report
   for each kernel;
3. ``lags_select`` against its plain PyTorch version: random cases at T
   from 1 to 65536 (CTA edges 1023, 1025, 8193 among them) with k=16, k > T,
   (2048, 2048) and (65536, 1024); few runnable tenants, none runnable, all
   credits equal (ties across the cluster's CTAs at T=65536), and credits
   below 1e-4 where the key's lane term decides the order.  Picks must be
   equal and the state bit-equal.  One call is one kernel under the
   profiler, and its only allocations are its three outputs;
4. ``decode_attention`` against its plain version: the reference's test
   shapes at G=1, the engine's shape B=16, H=32, Hkv=8, D=128 at
   L in {512, 4096} with kv_len including L-7, and phase 9's decode shape
   B=4, L=2112 with kv_len on and beside a split's edge, read through the
   model's (B, L, Hkv, D) cache view, and there G=16 (H=64, Hkv=4) and G=7
   (H=28, Hkv=4), also through a window's view of the cache's last 1024
   rows; ``flash_attention`` at the
   reference's test shapes for (causal, 0), (causal, 128), (causal, 64) and
   (non-causal, 0), GQA cases, S=1 and ragged S read through the
   (B, S, H, D) projection view, and the Qwen3-8B prefill shape, where each
   64-row query tile of each (b, h) is also held to a relative error
   ||got - want|| / ||want||; then non-causal at D=80 (hubert), G=16, G=7
   and a window of 1024 at S=1536 (gemma3); f32 and bf16 at the
   reference's tolerances;
   ``ssm_scan`` in f32 (the type the mixer hands it) at the reference's
   shapes, with a nonzero h0, and the falcon-mamba chunk shape, at 1e-4;
5. times at the main paths' shapes: kernel, plain version, and where one
   PyTorch call computes the same function (``scaled_dot_product_attention``)
   that call as a yardstick (the port never calls it), with the least time
   the card could take (``bound_ms``), the kernel's time over the library's,
   and the kernels the library ran in its timed launches.  ``lags_select``
   at T in {1024, 4096, 65536} with k=16 and at (65536, 1024), beside an
   empty kernel's time under the same timer (``floor_ms``) and
   ``torch.topk`` on the precomputed key (selection only, tie order unset);
   ``decode_attention`` also at G=16 (B=4, H=64, Hkv=4, L=2112);
6. serving on the cost model: ``repro_torch.launch.serve.main`` at 4096
   tenants; its credit kernel launches once per busy engine step; a 300-tenant
   run on the card prints the same summary as on the CPU; the wall time per
   busy step, the host time of the engine's credit tick, and of one
   ``cuda_backend.tick_and_pick`` at T=4096 beside the kernel's device time;
7. serving with Qwen3-8B at full width and depth (36 layers, bf16, random
   weights from seed 0) on 16 slots with 1024 tenants and max_len 512: 511
   decode steps, 36 decode-attention launches each, finite logits, and the
   same scheduling as the CPU engine (first, the reduced decoder in f32 on
   the card equals the CPU's); the tick's split as in phase 6 at T=1024;
   then the ms of one decode step at the full cache, and a profile of it by
   kernel;
8. prefill of the reduced Qwen3-8B (G=2) and falcon-mamba in f32: the card
   (kernels) equals the CPU (plain versions) in logits and every cache leaf;
9. Qwen3-8B prefill at full width and depth with phase 7's weights: B=4,
   S=2048 into a cache of 2112, 36 ``flash_attention`` launches, then 64
   decode steps from that cache; ms, tokens/s, a profile by kernel, finite
   logits, and prefill(S) against prefill(S-1) + one decode step (cosine
   similarity >= 0.99);
10. falcon-mamba-7b prefill at full width and depth (64 layers, bf16, random
    weights from seed 0): B=4, S=1024 in chunks of 256, 64 x 4
    ``ssm_scan`` launches (none of its checkpoint-writing build), then 32
    decode steps, with the same numbers and checks as phase 9;
11. the tick simulator (``repro_torch.core.simkernel_torch``) at Fig. 11's
    size (120 functions x 4 threads, 12 cores, 30 s = 7500 ticks) on the
    card for all seven policy codes: completions, percentiles, busy and
    overhead equal to the JAX reference's at the same call (constants
    below), and ``lags`` and ``cfs`` also on the CPU, with completion ticks
    equal to the card's; ticks/s on the card and the CPU;
12. the Fig. 7 consolidation sweep at its two ends
    (``consolidation_sweep(total_fns=800, node_counts=(14, 10),
    backend="torch", duration_s=30.0)``; the 12-node configurations are
    left out for time), every node of a configuration in one batched tick
    loop on the card: p50 and
    p95 equal to the reference's, overhead share within rtol 1e-5,
    ``min_nodes_meeting_slo`` 14 for both policies; the 10-node LAGS fleet
    again on the CPU, with completion ticks equal to the card's; ticks/s
    of each batched loop;
13. the device's busy share over 200 ticks of one node and of the 10-node
    fleet under ``torch.profiler``; phases 11 to 13 launch none of the
    hand-written kernels (their counts stay 0);
14. the chaos layer at full size: ``simulate_fleet_chaos(backend="torch")``
    on ``benchmarks/fig_chaos_topology.py``'s consolidated LAGS fleet (800
    functions, 10 nodes in racks of 2, 60 s in 5 s epochs): the rack story
    (a trending rack drained, then crashed) and a partition on the card,
    each equal to the JAX reference's run at the same call (``REF_CHAOS``),
    and the partition again on the CPU with the card's latencies; wall
    seconds, epoch ticks/s, the controller's host time an epoch and the
    ``chaos.*`` arrival counters; no hand-written kernel launches;
15. the reduced configs of the six families registered since (qwen2-moe,
    qwen3-moe at G=16, jamba, gemma3 decoding past its window of 16,
    qwen2-vl with three different position streams, hubert) in f32: the
    card (kernels) equals the CPU (plain versions) in prefill logits, cache
    leaves and 8 decode steps; jamba layer by layer;
16. qwen2-moe-a2.7b at full width and depth (24 layers, bf16, random
    weights from seed 0): served through ``Engine.attach_model`` on 16
    slots with the LAGS credit tick (1024 tenants, 4.5 simulated seconds),
    with the CPU engine's schedule; then prefill B=4, S=2048 with the share
    of (token, k) pairs dropped at capacity, 32 decode steps with a profile
    of one, and the cosine of prefill(S) against prefill(S-64) + 64 decode
    steps, printed and not checked (capacity drops make the two different
    functions);
17. jamba-v0.1-52b at full width, its first 8 of 32 layers (one period: 1
    attention and 7 Mamba layers, 4 MoE and 4 dense MLPs): prefill B=2,
    S=2048, 32 decode steps, launch counts and finite logits;
18. qwen3-moe-235b-a22b at full width, its first 8 of 94 layers: the same,
    its decode on ``decode_attention`` at G=16;
19. gemma3-27b at full width and depth (62 layers): prefill B=2, S=1536
    past the window of 1024, 64 decode steps through the window's view, and
    the cosine check of phase 9;
20. qwen2-vl-7b at full width and depth (28 layers): prefill B=4, S=2048
    with 1024 random vision embeddings and three position streams (stream
    0 the row index, streams 1-2 a 32x32 grid over the image rows), 32
    decode steps and the cosine check;
21. hubert-xlarge at full width and depth (48 layers): the encoder forward
    at B=4, S=2048 from random frames, 48 ``fa_mma`` launches (non-causal,
    D=80), finite logits (4, 504);
22. the training kernels against their plain versions: ``flash_attention``
    with positions (``fa_mma``, ``fa_fwd``) and ``flash_attention_bwd`` at
    the reference's test shapes, GQA, windows, non-causal D=80, S=1, ragged
    S, positions with repeats and gaps, and the qwen3-8b and stablelm-1.6b
    training shapes (f32 at TOL, bf16 at TOL and at a relative error of
    1e-2 over each 64-row tile, printed in the kernels line); the wgmma
    backward (``fa_bwd_wgmma``) at D 64 and 128, causal, window 128 and
    non-causal, G 1, 2, 4, 8 and 16, S 1, 77, 300 and 2048: the forward's L
    against its plain version (its output bit-equal to the no-gradient
    build's), dq, dk, dv from that L as above; at the two training shapes
    the ``mma`` route too, and two wgmma calls at stablelm's bit-equal;
    ``decode_attention`` over rows [kv_start,
    kv_len) at G=4 and G=16, an empty range giving 0; ``ssm_scan_bwd`` fed
    by the checkpoints of ``ssm_scan``'s checkpoint-writing build (its y
    and h_last bit-equal to the plain build's, its checkpoints within 1e-4
    of the plain version's) at the reference's shapes, ragged S (37, 17, 5,
    1), without dy or dh_last, and one falcon-mamba training chunk, at
    1e-4, two calls there bit-equal;
23. the backward kernels' times at the training shapes beside their plain
    versions, their bounds (five products for attention) and, for
    attention, autograd of ``scaled_dot_product_attention`` as a yardstick
    the port never calls; attention's wgmma and ``mma`` routes timed in
    turns (wgmma, mma, mma, wgmma), and the forward with and without L;
    ``ssm_scan_bwd`` given the forward's checkpoints, below the time of
    the two-pass kernel it replaced, in turns with the scan's forward with
    and without checkpoints, with what each timed call saw (its ms, the
    host's time to queue it, whether the card reached it first, the SM
    clock, Python's collections) and what ``nvidia-smi`` read of the card
    before each loop; ``--ssm-bwd-timing RUNS`` runs only this scan
    timing, RUNS times over, and stops;
24. the reduced stablelm, qwen3-8b (G=2), falcon-mamba, gemma3 and
    qwen2-vl in f32, the card (forward and backward kernels, remat on)
    against the CPU (plain versions): loss and every gradient leaf of
    ``train_loss``, then one train step (AdamW, clipping), and on qwen3-8b
    the step's updated parameters and moments within 1e-6;
25. stablelm-1.6b at full width and depth (24 layers, 1.645 B params,
    bf16) trains 10 steps at B=8, S=2048 through
    ``repro_torch.launch.train.main``: finite losses whose last three
    average below the first, 24 x 10 backward launches, all on the wgmma
    route, and 2 x 24 x 10 forward attention launches (remat recomputes
    each layer), step time, tokens/s, peak memory, and a profile of one
    step with the backward kernels' share;
26. qwen3-8b (its first 4 of 36 layers, B=4, S=2048) and falcon-mamba-7b
    (its first 8 of 64, B=2, S=1024; full depth needs ~112 GB of training
    state) train 5 steps each at full width: finite losses, launch counts
    (qwen3-8b's 4 x 5 backward launches on the wgmma route; falcon-mamba's
    scan forwards all on the checkpoint-writing build), step time and a
    profile with the scan's backward and forward shares;
27. checkpoint, kill and resume on the card: the reduced stablelm through
    the train CLI in two child processes, the first dying after step 5
    (exit code 17), the second resuming from the verified step-6
    checkpoint;
28. the multi-device layer on a world-1 NCCL group
    (``launch.mesh.make_local_mesh(1, 1)``): (a) ``compressed_psum`` and
    ``sparse_psum`` on seeded f32 gradients of every stablelm-1.6b leaf
    shape, bit-equal to the in-step pair and to the top-k pair at frac
    0.01, with their ms on the 100352 x 2048 embedding (median of 10) and
    bytes on the wire; (b) ``ep_a2a.moe_ep_a2a_local`` at qwen2-moe-a2.7b's
    expert widths (E=60, top-4, M=2048, F=1408): T=4096 in bf16 routed by
    ``moe.route``, the NCCL exchange bit-equal to ``group=None``, ms and
    the dropped share, then T=256 in f32 at capacity factors 1.25 and 0.5,
    the card against the CPU within 1e-5 with identical src, eid and
    counts; (c) stablelm-1.6b at full width and depth: ``state_pspecs``
    under ``TRAIN_RULES``, ``checkpoint.save`` and ``restore(...,
    sharding_tree=)`` into DTensors with those placements, bit-equal to
    the saved leaves, then one train step (B=4, S=2048) under
    ``sharding_ctx`` from the restored state and one without: loss,
    params, mu and nu bit-equal, the attention backward on
    ``fa_bwd_wgmma``; ``--only-distributed`` builds the kernels, runs only
    this phase and stops;
29. the script's wall seconds, a ``{"kernels": [...]}`` line (each
    kernel's CUDA function on the main path under ``kernel``, its launches
    summed over every path above, ``decode_attention``'s G=16 time under
    ``g16``; the two backward kernels at the stablelm-1.6b and falcon-mamba
    training shapes, attention's ``mma`` route under ``mma``), then
    ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits nonzero without the last line.
It exits nonzero at once where no card is present.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # dense, no sparsity
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),  # tests/test_kernels.py
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
SSM_TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_kernels.py, the scan
SLEEP_CYCLES = 400_000  # ~0.2 ms of device time, more than a call's host side


def require(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def bound_ms(n_bytes, n_ops, dtype):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Device time of one call, averaged over ``iters``, each launch after
    a 256 MB write that evicts the 50 MB L2, as the engine's step (16 GB of
    weights) leaves it cold.  A device-side wait after the write keeps the
    card busy until the host has queued the call, so the time between the
    two events is the call's work on the card, not the host's Python;
    ``Timer.last`` says where that did not hold (``late``)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        # the first timed loop of a process reads several times high, the
        # same call timed later does not: one untimed loop first
        self.ms(lambda: None)

    def ms(self, fn, iters=20, warmup=3):
        """The mean; ``self.last`` keeps what each call of the timed loop
        saw: its ms, the host's ms to queue it, whether the card had
        already reached its start event when the host had queued it
        (``late``: the card may have waited on the host), the SM clock the
        wait ran at, and the ms of Python's collections in the loop."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        ev = lambda: torch.cuda.Event(enable_timing=True)  # noqa: E731
        calls, gc_ms, gc_start = [], [], [0.0]

        def collections(phase, info):
            if phase == "start":
                gc_start[0] = time.perf_counter()
            else:
                gc_ms.append((time.perf_counter() - gc_start[0]) * 1e3)

        gc.callbacks.append(collections)
        # a longer wait first: the card is idle after the synchronize, and
        # the first call would otherwise have only one wait and one flush
        # for the host to queue it in; from there the host stays ahead
        torch.cuda._sleep(10 * SLEEP_CYCLES)
        try:
            for _ in range(iters):
                self.flush.zero_()
                w, s, e = ev(), ev(), ev()
                w.record()
                torch.cuda._sleep(SLEEP_CYCLES)
                s.record()
                t0 = time.perf_counter()
                fn()
                host = (time.perf_counter() - t0) * 1e3
                late = s.query()
                e.record()
                calls.append((w, s, e, host, late))
        finally:
            gc.callbacks.remove(collections)
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for _, s, e, _, _ in calls]
        self.last = dict(
            calls_ms=ms, host_ms=[c[3] for c in calls],
            late=[i for i, c in enumerate(calls) if c[4]],
            clock_mhz=[SLEEP_CYCLES / 1e3 / w.elapsed_time(s)
                       for w, s, _, _, _ in calls],
            gc_ms=gc_ms)
        return sum(ms) / iters


def ptxas_report(log):
    """(kernel, registers and barriers, spills) for each entry function that
    ``nvcc -Xptxas -v`` reports in ``log``; names demangled where c++filt
    is found."""
    rows, fn, spill = [], None, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn, spill = line.split("'")[1], ""
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and fn:
            rows.append([fn, line.split(":", 1)[1].strip(), spill])
            fn = None
    try:
        names = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
        for r, name in zip(rows, names):
            r[0] = name.replace("(anonymous namespace)::", "").split("(")[0]
    except (OSError, subprocess.CalledProcessError):
        pass
    return rows


# -- phase 3 --------------------------------------------------------------


def lags_cases(torch, gen):
    def rand(T, k):
        u = lambda: torch.rand(T, generator=gen, device="cuda")  # noqa: E731
        return (u() * 2, u() * 2, u(), u() < 0.5, k, 1000)

    def few():
        T = 4096
        runnable = torch.zeros(T, dtype=torch.bool, device="cuda")
        runnable[[5, 50, 3000]] = True
        z = torch.zeros(T, device="cuda")
        return z, torch.arange(T, dtype=torch.float32, device="cuda"), z, \
            runnable, 16, 1000

    def equal():
        T = 4096
        f = lambda v: torch.full((T,), v, device="cuda")  # noqa: E731
        runnable = torch.arange(T, device="cuda") % 3 != 1
        return f(0.25), f(0.5), f(0.5), runnable, 16, 256

    def sub_1e4():
        T = 2048
        credit = torch.ones(T, device="cuda")
        credit[1000] = 1e-5
        credit[0] = torch.nextafter(torch.tensor(1e-5), torch.tensor(1.0))
        z = torch.zeros(T, device="cuda")
        return z, credit, z, torch.ones(T, dtype=torch.bool, device="cuda"), \
            3, 10**9

    def ties(T, k):
        # one key for every lane: the picks are the lowest runnable lanes,
        # across the cluster's CTA edges
        f = lambda v: torch.full((T,), v, device="cuda")  # noqa: E731
        runnable = torch.arange(T, device="cuda") % 3 != 1
        return f(0.25), f(0.5), f(0.5), runnable, k, 256

    def none(T):
        load, credit, frac, runnable, k, window = rand(T, 16)
        return load, credit, frac, torch.zeros_like(runnable), k, window

    cases = {f"T{T}_k{k}": rand(T, k) for T, k in (
        (1, 1), (256, 16), (1023, 16), (1024, 16), (1025, 16), (4096, 16),
        (8193, 16), (2048, 2048), (100, 200), (65536, 16), (65536, 1024))}
    cases.update({"few_runnable": few(), "all_equal": equal(),
                  "sub_1e-4": sub_1e4(), "ties_across_ctas": ties(65536, 16),
                  "ties_across_ctas_k1024": ties(65536, 1024),
                  "none_runnable": none(65536)})
    return cases


def check_lags(torch, lags):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    cases = lags_cases(torch, gen)
    for name, (load, credit, frac, runnable, k, window) in cases.items():
        got = lags.lags_select(load, credit, frac, runnable, k, window=window)
        want = lags.lags_select_plain(load, credit, frac, runnable, k,
                                      window=window)
        torch.cuda.synchronize()
        require(torch.equal(got[2], want[2]),
                f"lags_select {name} picks {got[2].tolist()} != plain "
                f"{want[2].tolist()}")
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                f"lags_select {name} state is not bit-equal to the plain "
                "version")
        if name == "sub_1e-4":
            require(got[2].tolist() == [0, 1000, 1],
                    f"sub-1e-4 picks {got[2].tolist()} != [0, 1000, 1]")
        if name == "few_runnable":
            require(got[2].tolist() == [5, 50, 3000] + [-1] * 13,
                    f"few-runnable picks {got[2].tolist()}")
        if name.startswith("ties_across_ctas"):
            want_ties = [i for i in range(load.shape[0]) if i % 3 != 1][:k]
            require(got[2].tolist() == want_ties,
                    f"{name} picks are not the lowest runnable lanes")
        if name == "none_runnable":
            require(got[2].tolist() == [-1] * k, f"none-runnable picks "
                    f"{got[2].tolist()}")
        errs[name] = max(float((got[0] - want[0]).abs().max()),
                         float((got[1] - want[1]).abs().max()))
        print(f"lags_select {name}: T={load.shape[0]} k={k} picks equal, "
              f"state bit-equal, first picks {got[2][:4].tolist()}")
    one_launch(torch, lags, *cases["T65536_k1024"][:5])
    return errs


def one_launch(torch, lags, *args):
    """One ``lags_select`` call is one kernel on the card, and the wrapper
    allocates only its three outputs (no candidate buffer)."""
    from torch.profiler import ProfilerActivity, profile

    lags.lags_select(*args)  # the library is loaded before the count
    torch.cuda.synchronize()
    n0 = torch.cuda.memory_stats()["allocation.all.allocated"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lags.lags_select(*args)
        torch.cuda.synchronize()
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"] - n0
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    names = sorted({e.name for e in kernels})
    require(len(kernels) == 1 and "lags_cluster_select" in names[0],
            f"one lags_select call ran {len(kernels)} kernels: {names}")
    require(allocs == 3, f"one lags_select call made {allocs} allocations, "
            "want its 3 outputs")
    print(f"lags_select T={args[0].shape[0]} k={args[4]}: one call is one "
          f"kernel ({names[0][:60]}), {allocs} allocations (its outputs)")


# -- phase 4 --------------------------------------------------------------


def dec_inputs(torch, gen, B, H, Hkv, L, D, dtype, kv_len, r0=0):
    """q (B, H, D) and the model's (B, L, Hkv, D) cache, seen as
    (B, Hkv, L - r0, D) views from row r0 (r0 > 0: a window's view)."""
    dt = getattr(torch, dtype)
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D)[:, r0:].permute(0, 2, 1, 3)
    v = n(B, L, Hkv, D)[:, r0:].permute(0, 2, 1, 3)
    return q, k, v, torch.tensor(kv_len, dtype=torch.int32, device="cuda")


def dec_shapes():
    # (B, H, Hkv, L, D, kv_len, r0): tests/test_kernels.py at G=1, then the
    # engine's shape for Qwen3-8B (G=4) with kv_len from 1 to L, L-7 among
    # them, then the decode after phase 9's prefill (B*Hkv = 32 heads: the
    # kernel splits L 4 ways, kv_len on and beside a split's edge); then
    # G=16 (qwen3-moe, 64 heads over 4) and G=7 (qwen2-vl, 28 over 4) at
    # that length, over the whole cache and through a window's view of its
    # last 1024 rows (r0 = 1088, gemma3's decode past its window)
    out = [(1, 2, 2, 512, 64, [512 // 3], 0),
           (2, 4, 4, 1024, 128, [512, 1024 - 7], 0)]
    for L in (512, 4096):
        kv = [L - 7, L, 1, L // 2] + [(97 * i) % L + 1 for i in range(12)]
        out.append((16, 32, 8, L, 128, kv, 0))
    out.append((4, 32, 8, 2112, 128, [2049, 1728, 1729, 2112], 0))
    for H in (64, 28):
        out.append((4, H, 4, 2112, 128, [2049, 1728, 1729, 2112], 0))
        out.append((4, H, 4, 2112, 128, [1024, 1000, 1, 513], 1088))
    return out


def check_decode(torch, dec):
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for B, H, Hkv, L, D, kv_len, r0 in dec_shapes():
            q, k, v, kv = dec_inputs(torch, gen, B, H, Hkv, L, D, dtype,
                                     kv_len, r0)
            got = dec.decode_attention(q, k, v, kv)
            want = dec.decode_attention_plain(q, k, v, kv)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            bad = ((got.float() - want.float()).abs()
                   > tol["atol"] + tol["rtol"] * want.float().abs()).sum()
            name = (f"decode_attention {dtype} B={B} H={H} Hkv={Hkv} L={L} "
                    f"D={D} G={H // Hkv}" + (f" rows {r0}.." if r0 else ""))
            require(int(bad) == 0 and math.isfinite(err),
                    f"{name}: {int(bad)} values outside {tol}, max err {err}")
            errs[(dtype, B, H, Hkv, L, D, r0)] = err
            print(f"{name}: max_abs_err={err:.3e} within {tol}")
    return errs


FLASH_MASKS = [(True, 0), (True, 128), (True, 64), (False, 0)]
QWEN_PREFILL = dict(B=4, H=32, Hkv=8, S=2048, D=128)  # the phase 9 shape
# at the prefill shape, ||got - want|| / ||want|| over each 64-row query tile
# of each (b, h): late rows have |out| ~ 0.04, below TOL's atol, and a
# dropped or misweighted KV tile moves a tile's norm by ~0.1 or more
FLASH_REL = {"float32": 1e-4, "bfloat16": 1e-2}
MAMBA_CHUNK = dict(B=4, S=256, I=8192, N=16)  # one scan of phase 10


def within(got, want, tol):
    """(ok, max abs error, values outside atol + rtol * |want|)."""
    diff = (got.float() - want.float()).abs()
    bad = int((diff > tol["atol"] + tol["rtol"] * want.float().abs()).sum())
    err = float(diff.max())
    return bad == 0 and math.isfinite(err), err, bad


def flash_inputs(torch, gen, B, H, Hkv, S, D, dtype):
    """q, k, v as the model hands them in: its (B, S, heads, D)
    projections seen as (B, heads, S, D)."""
    dt = getattr(torch, dtype)
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)  # noqa: E731
    return tuple(n(B, S, h, D).permute(0, 2, 1, 3) for h in (H, Hkv, Hkv))


def flash_cases():
    # (B, H, Hkv, S, D, masks): tests/test_kernels.py at G=1; GQA and S
    # that are no multiple of the 64-row tile; then the Qwen3-8B prefill;
    # then hubert's non-causal D=80 (fa_mma in bf16), G=16 (qwen3-moe), G=7
    # (qwen2-vl) and gemma3's window of 1024 at S=1536
    out = [(1, 1, 1, 128, 64), (2, 2, 2, 256, 128), (1, 4, 4, 512, 128),
           (2, 8, 2, 300, 64), (1, 4, 2, 77, 16), (2, 4, 4, 200, 80),
           (2, 4, 2, 130, 64), (1, 8, 1, 1, 128)]
    out = [c + (FLASH_MASKS,) for c in out]
    return out + [tuple(QWEN_PREFILL.values()) + ([(True, 0)],),
                  (2, 16, 16, 1024, 80, [(False, 0)]),
                  (1, 64, 4, 1024, 128, [(True, 0)]),
                  (1, 28, 4, 1024, 128, [(True, 0)]),
                  (1, 32, 16, 1536, 128, [(True, 1024)])]


def tile_rel_err(got, want, tile=64):
    """max over (b, h, query tile) of ||got - want|| / ||want||, and where."""
    B, H, S, D = want.shape
    require(S % tile == 0, f"S={S} is no multiple of {tile}")
    diff = (got.float() - want.float()).reshape(B, H, S // tile, tile * D)
    rel = diff.norm(dim=-1) / want.float().reshape(diff.shape).norm(dim=-1)
    worst = int(rel.argmax())
    return float(rel.max()), (worst // (H * (S // tile)),
                              worst // (S // tile) % H, worst % (S // tile))


def check_flash(torch, fa):
    gen = torch.Generator(device="cuda").manual_seed(4)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for B, H, Hkv, S, D, masks in flash_cases():
            q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, dtype)
            for causal, window in masks:
                got = fa.flash_attention(q, k, v, causal=causal, window=window)
                want = fa.flash_attention_plain(q, k, v, causal=causal,
                                                window=window)
                torch.cuda.synchronize()
                ok, err, bad = within(got, want, TOL[dtype])
                name = (f"flash_attention {dtype} B={B} H={H} Hkv={Hkv} S={S} "
                        f"D={D} causal={causal} window={window}")
                require(ok, f"{name}: {bad} values outside {TOL[dtype]}, "
                        f"max err {err}")
                errs[(dtype, B, H, Hkv, S, D, causal, window)] = err
                print(f"{name}: max_abs_err={err:.3e} within {TOL[dtype]}")
                if (B, H, Hkv, S, D) == tuple(QWEN_PREFILL.values()):
                    r, at = tile_rel_err(got, want)
                    require(r < FLASH_REL[dtype], f"{name}: query tile (b, h, "
                            f"tile) {at} has relative error {r:.3e} >= "
                            f"{FLASH_REL[dtype]}")
                    print(f"{name}: max over (b, h, 64-row query tile) of "
                          f"||got - want|| / ||want|| = {r:.3e} at {at}, "
                          f"below {FLASH_REL[dtype]}")
    return errs


def ssm_inputs(torch, gen, B, S, I, N, h0_scale=1.0):
    """The reference test's distributions in f32: dA = exp(-dt * a) in
    (0, 1), dBx = dt * noise * 0.1; h0 nonzero unless h0_scale is 0."""
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    dt = torch.nn.functional.softplus(n(B, S, I, 1) - 1.0)
    dA = torch.exp(-dt * torch.exp(n(1, 1, I, N) * 0.2))
    dBx = dt * n(B, S, I, N) * 0.1
    return dA, dBx, n(B, S, N), n(B, I, N) * h0_scale


def check_ssm(torch, ssm):
    gen = torch.Generator(device="cuda").manual_seed(5)
    errs = {}
    cases = [(1, 128, 256, 8, 0.0), (2, 256, 512, 16, 0.0),
             (1, 128, 128, 8, 1.0), (2, 37, 64, 16, 1.0),
             tuple(MAMBA_CHUNK.values()) + (1.0,)]
    for B, S, I, N, h0_scale in cases:
        dA, dBx, C, h0 = ssm_inputs(torch, gen, B, S, I, N, h0_scale=h0_scale)
        y, h = ssm.ssm_scan(dA, dBx, C, h0)
        y_p, h_p = ssm.ssm_scan_plain(dA, dBx, C, h0)
        torch.cuda.synchronize()
        ok_y, err_y, bad_y = within(y, y_p, SSM_TOL)
        ok_h, err_h, bad_h = within(h, h_p, SSM_TOL)
        name = f"ssm_scan float32 B={B} S={S} I={I} N={N} h0x{h0_scale}"
        require(ok_y and ok_h, f"{name}: {bad_y} y and {bad_h} h values "
                f"outside tolerance, max err {err_y}, {err_h}")
        errs[(B, S, I, N)] = max(err_y, err_h)
        print(f"{name}: max_abs_err y={err_y:.3e} h={err_h:.3e} "
              f"within {SSM_TOL}")
    return errs


# -- phase 5 --------------------------------------------------------------


def library_ms(torch, timer, label, fn, iters=20):
    """``timer.ms(fn)`` for a library call, with the profiler recording which
    kernels ran in those very launches (for SDPA: the backend it chose)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ms = timer.ms(fn, iters=iters)
    rows = sorted(((e.self_device_time_total / 1e3 / e.count, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and e.self_device_time_total > 0
                   # the timer's L2 flush and its wait are not the library's
                   and "FillFunctor" not in e.key and "spin_kernel" not in e.key),
                  reverse=True)
    for each_ms, count, key in rows[:4]:
        print(f"  {label} ran {count}x {each_ms:.4f} ms  {key[:110]}")
    return ms


def time_lags(torch, lags, timer, T, k=16):
    gen = torch.Generator(device="cuda").manual_seed(2)
    u = lambda: torch.rand(T, generator=gen, device="cuda")  # noqa: E731
    args = (u() * 2, u() * 2, u(), u() < 0.5, k)
    ms = timer.ms(lambda: lags.lags_select(*args))
    plain_ms = timer.ms(lambda: lags.lags_select_plain(*args))
    # the floor: an empty kernel under the same timer
    floor_ms = timer.ms(lambda: lags.empty_launch("cuda"))
    # yardstick only: selection alone on the precomputed key, its order
    # among ties unset; its picks are not compared and the port never calls it
    _, credit, _ = lags.lags_select_plain(*args)
    key = torch.where(args[3], credit + torch.arange(
        T, device="cuda", dtype=torch.float32) * 1e-12, float("inf"))
    lib_ms = timer.ms(lambda: torch.topk(key, k, largest=False, sorted=True))
    # each input read once (3 f32 + 1 bool), each output written once
    n_bytes = T * (3 * 4 + 1) + T * 2 * 4 + k * 4
    n_ops = T * 9  # 4 mul + 2 add (tick), mul + add (key), 1 compare
    b, by = bound_ms(n_bytes, n_ops, "float32")
    return dict(ms=ms, plain_ms=plain_ms, floor_ms=floor_ms,
                library_ms=lib_ms, bound_ms=b, bound_by=by,
                library="torch.topk on the key: selection only, tie order "
                "unset")


def time_decode(torch, dec, timer, B=16, H=32, Hkv=8, L=512, D=128,
                dtype="bfloat16"):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(3)
    kv_len = [L - 7] * B
    q, k, v, kv = dec_inputs(torch, gen, B, H, Hkv, L, D, dtype, kv_len)
    ms = timer.ms(lambda: dec.decode_attention(q, k, v, kv))
    plain_ms = timer.ms(lambda: dec.decode_attention_plain(q, k, v, kv))
    # yardstick only: one PyTorch call for the same function
    q4, k4, v4 = q[:, :, None, :], k.contiguous(), v.contiguous()
    mask = (torch.arange(L, device="cuda")[None, :] < kv[:, None])[:, None, None]
    lib_ms = library_ms(torch, timer, f"SDPA decode L={L}",
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask, enable_gqa=True))
    esize = 2 if dtype == "bfloat16" else 4
    n_rows = sum(kv_len)  # cache rows this kv_len needs, per KV head
    n_bytes = (2 * B * H * D * esize  # q in, out
               + 2 * n_rows * Hkv * D * esize  # K and V rows once
               + B * 4)
    n_ops = 4 * n_rows * H * D  # q.k and p.v, 2 flops a multiply-add
    b, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by)


def time_flash(torch, fa, timer, B, H, Hkv, S, D, dtype="bfloat16"):
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, dtype)
    ms = timer.ms(lambda: fa.flash_attention(q, k, v), iters=10)
    plain_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v), iters=10)
    # yardstick only: one PyTorch call for the same function
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=True, enable_gqa=True)
    lib_ms = library_ms(torch, timer, "SDPA prefill", sdpa, iters=10)
    esize = 2 if dtype == "bfloat16" else 4
    n_bytes = B * S * (2 * H + 2 * Hkv) * D * esize  # q, k, v in; out
    pairs = S * (S + 1) // 2  # (query, key) pairs the causal mask keeps
    n_ops = 4 * pairs * D * B * H  # q.k and p.v, 2 flops a multiply-add
    b, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by)


def time_ssm(torch, ssm, timer, B, S, I, N):
    gen = torch.Generator(device="cuda").manual_seed(7)
    dA, dBx, C, h0 = ssm_inputs(torch, gen, B, S, I, N)
    ms = timer.ms(lambda: ssm.ssm_scan(dA, dBx, C, h0))
    plain_ms = timer.ms(lambda: ssm.ssm_scan_plain(dA, dBx, C, h0), iters=5)
    # f32: dA, dBx, C, h0 in; y, h_last out
    n_bytes = 4 * (2 * B * S * I * N + B * S * N + 2 * B * I * N + B * S * I)
    n_ops = 4 * B * S * I * N  # h = a*h + b, y += h*c
    b, by = bound_ms(n_bytes, n_ops, "float32")
    # no one PyTorch call computes a selective scan
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b,
                bound_by=by)


# -- phases 6 and 7 -------------------------------------------------------


def summary(st):
    lat = sorted(r.latency for r in st.completed)
    return (len(st.completed), st.membership_changes, st.steps, st.idle_steps,
            tuple(lat))


@contextlib.contextmanager
def engine_tick_clock(secs):
    """Append the host-clock seconds of every ``Engine._kernel_tick`` (the
    engine's credit tick: host lists, copies both ways, the kernel) to
    ``secs`` while the block runs."""
    from repro_torch.serving.engine import Engine

    orig = Engine._kernel_tick

    def timed(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            return orig(self, *args, **kwargs)
        finally:
            secs.append(time.perf_counter() - t0)

    Engine._kernel_tick = timed
    try:
        yield secs
    finally:
        Engine._kernel_tick = orig


def tick_split(torch, T, kernel_ms, k=16, window=256):
    """The host-clock ms of one ``cuda_backend.tick_and_pick`` call at T
    tenants (host arrays in, host arrays out, as the engine calls it), beside
    the kernel's device ms from phase 5."""
    import numpy as np

    from repro_torch.sched import cuda_backend

    rng = np.random.default_rng(T)
    args = (rng.uniform(0, 2, T), rng.uniform(0, 2, T), rng.uniform(0, 1, T),
            rng.uniform(size=T) < 0.5, k)
    for _ in range(5):
        cuda_backend.tick_and_pick(*args, window=window)
    secs = []
    for _ in range(50):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cuda_backend.tick_and_pick(*args, window=window)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = sorted(secs)[len(secs) // 2] * 1e3
    print(f"tick T={T} k={k}: one cuda_backend.tick_and_pick takes {med:.6g} "
          f"ms on the host clock (median of 50, min {min(secs) * 1e3:.6g}); "
          f"the kernel {kernel_ms:.6g} ms on the device, "
          f"{100 * kernel_ms / med:.2f}% of the call")
    return med


def serve_cost_model(torch, ops, serve, tick_kernel_ms):
    # the card and the CPU schedule alike: the kernel's state is bit-equal
    argv = ["--tenants", "300", "--duration", "2"]
    on_card = summary(serve.main(argv))
    on_cpu = summary(serve.main(argv + ["--device", "cpu"]))
    require(on_card == on_cpu, "300-tenant serve differs on the card and CPU")

    ops.reset_launch_counts()
    ticks = []
    with engine_tick_clock(ticks):
        t0 = time.perf_counter()
        st = serve.main(["--tenants", "4096", "--duration", "5"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = ops.launch_counts()
    busy = st.steps - st.idle_steps
    require(n["lags_select"] == busy > 0,
            f"lags_select launches {n['lags_select']} != busy steps {busy}")
    require(len(st.completed) > 0, "no request completed at 4096 tenants")
    print(f"serve 4096 tenants: steps={st.steps} busy_steps={busy} "
          f"lags_select launches={n['lags_select']}; serve.main wall "
          f"{wall:.3f} s, {wall / busy * 1e3:.6g} ms a busy step, of which "
          f"Engine._kernel_tick {sum(ticks) / len(ticks) * 1e3:.6g} ms "
          f"(host clock, mean of {len(ticks)} ticks)")
    tick_split(torch, 4096, tick_kernel_ms)
    return n


def to(tree, dev):
    """A copy of a parameter or cache tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, dev) for v in tree]
    return tree.to(dev)


def init_full(torch, cfg, note=""):
    """Random parameters from seed 0 on the card, the reference's init
    rule; prints their count and bytes."""
    from repro_torch.models.params import count_params, init_params

    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    print(f"{cfg.name}{note}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{count_params(params) / 1e9:.3f} B params in {cfg.param_dtype}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, init "
          f"{time.perf_counter() - t0:.1f} s")
    return params


def check_model_small(torch):
    """The reduced decoder on the card (kernels) against the CPU (plain
    versions), in f32: the same logits and greedy tokens."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model
    from repro_torch.models.params import init_params

    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    on = {"cpu": params, "cuda": to(params, "cuda")}
    caches = {dev: model.init_cache(cfg, 4, 16, device=dev)
              for dev in ("cpu", "cuda")}
    tokens = {dev: torch.tensor([[1], [7], [42], [255]], dtype=torch.int32,
                                device=dev) for dev in ("cpu", "cuda")}
    for n in range(6):
        out = {}
        for dev in ("cpu", "cuda"):
            logits, _ = model.decode_step(on[dev], cfg, {"tokens": tokens[dev]},
                                          caches[dev], n, device=dev)
            out[dev] = logits.float().cpu()
            tokens[dev] = torch.argmax(logits, -1)[:, None].to(torch.int32)
        err = float((out["cuda"] - out["cpu"]).abs().max())
        require(err <= 1e-4 + 1e-4 * float(out["cpu"].abs().max()),
                f"reduced decoder step {n}: card vs CPU max err {err}")
        require(torch.equal(tokens["cuda"].cpu(), tokens["cpu"]),
                f"reduced decoder step {n}: tokens differ")
    print(f"reduced qwen3-8b f32, 6 decode steps: card (kernels) = CPU "
          f"(plain versions), last max_abs_err={err:.3e}")


def serve_qwen3_8b(torch, ops, serve, tick_kernel_ms):
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.models.params import count_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_config("qwen3-8b")
    params = init_full(torch, cfg)
    n_params = count_params(params)

    n_tenants, duration, max_len = 1024, 20.0, 512
    tenants, arrivals = serve.build_workload(n_tenants, duration, seed=0)
    eng = Engine(EngineConfig(n_slots=16), tenants, device="cuda")
    eng.attach_model(cfg, params, max_len=max_len)
    cache_gb = sum(c["k"].numel() * 2 * c["k"].element_size()
                   for c in eng._cache) / 1e9
    ops.reset_launch_counts()
    ticks = []
    torch.cuda.synchronize()
    with engine_tick_clock(ticks):
        t0 = time.perf_counter()
        st = eng.run(duration, arrivals)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    n = ops.launch_counts()
    busy = st.steps - st.idle_steps
    decode_steps = eng._cache_len
    require(decode_steps == max_len - 1,
            f"{decode_steps} decode steps, want {max_len - 1}")
    require(n["decode_attention"] == cfg.n_layers * decode_steps,
            f"decode_attention launches {n['decode_attention']} != "
            f"{cfg.n_layers} x {decode_steps}")
    require(n["lags_select"] == busy,
            f"lags_select launches {n['lags_select']} != busy steps {busy}")

    # the decode does not change the schedule: the CPU engine agrees
    tenants_c, arrivals_c = serve.build_workload(n_tenants, duration, seed=0)
    st_c = Engine(EngineConfig(n_slots=16), tenants_c, device="cpu").run(
        duration, arrivals_c)
    require(summary(st) == summary(st_c), "the card's schedule differs from "
            "the CPU engine's on the same workload")
    lat = [r.latency for r in st.completed]
    print(f"engine qwen3-8b: tenants={n_tenants} slots=16 steps={st.steps} "
          f"busy_steps={busy} decode_steps={decode_steps} "
          f"completed={len(st.completed)}/{len(arrivals)} "
          f"p50={sorted(lat)[len(lat) // 2]:.2f}s "
          f"membership_changes={st.membership_changes} "
          f"kv_cache={cache_gb:.2f} GB wall={wall:.2f} s "
          f"launches={json.dumps(n)}")
    print(f"engine qwen3-8b: {wall / busy * 1e3:.6g} ms a busy step, of which "
          f"Engine._kernel_tick {sum(ticks) / len(ticks) * 1e3:.6g} ms "
          f"(host clock, mean of {len(ticks)} ticks)")
    tick_split(torch, n_tenants, tick_kernel_ms)

    # one more step at the full cache (kv_len 512), outside the counted run
    tokens = eng._tokens
    timer_ev = []
    for _ in range(13):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        logits, _ = model.decode_step(params, cfg, {"tokens": tokens},
                                      eng._cache, max_len - 1, device="cuda")
        e.record()
        timer_ev.append((s, e))
    torch.cuda.synchronize()
    require(logits.shape == (16, cfg.vocab_size), f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    step_ms = sorted(s.elapsed_time(e) for s, e in timer_ev[3:])
    weight_bytes = 2 * (n_params - cfg.vocab_size * cfg.d_model)  # rows read
    print(f"decode step qwen3-8b B=16 kv_len={max_len}: "
          f"median {step_ms[len(step_ms) // 2]:.3f} ms, min {step_ms[0]:.3f} ms "
          f"over {len(step_ms)} steps; bound {weight_bytes / 1e9:.2f} GB of "
          f"weights / 3.35 TB/s = {weight_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms")
    profile(torch, "decode step", lambda: model.decode_step(
        params, cfg, {"tokens": tokens}, eng._cache, max_len - 1,
        device="cuda"))
    return n, params


def profile(torch, label, step, n_steps=3, rows_out=None):
    """Where a step's time goes: device time by kernel, and the share of
    the step's wall time the card is busy.  Returns (wall ms, busy ms) of
    one step; ``rows_out`` gets every (ms, count, kernel) row."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_steps
    rows = [(e.self_device_time_total / 1e3 / n_steps, e.count // n_steps,
             e.key) for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    rows.sort(reverse=True)
    if rows_out is not None:
        rows_out.extend(rows)
    busy = sum(r[0] for r in rows)
    print(f"profile {label} (profiler on): wall {wall_ms:.3f} ms, "
          f"kernels {busy:.3f} ms, device busy {100 * busy / wall_ms:.1f}%")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms {count:5d}x  {key[:110]}")
    return wall_ms, busy


# -- phases 8 to 10 -------------------------------------------------------


def mrope_positions(torch, B, S, n_img, device):
    """(B, S, 3) M-RoPE positions: stream 0 the row index; streams 1 and 2
    a square grid (row, column) over the first n_img rows, the image's, and
    the row index after them."""
    side = math.isqrt(n_img)
    idx = torch.arange(S, dtype=torch.int32, device=device)
    img = idx < n_img
    h = torch.where(img, idx // side, idx)
    w = torch.where(img, idx % side, idx)
    return torch.stack([idx, h, w], -1).expand(B, S, 3).contiguous()


def family_batch(torch, cfg, B, S, device, seed=1):
    """A prefill batch: random tokens, or frames for the audio frontend;
    for the vision frontend ``n_vision_tokens`` random embeddings over the
    first rows and ``mrope_positions``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": torch.randn(B, S, cfg.d_model, generator=gen,
                                      device=device)}
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                                     dtype=torch.int32, device=device)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(B, cfg.n_vision_tokens,
                                             cfg.d_model, generator=gen,
                                             device=device)
        batch["positions"] = mrope_positions(torch, B, S, cfg.n_vision_tokens,
                                             device)
    return batch


def close(got, want, what):
    """max abs error of ``got`` (card) against ``want`` (CPU), required
    within 1e-4 + 1e-4 of want's largest entry; returns error / scale."""
    want = want.float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float().cpu() - want).abs().max())
    require(err <= 1e-4 + 1e-4 * scale, f"{what}: card vs CPU max err {err}")
    return err / scale


def family_end_to_end(torch, cfg, params, B=2, S=32, n_decode=8):
    """Prefill logits and every cache leaf on the card (kernels) against
    the CPU (plain versions), then ``n_decode`` steps fed the CPU's greedy
    tokens.  Returns the worst error / scale."""
    from repro_torch.models import model

    on = {"cpu": params, "cuda": to(params, "cuda")}
    batch = family_batch(torch, cfg, B, S, "cpu")
    out = {dev: model.prefill(on[dev], cfg, to(batch, dev),
                              max_len=S + n_decode, device=dev)
           for dev in on}
    worst = close(out["cuda"][0], out["cpu"][0], f"{cfg.name} prefill")
    if cfg.encoder_only:
        return worst
    caches = {dev: out[dev][1] for dev in on}
    tok = torch.argmax(out["cpu"][0], -1)[:, None].to(torch.int32)
    for n in range(S, S + n_decode):
        step = {dev: model.decode_step(on[dev], cfg, {"tokens": tok.to(dev)},
                                       caches[dev], n, device=dev)[0]
                for dev in on}
        worst = max(worst, close(step["cuda"], step["cpu"],
                                 f"{cfg.name} decode at {n}"))
        tok = torch.argmax(step["cpu"], -1)[:, None].to(torch.int32)
    for i, (c_card, c_cpu) in enumerate(zip(caches["cuda"], caches["cpu"])):
        for leaf in c_cpu:
            worst = max(worst, close(c_card[leaf], c_cpu[leaf],
                                     f"{cfg.name} layer {i} {leaf}"))
    return worst


def check_prefill_small(torch):
    """The reduced prefill in f32 on the card (kernels) against the CPU
    (plain versions): logits and every cache leaf, then one decode step."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params

    # S = 100 leaves a ragged 64-row tile; S = 300 a ragged 256-token chunk
    for name, overrides, S in (("qwen3-8b", {"n_kv_heads": 2}, 100),
                               ("falcon-mamba-7b", {}, 300)):
        cfg = reduced(get_config(name), n_layers=2, **overrides)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        worst = family_end_to_end(torch, cfg, params, B=3, S=S, n_decode=1)
        print(f"reduced {name} f32 prefill S={S} + 1 decode step: card "
              f"(kernels) = CPU (plain versions) in logits and every cache "
              f"leaf, worst error / scale {worst:.3e}")


def rows(batch, n):
    """The first n positions of a batch: every (B, S, ...) entry cut to n
    rows; the vision embeddings kept where they fit."""
    return {k: v for k, v in ((k, v if k == "vision_embeds" else v[:, :n])
                              for k, v in batch.items())
            if k != "vision_embeds" or v.shape[1] <= n}


def add_counts(total, n):
    for k, v in n.items():
        total[k] = total.get(k, 0) + v


def prefill_full(torch, ops, cfg, params, batch, n_decode, launches, tail=1,
                 cos_min=0.99, label=None, profile_decode=False):
    """Prefill of ``batch`` (B prompts of S positions), then ``n_decode``
    greedy decode steps from its cache.  The prefill must launch each kernel
    of ``launches`` that many times, each decode step every attention layer's
    ``decode_attention``.  Then the consistency check: prefill of the first
    S - ``tail`` positions and ``tail`` decode steps fed the prompt's last
    tokens, against the whole prefill's last logits, cosine >= ``cos_min``
    (None: printed, not checked; tail 0: no check).  Returns the launches of
    the prefill and the decode steps, summed."""
    import torch.nn.functional as F

    from repro_torch.configs.base import layer_specs
    from repro_torch.models import model

    label = label or cfg.name
    B, S = next(iter(batch.values())).shape[:2]
    max_len = S + n_decode
    run = lambda b, n=max_len: model.prefill(  # noqa: E731
        params, cfg, b, max_len=n, device="cuda")
    run(rows(batch, 64))  # warm-up: cuBLAS and the kernels' first launches
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = run(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n = ops.launch_counts()
    for kernel, want in launches.items():
        require(n[kernel] == want, f"{kernel} launches {n[kernel]} in the "
                f"{label} prefill, want {want}")
    require(logits.shape == (B, cfg.vocab_size), f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()),
            f"{label} prefill: non-finite logits")
    secs = [first_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(batch)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = sorted(secs)[1]
    print(f"prefill {label} B={B} S={S}: median {med * 1e3:.3f} ms "
          f"(runs {', '.join(f'{x * 1e3:.3f}' for x in secs)} ms), "
          f"{B * S / med:.0f} tokens/s; launches {json.dumps(n)}")
    total = dict(n)

    # decode from the prefill's cache
    n_attn = sum(spec.kind == "attn" for spec in layer_specs(cfg))
    ops.reset_launch_counts()
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    ev = []
    for i in range(n_decode):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        step, cache = model.decode_step(params, cfg, {"tokens": tok}, cache,
                                        S + i, device="cuda")
        e.record()
        ev.append((s, e))
        tok = torch.argmax(step, -1)[:, None].to(torch.int32)
    torch.cuda.synchronize()
    nd = ops.launch_counts()
    add_counts(total, nd)
    if n_decode:
        require(nd["decode_attention"] == n_attn * n_decode,
                f"decode_attention launches {nd['decode_attention']} after "
                f"the prefill, want {n_attn} x {n_decode}")
        require(bool(torch.isfinite(step).all()),
                f"{label} decode after prefill: non-finite logits")
        step_ms = sorted(a.elapsed_time(b) for a, b in ev[3:])
        print(f"decode {label} B={B} from the prefill's cache, positions "
              f"{S}..{S + n_decode - 1}: median "
              f"{step_ms[len(step_ms) // 2]:.3f} ms a step; launches "
              f"{json.dumps(nd)}")
        if profile_decode:
            profile(torch, f"decode step {label} B={B} at {S + n_decode}",
                    lambda: model.decode_step(params, cfg, {"tokens": tok},
                                              cache, S + n_decode - 1,
                                              device="cuda"))
    del cache

    if tail:
        # prefill(S - tail), then tail decode steps fed the prompt's tokens
        _, short = run(rows(batch, S - tail), S)
        for t in range(S - tail, S):
            db = {k: v[:, t:t + 1] for k, v in batch.items()
                  if k in ("tokens", "positions")}
            last, short = model.decode_step(params, cfg, db, short, t,
                                            device="cuda")
        del short
        cos = F.cosine_similarity(logits.float(), last.float(), dim=-1)
        require(bool(torch.isfinite(last).all()),
                f"{label}: non-finite logits after prefill + decode")
        if cos_min is not None:
            require(float(cos.min()) >= cos_min,
                    f"{label}: prefill vs prefill + decode cosine "
                    f"{cos.tolist()} < {cos_min}")
        print(f"consistency {label}: last logits of prefill(S={S}) vs "
              f"prefill(S-{tail}) + {tail} decode step"
              f"{'s' if tail > 1 else ''}, cosine similarity min "
              f"{float(cos.min()):.6f} (per prompt "
              f"{', '.join(f'{c:.6f}' for c in cos.tolist())}"
              + ("; not checked: capacity drops make prefill and decode "
                 "different functions" if cos_min is None else "")
              + f"); max abs diff "
              f"{float((logits.float() - last.float()).abs().max()):.4f}")
    profile(torch, f"prefill {label} B={B} S={S}", lambda: run(batch),
            n_steps=1)
    return total


def token_batch(torch, cfg, B, S, seed=8):
    """B prompts of S random tokens on the card."""
    return {"tokens": torch.randint(
        0, cfg.vocab_size, (B, S), dtype=torch.int32, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(seed))}


def mamba_full(torch, ops):
    from repro_torch.configs.base import get_config
    from repro_torch.models.mamba import CHUNK

    cfg = get_config("falcon-mamba-7b")
    params = init_full(torch, cfg)
    residual_growth(torch, cfg, params)
    B, S = 4, 1024
    return prefill_full(torch, ops, cfg, params, token_batch(torch, cfg, B, S),
                        32, {"ssm_scan": cfg.n_layers * -(-S // CHUNK),
                             "ssm_scan_ckpt": 0})


def residual_growth(torch, cfg, params, B=1, S=256):
    """max |x| of the residual stream after each layer, for a short prompt:
    the reference's fan_in rule gives every stacked weight std 1/8 here."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.models import blocks, model

    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(9))
    cache = model.init_cache(cfg, B, S, device="cuda")
    with torch.no_grad():
        x = params["embed"][toks].to(getattr(torch, cfg.dtype))
        peaks = []
        for spec, p, c in zip(layer_specs(cfg), params["layers"], cache):
            x, _ = blocks.apply_layer(cfg, spec, p, x, None, c)
            peaks.append(float(x.float().abs().max()))
    bad = [i for i, v in enumerate(peaks) if not math.isfinite(v)]
    require(not bad, f"{cfg.name}: the residual overflows at layer "
            f"{bad[:1]}")
    shown = [i for i in (1, 2, 4, 8, 16, 32, 64) if i <= len(peaks)]
    print(f"residual {cfg.name} B={B} S={S} max |x| after layers "
          + ", ".join(f"{i}: {peaks[i - 1]:.3e}" for i in shown))


# -- phases 11 to 13 ------------------------------------------------------

# The reference at the same calls (JAX 0.9.0 on the CPU; this script
# imports nothing of it).  Fig. 11: ``benchmarks/common.py::run_sim_jax(
# "azure2021", 120, policy)``, lags-static with ``static_rt=
# lightest_band_fns(120, n_bands_low=3)``: completed requests, the sum of
# their completion ticks, p50 and p95 (s), busy and overhead (s).
REF_FIG11 = {
    "cfs": (2354, 9551082, 0.112, 0.8761999999999989, 235.5103302001953,
            19.870229721069336),
    "lags": (2354, 9544722, 0.108, 0.908, 235.51206970214844,
             16.76390838623047),
    "eevdf": (2354, 9551162, 0.112, 0.8787999999999992, 235.5103302001953,
              19.873079299926758),
    "rr": (2354, 9594127, 0.184, 1.0493999999999997, 235.50978088378906,
           23.828720092773438),
    "lags-static": (2354, 9545476, 0.112, 0.7213999999999996,
                    235.51210021972656, 17.640056610107422),
    "cfs-tuned": (2354, 9554337, 0.116, 0.848, 235.50997924804688,
                  20.369178771972656),
    "eevdf-tuned": (2354, 9554339, 0.116, 0.848, 235.50999450683594,
                    20.372493743896484),
}
# Fig. 7: ``repro.fleet.consolidate.consolidation_sweep(total_fns=800,
# node_counts=(14, 12, 10), backend="jax", duration_s=30.0)``, the
# cross-check of ``benchmarks/fig7_cluster.py``: p50 and p95 (s) and the
# overhead share per (policy, nodes) of its 14- and 10-node configurations
# (each configuration is simulated alone, so it does not depend on the
# others in the sweep); ``min_nodes_meeting_slo`` is 14 for both policies.
REF_FIG7 = {
    ("cfs", 14): (0.148, 0.232, 0.022415417716616676),
    ("cfs", 10): (0.156, 1.072, 0.06029708120557997),
    ("lags", 14): (0.148, 0.244, 0.017715106313190763),
    ("lags", 10): (0.152, 1.784, 0.050209426879882814),
}
SIM_RTOL = 1e-5  # busy, overhead: f32 sums whose order may differ


@contextlib.contextmanager
def clock(owner, name, calls):
    """Append (positional arguments..., output, wall seconds) of every call
    of ``owner.name``, the card synchronised before and after, to
    ``calls`` while the block runs."""
    import torch

    orig = getattr(owner, name)

    def timed(*args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*args, **kw)
        torch.cuda.synchronize()
        calls.append((*args, out, time.perf_counter() - t0))
        return out

    setattr(owner, name, timed)
    try:
        yield calls
    finally:
        setattr(owner, name, orig)


def simulate_clock(calls):
    """``clock`` of ``simkernel_torch.simulate``: (trace, params, output,
    wall seconds) a call."""
    from repro_torch.core import simkernel_torch as st

    return clock(st, "simulate", calls)


def sim_check(name, got, want, what):
    require(math.isclose(got, want, rel_tol=SIM_RTOL),
            f"{name}: {what} {got!r}, the reference {want!r}")


def fig11(torch, card):
    """All seven policy codes at Fig. 11's size on the card, held to the
    reference; lags and cfs on the CPU too.  Returns the ticks/s and the
    LAGS run's trace and params for the profile."""
    import numpy as np

    from repro_torch.core import simkernel_torch as st
    from repro_torch.core.traces import lightest_band_fns, make_workload
    from repro_torch.sched.torch_backend import CODE_OF, LAGS, LAGS_STATIC

    wl = make_workload("azure2021", 120, duration_s=30.0, n_cores=12, seed=1,
                       exec_s=0.1, threads_per_fn=4)
    rt = tuple(int(f) for f in lightest_band_fns(120, n_bands_low=3))

    def params(code, n_ticks=7500):
        return st.SimParams(n_cores=12, n_fns=120, n_ticks=n_ticks,
                            policy=code, burst_us=120.0, depth=2.0,
                            rt_fns=rt if code == LAGS_STATIC else ())

    trace = {dev: st.build_slot_trace(wl, 120, 4, device=dev)
             for dev in ("cuda", "cpu")}
    st.simulate(trace["cuda"], params(LAGS, 50))  # warm-up: first launches
    done, rate = {}, {}
    for name, code in sorted(CODE_OF.items(), key=lambda kv: kv[1]):
        for dev in ("cuda", "cpu") if name in ("lags", "cfs") else ("cuda",):
            calls = []
            with simulate_clock(calls):
                out = st.simulate(trace[dev], params(code))
            secs = calls[0][3]
            rate[name, dev] = 7500 / secs
            d = out["done_tick"].cpu().numpy()
            lat = st.latencies_from(trace[dev], d)
            got = (len(lat), int(d[d >= 0].sum()),
                   float(np.percentile(lat, 50)), float(np.percentile(lat, 95)))
            ref = REF_FIG11[name]
            require(got == ref[:4], f"fig11 {name} on {dev}: (completed, sum "
                    f"of completion ticks, p50, p95) {got}, the reference "
                    f"{ref[:4]}")
            sim_check(f"fig11 {name} on {dev}", float(out["busy_s"]), ref[4],
                      "busy_s")
            sim_check(f"fig11 {name} on {dev}", float(out["overhead_s"]),
                      ref[5], "overhead_s")
            if dev == "cpu":
                require(np.array_equal(d, done[name]),
                        f"fig11 {name}: completion ticks differ on the card "
                        f"and the CPU")
            done[name] = d
            print(f"fig11 {name} T=480 R={trace[dev].arrival_tick.shape[1]} "
                  f"7500 ticks on the {dev}: {got[0]} completed, p50 "
                  f"{got[2]:.4f} s, p95 {got[3]:.4f} s, overhead "
                  f"{float(out['overhead_s']) / (12 * 30.0):.6f}; "
                  f"{secs:.3f} s wall, {rate[name, dev]:.1f} ticks/s [{card}]")
    print("fig11: all seven codes equal the reference on the card "
          "(completions, sum of completion ticks, p50, p95; busy and "
          "overhead within rtol 1e-5); lags and cfs complete on the same "
          "ticks on the CPU")
    return rate, trace["cuda"], params(LAGS)


def fig7(torch, card):
    """The consolidation sweep on the card against the reference, and its
    10-node LAGS fleet on the CPU.  Returns the ticks/s of the 10-node LAGS
    loop on the card and the CPU, and its trace and params."""
    import numpy as np

    from repro_torch.fleet import (CLUSTER_EXEC_S, consolidation_sweep,
                                   make_policy, min_nodes_meeting_slo, place,
                                   simulate_fleet)

    calls = []
    with simulate_clock(calls):
        t0 = time.perf_counter()
        res = consolidation_sweep(total_fns=800, node_counts=(14, 10),
                                  backend="torch", duration_s=30.0)
        wall = time.perf_counter() - t0
    require(len(res) == len(calls) == 4, f"{len(calls)} simulate calls")
    rate = {}
    for r, (trace, p, out, secs) in zip(res, calls):
        p50, p95, ovh = REF_FIG7[r.policy, r.n_nodes]
        require((r.p50, r.p95) == (p50, p95),
                f"fig7 {r.policy} n={r.n_nodes}: p50, p95 {(r.p50, r.p95)}, "
                f"the reference {(p50, p95)}")
        sim_check(f"fig7 {r.policy} n={r.n_nodes}", r.overhead_frac, ovh,
                  "overhead share")
        N, T, R = trace.arrival_tick.shape
        rate[r.policy, r.n_nodes] = p.n_ticks / secs
        print(f"fig7 {r.policy} n={r.n_nodes}: p50 {r.p50:.4f} s, p95 "
              f"{r.p95:.4f} s, overhead share {r.overhead_frac:.6f}, "
              f"util {r.util_effective:.4f}, done {r.done_ratio:.4f}; one "
              f"loop over N={N} nodes (T={T}, R={R}) on the card: {secs:.3f} "
              f"s, {p.n_ticks / secs:.1f} ticks/s, "
              f"{N * p.n_ticks / secs:.0f} node-ticks/s [{card}]")
    mins = {pol: min_nodes_meeting_slo(res, pol) for pol in ("cfs", "lags")}
    require(mins == {"cfs": 14, "lags": 14},
            f"min_nodes_meeting_slo {mins}, the reference 14 for both")
    print(f"fig7: sweep {wall:.3f} s wall on the card; p50 and p95 equal the "
          f"reference's, overhead within rtol 1e-5; min_nodes_meeting_slo "
          f"{mins}")

    card_call = calls[res.index(next(r for r in res if r.policy == "lags"
                                     and r.n_nodes == 10))]
    asg = place("round-robin", 800, 10, policy=make_policy("lags"),
                exec_s=CLUSTER_EXEC_S, seed=7)
    cpu_calls = []
    with simulate_clock(cpu_calls):
        simulate_fleet("lags", asg, duration_s=30.0, exec_s=CLUSTER_EXEC_S,
                       backend="torch", device="cpu")
    _, p, out, secs = cpu_calls[0]
    require(np.array_equal(out["done_tick"].numpy(),
                           card_call[2]["done_tick"].cpu().numpy()),
            "fig7 lags n=10: completion ticks differ on the card and the CPU")
    rate["lags", 10, "cpu"] = p.n_ticks / secs
    print(f"fig7 lags n=10 on the CPU: the card's completion ticks; "
          f"{secs:.3f} s, {p.n_ticks / secs:.1f} ticks/s, "
          f"{10 * p.n_ticks / secs:.0f} node-ticks/s [{card}]")
    return rate, card_call[0], card_call[1]


def simulators(torch, ops, card):
    """Phases 11 to 13: the tick simulator and the batched fleet."""
    from repro_torch.core import simkernel_torch as st

    ops.reset_launch_counts()
    rate11, trace1, p1 = fig11(torch, card)
    rate7, trace10, p10 = fig7(torch, card)
    n = ops.launch_counts()
    require(not any(n.values()), f"the simulators launched {n}")
    busy = {}
    for label, trace, p in (("one node, Fig. 11 lags", trace1, p1),
                            ("10-node fleet, Fig. 7 lags", trace10, p10)):
        p200 = p._replace(n_ticks=200)
        st.simulate(trace, p200)
        wall_ms, busy_ms = profile(torch, f"simulate {label}, 200 ticks",
                                   lambda: st.simulate(trace, p200),
                                   n_steps=1)
        busy[label] = 100 * busy_ms / wall_ms
    print(f"simulators: Fig. 11 one node {rate11['lags', 'cuda']:.1f} ticks/s "
          f"on the card, {rate11['lags', 'cpu']:.1f} on the CPU (lags); "
          f"Fig. 7 10-node fleet {rate7['lags', 10]:.1f} ticks/s on the card, "
          f"{rate7['lags', 10, 'cpu']:.1f} on the CPU; device busy "
          + ", ".join(f"{k} {v:.1f}%" for k, v in busy.items())
          + f" (profiler on); hand-written kernel launches {json.dumps(n)} "
          f"[{card}]")


# -- phase 14 -------------------------------------------------------------

# The reference at the same calls (JAX 0.9.0 on the CPU; this script
# imports nothing of it): the consolidated LAGS fleet of
# ``benchmarks/fig_chaos_topology.py``, 800 functions placed ``rack-spread``
# on 10 nodes of ``Topology.uniform(10, 2)``, through
# ``repro.fleet.simulate_fleet_chaos("lags", asg, schedule, duration_s=60.0,
# epoch_s=5.0, exec_s=CLUSTER_EXEC_S, topology=topo, backend="jax", ...)``:
# "rack", rack 2's nodes at a 1.8x slowdown from t=5 s and its
# ``rack_crash`` at t=30 s with ``proactive_drain=True,
# drain_enter_ratio=1.35, drain_exit_ratio=1.15``; "partition",
# ``FaultSchedule.single_partition((2, 3), 20.0, 10.0, 10, topo)``.  Each
# is ``chaos_summary`` of the result: the sha256s are of the canonical
# JSON of the latencies (s, float64) and of the migrations as
# [epoch, fn, src, dst]; liveness per epoch is (live, suspect, fenced,
# draining) nodes; busy and switch are summed over every epoch's nodes.
REF_CHAOS = {
    "rack": {
        "n_arrived": 31313,
        "n_completed": 30434,
        "n_latencies": 29276,
        "latency_sum_s": 11539.912,
        "p50": 0.156,
        "p95": 1.6480000000000001,
        "latencies_sha256":
            "9baef6bcd77901ec5b10d898704e6541eb8908425dee1b513de161a1af5c56b9",
        "per_epoch_counts": [
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
            [100, 100, 100, 100, 0, 0, 100, 100, 100, 100],
        ],
        "per_epoch_liveness": [
            [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 2],
            [10, 0, 0, 2], [10, 0, 0, 2], [8, 2, 0, 0], [8, 2, 2, 0],
            [8, 2, 2, 0], [8, 2, 2, 0], [8, 2, 2, 0], [8, 2, 2, 0],
        ],
        "drained": [4, 5],
        "suspects": [4, 5],
        "fenced": [4, 5],
        "n_migrations": 160,
        "migrations_sha256":
            "c7e63e7eebe6d145c4860d07e446d5558b4d27c76e437e90a88d6e23f4e48e5d",
        "lost_arrivals": 0,
        "replayed_arrivals": 0,
        "deferred_arrivals": 0,
        "max_recovery_s": 0.0,
        "busy_s": 4403.084720611572,
        "switch_s": 398.97786062955856,
    },
    "partition": {
        "n_arrived": 31313,
        "n_completed": 31054,
        "n_latencies": 30336,
        "latency_sum_s": 8554.5,
        "p50": 0.152,
        "p95": 1.024,
        "latencies_sha256":
            "f2e89270c3c8590ddb982c8eb33bd54c8f631753c9a4db87d50cad0f238cf64b",
        "per_epoch_counts": [
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
            [80, 80, 80, 80, 80, 80, 80, 80, 80, 80],
        ],
        "per_epoch_liveness": [
            [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 0],
            [10, 2, 0, 0], [10, 0, 2, 0], [10, 0, 0, 0], [10, 0, 0, 0],
            [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 0], [10, 0, 0, 0],
        ],
        "drained": [],
        "suspects": [2, 3],
        "fenced": [2, 3],
        "n_migrations": 0,
        "migrations_sha256":
            "4f53cda18c2baa0c0354bb5f9a3ecbe5ed12ab4d8e11ba873c2f11161202b945",
        "lost_arrivals": 0,
        "replayed_arrivals": 602,
        "deferred_arrivals": 602,
        "max_recovery_s": None,
        "busy_s": 4355.7215584516525,
        "switch_s": 302.32662609778345,
    },
}
CHAOS_EPOCHS, CHAOS_EPOCH_TICKS = 12, 1250  # 60 s in 5 s epochs of 4 ms


def chaos_summary(res):
    """The numbers phase 14 holds to the reference, JSON-able."""
    import hashlib

    import numpy as np

    def sha(x):
        return hashlib.sha256(json.dumps(
            x, separators=(",", ":")).encode()).hexdigest()

    lat = [float(v) for v in np.asarray(res.latencies, np.float64)]
    mig = [[m.epoch, m.fn, m.src, m.dst] for m in res.migrations]
    nodes = [n for e in res.epochs for n in e.fleet.nodes]
    return {
        "n_arrived": int(res.n_arrived), "n_completed": int(res.n_completed),
        "n_latencies": len(lat), "latency_sum_s": float(np.sum(lat)),
        "p50": res.pct(50), "p95": res.pct(95), "latencies_sha256": sha(lat),
        "per_epoch_counts": res.per_epoch_counts(),
        "per_epoch_liveness": [
            [v["live"], v["suspect"], v["fenced"], v["draining"]]
            for v in res.per_epoch_liveness()],
        "drained": sorted({n for e in res.epochs for n in e.draining}),
        "suspects": sorted({n for e in res.epochs for n in e.suspects}),
        "fenced": sorted({n for e in res.epochs for n in e.fenced}),
        "n_migrations": len(mig), "migrations_sha256": sha(mig),
        "lost_arrivals": int(res.lost_arrivals),
        "replayed_arrivals": int(res.replayed_arrivals),
        "deferred_arrivals": int(res.deferred_arrivals),
        "max_recovery_s": res.max_recovery_s(),
        "busy_s": float(sum(n.busy_time_s for n in nodes)),
        "switch_s": float(sum(n.switch_time_s for n in nodes)),
    }


def chaos_run(torch, story, device=None):
    """One ``simulate_fleet_chaos(backend="torch")`` run of phase 14 on
    ``device`` (``None``: the card).  Returns the result, the wall seconds,
    the seconds inside the batched tick loops and inside the
    ``simulate_fleet`` calls, and the ``chaos.*`` obs counters."""
    from repro_torch import obs
    from repro_torch.core import simkernel_torch as st
    from repro_torch.fleet import (CLUSTER_EXEC_S, FaultEvent, FaultSchedule,
                                   Topology, place, rebalance,
                                   simulate_fleet_chaos)

    topo = Topology.uniform(10, 2)
    asg = place("rack-spread", 800, 10, exec_s=CLUSTER_EXEC_S,
                racks=topo.racks())
    kw = dict(duration_s=60.0, epoch_s=5.0, exec_s=CLUSTER_EXEC_S,
              topology=topo, backend="torch", device=device)
    if story == "rack":
        evs = [FaultEvent(5.0, "node_slow", n, factor=1.8)
               for n in topo.nodes_in(2)]
        evs.append(FaultEvent(30.0, "rack_crash", rack=2))
        sched = FaultSchedule(evs, 10, topo)
        kw.update(proactive_drain=True, drain_enter_ratio=1.35,
                  drain_exit_ratio=1.15)
    else:
        sched = FaultSchedule.single_partition((2, 3), 20.0, 10.0, 10, topo)

    loops, fleets = [], []
    obs.enable()
    obs.registry().reset()
    try:
        with clock(st, "simulate", loops), \
                clock(rebalance, "simulate_fleet", fleets):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = simulate_fleet_chaos("lags", asg, sched, **kw)
            wall = time.perf_counter() - t0
        counters = {k: v["value"] for k, v in obs.registry().snapshot().items()
                    if v["type"] == "counter"}
    finally:
        obs.disable()
        obs.registry().reset()
    require(len(loops) == len(fleets) == CHAOS_EPOCHS,
            f"chaos {story}: {len(loops)} tick loops in {len(fleets)} "
            f"simulate_fleet calls, expected {CHAOS_EPOCHS}")
    return (res, wall, sum(c[-1] for c in loops), sum(c[-1] for c in fleets),
            counters)


def check_chaos(story, res, where):
    """``res`` equals the reference's run: counts, sets, migrations,
    latencies and percentiles exactly, busy and switch within SIM_RTOL."""
    got, ref = chaos_summary(res), REF_CHAOS[story]
    require(sorted(got) == sorted(ref), f"chaos {story}: summary keys")
    for k in ref:
        if k in ("busy_s", "switch_s"):
            sim_check(f"chaos {story} on {where}", got[k], ref[k], k)
        else:
            require(got[k] == ref[k], f"chaos {story} on {where}: {k} "
                    f"{got[k]!r}, the reference {ref[k]!r}")
    return got


def chaos(torch, ops, card):
    """Phase 14: the chaos layer on the batched torch fleet at full size."""
    import numpy as np

    ops.reset_launch_counts()
    runs = {}
    for story, device in (("rack", None), ("partition", None),
                          ("partition", "cpu")):
        where = "the card" if device is None else "the CPU"
        res, wall, loop, fleet, counters = chaos_run(torch, story, device)
        s = check_chaos(story, res, where)
        for name, attr in (("replayed", "replayed_arrivals"),
                           ("carried", "carried_arrivals"),
                           ("deferred", "deferred_arrivals")):
            n = counters.get(f"chaos.{name}_arrivals", 0.0)
            require(n == getattr(res, attr), f"chaos {story}: counter "
                    f"chaos.{name}_arrivals {n}, the result "
                    f"{getattr(res, attr)}")
        runs[story, where] = res
        ticks = CHAOS_EPOCHS * CHAOS_EPOCH_TICKS
        print(f"chaos {story} on {where}: {s['n_completed']}/"
              f"{s['n_arrived']} completed, p50 {s['p50']:.4f} s, p95 "
              f"{s['p95']:.4f} s, {s['n_migrations']} migrations, drained "
              f"{s['drained']}, suspects {s['suspects']}, fenced "
              f"{s['fenced']}, lost {s['lost_arrivals']}, replayed "
              f"{s['replayed_arrivals']}, deferred {s['deferred_arrivals']}, "
              f"max recovery {s['max_recovery_s']} s; {wall:.3f} s wall, "
              f"tick loops {loop:.3f} s = {ticks / loop:.1f} epoch ticks/s "
              f"(N=10), controller host {(wall - fleet) / CHAOS_EPOCHS:.4f} "
              f"s an epoch outside simulate_fleet; counters "
              + ", ".join(f"{k} {counters.get(k, 0.0):.0f}" for k in (
                  "chaos.replayed_arrivals", "chaos.carried_arrivals",
                  "chaos.deferred_arrivals")) + f" [{card}]")
    card_b, cpu_b = runs["partition", "the card"], runs["partition", "the CPU"]
    require(np.array_equal(card_b.latencies, cpu_b.latencies),
            "chaos partition: latencies differ on the card and the CPU")
    n = ops.launch_counts()
    require(not any(n.values()), f"the chaos phase launched {n}")
    print("chaos: the rack story and the partition equal the reference on "
          "the card (counts, liveness, node sets, migrations, arrival "
          "ledger, latencies and percentiles; busy and switch within rtol "
          "1e-5); the partition's latencies on the CPU equal the card's; "
          f"hand-written kernel launches {json.dumps(n)}")


# -- phases 15 to 21 ------------------------------------------------------

# (config, overrides) of phase 15: qwen3-moe at G = 16, its full config's
FAMILIES = (("qwen2-moe-a2.7b", {}),
            ("qwen3-moe-235b-a22b", {"n_heads": 16, "n_kv_heads": 1}),
            ("jamba-v0.1-52b", {}), ("gemma3-27b", {}), ("qwen2-vl-7b", {}),
            ("hubert-xlarge", {}))


def family_layerwise(torch, cfg, params, B=2, S=32, n_decode=8):
    """As ``family_end_to_end``, layer by layer: each layer on both devices
    fed the CPU's input to it (no rope: jamba's).  Returns the worst error /
    scale of any layer's output or cache leaf."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.models import blocks, model

    on = {"cpu": params, "cuda": to(params, "cuda")}
    caches = {dev: model.init_cache(cfg, B, S + n_decode, device=dev)
              for dev in on}
    toks = torch.randint(0, cfg.vocab_size, (B, S + n_decode),
                         dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    worst = 0.0
    for start, n in [(0, S)] + [(p, 1) for p in range(S, S + n_decode)]:
        x = params["embed"][toks[:, start:start + n]]
        for i, spec in enumerate(layer_specs(cfg)):
            ys = {}
            for dev in on:
                kv_len = torch.full((B,), start + n, dtype=torch.int32,
                                    device=dev)
                ys[dev], _ = blocks.apply_layer(
                    cfg, spec, on[dev]["layers"][i], x.to(dev), None,
                    caches[dev][i], None if start == 0 else start, kv_len)
            what = f"{cfg.name} layer {i} ({spec.kind}/{spec.mlp}) at {start}"
            worst = max(worst, close(ys["cuda"], ys["cpu"], what))
            for leaf in caches["cpu"][i]:
                worst = max(worst, close(caches["cuda"][i][leaf],
                                         caches["cpu"][i][leaf],
                                         f"{what}: {leaf}"))
            x = ys["cpu"]
    return worst


def check_families_small(torch):
    """Phase 15: the reduced configs of the six families in f32, card
    (kernels) against CPU (plain versions).  Jamba layer by layer: under
    the reference's init its reduced residual reaches ~1e11 and its logits
    move by ~1e-3 when its input moves by 1e-7 (tests/test_torch_families.py),
    so one-ulp differences between cuBLAS and the CPU's products are not
    held end to end."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models.params import init_params

    for name, overrides in FAMILIES:
        cfg = reduced(get_config(name), **overrides)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        layerwise = name.startswith("jamba")
        worst = (family_layerwise if layerwise else family_end_to_end)(
            torch, cfg, params)
        what = ("layer by layer, prefill S=32 + 8 decode steps"
                if layerwise else "prefill S=32" if cfg.encoder_only else
                "prefill S=32 + 8 decode steps, logits and cache leaves")
        print(f"reduced {cfg.name} {json.dumps(overrides)} f32, {what}: card "
              f"(kernels) = CPU (plain versions), worst error / scale "
              f"{worst:.3e}")


@contextlib.contextmanager
def moe_drops(shares):
    """Append the share of (token, k) pairs each ``moe`` call drops at
    capacity to ``shares`` while the block runs."""
    from repro_torch.models import moe

    orig = moe.moe

    def counted(params, x, cfg, *args, **kwargs):
        keep = moe.route(params, x, cfg, *args, **kwargs)[5]
        shares.append(1.0 - float(keep.mean()))
        return orig(params, x, cfg, *args, **kwargs)

    moe.moe = counted
    try:
        yield shares
    finally:
        moe.moe = orig


def serve_moe(torch, ops, serve):
    """Phase 16: qwen2-moe-a2.7b at full width and depth, served through
    ``Engine.attach_model`` with the LAGS credit tick, then prefill."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import model
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_config("qwen2-moe-a2.7b")
    params = init_full(torch, cfg)
    n_tenants, duration, max_len = 1024, 4.5, 256
    tenants, arrivals = serve.build_workload(n_tenants, duration, seed=0)
    eng = Engine(EngineConfig(n_slots=16), tenants, device="cuda")
    eng.attach_model(cfg, params, max_len=max_len)
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = eng.run(duration, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launch_counts()
    busy = st.steps - st.idle_steps
    steps = eng._cache_len
    require(steps == min(busy, max_len - 1) > 0,
            f"{steps} decode steps, want min({busy}, {max_len - 1})")
    require(n["decode_attention"] == cfg.n_layers * steps,
            f"decode_attention launches {n['decode_attention']} != "
            f"{cfg.n_layers} x {steps}")
    require(n["lags_select"] == busy,
            f"lags_select launches {n['lags_select']} != busy steps {busy}")
    tenants_c, arrivals_c = serve.build_workload(n_tenants, duration, seed=0)
    st_c = Engine(EngineConfig(n_slots=16), tenants_c, device="cpu").run(
        duration, arrivals_c)
    require(summary(st) == summary(st_c), "the card's schedule differs from "
            "the CPU engine's on the same workload")
    logits, _ = model.decode_step(params, cfg, {"tokens": eng._tokens},
                                  eng._cache, steps, device="cuda")
    require(bool(torch.isfinite(logits).all()), "non-finite logits")
    del eng
    print(f"engine qwen2-moe-a2.7b: tenants={n_tenants} slots=16 "
          f"steps={st.steps} busy_steps={busy} decode_steps={steps} "
          f"completed={len(st.completed)}/{len(arrivals)} "
          f"membership_changes={st.membership_changes} wall={wall:.2f} s, "
          f"{wall / busy * 1e3:.6g} ms a busy step; the CPU engine's "
          f"schedule is the same; launches={json.dumps(n)}")

    batch = token_batch(torch, cfg, 4, 2048)
    shares = []
    with moe_drops(shares):
        model.prefill(params, cfg, batch, device="cuda")
    print(f"qwen2-moe-a2.7b prefill B=4 S=2048: (token, k) pairs dropped at "
          f"capacity {100 * sum(shares) / len(shares):.3f}% over the "
          f"{len(shares)} MoE layers (per layer {min(shares) * 100:.3f}% to "
          f"{max(shares) * 100:.3f}%)")
    total = dict(n)
    add_counts(total, prefill_full(
        torch, ops, cfg, params, batch, 32, {"flash_attention": cfg.n_layers},
        tail=64, cos_min=None, profile_decode=True))
    return total


def reduced_depth(torch, ops, name, n_layers, B=2, S=2048, n_decode=32):
    """Phases 17-18: a config at full width with its first ``n_layers``
    layers: prefill, then ``n_decode`` decode steps; launch counts and
    finite logits."""
    import dataclasses

    from repro_torch.configs.base import get_config, layer_specs
    from repro_torch.models.mamba import CHUNK

    full = get_config(name)
    cfg = dataclasses.replace(full, n_layers=n_layers)
    note = f" ({n_layers} of {full.n_layers} layers)"
    params = init_full(torch, cfg, note)
    specs = layer_specs(cfg)
    launches = {"flash_attention": sum(s.kind == "attn" for s in specs),
                "ssm_scan": sum(s.kind == "mamba" for s in specs)
                * -(-S // CHUNK)}
    total = prefill_full(torch, ops, cfg, params,
                         token_batch(torch, cfg, B, S), n_decode, launches,
                         tail=0, label=cfg.name + note)
    del params
    torch.cuda.empty_cache()
    return total


def families_full(torch, ops, counts):
    """Phases 19-21: gemma3-27b, qwen2-vl-7b and hubert-xlarge at full width
    and depth."""
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import flash_attention as fa

    cfg = get_config("gemma3-27b")
    t0 = time.perf_counter()
    params = init_full(torch, cfg)
    # past the window of 1024 in prefill and in every decode step
    add_counts(counts, prefill_full(
        torch, ops, cfg, params, token_batch(torch, cfg, 2, 1536), 64,
        {"flash_attention": cfg.n_layers}))
    del params
    torch.cuda.empty_cache()
    print(f"phase 19 gemma3-27b: {time.perf_counter() - t0:.1f} s wall")

    cfg = get_config("qwen2-vl-7b")
    t0 = time.perf_counter()
    params = init_full(torch, cfg)
    add_counts(counts, prefill_full(
        torch, ops, cfg, params, family_batch(torch, cfg, 4, 2048, "cuda"),
        32, {"flash_attention": cfg.n_layers}))
    del params
    torch.cuda.empty_cache()
    print(f"phase 20 qwen2-vl-7b: {time.perf_counter() - t0:.1f} s wall")

    cfg = get_config("hubert-xlarge")
    t0 = time.perf_counter()
    params = init_full(torch, cfg)
    route = fa.route(torch.bfloat16, cfg.head_dim)
    require(route == "fa_mma", f"hubert's D=80 takes {route}, not fa_mma")
    add_counts(counts, prefill_full(
        torch, ops, cfg, params, family_batch(torch, cfg, 4, 2048, "cuda"),
        0, {"flash_attention": cfg.n_layers}, tail=0,
        label=f"{cfg.name} (encoder-only, {route})"))
    del params
    torch.cuda.empty_cache()
    print(f"phase 21 hubert-xlarge: {time.perf_counter() - t0:.1f} s wall")


# -- phases 22 to 27: training -------------------------------------------


# the attention and scan shapes of the training steps of phases 25-26
STABLELM_TRAIN = dict(B=8, H=32, Hkv=32, S=2048, D=64)  # stablelm-1.6b
QWEN_TRAIN = dict(B=4, H=32, Hkv=8, S=2048, D=128)  # qwen3-8b, 4 layers
MAMBA_TRAIN_CHUNK = dict(B=2, S=256, I=8192, N=16)  # falcon-mamba, 8 layers
# bf16 results are held to TOL element by element AND, over each 64-row tile
# of each (b, head), to ||got - want|| <= BF16_TILE_REL * (||want|| +
# TILE_FLOOR * sqrt(n)), n the tile's values.  At the training shapes |dk|
# and |dv| fall to ~3e-3 on late keys and |dq| is ~2e-2, so TOL's atol of
# 2e-2 alone would pass a tile off by 30%; the tile's norm does not.  The
# limit is phase 4's for the forward: the backward's worst tile measured
# 1.4e-3 (qwen3-8b's dq), the positioned forward's 3.3e-3.  The floor, 1/30
# of the smallest gradients compared, keeps tiles whose exact value is 0
# (S = 1: dS = dP - Delta, where the kernel leaves ~1e-6 of rounding) from
# dividing noise by noise.
BF16_TILE_REL = 1e-2
TILE_FLOOR = 1e-4


def tile_rel(got, want, tile=64, floor=TILE_FLOOR):
    """max over (b, h, 64-row tile) of ||got - want|| / (||want|| + floor *
    sqrt(n)), n the tile's values; any S."""
    import torch
    import torch.nn.functional as F

    B, H, S, D = want.shape
    pad = (0, 0, 0, (-S) % tile)
    d = F.pad(got.float() - want.float(), pad).reshape(B, H, -1, tile * D)
    w = F.pad(want.float(), pad).reshape(B, H, -1, tile * D)
    rows = torch.full((S,), float(D), device=want.device)
    n = F.pad(rows, (0, (-S) % tile)).reshape(-1, tile).sum(-1)
    den = (w.norm(dim=-1) + floor * n.sqrt()).clamp_min(1e-30)
    return float((d.norm(dim=-1) / den).max())


def close_kernel(got, want, dtype, name, quiet=False):
    """f32 at TOL; bf16 at TOL and at BF16_TILE_REL over each 64-row tile of
    each (b, head).  Returns (max abs error, tile error; 0 for f32); prints
    them unless ``quiet``."""
    ok, err, bad = within(got, want, TOL[dtype])
    require(ok, f"{name}: {bad} values outside {TOL[dtype]}, max err {err}")
    if dtype != "bfloat16":
        if not quiet:
            print(f"{name}: max_abs_err={err:.3e} within {TOL[dtype]}")
        return err, 0.0
    r = tile_rel(got, want)
    require(r <= BF16_TILE_REL, f"{name}: a 64-row tile's error {r:.3e} > "
            f"{BF16_TILE_REL} (max abs err {err:.3e})")
    if not quiet:
        print(f"{name}: max_abs_err={err:.3e} within {TOL[dtype]}; 64-row "
              f"tile error {r:.3e} <= {BF16_TILE_REL} (without the floor "
              f"{tile_rel(got, want, floor=0.0):.3e})")
    return err, r


def train_positions(torch, gen, B, S):
    """(B, S) int32 positions from 2, rising by 0, 1 or 2 a row: repeats
    and gaps, so the masks by position differ from those by index."""
    steps = torch.randint(0, 3, (B, S), generator=gen, device="cuda")
    return (torch.cumsum(steps, 1) + 2).to(torch.int32)


def check_flash_train(torch, fa):
    """Phase 22, attention: the positioned forward (fa_mma, fa_fwd) and the
    backward kernels, each call on its route (bf16 at D 64 and 128 without
    positions on the wgmma route, given no L: the wrapper runs the forward
    for it), against their plain versions."""
    gen = torch.Generator(device="cuda").manual_seed(11)
    # (B, H, Hkv, S, D, causal, window, positions, dtypes): the reference's
    # test shapes at G=1, GQA, S=1, ragged S, D=80 non-causal, positions
    # with and without a window (the training shapes are in
    # check_flash_bwd_wgmma)
    both = ("float32", "bfloat16")
    cases = [(1, 1, 1, 128, 64, True, 0, False, both),
             (2, 2, 2, 256, 128, True, 128, False, both),
             (2, 2, 2, 256, 128, False, 0, False, both),
             (2, 8, 2, 300, 64, True, 64, False, both),
             (1, 8, 1, 1, 128, True, 0, False, both),
             (1, 4, 2, 77, 16, True, 0, False, both),
             (2, 4, 4, 200, 80, False, 0, False, both),
             (2, 4, 2, 100, 64, True, 0, True, both),
             (1, 4, 1, 90, 32, False, 30, True, both),
             (2, 8, 2, 300, 128, True, 64, True, both)]
    for B, H, Hkv, S, D, causal, window, posn, dtypes in cases:
        for dtype in dtypes:
            q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, dtype)
            do = flash_inputs(torch, gen, B, H, H, S, D, dtype)[0]
            pos = train_positions(torch, gen, B, S) if posn else None
            kw = dict(causal=causal, window=window, q_pos=pos, k_pos=pos)
            name = (f"{dtype} B={B} H={H} Hkv={Hkv} S={S} D={D} "
                    f"causal={causal} window={window} positions={posn}")
            o = fa.flash_attention(q, k, v, **kw)
            o_p = fa.flash_attention_plain(q, k, v, **kw)
            torch.cuda.synchronize()
            if posn:
                close_kernel(o, o_p, dtype, f"flash_attention "
                             f"{fa.route(q.dtype, D, True)} {name}")
            before = fa.bwd_launches
            got = fa.flash_attention_bwd(q, k, v, o, do, **kw)
            want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
            torch.cuda.synchronize()
            require(fa.bwd_launches == before + 1, "one backward launch")
            for t, g, w in zip("qkv", got, want):
                close_kernel(g, w, dtype, f"flash_attention_bwd "
                             f"{fa.bwd_route(q.dtype, D, posn)} d{t} {name}")
            del got, want, o, o_p
    torch.cuda.empty_cache()


# the wgmma backward's grid in phase 22
BWD_WGMMA_MASKS = [(True, 0), (True, 128), (False, 0)]
BWD_WGMMA_GROUPS = (1, 2, 4, 8, 16)
BWD_WGMMA_S = (1, 77, 300, 2048)


def check_flash_bwd_wgmma(torch, fa):
    """Phase 22, the wgmma backward route: at D 64 and 128, each mask of
    ``BWD_WGMMA_MASKS``, G in ``BWD_WGMMA_GROUPS`` and S in ``BWD_WGMMA_S``
    (B=2 and two KV heads below S=2048, one of each at it), the forward's L
    against ``flash_attention_lse_plain`` at f32 TOL with its output
    bit-equal to the no-gradient build's, then dq, dk, dv from that L
    against ``flash_attention_bwd_plain`` as ``close_kernel`` holds them.
    At the two training shapes both routes (``mma`` by name), and two
    wgmma calls at stablelm's must give equal bits.  Returns {(shape,
    route): (max abs error, tile error)} of the training shapes."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(16)

    def one(B, H, Hkv, S, D, causal, window, route=None, twice=False):
        q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, "bfloat16")
        do = flash_inputs(torch, gen, B, H, H, S, D, "bfloat16")[0]
        kw = dict(causal=causal, window=window)
        name = (f"flash_attention_bwd {route or 'fa_bwd_wgmma'} B={B} H={H} "
                f"Hkv={Hkv} S={S} D={D} causal={causal} window={window}")
        o0 = fa.flash_attention(q, k, v, **kw)
        o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        lse_err = within(lse, fa.flash_attention_lse_plain(q, k, **kw),
                         TOL["float32"])
        n0 = ops.launch_counts()
        if route is None:
            got = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
        else:
            got = fa.flash_attention_bwd(q, k, v, o, do, route=route, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
        torch.cuda.synchronize()
        require(torch.equal(o, o0), f"{name}: the L-writing forward's output "
                "differs from the no-gradient build's")
        require(lse_err[0], f"{name}: L has {lse_err[2]} values outside "
                f"{TOL['float32']} of the plain L, max err {lse_err[1]}")
        n1 = ops.launch_counts()
        r = route or "fa_bwd_wgmma"
        require(n1[r] == n0[r] + 1 and n1["flash_attention_bwd"]
                == n0["flash_attention_bwd"] + 1, f"{name}: backward launches "
                f"{ {k: n1[k] - n0[k] for k in fa.BWD_ROUTES} }, want one {r}")
        res = [close_kernel(g, w, "bfloat16", f"{name} d{t}", quiet=True)
               for t, g, w in zip("qkv", got, want)]
        err, tile = max(e for e, _ in res), max(r for _, r in res)
        same = ""
        if twice:
            again = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
            torch.cuda.synchronize()
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{name}: two calls differ")
            same = "; a second call bit-equal"
        print(f"{name}: L max err {lse_err[1]:.3e}, out bit-equal to the "
              f"no-gradient build's; dq, dk, dv max_abs_err={err:.3e} within "
              f"{TOL['bfloat16']}, 64-row tile error {tile:.3e} <= "
              f"{BF16_TILE_REL}{same}")
        return err, tile

    t0 = time.perf_counter()
    n_cases = 0
    for D in fa.WGMMA_DIMS:
        for causal, window in BWD_WGMMA_MASKS:
            for G in BWD_WGMMA_GROUPS:
                for S in BWD_WGMMA_S:
                    B, Hkv = (2, 2) if S < 2048 else (1, 1)
                    one(B, G * Hkv, Hkv, S, D, causal, window)
                    n_cases += 1
    errs = {}
    for shape in (STABLELM_TRAIN, QWEN_TRAIN):
        for route in (None, "fa_bwd_mma"):
            errs[(tuple(shape.values()), route or "fa_bwd_wgmma")] = one(
                *shape.values(), True, 0, route=route,
                twice=route is None and shape is STABLELM_TRAIN)
    torch.cuda.empty_cache()
    print(f"phase 22 wgmma backward: {n_cases} grid cases and the training "
          f"shapes, {time.perf_counter() - t0:.1f} s wall")
    return errs


def check_decode_positions(torch, dec):
    """Phase 22, decode: rows [kv_start, kv_len) of the cache against the
    plain version at phase 9's shape (G=4) and at G=16, with an empty range
    (0) and ranges on and beside a split's edge."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    for dtype in ("float32", "bfloat16"):
        for H, Hkv in ((32, 8), (64, 4)):
            B, L, D = 4, 2112, 128
            kv_len = [2100, 5, 1500, 700]
            q, k, v, kv = dec_inputs(torch, gen, B, H, Hkv, L, D, dtype,
                                     kv_len)
            start = torch.tensor([1000, 5, 0, 640], dtype=torch.int32,
                                 device="cuda")
            got = dec.decode_attention(q, k, v, kv, kv_start=start)
            want = dec.decode_attention_plain(q, k, v, kv, kv_start=start)
            torch.cuda.synchronize()
            ok, err, bad = within(got, want, TOL[dtype])
            name = (f"decode_attention kv_start {dtype} B={B} H={H} "
                    f"Hkv={Hkv} L={L}")
            require(ok, f"{name}: {bad} values outside {TOL[dtype]}, "
                    f"max err {err}")
            require(int(torch.count_nonzero(got[1])) == 0,
                    f"{name}: an empty range must give 0")
            print(f"{name}: max_abs_err={err:.3e} within {TOL[dtype]}, the "
                  f"empty range 0")


def check_ssm_train(torch, ssm):
    """Phase 22, the scan's backward kernels fed by the forward's
    checkpoints, against the plain backward (which recomputes every state
    from h0), at the reference's shapes, ragged S, without dy or dh_last,
    and one chunk of the falcon-mamba training step.  The checkpoint-writing
    forward's y and h_last must equal the plain build's bit for bit, its
    checkpoints the plain version's within SSM_TOL; at the training chunk
    two backward calls must give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    cases = [(1, 128, 256, 8, True, True), (2, 256, 512, 16, True, True),
             (2, 37, 64, 16, True, False), (1, 5, 32, 4, False, True),
             (2, 17, 48, 16, True, True), (1, 1, 64, 16, True, True),
             tuple(MAMBA_TRAIN_CHUNK.values()) + (True, True)]
    errs = {}
    for B, S, I, N, with_dy, with_dh in cases:
        dA, dBx, C, h0 = ssm_inputs(torch, gen, B, S, I, N)
        dy = (torch.randn(B, S, I, generator=gen, device="cuda")
              if with_dy else None)
        dh = (torch.randn(B, I, N, generator=gen, device="cuda")
              if with_dh else None)
        name = f"ssm_scan_bwd float32 B={B} S={S} I={I} N={N}"
        y, h_last, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
        y0, h_last0 = ssm.ssm_scan(dA, dBx, C, h0)
        require(torch.equal(y, y0) and torch.equal(h_last, h_last0),
                f"{name}: the checkpoint-writing forward is not bit-equal "
                f"to the plain build")
        ok, err_ck, bad = within(hck, ssm.ssm_scan_ckpt_plain(dA, dBx, h0),
                                 SSM_TOL)
        require(ok, f"{name} checkpoints: {bad} values outside {SSM_TOL}, "
                f"max err {err_ck}")
        got = ssm.ssm_scan_bwd(dA, dBx, C, h0, dy, dh, hck)
        want = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh)
        torch.cuda.synchronize()
        worst = 0.0
        for t, g, w in zip(("dA", "dBx", "C", "h0"), got, want):
            ok, err, bad = within(g, w, SSM_TOL)
            require(ok, f"{name} d{t}: {bad} values outside {SSM_TOL}, max "
                    f"err {err}")
            worst = max(worst, err)
        errs[(B, S, I, N)] = worst
        again = ""
        if (B, S, I, N) == tuple(MAMBA_TRAIN_CHUNK.values()):
            second = ssm.ssm_scan_bwd(dA, dBx, C, h0, dy, dh, hck)
            require(all(torch.equal(a, b) for a, b in zip(got, second)),
                    f"{name}: two backward calls differ")
            again = "; two calls bit-equal"
        print(f"{name} dy={with_dy} dh_last={with_dh}: max_abs_err="
              f"{worst:.3e} within {SSM_TOL}, checkpoints {err_ck:.3e}, "
              f"forward builds bit-equal" + again)
    return errs


def time_flash_bwd(torch, fa, timer, B, H, Hkv, S, D, dtype="bfloat16"):
    """Phase 23: the backward kernels of the wgmma route (given the
    forward's L, as training runs them) and of the ``mma`` route (PR 18's,
    by name), timed in turns on one card (wgmma, mma, mma, wgmma; each the
    mean of its two), beside their plain version and, as a yardstick the
    port never calls, the backward of ``scaled_dot_product_attention``
    (autograd of one SDPA call); then the forward with and without L."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(14)
    q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, dtype)
    do = flash_inputs(torch, gen, B, H, H, S, D, dtype)[0]
    o, lse = fa.flash_attention_with_lse(q, k, v)
    runs = {}
    for route in ("fa_bwd_wgmma", "fa_bwd_mma", "fa_bwd_mma", "fa_bwd_wgmma"):
        kw = dict(lse=lse) if route == "fa_bwd_wgmma" else dict(route=route)
        runs.setdefault(route, []).append(timer.ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, do, **kw), iters=10))
    fwd = {}
    for label, fn in (("no L", lambda: fa.flash_attention(q, k, v)),
                      ("with L", lambda: fa.flash_attention_with_lse(q, k, v)),
                      ("with L", lambda: fa.flash_attention_with_lse(q, k, v)),
                      ("no L", lambda: fa.flash_attention(q, k, v))):
        fwd.setdefault(label, []).append(timer.ms(fn, iters=10))
    plain_ms = timer.ms(lambda: fa.flash_attention_bwd_plain(q, k, v, o, do),
                        iters=3, warmup=1)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True,
                                         enable_gqa=True)
    lib_ms = library_ms(torch, timer, "SDPA backward",
                        lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                    retain_graph=True),
                        iters=10)
    esize = 2 if dtype == "bfloat16" else 4
    # q, o, dO in and dQ out (H heads); k, v in and dK, dV out (Hkv heads)
    n_bytes = B * S * D * esize * (4 * H + 4 * Hkv)
    pairs = S * (S + 1) // 2  # (query, key) pairs the causal mask keeps
    # five products: S, dP, dV, dK, dQ, 2 flops a multiply-add
    n_ops = 5 * 2 * pairs * D * B * H
    b, by = bound_ms(n_bytes, n_ops, dtype)
    del out, qs, ks, vs
    torch.cuda.empty_cache()
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(ms=mean(runs["fa_bwd_wgmma"]), plain_ms=plain_ms,
                library_ms=lib_ms, bound_ms=b, bound_by=by,
                runs_ms=runs["fa_bwd_wgmma"],
                mma=dict(ms=mean(runs["fa_bwd_mma"]), plain_ms=plain_ms,
                         library_ms=lib_ms, bound_ms=b, bound_by=by,
                         runs_ms=runs["fa_bwd_mma"]),
                forward_ms={k: mean(v) for k, v in fwd.items()})


def backward_times(torch, fa, ssm, card):
    """Phase 23: ``time_flash_bwd`` at stablelm-1.6b's and qwen3-8b's
    training shapes and ``time_ssm_bwd`` at falcon-mamba's chunk, printed
    with their ratios; the wgmma route must beat the ``mma`` route at both
    attention shapes.  Returns the three timings."""
    timer = Timer(torch)
    stablelm = time_flash_bwd(torch, fa, timer, **STABLELM_TRAIN)
    qwen3 = time_flash_bwd(torch, fa, timer, **QWEN_TRAIN)
    scan = time_ssm_bwd(torch, ssm, timer, **MAMBA_TRAIN_CHUNK)
    del timer
    rows = []
    for shape, t in (("B=8 H=32 Hkv=32 S=2048 D=64", stablelm),
                     ("B=4 H=32 Hkv=8 S=2048 D=128", qwen3)):
        rows += [(f"flash_attention_bwd fa_bwd_wgmma bf16 causal {shape}", t),
                 (f"flash_attention_bwd fa_bwd_mma bf16 causal {shape}",
                  t["mma"])]
        print(f"time flash_attention forward bf16 causal {shape}: " + ", ".join(
            f"{k} {v:.6g} ms" for k, v in t["forward_ms"].items())
            + f" (each the mean of two, in turns) [{card}]")
    for name, t in rows + [("ssm_scan_bwd f32 B=2 S=256 I=8192 N=16", scan)]:
        ratio = (f" x_library={t['ms'] / t['library_ms']:.3f}"
                 if t["library_ms"] else "")
        print(f"time {name}: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items() if k not in ("mma", "forward_ms", "timer"))
            + f" x_bound={t['ms'] / t['bound_ms']:.3f}" + ratio + f" [{card}]")
    print_ssm_timing(ssm, scan, MAMBA_TRAIN_CHUNK, card)
    for shape, t in ((STABLELM_TRAIN, stablelm), (QWEN_TRAIN, qwen3)):
        require(t["ms"] < t["mma"]["ms"], f"flash_attention_bwd at {shape}: "
                f"the wgmma route's {t['ms']:.4f} ms is not below the mma "
                f"route's {t['mma']['ms']:.4f} ms")
    require(scan["ms"] < SSM_BWD_TWO_PASS_MS, f"ssm_scan_bwd at "
            f"{MAMBA_TRAIN_CHUNK}: {scan['ms']:.4f} ms is not below the "
            f"two-pass kernel's {SSM_BWD_TWO_PASS_MS} ms")
    return stablelm, qwen3, scan


def card_state():
    """What ``nvidia-smi`` reads of the card now: power, GPU and memory
    temperatures, SM and memory clocks, active throttle reasons."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=power.draw,temperature.gpu,"
         "temperature.memory,clocks.sm,clocks.mem,"
         "clocks_throttle_reasons.active", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()


def print_ssm_timing(ssm, scan, shape, card):
    """Phase 23's scan lines: the forward's two builds, the backward beside
    the two-pass kernel it replaced and the checkpoints the forward writes
    for it, and what each timed call saw (``Timer.last``)."""
    B, S, I, N = shape.values()
    f = scan["forward_ms"]
    ckpt_bytes = 4 * B * -(-S // ssm.SEG) * I * N
    print(f"time ssm_scan forward f32 B={B} S={S} I={I} N={N}: plain "
          f"{f['plain']:.6g} ms, with checkpoints {f['ckpt']:.6g} ms "
          f"({100 * (f['ckpt'] / f['plain'] - 1):+.2f}%; each the mean of "
          f"two, in turns; the checkpoints {ckpt_bytes / 1e6:.6g} MB, "
          f"{ckpt_bytes / HBM_BYTES_PER_S * 1e3:.6g} ms at the card's "
          f"rate); the backward {scan['ms']:.6g} ms against the two-pass "
          f"kernel's {SSM_BWD_TWO_PASS_MS} ms "
          f"({scan['ms'] / SSM_BWD_TWO_PASS_MS:.3f}x) [{card}]")
    for label, seen in scan["timer"]:
        ms = seen["calls_ms"]
        print(f"  timer {label}: calls ms [{', '.join(f'{x:.6g}' for x in ms)}]"
              f" min {min(ms):.6g} max {max(ms):.6g}; host ms max "
              f"{max(seen['host_ms']):.4g}; late calls {seen['late']}; SM "
              f"clock {min(seen['clock_mhz']):.0f}-"
              f"{max(seen['clock_mhz']):.0f} MHz; collections "
              f"{len(seen['gc_ms'])} ({sum(seen['gc_ms']):.3g} ms); card "
              f"before (power, temperatures, clocks, throttle reasons): "
              f"{seen['card_before']}")


# ms of the two-pass ``ssm_scan_bwd`` that the single-pass kernel replaced
# (ssm_bwd_ckpt + ssm_bwd + ssm_bwd_dc, which read dA and dBx twice), at
# MAMBA_TRAIN_CHUNK on an NVIDIA H100 80GB HBM3 at 700.00 W by this script's
# phase 23 (PERF.md): phase 23 requires the kernel to beat it
SSM_BWD_TWO_PASS_MS = 0.818613


def time_ssm_bwd(torch, ssm, timer, B, S, I, N):
    """Phase 23: the backward kernels given the forward's checkpoints, as
    training runs them, beside their plain version and bound, and the
    forward's plain and checkpoint-writing builds, all in turns (backward,
    plain, ckpt, ckpt, plain, backward; each the mean of its two, the
    backward's two under ``runs_ms``)."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    dA, dBx, C, h0 = ssm_inputs(torch, gen, B, S, I, N)
    dy = torch.randn(B, S, I, generator=gen, device="cuda")
    dh = torch.randn(B, I, N, generator=gen, device="cuda")
    hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)[2]
    bwd = lambda: ssm.ssm_scan_bwd(dA, dBx, C, h0, dy, dh, hck)  # noqa: E731
    plain = lambda: ssm.ssm_scan(dA, dBx, C, h0)  # noqa: E731
    ckpt = lambda: ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)  # noqa: E731
    runs, seen = {}, []
    for label, fn in (("bwd", bwd), ("plain", plain), ("ckpt", ckpt),
                      ("ckpt", ckpt), ("plain", plain), ("bwd", bwd)):
        state = card_state()
        runs.setdefault(label, []).append(timer.ms(fn, iters=10))
        seen.append((label, dict(timer.last, card_before=state)))
    plain_ms = timer.ms(lambda: ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy,
                                                       dh), iters=3, warmup=1)
    # f32: dA, dBx, C, h0, dy, dh_last in; d(dA), d(dBx), dC, dh0 out
    n_bytes = 4 * (4 * B * S * I * N + 2 * B * S * N + 3 * B * I * N
                   + B * S * I)
    # dh (multiply-add), d(dA), the carried dA * dh, dC (multiply-add)
    n_ops = 6 * B * S * I * N
    b, by = bound_ms(n_bytes, n_ops, "float32")
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    # no one PyTorch call computes a selective scan or its gradient
    return dict(ms=mean(runs["bwd"]), plain_ms=plain_ms, library_ms=None,
                bound_ms=b, bound_by=by, runs_ms=runs["bwd"],
                forward_ms={k: mean(runs[k]) for k in ("plain", "ckpt")},
                timer=seen)


def bwd_entry(fa, counts, errs, stablelm, qwen3):
    """The kernels line's ``flash_attention_bwd``: the wgmma route that
    training runs, at stablelm-1.6b's shape and (``qwen3``) qwen3-8b's,
    with PR 18's ``mma`` route under ``mma``."""
    shapes = {"stablelm": (STABLELM_TRAIN, stablelm),
              "qwen3": (QWEN_TRAIN, qwen3)}

    def numbers(route, which):
        shape, t = shapes[which]
        t = t if route == "fa_bwd_wgmma" else t["mma"]
        err, tile = errs[(tuple(shape.values()), route)]
        B, H, Hkv, S, D = shape.values()
        return dict(shape=f"B={B} H={H} Hkv={Hkv} S={S} D={D} causal bf16",
                    max_abs_err=err, max_tile_rel_err=tile, **{
                        k: v for k, v in t.items()
                        if k not in ("mma", "forward_ms")})

    return dict(
        name="flash_attention_bwd", route="cuda",
        kernel="fa_bwd_dq_wgmma + fa_bwd_dkdv_wgmma",
        source="src/repro_torch/kernels/csrc/flash_attention_bwd_wgmma.cu",
        replaces="src/repro/kernels/flash_attention.py:77",
        replaces_note=("the TPU kernel has no backward: the reference "
                       "differentiates src/repro/models/attention.py:46 "
                       "(_attend_chunk) with XLA"),
        launches=counts["fa_bwd_wgmma"],
        launches_by_route={r: counts[r] for r in fa.BWD_ROUTES},
        **numbers("fa_bwd_wgmma", "stablelm"),
        qwen3=numbers("fa_bwd_wgmma", "qwen3"),
        mma=dict(kernel=("fa_bwd_dq_mma + fa_bwd_dkdv_mma (bf16 with "
                         "positions or other head dims; f32: fa_bwd_dq_f32 "
                         "+ fa_bwd_dkdv_f32)"),
                 source="src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                 launches=counts["fa_bwd_mma"],
                 **numbers("fa_bwd_mma", "stablelm"),
                 qwen3=numbers("fa_bwd_mma", "qwen3")))


def check_train_small(torch):
    """Phase 24: reduced configs in f32, the card (kernels, forward and
    backward, remat on) against the CPU (plain versions): the loss and
    every gradient leaf of ``train_loss``, then one train step (AdamW,
    clipping) whose loss and gradient norm agree.  Gradients are held to
    1e-3 of each leaf's scale: the reduced stablelm's and qwen2-vl's move
    by ~1e-3 of their scale under 1e-7 input noise in the reference itself
    (tests/test_torch_train.py).  On qwen3-8b (G=2), whose gradients agree
    to ~1e-6 of their scale, the step's updated parameters and moments are
    held to 1e-6 as tests/test_torch_train.py holds them to the reference
    (clip 1e-3, active); the ill-conditioned configs cannot hold that: the
    first AdamW step moves each parameter by lr * g / (|g| + eps), which
    turns a gradient's relative error into the update's where |g| is near
    eps."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model
    from repro_torch.models.params import init_params
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.tree import leaves

    for name, overrides in (("stablelm-1.6b", {}),
                            ("qwen3-8b", {"n_kv_heads": 2}),
                            ("falcon-mamba-7b", {"n_layers": 2}),
                            ("gemma3-27b", {}), ("qwen2-vl-7b", {})):
        cfg = reduced(get_config(name), **overrides)
        batch = TokenStream(cfg, 2, 128, DataConfig()).batch_at(0)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        exact = name == "qwen3-8b"
        tc = train_loop.TrainConfig(opt=optimizer.OptConfig(
            lr=1e-3, warmup_steps=0, **({"clip_norm": 1e-3} if exact else {})))
        grads, steps, states = {}, {}, {}
        for dev in ("cpu", "cuda"):
            p = to(to(params, "cuda"), dev)  # a copy of its own on each
            for t in leaves(p):
                t.requires_grad_(True)
            loss, _ = model.train_loss(p, cfg, to({
                k: torch.from_numpy(v) for k, v in batch.items()}, dev),
                device=dev)
            grads[dev] = (float(loss.detach()),
                          torch.autograd.grad(loss, leaves(p)))
            state = train_loop.TrainState(p, optimizer.init_state(p))
            states[dev], m = train_loop.make_train_step(cfg, tc)(state,
                                                                 batch)
            steps[dev] = (float(m["loss"]), float(m["grad_norm"]))
        (l_card, g_card), (l_cpu, g_cpu) = grads["cuda"], grads["cpu"]
        require(abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu),
                f"{name}: loss {l_card} on the card, {l_cpu} on the CPU")
        worst = 0.0
        for a, b in zip(g_card, g_cpu):
            err = float((a.cpu() - b).abs().max())
            scale = max(float(b.abs().max()), 1e-30)
            require(err <= 1e-3 * scale, f"{name}: a gradient leaf differs "
                    f"by {err}, scale {scale}")
            worst = max(worst, err / scale)
        (sl_card, n_card), (sl_cpu, n_cpu) = steps["cuda"], steps["cpu"]
        require(abs(sl_card - sl_cpu) <= 1e-5 * abs(sl_cpu)
                and abs(n_card - n_cpu) <= 1e-4 * n_cpu,
                f"{name}: train step loss {sl_card} / {sl_cpu}, grad norm "
                f"{n_card} / {n_cpu} (card / CPU)")
        upd = ""
        if exact:
            require(n_cpu > 1e-3, f"{name}: the clip is not active")
            upd_err = 0.0
            for what in ("params", "mu", "nu"):
                tree = {d: (states[d].params if what == "params"
                            else getattr(states[d].opt, what))
                        for d in states}
                for a, b in zip(leaves(tree["cuda"]), leaves(tree["cpu"]),
                                strict=True):
                    e = float((a.detach().cpu() - b.detach()).abs().max())
                    require(e <= 1e-6, f"{name}: after one step a {what} leaf "
                            f"differs by {e} (card / CPU)")
                    upd_err = max(upd_err, e)
            upd = (f"; updated params, mu and nu (clip 1e-3) max abs error "
                   f"{upd_err:.3e} <= 1e-6")
        print(f"reduced {name} f32 (B=2, S=128): card = CPU, loss "
              f"{l_card:.6f} vs {l_cpu:.6f}, gradients worst error / scale "
              f"{worst:.3e}; one train step's grad norm {n_card:.6f} vs "
              f"{n_cpu:.6f}" + upd)


def train_profile(torch, cfg, B, S, label):
    """One train step under the profiler after one untimed step: kernel
    time by name and the backward kernels' share of it."""
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.data import DataConfig, TokenStream

    state = train_loop.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=optimizer.OptConfig(lr=1e-3, warmup_steps=0)))
    batch = TokenStream(cfg, B, S, DataConfig()).batch_at(0)
    step(state, batch)
    rows = []
    _, busy = profile(torch, label, lambda: step(state, batch), n_steps=1,
                      rows_out=rows)
    fa_ms = sum(r[0] for r in rows if "fa_bwd" in r[2])
    ssm_ms = sum(r[0] for r in rows if "ssm_bwd" in r[2])
    fwd_ms = sum(r[0] for r in rows if "ssm_fwd" in r[2])
    print(f"profile {label}: flash_attention_bwd {fa_ms:.3f} ms "
          f"({100 * fa_ms / busy:.1f}% of kernel time), ssm_scan_bwd "
          f"{ssm_ms:.3f} ms ({100 * ssm_ms / busy:.1f}%), ssm_scan forward "
          f"{fwd_ms:.3f} ms ({100 * fwd_ms / busy:.1f}%)")
    del state
    torch.cuda.empty_cache()


def check_losses(name, losses):
    require(all(math.isfinite(x) for x in losses),
            f"{name}: a loss is not finite: {losses}")
    tail = losses[-3:]
    require(sum(tail) / len(tail) < losses[0],
            f"{name}: the mean of the last 3 losses {tail} is not below the "
            f"first {losses[0]}")


def train_stablelm(torch, ops, steps=10, B=8, S=2048):
    """Phase 25: stablelm-1.6b at full width and depth (24 layers, 1.645 B
    params, bf16) trains ``steps`` steps through
    ``repro_torch.launch.train.main``, the train CLI: finite losses whose
    last three average below the first, launch counts, step time, tokens/s
    and peak memory; then a profile of one step."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import train as train_cli

    cfg = get_config("stablelm-1.6b")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = train_cli.main(["--arch", cfg.name, "--steps", str(steps),
                          "--batch", str(B), "--seq", str(S)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n = ops.launch_counts()
    losses = out["losses"]
    check_losses(cfg.name, losses)
    n_attn = cfg.n_layers
    want = {"flash_attention_bwd": n_attn * steps,
            "fa_bwd_wgmma": n_attn * steps, "fa_bwd_mma": 0, "fa_bwd_f32": 0,
            # remat runs each layer's forward again in the backward pass
            "flash_attention": 2 * n_attn * steps}
    for kernel, w in want.items():
        require(n[kernel] == w, f"{cfg.name}: {kernel} launches {n[kernel]} "
                f"!= {w}")
    step_s = sorted(out["seconds"][1:])[len(out["seconds"][1:]) // 2]
    print(f"phase 25 {cfg.name} train (B={B}, S={S}, {steps} steps through "
          f"launch.train.main): {wall:.1f} s wall, median step "
          f"{step_s * 1e3:.1f} ms ({B * S / step_s:.0f} tokens/s), first step "
          f"{out['seconds'][0] * 1e3:.1f} ms, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; launches {n}")
    train_profile(torch, cfg, B, S, f"{cfg.name} train step B={B} S={S}")
    return n


def train_cut_depth(torch, ops, name, n_layers, B, S, steps=5):
    """Phase 26: a config at full width with its first ``n_layers``
    layers (its training state does not fit 80 GB at full depth) trains
    ``steps`` steps through the train step: finite losses, launch counts,
    step time, tokens/s, peak memory and a profile of one step."""
    import dataclasses

    from repro_torch.configs.base import get_config, layer_specs
    from repro_torch.models.params import count_params
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.data import DataConfig, TokenStream

    cfg = dataclasses.replace(get_config(name), n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    step = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=optimizer.OptConfig(lr=1e-3, warmup_steps=2, total_steps=steps)))
    stream = TokenStream(cfg, B, S, DataConfig())
    ops.reset_launch_counts()
    losses, secs = [], []
    for i in range(steps):
        t0 = time.perf_counter()
        state, m = step(state, stream.batch_at(i))
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    n = ops.launch_counts()
    require(all(math.isfinite(x) for x in losses),
            f"{name}: a loss is not finite: {losses}")
    n_attn = sum(s.kind == "attn" for s in layer_specs(cfg))
    n_mamba = n_layers - n_attn
    chunks = -(-S // 256)
    want = {"flash_attention_bwd": n_attn * steps,
            "fa_bwd_wgmma": n_attn * steps, "fa_bwd_mma": 0, "fa_bwd_f32": 0,
            "flash_attention": 2 * n_attn * steps,
            "ssm_scan_bwd": n_mamba * chunks * steps,
            # remat runs each forward twice, both on the checkpoint build
            "ssm_scan": 2 * n_mamba * chunks * steps,
            "ssm_scan_ckpt": 2 * n_mamba * chunks * steps}
    for kernel, w in want.items():
        require(n[kernel] == w, f"{name}: {kernel} launches {n[kernel]} != "
                f"{w}")
    n_params = count_params(state.params)
    del state
    torch.cuda.empty_cache()
    step_s = sorted(secs[1:])[len(secs[1:]) // 2]
    print(f"phase 26 {name} ({n_layers} of {get_config(name).n_layers} "
          f"layers, {n_params / 1e9:.3f} B params) train B={B} S={S}, "
          f"{steps} steps: median step {step_s * 1e3:.1f} ms "
          f"({B * S / step_s:.0f} tokens/s), first {secs[0] * 1e3:.1f} ms, "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; losses "
          + " ".join(f"{x:.4f}" for x in losses) + f"; launches {n}")
    train_profile(torch, cfg, B, S, f"{name} ({n_layers} layers) train step "
                  f"B={B} S={S}")
    return n


def resume_on_card():
    """Phase 27: the reduced stablelm trains on the card through the train
    CLI with checkpoints every 3 steps, dies at step 5 (exit code 17), and
    a second run resumes from the verified step-6 checkpoint and finishes.
    Both runs are child processes, waited for."""
    import os
    import tempfile

    from repro_torch.train import checkpoint as ckpt

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with tempfile.TemporaryDirectory() as d:
        args = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                "stablelm-1.6b", "--reduced", "--steps", "9", "--batch", "2",
                "--seq", "32", "--ckpt-dir", d, "--ckpt-every", "3"]
        t0 = time.perf_counter()
        p1 = subprocess.run(args + ["--simulate-failure", "5"],
                            capture_output=True, text=True, env=env, cwd=ROOT,
                            timeout=300)
        require(p1.returncode == 17, f"the failing run exited "
                f"{p1.returncode}: {p1.stderr[-2000:]}")
        require(ckpt.latest_step(d) == 6 and ckpt.verify(d, 6),
                f"latest verified step {ckpt.latest_step(d)}, want 6")
        p2 = subprocess.run(args, capture_output=True, text=True, env=env,
                            cwd=ROOT, timeout=300)
        require(p2.returncode == 0, f"the resumed run exited {p2.returncode}:"
                f" {p2.stderr[-2000:]}")
        require("resumed from step 6" in p2.stdout and "step 8" in p2.stdout,
                f"the resumed run printed {p2.stdout[-2000:]}")
    print(f"phase 27 checkpoint, kill and resume on the card (reduced "
          f"stablelm, two child processes): exit 17 after step 5, resumed "
          f"from step 6 and finished step 8, {time.perf_counter() - t0:.1f} "
          f"s wall")


# -- phase 28: the multi-device layer ------------------------------------


def median_ms(torch, fn, iters=10):
    """The median of ``iters`` calls' device times after one untimed call
    (CUDA events around each call on the current stream, which waits for
    the NCCL stream of a blocking collective)."""
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        ms.append(s.elapsed_time(e))
    return sorted(ms)[iters // 2]


def collectives_on_card(torch, mesh, card):
    """Phase 28(a): ``compressed_psum`` and ``sparse_psum`` over the
    world-1 NCCL group of ``mesh`` on seeded f32 gradients of every
    stablelm-1.6b leaf shape: the first bit-equal to the in-step pair
    ``decompress(compress(g))``, the second to
    ``topk_decompress(*topk_compress(g))`` at frac 0.01; then each one's ms
    on the 100352 x 2048 embedding and its bytes on the wire."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import grad_compress as gc
    from repro_torch.models.params import param_specs
    from repro_torch.train.tree import flatten_with_path

    cfg = get_config("stablelm-1.6b")
    grp = mesh.get_group("data")
    gen = torch.Generator(device="cuda").manual_seed(28)
    t0 = time.perf_counter()
    n_leaves = n_values = 0
    for path, spec in flatten_with_path(param_specs(cfg)):
        g = torch.randn(spec.shape, generator=gen, device="cuda")
        where = "/".join(map(str, path))
        require(torch.equal(gc.compressed_psum(g, grp),
                            gc.decompress(*gc.compress(g))),
                f"compressed_psum differs from the in-step pair on {where}")
        v, i = gc.topk_compress(g, 0.01)
        require(torch.equal(gc.sparse_psum(g, grp, 0.01),
                            gc.topk_decompress(v, i, g.shape)),
                f"sparse_psum differs from the top-k pair on {where}")
        n_leaves += 1
        n_values += g.numel()
    torch.cuda.synchronize()
    check_s = time.perf_counter() - t0
    g = torch.randn((cfg.vocab_size, cfg.d_model), generator=gen,
                    device="cuda")
    n = g.numel()
    k = max(1, int(n * 0.01))
    out = {
        "compressed_psum_ms": median_ms(
            torch, lambda: gc.compressed_psum(g, grp)),
        "sparse_psum_ms": median_ms(torch, lambda: gc.sparse_psum(g, grp)),
        # one rank's share of each collective: the f32 absmax and the int32
        # payload; the top-k values (f32) and indices (int64)
        "compressed_wire_bytes": 4 + 4 * n,
        "reference_int16_wire_bytes": 4 + 2 * n,
        "f32_all_reduce_bytes": 4 * n,
        "sparse_wire_bytes": 12 * k,
    }
    print(f"phase 28(a) collectives on a world-1 NCCL group: {n_leaves} "
          f"stablelm-1.6b leaf shapes ({n_values} values), compressed_psum "
          f"bit-equal to decompress(compress(g)) and sparse_psum (frac 0.01) "
          f"to topk_decompress(topk_compress(g)) on every one, "
          f"{check_s:.1f} s; on the {cfg.vocab_size} x {cfg.d_model} "
          f"embedding (median of 10): "
          + " ".join(f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in out.items()) + f" [{card}]")
    del g
    return out


def expert_parallel_on_card(torch, mesh, card):
    """Phase 28(b): qwen2-moe-a2.7b's expert layer (E=60, top-4, M=2048,
    F=1408) through ``ep_a2a.moe_ep_a2a_local``: T=4096 tokens in bf16
    routed by ``moe.route`` on seeded weights, the exchange over the
    world-1 NCCL group bit-equal to ``group=None``, with ms per call and
    the share of (token, k) pairs that never reach the combine; then T=256
    in f32 at capacity factors 1.25 and 0.5 (the second overflows the
    bucket), the card against the CPU within 1e-5 with identical src, eid
    and counts from ``bucket_by_peer``."""
    from repro_torch.configs.base import get_config
    from repro_torch.distributed import ep_a2a
    from repro_torch.models import moe

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("qwen2-moe-a2.7b")
    E, K, M, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.d_ff_expert
    grp = mesh.get_group("model")
    gen = torch.Generator(device="cuda").manual_seed(28)
    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda")

    w_router = randn(M, E) / math.sqrt(M)
    w32 = [randn(E, M, F) / math.sqrt(M), randn(E, M, F) / math.sqrt(M),
           randn(E, F, M) / math.sqrt(F)]
    out = {}
    for T, dt in ((4096, torch.bfloat16), (256, torch.float32)):
        x = randn(1, T, M).to(dt)
        _, _, gate, ids, _, _, _ = moe.route({"w_router": w_router}, x, cfg)
        x, ids, gate = x[0], ids.reshape(T, K), gate.reshape(T, K)
        ws = [w.to(dt) for w in w32]
        if dt == torch.bfloat16:
            local = ep_a2a.moe_ep_a2a_local(x, ids, gate, *ws)
            grouped = ep_a2a.moe_ep_a2a_local(x, ids, gate, *ws, group=grp)
            require(torch.equal(local, grouped) and bool(
                torch.isfinite(local).all()), "the exchange over NCCL is not "
                "bit-equal to the single-shard path")
            cap = int(T * K * 1.25)
            _, src, _, _, counts = ep_a2a.bucket_by_peer(x, ids, gate, 1, cap)
            out["bf16_T4096"] = dict(
                local_ms=median_ms(torch, lambda: ep_a2a.moe_ep_a2a_local(
                    x, ids, gate, *ws)),
                nccl_ms=median_ms(torch, lambda: ep_a2a.moe_ep_a2a_local(
                    x, ids, gate, *ws, group=grp)),
                dropped_share=1 - int((src >= 0).sum()) / (T * K),
                counts=counts.tolist())
            continue
        cpu = [t.cpu() for t in (x, ids, gate, *ws)]
        for factor in (1.25, 0.5):
            cap = max(1, int(T * K * factor))
            on_card = ep_a2a.bucket_by_peer(x, ids, gate, 1, cap)
            on_cpu = ep_a2a.bucket_by_peer(*cpu[:3], 1, cap)
            for name, a, b in zip(("src", "eid", "counts"),
                                  (on_card[1], on_card[2], on_card[4]),
                                  (on_cpu[1], on_cpu[2], on_cpu[4])):
                require(torch.equal(a.cpu(), b), f"T={T} factor {factor}: "
                        f"{name} differs between the card and the CPU")
            got = ep_a2a.moe_ep_a2a_local(x, ids, gate, *ws, group=grp,
                                          capacity_factor=factor).cpu()
            want = ep_a2a.moe_ep_a2a_local(*cpu, capacity_factor=factor)
            err = float((got - want).abs().max())
            require(torch.allclose(got, want, rtol=1e-5, atol=1e-5),
                    f"T={T} f32 factor {factor}: card against CPU max abs "
                    f"error {err}")
            out[f"f32_T256_factor{factor}"] = dict(
                max_abs_err=err,
                dropped_share=1 - int((on_card[1] >= 0).sum()) / (T * K))
    print(f"phase 28(b) expert parallelism, qwen2-moe-a2.7b's expert layer "
          f"(E={E}, top-{K}, M={M}, F={F}): {json.dumps(out)} [{card}]")
    return out


def sharded_restore_and_step(torch, ops, mesh, card, B=4, S=2048):
    """Phase 28(c): stablelm-1.6b at full width and depth: the train
    state's specs under ``TRAIN_RULES`` on the (1, 1) cuda mesh; the state
    saved by ``checkpoint.save`` and restored with ``sharding_tree``, every
    leaf a DTensor with the resolved placements whose ``full_tensor()`` is
    bit-equal to the saved leaf; then one train step under
    ``sharding_ctx(mesh, TRAIN_RULES)`` from the restored state's local
    tensors and one without the mesh from the saved state: loss, params, mu
    and nu bit-equal, every attention backward on ``fa_bwd_wgmma``.
    Returns the mesh step's launch counts."""
    import tempfile

    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import get_config
    from repro_torch.distributed.sharding import (TRAIN_RULES, NamedSharding,
                                                  sharding_ctx)
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.tree import flatten_with_path, leaves, map_tree

    cfg = get_config("stablelm-1.6b")
    torch.cuda.reset_peak_memory_stats()
    state = train_loop.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    pspecs = train_loop.state_pspecs(cfg, rules=TRAIN_RULES, mesh=mesh)
    shardings = map_tree(lambda p: NamedSharding(mesh, p), pspecs)
    step = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=optimizer.OptConfig(lr=1e-3, warmup_steps=0)))
    batch = TokenStream(cfg, B, S, DataConfig()).batch_at(0)

    def sub(a, b):
        return float((a.detach().float() - b.detach().float()).abs().max())

    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ckpt.save(d, 0, state)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = ckpt.restore(d, 0, state, sharding_tree=shardings)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        for (path, got), (_, want), (_, ns) in zip(
                flatten_with_path(restored), flatten_with_path(state),
                flatten_with_path(shardings), strict=True):
            where = "/".join(map(str, path))
            require(isinstance(got, DTensor)
                    and got.placements == ns.placements,
                    f"{where} restored as {type(got)}, want a DTensor with "
                    f"{ns.placements}")
            require(torch.equal(got.full_tensor(), want.detach()),
                    f"{where}: the restored leaf differs from the saved one")
        local = map_tree(lambda t: t.to_local().detach().requires_grad_(
            t.requires_grad), restored)
        del restored
        ops.reset_launch_counts()
        with sharding_ctx(mesh, TRAIN_RULES):
            t0 = time.perf_counter()
            meshed, m1 = step(local, batch)
            torch.cuda.synchronize()
            mesh_s = time.perf_counter() - t0
        n = ops.launch_counts()
        want = {"flash_attention_bwd": cfg.n_layers,
                "fa_bwd_wgmma": cfg.n_layers, "fa_bwd_mma": 0,
                "fa_bwd_f32": 0, "flash_attention": 2 * cfg.n_layers}
        for kernel, w in want.items():
            require(n[kernel] == w, f"the step under the mesh launched "
                    f"{kernel} {n[kernel]} times, want {w}")
        t0 = time.perf_counter()
        plain, m0 = step(state, batch)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        require(torch.equal(m1["loss"], m0["loss"]), f"loss "
                f"{float(m1['loss'])} under the mesh, {float(m0['loss'])} "
                f"without")
        for (path, a), (_, b) in zip(flatten_with_path(meshed),
                                     flatten_with_path(plain), strict=True):
            if not torch.equal(a.detach(), b.detach()):
                require(False, f"after the step {'/'.join(map(str, path))} "
                        f"differs by {sub(a, b)} between the mesh and none")
    peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"phase 28(c) {cfg.name} (full width and depth) on the (1, 1) cuda "
          f"mesh: {len(leaves(state))} state leaves saved in {save_s:.1f} s, "
          f"restored as DTensors with the TRAIN_RULES placements in "
          f"{restore_s:.1f} s, bit-equal to the saved leaves; one train step "
          f"(B={B}, S={S}) under sharding_ctx in {mesh_s * 1e3:.1f} ms and "
          f"one without in {plain_s * 1e3:.1f} ms: loss "
          f"{float(m1['loss']):.6f} / {float(m0['loss']):.6f}, params, mu, "
          f"nu and loss bit-equal; peak {peak:.2f} GB; launches {n} [{card}]")
    del state, plain
    torch.cuda.empty_cache()
    return n


def distributed_on_card(torch, ops, card):
    """Phase 28: the collectives, expert parallelism and the sharded
    restore and step on a world-1 NCCL group; the group is destroyed at
    the end."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    t0 = time.perf_counter()
    mesh = make_local_mesh(1, 1)
    require(dist.get_backend() == "nccl", f"backend {dist.get_backend()}")
    coll = collectives_on_card(torch, mesh, card)
    ep = expert_parallel_on_card(torch, mesh, card)
    torch.cuda.empty_cache()
    n = sharded_restore_and_step(torch, ops, mesh, card)
    dist.destroy_process_group()
    print(f"phase 28 the multi-device layer: {time.perf_counter() - t0:.1f} "
          f"s wall")
    return n, dict(collectives=coll, expert_parallel=ep)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--ssm-bwd-timing", type=int, metavar="RUNS",
        help="time only phase 23's scan (the backward and the forward's two "
             "builds) RUNS times over in a fresh process, and stop")
    parser.add_argument(
        "--only-distributed", action="store_true",
        help="build the kernels, run only phase 28 (the multi-device "
             "layer), and stop without the closing lines")
    args = parser.parse_args()
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)

    from repro_torch.kernels import _build, ops
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import lags_select as lags
    from repro_torch.kernels import ssm_scan as ssm
    from repro_torch.launch import serve

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    if args.ssm_bwd_timing:
        # odd runs after phase 23's attention timing at qwen3-8b's shape,
        # as the full run times the scan
        timer = Timer(torch)
        for run in range(args.ssm_bwd_timing):
            if run % 2:
                time_flash_bwd(torch, fa, timer, **QWEN_TRAIN)
            scan = time_ssm_bwd(torch, ssm, timer, **MAMBA_TRAIN_CHUNK)
            print(f"run {run}{' after attention' if run % 2 else ''}: "
                  f"ssm_scan_bwd {scan['ms']:.6g} ms (two runs "
                  f"{scan['runs_ms']})")
            print_ssm_timing(ssm, scan, MAMBA_TRAIN_CHUNK, card)
        return

    # phase 2: build every kernel, one nvcc each, in parallel
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        text = log.read_text() if log.exists() else ""
        rows = ptxas_report(text)
        # ptxas says where it had to serialize wgmma products
        for line in text.splitlines():
            if "Potential Performance Loss" in line:
                print(f"  {name}: ptxas: {line.split('Loss: ')[-1][:200]}")
        for fn, used, spill in rows:
            # the f32 decode kernel is built for six head dims: shown only
            # where it spills
            if "dec_split" not in fn or " 0 bytes spill stores" not in spill:
                print(f"  {name}: {fn}: {used}; {spill}")
        quiet = [r for r in rows if "dec_split" in r[0]
                 and " 0 bytes spill stores" in r[2]]
        if quiet:
            print(f"  {name}: {len(quiet)} dec_split builds, no spills, "
                  f"{min(int(r[1].split()[1]) for r in quiet)} to "
                  f"{max(int(r[1].split()[1]) for r in quiet)} registers")
    fa_lib = _build.library("flash_attention_wgmma", {
        "flash_attention_wgmma_smem": ([ctypes.c_int], ctypes.c_int)})
    bwd_lib = _build.library("flash_attention_bwd_wgmma", {
        "flash_attention_bwd_wgmma_smem": ([ctypes.c_int, ctypes.c_int],
                                           ctypes.c_int)})
    ssm_lib = _build.library("ssm_scan_bwd", {
        "ssm_scan_bwd_smem": ([ctypes.c_int], ctypes.c_int)})
    dec_lib = _build.library("decode_attention", {
        "decode_attention_smem": ([ctypes.c_int, ctypes.c_int], ctypes.c_int)})
    print("  dynamic shared memory a block: fa_wgmma D=64 "
          f"{fa_lib.flash_attention_wgmma_smem(64)} B, D=128 "
          f"{fa_lib.flash_attention_wgmma_smem(128)} B; dec_mma (bf16) D=128 "
          f"{dec_lib.decode_attention_smem(1, 128)} B, dec_split (f32) D=128 "
          f"{dec_lib.decode_attention_smem(0, 128)} B; fa_bwd_dq_wgmma D=64 "
          f"{bwd_lib.flash_attention_bwd_wgmma_smem(64, 0)} B, D=128 "
          f"{bwd_lib.flash_attention_bwd_wgmma_smem(128, 0)} B; "
          f"fa_bwd_dkdv_wgmma D=64 {bwd_lib.flash_attention_bwd_wgmma_smem(64, 1)}"
          f" B, D=128 {bwd_lib.flash_attention_bwd_wgmma_smem(128, 1)} B; "
          f"ssm_bwd_tma N=16 {ssm_lib.ssm_scan_bwd_smem(16)} B")

    if args.only_distributed:
        distributed_on_card(torch, ops, card)
        return

    # phases 3-5: kernels against their plain versions, then times
    lags_err = check_lags(torch, lags)
    dec_err = check_decode(torch, dec)
    fa_err = check_flash(torch, fa)
    ssm_err = check_ssm(torch, ssm)
    timer = Timer(torch)
    times = {"lags_select": time_lags(torch, lags, timer, T=1024)}
    t4096 = time_lags(torch, lags, timer, T=4096)
    t65536 = time_lags(torch, lags, timer, T=65536)
    t65536_k1024 = time_lags(torch, lags, timer, T=65536, k=1024)
    times["decode_attention"] = time_decode(torch, dec, timer)
    d4096 = time_decode(torch, dec, timer, L=4096)
    d_g16 = time_decode(torch, dec, timer, B=4, H=64, Hkv=4, L=2112)
    times["flash_attention"] = time_flash(torch, fa, timer, **QWEN_PREFILL)
    times["ssm_scan"] = time_ssm(torch, ssm, timer, **MAMBA_CHUNK)
    del timer
    for name, t in (("lags_select T=1024 k=16", times["lags_select"]),
                    ("lags_select T=4096 k=16", t4096),
                    ("lags_select T=65536 k=16", t65536),
                    ("lags_select T=65536 k=1024", t65536_k1024),
                    ("decode_attention bf16 B=16 H=32 Hkv=8 L=512 kv=505",
                     times["decode_attention"]),
                    ("decode_attention bf16 B=16 H=32 Hkv=8 L=4096 kv=4089",
                     d4096),
                    ("decode_attention bf16 G=16 B=4 H=64 Hkv=4 L=2112 "
                     "kv=2105", d_g16),
                    ("flash_attention bf16 causal B=4 H=32 Hkv=8 S=2048 D=128",
                     times["flash_attention"]),
                    ("ssm_scan f32 B=4 S=256 I=8192 N=16",
                     times["ssm_scan"])):
        ratio = (f" x_library={t['ms'] / t['library_ms']:.3f}"
                 if t["library_ms"] else "")
        floor = (f" x_floor={t['ms'] / t['floor_ms']:.3f}"
                 if "floor_ms" in t else "")
        print(f"time {name}: " + " ".join(
            f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items()) + f" x_bound={t['ms'] / t['bound_ms']:.3f}"
            + ratio + floor + f" [{card}]")

    # each kernel's launches, summed over every path the script drives
    # (each path counted from 0 just before it runs)
    counts = {}

    # phase 6: the serving entry point on the cost model
    add_counts(counts, serve_cost_model(torch, ops, serve, t4096["ms"]))

    # phase 7: the main path at full width
    check_model_small(torch)
    n, qwen = serve_qwen3_8b(torch, ops, serve, times["lags_select"]["ms"])
    add_counts(counts, n)

    # phases 8-10: prefill, reduced on card and CPU, then at full size
    check_prefill_small(torch)
    cfg = get_config("qwen3-8b")
    add_counts(counts, prefill_full(
        torch, ops, cfg, qwen, token_batch(torch, cfg, 4, 2048), 64,
        {"flash_attention": 36}))
    del qwen  # 16 GB: falcon-mamba's weights take its place
    torch.cuda.empty_cache()
    add_counts(counts, mamba_full(torch, ops))

    # phases 11-13: the tick simulator and the batched fleet
    simulators(torch, ops, card)

    # phase 14: the chaos layer on the batched fleet
    chaos(torch, ops, card)

    # phase 15: the reduced families, card against CPU
    t0 = time.perf_counter()
    check_families_small(torch)
    print(f"phase 15 reduced families: {time.perf_counter() - t0:.1f} s wall")

    # phase 16: qwen2-moe-a2.7b served and prefilled at full size
    t0 = time.perf_counter()
    add_counts(counts, serve_moe(torch, ops, serve))
    torch.cuda.empty_cache()
    print(f"phase 16 qwen2-moe-a2.7b: {time.perf_counter() - t0:.1f} s wall")

    # phases 17-18: full width, the first 8 layers
    for phase, name in ((17, "jamba-v0.1-52b"), (18, "qwen3-moe-235b-a22b")):
        t0 = time.perf_counter()
        add_counts(counts, reduced_depth(torch, ops, name, 8))
        print(f"phase {phase} {name} (8 of {get_config(name).n_layers} "
              f"layers): {time.perf_counter() - t0:.1f} s wall")

    # phases 19-21: gemma3, qwen2-vl and hubert at full size
    families_full(torch, ops, counts)

    # phase 22: the training kernels against their plain versions
    check_flash_train(torch, fa)
    fa_bwd_err = check_flash_bwd_wgmma(torch, fa)
    check_decode_positions(torch, dec)
    ssm_bwd_err = check_ssm_train(torch, ssm)

    # phase 23: the backward kernels' times at the training shapes
    (times["flash_attention_bwd"], fa_bwd_qwen,
     times["ssm_scan_bwd"]) = backward_times(torch, fa, ssm, card)

    # phase 24: reduced train steps, card against CPU
    t0 = time.perf_counter()
    check_train_small(torch)
    print(f"phase 24 reduced train steps: {time.perf_counter() - t0:.1f} s "
          f"wall")

    # phase 25: stablelm-1.6b at full width and depth through the train CLI
    add_counts(counts, train_stablelm(torch, ops))
    torch.cuda.empty_cache()

    # phase 26: full width, cut depth
    for name, n_layers, B, S in (("qwen3-8b", 4, 4, 2048),
                                 ("falcon-mamba-7b", 8, 2, 1024)):
        add_counts(counts, train_cut_depth(torch, ops, name, n_layers, B, S))
        torch.cuda.empty_cache()

    # phase 27: checkpoint, kill and resume on the card
    resume_on_card()

    # phase 28: the multi-device layer on a world-1 NCCL group
    n, _ = distributed_on_card(torch, ops, card)
    add_counts(counts, n)

    kernels = [
        dict(name="lags_select", route="cuda", kernel="lags_cluster_select",
             source="src/repro_torch/kernels/csrc/lags_select.cu",
             replaces="src/repro/kernels/lags_select.py:56",
             launches=counts["lags_select"],
             max_abs_err=lags_err["T1024_k16"], **times["lags_select"]),
        dict(name="decode_attention", route="cuda",
             kernel=dec.route(torch.bfloat16),
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:61",
             launches=counts["decode_attention"],
             max_abs_err=dec_err[("bfloat16", 16, 32, 8, 512, 128, 0)],
             **times["decode_attention"],
             g16=dict(shape="B=4 H=64 Hkv=4 L=2112 D=128 kv_len=2105 bf16",
                      max_abs_err=dec_err[("bfloat16", 4, 64, 4, 2112, 128,
                                           0)], **d_g16)),
        dict(name="flash_attention", route="cuda",
             kernel=fa.route(torch.bfloat16, QWEN_PREFILL["D"]),
             source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=counts["flash_attention"],
             max_abs_err=fa_err[("bfloat16", *QWEN_PREFILL.values(), True, 0)],
             **times["flash_attention"]),
        dict(name="ssm_scan", route="cuda", kernel="ssm_fwd<false>",
             source="src/repro_torch/kernels/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan.py:51",
             launches=counts["ssm_scan"],
             max_abs_err=ssm_err[tuple(MAMBA_CHUNK.values())],
             **times["ssm_scan"],
             ckpt=dict(kernel="ssm_fwd<true>",
                       launches=counts["ssm_scan_ckpt"],
                       shape="B=2 S=256 I=8192 N=16 f32",
                       ms=times["ssm_scan_bwd"]["forward_ms"]["ckpt"],
                       plain_build_ms=times["ssm_scan_bwd"]["forward_ms"][
                           "plain"])),
        bwd_entry(fa, counts, fa_bwd_err, times["flash_attention_bwd"],
                  fa_bwd_qwen),
        dict(name="ssm_scan_bwd", route="cuda",
             kernel="ssm_bwd_tma + ssm_bwd_dc",
             source="src/repro_torch/kernels/csrc/ssm_scan_bwd.cu",
             replaces="src/repro/kernels/ssm_scan.py:51",
             replaces_note=("the TPU kernel has no backward: the reference "
                            "differentiates the scan of "
                            "src/repro/models/mamba.py:56 with XLA"),
             launches=counts["ssm_scan_bwd"],
             max_abs_err=ssm_bwd_err[tuple(MAMBA_TRAIN_CHUNK.values())],
             shape="B=2 S=256 I=8192 N=16 f32",
             **{k: v for k, v in times["ssm_scan_bwd"].items()
                if k not in ("forward_ms", "timer")}),
    ]
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall [{card}]")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
