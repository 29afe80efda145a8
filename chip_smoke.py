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
   rows; each also with its log-sum-exp output (the output bit-equal to
   the launch without it, the log-sum-exp within the f32 TOL of the plain
   version's) and split at half its rows into two launches merged by
   ``models.attention.merge_partials`` within TOL; ``flash_attention`` at
   the reference's test shapes for (causal, 0), (causal, 128), (causal, 64) and
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
    decode steps and the cosine check; its 28 attention launches all on
    ``fa_wgmma`` under positions, none on ``fa_mma`` (launches printed by
    route);
21. hubert-xlarge at full width and depth (48 layers): the encoder forward
    at B=4, S=2048 from random frames, 48 ``fa_wgmma`` launches
    (non-causal, D=80), none on ``fa_mma``, finite logits (4, 504);
22. the training kernels against their plain versions: ``flash_attention``
    with positions (``fa_wgmma``, ``fa_fwd``) and ``flash_attention_bwd`` at
    the reference's test shapes, GQA, windows, non-causal D=80, S=1, ragged
    S, positions with repeats and gaps, and the qwen3-8b and stablelm-1.6b
    training shapes (f32 at TOL, bf16 at TOL and at a relative error of
    1e-2 over each 64-row tile, printed in the kernels line); the wgmma
    backward (``fa_bwd_wgmma``) at D 64 and 128, causal, window 128 and
    non-causal, G 1, 2, 4, 8 and 16, S 1, 77, 300 and 2048: the forward's L
    against its plain version (its output bit-equal to the no-gradient
    build's), dq, dk, dv from that L as above, with the largest tile error
    at S=1, G=16 printed (ROADMAP Queue C item 10); at the two training
    shapes the ``mma`` route too, and two wgmma calls at stablelm's
    bit-equal; then the cases the wgmma route took over from the ``mma``
    kernels: the same grid at D=80, and positions rising, repeated with
    gaps, unsorted and with rows that keep no key, at D 64, 80 and 128,
    G=7, S 300 and 2048 (the dK/dV kernel split over the group's heads);
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
    where ``fa_wgmma`` took over from the ``mma`` kernels, the forward at
    the prefill shapes of phases 20 and 21 (B=4, S=2048) and the backward
    at qwen2-vl-7b's (positions) and hubert-xlarge's (non-causal, D=80)
    training shapes: the wgmma route and the ``mma`` kernels by name, each
    checked against the plain version, timed in turns beside SDPA with the
    same mask and the bound over the kept pairs (the wgmma route must
    beat the ``mma`` kernels at all four, and SDPA's backward at
    qwen2-vl-7b's); ``--attention-timing`` runs only these four and stops;
    ``ssm_scan_bwd`` given the forward's
    checkpoints, below the time of the two-pass kernel it replaced, in
    turns with the scan's forward with
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
29. the dry run, the roofline and the figure drivers: (a) ``python -m
    repro_torch.launch.dryrun --all`` in a child process at nice 19 on
    every core but one, started after phase 14 so that it runs beside
    phases 15-28 (a fake process group of 512 ranks, no card: each cell's
    sharded step executed as rank 0 on meta DTensors, its cells in child
    processes, one a core), 62 cells ok and 18 skipped with the
    reference's reasons, each ok cell's bytes a device (arguments and
    outputs) equal to the reference's (``REF_DRYRUN``), its FLOPs, bytes
    accessed, collectives (wire bytes above 0), temporaries and step
    seconds there and only the code size unavailable; its own seconds, and
    the five cells with the most temporaries against the card's 80 GB; (b)
    the ``roofline.*`` rows of ``benchmarks_torch.roofline`` over its
    report on the H100's published figures, each with its collective term
    and its dominant term, and the share of the card's bf16 peak
    that ``flops_model``'s MODEL_FLOPS gives at the step times of phases
    25 (stablelm-1.6b train), 9 (Qwen3-8B prefill) and 7 (Qwen3-8B decode),
    as ``mfu=``; (c) on the card, while the child runs:
    ``benchmarks_torch.fig11_baselines``' ``fig11.torch.*`` row of
    lags-static (phase 11 holds all seven codes) equal to
    ``REF_FIG11``, ``benchmarks_torch.serving_lags`` at 24
    tenants equal to the reference's rows (``REF_SERVING``), and
    ``examples_torch/quickstart.py`` with its loss falling;
    ``--only-figures`` builds the kernels, runs only this phase and stops;
30. prefill and decode sharded over a (1, 2) ("data", "model") mesh: two
    processes sharing the card over gloo (NCCL takes one rank a card),
    the parameters placed by their specs as they are drawn
    (``params.init_params(..., mesh=)``), prefill under ``TRAIN_RULES``
    and 8 decode steps through ``build_lowerable``'s decode cell: the
    reduced Qwen3-8B (G=2) and falcon-mamba-7b in f32, Qwen3-8B (B=4,
    S=2048) and falcon-mamba-7b (B=4, S=1024) at full width on 8 layers in
    bf16, and falcon-mamba-7b at full width on 2, 4 and 8 layers in f32,
    each against the same run unsharded in this process
    (``sharded_on_card``: the checks, and why falcon-mamba-7b's logits are
    held on 4 layers in f32); ``--only-sharded`` builds the kernels,
    checks ``decode_attention`` (phase 4's part), runs only phases 30 and
    31 and stops;
31. the same for the MoE, hybrid, windowed, vision and encoder-only
    families (``FAMILY_JOBS``): the reduced qwen2-moe, qwen3-moe (G=16),
    jamba, gemma3 (a window of 4 crossing the ranks' cache rows), qwen2-vl
    (vision rows, positions off the row index on one row) and hubert in
    f32, each held to TOL (jamba to TOL widened by 4x the world-1 run's
    own move under 1e-7 noise); then at full width in bf16
    qwen2-moe-a2.7b (B=4, S=2048), jamba-v0.1-52b and
    qwen3-moe-235b-a22b (B=2, S=2048), qwen2-vl-7b (B=4, S=2048, 1024
    vision rows) and hubert-xlarge (B=4, S=2048, the encoder forward) on 4
    layers, gemma3-27b on 6 (B=2, S=1536, decode past its window of 1024);
    gemma3's and qwen2-vl's held at cosine >= 0.99 to their world-1 run,
    the chaotic MoE stacks', jamba's and hubert's printed and held in f32
    at full width on their first layers at cosine >= 0.99 (``FAMILY_JOBS``
    says why);
    each job prints the cosine, the share of equal argmax tokens, a rank's
    bytes against the rules, each kernel's local launch shapes, and a
    rank's prefill and step times;
32. the train step over a ("data", "model") mesh of two processes sharing
    the card over gloo, as phases 30-31 run theirs (``TRAIN_JOBS``):
    stablelm-1.6b on 4 layers at full width on a (2, 1) mesh (FSDP: the
    weights gathered over "data", their gradients reduce-scattered, the
    batch split) and falcon-mamba-7b on 4 layers on a (1, 2) mesh (the
    inner channels split: the scan and its backward on half of them),
    B=2, S=512; then the other six configs at full width on (1, 2) (heads,
    FFN width, experts and vocab split), each cut to the depth whose train
    state fits ``STATE_BUDGET`` (printed): gemma3-27b (B=1, S=1536, past
    its window), hubert-xlarge (frames, non-causal, D=80, all 48 layers),
    qwen2-vl-7b (B=1, S=1536: its 1024 vision rows, and positions off the
    row index), qwen2-moe-a2.7b, qwen3-moe-235b-a22b (one layer) and
    jamba-v0.1-52b (a Mamba layer with a dense MLP, one with MoE); two
    steps each through ``build_lowerable``'s train cell, against the same
    steps unsharded in this process.  In f32 with each dense weight at std
    1/sqrt(its contraction width), held: the first step's loss, grad norm
    and each gradient leaf within 1e-4, the second's loss and grad norm
    within 1e-4 plus 4x the unsharded run's own move when every parameter
    moves by 1e-7 (its witness), the entries whose first gradients' signs
    differ counted, the update's cosine >= 0.99.  In bf16 with the
    reference's init, printed, only where a bf16 run launches a backward
    route or build that no f32 run does: stablelm-1.6b (``fa_bwd_wgmma``),
    gemma3-27b's pattern of windowed layers on 8 layers (the windowed
    ``fa_bwd_wgmma``), hubert-xlarge (D=80) and qwen2-vl-7b (positions):
    ``fa_wgmma`` and ``fa_bwd_wgmma``, no ``fa_mma`` or ``fa_bwd_mma``.
    Each rank's parameter and moment bytes against the rules, its peak
    above the state, its step times, the launches of the attention and
    scan kernels forward and backward (by route) and the local shapes of
    both; ``--only-train-sharded`` builds the kernels, runs only this
    phase and stops;
33. the script's wall seconds (each phase's on a ``wall:`` line), a
    ``{"kernels": [...]}`` line (each
    kernel's CUDA function on the main path under ``kernel``, its launches
    summed over every path above (attention's also by route),
    ``decode_attention``'s G=16 time under ``g16`` and with its
    log-sum-exp output under ``lse`` (timed in turns with the launch
    without it); attention's forward and backward at qwen2-vl-7b's and
    hubert-xlarge's shapes under ``qwen2_vl`` and ``hubert``, each with the
    ``mma`` kernels by name under ``mma``; the two backward kernels at the
    stablelm-1.6b and falcon-mamba training shapes, attention's ``mma``
    route under ``mma``), then
    ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits nonzero without the last line.
It exits nonzero at once where no card is present.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import gc
import itertools
import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import NamedTuple

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


# The bounds of the kernels' calls by row index, from each kernel module's
# ``cost`` (FLOPs, HBM bytes), the one formula the dry run also counts with


def flash_bound(fa, B, H, Hkv, S, D, dtype="bfloat16"):
    """One causal forward: q.k and p.v over the pairs the mask keeps."""
    route = "fa_fwd" if dtype == "float32" else "fa_wgmma"
    flops, n_bytes = fa.cost(route, B, H, Hkv, S, D, True, 0)
    return bound_ms(n_bytes, flops, dtype)


def flash_bwd_bound(fa, B, H, Hkv, S, D, dtype="bfloat16"):
    """One causal backward: the five products of a minimal design (S, dP,
    dV, dK, dQ; the wgmma kernels compute seven), the forward's L read."""
    route = "fa_bwd_f32" if dtype == "float32" else "fa_bwd_wgmma"
    flops, n_bytes = fa.cost(route, B, H, Hkv, S, D, True, 0,
                             products=fa.MIN_BWD_PRODUCTS)
    return bound_ms(n_bytes, flops, dtype)


def decode_bound(dec, B, H, Hkv, L, D, kv_len, dtype="bfloat16", lse=False):
    """One decode call over the cache rows ``kv_len`` (a list) keeps."""
    flops, n_bytes = dec.cost(B, H, Hkv, L, D, 2 if dtype == "bfloat16"
                              else 4, rows=sum(kv_len), lse=lse)
    return bound_ms(n_bytes, flops, dtype)


def ssm_bound(ssm, B, S, I, N, backward=False):
    """One scan (f32), or its backward given the forward's checkpoints
    (their reads not counted: the function's inputs are dA, dBx, C, h0,
    dy and dh_last)."""
    flops, n_bytes = ssm.cost(B, S, I, N, backward=backward)
    return bound_ms(n_bytes, flops, "float32")


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
    """Each shape of ``dec_shapes`` in f32 and bf16 against the plain
    version; the launch with the log-sum-exp output writes the same output
    bit for bit and its log-sum-exp within the f32 TOL of the plain
    version's; and the cache rows split in two halves, each attended with
    kv_len shifted by its first row and clamped, merge from their
    log-sum-exps (``models/attention.merge_partials``) to the unsplit
    output within TOL."""
    from repro_torch.models.attention import merge_partials

    gen = torch.Generator(device="cuda").manual_seed(1)
    errs, lse_err, merge_err = {}, 0.0, 0.0
    for dtype in ("float32", "bfloat16"):
        for B, H, Hkv, L, D, kv_len, r0 in dec_shapes():
            q, k, v, kv = dec_inputs(torch, gen, B, H, Hkv, L, D, dtype,
                                     kv_len, r0)
            got = dec.decode_attention(q, k, v, kv)
            want = dec.decode_attention_plain(q, k, v, kv)
            got_l, lse = dec.decode_attention(q, k, v, kv, with_lse=True)
            _, want_lse = dec.decode_attention_plain(q, k, v, kv,
                                                     with_lse=True)
            n = k.shape[2]
            half, parts = n // 2 // 64 * 64 or n // 2, []
            for a, b in ((0, half), (half, n)):
                parts.append(dec.decode_attention(
                    q, k[:, :, a:b], v[:, :, a:b], (kv - a).clamp(0, b - a),
                    with_lse=True))
            merged = merge_partials(*zip(*parts))
            torch.cuda.synchronize()
            ok, e, bad = within(lse, want_lse, TOL["float32"])
            require(ok and torch.equal(got_l, got), f"decode_attention "
                    f"{dtype} {(B, H, Hkv, L, D, r0)} with its log-sum-exp: "
                    f"{bad} lse values outside TOL, max err {e}; output "
                    f"equal to the launch without: {torch.equal(got_l, got)}")
            lse_err = max(lse_err, e)
            ok, e, bad = within(merged, want, TOL[dtype])
            require(ok, f"decode_attention {dtype} {(B, H, Hkv, L, D, r0)}: "
                    f"the two halves' merge has {bad} values outside TOL, "
                    f"max err {e}")
            merge_err = max(merge_err, e)
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
    print(f"decode_attention log-sum-exp output: max_abs_err={lse_err:.3e} "
          f"against the plain version, outputs bit-equal to the launches "
          f"without it; two halves of the rows merged: max_abs_err="
          f"{merge_err:.3e}")
    errs["lse"], errs["merge"] = lse_err, merge_err
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
    # then hubert's non-causal D=80 (fa_wgmma in bf16), G=16 (qwen3-moe), G=7
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
    # the launch without the log-sum-exp output (the default) and with it,
    # in turns: without, with, with, without; each the mean of its two
    runs = {}
    for lse in (False, True, True, False):
        runs.setdefault(lse, []).append(timer.ms(
            lambda: dec.decode_attention(q, k, v, kv, with_lse=lse)))
    ms = sum(runs[False]) / 2
    plain_ms = timer.ms(lambda: dec.decode_attention_plain(q, k, v, kv))
    # yardstick only: one PyTorch call for the same function
    q4, k4, v4 = q[:, :, None, :], k.contiguous(), v.contiguous()
    mask = (torch.arange(L, device="cuda")[None, :] < kv[:, None])[:, None, None]
    lib_ms = library_ms(torch, timer, f"SDPA decode L={L}",
                        lambda: F.scaled_dot_product_attention(
                            q4, k4, v4, attn_mask=mask, enable_gqa=True))
    b, by = decode_bound(dec, B, H, Hkv, L, D, kv_len, dtype)
    b_lse, by_lse = decode_bound(dec, B, H, Hkv, L, D, kv_len, dtype,
                                 lse=True)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by, runs_ms=runs[False],
                lse=dict(ms=sum(runs[True]) / 2, runs_ms=runs[True],
                         plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=b_lse, bound_by=by_lse))


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
    b, by = flash_bound(fa, B, H, Hkv, S, D, dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by)


def time_ssm(torch, ssm, timer, B, S, I, N):
    gen = torch.Generator(device="cuda").manual_seed(7)
    dA, dBx, C, h0 = ssm_inputs(torch, gen, B, S, I, N)
    ms = timer.ms(lambda: ssm.ssm_scan(dA, dBx, C, h0))
    plain_ms = timer.ms(lambda: ssm.ssm_scan_plain(dA, dBx, C, h0), iters=5)
    b, by = ssm_bound(ssm, B, S, I, N)
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
    MEASURED["decode", cfg.name, 16, max_len] = step_ms[len(step_ms) // 2]
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
    MEASURED["prefill", label, B, S] = med * 1e3
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


def side_by_side(fn, tasks):
    """``fn(*task)`` for every task, each in a process of its own, all
    started at once (spawned, one torch thread each), the results in the
    tasks' order.  The tick loops are bound by their host's issue of small
    kernels (the card is busy 5-7% under one), so independent loops run
    side by side on the host's cores and share the card."""
    import concurrent.futures
    import multiprocessing

    with concurrent.futures.ProcessPoolExecutor(
            len(tasks), mp_context=multiprocessing.get_context("spawn"),
            initializer=_one_thread) as pool:
        futures = [pool.submit(fn, *t) for t in tasks]
        return [f.result() for f in futures]


def _one_thread():
    import torch

    torch.set_num_threads(1)


def fig11_inputs(dev):
    """Fig. 11's node on ``dev``: its slot trace and ``params(code,
    n_ticks)``."""
    from repro_torch.core import simkernel_torch as st
    from repro_torch.core.traces import lightest_band_fns, make_workload
    from repro_torch.sched.torch_backend import LAGS_STATIC

    wl = make_workload("azure2021", 120, duration_s=30.0, n_cores=12, seed=1,
                       exec_s=0.1, threads_per_fn=4)
    rt = tuple(int(f) for f in lightest_band_fns(120, n_bands_low=3))

    def params(code, n_ticks=7500):
        return st.SimParams(n_cores=12, n_fns=120, n_ticks=n_ticks,
                            policy=code, burst_us=120.0, depth=2.0,
                            rt_fns=rt if code == LAGS_STATIC else ())

    return st.build_slot_trace(wl, 120, 4, device=dev), params


def fig11_run(name, dev):
    """One Fig. 11 run (``side_by_side``): the policy ``name`` over 7500
    ticks on ``dev``.  Returns the completion ticks, (completed, sum of
    completion ticks, p50, p95), busy and overhead seconds, the loop's
    wall seconds, the arrival slots and the process's kernel launches."""
    import numpy as np

    from repro_torch.core import simkernel_torch as st
    from repro_torch.kernels import ops
    from repro_torch.sched.torch_backend import CODE_OF, LAGS

    trace, params = fig11_inputs(dev)
    if dev == "cuda":
        st.simulate(trace, params(LAGS, 50))  # warm-up: first launches
    ops.reset_launch_counts()
    calls = []
    with simulate_clock(calls):
        out = st.simulate(trace, params(CODE_OF[name]))
    d = out["done_tick"].cpu().numpy()
    lat = st.latencies_from(trace, d)
    got = (len(lat), int(d[d >= 0].sum()), float(np.percentile(lat, 50)),
           float(np.percentile(lat, 95)))
    return dict(done=d, got=got, busy=float(out["busy_s"]),
                overhead=float(out["overhead_s"]), secs=calls[0][3],
                R=trace.arrival_tick.shape[1], launches=ops.launch_counts())


def fig11(torch, card):
    """All seven policy codes at Fig. 11's size on the card, held to the
    reference; lags and cfs on the CPU too; every run in a process of its
    own, side by side (``side_by_side``).  Returns the ticks/s, the
    launches, and the LAGS run's trace and params for the profile."""
    import numpy as np

    from repro_torch.sched.torch_backend import CODE_OF, LAGS

    runs = [(name, dev) for name, _ in sorted(CODE_OF.items(),
                                              key=lambda kv: kv[1])
            for dev in (("cuda", "cpu") if name in ("lags", "cfs")
                        else ("cuda",))]
    t0 = time.perf_counter()
    results = side_by_side(fig11_run, runs)
    wall = time.perf_counter() - t0
    done, rate, launches = {}, {}, {}
    for (name, dev), r in zip(runs, results):
        add_counts(launches, r["launches"])
        secs, got = r["secs"], r["got"]
        rate[name, dev] = 7500 / secs
        ref = REF_FIG11[name]
        require(got == ref[:4], f"fig11 {name} on {dev}: (completed, sum "
                f"of completion ticks, p50, p95) {got}, the reference "
                f"{ref[:4]}")
        sim_check(f"fig11 {name} on {dev}", r["busy"], ref[4], "busy_s")
        sim_check(f"fig11 {name} on {dev}", r["overhead"], ref[5],
                  "overhead_s")
        if dev == "cpu":
            require(np.array_equal(r["done"], done[name]),
                    f"fig11 {name}: completion ticks differ on the card "
                    f"and the CPU")
        done[name] = r["done"]
        print(f"fig11 {name} T=480 R={r['R']} 7500 ticks on the {dev}: "
              f"{got[0]} completed, p50 {got[2]:.4f} s, p95 {got[3]:.4f} s, "
              f"overhead {r['overhead'] / (12 * 30.0):.6f}; {secs:.3f} s "
              f"wall, {rate[name, dev]:.1f} ticks/s [{card}]")
    print(f"fig11: all seven codes equal the reference on the card "
          f"(completions, sum of completion ticks, p50, p95; busy and "
          f"overhead within rtol 1e-5); lags and cfs complete on the same "
          f"ticks on the CPU; the {len(runs)} runs side by side, each in a "
          f"process of its own: {wall:.1f} s wall")
    trace, params = fig11_inputs("cuda")
    return rate, launches, trace, params(LAGS)


FIG7_RUNS = (("cfs", 14, "cuda"), ("cfs", 10, "cuda"), ("lags", 14, "cuda"),
             ("lags", 10, "cuda"), ("lags", 10, "cpu"))


def fig7_run(policy, n_nodes, dev):
    """One configuration of the Fig. 7 sweep (``side_by_side``): the
    ``consolidation_sweep`` row of ``policy`` on ``n_nodes`` nodes on
    ``dev``.  Returns its ``ClusterResult``, the completion ticks, the
    loop's shape, ticks and wall seconds, its trace (on the host) and
    params, and the process's kernel launches."""
    from repro_torch.fleet import consolidation_sweep
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    calls = []
    with simulate_clock(calls):
        res = consolidation_sweep(total_fns=800, node_counts=(n_nodes,),
                                  policies=(policy,), backend="torch",
                                  duration_s=30.0, device=dev)
    require(len(res) == len(calls) == 1, f"{len(calls)} simulate calls")
    trace, p, out, secs = calls[0]
    return dict(res=res[0], done=out["done_tick"].cpu().numpy(),
                shape=tuple(trace.arrival_tick.shape), n_ticks=p.n_ticks,
                secs=secs, trace=type(trace)(*(t.cpu() for t in trace)),
                params=p, launches=ops.launch_counts())


def fig7(torch, card, results, wall):
    """The consolidation sweep on the card against the reference, and its
    10-node LAGS fleet on the CPU, from ``FIG7_RUNS``' ``results`` (run
    side by side, ``wall`` seconds).  Returns the ticks/s of the 10-node
    LAGS loop on the card and the CPU, its trace on the card and params,
    and the launches."""
    import numpy as np

    from repro_torch.fleet import min_nodes_meeting_slo

    rate, launches, by = {}, {}, dict(zip(FIG7_RUNS, results))
    for (pol, n, dev), r in by.items():
        add_counts(launches, r["launches"])
        res, (N, T, R), secs = r["res"], r["shape"], r["secs"]
        if dev == "cpu":
            continue
        p50, p95, ovh = REF_FIG7[pol, n]
        require((res.p50, res.p95) == (p50, p95),
                f"fig7 {pol} n={n}: p50, p95 {(res.p50, res.p95)}, the "
                f"reference {(p50, p95)}")
        sim_check(f"fig7 {pol} n={n}", res.overhead_frac, ovh,
                  "overhead share")
        rate[pol, n] = r["n_ticks"] / secs
        print(f"fig7 {pol} n={n}: p50 {res.p50:.4f} s, p95 "
              f"{res.p95:.4f} s, overhead share {res.overhead_frac:.6f}, "
              f"util {res.util_effective:.4f}, done {res.done_ratio:.4f}; one "
              f"loop over N={N} nodes (T={T}, R={R}) on the card: {secs:.3f} "
              f"s, {rate[pol, n]:.1f} ticks/s, "
              f"{N * rate[pol, n]:.0f} node-ticks/s [{card}]")
    res = [r["res"] for (_, _, dev), r in by.items() if dev == "cuda"]
    mins = {pol: min_nodes_meeting_slo(res, pol) for pol in ("cfs", "lags")}
    require(mins == {"cfs": 14, "lags": 14},
            f"min_nodes_meeting_slo {mins}, the reference 14 for both")
    print(f"fig7: the sweep's four loops and the CPU's side by side, each in "
          f"a process of its own, with phase 14's, {wall:.3f} s wall; p50 "
          f"and p95 equal the reference's, overhead within rtol 1e-5; "
          f"min_nodes_meeting_slo {mins}")
    card_run, cpu_run = by["lags", 10, "cuda"], by["lags", 10, "cpu"]
    require(np.array_equal(cpu_run["done"], card_run["done"]),
            "fig7 lags n=10: completion ticks differ on the card and the CPU")
    secs = cpu_run["secs"]
    rate["lags", 10, "cpu"] = cpu_run["n_ticks"] / secs
    print(f"fig7 lags n=10 on the CPU: the card's completion ticks; "
          f"{secs:.3f} s, {rate['lags', 10, 'cpu']:.1f} ticks/s, "
          f"{10 * rate['lags', 10, 'cpu']:.0f} node-ticks/s [{card}]")
    trace = type(card_run["trace"])(*(t.cuda() for t in card_run["trace"]))
    return rate, launches, trace, card_run["params"]


def simulators(torch, ops, card):
    """Phases 11 to 14: the tick simulator, the batched fleet and the chaos
    layer.  Fig. 11's nine runs side by side, then Fig. 7's five and the
    three chaos runs side by side (``side_by_side``); the profile of 200
    ticks in this process, between the two."""
    from repro_torch.core import simkernel_torch as st

    rate11, n, trace1, p1 = fig11(torch, card)
    t0 = time.perf_counter()
    results = side_by_side(_fleet_or_chaos,
                           [("fig7", *r) for r in FIG7_RUNS]
                           + [("chaos", *r) for r in CHAOS_RUNS])
    wall = time.perf_counter() - t0
    rate7, n7, trace10, p10 = fig7(torch, card, results[:len(FIG7_RUNS)],
                                   wall)
    add_counts(n, n7)
    require(not any(n.values()), f"the simulators launched {n}")
    ops.reset_launch_counts()
    busy = {}
    for label, trace, p in (("one node, Fig. 11 lags", trace1, p1),
                            ("10-node fleet, Fig. 7 lags", trace10, p10)):
        p200 = p._replace(n_ticks=200)
        st.simulate(trace, p200)
        wall_ms, busy_ms = profile(torch, f"simulate {label}, 200 ticks",
                                   lambda: st.simulate(trace, p200),
                                   n_steps=1)
        busy[label] = 100 * busy_ms / wall_ms
    add_counts(n, ops.launch_counts())
    print(f"simulators: Fig. 11 one node {rate11['lags', 'cuda']:.1f} ticks/s "
          f"on the card, {rate11['lags', 'cpu']:.1f} on the CPU (lags); "
          f"Fig. 7 10-node fleet {rate7['lags', 10]:.1f} ticks/s on the card, "
          f"{rate7['lags', 10, 'cpu']:.1f} on the CPU; device busy "
          + ", ".join(f"{k} {v:.1f}%" for k, v in busy.items())
          + f" (profiler on); hand-written kernel launches {json.dumps(n)} "
          f"[{card}]")
    chaos(card, results[len(FIG7_RUNS):])


def _fleet_or_chaos(kind, *args):
    return fig7_run(*args) if kind == "fig7" else chaos_run(*args)


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


def chaos_run(story, device=None):
    """One ``simulate_fleet_chaos(backend="torch")`` run of phase 14 on
    ``device`` (``None``: the card).  Returns the result, the wall seconds,
    the seconds inside the batched tick loops and inside the
    ``simulate_fleet`` calls, the ``chaos.*`` obs counters and the
    process's kernel launches."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import ops
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
    ops.reset_launch_counts()
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
            counters, ops.launch_counts())


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


CHAOS_RUNS = (("rack", None), ("partition", None), ("partition", "cpu"))


def chaos(card, results):
    """Phase 14: the chaos layer on the batched torch fleet at full size,
    from ``CHAOS_RUNS``' ``results`` (``chaos_run``, run side by side)."""
    import numpy as np

    runs, launches = {}, {}
    for (story, device), (res, wall, loop, fleet, counters, n) in zip(
            CHAOS_RUNS, results):
        add_counts(launches, n)
        where = "the card" if device is None else "the CPU"
        s = check_chaos(story, res, where)
        for name, attr in (("replayed", "replayed_arrivals"),
                           ("carried", "carried_arrivals"),
                           ("deferred", "deferred_arrivals")):
            c = counters.get(f"chaos.{name}_arrivals", 0.0)
            require(c == getattr(res, attr), f"chaos {story}: counter "
                    f"chaos.{name}_arrivals {c}, the result "
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
    require(not any(launches.values()), f"the chaos phase launched "
            f"{launches}")
    print("chaos: the rack story and the partition equal the reference on "
          "the card (counts, liveness, node sets, migrations, arrival "
          "ledger, latencies and percentiles; busy and switch within rtol "
          "1e-5); the partition's latencies on the CPU equal the card's "
          "(the three runs side by side with Fig. 7's, each in a process "
          f"of its own); hand-written kernel launches {json.dumps(launches)}")


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

    # phases 20 and 21 run every attention layer on fa_wgmma (positions,
    # D=80), none on fa_mma
    cfg = get_config("qwen2-vl-7b")
    t0 = time.perf_counter()
    params = init_full(torch, cfg)
    on_wgmma = {"flash_attention": cfg.n_layers, "fa_wgmma": cfg.n_layers,
                "fa_mma": 0}
    add_counts(counts, prefill_full(
        torch, ops, cfg, params, family_batch(torch, cfg, 4, 2048, "cuda"),
        32, on_wgmma))
    del params
    torch.cuda.empty_cache()
    print(f"phase 20 qwen2-vl-7b: {time.perf_counter() - t0:.1f} s wall")

    cfg = get_config("hubert-xlarge")
    t0 = time.perf_counter()
    params = init_full(torch, cfg)
    route = fa.route(torch.bfloat16, cfg.head_dim)
    require(route == "fa_wgmma", f"hubert's D=80 takes {route}, not fa_wgmma")
    add_counts(counts, prefill_full(
        torch, ops, cfg, params, family_batch(torch, cfg, 4, 2048, "cuda"),
        0, {"flash_attention": cfg.n_layers, "fa_wgmma": cfg.n_layers,
            "fa_mma": 0}, tail=0,
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
    """Phase 22, attention: the positioned forward (fa_wgmma, fa_mma at D
    16 and 32, fa_fwd) and the backward kernels, each call on its route
    (bf16 at D 64, 80 and 128 on the wgmma route, given no L: the wrapper
    runs the forward for it), against their plain versions."""
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
# the kinds of positions phase 22 gives the wgmma kernels
POSITION_KINDS = ("rising", "repeats", "unsorted", "no_key")


def position_kind(torch, gen, kind, B, S):
    """(q_pos, k_pos) int32 (B, S): rising with the row, with repeats and
    gaps (``train_positions``), the same shuffled (not monotonic), or the
    queries 9 behind the keys (their first 9 rows keep no key under a
    causal mask)."""
    idx = torch.arange(S, device="cuda", dtype=torch.int32).repeat(B, 1)
    if kind == "rising":
        return idx, idx
    if kind == "no_key":
        return idx - 9, idx
    pos = train_positions(torch, gen, B, S)
    if kind == "unsorted":
        perm = torch.argsort(torch.rand(B, S, generator=gen, device="cuda"), 1)
        pos = torch.gather(pos, 1, perm)
    return pos, pos
BWD_WGMMA_GROUPS = (1, 2, 4, 8, 16)
BWD_WGMMA_S = (1, 77, 300, 2048)


def check_flash_bwd_wgmma(torch, fa):
    """Phase 22, the wgmma backward route: at D 64 and 128, each mask of
    ``BWD_WGMMA_MASKS``, G in ``BWD_WGMMA_GROUPS`` and S in ``BWD_WGMMA_S``
    (B=2 and two KV heads below S=2048, one of each at it), the forward's L
    against ``flash_attention_lse_plain`` at f32 TOL with its output
    bit-equal to the no-gradient build's, then dq, dk, dv from that L
    against ``flash_attention_bwd_plain`` as ``close_kernel`` holds them;
    the largest tile error at S=1, G=16 is printed (ROADMAP Queue C item
    10).  At the two training shapes both routes (``mma`` by name), and two
    wgmma calls at stablelm's must give equal bits.  Then, from a
    generator of their own, the cases fa_wgmma took over from the mma
    kernels: the same grid at D=80, and given positions (``POSITION_KINDS``)
    at D 64, 80 and 128, G=7, S=300 and 2048 (the dK/dV kernel split over
    the group's heads), each mask; two calls under positions bit-equal.
    Returns {(shape, route): (max abs error, tile error)} of the training
    shapes."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(16)

    def one(B, H, Hkv, S, D, causal, window, route=None, twice=False,
            kind=None):
        q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, "bfloat16")
        do = flash_inputs(torch, gen, B, H, H, S, D, "bfloat16")[0]
        q_pos, k_pos = (None, None) if kind is None else position_kind(
            torch, gen, kind, B, S)
        kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos)
        name = (f"flash_attention_bwd {route or 'fa_bwd_wgmma'} B={B} H={H} "
                f"Hkv={Hkv} S={S} D={D} causal={causal} window={window}"
                + ("" if kind is None else f" positions={kind}"))
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
    n_cases, watch = 0, 0.0
    for D in (64, 128):  # the grid's first cases, drawn as before D=80
        for causal, window in BWD_WGMMA_MASKS:
            for G in BWD_WGMMA_GROUPS:
                for S in BWD_WGMMA_S:
                    B, Hkv = (2, 2) if S < 2048 else (1, 1)
                    tile = one(B, G * Hkv, Hkv, S, D, causal, window)[1]
                    if (S, G) == (1, 16):
                        watch = max(watch, tile)
                    n_cases += 1
    print(f"phase 22 wgmma backward, ROADMAP Queue C item 10: the largest "
          f"64-row tile error at S=1, G=16 (D 64 and 128, each mask) "
          f"{watch:.4g} <= {BF16_TILE_REL}")
    errs = {}
    for shape in (STABLELM_TRAIN, QWEN_TRAIN):
        for route in (None, "fa_bwd_mma"):
            errs[(tuple(shape.values()), route or "fa_bwd_wgmma")] = one(
                *shape.values(), True, 0, route=route,
                twice=route is None and shape is STABLELM_TRAIN)
    gen = torch.Generator(device="cuda").manual_seed(27)
    for causal, window in BWD_WGMMA_MASKS:
        for G in BWD_WGMMA_GROUPS:
            for S in BWD_WGMMA_S:
                B, Hkv = (2, 2) if S < 2048 else (1, 1)
                one(B, G * Hkv, Hkv, S, 80, causal, window)
                n_cases += 1
    for D in (64, 80, 128):
        for kind in POSITION_KINDS:
            for causal, window in BWD_WGMMA_MASKS:
                for S in (300, 2048):
                    one(1, 14, 2, S, D, causal, window, kind=kind,
                        twice=(S, causal, window) == (2048, True, 0))
                    n_cases += 1
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
    b, by = flash_bwd_bound(fa, B, H, Hkv, S, D, dtype)
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


# the attention shapes of phase 32's world-1 training steps whose bf16
# attention runs fa_wgmma's builds for positions and D=80: hubert-xlarge
# (non-causal, D=80) and qwen2-vl-7b (causal over given positions, M-RoPE's
# stream 0 off the row index in row 1: ``vision_positions``)
HUBERT_TRAIN = dict(B=2, H=16, Hkv=16, S=512, D=80, causal=False,
                    positions=False)
QWEN2VL_TRAIN = dict(B=1, H=28, Hkv=4, S=1536, D=128, causal=True,
                     positions=True)
# and the attention shapes of the prefills of phases 20 and 21 (B=4,
# S=2048): qwen2-vl-7b causal over stream 0 (the row index there) and
# hubert-xlarge full at D=80
QWEN2VL_PREFILL = dict(B=4, H=28, Hkv=4, S=2048, D=128, causal=True,
                       positions=True)
HUBERT_PREFILL = dict(B=4, H=16, Hkv=16, S=2048, D=80, causal=False,
                      positions=False)


def vision_positions(torch, B, S, moved=True):
    """(B, S) int32 stream 0 of phase 32's vision batches: the row index,
    row 1's (row 0's where B = 1) moved up by 3 from position 5 (so every
    rank takes the position masks); the row index alone where not
    ``moved``, as phase 20's prefill has it."""
    pos = torch.arange(S, dtype=torch.int32, device="cuda").repeat(B, 1)
    if moved:
        pos[min(1, B - 1), 5:] += 3
    return pos


def kept_bound(torch, fa, B, H, Hkv, S, D, causal, pos, products, tensors):
    """(bound ms, bound_by, the mask) of an attention call: ``products``
    S x D products over the (b, query, key) triples the mask keeps in this
    call's data, and ``tensors`` (B, S, heads, D) bf16 tensors each of H
    heads and of Hkv heads read or written once (forward: q, out and k, v;
    backward: q, o, dO, dQ and k, v, dK, dV), the positions read once
    each."""
    keep = fa._keep(pos, pos, B, S, causal, 0, "cuda")[:, 0]  # (B, 1, S, S)
    n_bytes = B * S * D * 2 * tensors * (H + Hkv) + (
        2 * B * S * 4 if pos is not None else 0)
    n_ops = products * 2 * int(keep.sum()) * D * H  # 2 flops an FMA
    b, by = bound_ms(n_bytes, n_ops, "bfloat16")
    return b, by, keep


def time_flash_prefill(torch, fa, timer, B, H, Hkv, S, D, causal,
                       positions):
    """Phase 23: the forward at a prefill shape of phases 20-21, on its
    route (``fa_wgmma``) and on ``fa_mma`` by name (the kernel the call ran
    on before), each checked against the plain version as ``close_kernel``
    holds it, then timed in turns (wgmma, mma, mma, wgmma), beside the
    plain version and, as a yardstick the port never calls, one
    ``scaled_dot_product_attention`` call with the same mask (a boolean
    mask where positions are given); the bound counts q.k and p.v over
    the pairs the mask keeps."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(24)
    q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, "bfloat16")
    pos = vision_positions(torch, B, S, moved=False) if positions else None
    kw = dict(causal=causal, q_pos=pos, k_pos=pos)
    route = fa.route(torch.bfloat16, D, positions)
    require(route == "fa_wgmma", f"D={D} positions={positions} runs {route}")
    name = (f"flash_attention B={B} H={H} Hkv={Hkv} S={S} D={D} "
            f"causal={causal} positions={positions} bf16")
    want = fa.flash_attention_plain(q, k, v, **kw)
    errs = {}
    for r in ("fa_wgmma", "fa_mma"):
        n0 = ops.launch_counts()[r]
        got = fa.flash_attention(q, k, v, route=r, **kw)
        torch.cuda.synchronize()
        require(ops.launch_counts()[r] == n0 + 1, f"{name}: {r} did not run")
        errs[r] = close_kernel(got, want, "bfloat16", f"{name} {r}",
                               quiet=True)
    del got, want
    runs = {}
    for r in ("fa_wgmma", "fa_mma", "fa_mma", "fa_wgmma"):
        runs.setdefault(r, []).append(timer.ms(
            lambda: fa.flash_attention(q, k, v, route=r, **kw), iters=10))
    # positions equal to the row index: the same function by index masks,
    # what the positions (their tables, the masks' loads) cost
    index_ms = (timer.ms(lambda: fa.flash_attention(q, k, v, causal=causal),
                         iters=10) if positions else None)
    plain_ms = timer.ms(lambda: fa.flash_attention_plain(q, k, v, **kw),
                        iters=3, warmup=1)
    b, by, keep = kept_bound(torch, fa, B, H, Hkv, S, D, causal, pos, 2, 2)
    lib_ms = library_ms(torch, timer, "SDPA prefill", lambda: (
        F.scaled_dot_product_attention(
            q, k, v, attn_mask=keep if positions else None,
            is_causal=causal and not positions, enable_gqa=True)), iters=10)
    del keep
    torch.cuda.empty_cache()
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(shape=name.split("flash_attention ")[1],
                max_abs_err=errs["fa_wgmma"][0],
                max_tile_rel_err=errs["fa_wgmma"][1],
                ms=mean(runs["fa_wgmma"]), runs_ms=runs["fa_wgmma"],
                index_ms=index_ms, plain_ms=plain_ms, library_ms=lib_ms,
                bound_ms=b, bound_by=by,
                mma=dict(max_abs_err=errs["fa_mma"][0],
                         max_tile_rel_err=errs["fa_mma"][1],
                         ms=mean(runs["fa_mma"]), runs_ms=runs["fa_mma"]))


def time_flash_bwd_train(torch, fa, timer, B, H, Hkv, S, D, causal,
                         positions):
    """Phase 23: the backward as training runs it at a shape that took the
    ``mma`` kernels before ``fa_wgmma`` took positions and D=80: the
    ``fa_bwd_wgmma`` route given the forward's L, and ``fa_bwd_mma`` by
    name on the same call, each checked against the plain version as
    ``close_kernel`` holds it, timed in turns (wgmma, mma, mma, wgmma)
    beside the plain version and, as a yardstick the port never calls, the
    backward of one ``scaled_dot_product_attention`` call with the same
    mask (a boolean mask where positions are given).  The bound counts the
    five products over the (query, key) pairs the mask keeps in this
    call's data."""
    import torch.nn.functional as F

    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(23)
    q, k, v = flash_inputs(torch, gen, B, H, Hkv, S, D, "bfloat16")
    do = flash_inputs(torch, gen, B, H, H, S, D, "bfloat16")[0]
    pos = vision_positions(torch, B, S) if positions else None
    kw = dict(causal=causal, q_pos=pos, k_pos=pos)
    require(fa.bwd_route(torch.bfloat16, D, positions) == "fa_bwd_wgmma",
            f"D={D} positions={positions} is not on the wgmma route")
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    name = (f"flash_attention_bwd B={B} H={H} Hkv={Hkv} S={S} D={D} "
            f"causal={causal} positions={positions}")
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    calls = {"fa_bwd_wgmma": dict(lse=lse), "fa_bwd_mma": dict(
        route="fa_bwd_mma")}
    errs = {}
    for r, extra in calls.items():
        n0 = ops.launch_counts()[r]
        got = fa.flash_attention_bwd(q, k, v, o, do, **kw, **extra)
        torch.cuda.synchronize()
        require(ops.launch_counts()[r] == n0 + 1, f"{name}: {r} did not run")
        res = [close_kernel(g, w, "bfloat16", f"{name} {r} d{t}", quiet=True)
               for t, g, w in zip("qkv", got, want)]
        errs[r] = (max(e for e, _ in res), max(x for _, x in res))
    del got, want
    runs = {}
    for r in ("fa_bwd_wgmma", "fa_bwd_mma", "fa_bwd_mma", "fa_bwd_wgmma"):
        runs.setdefault(r, []).append(timer.ms(
            lambda: fa.flash_attention_bwd(q, k, v, o, do, **kw, **calls[r]),
            iters=10))
    plain_ms = timer.ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, o, do, **kw), iters=3, warmup=1)
    b, by, keep = kept_bound(torch, fa, B, H, Hkv, S, D, causal, pos, 5, 4)
    qs, ks, vs = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=keep if positions else None,
        is_causal=causal and not positions, enable_gqa=True)
    lib_ms = library_ms(torch, timer, "SDPA backward",
                        lambda: torch.autograd.grad(out, (qs, ks, vs), do,
                                                    retain_graph=True),
                        iters=10)
    del out, qs, ks, vs, keep
    torch.cuda.empty_cache()
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    return dict(shape=name.split("flash_attention_bwd ")[1],
                max_abs_err=errs["fa_bwd_wgmma"][0],
                max_tile_rel_err=errs["fa_bwd_wgmma"][1],
                ms=mean(runs["fa_bwd_wgmma"]), runs_ms=runs["fa_bwd_wgmma"],
                plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b,
                bound_by=by,
                mma=dict(max_abs_err=errs["fa_bwd_mma"][0],
                         max_tile_rel_err=errs["fa_bwd_mma"][1],
                         ms=mean(runs["fa_bwd_mma"]),
                         runs_ms=runs["fa_bwd_mma"]))


def print_route_times(label, t, card):
    """One line: a timing of ``time_flash_prefill`` or
    ``time_flash_bwd_train``, the new route beside ``mma`` by name, the
    plain version, SDPA and the bound."""
    index = ("" if t.get("index_ms") is None else
             f", by index masks {t['index_ms']:.6g} ms")
    print(f"time {label} {t['shape']}: fa_wgmma route {t['ms']:.6g} ms "
          f"(runs {', '.join(f'{x:.6g}' for x in t['runs_ms'])}{index}), mma by "
          f"name {t['mma']['ms']:.6g} ms (runs "
          f"{', '.join(f'{x:.6g}' for x in t['mma']['runs_ms'])}), plain "
          f"{t['plain_ms']:.6g} ms, SDPA {t['library_ms']:.6g} ms, bound "
          f"{t['bound_ms']:.6g} ms ({t['bound_by']}); x_mma="
          f"{t['ms'] / t['mma']['ms']:.3f} x_library="
          f"{t['ms'] / t['library_ms']:.3f} x_bound="
          f"{t['ms'] / t['bound_ms']:.3f}; max_abs_err "
          f"{t['max_abs_err']:.3e}, 64-row tile error "
          f"{t['max_tile_rel_err']:.3e} (mma {t['mma']['max_abs_err']:.3e}, "
          f"{t['mma']['max_tile_rel_err']:.3e}) [{card}]")


def route_times(torch, fa, card):
    """Phase 23, attention at the shapes the new routes took over: the
    forward at the prefill shapes of phases 20 and 21, the backward at
    phase 32's training shapes of qwen2-vl-7b and hubert-xlarge.  The new
    route must beat the ``mma`` kernels it replaced at each, and at
    qwen2-vl-7b's training shape SDPA's backward.  Returns ({config:
    forward timing}, {config: backward timing})."""
    timer = Timer(torch)
    fwd = {"qwen2_vl": time_flash_prefill(torch, fa, timer,
                                          **QWEN2VL_PREFILL),
           "hubert": time_flash_prefill(torch, fa, timer, **HUBERT_PREFILL)}
    bwd = {"qwen2_vl": time_flash_bwd_train(torch, fa, timer,
                                            **QWEN2VL_TRAIN),
           "hubert": time_flash_bwd_train(torch, fa, timer, **HUBERT_TRAIN)}
    del timer
    for which, t in fwd.items():
        print_route_times(f"flash_attention at {which}'s prefill shape", t,
                          card)
    for which, t in bwd.items():
        print_route_times(f"flash_attention_bwd at {which}'s training shape",
                          t, card)
    for which, t in list(fwd.items()) + list(bwd.items()):
        require(t["ms"] < t["mma"]["ms"], f"{which} {t['shape']}: the wgmma "
                f"route's {t['ms']:.4f} ms is not below the mma kernels' "
                f"{t['mma']['ms']:.4f} ms")
    t = bwd["qwen2_vl"]
    require(t["ms"] < t["library_ms"], f"qwen2_vl {t['shape']}: the wgmma "
            f"backward's {t['ms']:.4f} ms is not below SDPA's "
            f"{t['library_ms']:.4f} ms")
    return fwd, bwd


def backward_times(torch, fa, ssm, card):
    """Phase 23: ``time_flash_bwd`` at stablelm-1.6b's and qwen3-8b's
    training shapes, ``route_times`` (the forward at the prefill shapes of
    qwen2-vl-7b and hubert-xlarge, the backward at their training shapes),
    and ``time_ssm_bwd`` at falcon-mamba's chunk, printed with their
    ratios; the wgmma route must beat the ``mma`` route at each of its
    attention shapes.  Returns the timings (``route_times``' two dicts by
    config)."""
    timer = Timer(torch)
    stablelm = time_flash_bwd(torch, fa, timer, **STABLELM_TRAIN)
    qwen3 = time_flash_bwd(torch, fa, timer, **QWEN_TRAIN)
    scan = time_ssm_bwd(torch, ssm, timer, **MAMBA_TRAIN_CHUNK)
    del timer
    fwd_new, bwd_new = route_times(torch, fa, card)
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
    return stablelm, qwen3, fwd_new, bwd_new, scan


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
    b, by = ssm_bound(ssm, B, S, I, N, backward=True)
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    # no one PyTorch call computes a selective scan or its gradient
    return dict(ms=mean(runs["bwd"]), plain_ms=plain_ms, library_ms=None,
                bound_ms=b, bound_by=by, runs_ms=runs["bwd"],
                forward_ms={k: mean(runs[k]) for k in ("plain", "ckpt")},
                timer=seen)


def bwd_entry(fa, counts, errs, stablelm, qwen3, train_new):
    """The kernels line's ``flash_attention_bwd``: the wgmma route that
    training runs, at stablelm-1.6b's shape and (``qwen3``) qwen3-8b's, and
    at qwen2-vl-7b's and hubert-xlarge's training shapes (``train_new``:
    under positions and at D=80, each with the ``mma`` kernels by name
    under ``mma``), with the ``mma`` kernels' route under ``mma``."""
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
        qwen3=numbers("fa_bwd_wgmma", "qwen3"), **train_new,
        mma=dict(kernel=("fa_bwd_dq_mma + fa_bwd_dkdv_mma (bf16 at head "
                         "dims 16, 32 and 96, and by name; f32: "
                         "fa_bwd_dq_f32 + fa_bwd_dkdv_f32)"),
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
    MEASURED["train", cfg.name, B, S] = step_s * 1e3
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


# -- phase 29: the dry run, the roofline, the figure drivers --------------

# The reference at the same cells (JAX 0.9.0 on the CPU; this script imports
# nothing of it): for each cell that ``repro.launch.dryrun --all`` builds,
# the bytes one device holds of the arguments and of the outputs (arch,
# shape, mesh): (arguments, outputs), by shard arithmetic over the
# ShapeDtypeStructs and PartitionSpecs of ``repro.launch.specs.
# build_lowerable`` on the production mesh (no compile).  The outputs are
# counted as ``repro_torch.launch.specs`` places them (the train state as
# its input plus five replicated f32 metrics; logits over ("batch",
# "vocab") and the cache under its logical axes), where the reference
# leaves them to XLA.  tests/test_torch_dryrun.py recomputes every entry.
REF_DRYRUN = {
    ("falcon-mamba-7b", "train_4k", "16x16"): (453017604, 452231192),
    ("falcon-mamba-7b", "prefill_32k", "16x16"): (92078080, 4603776),
    ("falcon-mamba-7b", "decode_32k", "16x16"): (896352292, 18415104),
    ("falcon-mamba-7b", "long_500k", "16x16"): (880295944, 2301888),
    ("gemma3-27b", "train_4k", "16x16"): (1064027140, 1063240728),
    ("gemma3-27b", "prefill_32k", "16x16"): (214010880, 2080440320),
    ("gemma3-27b", "decode_32k", "16x16"): (11704269860, 8325824512),
    ("hubert-xlarge", "train_4k", "16x16"): (219744772, 51448344),
    ("hubert-xlarge", "prefill_32k", "16x16"): (178260480, 2016),
    ("jamba-v0.1-52b", "train_4k", "16x16"): (2115563524, 2114777112),
    ("jamba-v0.1-52b", "prefill_32k", "16x16"): (424161280, 1075765248),
    ("jamba-v0.1-52b", "decode_32k", "16x16"): (1506586660, 276660224),
    ("jamba-v0.1-52b", "long_500k", "16x16"): (1767882760, 537899008),
    ("mistral-nemo-12b", "train_4k", "16x16"): (729935876, 729149464),
    ("mistral-nemo-12b", "prefill_32k", "16x16"): (146755584, 10737451008),
    ("mistral-nemo-12b", "decode_32k", "16x16"): (5004677156, 2685796352),
    ("qwen2-moe-a2.7b", "train_4k", "16x16"): (563286020, 562499608),
    ("qwen2-moe-a2.7b", "prefill_32k", "16x16"): (113217536, 805344352),
    ("qwen2-moe-a2.7b", "decode_32k", "16x16"): (5024063524, 3222950272),
    ("qwen2-vl-7b", "train_4k", "16x16"): (900626436, 781613080),
    ("qwen2-vl-7b", "prefill_32k", "16x16"): (172378112, 3758134400),
    ("qwen2-vl-7b", "decode_32k", "16x16"): (3434117252, 940134912),
    ("qwen3-8b", "train_4k", "16x16"): (501370884, 500584472),
    ("qwen3-8b", "prefill_32k", "16x16"): (100872192, 9663714400),
    ("qwen3-8b", "decode_32k", "16x16"): (4008366116, 2417250688),
    ("qwen3-moe-235b-a22b", "train_4k", "16x16"): (9459730436, 9458944024),
    ("qwen3-moe-235b-a22b", "prefill_32k", "16x16"): (1898256384, 12616504416),
    ("qwen3-moe-235b-a22b", "decode_32k", "16x16"): (6862813220, 3155808640),
    ("stablelm-1.6b", "train_4k", "16x16"): (66215940, 65429528),
    ("stablelm-1.6b", "prefill_32k", "16x16"): (13508608, 805331456),
    ("stablelm-1.6b", "decode_32k", "16x16"): (3428720676, 3222898688),
    ("falcon-mamba-7b", "train_4k", "2x16x16"): (452624388, 452231192),
    ("falcon-mamba-7b", "prefill_32k", "2x16x16"): (91947008, 2301888),
    ("falcon-mamba-7b", "decode_32k", "2x16x16"): (887177236, 9207552),
    ("falcon-mamba-7b", "long_500k", "2x16x16"): (880295944, 2301888),
    ("gemma3-27b", "train_4k", "2x16x16"): (1063633924, 1063240728),
    ("gemma3-27b", "prefill_32k", "2x16x16"): (213879808, 1040220160),
    ("gemma3-27b", "decode_32k", "2x16x16"): (7541488660, 4162912256),
    ("hubert-xlarge", "train_4k", "2x16x16"): (135596548, 51448344),
    ("hubert-xlarge", "prefill_32k", "2x16x16"): (94374400, 1008),
    ("jamba-v0.1-52b", "train_4k", "2x16x16"): (2115170308, 2114777112),
    ("jamba-v0.1-52b", "prefill_32k", "2x16x16"): (424030208, 537882624),
    ("jamba-v0.1-52b", "decode_32k", "2x16x16"): (1368289300, 138330112),
    ("jamba-v0.1-52b", "long_500k", "2x16x16"): (1767882760, 537899008),
    ("mistral-nemo-12b", "train_4k", "2x16x16"): (729542660, 729149464),
    ("mistral-nemo-12b", "prefill_32k", "2x16x16"): (146624512, 5368725504),
    ("mistral-nemo-12b", "decode_32k", "2x16x16"): (3661844500, 1342898176),
    ("qwen2-moe-a2.7b", "train_4k", "2x16x16"): (562892804, 562499608),
    ("qwen2-moe-a2.7b", "prefill_32k", "2x16x16"): (113086464, 402672176),
    ("qwen2-moe-a2.7b", "decode_32k", "2x16x16"): (3412664340, 1611475136),
    ("qwen2-vl-7b", "train_4k", "2x16x16"): (841119748, 781613080),
    ("qwen2-vl-7b", "prefill_32k", "2x16x16"): (164513792, 1879067200),
    ("qwen2-vl-7b", "decode_32k", "2x16x16"): (2964125764, 470067456),
    ("qwen3-8b", "train_4k", "2x16x16"): (500977668, 500584472),
    ("qwen3-8b", "prefill_32k", "2x16x16"): (100741120, 4831857200),
    ("qwen3-8b", "decode_32k", "2x16x16"): (2799816724, 1208625344),
    ("qwen3-moe-235b-a22b", "train_4k", "2x16x16"): (9459337220, 9458944024),
    ("qwen3-moe-235b-a22b", "prefill_32k", "2x16x16"): (1898125312, 6308252208),
    ("qwen3-moe-235b-a22b", "decode_32k", "2x16x16"): (5284984852, 1577904320),
    ("stablelm-1.6b", "train_4k", "2x16x16"): (65822724, 65429528),
    ("stablelm-1.6b", "prefill_32k", "2x16x16"): (13377536, 402665728),
    ("stablelm-1.6b", "decode_32k", "2x16x16"): (1817321492, 1611449344),
}
FULL_ATTN = "full-attention arch: long_500k skipped per spec"
NO_DECODE = "encoder-only arch has no decode step"
# ``repro.launch.specs.cell_skip_reason`` of the cells it skips, on each mesh
REF_SKIPPED = {
    ("gemma3-27b", "long_500k"): FULL_ATTN,
    ("hubert-xlarge", "decode_32k"): NO_DECODE,
    ("hubert-xlarge", "long_500k"): NO_DECODE,
    ("mistral-nemo-12b", "long_500k"): FULL_ATTN,
    ("qwen2-moe-a2.7b", "long_500k"): FULL_ATTN,
    ("qwen2-vl-7b", "long_500k"): FULL_ATTN,
    ("qwen3-8b", "long_500k"): FULL_ATTN,
    ("qwen3-moe-235b-a22b", "long_500k"): FULL_ATTN,
    ("stablelm-1.6b", "long_500k"): FULL_ATTN,
}
# ``benchmarks/serving_lags.py::main(densities=(24,))``'s derived column
# (the reference's engine, JAX 0.9.0 on the CPU); tests/test_torch_figures.py
# recomputes it
REF_SERVING = {
    "serving.t24.fifo": "done=1260/1589;p50=5.58;slo2s=12%;ovh=2.5%",
    "serving.t24.fair": "done=1235/1589;p50=4.16;slo2s=32%;ovh=4.9%",
    "serving.t24.lags": "done=1208/1589;p50=4.64;slo2s=29%;ovh=5.3%",
}
# step times of phases 7, 9 and 25 that phase 29 turns into shares of the
# card's peak: (step, arch, B, S) -> ms
MEASURED = {}


def dry_run_child(report):
    """Phase 29(a)'s child process: ``repro_torch.launch.dryrun --all``,
    its report to ``report`` and its output beside it (``.log``).  The dry
    run starts a fake default process group of its own and runs its cells
    in child processes of its own, one a core it may use, on the host alone
    (meta tensors, no card): so it runs beside this process's state, not in
    it, at the lowest priority (nice 19) and on every core but one, so that
    the card's phases keep the host first."""
    import atexit
    import os

    def lowly():
        os.nice(19)
        cores = sorted(os.sched_getaffinity(0))
        if len(cores) > 1:
            os.sched_setaffinity(0, cores[1:])

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(f"{report}.log", "w")
    # a session of its own: ``stop`` ends the dry run's workers with it
    child = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all", "--out",
         str(report)], cwd=ROOT, env=env, stdout=log,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
        preexec_fn=lowly)
    child.report, child.log, child.t0 = Path(report), log, time.perf_counter()

    def stop():
        if child.poll() is None:
            os.killpg(child.pid, 9)
            child.wait()

    child.stop = stop
    atexit.register(stop)
    return child


def check_dry_run(child):
    """Phase 29(a): 62 cells ok and 18 skipped with the reference's
    reasons; each ok cell's bytes a device, arguments and outputs, equal to
    ``REF_DRYRUN``; each ok cell's executed figures there (FLOPs, bytes
    accessed, collectives with wire bytes, temporaries, the step's
    seconds), only the code size unavailable, and no redistribution that
    DTensor planned by itself, nor any collective of one, in any ok
    cell."""
    try:
        child.wait(timeout=600)
    finally:
        child.log.close()
    wall = time.perf_counter() - child.t0
    out = Path(child.log.name).read_text()
    if child.returncode != 0:
        print("\n".join(x for x in out.splitlines()
                        if x.startswith("FAILED ")))
    require(child.returncode == 0, f"the dry run exited {child.returncode}: "
            f"{out[-2000:]}")
    cells = json.loads(child.report.read_text())
    ok = {(c["arch"], c["shape"], c["mesh"]): c for c in cells
          if c["status"] == "ok"}
    skipped = [c for c in cells if c["status"] == "skipped"]
    require(len(cells) == 80 and len(ok) == 62 and len(skipped) == 18,
            f"{len(cells)} cells: {len(ok)} ok, {len(skipped)} skipped")
    for c in skipped:
        want = REF_SKIPPED.get((c["arch"], c["shape"]))
        require(c["reason"] == want, f"{c['arch']} x {c['shape']} skipped "
                f"for {c['reason']!r}, the reference {want!r}")
    require(set(ok) == set(REF_DRYRUN), "the ok cells are not the "
            "reference's")
    for key, (args, outs) in REF_DRYRUN.items():
        c = ok[key]
        mem = c["memory"]
        got = (mem["argument_size_in_bytes"], mem["output_size_in_bytes"])
        require(got == (args, outs), f"{key}: bytes a device (arguments, "
                f"outputs) {got}, the reference {(args, outs)}")
        figures = (c["flops"], c["bytes_accessed"], c["collectives"],
                   mem["temp_size_in_bytes"], c["compile_s"])
        require(None not in figures and c["collectives"]["total_bytes"] > 0,
                f"{key}: executed figures {figures}")
        require(mem["generated_code_size_in_bytes"] is None and
                c["unavailable"].split(":")[0] ==
                "generated_code_size_in_bytes",
                f"{key}: unavailable {c['unavailable']!r}")
    lines = out.strip().splitlines()
    fit = next(x for x in lines if "above the card's" in x)
    own = next(x for x in lines if x.startswith("dry run: "))
    print(f"phase 29(a) dry run (a child process, a fake group of 512 ranks, "
          f"each cell's sharded step executed as rank 0 on meta DTensors): "
          f"62 cells ok, 18 skipped with the reference's reasons; arguments "
          f"and outputs a device equal to the reference's shard arithmetic in "
          f"every ok cell; FLOPs, bytes, collectives, temporaries and the "
          f"step's seconds in every ok cell; {fit}; {own}, {wall:.1f} s from "
          f"its start beside the card's phases to its end")
    # every collective goes through distributed/sharding.py: no DTensor
    # operation mixes placements that DTensor reconciles by itself (ROADMAP
    # Queue C item 19, on this machine's torch)
    import torch

    for field, what in (("dtensor_collectives", "collectives of DTensor's "
                         "own redistribution, by the op they served"),
                        ("dtensor_redistributions", "redistributions "
                         "DTensor planned by itself, collective or local")):
        own = {" x ".join(k): c[field] for k, c in ok.items() if c[field]}
        print(f"phase 29(a) {what} (torch {torch.__version__}): "
              f"{own or 'none'}")
        require(not own, f"{what} in {len(own)} cells: {own}")
    # the embedding's lookup at the reference's width (ROADMAP Queue C item
    # 23): qwen3-8b's prefill on 16x16 gathers the tokens over "data", sums
    # the rows of the table's 256 of 4096 columns a rank over "model" and
    # moves them to the batch split by one all-to-all over "data"
    c = ok[("qwen3-8b", "prefill_32k", "16x16")]
    want = ["all-gather s32[32,32768]", "all-reduce bf16[32,32768,256]",
            "all-to-all (" + ", ".join(["bf16[2,32768,256]"] * 16) + ")"]
    coll = c["collectives"]
    # an all-to-all's pieces, one a rank, as "<n> x <piece>"
    calls = [re.sub(r"\((bf16\[[0-9,]+\])(, \1)*\)",
                    lambda m: f"{m[0].count('bf16')} x {m[1]}", x)
             for x in c["lookup"]]
    print("phase 29(a) qwen3-8b x prefill_32k x 16x16: the lookup's "
          f"collectives {'; '.join(calls)} (the reference's: the width "
          f"split over \"data\"); all collectives "
          f"{coll['total_bytes'] / 1e9:.4f} GB a device, the all-reduces "
          f"{coll['all-reduce']['bytes'] / 1e9:.4f} GB")
    require(c["lookup"] == want, f"qwen3-8b x prefill_32k x 16x16: the "
            f"lookup's collectives {c['lookup']}, want {want}")
    top = sorted(ok.values(), key=lambda c: -c["memory"]["temp_size_in_bytes"])
    for c in top[:5]:
        mem = c["memory"]
        print(f"phase 29(a) temporaries {c['arch']} x {c['shape']} x "
              f"{c['mesh']}: {mem['temp_size_in_bytes'] / 1e9:.2f} GB, with "
              f"the arguments {(mem['temp_size_in_bytes'] + mem['argument_size_in_bytes']) / 1e9:.2f}"
              f" GB of the card's 80 GB")
    return child.report


def roofline_and_mfu(report, card):
    """Phase 29(b): the roofline rows over the dry run's report on the
    card's published figures, and the share of the card's bf16 peak that
    ``model_flops`` gives at each step time phases 7, 9 and 25 measured
    (printed as ``mfu=``)."""
    from benchmarks_torch import roofline
    from benchmarks_torch.flops_model import step_model_flops
    from repro_torch.launch.hlo_analysis import CHIP

    rows = roofline.main(str(report))
    terms = [dict(kv.split("=") for kv in r[2].split(";")) for r in rows]
    # a number in every row (printed to 4 decimals: a decode cell's wire
    # bytes take well under 0.1 ms of the links)
    require(len(rows) == 62 and all(r[0].startswith("roofline.") for r in rows)
            and all(float(t["collective_s"]) >= 0 for t in terms),
            f"{len(rows)} roofline rows, collective_s "
            f"{[t.get('collective_s') for t in terms]}")
    for (name, _, derived), t in zip(rows, terms):
        print(f"{name}: collective_s={t['collective_s']} "
              f"dominant={t['dominant']}; {derived}")
    for key in (("train", "stablelm-1.6b", 8, 2048),
                ("prefill", "qwen3-8b", 4, 2048),
                ("decode", "qwen3-8b", 16, 512)):
        step, arch, B, S = key
        if key not in MEASURED:
            print(f"phase 29(b) {step} {arch} B={B} S={S}: not measured in "
                  f"this run")
            continue
        ms = MEASURED[key]
        flops = step_model_flops(arch, step, B, S)
        share = flops / (ms * 1e-3) / CHIP.peak_flops
        print(f"phase 29(b) {step} {arch} B={B} S={S}: {ms:.6g} ms, "
              f"model_flops {flops:.4e}, mfu={share:.6f} of "
              f"{CHIP.peak_flops:.4g} FLOP/s dense bf16 [{card}]")


# phase 11 holds all seven Fig. 11 codes on the card; fig11_baselines'
# torch rows repeat the same host-bound tick loop, so phase 29(c) runs one
# of them: the one given static right-sizing
FIG11_ROW_POLICIES = ("lags-static",)


def drivers_on_card(torch, ops, card):
    """Phase 29(c): the figure drivers and the quickstart on the card:
    ``fig11_baselines``' ``fig11.torch.*`` rows of ``FIG11_ROW_POLICIES``
    equal to ``REF_FIG11``, ``serving_lags.main(densities=(24,))`` equal
    to ``REF_SERVING`` (no kernel: below 256 tenants the engine's credit tick
    runs on the host), and ``examples_torch/quickstart.py`` with its loss
    falling.  Returns their launches."""
    import runpy

    from benchmarks_torch import fig11_baselines, serving_lags

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rows = fig11_baselines.torch_rows(policies=FIG11_ROW_POLICIES)
    fig11_s = time.perf_counter() - t0
    require([r[0] for r in rows] == [f"fig11.torch.120fn-{p}" for p in
                                     FIG11_ROW_POLICIES], f"rows {rows}")
    for name, _, derived in rows:
        n, _, p50, p95, _, _ = REF_FIG11[name.split("-", 1)[1]]
        want = f"p50={p50:.3f};p95={p95:.3f};n={n}"
        require(derived == want, f"{name}: {derived}, the reference {want}")
        print(f"{name}: {derived} [{card}]")
    t0 = time.perf_counter()
    rows = serving_lags.main(densities=(24,))
    serving_s = time.perf_counter() - t0
    got = {name: derived for name, _, derived in rows}
    require(got == REF_SERVING, f"serving rows {got}, the reference "
            f"{REF_SERVING}")
    for name, derived in got.items():
        print(f"{name}: {derived} [{card}]")
    t0 = time.perf_counter()
    quick = runpy.run_path(str(ROOT / "examples_torch" / "quickstart.py"),
                           run_name="quickstart")["run"]()
    quick_s = time.perf_counter() - t0
    n = ops.launch_counts()
    losses = quick["losses"]
    require(losses[-1] < losses[0], f"the quickstart's loss {losses}")
    # the quickstart's reduced qwen3-8b: 2 attention layers, 30 steps,
    # remat; the serving sweep's 24 tenants stay below the engine's
    # pallas_threshold (256), where its credit tick runs on the host, as the
    # reference's does
    want = {"flash_attention": 2 * 2 * 30, "flash_attention_bwd": 2 * 30,
            "lags_select": 0}
    for kernel, w in want.items():
        require(n[kernel] == w, f"phase 29(c) {kernel} launches {n[kernel]}, "
                f"want {w}")
    print(f"phase 29(c) on the card: fig11.torch rows {fig11_s:.1f} s, equal "
          f"to REF_FIG11; serving.t24 rows {serving_s:.1f} s, equal to "
          f"REF_SERVING; quickstart {quick_s:.1f} s, loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}; launches {json.dumps(n)} [{card}]")
    return n


def figures(torch, ops, card, child=None):
    """Phase 29: the dry run in a child process (``child``, started beside
    the card's earlier phases; None starts it here) while the card runs
    the drivers, then the roofline and the shares of the card's peak.
    Returns the drivers' launches."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        if child is None:
            child = dry_run_child(Path(d) / "dryrun_report.json")
        try:
            n = drivers_on_card(torch, ops, card)
            report = check_dry_run(child)
        finally:
            child.stop()
        roofline_and_mfu(report, card)
    print(f"phase 29 the dry run, the roofline and the drivers: "
          f"{time.perf_counter() - t0:.1f} s wall")
    return n


# -- phase 30: prefill and decode sharded over two ranks on the card -------

SHARDED_RANKS = 2  # processes sharing cuda:0 over gloo: NCCL takes one a card
SHARDED_JOIN_S = 900  # the world fails, instead of hanging, past this


class ShardedJob(NamedTuple):
    """One run of phase 30: ``config`` reduced (with ``overrides``) or at
    full width (``overrides`` applied to it: a cut depth, the dtypes);
    ``limit``: how its logits are held to the world-1 run ("tol": f32 TOL,
    "cos": cosine >= 0.99 per prompt, None: printed only)."""
    config: str
    reduced: bool
    overrides: dict
    B: int
    S: int
    n_decode: int
    limit: str | None


# The reduced configs in f32 first (fa_fwd, dec_split), then Qwen3-8B (its
# first 8 of 36 layers) and falcon-mamba-7b (its first 8 of 64) at full
# width in bf16 (fa_wgmma, dec_mma, ssm_fwd<false>); both ran at full depth
# until the train step of every config joined phase 32, and the script's
# time asked for the cut.  The random falcon-mamba-7b is chaotic across its
# layers: a change in the last bits of a layer's output grows from layer
# to layer, and a contraction split over two ranks sums in another order,
# so at 64 layers in bf16 its logits kept no agreement with the world-1
# run (cosine 0.084).  They are printed; the Mamba path's function is held
# at full width on its first 4 layers in f32, and the f32 runs of its
# first 2 and 8 layers show the growth.
F32 = {"dtype": "float32", "param_dtype": "float32"}
SHARDED_JOBS = (
    ShardedJob("qwen3-8b", True, {"n_kv_heads": 2}, 2, 64, 4, "tol"),
    ShardedJob("falcon-mamba-7b", True, {}, 2, 64, 4, "tol"),
    ShardedJob("qwen3-8b", False, {"n_layers": 8}, 4, 2048, 8, "cos"),
    ShardedJob("falcon-mamba-7b", False, {"n_layers": 8}, 4, 1024, 8, None),
    ShardedJob("falcon-mamba-7b", False, {"n_layers": 2, **F32}, 4, 1024, 1,
               None),
    ShardedJob("falcon-mamba-7b", False, {"n_layers": 4, **F32}, 4, 1024, 8,
               "cos"),
    ShardedJob("falcon-mamba-7b", False, {"n_layers": 8, **F32}, 4, 1024, 1,
               None))
# Phase 31: the other families.  The reduced configs in f32 first, held to
# TOL as in phase 30; jamba's, whose reduced residual reaches ~1e11, to TOL
# widened by 4x the world-1 run's own move under 1e-7 noise on its
# embeddings (2 draws; tests/test_torch_sharded_families.py).  A window of
# 4 over a 20-token prompt crosses the two ranks' 18 cache rows in decode,
# and qwen2-vl's row 1 takes positions off the row index.  Then
# full width at phases 16-21's shapes, each on its first layers: jamba,
# qwen3-moe, qwen2-moe-a2.7b, qwen2-vl-7b and hubert-xlarge on 4, gemma3 on
# 6 (its global layer 5, decode past its window of 1024); until the train
# step of every config joined phase 32 they ran deeper (jamba, qwen3-moe
# and gemma3 on 8, 8 and 12 layers, the others at full depth), and the
# script's time asked for the cut; gemma3 and qwen2-vl held in bf16 at
# cosine >= 0.99.  The other random stacks amplify a last-bit difference
# (the ranks' partial sums meet in another order) from layer to layer, as
# falcon-mamba-7b's does in phase 30: in bf16 on an H100 80GB HBM3 at 700
# W, the MoE stacks' expert choices flip near ties (min cosine to the
# world-1 run 0.907 for qwen2-moe-a2.7b's 24 layers, 0.269 for qwen3-moe's
# 8) and hubert-xlarge's 48 non-causal layers reached 0.980.  So their
# bf16 logits are printed, and each is held in f32 at full width:
# qwen2-moe and qwen3-moe on their first 4 layers, jamba on 5 (Mamba, the
# attention layer at 4, MoE at 1 and 3), hubert on 4.  jamba's random 8
# layers in bf16 grew a residual whose square overflowed f32 in the final
# norm (logits 0 in both runs); each job runs every kernel of its layers
# at full width on a rank's shards.
FAMILY_JOBS = (
    ShardedJob("qwen2-moe-a2.7b", True, {}, 2, 64, 4, "tol"),
    ShardedJob("qwen3-moe-235b-a22b", True, {"n_heads": 16, "n_kv_heads": 1},
               2, 64, 4, "tol"),
    ShardedJob("jamba-v0.1-52b", True, {}, 2, 64, 4, "noise"),
    ShardedJob("gemma3-27b", True, {"sliding_window": 4}, 2, 20, 4, "tol"),
    ShardedJob("qwen2-vl-7b", True, {}, 2, 64, 4, "tol"),
    ShardedJob("hubert-xlarge", True, {}, 2, 64, 0, "tol"),
    ShardedJob("qwen2-moe-a2.7b", False, {"n_layers": 4}, 4, 2048, 8, None),
    ShardedJob("qwen2-moe-a2.7b", False, {"n_layers": 4, **F32}, 4, 2048, 8,
               "cos"),
    ShardedJob("jamba-v0.1-52b", False, {"n_layers": 4}, 2, 2048, 8, None),
    ShardedJob("jamba-v0.1-52b", False, {"n_layers": 5, **F32}, 2, 2048, 8,
               "cos"),
    ShardedJob("qwen3-moe-235b-a22b", False, {"n_layers": 4}, 2, 2048, 8,
               None),
    ShardedJob("qwen3-moe-235b-a22b", False, {"n_layers": 4, **F32}, 2, 2048,
               8, "cos"),
    ShardedJob("gemma3-27b", False, {"n_layers": 6}, 2, 1536, 8, "cos"),
    ShardedJob("qwen2-vl-7b", False, {"n_layers": 4}, 4, 2048, 8, "cos"),
    ShardedJob("hubert-xlarge", False, {"n_layers": 4}, 4, 2048, 0, None),
    ShardedJob("hubert-xlarge", False, {"n_layers": 4, **F32}, 4, 2048, 0,
               "cos"))
JOBS = {30: SHARDED_JOBS, 31: FAMILY_JOBS}
NOISE_DRAWS = 2
GLOO_COLLECTIVES = ("all_reduce", "all_gather_into_tensor",
                    "reduce_scatter_tensor", "broadcast", "all_to_all_single")


def sharded_cfg(job):
    import dataclasses

    from repro_torch.configs.base import get_config, reduced

    cfg = get_config(job.config)
    if job.reduced:
        return reduced(cfg, **job.overrides)
    return dataclasses.replace(cfg, **job.overrides)


def tree_bytes(tree):
    from repro_torch.distributed.sharding import local
    from repro_torch.train.tree import leaves

    return sum(local(t).numel() * local(t).element_size()
               for t in leaves(tree))


def rule_bytes(spec_tree, mesh, rules):
    """The bytes a rank's shards of ``spec_tree`` hold by ``rules``."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.tree import leaves

    sizes, total = sh.axis_sizes(mesh), 0
    for s in leaves(spec_tree):
        split = 1
        for entry in sh.to_pspec(s.logical, rules=rules, mesh=mesh,
                                 shape=s.shape):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= sizes[a]
        total += math.prod(s.shape) // split * s.dtype.itemsize
    return total


def gloo_cuda_collectives(torch, rank):
    """Which collectives the gloo group moves for CUDA tensors, each
    checked against its value: {name: "ok" or the error}."""
    import torch.distributed as dist

    dev, out = torch.device("cuda", 0), {}
    for name in GLOO_COLLECTIVES:
        x = torch.arange(4.0, device=dev) + 10 * rank
        try:
            if name == "all_reduce":
                dist.all_reduce(x)
                got, want = x, torch.arange(4.0) * 2 + 10
            elif name == "all_gather_into_tensor":
                got = torch.empty(8, device=dev)
                dist.all_gather_into_tensor(got, x)
                want = torch.cat([torch.arange(4.0), torch.arange(4.0) + 10])
            elif name == "reduce_scatter_tensor":
                got = torch.empty(2, device=dev)
                dist.reduce_scatter_tensor(got, x)
                want = (torch.arange(4.0) * 2 + 10)[2 * rank:2 * rank + 2]
            elif name == "broadcast":
                dist.broadcast(x, 0)
                got, want = x, torch.arange(4.0)
            else:
                got = torch.empty(4, device=dev)
                dist.all_to_all_single(got, x)
                want = torch.tensor([0.0, 1.0, 10.0, 11.0]) + 2 * rank
            out[name] = ("ok" if torch.equal(got.cpu(), want)
                         else f"wrong values {got.tolist()}")
        except Exception as e:  # noqa: BLE001 - recorded and required below
            out[name] = f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    return out


def sharded_batches(torch, cfg, B, S, n_decode, off_index=False):
    """The prefill batch and ``n_decode`` step batches of a sharded run,
    seeded, on the card: B prompts of S tokens (``token_batch``) and tokens
    from seed 9, or frames for the audio frontend; for the vision frontend
    ``n_vision_tokens`` random embeddings and ``mrope_positions``, the step
    at cache_len n at position n.  With ``off_index``, row 1's stream 0
    leaves the row index: +3 from position 5 in prefill, positions 5, 6,
    ... in decode (below the cache length, so its decode attends only the
    first rows)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn(
            B, S, cfg.d_model, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(8))}
    else:
        batch = token_batch(torch, cfg, B, S)
    toks = torch.randint(0, cfg.vocab_size, (n_decode, B, 1),
                         dtype=torch.int32, device="cuda", generator=gen)
    steps = [{"tokens": toks[i]} for i in range(n_decode)]
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(
            B, cfg.n_vision_tokens, cfg.d_model, device="cuda", generator=gen)
        pos = mrope_positions(torch, B, S, cfg.n_vision_tokens, "cuda")
        if off_index:
            pos[1, 5:, 0] += 3
        batch["positions"] = pos
        for i, st in enumerate(steps):
            st["positions"] = torch.full((B, 1, 3), S + i, dtype=torch.int32,
                                         device="cuda")
            if off_index:
                st["positions"][1, 0, 0] = 5 + i
    return batch, steps


def spec_bytes(spec_tree):
    from repro_torch.train.tree import leaves

    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in leaves(spec_tree))


def sharded_steps(torch, ops, cfg, B, S, n_decode, mesh=None, noise=0,
                  off_index=False):
    """Prefill of ``sharded_batches`` (B prompts of S positions) into a
    cache of S + 16 rows, then ``n_decode`` steps fed seeded tokens;
    parameters from seed 0 on the card (the encoder-only forward: prefill
    alone, no cache).  With ``mesh``: the parameters placed by their specs
    under ``TRAIN_RULES`` leaf by leaf as they are drawn, prefill under
    them, then the decode cell of ``launch/specs.build_lowerable`` on
    arguments placed by its ``in_shardings``, under its rules; the logits
    gathered.  Returns the logits (f32, CPU), the ms of the prefill and of
    each step, the launches of the main path (counted from 0 just before
    it), and with ``mesh`` the bytes each rank holds against the rules and
    the local shapes each kernel wrapper ran on.  With ``noise`` draws (no
    mesh), also how far the logits move when the embeddings (the frames
    for the audio frontend) move by 1e-7, relative: the run's own
    sensitivity, for a stack whose logits amplify last-bit differences."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.models import model
    from repro_torch.models.params import init_params, param_specs

    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda", mesh=mesh, rules=sh.TRAIN_RULES)
    out = {"full_bytes": spec_bytes(param_specs(cfg))}
    batch, steps = sharded_batches(torch, cfg, B, S, n_decode, off_index)
    L = S + specs.DECODE_PAD
    if mesh is not None:
        torch.cuda.empty_cache()
        out["param_bytes"] = [tree_bytes(params), rule_bytes(
            param_specs(cfg), mesh, sh.TRAIN_RULES)]

    def under(rules):
        return (sh.sharding_ctx(mesh, rules) if mesh is not None
                else contextlib.nullcontext())

    def gather(t):
        return sh.full(t).float().cpu()

    def prefill(b, p=None):
        with under(sh.TRAIN_RULES):
            return model.prefill(p or params, cfg, b, max_len=L,
                                 device="cuda")

    prefill(rows(batch, min(S, 64)))  # warm-up: cuBLAS, the kernels
    seen = {name: set() for name in ("flash_attention", "decode_attention",
                                     "ssm_scan")}
    originals = {name: getattr(ops, name) for name in seen}

    def recorder(name):
        def call(*a, **kw):
            seen[name].add((tuple(tuple(sh.local(t).shape) for t in a[:2]),
                            bool(kw.get("with_lse"))))
            return originals[name](*a, **kw)
        return call

    for name in seen:
        setattr(ops, name, recorder(name))
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        logits, cache = prefill(batch)
        logits = [gather(logits)]
        out["prefill_ms"] = (time.perf_counter() - t0) * 1e3
        step_rules = sh.DECODE_RULES
        if mesh is not None and cache is not None:
            out["cache_bytes_prefill"] = [tree_bytes(cache), rule_bytes(
                model.cache_specs(cfg, B, L), mesh, sh.TRAIN_RULES)]
            low = specs.build_lowerable(
                cfg, ShapeConfig("decode", S, B, "decode"), mesh)
            step_rules = low.rules
            # leaf by leaf: a second whole tree of qwen3-moe's 8 layers
            # would not fit beside two ranks' first
            params = sh.distribute(params, low.in_shardings[0], mesh,
                                   in_place=True)
            cache = sh.distribute(cache, low.in_shardings[2], mesh,
                                  in_place=True)
            torch.cuda.empty_cache()
        out["decode_ms"] = []
        for i, step in enumerate(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with under(step_rules):
                if mesh is not None:
                    step = sh.distribute(step, low.in_shardings[1], mesh)
                    lg, cache = low.fn(params, step, cache, S + i)
                else:
                    lg, cache = model.decode_step(params, cfg, step, cache,
                                                  S + i, device="cuda")
            logits.append(gather(lg))
            out["decode_ms"].append((time.perf_counter() - t0) * 1e3)
        out["counts"] = ops.launch_counts()
    finally:
        for name, fn in originals.items():
            setattr(ops, name, fn)
    if mesh is not None:
        out["param_bytes_decode"] = [tree_bytes(params), rule_bytes(
            param_specs(cfg), mesh, sh.DECODE_RULES if steps
            else sh.TRAIN_RULES)]
        if cache is not None:
            out["cache_bytes_decode"] = [tree_bytes(cache), rule_bytes(
                model.cache_specs(cfg, B, L), mesh, sh.DECODE_RULES)]
        out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    out["logits"] = logits
    del cache
    out["move"] = [0.0] * len(logits)
    for seed in range(noise):
        g = torch.Generator(device="cuda").manual_seed(100 + seed)
        noisy, b = dict(params), dict(batch)
        key, tree = (("frames", b) if cfg.frontend == "audio_frames"
                     else ("embed", noisy))
        tree[key] = tree[key] * (1 + 1e-7 * torch.randn(
            tree[key].shape, generator=g, device="cuda"))
        lg, c = prefill(b, noisy)
        moved = [gather(lg)]
        for i, step in enumerate(steps):
            lg, c = model.decode_step(noisy, cfg, step, c, S + i,
                                      device="cuda")
            moved.append(gather(lg))
        out["move"] = [max(m, float((x - y).abs().max())) for m, x, y in
                       zip(out["move"], moved, logits, strict=True)]
        del noisy, c
    del params
    torch.cuda.empty_cache()
    return out


def run_job(torch, ops, job, mesh=None):
    """One job of ``JOBS`` in this process (mesh None: the world-1 run)."""
    return sharded_steps(
        torch, ops, sharded_cfg(job), job.B, job.S, job.n_decode, mesh,
        noise=NOISE_DRAWS if job.limit == "noise" and mesh is None else 0,
        off_index=job.reduced)


def sharded_rank(rank, store, out_dir, phase):
    """One rank of phase 30 or 31: a gloo group of ``SHARDED_RANKS``
    processes on cuda:0, a (1, 2) ("data", "model") mesh, every job of
    ``JOBS[phase]`` with DTensor's own collectives and plans refused;
    writes its results to out_dir/rank{rank}.pt."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARDED_RANKS),
                            rank=rank, world_size=SHARDED_RANKS)
    try:
        from repro_torch.distributed import sharding as sh
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_local_mesh

        res = {"collectives": gloo_cuda_collectives(torch, rank)}
        sh.forbid_dtensor_collectives()  # every one through sharding
        sh.forbid_dtensor_plans()
        mesh = make_local_mesh(1, SHARDED_RANKS)
        for k, job in enumerate(JOBS[phase]):
            try:
                res[k] = run_job(torch, ops, job, mesh)
            except Exception as e:  # name the job in the rank's error
                raise RuntimeError(f"phase {phase} job {k}: {job}") from e
            dist.barrier()
        res["dtensor_plans"] = dict(sh.DTENSOR_PLANS)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def check_plans(phase, ranks):
    """Print the redistributions DTensor planned by itself in each rank of
    ``phase`` (``sharding.forbid_dtensor_plans`` refuses the first, so a
    rank that ran to its end holds none) and require none."""
    plans = [r["dtensor_plans"] for r in ranks]
    print(f"phase {phase} DTensor plans of its own, by rank: {plans}")
    require(not any(plans), f"phase {phase}: DTensor planned {plans}")


def expected_launches(cfg, S, n_decode):
    """{kernel: launches} of a prefill of S positions and ``n_decode``
    decode steps, per rank."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.models.mamba import CHUNK

    specs = layer_specs(cfg)
    n_attn = sum(s.kind == "attn" for s in specs)
    return {"flash_attention": n_attn, "decode_attention": n_attn * n_decode,
            "ssm_scan": (len(specs) - n_attn) * -(-S // CHUNK)}


def half_shapes(cfg, B, S, n_decode):
    """The local launch shapes of a full-width job on a rank of the (1, 2)
    mesh: heads H/2 and KV heads Hkv/2 for flash_attention, every head over
    L/2 cache rows with the log-sum-exp for decode_attention, inner
    channels I/2 in chunks of 256 for ssm_scan."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.models.mamba import CHUNK

    kinds = {s.kind for s in layer_specs(cfg)}
    H, Hkv, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    chunk = (B, min(S, CHUNK), cfg.d_inner // 2, cfg.ssm_state)
    return {"flash_attention": [(((B, H // 2, S, D), (B, Hkv // 2, S, D)),
                                 False)] if "attn" in kinds else [],
            "decode_attention": [(((B, H, D), (B, Hkv, (S + 16) // 2, D)),
                                  True)] if "attn" in kinds and n_decode
            else [],
            "ssm_scan": [((chunk, chunk), False)] if "mamba" in kinds else []}


def sharded_on_card(torch, ops, card, phase=30):
    """Phases 30 and 31: prefill and decode over a (1, 2) ("data", "model")
    mesh, each rank running the kernels on its shards.  The card has one
    H100 and NCCL refuses two ranks on one device, so the world is 2
    processes sharing cuda:0 over gloo, every rank's compute and kernels on
    the card.  Each job of ``JOBS[phase]`` runs first unsharded in this
    process (the world-1 run: the same seeded weights and batches; all of
    them before the ranks start, each freed after it), then in both ranks.
    Checks: the collectives gloo moves for CUDA tensors; each rank's
    parameter and cache bytes equal to its shards' by the rules (about half
    of the whole at full size); the launches of every kernel on the path
    and their local shapes (``half_shapes``); the gathered logits of the
    prefill and of every decode step finite, and against the world-1 run as
    each job's ``limit`` says (``SHARDED_JOBS``, ``FAMILY_JOBS``), with the
    logits' cosine and the share of equal argmax tokens printed.  Returns
    the launches of both ranks' main paths, summed."""
    import tempfile

    import torch.multiprocessing as mp
    import torch.nn.functional as F

    t_phase = time.perf_counter()
    jobs = JOBS[phase]
    world1 = []
    for job in jobs:
        world1.append(run_job(torch, ops, job))
        torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.spawn(sharded_rank, args=(f"{d}/store", d, phase),
                       nprocs=SHARDED_RANKS, join=False)
        deadline = time.monotonic() + SHARDED_JOIN_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                require(time.monotonic() < deadline, f"the {SHARDED_RANKS} "
                        f"ranks did not end in {SHARDED_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(SHARDED_RANKS)]
    check_plans(phase, ranks)
    coll = ranks[0]["collectives"]
    print(f"phase {phase} gloo moves for CUDA tensors (2 ranks on cuda:0): "
          + ", ".join(f"{k} {v}" for k, v in coll.items()))
    for r in ranks:
        require(all(v == "ok" for v in r["collectives"].values()),
                f"gloo collectives on CUDA tensors: {r['collectives']}")
    total, fails = {}, []

    def need(cond, msg):  # every job is printed before the phase fails
        if not cond:
            fails.append(msg)

    for k, job in enumerate(jobs):
        cfg, want = sharded_cfg(job), world1[k]
        B, S, n_decode, dtype = job.B, job.S, job.n_decode, cfg.dtype
        label = (f"{cfg.name} ({cfg.n_layers} layers, {dtype}, B={B}, S={S}, "
                 f"{n_decode} decode steps)")
        for r, res in enumerate(ranks):
            got = res[k]
            add_counts(total, got["counts"])
            keys = ("param_bytes", "cache_bytes_prefill",
                    "param_bytes_decode", "cache_bytes_decode")
            for key in keys if not cfg.encoder_only else keys[:1]:
                need(got[key][0] == got[key][1], f"{label} rank {r}: "
                        f"{key} {got[key][0]} held, {got[key][1]} by the "
                        f"rules")
            share = got["param_bytes_decode"][0] / got["full_bytes"]
            if not job.reduced:
                need(0.5 <= share < 0.51, f"{label} rank {r} holds "
                        f"{share:.4f} of the parameters' bytes")
            sizes = {k: v for k, v in got["counts"].items() if v}
            cache = got.get("cache_bytes_decode", [0])[0]
            print(f"phase {phase} {label} rank {r}: parameters "
                  f"{got['param_bytes'][0] / 1e9:.4f} GB of "
                  f"{got['full_bytes'] / 1e9:.4f} ({share:.4f}), cache "
                  f"{cache / 1e9:.4f} GB; launches {sizes}; local launch "
                  f"shapes {got['shapes']}")
            n = got["counts"]
            for kernel, w in expected_launches(cfg, S, n_decode).items():
                need(n[kernel] == w, f"{label} rank {r}: {kernel} "
                        f"launched {n[kernel]} times, want {w}")
            if not job.reduced:
                for kernel, w in half_shapes(cfg, B, S, n_decode).items():
                    need(got["shapes"][kernel] == w, f"{label} rank {r}: "
                            f"{kernel} shapes {got['shapes'][kernel]}, want "
                            f"{w}")
            for i, (g, w) in enumerate(zip(got["logits"], want["logits"],
                                           strict=True)):
                what = "prefill" if i == 0 else f"decode step {i}"
                need(bool(torch.isfinite(g).all()), f"{label} rank {r} "
                        f"{what}: non-finite logits")
                if job.limit in ("tol", "noise"):
                    tol = dict(TOL["float32"])
                    tol["atol"] += 4 * want["move"][i]
                    ok, err, bad = within(g, w, tol)
                    need(ok, f"{label} rank {r} {what}: {bad} logits "
                            f"outside {tol} of the world-1 run, max err "
                            f"{err}")
                elif job.limit == "cos":
                    cos = F.cosine_similarity(g, w, dim=-1)
                    need(float(cos.min()) >= 0.99, f"{label} rank {r} "
                            f"{what}: cosine {cos.tolist()} < 0.99")
        g0, w = ranks[0][k], want
        cos = [float(F.cosine_similarity(g, x, dim=-1).min())
               for g, x in zip(g0["logits"], w["logits"])]
        err = max(float((g - x).abs().max())
                  for g, x in zip(g0["logits"], w["logits"]))
        rel = max(float((g - x).norm() / x.norm())
                  for g, x in zip(g0["logits"], w["logits"]))
        same = [float((g.argmax(-1) == x.argmax(-1)).float().mean())
                for g, x in zip(g0["logits"], w["logits"])]
        zero = all(not x.any() for x in w["logits"] + g0["logits"])
        held = {None: " (printed, not held: chaotic across its layers"
                + ("; both runs' logits all 0" if zero else "") + ")",
                "noise": " (held to TOL + 4x the world-1 run's move under "
                f"1e-7 noise, moves {[f'{m:.3g}' for m in w['move']]})"}
        print(f"phase {phase} {label}: 2 ranks vs world 1"
              + held.get(job.limit, "") + ", logits min cosine "
              f"{min(cos):.6f} (prefill {cos[0]:.6f}), argmax tokens equal "
              f"{sum(same) / len(same):.4f} of the rows, max abs diff "
              f"{err:.4g}, relative difference (2-norm, largest step) "
              f"{rel:.4g}; argmax tokens, 2 ranks / world 1: " + "; ".join(
                  f"{g.argmax(-1).tolist()} / {x.argmax(-1).tolist()}"
                  for g, x in zip(g0["logits"], w["logits"])))
        mid = lambda x: sorted(x)[len(x) // 2]  # noqa: E731
        print(f"phase {phase} {label}: prefill " + ", ".join(
            f"rank {r} {res[k]['prefill_ms']:.1f} ms"
            for r, res in enumerate(ranks))
            + f" (world 1 {want['prefill_ms']:.1f} ms)" + (
                "; decode median " + ", ".join(
                    f"rank {r} {mid(res[k]['decode_ms']):.1f} ms a step"
                    for r, res in enumerate(ranks))
                + f" (world 1 {mid(want['decode_ms']):.1f} ms)"
                if n_decode else "")
            + "; the two ranks share one card and move their collectives "
            "through gloo on the host: not a multi-card speed [" + card + "]")
    print(f"phase {phase} prefill and decode sharded over 2 ranks: "
          f"{time.perf_counter() - t_phase:.1f} s wall")
    require(not fails, f"phase {phase}: " + "; ".join(fails))
    return total


# -- phase 32: the train step sharded over two ranks on the card -----------


class TrainJob(NamedTuple):
    """One run of phase 32: ``config`` at full width with ``overrides``
    (its cut depth, the dtypes), or with ``reduced`` the reduced config
    (with ``overrides``), on a ("data", "model") mesh of ``mesh`` over the
    two ranks, ``TRAIN_STEPS`` steps of a B x S batch; with ``fan_in``,
    each dense weight drawn by the reference's rule is scaled to std
    1/sqrt(its contraction width) (``fan_in_init``); ``held``: whether its
    loss, grad norm and update are held to the world-1 run (else printed
    only)."""
    config: str
    overrides: dict
    mesh: tuple
    B: int
    S: int
    fan_in: bool
    held: bool
    reduced: bool = False


# stablelm-1.6b on (2, 1): FSDP, each weight gathered over "data" before
# its product and its gradient reduce-scattered, the batch split;
# falcon-mamba-7b on (1, 2): the inner channels split over "model", so the
# scan and its backward run on half of them.  B = 2, S = 512 and 4 layers:
# gloo stages every collective of a CUDA tensor on the host, and a step
# with remat moves each layer's weights three times (the gather, its
# recomputation, the gradient's reduce-scatter).  Under the reference's
# init rule a cut-depth stack has large weights (std 1/sqrt(4) at 4
# layers, at widths of 2048 and 4096): its attention saturates and its
# scan's gradients reach 1e5-1e6, and a last-bit difference grows from
# layer to layer (ROADMAP Queue C item 9).  The bf16 runs with that init
# are printed; the function is held in f32 on the same widths with each
# dense weight at std 1/sqrt(its contraction width).
#
# The other six configs run on (1, 2), tensor parallel over "model"
# (heads, FFN width, experts, vocab, channels), each at full width and at
# the depth ``STATE_BUDGET`` allows (``cut_depth``): its state (parameters
# and gradients in its dtype, two f32 moments) must fit one card in the
# world-1 run, and so beside the other rank's half in the two ranks.  The
# f32 runs are held.  A bf16 run is added only where it launches a route
# of the attention backward that no f32 run launches: gemma3-27b's pattern
# of five windowed layers and a global one plus the two layers past it
# (the windowed ``fa_bwd_wgmma``; in f32 its 5 layers all lie before the
# first whole period, so none is decayed), hubert-xlarge (non-causal, D=80)
# and qwen2-vl-7b (positions off the row index), whose bf16 attention runs
# the D=80 and position builds of ``fa_wgmma`` and ``fa_bwd_wgmma``.  gemma3 and qwen2-vl take S = 1536, past gemma3's
# window of 1024 and past qwen2-vl's 1024 vision rows, at B = 1: every
# activation the ranks exchange crosses the host (gloo), so the script's
# time follows B x S.
#
# Last, qwen3-8b in f32 with one KV head on its first 2 layers: "model"
# splits its 32 query heads but not the KV head, so each rank pairs its
# query heads with the replicated KV head (``models/attention.py::
# _paired``) and the gradients of k and v are each rank's term of a sum
# (ROADMAP Queue C item 19).  No config pairs at tp 2 (every config's KV
# heads split over two ranks), so the override is the only way to reach
# that path with two ranks; its depth is chosen for the script's time, not
# by the budget.  Last, the reduced jamba with one KV head: its attention
# has neither rope nor qk-norm, so k's gradient meets the reshape of its
# projection straight from ``_paired``, where a strided partial gradient
# made DTensor plan a reduction on the CPU (ROADMAP Queue C item 22).  It
# runs its first 5 layers (Mamba, MoE at 1 and 3, the attention layer at
# 4), as phase 31 holds jamba: on an H100 80GB HBM3 at 700 W its 16 reduced
# layers held step 1 but moved step 2's grad norm by 3.23e-3 against a
# limit of 1.58e-3 (the witness's 3.71e-4), and with its own 4 KV heads
# step 1's gradients by 1.88e-4 of a leaf (the witness's 2.35e-4): the
# 16-layer stack amplifies the ranks' rounding beyond what the rule
# holds, with one KV head or four.
TRAIN_STEPS = 2
TRAIN_JOBS = (
    TrainJob("stablelm-1.6b", {"n_layers": 4}, (2, 1), 2, 512, False, False),
    TrainJob("stablelm-1.6b", {"n_layers": 4, **F32}, (2, 1), 2, 512, True,
             True),
    TrainJob("falcon-mamba-7b", {"n_layers": 4, **F32}, (1, 2), 2, 512, True,
             True),
    TrainJob("gemma3-27b", {"n_layers": 5, **F32}, (1, 2), 1, 1536, True,
             True),
    TrainJob("gemma3-27b", {"n_layers": 8}, (1, 2), 1, 1536, False, False),
    TrainJob("hubert-xlarge", F32, (1, 2), 2, 512, True, True),
    TrainJob("hubert-xlarge", {}, (1, 2), 2, 512, False, False),
    TrainJob("qwen2-vl-7b", {"n_layers": 11, **F32}, (1, 2), 1, 1536, True,
             True),
    TrainJob("qwen2-vl-7b", {"n_layers": 16}, (1, 2), 1, 1536, False, False),
    TrainJob("qwen2-moe-a2.7b", {"n_layers": 5, **F32}, (1, 2), 2, 512, True,
             True),
    TrainJob("qwen3-moe-235b-a22b", {"n_layers": 1, **F32}, (1, 2), 2, 512,
             True, True),
    TrainJob("jamba-v0.1-52b", {"n_layers": 2, **F32}, (1, 2), 2, 512, True,
             True),
    TrainJob("qwen3-8b", {"n_layers": 2, "n_kv_heads": 1, **F32}, (1, 2), 2,
             512, True, True),
    TrainJob("jamba-v0.1-52b", {"n_kv_heads": 1, "n_layers": 5}, (1, 2), 4,
             64, True, True, reduced=True))
# the jobs whose depth is chosen for the script's time, not by STATE_BUDGET
TIME_CUT = ("stablelm-1.6b", "falcon-mamba-7b", "qwen3-8b")
# the state of a job's world-1 run (and of its two ranks together) that its
# depth is cut to: the rest of the card holds the step's activations,
# its temporaries and the allocator's slack
STATE_BUDGET = 60e9
# A held run against the world-1 run: the first step's loss and grad norm
# within TRAIN_RTOL (relative), and each gradient leaf within TRAIN_RTOL of
# its largest |g| (tests/test_torch_train.py's rule); the second step's
# loss and grad norm within TRAIN_RTOL plus 4x the world-1 run's own move
# under TRAIN_NOISE (the same rule's other arm): AdamW's first update is
# about +-lr on every entry whatever its gradient's size, so an entry near
# 0 whose sign the ranks' sums flip moves by 2 lr, and the second step
# shows it (the flipped entries are counted and printed); the update (the
# parameters after the steps less before, every leaf flattened) at cosine
# >= 0.99 to the world-1 run's.
TRAIN_RTOL = 1e-4
TRAIN_NOISE = 1e-7
# the update's cosine is taken over the first entries of each leaf's rank
# shard, at most this many, and the gradients over their first
# GRAD_SAMPLE: enough for the checks, and the ranks' results cross the disk
UPDATE_SAMPLE = 1 << 20
GRAD_SAMPLE = 1 << 18
# the dense weights and how many leading dims each contracts (an expert
# weight, (E, in, out), its dim 1)
DENSE_CONTRACT = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1,
                  "w_down": 1, "in_proj": 1, "x_proj": 1, "dt_proj": 1,
                  "out_proj": 1, "conv_w": 1, "w_router": 1}


def fan_in_init(torch, cfg, params):
    """Scale each layer's dense weights, drawn by ``init_params`` (std
    1/sqrt(fan_in) with the reference's ``fan_in``: the stacked layer
    count inside the scanned stack), to std 1/sqrt(the product of the dims
    it contracts), in place (a DTensor's rank shard: every rank scales
    alike)."""
    from repro_torch.configs.base import scan_period
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.tree import flatten_with_path

    n_rep = cfg.n_layers // scan_period(cfg)
    n_stacked = n_rep * scan_period(cfg)
    with torch.no_grad():
        for i, layer in enumerate(params["layers"]):
            for path, w in flatten_with_path(layer):
                k = DENSE_CONTRACT.get(path[-1])
                if k is None:
                    continue
                ref = n_rep if i < n_stacked else w.shape[0]
                expert = path[0] == "moe" and w.dim() == 3
                dims = w.shape[1:2] if expert else w.shape[:k]
                sh.local(w).mul_(math.sqrt(max(ref, 1) / math.prod(dims)))


def state_bytes(cfg):
    """A train state's bytes: the parameters and their gradients in their
    dtypes, and two f32 moments."""
    from repro_torch.models.params import param_specs
    from repro_torch.train.tree import leaves

    return sum(math.prod(s.shape) * (2 * s.dtype.itemsize + 8)
               for s in leaves(param_specs(cfg)))


def train_cfg(job):
    """The config of a phase 32 job."""
    import dataclasses

    from repro_torch.configs.base import get_config, reduced

    if job.reduced:
        return reduced(get_config(job.config), **job.overrides)
    return dataclasses.replace(get_config(job.config), **job.overrides)


def cut_depth(job):
    """(the full config's layers, the job's state bytes, the state of one
    layer more or None at full depth); for the six configs' full-width
    jobs (those not in ``TIME_CUT``) the phase requires the state within
    ``STATE_BUDGET`` and one layer more beyond it."""
    import dataclasses

    from repro_torch.configs.base import get_config

    full = get_config(job.config)
    cfg = train_cfg(job)
    more = (None if cfg.n_layers >= full.n_layers else state_bytes(
        dataclasses.replace(cfg, n_layers=cfg.n_layers + 1)))
    return full.n_layers, state_bytes(cfg), more


def train_job_steps(torch, ops, job, mesh=None, noise=0.0):
    """``TRAIN_STEPS`` steps of ``job`` on the card: the state from seed 0
    (placed leaf by leaf as it is drawn with ``mesh``; with ``noise``,
    every parameter then moved by that much of itself, seeded), seeded
    batches of the data pipeline with a loss mask; with ``mesh``, the
    train cell of ``launch/specs.build_lowerable`` on arguments placed by
    its ``in_shardings``, under its rules.  Returns the losses and grad
    norms, the ms of each step, the launches of the steps (counted from 0
    just before them), the local shapes each kernel wrapper ran on, the
    bytes of the parameters and moments against the rules, the peak bytes
    above the state during a step, and of each leaf, by mesh coordinate,
    the first entries of the rank's shard (of every rank's of
    ``job.mesh`` without ``mesh``) of the first step's gradients before
    clipping (``grad_hook``; f32, CPU, with the largest |entry| of the
    rank's shard or of the whole leaf) and of the update (bf16, CPU)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch import specs
    from repro_torch.models.params import ParamSpec, param_specs
    from repro_torch.train import optimizer, train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.tree import flatten_with_path, map_tree

    cfg = train_cfg(job)
    B, S = job.B, job.S
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(
        lr=1e-3, warmup_steps=1, total_steps=TRAIN_STEPS))
    state = train_loop.init_state(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda",
        mesh=mesh, rules=sh.TRAIN_RULES)
    if job.fan_in:
        fan_in_init(torch, cfg, state.params)
    if noise:
        gen = torch.Generator(device="cuda").manual_seed(7)
        with torch.no_grad():
            for _, t in flatten_with_path(state.params):
                t.mul_(1 + noise * torch.randn(t.shape, generator=gen,
                                               device="cuda", dtype=t.dtype))
    stream = TokenStream(cfg, B, S, DataConfig())
    batches = []
    for i in range(TRAIN_STEPS):
        b = {k: torch.as_tensor(v, device="cuda")
             for k, v in stream.batch_at(i).items()}
        # rows keep unlike shares of their positions
        keep = torch.linspace(0.9, 0.4, B, device="cuda")[:, None]
        b["loss_mask"] = (torch.rand(B, S, generator=torch.Generator(
            device="cuda").manual_seed(20 + i), device="cuda") < keep).float()
        if "positions" in b:  # stream 0 off the row index: position masks
            b["positions"][..., 0] = vision_positions(torch, B, S)
        batches.append(b)
    out = {}
    if mesh is None:
        step = train_loop.make_train_step(cfg, tc)
    else:
        low = specs.build_lowerable(cfg, ShapeConfig("train", S, B, "train"),
                                    mesh, tc)
        step = low.fn
        batches = [sh.distribute(b, low.in_shardings[1], mesh)
                   for b in batches]
        specs_ = param_specs(cfg)
        f32 = map_tree(lambda s: ParamSpec(s.shape, torch.float32,
                                           s.logical), specs_)
        out["param_bytes"] = [tree_bytes(state.params), rule_bytes(
            specs_, mesh, sh.TRAIN_RULES)]
        out["moment_bytes"] = [tree_bytes((state.opt.mu, state.opt.nu)),
                               2 * rule_bytes(f32, mesh, sh.TRAIN_RULES)]
    out["full_bytes"] = spec_bytes(param_specs(cfg))
    # each leaf's first entries of each rank's shard: a rank's own, or in
    # the world-1 run every rank's of the job's mesh, split as the rules
    # split the leaf there (compared entry by entry, without a whole leaf
    # on the host or a second copy on the card)
    coords = ([tuple(mesh.get_coordinate())] if mesh is not None else
              list(itertools.product(*map(range, job.mesh))))
    abstract = sh.AbstractMesh(("data", "model"), job.mesh)
    dims = {"/".join(map(str, p)): [
        q.dim if q.is_shard() else None for q in sh.placements(sh.to_pspec(
            s.logical, rules=sh.TRAIN_RULES, mesh=abstract, shape=s.shape),
            abstract)] for p, s in flatten_with_path(param_specs(cfg))}

    def samples(key, t, n):
        if mesh is not None:
            return {coords[0]: head(sh.local(t), n)}
        return {c: head(shard_of(t, (c, job.mesh, dims[key])), n)
                for c in coords}

    before = {}
    for p, t in flatten_with_path(state.params):
        key = "/".join(map(str, p))
        before[key] = {c: x.float().clone() for c, x in samples(
            key, t.detach(), UPDATE_SAMPLE).items()}
    out["grads"], hook_s = {}, [0.0]

    @torch.no_grad()
    def first_grads(tree):  # its time is taken out of the step's
        if out["grads"]:
            return
        t0 = time.perf_counter()
        for p, g in flatten_with_path(tree):
            if mesh is not None:  # in the parameter's layout: no partial sum
                require(not any(q.is_partial() for q in g.placements),
                        f"the gradient of {p} is a partial sum")
            key = "/".join(map(str, p))
            lo, hi = torch.aminmax(sh.local(g).detach())
            # copied to the host before widening: no device memory is added
            out["grads"][key] = ({c: x.cpu().float() for c, x in samples(
                key, g.detach(), GRAD_SAMPLE).items()},
                max(-float(lo), float(hi)))
        hook_s[0] += time.perf_counter() - t0

    step.grad_hook = first_grads
    # the local shapes of the first two arguments of each wrapper's calls,
    # and of its backward kernels' (their autograd Functions call them by
    # their modules' names, on the rank's shards)
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm

    wrapped = {"flash_attention": ops, "ssm_scan": ops,
               "flash_attention_bwd": fa, "ssm_scan_bwd": ssm}
    seen = {name: set() for name in wrapped}
    originals = {name: getattr(mod, name) for name, mod in wrapped.items()}

    def recorder(name):
        def call(*a, **kw):
            seen[name].add(tuple(tuple(sh.local(t).shape) for t in a[:2]))
            return originals[name](*a, **kw)
        return call

    for name, mod in wrapped.items():
        setattr(mod, name, recorder(name))
    def ctx():
        return (sh.sharding_ctx(mesh, sh.TRAIN_RULES) if mesh is not None
                else contextlib.nullcontext())

    try:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out["loss"], out["grad_norm"], out["step_ms"] = [], [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ctx():
                state, m = step(state, b)
            out["loss"].append(float(m["loss"]))
            out["grad_norm"].append(float(m["grad_norm"]))
            out["step_ms"].append((time.perf_counter() - t0 - hook_s[0])
                                  * 1e3)
            hook_s[0] = 0.0
        out["counts"] = ops.launch_counts()
        out["peak_above_state"] = torch.cuda.max_memory_allocated() - base
    finally:
        step.grad_hook = None
        for name, fn in originals.items():
            setattr(wrapped[name], name, fn)
    out["shapes"] = {k: sorted(v) for k, v in seen.items()}
    out["update"] = {}
    for p, t in flatten_with_path(state.params):
        key = "/".join(map(str, p))
        # bf16 on the host: the cosine needs no more
        out["update"][key] = {
            c: (x.float() - before[key][c]).bfloat16().cpu()
            for c, x in samples(key, t.detach(), UPDATE_SAMPLE).items()}
    del state, before
    torch.cuda.empty_cache()
    return out


def train_sharded_rank(rank, store, out_dir):
    """One rank of phase 32: a gloo group of ``SHARDED_RANKS`` processes on
    cuda:0, every job of ``TRAIN_JOBS`` on its mesh with DTensor's own
    collectives and plans refused; writes its results to
    out_dir/rank{rank}.pt."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, SHARDED_RANKS),
                            rank=rank, world_size=SHARDED_RANKS)
    try:
        from repro_torch.distributed import sharding as sh
        from repro_torch.kernels import ops
        from repro_torch.launch.mesh import make_local_mesh

        sh.forbid_dtensor_collectives()  # every one through sharding
        sh.forbid_dtensor_plans()
        res = {}
        for k, job in enumerate(TRAIN_JOBS):
            t0 = time.perf_counter()
            try:
                res[k] = train_job_steps(torch, ops, job,
                                         make_local_mesh(*job.mesh))
                res[k]["wall_s"] = time.perf_counter() - t0
            except Exception as e:  # name the job in the rank's error
                raise RuntimeError(f"phase 32 job {k}: {job.config} "
                                   f"{job.overrides} on {job.mesh}") from e
            dist.barrier()
        res["dtensor_plans"] = dict(sh.DTENSOR_PLANS)
        torch.save(res, f"{out_dir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def shard_of(t, layout):
    """The rank's shard of the whole tensor ``t`` by ``layout`` (the mesh
    coordinate, the mesh's shape, and the tensor dim each mesh dimension
    splits or None), as DTensor splits it."""
    coord, shape, dims = layout
    for m, d in enumerate(dims):
        if d is not None:
            t = t.chunk(shape[m], dim=d)[coord[m]]
    return t


def head(t, n):
    """The first ``n`` entries of ``t`` in row-major order, copying only
    the leading rows they lie in."""
    if t.dim() == 0:
        return t.reshape(1)
    per_row = max(t[0].numel(), 1) if t.shape[0] else 1
    return t[:-(-n // per_row)].flatten()[:n]


def train_launches(torch, cfg, S):
    """{kernel: launches} of ``TRAIN_STEPS`` steps with remat, per rank
    (a vision config's batches carry positions off the row index)."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.mamba import CHUNK

    specs = layer_specs(cfg)
    n_attn = sum(s.kind == "attn" for s in specs)
    chunks = (len(specs) - n_attn) * -(-S // CHUNK)
    args = (getattr(torch, cfg.dtype), cfg.head_dim, cfg.frontend == "vision")
    want = {"flash_attention": 2 * n_attn, "flash_attention_bwd": n_attn,
            "ssm_scan_ckpt": 2 * chunks, "ssm_scan_bwd": chunks}
    # by route: fa_mma and fa_bwd_mma none in every job
    want.update({r: 2 * n_attn * (r == fa.route(*args)) for r in fa.ROUTES})
    want.update({r: n_attn * (r == fa.bwd_route(*args))
                 for r in fa.BWD_ROUTES})
    return {k: v * TRAIN_STEPS for k, v in want.items()}


def train_shapes(cfg, job, m):
    """{wrapper: [local shapes of its first two arguments]} the rank at
    ``m`` on "model" of ``job.mesh`` runs, forward and backward: attention
    on its batch rows and heads (the KV heads split with the query heads,
    or, where "model" does not split them, the ones its query heads read),
    the scan on its batch rows and inner channels, each chunk of at most
    256 steps."""
    from repro_torch.configs.base import layer_specs
    from repro_torch.models.mamba import CHUNK

    dp, tp = job.mesh
    B, S = job.B // dp, job.S
    kinds = {s.kind for s in layer_specs(cfg)}
    out = {}
    if "attn" in kinds:
        require(cfg.n_heads % tp == 0, f"{cfg.name}: {tp} ranks do not "
                f"split the query heads")
        hl = cfg.n_heads // tp
        kv = (cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else
              len({h // cfg.q_per_kv for h in range(m * hl, (m + 1) * hl)}))
        one = sorted({((B, hl, S, cfg.head_dim),
                       (B, kv, S, cfg.head_dim))})
        out["flash_attention"] = out["flash_attention_bwd"] = one
    if "mamba" in kinds:
        inner = cfg.d_inner // tp if cfg.d_inner % tp == 0 else cfg.d_inner
        one = sorted({((B, min(CHUNK, S - c), inner, cfg.ssm_state),) * 2
                      for c in range(0, S, CHUNK)})
        out["ssm_scan"] = out["ssm_scan_bwd"] = one
    return out


def grad_diff(got, want):
    """Step 1's gradients of two runs ({leaf: ({mesh coordinate: the first
    entries of that rank's shard}, largest |entry|)}): each of ``got``'s
    samples against the same entries of ``want``.  Returns (the largest
    |got - want| over the leaf's largest |want|, over the leaves, and its
    leaf; the entries whose signs differ; the entries compared)."""
    worst, leaf, flips, n = 0.0, None, 0, 0
    for key, (parts, _) in got.items():
        wparts, scale = want[key]
        for c, g in parts.items():
            w = wparts[c]
            err = float((g - w).abs().max()) / max(scale, 1e-30)
            if err > worst:
                worst, leaf = err, key
            flips += int((g.sign() != w.sign()).sum())
            n += g.numel()
    return worst, leaf, flips, n


def run_moves(a, b):
    """How far run ``b`` is from run ``a`` (``train_job_steps``' results):
    each step's larger relative difference of the loss and the grad norm,
    step 1's gradients (``grad_diff``) and the update's cosine, over the
    entries ``b`` sampled."""
    moves = [max(abs(x - y) / abs(y) for x, y in pairs) for pairs in zip(
        zip(b["loss"], a["loss"]), zip(b["grad_norm"], a["grad_norm"]))]
    dot = na = nb = 0.0
    for key, parts in b["update"].items():
        for c, upd in parts.items():
            upd, w = upd.double(), a["update"][key][c].double()
            dot += float((upd * w).sum())
            na += float(upd.square().sum())
            nb += float(w.square().sum())
    return {"steps": moves, "grads": grad_diff(b["grads"], a["grads"]),
            "cos": dot / max(math.sqrt(na * nb), 1e-300)}


def train_sharded_on_card(torch, ops, card):
    """Phase 32: the train step over a ("data", "model") mesh of two
    processes sharing cuda:0 over gloo (NCCL refuses two ranks on one
    device), each job of ``TRAIN_JOBS`` first unsharded in this process
    (the world-1 run: the same seeded weights and batches), then in both
    ranks; beside each held job, its witness (world 1 against world 1 with
    every parameter moved by ``TRAIN_NOISE``).  Each job's depth and its
    state's bytes are printed (``cut_depth``).  Checks: the six configs'
    depths are the deepest that ``STATE_BUDGET`` allows; each rank's
    parameter and moment bytes equal to its shards' by the rules; the
    launches of the attention and scan kernels, forward and backward (by
    route), on the steps, and the local shapes of both, forward and
    backward (``train_shapes``: half the batch rows on (2, 1), half the
    heads or inner channels on (1, 2), the one KV head whole); no gradient
    a partial sum; finite losses; for a held job the first step's loss,
    grad norm and gradients within ``TRAIN_RTOL`` of the world-1 run, the
    second step's loss and grad norm within ``TRAIN_RTOL`` plus 4x the
    witness's move, and the update's cosine >= 0.99.  The ranks refuse
    DTensor's own collectives and plans.  Returns the launches of both ranks' steps,
    summed."""
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.configs.base import get_config

    t_phase = time.perf_counter()
    world1, witness, fails = [], [], []
    for job in TRAIN_JOBS:
        n_full, state, more = cut_depth(job)
        cfg = train_cfg(job)
        n = cfg.n_layers
        cut = ("reduced" if job.reduced else f"at full depth, {n_full} layers"
               if n == n_full else f"cut to {n} of {n_full} layers")
        print(f"phase 32 {cfg.name} {cfg.dtype}: "
              f"{cut}; its state (parameters, gradients, two f32 moments) "
              f"{state / 1e9:.1f} GB" + ("" if more is None else
              f", {more / 1e9:.1f} GB with one layer more")
              + f" (budget {STATE_BUDGET / 1e9:.0f} GB of the card for the "
              f"world-1 run, and for the two ranks' halves beside each "
              f"other)")
        if job.config not in TIME_CUT and not job.reduced:
            if state > STATE_BUDGET or (more is not None
                                        and more <= STATE_BUDGET):
                fails.append(f"{job.config}: {n} layers is not the depth "
                             f"that {STATE_BUDGET / 1e9:.0f} GB allows")
        t0 = time.perf_counter()
        world1.append(train_job_steps(torch, ops, job))
        # the witness only for a held job: the same run, every parameter
        # moved by TRAIN_NOISE
        witness.append(run_moves(world1[-1], train_job_steps(
            torch, ops, job, noise=TRAIN_NOISE)) if job.held else None)
        world1[-1]["wall_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    t_world1 = time.perf_counter() - t_phase
    with tempfile.TemporaryDirectory() as d:
        ctx = mp.spawn(train_sharded_rank, args=(f"{d}/store", d),
                       nprocs=SHARDED_RANKS, join=False)
        deadline = time.monotonic() + SHARDED_JOIN_S
        try:
            while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
                require(time.monotonic() < deadline, f"the {SHARDED_RANKS} "
                        f"ranks did not end in {SHARDED_JOIN_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        ranks = [torch.load(f"{d}/rank{r}.pt") for r in range(SHARDED_RANKS)]
    check_plans(32, ranks)
    t_ranks = time.perf_counter() - t_phase - t_world1
    total = {}

    def need(cond, msg):  # every job is printed before the phase fails
        if not cond:
            fails.append(msg)

    for k, job in enumerate(TRAIN_JOBS):
        cfg = train_cfg(job)
        want, wit = world1[k], witness[k]
        label = (f"{cfg.name} ({cfg.n_layers} of "
                 f"{get_config(job.config).n_layers} layers, {cfg.dtype}, "
                 f"{'fan-in' if job.fan_in else 'reference'} init, "
                 f"B={job.B}, S={job.S}, mesh {job.mesh})")
        limits = ([TRAIN_RTOL] + [TRAIN_RTOL + 4 * m for m in
                                  wit["steps"][1:]] if wit else None)
        n_want = train_launches(torch, cfg, job.S)
        for r, res in enumerate(ranks):
            got = res[k]
            shapes_want = train_shapes(cfg, job, r % job.mesh[1])
            add_counts(total, got["counts"])
            for key in ("param_bytes", "moment_bytes"):
                need(got[key][0] == got[key][1], f"{label} rank {r}: "
                     f"{key} {got[key][0]} held, {got[key][1]} by the rules")
            for kernel, w in n_want.items():
                need(got["counts"][kernel] == w, f"{label} rank {r}: "
                     f"{kernel} launched {got['counts'][kernel]} times, want "
                     f"{w}")
            for kernel, shapes in got["shapes"].items():
                need(shapes == shapes_want.get(kernel, []), f"{label} rank "
                     f"{r}: {kernel} ran on local shapes {shapes}, want "
                     f"{shapes_want.get(kernel, [])}")
            need(all(math.isfinite(x) for x in got["loss"] + got["grad_norm"]),
                 f"{label} rank {r}: a loss or grad norm is not finite")
            got.update(run_moves(want, got))
            if job.held:
                for i, (m, lim) in enumerate(zip(got["steps"], limits)):
                    need(m <= lim, f"{label} rank {r}: step {i + 1}'s loss "
                         f"{got['loss'][i]} and grad norm "
                         f"{got['grad_norm'][i]} against the world-1 run's "
                         f"{want['loss'][i]}, {want['grad_norm'][i]}: "
                         f"relative difference {m:.3g} > {lim:.3g}")
                need(got["grads"][0] <= TRAIN_RTOL, f"{label} rank {r}: "
                     f"step 1's gradient {got['grads'][1]} differs from the "
                     f"world-1 run's by {got['grads'][0]:.3g} of its largest "
                     f"entry > {TRAIN_RTOL}")
                need(got["cos"] >= 0.99, f"{label} rank {r}: the update's "
                     f"cosine to the world-1 run's {got['cos']:.6f} < 0.99")
            sizes = {n: v for n, v in got["counts"].items() if v}
            print(f"phase 32 {label} rank {r}: parameters "
                  f"{got['param_bytes'][0] / 1e9:.4f} GB of "
                  f"{got['full_bytes'] / 1e9:.4f} (rules "
                  f"{got['param_bytes'][1] / 1e9:.4f}), moments "
                  f"{got['moment_bytes'][0] / 1e9:.4f} GB (rules "
                  f"{got['moment_bytes'][1] / 1e9:.4f}), peak above the "
                  f"state {got['peak_above_state'] / 1e9:.3f} GB (world 1 "
                  f"{want['peak_above_state'] / 1e9:.3f}); steps "
                  + ", ".join(f"{x:.1f}" for x in got["step_ms"])
                  + " ms (world 1 " + ", ".join(
                      f"{x:.1f}" for x in want["step_ms"]) + "); launches "
                  f"{sizes}; local launch shapes {got['shapes']} [{card}]")
        r0 = ranks[0][k]

        def worst(key, i=None):
            vals = [res[k][key] if i is None else res[k][key][i]
                    for res in ranks]
            return max(vals, key=lambda v: v[0] if isinstance(v, tuple)
                       else v)

        g = worst("grads")
        print(f"phase 32 {label}: 2 ranks vs world 1"
              + ("" if job.held else " (printed, not held: the reference's "
                 "init is chaotic at this depth, ROADMAP Queue C item 9)")
              + f": losses {[f'{x:.6f}' for x in r0['loss']]} / "
              f"{[f'{x:.6f}' for x in want['loss']]}, grad norms "
              f"{[f'{x:.6f}' for x in r0['grad_norm']]} / "
              f"{[f'{x:.6f}' for x in want['grad_norm']]}; relative "
              f"difference by step "
              + ", ".join(f"{worst('steps', i):.3g}" for i in range(
                  TRAIN_STEPS))
              + (" (limits " + ", ".join(f"{x:.3g}" for x in limits) + ")"
                 if job.held else "")
              + f"; step 1's gradients within {g[0]:.3g} of a leaf's "
              f"largest entry (worst {g[1]}), {g[2]} of {g[3]} sampled "
              f"entries of opposite sign; the update's cosine "
              f"{min(res[k]['cos'] for res in ranks):.6f}; the job's wall "
              f"{want['wall_s']:.1f} s in world 1 (with its witness), "
              f"{max(res[k]['wall_s'] for res in ranks):.1f} s in the ranks; "
              f"the two ranks share one card and move their collectives "
              f"through gloo on the host: not a multi-card speed [{card}]")
        if wit:
            wg = wit["grads"]
            print(f"phase 32 {label}: witness, world 1 against world 1 with "
                  f"every parameter moved by {TRAIN_NOISE:g} of itself: "
                  f"relative move by step "
                  + ", ".join(f"{x:.3g}" for x in wit["steps"])
                  + f"; step 1's gradients within {wg[0]:.3g} (worst "
                  f"{wg[1]}), {wg[2]} of {wg[3]} sampled entries of opposite "
                  f"sign; the update's cosine {wit['cos']:.6f} [{card}]")
    print(f"phase 32 the train step sharded over 2 ranks: "
          f"{time.perf_counter() - t_phase:.1f} s wall (the world-1 runs "
          f"and witnesses {t_world1:.1f} s, the ranks' from their spawn "
          f"{t_ranks:.1f} s)")
    require(not fails, "phase 32: " + "; ".join(fails))
    return total


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument(
        "--ssm-bwd-timing", type=int, metavar="RUNS",
        help="time only phase 23's scan (the backward and the forward's two "
             "builds) RUNS times over in a fresh process, and stop")
    parser.add_argument(
        "--attention-timing", action="store_true",
        help="time only phase 23's attention at the shapes the wgmma routes "
             "took over from the mma kernels (qwen2-vl-7b's and "
             "hubert-xlarge's prefill and training shapes) in a fresh "
             "process, and stop")
    parser.add_argument(
        "--only-distributed", action="store_true",
        help="build the kernels, run only phase 28 (the multi-device "
             "layer), and stop without the closing lines")
    parser.add_argument(
        "--only-figures", action="store_true",
        help="build the kernels, run only phase 29 (the dry run, the "
             "roofline and the figure drivers), and stop without the closing "
             "lines")
    parser.add_argument(
        "--only-train-sharded", action="store_true",
        help="build the kernels, run only phase 32 (the train step sharded "
             "over two ranks on the card), and stop without the closing "
             "lines")
    parser.add_argument(
        "--only-sharded", action="store_true",
        help="build the kernels, check decode_attention (phase 4's part, "
             "with its log-sum-exp output), run only phases 30 and 31 "
             "(prefill and decode sharded over two ranks on the card), and "
             "stop without the closing lines")
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
    if args.attention_timing:
        route_times(torch, fa, card)
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
    print("  dynamic shared memory a block (D=80 runs in D=128's layout): "
          f"fa_wgmma D=64 {fa_lib.flash_attention_wgmma_smem(64)} B, D=128 "
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
    if args.only_figures:
        figures(torch, ops, card)
        return
    if args.only_train_sharded:
        train_sharded_on_card(torch, ops, card)
        return
    if args.only_sharded:
        check_decode(torch, dec)  # the log-sum-exp output phase 30 merges
        sharded_on_card(torch, ops, card)
        sharded_on_card(torch, ops, card, 31)
        return

    # each phase's wall seconds, from the end of the one before
    t_lap = [time.perf_counter()]

    def lap(phases):
        now = time.perf_counter()
        print(f"wall: phases {phases} {now - t_lap[0]:.1f} s")
        t_lap[0] = now

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
            for k, v in t.items() if k not in ("lse", "runs_ms"))
            + f" x_bound={t['ms'] / t['bound_ms']:.3f}" + ratio + floor
            + f" [{card}]")
        if "lse" in t:
            print(f"time {name}: without the log-sum-exp output "
                  f"{', '.join(f'{x:.6g}' for x in t['runs_ms'])} ms, with "
                  f"it {', '.join(f'{x:.6g}' for x in t['lse']['runs_ms'])} "
                  f"ms (in turns: without, with, with, without) x_bound "
                  f"{t['lse']['ms'] / t['lse']['bound_ms']:.3f} with it "
                  f"[{card}]")

    # each kernel's launches, summed over every path the script drives
    # (each path counted from 0 just before it runs)
    counts = {}

    lap("3-5")
    # phase 6: the serving entry point on the cost model
    add_counts(counts, serve_cost_model(torch, ops, serve, t4096["ms"]))

    lap("6")
    # phase 7: the main path at full width
    check_model_small(torch)
    n, qwen = serve_qwen3_8b(torch, ops, serve, times["lags_select"]["ms"])
    add_counts(counts, n)

    lap("7")
    # phases 8-10: prefill, reduced on card and CPU, then at full size
    check_prefill_small(torch)
    cfg = get_config("qwen3-8b")
    add_counts(counts, prefill_full(
        torch, ops, cfg, qwen, token_batch(torch, cfg, 4, 2048), 64,
        {"flash_attention": 36}))
    del qwen  # 16 GB: falcon-mamba's weights take its place
    torch.cuda.empty_cache()
    add_counts(counts, mamba_full(torch, ops))

    lap("8-10")
    # phases 11-14: the tick simulator, the batched fleet and the chaos
    # layer, their tick loops side by side
    simulators(torch, ops, card)

    lap("11-14")
    # phase 29(a)'s dry run on the host alone, beside phases 15-28: after
    # phases 11-14, whose tick loops run side by side in nine processes
    dry_dir = tempfile.TemporaryDirectory()
    dry_run = dry_run_child(Path(dry_dir.name) / "dryrun_report.json")
    # phase 15: the reduced families, card against CPU
    t0 = time.perf_counter()
    check_families_small(torch)
    print(f"phase 15 reduced families: {time.perf_counter() - t0:.1f} s wall")

    lap("15")
    # phase 16: qwen2-moe-a2.7b served and prefilled at full size
    t0 = time.perf_counter()
    add_counts(counts, serve_moe(torch, ops, serve))
    torch.cuda.empty_cache()
    print(f"phase 16 qwen2-moe-a2.7b: {time.perf_counter() - t0:.1f} s wall")

    lap("16")
    # phases 17-18: full width, the first 8 layers
    for phase, name in ((17, "jamba-v0.1-52b"), (18, "qwen3-moe-235b-a22b")):
        t0 = time.perf_counter()
        add_counts(counts, reduced_depth(torch, ops, name, 8))
        print(f"phase {phase} {name} (8 of {get_config(name).n_layers} "
              f"layers): {time.perf_counter() - t0:.1f} s wall")

    lap("17-18")
    # phases 19-21: gemma3, qwen2-vl and hubert at full size
    families_full(torch, ops, counts)

    lap("19-21")
    # phase 22: the training kernels against their plain versions
    check_flash_train(torch, fa)
    fa_bwd_err = check_flash_bwd_wgmma(torch, fa)
    check_decode_positions(torch, dec)
    ssm_bwd_err = check_ssm_train(torch, ssm)

    lap("22")
    # phase 23: the backward kernels' times at the training shapes
    (times["flash_attention_bwd"], fa_bwd_qwen, fa_prefill_new, fa_bwd_new,
     times["ssm_scan_bwd"]) = backward_times(torch, fa, ssm, card)

    lap("23")
    # phase 24: reduced train steps, card against CPU
    t0 = time.perf_counter()
    check_train_small(torch)
    print(f"phase 24 reduced train steps: {time.perf_counter() - t0:.1f} s "
          f"wall")

    lap("24")
    # phase 25: stablelm-1.6b at full width and depth through the train CLI
    add_counts(counts, train_stablelm(torch, ops))
    torch.cuda.empty_cache()

    lap("25")
    # phase 26: full width, cut depth
    for name, n_layers, B, S in (("qwen3-8b", 4, 4, 2048),
                                 ("falcon-mamba-7b", 8, 2, 1024)):
        add_counts(counts, train_cut_depth(torch, ops, name, n_layers, B, S))
        torch.cuda.empty_cache()

    lap("26")
    # phase 27: checkpoint, kill and resume on the card
    resume_on_card()

    lap("27")
    # phase 28: the multi-device layer on a world-1 NCCL group
    n, _ = distributed_on_card(torch, ops, card)
    add_counts(counts, n)

    lap("28")
    # phase 29: the dry run, the roofline and the figure drivers
    add_counts(counts, figures(torch, ops, card, dry_run))

    lap("29")
    # phase 30: prefill and decode sharded over two ranks on the card
    add_counts(counts, sharded_on_card(torch, ops, card))

    lap("30")
    # phase 31: the MoE, hybrid, windowed, vision and encoder-only families
    # sharded over two ranks on the card
    add_counts(counts, sharded_on_card(torch, ops, card, 31))

    lap("31")
    # phase 32: the train step sharded over two ranks on the card
    add_counts(counts, train_sharded_on_card(torch, ops, card))

    lap("32")
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
             launches_by_route={r: counts[r] for r in fa.ROUTES},
             max_abs_err=fa_err[("bfloat16", *QWEN_PREFILL.values(), True, 0)],
             **times["flash_attention"],
             # the prefill shapes of phases 20 and 21, on fa_wgmma under
             # positions and at D=80, with fa_mma by name under ``mma``
             **fa_prefill_new),
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
                  fa_bwd_qwen, fa_bwd_new),
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
