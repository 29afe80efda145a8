#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` only (no JAX, nothing of ``repro``):

1. card: name and power limit from ``nvidia-smi``;
2. build: the five CUDA sources from ``src/repro_torch/kernels/csrc``, in
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
   model's (B, L, Hkv, D) cache view; ``flash_attention`` at the
   reference's test shapes for (causal, 0), (causal, 128), (causal, 64) and
   (non-causal, 0), GQA cases, S=1 and ragged S read through the
   (B, S, H, D) projection view, and the Qwen3-8B prefill shape, where each
   64-row query tile of each (b, h) is also held to a relative error
   ||got - want|| / ||want||; f32 and bf16 at the reference's tolerances;
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
    ``ssm_scan`` launches, then 32 decode steps, with the same numbers and
    checks as phase 9;
11. a ``{"kernels": [...]}`` line (each kernel's CUDA function on the main
    path under ``kernel``), then ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits nonzero without the last line.
It exits nonzero at once where no card is present.
"""
from __future__ import annotations

import contextlib
import ctypes
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
    two events is the call's work on the card, not the host's Python."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")
        # the first timed loop of a process reads several times high, the
        # same call timed later does not: one untimed loop first
        self.ms(lambda: None)

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(SLEEP_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


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


def dec_inputs(torch, gen, B, H, Hkv, L, D, dtype, kv_len):
    """q (B, H, D) and the model's (B, L, Hkv, D) cache, seen as
    (B, Hkv, L, D) views."""
    dt = getattr(torch, dtype)
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dt)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    return q, k, v, torch.tensor(kv_len, dtype=torch.int32, device="cuda")


def dec_shapes():
    # (B, H, Hkv, L, D, kv_len): tests/test_kernels.py at G=1, then the
    # engine's shape for Qwen3-8B (G=4) with kv_len from 1 to L, L-7 among
    # them, then the decode after phase 9's prefill (B*Hkv = 32 heads: the
    # kernel splits L 4 ways, kv_len on and beside a split's edge)
    out = [(1, 2, 2, 512, 64, [512 // 3]), (2, 4, 4, 1024, 128, [512, 1024 - 7])]
    for L in (512, 4096):
        kv = [L - 7, L, 1, L // 2] + [(97 * i) % L + 1 for i in range(12)]
        out.append((16, 32, 8, L, 128, kv))
    out.append((4, 32, 8, 2112, 128, [2049, 1728, 1729, 2112]))
    return out


def check_decode(torch, dec):
    gen = torch.Generator(device="cuda").manual_seed(1)
    errs = {}
    for dtype in ("float32", "bfloat16"):
        for B, H, Hkv, L, D, kv_len in dec_shapes():
            q, k, v, kv = dec_inputs(torch, gen, B, H, Hkv, L, D, dtype, kv_len)
            got = dec.decode_attention(q, k, v, kv)
            want = dec.decode_attention_plain(q, k, v, kv)
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = TOL[dtype]
            bad = ((got.float() - want.float()).abs()
                   > tol["atol"] + tol["rtol"] * want.float().abs()).sum()
            require(int(bad) == 0 and math.isfinite(err),
                    f"decode_attention {dtype} B={B} H={H} Hkv={Hkv} L={L} "
                    f"D={D}: {int(bad)} values outside {tol}, max err {err}")
            errs[(dtype, B, H, Hkv, L, D)] = err
            print(f"decode_attention {dtype} B={B} H={H} Hkv={Hkv} L={L} "
                  f"D={D} G={H // Hkv}: max_abs_err={err:.3e} within {tol}")
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
    # that are no multiple of the 64-row tile; then the Qwen3-8B prefill
    out = [(1, 1, 1, 128, 64), (2, 2, 2, 256, 128), (1, 4, 4, 512, 128),
           (2, 8, 2, 300, 64), (1, 4, 2, 77, 16), (2, 4, 4, 200, 80),
           (2, 4, 2, 130, 64), (1, 8, 1, 1, 128)]
    out = [c + (FLASH_MASKS,) for c in out]
    return out + [tuple(QWEN_PREFILL.values()) + ([(True, 0)],)]


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


def to(tree, dev):
    """A copy of a parameter or cache tree on ``dev``."""
    if isinstance(tree, dict):
        return {k: to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to(v, dev) for v in tree]
    return tree.to(dev)


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
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    n_params = count_params(params)
    print(f"qwen3-8b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.3f} B params in {cfg.param_dtype}, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card, "
          f"init {time.perf_counter() - t0:.1f} s")

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


def profile(torch, label, step, n_steps=3):
    """Where a step's time goes: device time by kernel, and the share of
    the step's wall time the card is busy."""
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
    busy = sum(r[0] for r in rows)
    print(f"profile {label} (profiler on): wall {wall_ms:.3f} ms, "
          f"kernels {busy:.3f} ms, device busy {100 * busy / wall_ms:.1f}%")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms {count:5d}x  {key[:110]}")


# -- phases 8 to 10 -------------------------------------------------------


def check_prefill_small(torch):
    """The reduced prefill in f32 on the card (kernels) against the CPU
    (plain versions): logits and every cache leaf, then one decode step."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model
    from repro_torch.models.params import init_params

    # S = 100 leaves a ragged 64-row tile; S = 300 a ragged 256-token chunk
    for name, overrides, S in (("qwen3-8b", {"n_kv_heads": 2}, 100),
                               ("falcon-mamba-7b", {}, 300)):
        cfg = reduced(get_config(name), n_layers=2, **overrides)
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        toks = torch.randint(0, cfg.vocab_size, (3, S + 1), dtype=torch.int32,
                             generator=torch.Generator().manual_seed(1))
        out = {}
        for dev in ("cpu", "cuda"):
            p, t = to(params, dev), toks.to(dev)
            logits, cache = model.prefill(p, cfg, {"tokens": t[:, :S]},
                                          max_len=S + 1, device=dev)
            step, cache = model.decode_step(p, cfg, {"tokens": t[:, S:]},
                                            cache, S, device=dev)
            out[dev] = [logits, step] + [v for c in cache for v in c.values()]
        worst = 0.0
        for got, want in zip(out["cuda"], out["cpu"]):
            want = want.float()
            err = float((got.float().cpu() - want).abs().max())
            require(err <= 1e-4 + 1e-4 * float(want.abs().max()),
                    f"reduced {name} prefill: card vs CPU max err {err}")
            worst = max(worst, err / max(1.0, float(want.abs().max())))
        print(f"reduced {name} f32 prefill S={S} + 1 decode step: card "
              f"(kernels) = CPU (plain versions) in logits and "
              f"{len(out['cpu']) - 2} cache leaves, worst error / scale "
              f"{worst:.3e}")


def prefill_full(torch, ops, cfg, params, B, S, n_decode, kernel, launches):
    """Prefill of B prompts of S random tokens, then ``n_decode`` greedy
    decode steps from its cache.  The prefill must launch ``kernel``
    ``launches`` times.  Returns those launches."""
    import torch.nn.functional as F

    from repro_torch.configs.base import layer_specs
    from repro_torch.models import model

    max_len = S + n_decode
    toks = torch.randint(0, cfg.vocab_size, (B, S), dtype=torch.int32,
                         device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(8))
    run = lambda t, n=max_len: model.prefill(  # noqa: E731
        params, cfg, {"tokens": t}, max_len=n, device="cuda")
    run(toks[:, :64])  # warm-up: cuBLAS and the kernels' first launches
    torch.cuda.synchronize()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = run(toks)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    n = ops.launch_counts()
    require(n[kernel] == launches,
            f"{kernel} launches {n[kernel]} in the {cfg.name} prefill, "
            f"want {launches}")
    require(logits.shape == (B, cfg.vocab_size), f"logits {logits.shape}")
    require(bool(torch.isfinite(logits).all()),
            f"{cfg.name} prefill: non-finite logits")
    secs = [first_s]
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run(toks)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    med = sorted(secs)[1]
    print(f"prefill {cfg.name} B={B} S={S}: median {med * 1e3:.3f} ms "
          f"(runs {', '.join(f'{x * 1e3:.3f}' for x in secs)} ms), "
          f"{B * S / med:.0f} tokens/s; launches {json.dumps(n)}")

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
    require(nd["decode_attention"] == n_attn * n_decode,
            f"decode_attention launches {nd['decode_attention']} after the "
            f"prefill, want {n_attn} x {n_decode}")
    require(bool(torch.isfinite(step).all()),
            f"{cfg.name} decode after prefill: non-finite logits")
    step_ms = sorted(a.elapsed_time(b) for a, b in ev[3:])
    print(f"decode {cfg.name} B={B} from the prefill's cache, positions "
          f"{S}..{S + n_decode - 1}: median {step_ms[len(step_ms) // 2]:.3f} "
          f"ms a step; launches {json.dumps(nd)}")
    del cache

    # prefill(S) against prefill(S - 1) and one decode step
    _, short = run(toks[:, :S - 1], S)
    last, short = model.decode_step(params, cfg, {"tokens": toks[:, S - 1:]},
                                    short, S - 1, device="cuda")
    del short
    cos = F.cosine_similarity(logits.float(), last.float(), dim=-1)
    require(bool(torch.isfinite(last).all()) and float(cos.min()) >= 0.99,
            f"{cfg.name}: prefill vs prefill + decode cosine "
            f"{cos.tolist()} < 0.99")
    print(f"consistency {cfg.name}: last logits of prefill(S={S}) vs "
          f"prefill(S-1) + decode, cosine similarity min {float(cos.min()):.6f} "
          f"(per prompt {', '.join(f'{c:.6f}' for c in cos.tolist())}); "
          f"max abs diff {float((logits.float() - last.float()).abs().max()):.4f}")
    profile(torch, f"prefill {cfg.name} B={B} S={S}", lambda: run(toks),
            n_steps=1)
    return n[kernel]


def mamba_full(torch, ops):
    from repro_torch.configs.base import get_config
    from repro_torch.models.mamba import CHUNK
    from repro_torch.models.params import count_params, init_params

    cfg = get_config("falcon-mamba-7b")
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                         device="cuda")
    torch.cuda.synchronize()
    print(f"falcon-mamba-7b: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"d_inner {cfg.d_inner}, {count_params(params) / 1e9:.3f} B params "
          f"in {cfg.param_dtype}, {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB on the card, init {time.perf_counter() - t0:.1f} s")
    residual_growth(torch, cfg, params)
    B, S = 4, 1024
    return prefill_full(torch, ops, cfg, params, B, S, 32, "ssm_scan",
                        cfg.n_layers * -(-S // CHUNK))


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
            x = blocks.apply_layer(cfg, spec, p, x, None, c)
            peaks.append(float(x.float().abs().max()))
    bad = [i for i, v in enumerate(peaks) if not math.isfinite(v)]
    require(not bad, f"{cfg.name}: the residual overflows at layer "
            f"{bad[:1]}")
    shown = [i for i in (1, 2, 4, 8, 16, 32, 64) if i <= len(peaks)]
    print(f"residual {cfg.name} B={B} S={S} max |x| after layers "
          + ", ".join(f"{i}: {peaks[i - 1]:.3e}" for i in shown))


def main():
    import torch

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

    # phase 2: build every kernel, one nvcc each, in parallel
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        rows = ptxas_report(log.read_text() if log.exists() else "")
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
    dec_lib = _build.library("decode_attention", {
        "decode_attention_smem": ([ctypes.c_int, ctypes.c_int], ctypes.c_int)})
    print("  dynamic shared memory a block: fa_wgmma D=64 "
          f"{fa_lib.flash_attention_wgmma_smem(64)} B, D=128 "
          f"{fa_lib.flash_attention_wgmma_smem(128)} B; dec_mma (bf16) D=128 "
          f"{dec_lib.decode_attention_smem(1, 128)} B, dec_split (f32) D=128 "
          f"{dec_lib.decode_attention_smem(0, 128)} B")

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

    # phase 6: the serving entry point on the cost model
    serve_cost_model(torch, ops, serve, t4096["ms"])

    # phase 7: the main path at full width
    check_model_small(torch)
    counts, qwen = serve_qwen3_8b(torch, ops, serve,
                                  times["lags_select"]["ms"])

    # phases 8-10: prefill, reduced on card and CPU, then at full size
    check_prefill_small(torch)
    counts["flash_attention"] = prefill_full(
        torch, ops, get_config("qwen3-8b"), qwen, B=4, S=2048, n_decode=64,
        kernel="flash_attention", launches=36)
    del qwen  # 16 GB: falcon-mamba's weights take its place
    torch.cuda.empty_cache()
    counts["ssm_scan"] = mamba_full(torch, ops)

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
             max_abs_err=dec_err[("bfloat16", 16, 32, 8, 512, 128)],
             **times["decode_attention"]),
        dict(name="flash_attention", route="cuda",
             kernel=fa.route(torch.bfloat16, QWEN_PREFILL["D"]),
             source="src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
             replaces="src/repro/kernels/flash_attention.py:77",
             launches=counts["flash_attention"],
             max_abs_err=fa_err[("bfloat16", *QWEN_PREFILL.values(), True, 0)],
             **times["flash_attention"]),
        dict(name="ssm_scan", route="cuda",
             source="src/repro_torch/kernels/csrc/ssm_scan.cu",
             replaces="src/repro/kernels/ssm_scan.py:51",
             launches=counts["ssm_scan"],
             max_abs_err=ssm_err[tuple(MAMBA_CHUNK.values())],
             **times["ssm_scan"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
