#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives ``repro_torch`` only (no JAX, nothing of ``repro``):

1. card: name and power limit from ``nvidia-smi``;
2. build: both CUDA kernels from ``src/repro_torch/kernels/csrc``, in
   parallel, with the compiler's register and spill report;
3. ``lags_select`` against its plain PyTorch version: T in {256, 1024,
   4096, 65536} with k=16, few runnable tenants, all credits equal, and credits
   below 1e-4 where the key's lane term decides the order.  Picks must be
   equal and the state bit-equal;
4. ``decode_attention`` against its plain version: the reference's test
   shapes at G=1, and the engine's shape B=16, H=32, Hkv=8, D=128 at
   L in {512, 4096} with kv_len including L-7, read through the model's
   (B, L, Hkv, D) cache view; f32 and bf16 at the reference's tolerances;
5. times at the main path's shapes: kernel, plain version, and for decode
   attention ``scaled_dot_product_attention`` as a yardstick (the port never
   calls it), with the least time the card could take (``bound_ms``);
6. serving on the cost model: ``repro_torch.launch.serve.main`` at 4096
   tenants; its credit kernel launches once per busy engine step; a 300-tenant
   run on the card prints the same summary as on the CPU;
7. serving with Qwen3-8B at full width and depth (36 layers, bf16, random
   weights from seed 0) on 16 slots with 1024 tenants and max_len 512: 511
   decode steps, 36 decode-attention launches each, finite logits, and the
   same scheduling as the CPU engine (first, the reduced decoder in f32 on
   the card equals the CPU's); then the ms of one decode step at the full
   cache, and a profile of it by kernel;
8. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.

Any failed check raises, and the script exits nonzero without the last line.
It exits nonzero at once where no card is present.
"""
from __future__ import annotations

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
    weights) leaves it cold."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32, device="cuda")

    def ms(self, fn, iters=20, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        pairs = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            pairs.append((s, e))
        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in pairs) / iters


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

    return {"T256_k16": rand(256, 16), "T1024_k16": rand(1024, 16),
            "T4096_k16": rand(4096, 16), "T65536_k16": rand(65536, 16),
            "few_runnable": few(), "all_equal": equal(), "sub_1e-4": sub_1e4()}


def check_lags(torch, lags):
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {}
    for name, (load, credit, frac, runnable, k, window) in lags_cases(
            torch, gen).items():
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
        errs[name] = max(float((got[0] - want[0]).abs().max()),
                         float((got[1] - want[1]).abs().max()))
        print(f"lags_select {name}: T={load.shape[0]} k={k} picks equal, "
              f"state bit-equal, first picks {got[2][:4].tolist()}")
    return errs


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
    # engine's shape for Qwen3-8B (G=4) with kv_len from 1 to L, L-7 among them
    out = [(1, 2, 2, 512, 64, [512 // 3]), (2, 4, 4, 1024, 128, [512, 1024 - 7])]
    for L in (512, 4096):
        kv = [L - 7, L, 1, L // 2] + [(97 * i) % L + 1 for i in range(12)]
        out.append((16, 32, 8, L, 128, kv))
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


# -- phase 5 --------------------------------------------------------------


def time_lags(torch, lags, timer, T, k=16):
    gen = torch.Generator(device="cuda").manual_seed(2)
    u = lambda: torch.rand(T, generator=gen, device="cuda")  # noqa: E731
    args = (u() * 2, u() * 2, u(), u() < 0.5, k)
    ms = timer.ms(lambda: lags.lags_select(*args))
    plain_ms = timer.ms(lambda: lags.lags_select_plain(*args))
    # each input read once (3 f32 + 1 bool), each output written once
    n_bytes = T * (3 * 4 + 1) + T * 2 * 4 + k * 4
    n_ops = T * 9  # 4 mul + 2 add (tick), mul + add (key), 1 compare
    b, by = bound_ms(n_bytes, n_ops, "float32")
    return dict(ms=ms, plain_ms=plain_ms, library_ms=None, bound_ms=b,
                bound_by=by)


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
    library_ms = timer.ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask, enable_gqa=True))
    esize = 2 if dtype == "bfloat16" else 4
    n_rows = sum(kv_len)  # cache rows this kv_len needs, per KV head
    n_bytes = (2 * B * H * D * esize  # q in, out
               + 2 * n_rows * Hkv * D * esize  # K and V rows once
               + B * 4)
    n_ops = 4 * n_rows * H * D  # q.k and p.v, 2 flops a multiply-add
    b, by = bound_ms(n_bytes, n_ops, dtype)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=b,
                bound_by=by)


# -- phases 6 and 7 -------------------------------------------------------


def summary(st):
    lat = sorted(r.latency for r in st.completed)
    return (len(st.completed), st.membership_changes, st.steps, st.idle_steps,
            tuple(lat))


def serve_cost_model(torch, ops, serve):
    # the card and the CPU schedule alike: the kernel's state is bit-equal
    argv = ["--tenants", "300", "--duration", "2"]
    on_card = summary(serve.main(argv))
    on_cpu = summary(serve.main(argv + ["--device", "cpu"]))
    require(on_card == on_cpu, "300-tenant serve differs on the card and CPU")

    ops.reset_launch_counts()
    st = serve.main(["--tenants", "4096", "--duration", "5"])
    torch.cuda.synchronize()
    n = ops.launch_counts()
    busy = st.steps - st.idle_steps
    require(n["lags_select"] == busy > 0,
            f"lags_select launches {n['lags_select']} != busy steps {busy}")
    require(len(st.completed) > 0, "no request completed at 4096 tenants")
    print(f"serve 4096 tenants: steps={st.steps} busy_steps={busy} "
          f"lags_select launches={n['lags_select']}")


def check_model_small(torch):
    """The reduced decoder on the card (kernels) against the CPU (plain
    versions), in f32: the same logits and greedy tokens."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.models import model
    from repro_torch.models.params import init_params

    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

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


def serve_qwen3_8b(torch, ops, serve):
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
    torch.cuda.synchronize()
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
    profile_decode(torch, lambda: model.decode_step(
        params, cfg, {"tokens": tokens}, eng._cache, max_len - 1,
        device="cuda"))
    return n


def profile_decode(torch, step, n_steps=3):
    """Where a decode step's time goes: device time by kernel, and the
    share of the step's wall time the card is busy."""
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
    print(f"profile decode step (profiler on): wall {wall_ms:.3f} ms, "
          f"kernels {busy:.3f} ms, device busy {100 * busy / wall_ms:.1f}%")
    for ms, count, key in rows[:12]:
        print(f"  {ms:8.3f} ms {count:5d}x  {key[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)

    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import lags_select as lags
    from repro_torch.launch import serve

    # phase 1: the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")

    # phase 2: build both kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    built = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s wall "
          f"({', '.join(f'{k} {v:.1f} s' for k, v in built.items())})")
    for name in _build.SOURCES:
        log = (_build.BUILD_DIR / f"{name}.log")
        for line in (log.read_text().splitlines() if log.exists() else []):
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # phases 3-5: kernels against their plain versions, then times
    lags_err = check_lags(torch, lags)
    dec_err = check_decode(torch, dec)
    timer = Timer(torch)
    times = {"lags_select": time_lags(torch, lags, timer, T=1024)}
    t4096 = time_lags(torch, lags, timer, T=4096)
    t65536 = time_lags(torch, lags, timer, T=65536)
    times["decode_attention"] = time_decode(torch, dec, timer)
    d4096 = time_decode(torch, dec, timer, L=4096)
    del timer
    for name, t in (("lags_select T=1024 k=16", times["lags_select"]),
                    ("lags_select T=4096 k=16", t4096),
                    ("lags_select T=65536 k=16", t65536),
                    ("decode_attention bf16 B=16 H=32 Hkv=8 L=512 kv=505",
                     times["decode_attention"]),
                    ("decode_attention bf16 B=16 H=32 Hkv=8 L=4096 kv=4089",
                     d4096)):
        print(f"time {name}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in t.items()) + f" [{card}]")

    # phase 6: the serving entry point on the cost model
    serve_cost_model(torch, ops, serve)

    # phase 7: the main path at full width
    check_model_small(torch)
    counts = serve_qwen3_8b(torch, ops, serve)

    kernels = [
        dict(name="lags_select", route="cuda",
             source="src/repro_torch/kernels/csrc/lags_select.cu",
             replaces="src/repro/kernels/lags_select.py:56",
             launches=counts["lags_select"],
             max_abs_err=lags_err["T1024_k16"], **times["lags_select"]),
        dict(name="decode_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/decode_attention.cu",
             replaces="src/repro/kernels/decode_attention.py:61",
             launches=counts["decode_attention"],
             max_abs_err=dec_err[("bfloat16", 16, 32, 8, 512, 128)],
             **times["decode_attention"]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
