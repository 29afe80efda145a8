"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips with a reason where there is no card (the
decision is taken inside the ``card`` fixture, never at import).  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.core import simkernel_torch as st
from repro_torch.core.traces import lightest_band_fns, make_workload
from repro_torch.fleet import (
    FaultSchedule,
    Topology,
    place,
    simulate_fleet,
    simulate_fleet_chaos,
)
from repro_torch.fleet.simulate import _pad_trace
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import lags_select as lags
from repro_torch.kernels import ssm_scan as ssm
from repro_torch.configs.base import get_config, layer_specs, reduced
from repro_torch.models import attention, blocks, model
from repro_torch.models.params import init_params
from repro_torch.sched import torch_backend as tb

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),  # tests/test_kernels.py
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}
BF16_TILE_REL = 1e-2  # chip_smoke.BF16_TILE_REL


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _lags_args(gen, T, k, kind):
    u = lambda: torch.rand(T, generator=gen, device="cuda")  # noqa: E731
    if kind == "ties_across_ctas":
        # one key for every lane: the picks are the lowest runnable lanes,
        # across the cluster's CTA edges
        f = lambda v: torch.full((T,), v, device="cuda")  # noqa: E731
        return (f(0.25), f(0.5), f(0.5),
                torch.arange(T, device="cuda") % 3 != 1, k)
    if kind == "unaligned":
        # views one lane into their storage: no 16-byte loads
        return tuple(x[1:] for x in _lags_args(gen, T + 1, k, "random")[:4]) \
            + (k,)
    runnable = u() < 0.5
    if kind == "none_runnable":
        runnable = torch.zeros_like(runnable)
    # a coarse grid makes many equal credits: ties go to the lower lane
    return ((u() * 2).round(decimals=1), (u() * 2).round(decimals=1), u(),
            runnable, k)


@pytest.mark.parametrize("T,k,kind", [
    (1, 1, "random"), (256, 16, "random"), (1000, 16, "random"),
    (1023, 16, "random"), (1025, 16, "random"), (4096, 16, "random"),
    (8193, 16, "random"), (2048, 2048, "random"), (100, 200, "random"),
    (65536, 16, "random"), (65536, 64, "random"), (65536, 1024, "random"),
    (65536, 16, "ties_across_ctas"), (65536, 1024, "ties_across_ctas"),
    (4096, 16, "none_runnable"), (65536, 16, "none_runnable"),
    (4096, 16, "unaligned"), (65536, 1024, "unaligned")])
def test_lags_select_kernel_equals_plain(card, T, k, kind):
    args = _lags_args(card, T, k, kind)
    got = lags.lags_select(*args)
    want = lags.lags_select_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    if kind == "ties_across_ctas":
        assert got[2].tolist() == [i for i in range(T) if i % 3 != 1][:k]
    if kind == "none_runnable":
        assert got[2].tolist() == [-1] * k


def test_lags_select_refuses_before_launch(card):
    """Beyond the reference's T <= 65536 and the 2048 picks CTA 0 sorts."""
    before = lags.launches
    for T, k in ((65537, 16), (8192, 2049)):
        z = torch.zeros(T, device="cuda")
        with pytest.raises(ValueError):
            lags.lags_select(z, z, z, z > 0, k)
    assert lags.launches == before


def test_lags_select_sub_1e4_order(card):
    T = 2048
    credit = torch.ones(T, device="cuda")
    credit[1000] = 1e-5
    credit[0] = torch.nextafter(torch.tensor(1e-5), torch.tensor(1.0))
    z = torch.zeros(T, device="cuda")
    idx = lags.lags_select(z, credit, z, torch.ones(T, dtype=torch.bool,
                                                    device="cuda"), 3,
                           window=10**9)[2]
    assert idx.tolist() == [0, 1000, 1]


# (B, H, Hkv, L, D): the reference's shapes, then B * Hkv = 32 (the decode
# after the Qwen3-8B prefill) and 128 (the engine) at L = 512, 2112, 4096
DEC_SHAPES = [(1, 2, 2, 512, 64), (2, 4, 4, 1024, 128), (2, 8, 2, 300, 64)] + [
    (B, 32, 8, L, 128) for B in (4, 16) for L in (512, 2112, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D", DEC_SHAPES)
def test_decode_attention_kernel_matches_plain(card, dtype, B, H, Hkv, L, D):
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)  # the model's cache view
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    # kv_len from 1 to L, L - 7 and the edges of the kernel's splits among them
    chunk, _ = dec.split_plan(B, Hkv, L, D, q.element_size())
    edges = [L - 7, L, 1, chunk, chunk - 1, chunk + 1, L // 3]
    kv_len = torch.tensor([min(max(x, 1), L) for x in (edges * B)[:B]],
                          dtype=torch.int32, device="cuda")
    got = dec.decode_attention(q, k, v, kv_len)
    want = dec.decode_attention_plain(q, k, v, kv_len)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (B, H, Hkv, L, r0): G = 16 (qwen3-moe's 64 query heads over 4 KV heads)
# and G = 7 (qwen2-vl's 28 over 4) at D = 128, over the whole cache (r0 = 0)
# and through a window's view of it that starts at row r0 (gemma3's decode
# past its window), one split and several
DEC_GROUP_SHAPES = [(B, H, 4, L, r0) for B, L, r in ((4, 2112, 1088),
                                                     (2, 300, 44))
                    for H in (64, 28) for r0 in (0, r)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,r0", DEC_GROUP_SHAPES)
def test_decode_attention_large_groups_and_window_views(card, dtype, B, H,
                                                        Hkv, L, r0):
    D = 128
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D)[:, r0:].permute(0, 2, 1, 3)  # the window's view
    v = n(B, L, Hkv, D)[:, r0:].permute(0, 2, 1, 3)
    rows = L - r0
    kv_len = torch.tensor([[rows, rows - 7, 1, rows // 3][b % 4]
                           for b in range(B)], dtype=torch.int32,
                          device="cuda")
    got = dec.decode_attention(q, k, v, kv_len)
    want = dec.decode_attention_plain(q, k, v, kv_len)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


# (B, H, Hkv, L): G = 1, 2, 4, 8 and 16 at D = 128 (D = 64 at G = 1), one
# split and several; (4, 32, 8, 1032) is each rank's cache in the sharded
# Qwen3-8B decode (2064 rows over two ranks)
DEC_LSE_SHAPES = [(2, 8, 8, 300, 64), (2, 16, 8, 1024, 128),
                  (4, 32, 8, 1032, 128), (4, 32, 4, 2112, 128),
                  (4, 64, 4, 2112, 128)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D", DEC_LSE_SHAPES)
def test_decode_attention_lse_matches_plain_and_merges(card, dtype, B, H, Hkv,
                                                      L, D):
    """The log-sum-exp output against the plain version's (-inf where a row
    attends to none: kv_len 0), the output bit-equal to the launch without
    it; and the rows split at L / 2, each half attended with kv_len shifted
    and clamped, merge to the unsplit output."""
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    kv_len = torch.tensor([[L, L - 7, 0, L // 3][b % 4] for b in range(B)],
                          dtype=torch.int32, device="cuda")
    out, lse = dec.decode_attention(q, k, v, kv_len, with_lse=True)
    want, want_lse = dec.decode_attention_plain(q, k, v, kv_len,
                                                with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    assert torch.equal(out, dec.decode_attention(q, k, v, kv_len))
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    half = L // 2
    parts = [dec.decode_attention(q, k[:, :, a:b], v[:, :, a:b],
                                  (kv_len - a).clamp(0, b - a), with_lse=True)
             for a, b in ((0, half), (half, L))]
    merged = attention.merge_partials(*zip(*parts))
    torch.testing.assert_close(merged, want.float(), **TOL[dtype])


# (kv_start, kv_len) rows of each batch row: whole ranges, a window in the
# middle, ranges that start at or past kv_len (empty), kv_len 0
DEC_RANGES = [(0, "L"), (5, "L-7"), ("L-3", "L-3"), ("L//2", "L//3"),
              (0, 0), (1, "L//3")]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D", DEC_LSE_SHAPES)
def test_decode_attention_kv_start_with_lse_matches_plain(card, dtype, B, H,
                                                         Hkv, L, D):
    """kv_start and the log-sum-exp together, as each rank of a windowed
    or positioned sharded decode runs them: output and log-sum-exp against
    the plain version, an empty range (kv_start >= kv_len, or kv_len 0)
    giving output 0 and log-sum-exp -inf; the output bit-equal to the
    launch without the log-sum-exp."""
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    rows = [DEC_RANGES[(b + len(DEC_RANGES) - B % 3) % len(DEC_RANGES)]
            for b in range(B)]
    ev = lambda e: e if isinstance(e, int) else eval(e, {"L": L})  # noqa: E731
    kv_start = torch.tensor([ev(a) for a, _ in rows], dtype=torch.int32,
                            device="cuda")
    kv_len = torch.tensor([ev(b) for _, b in rows], dtype=torch.int32,
                          device="cuda")
    out, lse = dec.decode_attention(q, k, v, kv_len, kv_start=kv_start,
                                    with_lse=True)
    want, want_lse = dec.decode_attention_plain(q, k, v, kv_len,
                                                kv_start=kv_start,
                                                with_lse=True)
    assert torch.equal(out, dec.decode_attention(q, k, v, kv_len,
                                                 kv_start=kv_start))
    torch.testing.assert_close(lse, want_lse, **TOL[torch.float32])
    torch.testing.assert_close(out.float(), want.float(), **TOL[dtype])
    empty = kv_start >= kv_len
    assert bool(empty.any())
    assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ranks", [2, 3])
@pytest.mark.parametrize("window", [4, 700])
def test_merge_partials_of_windowed_row_splits(card, dtype, ranks, window):
    """A windowed decode over a cache whose 2112 rows are split into 2 or
    3 ranks' rows, each attending to its part of the window (kv_start and
    kv_len shifted by its first row and clamped), merged by
    ``merge_partials``: equal to the unsplit windowed result; at window 4
    most ranks hold none of the window."""
    B, H, Hkv, L, D = 4, 32, 8, 2112, 128
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    cache_len = torch.tensor([2100, 1500, 703, 2], dtype=torch.int32,
                             device="cuda")
    end = cache_len + 1
    start = (end - window).clamp_min(0)
    want = dec.decode_attention(q, k, v, end, kv_start=start)
    outs, lses = [], []
    n_rows = L // ranks
    for r in range(ranks):
        r0 = r * n_rows
        o, lse = dec.decode_attention(
            q, k[:, :, r0:r0 + n_rows], v[:, :, r0:r0 + n_rows],
            (end - r0).clamp(0, n_rows),
            kv_start=(start - r0).clamp(0, n_rows), with_lse=True)
        outs.append(o)
        lses.append(lse)
    if window == 4:  # a rank that holds none of a row's window
        assert any(bool(torch.isneginf(x).any()) for x in lses)
    merged = attention.merge_partials(outs, lses)
    torch.testing.assert_close(merged, want.float(), **TOL[dtype])


def test_decode_attention_refuses_groups_past_16(card):
    q = torch.zeros(1, 34, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 2, 32, 64, device="cuda", dtype=torch.bfloat16)
    assert dec.decode_attention(q[:, :32], kv, kv, torch.tensor(
        [7], device="cuda")).shape == (1, 32, 64)
    with pytest.raises(ValueError, match="G=17 exceeds the kernel's 16"):
        dec.decode_attention(q, kv, kv, torch.tensor([7], device="cuda"))


def test_decode_attention_kernel_refuses_unaligned_cache(card):
    """16-byte loads: a cache row stride that is no multiple of 16 bytes is
    refused, not read another way."""
    q = torch.zeros(1, 4, 64, device="cuda", dtype=torch.bfloat16)
    kv = torch.zeros(1, 32, 2, 65, device="cuda", dtype=torch.bfloat16)
    kv = kv[..., :64].permute(0, 2, 1, 3)
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        dec.decode_attention(q, kv, kv, torch.tensor([7], device="cuda"))


# (B, H, Hkv, S, D, pad): the reference's shapes and ragged S, with rows
# padded by one element (odd strides) or not; then fa_wgmma's grid, D in
# {64, 128} x G in {1, 4, 8} x S in {1, 77, 128, 130, 300, 2048}
FLASH_SHAPES = [(B, H, Hkv, S, D, pad) for B, H, Hkv, S, D in (
    (1, 1, 1, 128, 64), (2, 2, 2, 256, 128), (2, 8, 2, 300, 64),
    (1, 4, 2, 77, 16), (2, 4, 4, 200, 80)) for pad in (0, 1)] + [
    (1, 2 * G, 2, S, D, 0) for D in (64, 128) for G in (1, 4, 8)
    for S in (1, 77, 128, 130, 300, 2048)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 128), (True, 64),
                                           (False, 0)])
@pytest.mark.parametrize("B,H,Hkv,S,D,pad", FLASH_SHAPES)
def test_flash_attention_kernel_matches_plain(card, dtype, causal, window, B,
                                              H, Hkv, S, D, pad):
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    # the model's (B, S, H, D) projections, seen as (B, H, S, D); rows
    # padded by one element make odd strides, which the f32 kernel reads and
    # the bf16 kernels (16 bytes a load, TMA) refuse
    q, k, v = (n(B, S, h, D + pad)[..., :D].permute(0, 2, 1, 3)
               for h in (H, Hkv, Hkv))
    if dtype == torch.bfloat16 and pad:
        with pytest.raises(ValueError, match="multiples of 8"):
            fa.flash_attention(q, k, v, causal=causal, window=window)
        return
    got = fa.flash_attention(q, k, v, causal=causal, window=window)
    want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert got.dtype == dtype and got.shape == (B, H, S, D)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.parametrize("B,S,I,N", [(1, 128, 256, 8), (2, 256, 512, 16),
                                     (2, 37, 64, 16), (1, 5, 32, 4)])
def test_ssm_scan_kernel_matches_plain(card, B, S, I, N):
    u = lambda *s: torch.rand(*s, generator=card, device="cuda")  # noqa: E731
    dA = 0.5 + 0.49 * u(B, S, I, N)
    dBx = (u(B, S, I, N) - 0.5) * 0.1
    C = u(B, S, N) * 2 - 1
    h0 = u(B, I, N) * 2 - 1  # nonzero
    y, h = ssm.ssm_scan(dA, dBx, C, h0)
    y_p, h_p = ssm.ssm_scan_plain(dA, dBx, C, h0)
    assert y.dtype == h.dtype == torch.float32
    torch.testing.assert_close(y, y_p, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-4)


def test_ssm_scan_kernel_takes_f32_only(card):
    """The mixer hands the kernel f32; other types are refused, not cast."""
    x = torch.ones(1, 4, 32, 16, device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        ssm.ssm_scan(x, x, x[:, :, 0], torch.zeros(1, 32, 16, device="cuda"))


# -- the tick simulator: the card runs the CPU's arithmetic -----------------

def _sim_params(code, n_fns, dur, n_cores=12):
    rt = (tuple(int(f) for f in lightest_band_fns(n_fns))
          if code == tb.LAGS_STATIC else ())
    return st.SimParams(n_cores=n_cores, n_fns=n_fns,
                        n_ticks=int(dur / st.TICK), policy=code, rt_fns=rt)


@pytest.mark.parametrize("code", sorted(tb.NAME_OF),
                         ids=lambda c: tb.NAME_OF[c])
def test_simulate_on_card_equals_cpu(card, code):
    """tests/test_simkernel_jax.py's trace (40 functions, 15 s, 8 threads,
    12 cores): the same completion ticks on the card as on the CPU."""
    wl = make_workload("azure2021", 40, duration_s=15.0, seed=3,
                       threads_per_fn=8)
    p = _sim_params(code, 40, 15.0)
    got, want = (st.simulate(st.build_slot_trace(wl, 40, 8, device=dev), p)
                 for dev in ("cuda", "cpu"))
    assert got["done_tick"].device.type == "cuda"
    assert torch.equal(got["done_tick"].cpu(), want["done_tick"])
    for k in ("busy_s", "overhead_s", "credit"):
        torch.testing.assert_close(got[k].cpu(), want[k], rtol=1e-5, atol=0)


def test_padded_batch_on_card_equals_each_node(card):
    traces = []
    for n_fns, seed in ((6, 1), (5, 2)):
        wl = make_workload("azure2021", n_fns, duration_s=3.0, seed=seed,
                           threads_per_fn=4)
        traces.append(st.build_slot_trace(wl, n_fns, 4, device="cuda"))
    R = max(t.arrival_tick.shape[1] for t in traces)
    padded = [_pad_trace(t, 24, R) for t in traces]
    batch = st.simulate(st.SlotTrace(*(torch.stack(x) for x in zip(*padded))),
                        _sim_params(tb.LAGS, 6, 3.0, n_cores=4))
    for i, (t, n_fns) in enumerate(zip(traces, (6, 5))):
        out = st.simulate(t, _sim_params(tb.LAGS, n_fns, 3.0, n_cores=4))
        t0, r0 = t.arrival_tick.shape
        assert torch.equal(batch["done_tick"][i, :t0, :r0], out["done_tick"])
        for k in ("busy_s", "overhead_s"):
            assert torch.equal(batch[k][i], out[k])


def test_torch_fleet_on_card_equals_cpu(card):
    asg = place("round-robin", 11, 2)
    got, want = (simulate_fleet("lags", asg, duration_s=5.0, backend="torch",
                                device=dev) for dev in ("cuda", "cpu"))
    for g, w in zip(got.nodes, want.nodes):
        assert (g.latencies == w.latencies).all() and len(g.latencies) > 0


def test_chaos_partition_on_card_equals_cpu(card):
    """A partition fenced by the chaos controller: every epoch's fleet in
    one batched loop, on the card as on the CPU."""
    topo = Topology.uniform(4, 2)
    asg = place("rack-spread", 64, 4, exec_s=0.1, racks=topo.racks())
    part = FaultSchedule.single_partition((1,), 3.0, 4.5, 4, topo)
    got, want = (simulate_fleet_chaos(
        "lags", asg, part, duration_s=12.0, epoch_s=1.5, exec_s=0.1, seed=10,
        topology=topo, backend="torch", device=dev) for dev in ("cuda", "cpu"))
    assert (got.latencies == want.latencies).all() and len(got.latencies) > 0
    assert got.per_epoch_counts() == want.per_epoch_counts()
    assert got.deferred_arrivals == want.deferred_arrivals > 0
    assert {n for e in got.epochs for n in e.fenced} == {1}


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _assert_scaled(got, want, what):
    """Within 1e-4 of ``want``'s scale (its largest entry, at least 1)."""
    want = want.float()
    scale = max(1.0, float(want.abs().max()))
    err = float((got.float().cpu() - want).abs().max())
    assert err <= 1e-4 * scale, f"{what}: max err {err}, scale {scale}"


# the reduced configs of the model families in f32, on the card (kernels)
# against the CPU (plain versions): prefill S=32 and 8 decode steps
FAMILIES = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen3-moe-G16": ("qwen3-moe-235b-a22b", {"n_heads": 16, "n_kv_heads": 1}),
    "gemma3": ("gemma3-27b", {}),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "hubert": ("hubert-xlarge", {}),
}


@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_on_card_equals_cpu(card, case):
    """Logits and every cache leaf after prefill, then 8 decode steps fed
    the CPU's greedy tokens (gemma3 past its window of 16; qwen2-vl with
    vision rows and three different position streams)."""
    name, overrides = FAMILIES[case]
    cfg = reduced(get_config(name), **overrides)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on = {"cpu": params, "cuda": _to(params, "cuda")}
    g = torch.Generator().manual_seed(1)
    B, S = 2, 32
    if cfg.frontend == "audio_frames":
        batch = {"frames": torch.randn(B, S, cfg.d_model, generator=g)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (B, S),
                                         generator=g, dtype=torch.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = torch.randn(B, cfg.n_vision_tokens,
                                             cfg.d_model, generator=g)
        idx = torch.arange(S, dtype=torch.int32)
        batch["positions"] = torch.stack(
            [idx, idx // 4, idx % 4 + 1], -1).expand(B, S, 3).contiguous()
    out = {}
    for dev in ("cpu", "cuda"):
        logits, cache = model.prefill(on[dev], cfg, _to(batch, dev),
                                      max_len=S + 8, device=dev)
        out[dev] = (logits, cache)
    _assert_scaled(out["cuda"][0], out["cpu"][0], f"{case} prefill logits")
    if cfg.encoder_only:
        return
    caches = {dev: out[dev][1] for dev in out}
    tok = torch.argmax(out["cpu"][0], -1)[:, None].to(torch.int32)
    for n in range(S, S + 8):
        step = {dev: model.decode_step(on[dev], cfg, {"tokens": tok.to(dev)},
                                       caches[dev], n, device=dev)[0]
                for dev in ("cpu", "cuda")}
        _assert_scaled(step["cuda"], step["cpu"], f"{case} decode at {n}")
        tok = torch.argmax(step["cpu"], -1)[:, None].to(torch.int32)
    for i, (c_card, c_cpu) in enumerate(zip(caches["cuda"], caches["cpu"])):
        for leaf in c_cpu:
            _assert_scaled(c_card[leaf], c_cpu[leaf], f"{case} layer {i} {leaf}")


def test_jamba_layerwise_on_card_equals_cpu(card):
    """The reduced jamba (16 layers) layer by layer, each layer on both
    devices fed the CPU's input to it: under the reference's init its
    residual reaches ~1e11 and its logits move by ~1e-3 when the input
    moves by 1e-7 (tests/test_torch_families.py), so the whole forward is
    not held to 1e-4.  Prefill S=32, then 8 decode steps."""
    cfg = reduced(get_config("jamba-v0.1-52b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on = {"cpu": params, "cuda": _to(params, "cuda")}
    B, S = 2, 32
    caches = {dev: model.init_cache(cfg, B, S + 8, device=dev)
              for dev in on}
    toks = torch.randint(0, cfg.vocab_size, (B, S + 8), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(1))
    for start, n in [(0, S)] + [(p, 1) for p in range(S, S + 8)]:
        x = params["embed"][toks[:, start:start + n]]
        for i, spec in enumerate(layer_specs(cfg)):
            ys = {}
            for dev in on:
                kv_len = torch.full((B,), start + n, dtype=torch.int32,
                                    device=dev)
                ys[dev], _ = blocks.apply_layer(
                    cfg, spec, on[dev]["layers"][i], x.to(dev), None,
                    caches[dev][i], None if start == 0 else start, kv_len)
            what = f"layer {i} ({spec.kind}/{spec.mlp}) at {start}"
            _assert_scaled(ys["cuda"], ys["cpu"], what)
            for leaf in caches["cpu"][i]:
                _assert_scaled(caches["cuda"][i][leaf], caches["cpu"][i][leaf],
                               f"{what}: {leaf}")
            x = ys["cpu"]


# -- training: the backward kernels, positions, and a train step ------------

def _tile_rel(got, want, tile=64, floor=1e-4):
    """max over (b, h, 64-row tile) of ||got - want|| / (||want|| + floor *
    sqrt(n)), n the tile's values (chip_smoke.tile_rel)."""
    B, H, S, D = want.shape
    pad = (-S) % tile
    d = torch.nn.functional.pad((got.float() - want.float()), (0, 0, 0, pad))
    w = torch.nn.functional.pad(want.float(), (0, 0, 0, pad))
    d = d.reshape(B, H, -1, tile * D).norm(dim=-1)
    w = w.reshape(B, H, -1, tile * D).norm(dim=-1)
    n = torch.nn.functional.pad(torch.full((S,), float(D), device=w.device),
                                (0, pad)).reshape(-1, tile).sum(-1)
    return float((d / (w + floor * n.sqrt()).clamp_min(1e-30)).max())


def _assert_kernel_close(got, want, dtype, what):
    """f32 at TOL; bf16 at TOL and at chip_smoke.py's BF16_TILE_REL over
    each 64-row tile of each (b, head): TOL's atol alone is as large as the
    smallest gradients it compares."""
    diff = (got.float() - want.float()).abs()
    ok = bool((diff <= TOL[dtype]["atol"] + TOL[dtype]["rtol"]
               * want.float().abs()).all())
    assert ok, f"{what}: max err {float(diff.max())}"
    if dtype == torch.bfloat16:
        r = _tile_rel(got, want)
        assert r <= BF16_TILE_REL, f"{what}: 64-row tile error {r}"


def _positions(gen, B, S):
    steps = torch.randint(0, 3, (B, S), generator=gen, device="cuda")
    return (torch.cumsum(steps, 1) + 2).to(torch.int32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window,positions", [
    (1, 1, 1, 128, 64, True, 0, False), (2, 2, 2, 256, 128, True, 128, False),
    (2, 8, 2, 300, 64, True, 0, False), (1, 4, 2, 77, 16, False, 0, False),
    (2, 4, 4, 200, 80, False, 0, False), (1, 2, 2, 1, 128, True, 0, False),
    (1, 8, 2, 130, 128, True, 64, False), (2, 4, 2, 100, 64, True, 0, True),
    (1, 4, 1, 90, 32, False, 30, True), (1, 2, 2, 64, 96, True, 16, True)])
def test_flash_attention_bwd_kernel_matches_plain(card, dtype, B, H, Hkv, S,
                                                  D, causal, window,
                                                  positions):
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q, k, v = (n(B, S, h, D).permute(0, 2, 1, 3) for h in (H, Hkv, Hkv))
    do = n(B, S, H, D).permute(0, 2, 1, 3)
    pos = _positions(card, B, S) if positions else None
    kw = dict(causal=causal, window=window, q_pos=pos, k_pos=pos)
    o = fa.flash_attention(q, k, v, **kw)
    _assert_kernel_close(o, fa.flash_attention_plain(q, k, v, **kw), dtype,
                         "forward")
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, do, **kw)
    assert fa.bwd_launches == before + 1
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == dtype and g.shape == w.shape
        _assert_kernel_close(g, w, dtype, f"d{name}")


def test_flash_attention_autograd_runs_the_kernels(card):
    """Under autograd on a card: forward kernel, then the backward kernel,
    whose gradients equal autograd of the plain version (f32)."""
    q, k, v = (torch.randn(2, 4 if h == 4 else 2, 96, 32, generator=card,
                           device="cuda").requires_grad_(True)
               for h in (4, 2, 2))
    f0, b0 = fa.launches, fa.bwd_launches
    out = fa.flash_attention(q, k, v, window=40)
    do = torch.randn(out.shape, generator=card, device="cuda")
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.bwd_launches) == (f0 + 1, b0 + 1)
    ref = fa.flash_attention_plain(q, k, v, window=40)
    want = torch.autograd.grad(ref, (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, **TOL[torch.float32])


# the wgmma backward's grid: D x masks x G x S (chip_smoke.py phase 22)
BWD_WGMMA_GRID = [(D, causal, window, G, S) for D in (64, 128)
                  for causal, window in ((True, 0), (True, 128), (False, 0))
                  for G in (1, 2, 4, 8, 16) for S in (1, 77, 300, 2048)]


def _bwd_inputs(gen, B, H, Hkv, S, D):
    n = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(  # noqa: E731
        torch.bfloat16)
    q, k, v = (n(B, S, h, D).permute(0, 2, 1, 3) for h in (H, Hkv, Hkv))
    return q, k, v, n(B, S, H, D).permute(0, 2, 1, 3)


@pytest.mark.parametrize("D,causal,window,G,S", BWD_WGMMA_GRID)
def test_flash_attention_bwd_wgmma_matches_plain(card, D, causal, window, G,
                                                 S):
    """The wgmma route from the forward's L: the L against the plain L (f32
    TOL), the forward's output bit-equal to the no-gradient build's, and
    dq, dk, dv against the plain backward (TOL and the 64-row tile
    limit)."""
    B, Hkv = (2, 2) if S < 2048 else (1, 1)
    q, k, v, do = _bwd_inputs(card, B, G * Hkv, Hkv, S, D)
    kw = dict(causal=causal, window=window)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, **kw),
                               **TOL[torch.float32])
    before = (fa.bwd_wgmma_launches, fa.bwd_mma_launches)
    got = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    assert (fa.bwd_wgmma_launches, fa.bwd_mma_launches) == (before[0] + 1,
                                                            before[1])
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _assert_kernel_close(g, w, torch.bfloat16, f"d{name}")


def test_flash_attention_bwd_wgmma_is_deterministic(card):
    """No atomics: two calls give the same bits."""
    q, k, v, do = _bwd_inputs(card, 2, 8, 2, 2048, 64)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    a = fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    b = fa.flash_attention_bwd(q, k, v, o, do, lse=lse)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_bwd_routes_on_card(card):
    """A direct call without L gets it from one forward launch; L is refused
    where the route recomputes it; a route is run by name only where it can
    run the call."""
    q, k, v, do = _bwd_inputs(card, 1, 4, 2, 300, 128)
    o, lse = fa.flash_attention_with_lse(q, k, v)
    f0 = fa.launches
    got = fa.flash_attention_bwd(q, k, v, o, do)
    assert fa.launches == f0 + 1
    want = fa.flash_attention_bwd(q, k, v, o, do, lse=lse.contiguous())
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    m0 = fa.bwd_mma_launches
    mma = fa.flash_attention_bwd(q, k, v, o, do, route="fa_bwd_mma")
    assert fa.bwd_mma_launches == m0 + 1
    for g, w in zip(mma, fa.flash_attention_bwd_plain(q, k, v, o, do)):
        _assert_kernel_close(g, w, torch.bfloat16, "mma route")
    with pytest.raises(ValueError, match="recomputes L"):
        fa.flash_attention_bwd(q, k, v, o, do, lse=lse, route="fa_bwd_mma")
    with pytest.raises(ValueError, match="cannot run"):
        fa.flash_attention_bwd(q, k, v, o, do, route="fa_bwd_f32")
    # fa_mma writes no L: not at D = 96, not by name on fa_wgmma's call
    q96, k96, v96, _ = _bwd_inputs(card, 1, 4, 2, 300, 96)
    pos = torch.arange(300, device="cuda", dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="only fa_wgmma writes L"):
        fa._forward_kernel(q96, k96, v96, True, 0, None, pos, pos,
                           with_lse=True)
    with pytest.raises(ValueError, match="only fa_wgmma writes L"):
        fa._forward_kernel(q, k, v, True, 0, None, pos, pos, with_lse=True,
                           route="fa_mma")


def test_flash_attention_autograd_runs_the_wgmma_route(card):
    """bf16 at D=64 under autograd: the L-writing forward, then one launch
    of the wgmma backward and none of the mma route; gradients against the
    plain backward."""
    q, k, v, do = _bwd_inputs(card, 2, 8, 2, 256, 64)
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    n0 = (fa.launches, fa.bwd_wgmma_launches, fa.bwd_mma_launches)
    out = fa.flash_attention(q, k, v, window=100)
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa.launches, fa.bwd_wgmma_launches, fa.bwd_mma_launches) == (
        n0[0] + 1, n0[1] + 1, n0[2])
    want = fa.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(),
                                        out.detach(), do, window=100)
    for g, w in zip(got, want):
        _assert_kernel_close(g, w, torch.bfloat16, "autograd")


def test_flash_attention_fully_masked_rows_on_card(card):
    B, H, S, D = 1, 2, 70, 64
    q, k, v, do = (torch.randn(B, H, S, D, generator=card, device="cuda")
                   for _ in range(4))
    q_pos = (torch.arange(S, device="cuda") - 9).to(torch.int32)[None]
    k_pos = torch.arange(S, device="cuda", dtype=torch.int32)[None]
    o = fa.flash_attention(q, k, v, q_pos=q_pos, k_pos=k_pos)
    assert int(torch.count_nonzero(o[:, :, :9])) == 0
    dq, dk, dv = fa.flash_attention_bwd(q, k, v, o, do, q_pos=q_pos,
                                        k_pos=k_pos)
    assert int(torch.count_nonzero(dq[:, :, :9])) == 0
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, q_pos=q_pos,
                                        k_pos=k_pos)
    for g, w in zip((dq, dk, dv), want):
        torch.testing.assert_close(g, w, **TOL[torch.float32])


# -- fa_wgmma and fa_bwd_wgmma under given positions and at head dim 80 -----

def _position_kind(gen, kind, B, S):
    """(q_pos, k_pos) int32 (B, S) on the card: rising with the row, with
    repeats and gaps, the same shuffled (not monotonic), or queries 9
    behind the keys (their first 9 rows keep no key under a causal mask)."""
    idx = torch.arange(S, device="cuda", dtype=torch.int32).repeat(B, 1)
    if kind == "rising":
        return idx, idx
    pos = _positions(gen, B, S)
    if kind == "repeats":
        return pos, pos
    if kind == "unsorted":
        perm = torch.argsort(torch.rand(B, S, generator=gen, device="cuda"), 1)
        pos = torch.gather(pos, 1, perm)
        return pos, pos
    assert kind == "no_key"
    return idx - 9, idx


# (D, S, G, causal, window, kind): D = 80 full and causal; each kind of
# positions, with and without a window; ragged S; G 1, 7, 16
WGMMA_POS_CASES = (
    [(80, S, G, causal, 0, None) for S in (1, 77, 130, 300)
     for G, causal in ((1, False), (7, True))]
    + [(D, S, G, True, w, kind) for D in (64, 80, 128)
       for kind in ("rising", "repeats", "unsorted", "no_key")
       for S, G, w in ((77, 1, 0), (300, 16, 0), (130, 7, 50))]
    + [(128, 1, 7, True, 0, "repeats"), (64, 300, 1, False, 100, "unsorted")])


@pytest.mark.parametrize("D,S,G,causal,window,kind", WGMMA_POS_CASES)
def test_flash_attention_wgmma_positions_and_d80_match_plain(
        card, D, S, G, causal, window, kind):
    """The new fa_wgmma cases (head dim 80; given positions: rising,
    repeated with gaps, unsorted, rows with no kept key) and their
    fa_bwd_wgmma backward: the forward against its plain version, the
    L-writing build's output bit-equal to it and its L against the plain
    L (f32 TOL), then dq, dk, dv from that L against the plain backward
    (TOL and the 64-row tile limit); one launch of each route, none of the
    mma kernels."""
    B, Hkv = 2, 2
    q, k, v, do = _bwd_inputs(card, B, G * Hkv, Hkv, S, D)
    q_pos, k_pos = (None, None) if kind is None else _position_kind(
        card, kind, B, S)
    kw = dict(causal=causal, window=window, q_pos=q_pos, k_pos=k_pos)
    assert fa.route(torch.bfloat16, D, kind is not None) == "fa_wgmma"
    n0 = (fa.wgmma_launches, fa.mma_launches, fa.bwd_wgmma_launches,
          fa.bwd_mma_launches)
    o = fa.flash_attention(q, k, v, **kw)
    _assert_kernel_close(o, fa.flash_attention_plain(q, k, v, **kw),
                         torch.bfloat16, "forward")
    o_l, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    assert torch.equal(o, o_l)
    torch.testing.assert_close(lse, fa.flash_attention_lse_plain(q, k, **kw),
                               **TOL[torch.float32])
    got = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    assert (fa.wgmma_launches, fa.mma_launches, fa.bwd_wgmma_launches,
            fa.bwd_mma_launches) == (n0[0] + 2, n0[1], n0[2] + 1, n0[3])
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape
        _assert_kernel_close(g, w, torch.bfloat16, f"d{name}")
    if kind == "no_key" and causal:
        assert int(torch.count_nonzero(o[:, :, :9])) == 0
        assert int(torch.count_nonzero(lse[:, :, :9])) == 0
        assert int(torch.count_nonzero(got[0][:, :, :9])) == 0


@pytest.mark.parametrize("which", ["qwen2-vl-7b", "hubert-xlarge"])
def test_flash_attention_wgmma_at_the_training_shapes(card, which):
    """The two training shapes that ran on the mma kernels: qwen2-vl-7b's
    (B=1, H=28, Hkv=4, S=1536, D=128, causal over M-RoPE's stream 0, moved
    up by 3 from position 5) and hubert-xlarge's (B=2, H=16, S=512, D=80,
    full), forward and backward against their plain versions, and against
    the mma kernels run by name on the same call."""
    if which == "qwen2-vl-7b":
        B, H, Hkv, S, D, causal = 1, 28, 4, 1536, 128, True
        pos = torch.arange(S, dtype=torch.int32, device="cuda")[None].clone()
        pos[0, 5:] += 3
    else:
        B, H, Hkv, S, D, causal, pos = 2, 16, 16, 512, 80, False, None
    q, k, v, do = _bwd_inputs(card, B, H, Hkv, S, D)
    kw = dict(causal=causal, q_pos=pos, k_pos=pos)
    o = fa.flash_attention(q, k, v, **kw)
    _assert_kernel_close(o, fa.flash_attention_plain(q, k, v, **kw),
                         torch.bfloat16, "forward")
    m0 = fa.mma_launches
    o_mma = fa.flash_attention(q, k, v, route="fa_mma", **kw)
    assert fa.mma_launches == m0 + 1
    _assert_kernel_close(o_mma, fa.flash_attention_plain(q, k, v, **kw),
                         torch.bfloat16, "forward fa_mma")
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, **kw)
    for route in (None, "fa_bwd_mma"):
        got = fa.flash_attention_bwd(q, k, v, o, do, route=route, **kw)
        for name, g, w in zip("qkv", got, want):
            _assert_kernel_close(g, w, torch.bfloat16, f"{route} d{name}")


@pytest.mark.parametrize("D,positions", [(80, False), (128, True)])
def test_flash_attention_bwd_wgmma_positions_is_deterministic(card, D,
                                                              positions):
    """No atomics under positions or at D = 80 either: two backward runs
    give the same bits."""
    q, k, v, do = _bwd_inputs(card, 2, 8, 2, 1000, D)
    pos = _positions(card, 2, 1000) if positions else None
    kw = dict(q_pos=pos, k_pos=pos)
    o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
    a = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    b = fa.flash_attention_bwd(q, k, v, o, do, lse=lse, **kw)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_flash_attention_forward_routes_on_card(card):
    """``route=`` on the forward: ``fa_mma`` runs fa_wgmma's calls by name
    (positions, D = 80), counted under its own route and under autograd
    with its own backward; a route that cannot run the call is refused."""
    q, k, v, do = _bwd_inputs(card, 1, 8, 2, 200, 80)
    pos = _positions(card, 1, 200)
    kw = dict(q_pos=pos, k_pos=pos, window=64)
    n0 = (fa.wgmma_launches, fa.mma_launches)
    got = fa.flash_attention(q, k, v, route="fa_mma", **kw)
    assert (fa.wgmma_launches, fa.mma_launches) == (n0[0], n0[1] + 1)
    _assert_kernel_close(got, fa.flash_attention_plain(q, k, v, **kw),
                         torch.bfloat16, "fa_mma by name")
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
    b0 = fa.bwd_mma_launches
    out = fa.flash_attention(qg, kg, vg, route="fa_mma", **kw)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    assert fa.bwd_mma_launches == b0 + 1
    want = fa.flash_attention_bwd_plain(q, k, v, out.detach(), do, **kw)
    for name, g, w in zip("qkv", grads, want):
        _assert_kernel_close(g, w, torch.bfloat16, f"fa_mma autograd d{name}")
    for bad in ("fa_fwd", "fa_wgmma_v2"):
        with pytest.raises(ValueError):
            fa.flash_attention(q, k, v, route=bad, **kw)
    with pytest.raises(ValueError, match="cannot run"):
        fa.flash_attention(q.float(), k.float(), v.float(), route="fa_mma")


SSM_BWD_CASES = [(1, 128, 256, 8, True, True), (2, 256, 512, 16, True, True),
                 (2, 37, 64, 16, True, False), (1, 5, 32, 4, False, True),
                 (2, 17, 48, 16, True, True)]


def _ssm_bwd_inputs(gen, B, S, I, N, dy, dh):
    u = lambda *s: torch.rand(*s, generator=gen, device="cuda")  # noqa: E731
    dA = 0.5 + 0.49 * u(B, S, I, N)
    dBx = (u(B, S, I, N) - 0.5) * 0.1
    C = u(B, S, N) * 2 - 1
    h0 = u(B, I, N) * 2 - 1
    g_y = u(B, S, I) - 0.5 if dy else None
    g_h = u(B, I, N) - 0.5 if dh else None
    return dA, dBx, C, h0, g_y, g_h


@pytest.mark.parametrize("B,S,I,N,dy,dh", SSM_BWD_CASES)
def test_ssm_scan_bwd_kernel_matches_plain(card, B, S, I, N, dy, dh):
    """The backward kernels given the forward's checkpoints, against the
    plain backward that recomputes every state from h0."""
    dA, dBx, C, h0, g_y, g_h = _ssm_bwd_inputs(card, B, S, I, N, dy, dh)
    _, _, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
    torch.testing.assert_close(hck, ssm.ssm_scan_ckpt_plain(dA, dBx, h0),
                               rtol=1e-4, atol=1e-4)
    before = ssm.bwd_launches
    got = ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h, hck)
    assert ssm.bwd_launches == before + 1
    want = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, g_y, g_h)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("B,S,I,N", [c[:4] for c in SSM_BWD_CASES])
def test_ssm_scan_ckpt_build_is_bit_equal(card, B, S, I, N):
    """The checkpoint-writing build's y and h_last are the plain build's,
    bit for bit, and it counts as one forward launch of each kind."""
    dA, dBx, C, h0, _, _ = _ssm_bwd_inputs(card, B, S, I, N, False, False)
    y, h = ssm.ssm_scan(dA, dBx, C, h0)
    n, n_ckpt = ssm.launches, ssm.ckpt_launches
    y_c, h_c, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
    assert (ssm.launches, ssm.ckpt_launches) == (n + 1, n_ckpt + 1)
    assert hck.shape == (B, -(-S // ssm.SEG), I, N)
    assert torch.equal(y_c, y) and torch.equal(h_c, h)
    assert torch.equal(hck[:, 0], h0)


def test_ssm_scan_bwd_is_deterministic(card):
    """No atomics: two backward calls give the same bits."""
    dA, dBx, C, h0, g_y, g_h = _ssm_bwd_inputs(card, 2, 256, 512, 16, True,
                                               True)
    _, _, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
    first = ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h, hck)
    second = ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h, hck)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_ssm_scan_bwd_without_ckpt_runs_the_ckpt_forward(card):
    """A caller without checkpoints gets them from one launch of the
    checkpoint-writing build: the same bits as the call given them."""
    dA, dBx, C, h0, g_y, g_h = _ssm_bwd_inputs(card, 2, 37, 64, 16, True,
                                               True)
    _, _, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
    want = ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h, hck)
    n = (ssm.launches, ssm.ckpt_launches, ssm.bwd_launches)
    got = ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h)
    assert (ssm.launches, ssm.ckpt_launches, ssm.bwd_launches) == (
        n[0] + 1, n[1] + 1, n[2] + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="hck"):
        ssm.ssm_scan_bwd(dA, dBx, C, h0, g_y, g_h, hck[:, :1])


def test_ssm_scan_bwd_refuses_unaligned_inputs(card):
    """TMA reads dA and dBx: data that is not 16-byte aligned is refused,
    not copied."""
    dA, dBx, C, h0, g_y, g_h = _ssm_bwd_inputs(card, 1, 5, 32, 4, True, True)
    hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)[2]
    shifted = torch.empty(dA.numel() + 1, device="cuda")[1:].view(dA.shape)
    shifted.copy_(dA)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ssm.ssm_scan_bwd(shifted, dBx, C, h0, g_y, g_h, hck)


def test_ssm_scan_autograd_runs_the_kernels(card):
    dA, dBx = (torch.rand(2, 40, 64, 16, generator=card, device="cuda") * 0.9
               for _ in range(2))
    C = torch.randn(2, 40, 16, generator=card, device="cuda")
    h0 = torch.randn(2, 64, 16, generator=card, device="cuda")
    ins = [t.requires_grad_(True) for t in (dA, dBx, C, h0)]
    y, h = ssm.ssm_scan(*ins)
    gy = torch.randn(y.shape, generator=card, device="cuda")
    got = torch.autograd.grad((y * gy).sum() + h.sum(), ins)
    y_p, h_p = ssm.ssm_scan_plain(*ins)
    want = torch.autograd.grad((y_p * gy).sum() + h_p.sum(), ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


def test_ssm_scan_autograd_under_remat(card):
    """``SSMScanFn`` under a non-reentrant activation checkpoint, as the
    model's remat runs it: the plain autograd's gradients; the forward (its
    checkpoint-writing build) runs twice, once more in the backward pass,
    and the backward once."""
    from torch.utils.checkpoint import checkpoint

    dA, dBx = (torch.rand(2, 45, 64, 16, generator=card, device="cuda") * 0.9
               for _ in range(2))
    C = torch.randn(2, 45, 16, generator=card, device="cuda")
    h0 = torch.randn(2, 64, 16, generator=card, device="cuda")
    gy = torch.randn(2, 45, 64, generator=card, device="cuda")
    ins = [t.requires_grad_(True) for t in (dA, dBx, C, h0)]

    def loss(scan, *xs):
        y, h = scan(*xs)
        return (y * gy).sum() + (h * h).sum()

    n = (ssm.launches, ssm.ckpt_launches, ssm.bwd_launches)
    out = checkpoint(loss, ssm.ssm_scan, *ins, use_reentrant=False)
    got = torch.autograd.grad(out, ins)
    assert (ssm.launches, ssm.ckpt_launches, ssm.bwd_launches) == (
        n[0] + 2, n[1] + 2, n[2] + 1)
    want = torch.autograd.grad(loss(ssm.ssm_scan_plain, *ins), ins)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kv_start_matches_plain(card, dtype):
    B, H, Hkv, L, D = 4, 16, 4, 700, 128
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k, v = (n(B, L, Hkv, D).permute(0, 2, 1, 3) for _ in range(2))
    kv_len = torch.tensor([690, 3, 400, 650], device="cuda", dtype=torch.int32)
    kv_start = torch.tensor([100, 3, 0, 640], device="cuda", dtype=torch.int32)
    got = dec.decode_attention(q, k, v, kv_len, kv_start=kv_start)
    want = dec.decode_attention_plain(q, k, v, kv_len, kv_start=kv_start)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    assert int(torch.count_nonzero(got[1])) == 0  # an empty range gives 0


@pytest.mark.parametrize("case", [
    ("stablelm-1.6b", {}), ("qwen3-8b", {"n_kv_heads": 2}),
    ("falcon-mamba-7b", {"n_layers": 2}), ("gemma3-27b", {}),
    ("qwen2-vl-7b", {}), ("qwen2-moe-a2.7b", {}), ("hubert-xlarge", {})])
def test_train_step_on_card_equals_cpu(card, case):
    """A reduced config in f32 (remat on), card (kernels) against CPU
    (plain versions): the loss and every gradient leaf of ``train_loss``
    (1e-3 of a leaf's scale: the reduced stablelm's and qwen2-vl's
    gradients move by ~1e-3 of it under 1e-7 input noise in the reference
    itself, tests/test_torch_train.py), then one train step's loss and
    gradient norm."""
    from repro_torch.train import train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    name, overrides = case
    cfg = reduced(get_config(name), **overrides)
    batch = TokenStream(cfg, 2, 64, DataConfig()).batch_at(0)
    tc = train_loop.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p_dev = _to(_to(params, "cuda"), dev)  # a copy of its own on each
        for p in leaves(p_dev):
            p.requires_grad_(True)
        loss, _ = model.train_loss(p_dev, cfg, {
            k: torch.from_numpy(v).to(dev) for k, v in batch.items()},
            device=dev)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(
            leaves(p_dev), torch.autograd.grad(loss, leaves(p_dev),
                                               allow_unused=True))]
        state = train_loop.TrainState(p_dev, train_loop.opt_lib.init_state(
            p_dev))
        _, m = train_loop.make_train_step(cfg, tc)(state, batch)
        out[dev] = (float(loss.detach()), grads, float(m["loss"]),
                    float(m["grad_norm"]))
    (l_g, g_g, sl_g, n_g), (l_c, g_c, sl_c, n_c) = out["cuda"], out["cpu"]
    assert l_g == pytest.approx(l_c, rel=1e-5)
    for a, b in zip(g_g, g_c):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a.cpu() - b).abs().max()) <= 1e-3 * scale, name
    assert sl_g == pytest.approx(sl_c, rel=1e-5)
    assert n_g == pytest.approx(n_c, rel=1e-4)


def test_one_train_step_on_card_equals_cpu(card):
    """One train step of the reduced qwen3-8b (G=2) in f32: the updated
    parameters and both moments on the card within 1e-6 of the CPU's, as
    tests/test_torch_train.py holds the CPU's to the reference (clip 1e-3,
    active).  Its gradients agree to ~1e-6 of their scale; the
    ill-conditioned configs cannot hold this, since the first AdamW step
    turns a gradient's relative error into the update's where |g| is near
    eps."""
    from repro_torch.train import train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    cfg = reduced(get_config("qwen3-8b"), n_kv_heads=2)
    batch = TokenStream(cfg, 2, 64, DataConfig()).batch_at(2)
    tc = train_loop.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0,
                                              clip_norm=1e-3))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        p_dev = _to(_to(params, "cuda"), dev)
        for p in leaves(p_dev):
            p.requires_grad_(True)
        state = train_loop.TrainState(p_dev, train_loop.opt_lib.init_state(
            p_dev))
        out[dev] = train_loop.make_train_step(cfg, tc)(state, batch)
    (new_g, m_g), (new_c, m_c) = out["cuda"], out["cpu"]
    assert float(m_c["grad_norm"]) > 1e-3  # the clip is active
    assert float(m_g["grad_norm"]) == pytest.approx(float(m_c["grad_norm"]),
                                                    rel=1e-5)
    for got, want in ((new_g.params, new_c.params), (new_g.opt.mu,
                                                     new_c.opt.mu),
                      (new_g.opt.nu, new_c.opt.nu)):
        for a, b in zip(leaves(got), leaves(want), strict=True):
            torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                       atol=1e-6)


def test_jamba_grads_layerwise_on_card_equals_cpu(card):
    """Each layer of the reduced jamba (Mamba and attention mixers, MoE and
    dense MLPs), on both devices fed the CPU's input to it, no cache and
    gradients on (the training path, both backward kernels on the card):
    its output and the VJP of a fixed cotangent for its input and every
    parameter leaf, each within 1e-4 of the CPU's scale, as
    tests/test_torch_train.py holds the CPU's to the reference layer by
    layer.  The whole stack is not held this way: in the reference itself
    its logits move by ~1e-3 under 1e-7 input noise."""
    from repro_torch.kernels import ops
    from repro_torch.train.tree import leaves

    cfg = reduced(get_config("jamba-v0.1-52b"))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    on = {"cpu": params, "cuda": _to(params, "cuda")}
    g = torch.Generator().manual_seed(2)
    B, S = 2, 64
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    x = params["embed"][toks].detach()
    ops.reset_launch_counts()
    for i, spec in enumerate(layer_specs(cfg)):
        ct = torch.randn(x.shape, generator=g)
        res = {}
        for dev in on:
            xt = x.to(dev).requires_grad_(True)
            lt = on[dev]["layers"][i]
            ps = leaves(lt)
            for p in ps:
                p.requires_grad_(True)
            y, aux = blocks.apply_layer(cfg, spec, lt, xt, None, None)
            loss = (y * ct.to(dev)).sum() + aux
            grads = torch.autograd.grad(loss, [xt] + ps, allow_unused=True)
            res[dev] = [y.detach()] + [torch.zeros_like(p) if d is None
                                       else d for p, d in zip([xt] + ps,
                                                              grads)]
        what = f"layer {i} ({spec.kind}/{spec.mlp})"
        for j, (a, b) in enumerate(zip(res["cuda"], res["cpu"], strict=True)):
            scale = max(float(b.abs().max()), 1e-30)
            err = float((a.cpu() - b).abs().max())
            assert err <= 1e-4 * scale, (f"{what}: "
                                         f"{'output' if j == 0 else j}: "
                                         f"err {err}, scale {scale}")
        x = res["cpu"][0]
    n = ops.launch_counts()
    n_attn = sum(s.kind == "attn" for s in layer_specs(cfg))
    assert n["flash_attention_bwd"] == n_attn > 0
    assert n["ssm_scan_bwd"] == (cfg.n_layers - n_attn) * -(-S // 256) > 0


def test_jamba_trains_on_card(card):
    """The reduced jamba (Mamba and attention mixers, MoE and dense MLPs,
    no rope) trains one step on the card through both backward kernels.
    Its loss is held to the CPU's within 1e-3 relative only: in the
    reference itself its logits move by ~1e-3 when its embeddings move by
    1e-7 (tests/test_torch_families.py), so f32 rounding differences do
    not stay within 1e-5; each layer's output and every gradient leaf is
    held at 1e-4 by test_jamba_grads_layerwise_on_card_equals_cpu."""
    from repro_torch.kernels import ops
    from repro_torch.train import train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    cfg = reduced(get_config("jamba-v0.1-52b"))
    batch = TokenStream(cfg, 2, 64, DataConfig()).batch_at(0)
    tc = train_loop.TrainConfig(opt=OptConfig(lr=1e-3, warmup_steps=0))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    losses = {}
    for dev in ("cpu", "cuda"):
        p_dev = _to(_to(params, "cuda"), dev)
        for p in leaves(p_dev):
            p.requires_grad_(True)
        state = train_loop.TrainState(p_dev, train_loop.opt_lib.init_state(
            p_dev))
        ops.reset_launch_counts()
        _, m = train_loop.make_train_step(cfg, tc)(state, batch)
        losses[dev] = float(m["loss"])
        assert torch.isfinite(m["grad_norm"])
    n = ops.launch_counts()
    n_attn = sum(s.kind == "attn" for s in layer_specs(cfg))
    assert n["flash_attention_bwd"] == n_attn > 0
    assert n["ssm_scan_bwd"] == cfg.n_layers - n_attn > 0
    assert losses["cuda"] == pytest.approx(losses["cpu"], rel=1e-3)


# -- the multi-device layer on a world-1 NCCL group (chip_smoke phase 28) ---


@pytest.fixture(scope="module")
def nccl_mesh():
    """A (1, 1) cuda mesh over a world-1 NCCL group, destroyed after the
    module."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the NCCL group runs on it")
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    m = make_local_mesh(1, 1)
    assert dist.get_backend() == "nccl"
    yield m
    dist.destroy_process_group()


@pytest.mark.parametrize("S", [77, 2048])
def test_flash_attention_noncausal_d80_on_head_shards(nccl_mesh, S):
    """hubert's attention (non-causal, D = 80, bf16: ``fa_wgmma``) on
    DTensors split by heads over the world-1 mesh's "model" axis: the kernel
    runs on the rank's shard, its output is that shard of the plain
    result."""
    from repro_torch.distributed import sharding as sh

    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(2, 16, S, 80, generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    spec = sh.PartitionSpec(None, "model", None, None)
    dq, dk, dv = (sh.distribute(t, spec, nccl_mesh) for t in (q, k, v))
    pl = sh.placements(spec, nccl_mesh)
    before = (fa.launches, fa.wgmma_launches)
    out = fa.flash_attention(dq, dk, dv, causal=False)
    assert (fa.launches, fa.wgmma_launches) == (before[0] + 1,
                                                before[1] + 1)
    assert fa.route(torch.bfloat16, 80) == "fa_wgmma"
    assert tuple(out.placements) == tuple(pl)
    want = fa.flash_attention_plain(q, k, v, causal=False)
    torch.testing.assert_close(out.to_local().float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.parametrize("shape", [(2048,), (2048, 5632), (1000, 37)])
def test_collectives_on_nccl_equal_the_in_step_pairs(nccl_mesh, shape):
    from repro_torch.distributed import grad_compress as gc

    g = torch.randn(shape, generator=torch.Generator(device="cuda")
                    .manual_seed(1), device="cuda")
    grp = nccl_mesh.get_group("data")
    assert torch.equal(gc.compressed_psum(g, grp),
                       gc.decompress(*gc.compress(g)))
    v, i = gc.topk_compress(g, 0.01)
    assert torch.equal(gc.sparse_psum(g, grp, 0.01),
                       gc.topk_decompress(v, i, g.shape))


def _ep_case(dt, T=256, K=4, E=8, M=256, F=128, seed=2):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda")  # noqa: E731
    ids = torch.randint(0, E, (T, K), generator=gen, device="cuda")
    gate = torch.rand(T, K, generator=gen, device="cuda")
    return (r(T, M).to(dt), ids, gate, (r(E, M, F) / 16).to(dt),
            (r(E, M, F) / 16).to(dt), (r(E, F, M) / 11).to(dt))


def test_ep_a2a_over_nccl_equals_the_local_path(nccl_mesh):
    from repro_torch.distributed import ep_a2a

    args = _ep_case(torch.bfloat16)
    local = ep_a2a.moe_ep_a2a_local(*args)
    grouped = ep_a2a.moe_ep_a2a_local(*args,
                                      group=nccl_mesh.get_group("model"))
    assert torch.equal(local, grouped)
    assert torch.equal(local, ep_a2a.moe_ep_a2a_local(*args))


@pytest.mark.parametrize("factor", [1.25, 0.5])
def test_ep_a2a_on_card_equals_cpu(nccl_mesh, factor):
    from repro_torch.distributed import ep_a2a

    torch.backends.cuda.matmul.allow_tf32 = False
    args = _ep_case(torch.float32)
    cpu = [a.cpu() for a in args]
    cap = int(256 * 4 * factor)
    on_card = ep_a2a.bucket_by_peer(*args[:3], 1, cap)
    on_cpu = ep_a2a.bucket_by_peer(*cpu[:3], 1, cap)
    for a, b in zip(on_card[1:], on_cpu[1:]):
        assert torch.equal(a.cpu(), b)
    got = ep_a2a.moe_ep_a2a_local(*args, group=nccl_mesh.get_group("model"),
                                  capacity_factor=factor)
    want = ep_a2a.moe_ep_a2a_local(*cpu, capacity_factor=factor)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def test_restore_reshards_onto_the_cuda_mesh(nccl_mesh, tmp_path):
    from torch.distributed.tensor import DTensor

    from repro_torch.distributed.sharding import TRAIN_RULES, NamedSharding
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train import train_loop
    from repro_torch.train.tree import flatten_with_path, map_tree

    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    state = train_loop.init_state(cfg, torch.Generator(device="cuda")
                                  .manual_seed(0), device="cuda")
    ckpt.save(str(tmp_path), 1, state)
    shardings = map_tree(lambda p: NamedSharding(nccl_mesh, p),
                         train_loop.state_pspecs(cfg, TRAIN_RULES, nccl_mesh))
    out = ckpt.restore(str(tmp_path), 1, state, sharding_tree=shardings)
    for (_, got), (_, want), (_, ns) in zip(
            flatten_with_path(out), flatten_with_path(state),
            flatten_with_path(shardings), strict=True):
        assert isinstance(got, DTensor) and got.placements == ns.placements
        assert got.device.type == "cuda"
        assert torch.equal(got.full_tensor(), want.detach())


def test_train_step_under_the_cuda_mesh_equals_the_step_without(nccl_mesh):
    from repro_torch.distributed.sharding import TRAIN_RULES, sharding_ctx
    from repro_torch.train import train_loop
    from repro_torch.train.data import DataConfig, TokenStream
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    batch = TokenStream(cfg, 2, 128, DataConfig()).batch_at(0)
    step = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=OptConfig(lr=1e-3, warmup_steps=0)))
    states = [train_loop.init_state(cfg, torch.Generator(device="cuda")
                                    .manual_seed(0), device="cuda")
              for _ in range(2)]
    plain, m0 = step(states[0], batch)
    with sharding_ctx(nccl_mesh, TRAIN_RULES):
        meshed, m1 = step(states[1], batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(leaves(plain), leaves(meshed), strict=True):
        assert torch.equal(a.detach(), b.detach())


# -- the kernels' gradients on DTensor shards (sharded training) -------------


def _dtensors(nccl_mesh, spec, *tensors):
    """Each tensor placed on the world-1 mesh by ``spec``, a leaf that
    takes a gradient."""
    from repro_torch.distributed import sharding as sh

    return [sh.distribute(t.detach(), spec, nccl_mesh).requires_grad_(True)
            for t in tensors]


@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "fa_bwd_wgmma"),
                                         (torch.float32, "fa_bwd_f32")])
def test_flash_attention_backward_on_dtensor_shards(nccl_mesh, dtype, route):
    """Sharded training's attention: q, k, v DTensors split by batch and
    heads on the world-1 mesh, the forward kernel on the rank's shards
    (``kernels/_dtensor.on_shards``) and under autograd the backward
    kernel of its route on the same shards, one launch each; the output
    and the gradients, which come back in the arguments' placements, are
    the plain version's (f32 at TOL, bf16 at TOL and the 64-row tile
    limit)."""
    from repro_torch.distributed import sharding as sh

    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = _bwd_inputs(gen, 2, 8, 2, 256, 64)
    q, k, v, do = (t.to(dtype) for t in (q, k, v, do))
    spec = sh.PartitionSpec("data", "model", None, None)
    dq, dk, dv = _dtensors(nccl_mesh, spec, q, k, v)
    ddo = sh.distribute(do, spec, nccl_mesh)
    n0 = (fa.launches, getattr(fa, route.replace("fa_", "") + "_launches"))
    out = fa.flash_attention(dq, dk, dv, window=100)
    got = torch.autograd.grad(out, (dq, dk, dv), ddo)
    assert (fa.launches, getattr(fa, route.replace("fa_", "") +
                                 "_launches")) == (n0[0] + 1, n0[1] + 1)
    assert fa.bwd_route(dtype, 64, False) == route
    assert all(tuple(g.placements) == tuple(t.placements)
               for g, t in zip(got, (dq, dk, dv)))
    qp, kp, vp = (t.detach().requires_grad_(True) for t in (q, k, v))
    ref = fa.flash_attention_plain(qp, kp, vp, window=100)
    want = torch.autograd.grad(ref, (qp, kp, vp), do)
    _assert_kernel_close(out.to_local(), ref.detach(), dtype, "forward")
    for name, g, w in zip("qkv", got, want):
        _assert_kernel_close(g.to_local(), w, dtype, f"d{name}")


@pytest.mark.parametrize("D,causal,window,positions,route", [
    (80, False, 0, False, "fa_bwd_wgmma"),  # hubert-xlarge's heads
    (128, True, 0, True, "fa_bwd_wgmma"),  # qwen2-vl-7b's positions
    (128, True, 64, False, "fa_bwd_wgmma"),  # gemma3-27b's window
    (128, True, 0, True, "fa_bwd_mma")],  # the mma kernels, by name
    ids=["mma-D80-noncausal", "mma-positions", "wgmma-window",
         "mma-by-name"])
def test_flash_attention_backward_routes_on_dtensor_shards(
        nccl_mesh, D, causal, window, positions, route):
    """The bf16 routes the other families' sharded training takes, on
    DTensor shards split by batch and heads on the world-1 mesh: the wgmma
    backward where the forward is ``fa_wgmma``, at a head dim of 80
    (non-causal), under given positions (split by batch as q is, stream 0
    off the row index in row 1; the position tables made from the rank's
    shard) and under a window; and the ``mma`` kernels where the forward
    names ``fa_mma``; one launch of the forward and of the route's
    backward, the gradients in the arguments' placements, output and
    gradients the plain version's (TOL and the 64-row tile limit).  (The
    first two ids name the mma routes these calls took before fa_wgmma
    took positions and D = 80.)"""
    from repro_torch.distributed import sharding as sh

    gen = torch.Generator(device="cuda").manual_seed(7)
    q, k, v, do = _bwd_inputs(gen, 2, 8, 2, 256, D)
    pos = None
    if positions:
        pos = torch.arange(256, dtype=torch.int32, device="cuda").repeat(2, 1)
        pos[1, 5:] += 3
    spec = sh.PartitionSpec("data", "model", None, None)
    dq, dk, dv = _dtensors(nccl_mesh, spec, q, k, v)
    ddo = sh.distribute(do, spec, nccl_mesh)
    dpos = None if pos is None else sh.distribute(
        pos, sh.PartitionSpec("data", None), nccl_mesh)
    counter = route.replace("fa_", "") + "_launches"
    named = "fa_mma" if route == "fa_bwd_mma" else None
    n0 = (fa.launches, getattr(fa, counter))
    kw = dict(causal=causal, window=window)
    out = fa.flash_attention(dq, dk, dv, q_pos=dpos, k_pos=dpos, route=named,
                             **kw)
    got = torch.autograd.grad(out, (dq, dk, dv), ddo)
    assert (fa.launches, getattr(fa, counter)) == (n0[0] + 1, n0[1] + 1)
    assert fa.bwd_route(torch.bfloat16, D, positions) == "fa_bwd_wgmma"
    assert all(tuple(g.placements) == tuple(t.placements)
               for g, t in zip(got, (dq, dk, dv)))
    qp, kp, vp = (t.detach().requires_grad_(True) for t in (q, k, v))
    ref = fa.flash_attention_plain(qp, kp, vp, q_pos=pos, k_pos=pos, **kw)
    want = torch.autograd.grad(ref, (qp, kp, vp), do)
    _assert_kernel_close(out.to_local(), ref.detach(), torch.bfloat16,
                         "forward")
    for name, g, w in zip("qkv", got, want):
        _assert_kernel_close(g.to_local(), w, torch.bfloat16, f"d{name}")


def test_ssm_scan_backward_on_dtensor_shards(nccl_mesh):
    """Sharded training's scan: dA, dBx and h0 DTensors split by batch and
    inner channels, C by batch, on the world-1 mesh; the checkpoint-writing
    forward and the backward kernels on the rank's shards, one launch of
    each; outputs and gradients equal autograd of the plain version."""
    from repro_torch.distributed import sharding as sh

    gen = torch.Generator(device="cuda").manual_seed(6)
    dA, dBx = (torch.rand(2, 40, 64, 16, generator=gen, device="cuda") * 0.9
               for _ in range(2))
    C = torch.randn(2, 40, 16, generator=gen, device="cuda")
    h0 = torch.randn(2, 64, 16, generator=gen, device="cuda")
    gy = torch.randn(2, 40, 64, generator=gen, device="cuda")
    inner = sh.PartitionSpec("data", None, "model", None)
    ins = (*_dtensors(nccl_mesh, inner, dA, dBx),
           *_dtensors(nccl_mesh, sh.PartitionSpec("data", None, None), C),
           *_dtensors(nccl_mesh, sh.PartitionSpec("data", "model", None), h0))
    n0 = (ssm.ckpt_launches, ssm.bwd_launches)
    y, h = ssm.ssm_scan(*ins)
    got = torch.autograd.grad(
        (y * sh.distribute(gy, sh.PartitionSpec("data", None, "model"),
                           nccl_mesh)).sum() + h.sum(), ins)
    assert (ssm.ckpt_launches, ssm.bwd_launches) == (n0[0] + 1, n0[1] + 1)
    plain = [t.detach().requires_grad_(True) for t in (dA, dBx, C, h0)]
    y_p, h_p = ssm.ssm_scan_plain(*plain)
    want = torch.autograd.grad((y_p * gy).sum() + h_p.sum(), plain)
    torch.testing.assert_close(y.to_local(), y_p.detach(), rtol=1e-4,
                               atol=1e-4)
    for g, t, w in zip(got, ins, want):
        assert tuple(g.placements) == tuple(t.placements)
        torch.testing.assert_close(g.to_local(), w, rtol=1e-4, atol=1e-4)
