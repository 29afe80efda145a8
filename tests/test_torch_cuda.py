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
from repro_torch.sched import torch_backend as tb

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),  # tests/test_kernels.py
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


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
