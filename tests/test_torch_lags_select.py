"""Port parity for the LAGS tick: ``repro_torch``'s ``lags_select`` on the CPU
(its plain PyTorch version) against the Pallas kernel in interpret mode and
``repro.kernels.ref.lags_select_ref``, and the CUDA backend's
``tick_and_pick`` against the float64 ``numpy_reference``.

Picks must be equal; the f32 state agrees within rtol 1e-6 (the two
frameworks may round the f32 products in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.load_credit import ema_update, pelt_update
from repro.kernels import ref
from repro.kernels.lags_select import lags_select as pallas_lags_select
from repro_torch.core.load_credit import torch_tick
from repro_torch.kernels import lags_select as lags_module
from repro_torch.kernels.lags_select import lags_select
from repro_torch.sched import cuda_backend


def _random_case(T, k):
    rng = np.random.default_rng(T)
    return (rng.uniform(0, 2, T).astype(np.float32),
            rng.uniform(0, 2, T).astype(np.float32),
            rng.uniform(0, 1, T).astype(np.float32),
            rng.uniform(size=T) < 0.5, k, 1000)


def _few_runnable():
    T = 100
    runnable = np.zeros(T, bool)
    runnable[[5, 50]] = True
    z = np.zeros(T, np.float32)
    return z, np.arange(T, dtype=np.float32), z, runnable, 8, 1000


def _sub_1e4():
    """Credits below 1e-4: the key's lane*1e-12 term outweighs a one-ulp
    credit gap, so lane 0 (one ulp above lane 1000) is picked first."""
    T = 2048
    credit = np.ones(T, np.float32)
    credit[1000] = np.float32(1e-5)
    credit[0] = np.nextafter(np.float32(1e-5), np.float32(1))
    z = np.zeros(T, np.float32)
    return z, credit, z, np.ones(T, bool), 3, 10**9


def _all_equal():
    T = 300
    runnable = np.arange(T) % 3 != 1
    return (np.full(T, 0.25, np.float32), np.full(T, 0.5, np.float32),
            np.full(T, 0.5, np.float32), runnable, 16, 256)


CASES = {
    "T64_k4": lambda: _random_case(64, 4),
    "T200_k12": lambda: _random_case(200, 12),
    "T1024_k16": lambda: _random_case(1024, 16),
    "few_runnable": _few_runnable,
    "sub_1e-4": _sub_1e4,
    "all_equal": _all_equal,
}


def _port(load, credit, frac, runnable, k, window):
    t = torch.from_numpy
    nl, nc, idx = lags_select(t(load), t(credit), t(frac), t(runnable), k,
                              window=window)
    return nl.numpy(), nc.numpy(), idx.numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_pallas_interpret_and_ref(case):
    load, credit, frac, runnable, k, window = CASES[case]()
    nl, nc, idx = _port(load, credit, frac, runnable, k, window)
    j = jnp.asarray
    pl_nl, pl_nc, pl_idx = pallas_lags_select(
        j(load), j(credit), j(frac), j(runnable), k, window=window,
        interpret=True)
    r_nl, r_nc, r_idx, _ = ref.lags_select_ref(
        j(load), j(credit), j(frac), j(runnable), k, window=window)
    assert idx.dtype == np.int32
    np.testing.assert_array_equal(idx, np.asarray(pl_idx))
    np.testing.assert_array_equal(idx, np.asarray(r_idx))
    for got, want in ((nl, pl_nl), (nc, pl_nc), (nl, r_nl), (nc, r_nc)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6)


def test_sub_1e4_order_is_the_key_order_not_credit_index():
    load, credit, frac, runnable, k, window = _sub_1e4()
    _, nc, idx = _port(load, credit, frac, runnable, k, window)
    assert idx.tolist() == [0, 1000, 1]
    lexsort = np.lexsort((np.arange(len(nc)), nc))[:k]
    assert lexsort.tolist() == [1000, 0, 1]


def test_few_runnable_pads_with_minus_one():
    idx = _port(*_few_runnable())[2]
    assert idx.tolist() == [5, 50] + [-1] * 6


def test_k_above_t_pads_with_minus_one():
    T = 5
    z = np.zeros(T, np.float32)
    idx = _port(z, np.arange(T, dtype=np.float32)[::-1].copy(), z,
                np.ones(T, bool), 8, 1000)[2]
    assert idx.tolist() == [4, 3, 2, 1, 0, -1, -1, -1]


@pytest.mark.parametrize("T,k", [(1, 1), (1, 5120), (1024, 5120),
                                 (2048, 2048), (2048, 2560), (4096, 1280),
                                 (3072, 1706), (65536, 16), (65536, 1024),
                                 (65536, 2048), (100, 200)])
def test_check_domain_accepts(T, k):
    """Every (T, k) the merge-pass kernel took (ceil(T/1024)*k <= 5120),
    and k up to 2048 at T = 65536, which it refused."""
    lags_module.check_domain(T, k)


@pytest.mark.parametrize("T,k", [(0, 1), (16, 0), (65537, 16),
                                 (131072, 1), (4096, 2049), (65536, 2049)])
def test_check_domain_refuses(T, k):
    with pytest.raises(ValueError):
        lags_module.check_domain(T, k)


@pytest.mark.parametrize("T", [1, 31, 256, 1023, 1024, 1025, 4096, 4097,
                               8192, 8193, 30000, 65535, 65536])
def test_plan_covers_every_lane(T):
    """One cluster of at most 8 CTAs of at most 1024 threads (a multiple of
    32) holds all T lanes, and every CTA owns some."""
    ctas, threads, per = lags_module.plan(T)
    assert 1 <= ctas <= 8 and per in (4, 8)
    assert 32 <= threads <= 1024 and threads % 32 == 0
    assert ctas * threads * per >= T > (ctas - 1) * threads * per


def test_tick_and_pick_matches_numpy_reference():
    """The grid cases of the reference's backend test: identical pick order,
    allclose credit state, on 20 randomized cases."""
    rng = np.random.default_rng(7)
    for case in range(20):
        T = int(rng.integers(4, 33))
        # credits distinct on a 1/16 grid; one EMA step (window 256) moves
        # them < half the spacing, so f32 vs f64 cannot reorder the picks
        credit = rng.choice(np.arange(64), size=T, replace=False) / 16.0
        load = rng.integers(0, 17, T) / 16.0
        frac = rng.integers(0, 17, T) / 16.0
        runnable = rng.random(T) < 0.7
        k = int(rng.integers(1, 9))

        nl, nc, idx = cuda_backend.tick_and_pick(
            load, credit, frac, runnable, k, window=256, device="cpu")
        rl, rc, ridx = cuda_backend.numpy_reference(
            load, credit, frac, runnable, k, window=256)
        np.testing.assert_allclose(nl, rl, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(nc, rc, rtol=1e-5, atol=1e-6)
        assert idx.tolist() == ridx.tolist(), f"case {case}"


def test_torch_tick_is_bit_identical_to_numpy_in_float64():
    rng = np.random.default_rng(11)
    load, credit, frac = (rng.uniform(0, 2, 257) for _ in range(3))
    (tl, tc), out = torch_tick(
        (torch.from_numpy(load), torch.from_numpy(credit)),
        torch.from_numpy(frac), window_ticks=256)
    want_l = pelt_update(load, frac)
    want_c = ema_update(credit, want_l, 256)
    np.testing.assert_array_equal(tl.numpy(), want_l)
    np.testing.assert_array_equal(tc.numpy(), want_c)
    assert out is tc
