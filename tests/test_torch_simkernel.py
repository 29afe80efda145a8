"""The port's tensor tick simulator against the reference's ``lax.scan`` one.

On the trace of ``tests/test_simkernel_jax.py::_setup`` (40 functions,
15 s, 8 threads, 12 cores) every policy code must give the reference's
completion ticks exactly, and its busy time, overhead and final credit
within rtol 1e-5.  The pick rule (ties to the lower slot, the slot-0
scatter quirk) is checked on hand-built keys against ``lax.top_k`` and the
reference's scatter, and the port's copy of the numpy engine bounds the
simulator as the reference's test does.
"""
import jax
import jax.numpy as jnp
import numpy as np
from jax.extend import core as jcore
import pytest
import torch

from repro.core import simkernel_jax as sj
from repro.core.traces import make_workload as make_workload_ref
from repro_torch.core import simkernel_torch as st
from repro_torch.core import xla_f32
from repro_torch.core.policies import make_policy
from repro_torch.core.simkernel import SimConfig, simulate
from repro_torch.core.traces import lightest_band_fns, make_workload
from repro_torch.fleet.simulate import _pad_trace
from repro_torch.sched import torch_backend as tb

CODES = sorted(tb.NAME_OF)
N_FNS, DUR, SEED, THREADS = 40, 15.0, 3, 8  # tests/test_simkernel_jax.py


def _params(mod, code, n_fns=N_FNS, dur=DUR, n_cores=12, **kw):
    rt = (tuple(int(f) for f in lightest_band_fns(n_fns))
          if code == tb.LAGS_STATIC else ())
    return mod.SimParams(n_cores=n_cores, n_fns=n_fns,
                         n_ticks=int(dur / mod.TICK), policy=code,
                         rt_fns=rt, **kw)


@pytest.fixture(scope="module")
def setup():
    wl = make_workload("azure2021", N_FNS, duration_s=DUR, seed=SEED,
                       threads_per_fn=THREADS)
    return (wl, sj.build_slot_trace(wl, N_FNS, THREADS),
            st.build_slot_trace(wl, N_FNS, THREADS, device="cpu"))


@pytest.fixture(scope="module")
def runs(setup):
    """The port's run of each code on the setup trace, made once."""
    cache = {}

    def run(code):
        if code not in cache:
            cache[code] = st.simulate(setup[2], _params(st, code))
        return cache[code]
    return run


def test_workload_copy_and_slot_trace_equal_the_reference():
    kw = dict(duration_s=DUR, seed=SEED, threads_per_fn=THREADS)
    wl, ref = make_workload("azure2021", N_FNS, **kw), \
        make_workload_ref("azure2021", N_FNS, **kw)
    for a, b in zip(wl.arrivals + wl.service_s, ref.arrivals + ref.service_s):
        np.testing.assert_array_equal(a, b)
    got = st.build_slot_trace(wl, N_FNS, THREADS, device="cpu")
    want = sj.build_slot_trace(ref, N_FNS, THREADS)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.device.type == "cpu" and g.numpy().dtype == w.dtype
        np.testing.assert_array_equal(g.numpy(), w)


@pytest.mark.parametrize("code", CODES, ids=lambda c: tb.NAME_OF[c])
def test_simulate_equals_jax(setup, runs, code):
    want = sj.simulate(setup[1], _params(sj, code))
    got = runs(code)
    np.testing.assert_array_equal(got["done_tick"].numpy(),
                                  np.asarray(want["done_tick"]))
    for k in ("busy_s", "overhead_s", "credit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)
    lat = st.latencies_from(setup[2], got["done_tick"])
    assert len(lat) > 100 and (lat > 0).all()


@pytest.mark.parametrize("name", ["cfs", "lags"])
def test_matches_numpy_engine(runs, name):
    """The bounds of tests/test_simkernel_jax.py::test_matches_numpy_engine,
    against the port's copy of the numpy engine."""
    out = runs(tb.CODE_OF[name])
    wl = make_workload("azure2021", N_FNS, duration_s=DUR, seed=SEED,
                       threads_per_fn=THREADS)
    trace = st.build_slot_trace(wl, N_FNS, THREADS, device="cpu")
    lat = st.latencies_from(trace, out["done_tick"])
    r = simulate(wl, make_policy(name), SimConfig())
    assert abs(len(lat) - r.n_completed) <= max(3, 0.05 * r.n_completed)
    assert abs(np.median(lat) - r.pct(50)) < 0.25 * max(r.pct(50), 0.05)
    ovh = float(out["overhead_s"]) / (12 * DUR)
    assert abs(ovh - r.overhead_frac) < 0.05


def test_xla_log_equals_jitted_jnp_log():
    """The simulator's log table: XLA's f32 log, bit for bit."""
    x = np.concatenate([
        np.arange(1, 70000, dtype=np.float32),
        np.random.default_rng(0).uniform(1e-3, 1e6, 100000).astype(np.float32)])
    want = np.asarray(jax.jit(jnp.log)(x))
    np.testing.assert_array_equal(xla_f32.log(x), want)
    # torch's log is another function: the table is needed
    assert (torch.log(torch.from_numpy(x)).numpy() != want).sum() > 100


def test_fma_equals_the_compiled_multiply_add():
    rng = np.random.default_rng(1)
    a, b, c = (rng.uniform(-4, 4, 100000).astype(np.float32)
               for _ in range(3))
    want = np.asarray(jax.jit(lambda a, b, c: a * b + c)(a, b, c))
    got = xla_f32.fma(torch.from_numpy(a), torch.from_numpy(b),
                      torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (a * b + c != want).sum() > 100  # the FMA is not mul then add


def _ref_pick(key, C):
    """The reference's pick (simkernel_jax.py:146-151), jitted."""
    @jax.jit
    def f(key):
        neg, idx = jax.lax.top_k(-key, C)
        picked = jnp.isfinite(-neg)
        run_slots = jnp.where(picked, idx, -1)
        slot = jnp.zeros(key.shape[0], bool).at[
            jnp.maximum(run_slots, 0)].set(picked)
        return jnp.maximum(run_slots, 0), picked, slot
    return [np.asarray(x) for x in f(jnp.asarray(key))]


INF = np.float32(np.inf)
TIE = np.arange(8, dtype=np.float32) * np.float32(1e-12)
PICK_CASES = {
    # equal keys above 1e-4: the tie term is erased, the lower slot wins
    "ties": (np.full(8, 0.5, np.float32) + TIE, 3),
    # every slot sticky: all keys collapse to -1e18
    "all_sticky": ((np.float32(0.25) + TIE) - np.float32(1e18), 4),
    # fewer runnable than C, slot 0 among them: slot 0 reads unpicked
    "few_with_slot0": (np.array([0.1, INF, 0.3, INF, INF, 0.2, INF, INF],
                                np.float32) + TIE, 5),
    # fewer runnable than C, slot 0 not among them
    "few_without_slot0": (np.array([INF, 0.5, INF, 0.5, INF, INF, INF, 0.1],
                                   np.float32) + TIE, 4),
    "none_runnable": (np.full(8, INF, np.float32), 3),
    # below 1e-4 the tie term decides: slot 0 one ulp above slot 5's key
    "sub_1e4": (np.array([np.nextafter(np.float32(1e-5), np.float32(1)),
                          0.5, 0.5, 0.5, 0.5, 1e-5, 0.5, 0.5], np.float32)
                + TIE, 3),
}


@pytest.mark.parametrize("case", sorted(PICK_CASES))
def test_pick_rule_equals_top_k_and_the_reference_scatter(case):
    key, C = PICK_CASES[case]
    want = _ref_pick(key, C)
    got = [x[0].numpy() for x in st.pick(torch.from_numpy(key)[None], C)]
    for g, w, what in zip(got, want, ("run_slot", "picked", "picked_slot")):
        np.testing.assert_array_equal(g, w, err_msg=what)
    if case == "few_with_slot0":  # the quirk the port copies
        assert got[1][0] and got[0][0] == 0 and not got[2][0]


@pytest.mark.parametrize("code", [tb.CFS, tb.RR, tb.CFS_TUNED],
                         ids=lambda c: tb.NAME_OF[c])
def test_slot0_quirk_in_a_hand_built_trace(code):
    """Slot 0 alone runnable on two cores: the reference's scatter marks it
    unpicked, so it holds no slice and its last pick tick never moves, yet
    it runs.  The port copies that, tick for tick."""
    BIG = st.BIG
    at = np.full((3, 4), BIG, np.int32)
    de = np.zeros((3, 4), np.float32)
    at[0, :3] = [0, 2, 40]
    de[0, :3] = [0.02, 0.05, 0.01]
    at[1, :2] = [30, 31]
    de[1, :2] = [0.03, 0.01]
    fn = np.array([0, 0, 1], np.int32)
    p = dict(n_cores=2, n_fns=2, n_ticks=80, policy=code)
    want = sj.simulate(sj.SlotTrace(*(jnp.asarray(x) for x in (at, de, fn))),
                       sj.SimParams(**p))
    got = st.simulate(st.SlotTrace(*(torch.from_numpy(x)
                                     for x in (at, de, fn))),
                      st.SimParams(**p))
    np.testing.assert_array_equal(got["done_tick"].numpy(),
                                  np.asarray(want["done_tick"]))
    assert (got["done_tick"][0, :3] >= 0).all()
    for k in ("busy_s", "overhead_s", "credit"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, err_msg=k)


def test_batch_of_nodes_equals_each_node_alone():
    """Two different nodes, padded to one (T, R) and stacked, give each
    node's own results bit for bit."""
    traces, outs = [], []
    for n_fns, seed in ((6, 1), (5, 2)):
        wl = make_workload("azure2021", n_fns, duration_s=3.0, seed=seed,
                           threads_per_fn=4)
        traces.append(st.build_slot_trace(wl, n_fns, 4, device="cpu"))
        outs.append(st.simulate(traces[-1], _params(st, tb.LAGS, n_fns=n_fns,
                                                    dur=3.0, n_cores=4)))
    R = max(t.arrival_tick.shape[1] for t in traces)
    padded = [_pad_trace(t, 24, R) for t in traces]
    batch = st.simulate(st.SlotTrace(*(torch.stack(x) for x in zip(*padded))),
                        _params(st, tb.LAGS, n_fns=6, dur=3.0, n_cores=4))
    for i, (t, out) in enumerate(zip(traces, outs)):
        t0, r0 = t.arrival_tick.shape
        assert torch.equal(batch["done_tick"][i, :t0, :r0], out["done_tick"])
        assert (batch["done_tick"][i, t0:] == -1).all()
        for k in ("busy_s", "overhead_s"):
            assert torch.equal(batch[k][i], out[k])


def _ref_final_state(trace, p):
    """The reference's final ``lax.scan`` state (ptr, rem, vrt_fn, load,
    credit, ...), read from its own program: ``sj.simulate`` returns no
    ``load``, so its jaxpr is re-run with the scan's outputs as results."""
    closed = jax.make_jaxpr(lambda t: sj.simulate(t, p))(trace)
    inner = closed.jaxpr.eqns[0].params["jaxpr"]  # the jitted body
    (scan,) = [e for e in inner.jaxpr.eqns if e.primitive.name == "scan"]
    body = jcore.ClosedJaxpr(inner.jaxpr.replace(outvars=list(scan.outvars)),
                             inner.consts)
    return jax.jit(jcore.jaxpr_as_fun(body))(*trace)


@pytest.mark.parametrize("n_ticks", [1000, 1050, 1500])
@pytest.mark.parametrize("code", [tb.LAGS, tb.CFS],
                         ids=lambda c: tb.NAME_OF[c])
def test_long_idle_group_flushes_subnormal_load(code, n_ticks):
    """Group 0 runs for a few ticks, then idles: its PELT load decays by
    0.5**(1/8) a tick and falls below the smallest normal f32 after about
    1010 ticks, where the reference's compiled code flushes it to zero.
    Group 0 runs again at tick 1300 and group 1 first at tick 1350.  The
    port's load, credit and completion ticks equal the reference's."""
    BIG = st.BIG
    at = np.array([[0, 1300], [1350, BIG]], np.int32)
    de = np.array([[0.02, 0.01], [0.01, 0.0]], np.float32)
    fn = np.array([0, 1], np.int32)
    p = dict(n_cores=1, n_fns=2, n_ticks=n_ticks, policy=code)
    trace = sj.SlotTrace(*(jnp.asarray(x) for x in (at, de, fn)))
    want = sj.simulate(trace, sj.SimParams(**p))
    want_load = np.asarray(_ref_final_state(trace, sj.SimParams(**p))[3])
    got = st.simulate(st.SlotTrace(*(torch.from_numpy(x)
                                     for x in (at, de, fn))),
                      st.SimParams(**p))
    if n_ticks == 1050:  # past the range of normal f32 in the reference
        assert want_load[0] == 0.0
    np.testing.assert_array_equal(got["load"].numpy(), want_load)
    np.testing.assert_array_equal(got["credit"].numpy(),
                                  np.asarray(want["credit"]))
    np.testing.assert_array_equal(got["done_tick"].numpy(),
                                  np.asarray(want["done_tick"]))
    assert (got["done_tick"].numpy() >= 0).sum() == (3 if n_ticks > 1352
                                                     else 1)
