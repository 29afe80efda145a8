"""Port parity for the serving engine and its CLI: ``repro_torch`` on the CPU
(the credit kernel's plain version) against the JAX engine on its Pallas
kernel in interpret mode, on the same workload.

The reference engine calls the Pallas kernel without ``jit``, which retraces
it every step (about 0.3 s a step in interpret mode).  The fixture below
wraps the same function in ``jax.jit`` for the test's duration; the kernel
and the engine code are unchanged.
"""
import jax
import numpy as np
import pytest

import repro.kernels.lags_select as pallas_lags
from repro.launch import serve as jax_serve
from repro.scheduler.tenant import Request as JRequest
from repro.scheduler.tenant import Tenant as JTenant
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.kernels import ops
from repro_torch.launch import serve
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.serving.engine import Engine, EngineConfig


@pytest.fixture
def jitted_pallas(monkeypatch):
    monkeypatch.setattr(pallas_lags, "lags_select", jax.jit(
        pallas_lags.lags_select,
        static_argnames=("k", "window", "halflife", "interpret")))


def _workload(tenant_cls, request_cls, n_tenants=12, n_req=48, seed=3):
    rng = np.random.default_rng(seed)
    weights = rng.uniform(32, 256, n_tenants)
    reqs = [(r, int(rng.integers(n_tenants)), int(rng.integers(16, 256)),
             int(rng.integers(4, 24)), float(rng.uniform(0, 2.5)))
            for r in range(n_req)]
    tenants = {i: tenant_cls(i, weight_mb=float(w))
               for i, w in enumerate(weights)}
    return tenants, [request_cls(*r) for r in reqs]


def test_engine_kernel_path_matches_jax_engine(jitted_pallas):
    tj, rj = _workload(JTenant, JRequest)
    tp, rp = _workload(Tenant, Request)
    st_j = JEngine(JEngineConfig(policy="lags", pallas_threshold=1),
                   tj).run(3.0, rj)
    ops.reset_launch_counts()
    st_p = Engine(EngineConfig(policy="lags", pallas_threshold=1), tp,
                  device="cpu").run(3.0, rp)
    assert ops.launch_counts()["lags_select"] == 0  # the CPU runs no kernel
    done = lambda st: sorted((r.rid, r.finish_time) for r in st.completed)  # noqa: E731
    assert len(st_p.completed) == len(st_j.completed) > 0
    assert done(st_p) == done(st_j)
    assert st_p.membership_changes == st_j.membership_changes
    assert st_p.steps == st_j.steps
    for attr in ("credit", "load_avg"):
        np.testing.assert_allclose(
            [getattr(tp[i], attr) for i in sorted(tp)],
            [getattr(tj[i], attr) for i in sorted(tj)], rtol=1e-5, atol=1e-5)


def test_kernel_tick_matches_python_tick():
    """Engine state after one ``_kernel_tick`` == one ``Tenant.tick`` loop."""
    rng = np.random.default_rng(3)
    n = 12
    loads, creds = rng.random(n), rng.random(n)
    served = {i: float(rng.random() * 0.01) for i in range(0, n, 2)}
    step_s = 0.012
    ta = {i: Tenant(i) for i in range(n)}
    tb = {i: Tenant(i) for i in range(n)}
    for i in range(n):
        ta[i].load_avg = tb[i].load_avg = float(loads[i])
        ta[i].credit = tb[i].credit = float(creds[i])
    ta[1].queue.append(Request(0, 1, 8, 4, 0.0))
    eng = Engine(EngineConfig(policy="lags", pallas_threshold=1,
                              credit_window=256), ta, device="cpu")
    eng._kernel_tick(served, step_s)
    for i in range(n):
        tb[i].tick(served.get(i, 0.0), step_s, 256)
    for attr in ("load_avg", "credit"):
        np.testing.assert_allclose([getattr(ta[i], attr) for i in range(n)],
                                   [getattr(tb[i], attr) for i in range(n)],
                                   rtol=1e-5, atol=1e-6)
    assert [ta[i].served_s for i in range(n)] == \
        [tb[i].served_s for i in range(n)]


def test_idle_steps_tick_no_credit():
    """Every busy step ticks credit once; idle steps do not."""
    tenants = {i: Tenant(i, weight_mb=32.0) for i in range(4)}
    eng = Engine(EngineConfig(policy="lags", pallas_threshold=1), tenants,
                 device="cpu")
    calls = []
    eng._kernel_tick = lambda served, step_s: calls.append(step_s)
    st = eng.run(1.0, [Request(0, 0, 64, 5, arrival=0.5)])
    assert st.idle_steps > 0
    assert len(calls) == st.steps - st.idle_steps == 5


def _summary(st):
    lat = np.asarray([r.latency for r in st.completed])
    return (len(st.completed), float(np.median(lat)),
            float(np.percentile(lat, 95)), st.membership_changes)


def test_serve_cli_matches_jax(jitted_pallas, capsys):
    argv = ["--tenants", "300", "--duration", "2"]
    want = _summary(jax_serve.main(argv))
    jax_line = capsys.readouterr().out.strip()
    got = _summary(serve.main(argv + ["--device", "cpu"]))
    port_line = capsys.readouterr().out.strip()
    assert got == want
    assert port_line == jax_line  # the reference's summary line
