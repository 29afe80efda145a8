"""The port's run records, report CLI and event-driven oracle against the
reference's.

The five cases of ``tests/test_des_oracle.py`` give the reference's
latencies; ``record_run``/``load_run`` and ``report``'s summary, merge and
diff give the same text for the same records; ``record_fleet`` and
``record_chaos`` write the same ``run.json`` content; and the serve CLI
with ``--obs-dir``, ``--checkpoint-every`` and ``--shard`` prints the
reference's summary line and writes records that ``report`` renders
alike (the record cases of ``tests/test_obs.py``).
"""
from __future__ import annotations

import json

import numpy as np
import pytest

import repro.core.des as ref_des
import repro.core.policies as ref_policies
import repro.core.simkernel as ref_simkernel
import repro.launch.serve as ref_serve
import repro.obs as ref_obs
import repro_torch.core.des as port_des
import repro_torch.core.policies as port_policies
import repro_torch.core.simkernel as port_simkernel
import repro_torch.launch.serve as port_serve
import repro_torch.obs as port_obs
from test_torch_chaos import PORT, REF


@pytest.fixture(autouse=True)
def _obs_reset():
    """Keep both packages' process-wide switch/registry/tracer clean."""
    def reset():
        for o in (port_obs, ref_obs):
            o.disable()
            o.registry().reset()
            o.uninstall_tracer()
    reset()
    yield
    reset()


# --- the event-driven oracle (tests/test_des_oracle.py) ---------------------


def _single(des, pol):
    sim = des.EventSim(n_fns=1, n_cores=1, policy=pol.make_policy("cfs"))
    sim.submit(0, t=0.0, demand=0.25)
    return sim.run(until=2.0)


def _share(des, pol):
    sim = des.EventSim(n_fns=2, n_cores=1, policy=pol.make_policy("cfs"))
    sim.submit(0, 0.0, 0.2)
    sim.submit(1, 0.0, 0.2)
    return sim.run(until=5.0)


def _lags(des, pol):
    sim = des.EventSim(n_fns=2, n_cores=1, policy=pol.make_policy("lags"))
    sim.tracker.credit[:] = [1.0, 0.0]
    sim.submit(0, 0.0, 0.3)
    sim.submit(1, 0.01, 0.1)
    return sim.run(until=5.0)


def _multicore(des, pol):
    sim = des.EventSim(n_fns=3, n_cores=3, policy=pol.make_policy("cfs"))
    for f in range(3):
        sim.submit(f, 0.0, 0.2)
    return sim.run(until=1.0)


def _vs_simkernel(des, pol, sk=None):
    arr = [np.asarray([0.0]), np.asarray([0.0])]
    svc = [np.asarray([0.2]), np.asarray([0.2])]
    wl = sk.Workload(2, arr, svc, threads_per_fn=1, duration_s=2.0)
    r = sk.simulate(wl, pol.make_policy("cfs"),
                    sk.SimConfig(n_cores=1, model_switch_cost=False))
    sim = des.EventSim(2, 1, pol.make_policy("cfs"))
    sim.submit(0, 0.0, 0.2)
    sim.submit(1, 0.0, 0.2)
    lat_des = sim.run(until=2.0)
    return np.concatenate([np.asarray(lat_des), r.latencies])


DES = {"single": _single, "share": _share, "lags": _lags,
       "multicore": _multicore, "vs_simkernel": _vs_simkernel}


@pytest.mark.parametrize("case", sorted(DES))
def test_des_oracle_equals_the_reference(case):
    kw = ({"port": dict(sk=port_simkernel), "ref": dict(sk=ref_simkernel)}
          if case == "vs_simkernel" else {"port": {}, "ref": {}})
    got = np.asarray(DES[case](port_des, port_policies, **kw["port"]))
    want = np.asarray(DES[case](ref_des, ref_policies, **kw["ref"]))
    np.testing.assert_array_equal(got, want)
    if case == "single":
        np.testing.assert_allclose(got, [0.25], atol=1e-9)
    elif case == "share":
        assert len(got) == 2 and (got > 0.3).all()
    elif case == "lags":
        assert (got[1] if len(got) == 2 else got.min()) < 0.13
    elif case == "multicore":
        np.testing.assert_allclose(got, [0.2] * 3, atol=0.02)
    else:
        assert abs(got[2:].max() - got[:2].max()) < 0.05


def test_des_schedstats():
    def run(des, pol):
        sim = des.EventSim(n_fns=2, n_cores=1, policy=pol.make_policy("cfs"))
        sim.submit(0, 0.0, 0.2)
        sim.submit(1, 0.0, 0.2)
        lat = sim.run(until=2.0)
        return lat, sim.switches, sim.sched.snapshot()
    got = run(port_des, port_policies)
    assert json.dumps(got, default=list) == json.dumps(
        run(ref_des, ref_policies), default=list)
    lat, switches, snap = got
    assert len(lat) == 2 and switches == int(snap["switches"])
    assert abs(snap["useful_s"] - 0.4) < 1e-9


# --- recorder + report ------------------------------------------------------


def _mini_run(obs, policy: str, switch_s: float):
    s = obs.SchedStats(policy)
    s.account_time(10.0)
    s.account_useful(0, 10.0 - switch_s)
    s.account_switch(0, switch_s, n=5)
    for i in range(20):
        s.account_completion(0, 0.1 + 0.01 * i)
    return s


def _record_two(pkg, root):
    for pol, sw in (("fair", 2.0), ("lags", 1.0)):
        pkg.recorder.record_run(str(root / pol), {"policy": pol},
                                sched=_mini_run(pkg.obs, pol, sw))
    return [pkg.recorder.load_run(str(root / p)) for p in ("fair", "lags")]


def test_record_load_summarize_merge_and_diff(tmp_path):
    texts = []
    for pkg in (PORT, REF):
        root = tmp_path / pkg.fleet.__name__
        a, b = _record_two(pkg, root)
        assert a["sched"].switch_share == pytest.approx(0.2)
        dirs = [str(root / "fair"), str(root / "lags")]
        texts.append([
            pkg.report.summarize(a, top=3), pkg.report.diff(a, b),
            pkg.report.merge([a, b]), pkg.report.main(dirs),
            pkg.report.main(["--diff"] + dirs),
            pkg.report.main(["--merge"] + dirs),
            (root / "fair" / "run.json").read_text()])
    assert texts[0] == texts[1]
    assert "lower switch-time share: lags" in texts[0][1]


def test_record_run_includes_trace(tmp_path):
    out = []
    for pkg in (PORT, REF):
        pkg.obs.install_tracer()
        with pkg.obs.span("ev"):
            pass
        d = tmp_path / pkg.fleet.__name__
        pkg.recorder.record_run(str(d), {"policy": "x"})
        pkg.obs.uninstall_tracer()
        trace = json.loads((d / "trace.json").read_text())
        run = pkg.recorder.load_run(str(d))
        out.append(([e["name"] for e in trace["traceEvents"]],
                    run["trace_file"], run["meta"]))
    assert out[0] == out[1] == (["ev"], "trace.json", {"policy": "x"})


def _records(root):
    """Every ``run.json`` under ``root``, by relative path."""
    return {str(p.relative_to(root)): json.loads(p.read_text())
            for p in sorted(root.rglob("run.json"))}


@pytest.mark.parametrize("backend", ["numpy", "torch"])
def test_record_fleet_writes_the_reference_records(tmp_path, backend):
    def run(pkg, **bk):
        root = tmp_path / pkg.fleet.__name__
        asg = pkg.fleet.place("round-robin", 11, 2)
        fleet = pkg.fleet.simulate_fleet("lags", asg, duration_s=3.0,
                                         record_dir=str(root), **bk)
        return fleet, _records(root), pkg.report.main(
            ["--merge"] + [str(root / f"node{i}") for i in range(2)])
    got = run(PORT, **({"backend": "torch", "device": "cpu"}
                       if backend == "torch" else {}))
    want = run(REF, **({"backend": "jax"} if backend == "torch" else {}))
    assert sorted(got[1]) == ["node0/run.json", "node1/run.json"]
    if backend == "numpy":
        assert got[1] == want[1] and got[2] == want[2]
    else:  # meta names the backend; latencies are exact, f32 sums to rtol
        for k in got[1]:
            g, w = got[1][k], want[1][k]
            assert g["meta"] == {**w["meta"], "backend": "torch"}
            assert g["schedstats"]["latency"] == w["schedstats"]["latency"]
            _close(g["schedstats"], w["schedstats"])


def _close(got, want):
    """Equal structure and integers; floats within rtol 1e-5."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
    elif isinstance(want, float):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    else:
        assert got == want


def test_placement_comparison_records_each_placement(tmp_path):
    for pkg in (PORT, REF):
        pkg.fleet.placement_comparison(
            11, 2, placements=("round-robin", "pack"), duration_s=2.0,
            record_dir=str(tmp_path / pkg.fleet.__name__))
    got, want = (_records(tmp_path / p) for p in ("repro_torch.fleet",
                                                  "repro.fleet"))
    assert len(got) == 4 and got == want


def test_record_chaos_writes_the_reference_records(tmp_path):
    for pkg in (PORT, REF):
        topo = pkg.fleet.Topology.uniform(4, 2)
        asg = pkg.fleet.place("rack-spread", 32, 4, exec_s=0.1,
                              racks=topo.racks())
        res = pkg.fleet.simulate_fleet_chaos(
            "lags", asg, pkg.fleet.FaultSchedule.single_rack_crash(1, 2.0,
                                                                   topo),
            duration_s=6.0, epoch_s=1.5, exec_s=0.1, topology=topo)
        pkg.fleet.record_chaos(res, str(tmp_path / pkg.fleet.__name__))
    root, ref_root = tmp_path / "repro_torch.fleet", tmp_path / "repro.fleet"
    got, want = _records(root), _records(ref_root)
    assert len(got) == 5 and got == want
    assert "chaos" in got["run.json"]
    assert PORT.report.main([str(root)]) == REF.report.main([str(ref_root)])


# --- the serve CLI with run records -----------------------------------------


def test_serve_cli_records_equal_the_reference(tmp_path, capsys):
    argv = ["--tenants", "48", "--duration", "2", "--checkpoint-every",
            "0.5", "--shard", "s0"]
    outs = []
    for mod, o, extra in ((port_serve, port_obs, ["--device", "cpu"]),
                          (ref_serve, ref_obs, [])):
        d = tmp_path / mod.__name__
        mod.main(argv + extra + ["--obs-dir", str(d)])
        o.disable()
        lines = capsys.readouterr().out.splitlines()
        assert lines[1] == f"run record -> {d / 'run.json'}"
        outs.append((lines[0], lines[2:], (d / "run.json").read_text()))
    assert outs[0] == outs[1]
    assert "checkpoints=4" in outs[0][0]
    run = json.loads(outs[0][2])
    assert run["meta"]["shard"] == "s0" and run["meta"]["checkpoints"] == 4
    got = PORT.report.main([str(tmp_path / port_serve.__name__)])
    assert got == REF.report.main([str(tmp_path / ref_serve.__name__)])


def test_serve_cli_obs_smoke(tmp_path):
    """The port's CLI with telemetry and a trace, then a report diff."""
    for pol in ("fair", "lags"):
        port_serve.main(["--policy", pol, "--tenants", "8", "--duration", "2",
                         "--device", "cpu", "--obs-dir", str(tmp_path / pol),
                         "--trace"])
        port_obs.disable()
        port_obs.uninstall_tracer()
    out = PORT.report.main(
        ["--diff", str(tmp_path / "fair"), str(tmp_path / "lags")])
    assert "switch_share" in out and "p99_latency" in out
    trace = json.loads((tmp_path / "lags" / "trace.json").read_text())
    assert trace["traceEvents"], "trace should contain engine.step events"
    ts = [e["ts"] for e in trace["traceEvents"]]
    assert ts == sorted(ts) and all(t >= 0 for t in ts)
