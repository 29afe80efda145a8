"""The port's topology-aware chaos layer against the reference's.

The 31 cases of ``tests/test_chaos_topology.py`` run through ``repro`` and
``repro_torch``: topologies, the SUSPECT tier of the health tracker, the
trend detector's hysteresis, the extended schedule grammar (the same
errors, the same JSON bytes), ``rack-spread``, the controller's fencing
and proactive drain on the numpy backend, the serving engine's fence
windows and the report's failover section must agree, and the
reference's behavioural assertions hold on the port.  A partition and a
rack crash also run on ``backend="torch", device="cpu"`` against
``backend="jax"``, exactly.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.fleet.placement as ref_placement
import repro.scheduler.tenant as ref_tenant
import repro.serving.engine as ref_engine
import repro_torch.fleet.placement as port_placement
import repro_torch.scheduler.tenant as port_tenant
import repro_torch.serving.engine as port_engine
from test_torch_chaos import PORT, REF, both, same_chaos

# --- topology ----------------------------------------------------------------


def test_topology_uniform_and_queries():
    def run(pkg):
        topo = pkg.fleet.Topology.uniform(10, rack_size=5)
        with pytest.raises(ValueError) as err:
            topo.nodes_in(2)
        return (topo.n_nodes, topo.n_racks, topo.rack_of(0), topo.rack_of(9),
                list(topo.nodes_in(1)), topo.racks().tolist(), str(err.value))
    got, want = both(run)
    assert got == want
    assert got[:5] == (10, 2, 0, 1, [5, 6, 7, 8, 9])


def test_topology_flat_every_node_its_own_rack():
    def run(pkg):
        topo = pkg.fleet.Topology.flat(4)
        return topo.n_racks, [topo.rack_of(n) for n in range(4)]
    got, want = both(run)
    assert got == want == (4, [0, 1, 2, 3])


@pytest.mark.parametrize("racks", [(0, 2), ()], ids=["gappy", "empty"])
def test_topology_rejects_gappy_or_empty_racks(racks):
    msgs = []
    for pkg in (PORT, REF):
        with pytest.raises(ValueError) as err:
            pkg.fleet.Topology(rack_of_node=racks)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_topology_json_round_trip_byte_exact():
    def run(pkg):
        topo = pkg.fleet.Topology.uniform(6, rack_size=2, zone_racks=3)
        text = topo.to_json()
        back = pkg.fleet.Topology.from_json(text)
        assert back == topo and back.to_json() == text
        return text
    got, want = both(run)
    assert got == want


# --- HealthTracker: the SUSPECT tier ----------------------------------------


def _verdicts(tr, times):
    return [(tr.failed_hosts(now=t), tr.suspect_hosts(now=t)) for t in times]


def test_delayed_heartbeats_with_progress_is_suspect_not_failed():
    def run(pkg):
        tr = pkg.fault.HealthTracker(n_hosts=2, timeout_s=5.0)
        for h in (0, 1):
            tr.heartbeat(h, now=0.0)
        tr.heartbeat(1, now=9.0)
        tr.observe_progress(0, now=9.0)
        return _verdicts(tr, (10.0,))
    got, want = both(run)
    assert got == want == [([], [0])]


def test_suspect_becomes_failed_once_progress_goes_stale_too():
    def run(pkg):
        tr = pkg.fault.HealthTracker(n_hosts=1, timeout_s=5.0)
        tr.heartbeat(0, now=0.0)
        tr.observe_progress(0, now=4.0)
        return _verdicts(tr, (8.0, 10.0))
    got, want = both(run)
    assert got == want == [([], [0]), ([0], [])]


def test_never_progressed_host_keeps_heartbeat_only_timing():
    def run(pkg):
        tr = pkg.fault.HealthTracker(n_hosts=1, timeout_s=5.0)
        tr.heartbeat(0, now=0.0)
        return _verdicts(tr, (5.5,))
    got, want = both(run)
    assert got == want == [([0], [])]


def test_progress_timeout_s_overrides_staleness_horizon():
    def run(pkg):
        tr = pkg.fault.HealthTracker(n_hosts=1, timeout_s=2.0,
                                     progress_timeout_s=10.0)
        tr.heartbeat(0, now=0.0)
        tr.observe_progress(0, now=0.0)
        return _verdicts(tr, (5.0, 11.0))
    got, want = both(run)
    assert got == want
    assert got[0][1] == [0] and got[1][0] == [0]


# --- TrendDetector: hysteresis ----------------------------------------------


def _feed(td, host, value, others=(1, 2, 3), baseline=1.0):
    for o in others:
        td.observe(o, baseline)
    return td.observe(host, value)


def _trend(pkg, values, forget=False, **kw):
    td = pkg.fault.TrendDetector(n_hosts=4, alpha=1.0, **kw)
    out = [_feed(td, 0, v) for v in values]
    if forget:
        td.forget(0)
        out.append(0 in td.ewma)
    return out, td.drain_hosts()


def test_trend_detector_debounces_single_burst():
    got, want = both(_trend, values=[1.0, 1.0, 2.0, 1.0, 2.0, 2.0],
                     enter_ratio=1.5, persist=2)
    assert got == want
    assert got == ([False] * 5 + [True], [0])


def test_trend_detector_hysteresis_band_never_flaps():
    values = [1.0, 1.0, 1.6, 1.4, 1.25, 1.45, 1.3, 1.0, 1.3, 1.45, 1.35]
    got, want = both(_trend, values=values, enter_ratio=1.5, exit_ratio=1.2,
                     persist=1)
    assert got == want
    assert got[0][2:7] == [True] * 5 and not any(got[0][7:])


def test_trend_detector_forget_drops_history():
    got, want = both(_trend, values=[1.0, 1.0, 3.0], forget=True,
                     enter_ratio=1.5, persist=1)
    assert got == want == ([False, False, True, False], [])


def test_trend_detector_rejects_inverted_band():
    msgs = []
    for pkg in (PORT, REF):
        with pytest.raises(ValueError) as err:
            pkg.fault.TrendDetector(n_hosts=2, enter_ratio=1.2,
                                    exit_ratio=1.5)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --- schedule grammar: validation -------------------------------------------


def _rejects(events, n_nodes, topo, match=None):
    """Both packages refuse the schedule with the same message."""
    msgs = []
    for pkg in (PORT, REF):
        t = pkg.fleet.Topology.uniform(4, 2) if topo else None
        evs = [pkg.fleet.FaultEvent(*a, **k) for a, k in events]
        with pytest.raises(ValueError, match=match) as err:
            pkg.fleet.FaultSchedule(evs, n_nodes, t)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def test_rack_crash_requires_topology_and_valid_rack():
    _rejects([((1.0, "rack_crash"), dict(rack=0))], 4, False, "topology")
    _rejects([((1.0, "rack_crash"), dict(rack=2))], 4, True, "out of range")


def test_overlapping_partitions_of_same_node_rejected():
    _rejects([((1.0, "partition"), dict(nodes=(0, 1), duration=4.0)),
              ((3.0, "partition"), dict(nodes=(1, 2), duration=2.0))],
             4, False, "overlapping partitions")

    def run(pkg):
        E = pkg.fleet.FaultEvent
        return pkg.fleet.FaultSchedule(
            [E(1.0, "partition", nodes=(0,), duration=1.0),
             E(3.0, "partition", nodes=(0,), duration=1.0)], 4).to_json()
    got, want = both(run)
    assert got == want


def test_heartbeat_fault_on_crashed_node_rejected():
    _rejects([((1.0, "node_crash", 2), {}),
              ((2.0, "heartbeat_delay", 2), dict(factor=3.0))], 4, False)
    _rejects([((1.0, "rack_crash"), dict(rack=1)),
              ((2.0, "heartbeat_loss", 3), dict(factor=0.5))], 4, True)


@pytest.mark.parametrize("kw,match", [
    (dict(duration=1.0), "non-empty"),
    (dict(nodes=(1, 1), duration=1.0), "duplicates"),
    (dict(nodes=(4,), duration=1.0), "out of range"),
    (dict(nodes=(0,), duration=0.0), "duration"),
], ids=["empty", "duplicates", "range", "duration"])
def test_partition_validation_edges(kw, match):
    _rejects([((1.0, "partition"), kw)], 4, False, match)


# --- schedule grammar: byte-exact JSON round-trips --------------------------


def test_all_event_kinds_round_trip_byte_exact():
    def run(pkg):
        E = pkg.fleet.FaultEvent
        topo = pkg.fleet.Topology.uniform(4, 2)
        sched = pkg.fleet.FaultSchedule([
            E(0.5, "heartbeat_delay", 0, factor=2.5),
            E(1.0, "heartbeat_loss", 1, factor=0.3),
            E(1.5, "partition", nodes=(0, 1), duration=2.0),
            E(2.0, "node_slow", 2, factor=3.0),
            E(2.5, "burst_storm", factor=2.0),
            E(3.0, "recover"),
            E(3.5, "rack_crash", rack=1),
            E(4.0, "node_crash", 0),
        ], 4, topo)
        back = pkg.fleet.FaultSchedule.from_json(sched.to_json())
        assert back.to_json() == sched.to_json()
        assert back.events == sched.events and back.topology == topo
        return sched.to_json()
    got, want = both(run)
    assert got == want


@pytest.mark.parametrize("seed,n_events", [(0, 2), (7, 5), (4242, 8),
                                           (10000, 3)])
def test_any_random_topology_schedule_round_trips_byte_exact(seed, n_events):
    def run(pkg):
        topo = pkg.fleet.Topology.uniform(6, 2)
        sched = pkg.fleet.FaultSchedule.random(
            seed=seed, n_nodes=6, duration_s=30.0, n_events=n_events,
            topology=topo)
        back = pkg.fleet.FaultSchedule.from_json(sched.to_json())
        assert back.to_json() == sched.to_json()
        return sched.to_json()
    got, want = both(run)
    assert got == want


@pytest.mark.parametrize("seed", [0, 1, 999, 10000])
def test_random_without_topology_keeps_legacy_bytes(seed):
    def run(pkg):
        a = pkg.fleet.FaultSchedule.random(seed=seed, n_nodes=4,
                                           duration_s=20.0)
        b = pkg.fleet.FaultSchedule.random(seed=seed, n_nodes=4,
                                           duration_s=20.0, topology=None)
        assert a.to_json() == b.to_json()
        return a.to_json(), [ev.kind for ev in a.events]
    got, want = both(run)
    assert got == want
    assert set(got[1]) <= {"node_crash", "node_slow", "burst_storm",
                           "recover"}


# --- placement: rack-spread --------------------------------------------------


def test_rack_spread_reduces_to_spread_without_racks():
    def run(pkg):
        a = pkg.fleet.place("spread", 40, 4, exec_s=0.1)
        b = pkg.fleet.place("rack-spread", 40, 4, exec_s=0.1)
        assert all(np.array_equal(x, y) for x, y in zip(a.node_fns,
                                                         b.node_fns))
        return [x.tolist() for x in b.node_fns]
    got, want = both(run)
    assert got == want


def test_rack_spread_balances_nodes_and_diversifies_racks():
    def run(pkg):
        topo = pkg.fleet.Topology.uniform(4, 2)
        asg = pkg.fleet.place("rack-spread", 40, 4, exec_s=0.1,
                              racks=topo.racks())
        with pytest.raises(ValueError, match="racks") as err:
            pkg.fleet.place("rack-spread", 40, 4, exec_s=0.1,
                            racks=np.array([0, 1]))
        return [x.tolist() for x in asg.node_fns], str(err.value)
    got, want = both(run)
    assert got == want
    assert sorted(len(x) for x in got[0]) == [10, 10, 10, 10]


def test_rack_spread_does_not_dogpile_a_lone_surviving_node():
    def run(placement):
        shares = placement.fn_shares(30, exec_s=0.1)
        groups = placement.PLACEMENTS["rack-spread"](
            shares, 3, racks=np.array([0, 0, 1]),
            init_load=np.array([1.0, 1.0, 1.0]))
        return [list(map(int, g)) for g in groups]
    got, want = run(port_placement), run(ref_placement)
    assert got == want
    counts = [len(g) for g in got]
    assert max(counts) - min(counts) <= 1


# --- controller integration ---------------------------------------------


def _run(pkg, sched_of, total=64, n_nodes=4, **kw):
    topo = pkg.fleet.Topology.uniform(4, 2)
    asg = pkg.fleet.place("rack-spread", total, n_nodes, exec_s=0.1,
                          racks=topo.racks())
    kw.setdefault("duration_s", 12.0)
    kw.setdefault("epoch_s", 1.5)
    return pkg.fleet.simulate_fleet_chaos(
        "lags", asg, sched_of(pkg, topo), exec_s=0.1, seed=10,
        topology=topo, **kw)


_RUNS: dict = {}


def _both_cached(sched_of, **kw):
    """``both(_run, ...)``, made once per schedule and arguments."""
    key = (sched_of.__name__, tuple(sorted(kw.items())))
    if key not in _RUNS:
        _RUNS[key] = both(_run, sched_of=sched_of, **kw)
    return _RUNS[key]


def _rack_crash(pkg, topo):
    return pkg.fleet.FaultSchedule.single_rack_crash(1, 3.0, topo)


def _partition(pkg, topo):
    return pkg.fleet.FaultSchedule.single_partition((1,), 3.0, 4.5, 4, topo)


def _delay(pkg, topo):
    return pkg.fleet.FaultSchedule(
        [pkg.fleet.FaultEvent(1.5, "heartbeat_delay", 1, factor=0.5)], 4,
        topo)


def _trending(pkg, topo):
    return pkg.fleet.FaultSchedule(
        [pkg.fleet.FaultEvent(1.5, "node_slow", 2, factor=1.8)], 4, topo)


def _trending_then_recover(pkg, topo):
    E = pkg.fleet.FaultEvent
    return pkg.fleet.FaultSchedule(
        [E(1.5, "node_slow", 2, factor=1.8), E(7.5, "recover", 2)], 4, topo)


def test_rack_crash_fails_over_every_member_and_avoids_the_rack():
    res, want = both(_run, sched_of=_rack_crash)
    same_chaos(res, want)
    assert all(m.src in (2, 3) and m.dst in (0, 1) for m in res.migrations)
    rec = res.recovery_s()
    assert set(rec) == {2, 3} and all(v is not None for v in rec.values())
    assert res.per_epoch_counts()[-1][2:] == [0, 0]
    assert all(sum(e.counts) == 64 for e in res.epochs)


def test_partition_fences_instead_of_double_placing():
    res, want = _both_cached(_partition)
    same_chaos(res, want)
    assert res.migrations == []
    assert {n for e in res.epochs for n in e.fenced} == {1}
    assert res.lost_arrivals == 0
    assert res.replayed_arrivals >= res.deferred_arrivals > 0
    assert all(sum(e.counts) == 64 for e in res.epochs)
    assert res.epochs[-1].suspects == [] and res.epochs[-1].fenced == []


def test_mild_heartbeat_delay_causes_no_false_positives():
    res, want = both(_run, sched_of=_delay)
    same_chaos(res, want)
    assert res.migrations == []
    assert all(e.suspects == [] and e.fenced == [] for e in res.epochs)
    assert res.lost_arrivals == 0 and res.deferred_arrivals == 0


def test_proactive_drain_evacuates_trending_node_with_hysteresis():
    kw = dict(sched_of=_trending, proactive_drain=True,
              drain_enter_ratio=1.35, drain_exit_ratio=1.15)
    res, want = both(_run, **kw)
    rea, rea_want = both(_run, sched_of=_trending, proactive_drain=False)
    same_chaos(res, want)
    same_chaos(rea, rea_want)
    assert {n for e in res.epochs for n in e.draining} == {2}
    moves = [m for m in res.migrations if m.src == 2]
    assert moves and all(m.dst != 2 and m.cost_s >= 0.0 for m in moves)
    if rea.migrations:
        assert min(m.epoch for m in moves) < min(
            m.epoch for m in rea.migrations)


def test_proactive_drain_is_reversible_after_recover():
    res, want = both(_run, sched_of=_trending_then_recover, duration_s=18.0,
                     proactive_drain=True, drain_enter_ratio=1.35,
                     drain_exit_ratio=1.15)
    same_chaos(res, want)
    assert any(2 in e.draining for e in res.epochs)
    assert 2 not in res.epochs[-1].draining


# --- serving engine: fence windows -------------------------------------------


def _engine(tenant, engine, **kw):
    tenants = {i: tenant.Tenant(i, weight_mb=32.0) for i in range(8)}
    return engine.Engine(engine.EngineConfig(policy="lags"), tenants, **kw)


def test_engine_fence_window_defers_but_completes_in_flight():
    def run(tenant, engine, **kw):
        reqs = [tenant.Request(i, i % 8, 128, 8, arrival=0.002 * i)
                for i in range(64)]
        eng = _engine(tenant, engine, **kw)
        st = eng.run(30.0, reqs, fence_windows=[(0.05, 0.4)])
        assert not eng.fenced
        return st
    st = run(port_tenant, port_engine, device="cpu")
    want = run(ref_tenant, ref_engine)
    assert (st.fenced_steps, st.deferred, len(st.completed)) == (
        want.fenced_steps, want.deferred, len(want.completed))
    assert [r.latency for r in st.completed] == \
        [r.latency for r in want.completed]
    assert st.sched.fenced_s == want.sched.fenced_s > 0.0
    assert st.fenced_steps > 0 and st.deferred > 0
    assert len(st.completed) == 64
    assert st.sched.conservation_error() < 1e-6


def test_engine_fence_window_rejects_empty_window():
    msgs = []
    for tenant, engine, kw in ((port_tenant, port_engine, dict(device="cpu")),
                               (ref_tenant, ref_engine, {})):
        with pytest.raises(ValueError) as err:
            _engine(tenant, engine, **kw).run(1.0, [],
                                              fence_windows=[(0.5, 0.5)])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


# --- report: the failover section --------------------------------------------


def test_report_renders_empty_set_for_fault_free_chaos_record():
    rec = {"events": [], "epochs": 4, "epoch_s": 1.5, "completed": 40,
           "arrived": 40, "done_ratio": 1.0}
    txt = "\n".join(PORT.report._failover_section(rec))
    assert txt == "\n".join(REF.report._failover_section(rec))
    assert "∅" in txt and "recovery" in txt and "never" not in txt
    assert "migrations          0" not in txt


def test_report_renders_liveness_ladder_for_partition_record():
    res, want = _both_cached(_partition)
    txt = "\n".join(PORT.report._failover_section(res.report()))
    assert txt == "\n".join(REF.report._failover_section(want.report()))
    assert "fenced_nodes" in txt and "deferred/reconciled" in txt
    assert "per-epoch liveness" in txt


# --- the torch backend against the JAX backend ------------------------------

TORCH = dict(backend="torch", device="cpu")


@pytest.mark.parametrize("sched_of", [_partition, _rack_crash],
                         ids=["partition", "rack_crash"])
def test_torch_topology_chaos_equals_jax(sched_of):
    got = _run(PORT, sched_of, duration_s=9.0, **TORCH)
    want = _run(REF, sched_of, duration_s=9.0, backend="jax")
    same_chaos(got, want)
    assert got.epochs[0].fleet.backend == "torch"
    assert all(sum(e.counts) == 64 for e in got.epochs)
