"""The port's chaos layer against the reference's.

Every scenario of ``tests/test_chaos.py`` runs through ``repro`` and
``repro_torch`` on the numpy backend: the schedules, the detectors and the
controller must give the same answers (latencies, counts, per-epoch
placement and liveness, migrations, the arrival ledger and ``report()``),
and the reference's behavioural assertions hold on the port.  Three small
scenarios run the controller on ``backend="torch", device="cpu"`` against
``backend="jax"``, exactly.
"""
from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest

import repro.distributed.fault as ref_fault
import repro.fleet as ref_fleet
import repro.obs as ref_obs
import repro.obs.recorder as ref_recorder
import repro.obs.report as ref_report
import repro_torch.distributed.fault as port_fault
import repro_torch.fleet as port_fleet
import repro_torch.obs as port_obs
import repro_torch.obs.recorder as port_recorder
import repro_torch.obs.report as port_report

REF = SimpleNamespace(fleet=ref_fleet, fault=ref_fault, obs=ref_obs,
                      recorder=ref_recorder, report=ref_report)
PORT = SimpleNamespace(fleet=port_fleet, fault=port_fault, obs=port_obs,
                       recorder=port_recorder, report=port_report)


def canon(x) -> str:
    """Canonical JSON: NaN compares equal to NaN, tuples to lists."""
    return json.dumps(x, sort_keys=True, default=str)


def same_fleet(got, want):
    """Two ``FleetResult``s: equal latencies and counts, per node."""
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert (got.n_arrived, got.n_completed) == (want.n_arrived,
                                                want.n_completed)
    for g, w in zip(got.nodes, want.nodes, strict=True):
        np.testing.assert_array_equal(g.latencies, w.latencies)
        assert (g.n_arrived, g.n_completed) == (w.n_arrived, w.n_completed)
        np.testing.assert_allclose(
            [g.busy_time_s, g.switch_time_s],
            [w.busy_time_s, w.switch_time_s], rtol=1e-5)


def same_chaos(got, want):
    """Two ``ChaosFleetResult``s: the same run, epoch for epoch."""
    np.testing.assert_array_equal(got.latencies, want.latencies)
    assert (got.n_arrived, got.n_completed) == (want.n_arrived,
                                                want.n_completed)
    assert got.per_epoch_counts() == want.per_epoch_counts()
    assert got.per_epoch_liveness() == want.per_epoch_liveness()
    for g, w in zip(got.epochs, want.epochs, strict=True):
        same_fleet(g.fleet, w.fleet)
        for k in ("alive", "detected_dead", "stragglers", "suspects",
                  "fenced", "draining", "lost_arrivals", "replayed",
                  "carried", "credited", "deferred", "reconciled",
                  "degraded"):
            assert getattr(g, k) == getattr(w, k), k
    assert [(m.epoch, m.fn, m.src, m.dst) for m in got.migrations] == \
        [(m.epoch, m.fn, m.src, m.dst) for m in want.migrations]
    np.testing.assert_allclose([m.cost_s for m in got.migrations],
                               [m.cost_s for m in want.migrations],
                               rtol=1e-12)
    for k in ("stranded_arrivals", "replayed_arrivals", "lost_arrivals",
              "carried_arrivals", "credited_arrivals", "deferred_arrivals",
              "reconciled_completions"):
        assert getattr(got, k) == getattr(want, k), k
    assert got.recovery_s() == want.recovery_s()
    assert canon(got.report()) == canon(want.report())


def both(scenario, **kw):
    """Run ``scenario(pkg, **kw)`` through the reference and the port."""
    return scenario(PORT, **kw), scenario(REF, **kw)


# --- schedule grammar & validation ------------------------------------------

BAD = {
    "unknown_kind": ([(1.0, "meteor", 0)], "unknown fault kind"),
    "negative_time": ([(-1.0, "node_crash", 0)], "time must be >= 0"),
    "slow_factor": ([(1.0, "node_slow", 0, 0.5)], "factor must be >= 1"),
    "storm_on_node": ([(1.0, "burst_storm", 2, 2.0)], "fleet-wide"),
    "recover_no_storm": ([(1.0, "recover", -1)], "no active storm"),
    "node_range": ([(1.0, "node_crash", 7)], "out of range"),
    "crash_twice": ([(1.0, "node_crash", 0), (2.0, "node_crash", 0)],
                    "crashed twice"),
    "slow_crashed": ([(1.0, "node_crash", 0), (2.0, "node_slow", 0, 2.0)],
                     "already-crashed"),
    "recover_healthy": ([(1.0, "recover", 0)], "neither crashed nor slow"),
    "crash_all": ([(1.0, "node_crash", 0), (1.5, "node_crash", 1)],
                  "crashes every node"),
}


@pytest.mark.parametrize("case", sorted(BAD))
def test_schedule_validation_rejects_bad_events(case):
    events, match = BAD[case]
    msgs = []
    for pkg in (PORT, REF):
        evs = [pkg.fleet.FaultEvent(*e) for e in events]
        with pytest.raises(ValueError, match=match) as err:
            pkg.fleet.FaultSchedule(evs, n_nodes=2)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    assert port_fleet.FLEET == ref_fleet.FLEET == -1


def _good(pkg):
    E, F = pkg.fleet.FaultEvent, pkg.fleet.FLEET
    return pkg.fleet.FaultSchedule(
        [E(1.0, "node_crash", 0), E(2.0, "recover", 0),
         E(3.0, "node_crash", 0), E(1.0, "node_slow", 1, 3.0),
         E(4.0, "recover", 1), E(0.5, "burst_storm", F, 2.0),
         E(5.0, "recover", F)], n_nodes=3)


def test_schedule_good_sequences_validate():
    got, want = both(_good)
    assert got.to_json() == want.to_json()


def test_schedule_events_in_and_ordering():
    def run(pkg):
        E = pkg.fleet.FaultEvent
        s = pkg.fleet.FaultSchedule(
            [E(3.0, "node_crash", 1), E(0.5, "node_slow", 0, 2.0)], n_nodes=2)
        return [[e.to_dict() for e in s.events_in(a, b)]
                for a, b in ((0.0, 1.0), (3.0, 4.0), (1.0, 3.0))] + \
            [[e.t for e in s.events]]
    got, want = both(run)
    assert got == want
    assert got[3] == [0.5, 3.0] and got[2] == []


@pytest.mark.parametrize("seed", [11, 12])
def test_schedule_json_roundtrip_byte_stable(seed):
    def run(pkg):
        a = pkg.fleet.FaultSchedule.random(seed=seed, n_nodes=4,
                                           duration_s=30.0, n_events=6)
        b = pkg.fleet.FaultSchedule.from_json(a.to_json())
        assert a.to_json() == b.to_json() and a.events == b.events
        return a.to_json()
    got, want = both(run)
    assert got == want


# --- detection stack --------------------------------------------------------


def _health(pkg):
    H, out = pkg.fault.HealthTracker, []
    h = H(2, timeout_s=10.0)
    h.register(0, now=0.0)
    h.register(1, now=0.0)
    out += [h.failed_hosts(now=t) for t in (0.0, 10.0, 10.1)]
    h.heartbeat(0, now=10.1)
    out += [h.failed_hosts(now=t) for t in (20.0, 20.2)]
    h2 = H(1, timeout_s=10.0)
    out += [h2.failed_hosts(now=t) for t in (5.0, 11.0)]
    h3 = H(1, timeout_s=100.0, grace_s=5.0)
    h3.register(0, now=0.0)
    out += [h3.failed_hosts(now=t) for t in (4.0, 6.0)]
    return out


def test_health_tracker_grace_period_boundaries():
    got, want = both(_health)
    assert got == want
    assert got == [[], [], [0, 1], [1], [0, 1], [], [0], [], [0]]


def _watchdog_3x(pkg):
    w = pkg.fault.StragglerWatchdog(n_hosts=4, warmup=4)
    flags = []
    for i in range(60):
        for h in (0, 1, 2):
            w.observe(h, 0.10)
        flags.append(w.observe(3, 0.30 if i >= 10 else 0.10))
    return flags, dict(w.mean)


def test_straggler_watchdog_3x_stays_flagged():
    (flags, mean), want = both(_watchdog_3x)
    assert (flags, mean) == want
    assert not any(flags[:11]) and all(flags[11:])
    assert mean[3] < 0.15


def _watchdog_hetero(pkg):
    w = pkg.fault.StragglerWatchdog(n_hosts=4, warmup=4)
    return [w.observe(h, b) for _ in range(40)
            for h, b in enumerate([0.08, 0.10, 0.12, 0.14])]


def test_straggler_watchdog_tolerates_heterogeneous_fleet():
    got, want = both(_watchdog_hetero)
    assert got == want and not any(got)


# --- controller -------------------------------------------------------------


def _tiny(pkg, n_fns, n_nodes, strategy="spread", exec_s=0.1):
    return pkg.fleet.place(strategy, n_fns, n_nodes, exec_s=exec_s)


def _empty(pkg, **bk):
    asg = _tiny(pkg, 48, 2, "round-robin")
    base = pkg.fleet.simulate_fleet("lags", asg, duration_s=6.0, exec_s=0.1,
                                    **bk)
    ch = pkg.fleet.simulate_fleet_chaos(
        "lags", asg, pkg.fleet.FaultSchedule.empty(2), duration_s=6.0,
        exec_s=0.1, **bk)
    return base, ch


def test_empty_schedule_bit_identical_to_simulate_fleet():
    (base, ch), (_, ref_ch) = both(_empty)
    same_chaos(ch, ref_ch)
    assert np.array_equal(base.latencies, ch.latencies)
    assert (base.n_arrived, base.n_completed) == (ch.n_arrived,
                                                  ch.n_completed)
    assert ch.migrations == [] and ch.lost_arrivals == 0


def _crash(pkg, rebalance, **bk):
    asg = _tiny(pkg, 24, 3)
    crash = pkg.fleet.FaultSchedule.single_crash(1, 3.0, 3)
    return pkg.fleet.simulate_fleet_chaos(
        "lags", asg, crash, rebalance=rebalance, duration_s=9.0, epoch_s=1.5,
        exec_s=0.1, seed=10, **bk), len(asg.node_fns[1])


def test_crash_rebalance_vs_static():
    (reb, n_victim), (ref_reb, _) = both(_crash, rebalance=True)
    (stat, _), (ref_stat, _) = both(_crash, rebalance=False)
    same_chaos(reb, ref_reb)
    same_chaos(stat, ref_stat)
    assert len(reb.migrations) == n_victim
    assert all(m.src == 1 and m.dst != 1 for m in reb.migrations)
    last = reb.per_epoch_counts()[-1]
    assert last[1] == 0 and sum(last) == 24
    assert reb.recovery_s()[1] is not None
    assert stat.migrations == [] and stat.recovery_s()[1] is None
    assert stat.per_epoch_counts()[-1][1] == n_victim
    assert reb.replayed_arrivals == reb.stranded_arrivals > 0
    assert reb.lost_arrivals == 0 and stat.replayed_arrivals == 0
    assert stat.lost_arrivals == stat.stranded_arrivals > 0
    assert reb.n_completed > stat.n_completed
    assert stat.n_arrived >= stat.n_completed + stat.lost_arrivals


def _slow(pkg, **bk):
    asg = _tiny(pkg, 64, 8)
    sch = pkg.fleet.FaultSchedule(
        [pkg.fleet.FaultEvent(0.0, "node_slow", 2, 3.0)], 8)
    return pkg.fleet.simulate_fleet_chaos(
        "lags", asg, sch, duration_s=8.0, epoch_s=1.0, exec_s=0.1, seed=7,
        **bk)


def test_slow_node_flagged_and_drained():
    res, want = both(_slow)
    same_chaos(res, want)
    assert any(2 in e.stragglers for e in res.epochs)
    assert 2 in res.report()["stragglers_drained"]
    assert res.per_epoch_counts()[-1][2] == 0
    assert all(m.src == 2 for m in res.migrations)
    assert sum(res.per_epoch_counts()[-1]) == 64


def _storm(pkg, empty):
    E, F = pkg.fleet.FaultEvent, pkg.fleet.FLEET
    sch = (pkg.fleet.FaultSchedule.empty(2) if empty else
           pkg.fleet.FaultSchedule([E(0.0, "burst_storm", F, 3.0),
                                    E(2.0, "recover", F)], 2))
    return pkg.fleet.simulate_fleet_chaos(
        "lags", _tiny(pkg, 16, 2), sch, duration_s=4.0, epoch_s=1.0,
        exec_s=0.1, seed=6, carry_unfinished=False)


def test_burst_storm_scales_demand_then_recovers():
    res, want = both(_storm, empty=False)
    calm, calm_want = both(_storm, empty=True)
    same_chaos(res, want)
    same_chaos(calm, calm_want)
    storm_arr = sum(e.fleet.n_arrived for e in res.epochs[:2])
    calm_arr = sum(e.fleet.n_arrived for e in calm.epochs[:2])
    assert storm_arr > 1.5 * calm_arr
    assert res.epochs[3].fleet.n_arrived == calm.epochs[3].fleet.n_arrived


@pytest.mark.parametrize("policy,n", [("cfs", 88), ("lags", 88), ("cfs", 0),
                                      ("lags", 1)])
def test_migration_cost_policy_asymmetry(policy, n):
    got, want = both(lambda pkg: pkg.fleet.migration_cost_s(
        pkg.fleet.make_policy(policy), n))
    assert got == want
    c_cfs = port_fleet.migration_cost_s(port_fleet.make_policy("cfs"), 88)
    c_lags = port_fleet.migration_cost_s(port_fleet.make_policy("lags"), 88)
    assert c_cfs > 10 * c_lags >= 0.0


def test_chaos_record_and_report(tmp_path):
    def run(pkg):
        out = tmp_path / pkg.fleet.__name__
        res = pkg.fleet.simulate_fleet_chaos(
            "lags", _tiny(pkg, 16, 2),
            pkg.fleet.FaultSchedule.single_crash(0, 1.0, 2),
            duration_s=4.0, epoch_s=1.0, exec_s=0.1, record_dir=str(out))
        return res, pkg.report.summarize(pkg.recorder.load_run(str(out)))
    (res, txt), (ref_res, ref_txt) = both(run)
    same_chaos(res, ref_res)
    assert txt == ref_txt
    assert "failover:" in txt and "node_crash" in txt
    assert str(len(res.migrations)) in txt


@pytest.mark.parametrize("seed", [0, 1, 417, 5000, 10000])
def test_any_schedule_conserves_functions(seed):
    def run(pkg):
        sch = pkg.fleet.FaultSchedule.random(
            seed=seed, n_nodes=2, duration_s=4.0, n_events=3)
        return pkg.fleet.simulate_fleet_chaos(
            "lags", _tiny(pkg, 8, 2), sch, duration_s=4.0, epoch_s=1.0,
            exec_s=0.1, seed=3)
    res, want = both(run)
    same_chaos(res, want)
    for counts in res.per_epoch_counts():
        assert sum(counts) == 8 and all(c >= 0 for c in counts)
    cum = res.cumulative_completions()
    assert all(b >= a for a, b in zip(cum, cum[1:]))
    assert res.n_arrived >= res.n_completed


# --- the torch backend against the JAX backend ------------------------------

TORCH = dict(backend="torch", device="cpu")


def test_torch_empty_schedule_bit_identical_to_torch_simulate_fleet():
    base, ch = _empty(PORT, **TORCH)
    _, ref_ch = _empty(REF, backend="jax")
    assert ch.epochs[0].fleet.backend == "torch"
    same_chaos(ch, ref_ch)
    np.testing.assert_array_equal(base.latencies, ch.latencies)
    same_fleet(ch.epochs[0].fleet, base)


def test_torch_crash_rebalance_equals_jax():
    got, n_victim = _crash(PORT, rebalance=True, **TORCH)
    want, _ = _crash(REF, rebalance=True, backend="jax")
    same_chaos(got, want)
    assert len(got.migrations) == n_victim and got.lost_arrivals == 0


def test_torch_slow_node_equals_jax():
    got = _slow(PORT, **TORCH)
    want = _slow(REF, backend="jax")
    same_chaos(got, want)
    assert any(2 in e.stragglers for e in got.epochs)
