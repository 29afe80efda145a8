"""The port's fleet layer against the reference's.

The batched torch fleet must give the JAX fleet's latencies exactly (the
analogue of ``tests/test_fleet.py``'s per-node contract), a padded batch
must equal each node run alone, and a small consolidation sweep must give
the reference's ``ClusterResult``s.  The copies of the numpy fleet modules
(placement, the numpy backend) must give the reference's results, and the
entry points run on the card unless the caller asks for the CPU.
"""
from dataclasses import asdict

import numpy as np
import pytest
import torch

from repro.core.cluster import simulate_node_share_jax
from repro.fleet import consolidate as ref_consolidate
from repro.fleet import placement as ref_placement
from repro.fleet import simulate as ref_simulate
from repro_torch.core import simkernel_torch as st
from repro_torch.core.cluster import simulate_node_share_torch
from repro_torch.core.traces import make_workload
from repro_torch.fleet import (
    PLACEMENTS,
    consolidation_sweep,
    min_nodes_meeting_slo,
    place,
    simulate_fleet,
)
from repro_torch.sched.torch_backend import CODE_OF

EXACT = ("policy", "n_nodes", "p50", "p95", "thr_slo", "placement",
         "p95_spread", "done_ratio")


def _same_nodes(got, want):
    for g, w in zip(got.nodes, want.nodes):
        np.testing.assert_array_equal(g.latencies, w.latencies)
        np.testing.assert_array_equal(g.fn_of, w.fn_of)
        np.testing.assert_array_equal(g.arrival_of, w.arrival_of)
        assert (g.n_arrived, g.n_completed) == (w.n_arrived, w.n_completed)
        np.testing.assert_allclose(
            [g.busy_time_s, g.switch_time_s],
            [w.busy_time_s, w.switch_time_s], rtol=1e-5)


@pytest.mark.parametrize("policy", ["lags", "cfs"])
def test_torch_fleet_equals_jax_fleet(policy):
    asg = place("round-robin", 11, 2)  # counts (6, 5): uneven, forces padding
    assert list(asg.counts) == [6, 5]
    got = simulate_fleet(policy, asg, duration_s=5.0, backend="torch",
                         device="cpu")
    want = ref_simulate.simulate_fleet(
        policy, ref_placement.place("round-robin", 11, 2), duration_s=5.0,
        backend="jax")
    assert got.backend == "torch" and got.n_completed > 0
    np.testing.assert_array_equal(got.latencies, want.latencies)
    _same_nodes(got, want)


def test_torch_fleet_matches_per_node_runs_exactly():
    """Padding to the common (T, R) and batching must be bit-identical to
    running each node's unpadded trace alone."""
    asg = place("round-robin", 11, 2)
    fleet = simulate_fleet("lags", asg, duration_s=5.0, backend="torch",
                           device="cpu")
    for node, k in zip(fleet.nodes, asg.counts):
        wl = make_workload("azure2021", int(k), duration_s=5.0, n_cores=12,
                           seed=7, exec_s=0.2, threads_per_fn=8)
        trace = st.build_slot_trace(wl, int(k), 8, device="cpu")
        p = st.SimParams(n_cores=12, n_fns=int(k), n_ticks=int(5.0 / st.TICK),
                         policy=CODE_OF["lags"], burst_us=280.0, depth=5.0)
        out = st.simulate(trace, p)
        lat = st.latencies_from(trace, out["done_tick"])
        np.testing.assert_array_equal(np.sort(node.latencies), np.sort(lat))
        assert node.busy_time_s == float(out["busy_s"])
        assert node.switch_time_s == float(out["overhead_s"])


def test_small_consolidation_sweep_equals_jax():
    kw = dict(total_fns=40, node_counts=(4, 3), duration_s=5.0)
    got = consolidation_sweep(backend="torch", device="cpu", **kw)
    want = ref_consolidate.consolidation_sweep(backend="jax", **kw)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        g, w = asdict(g), asdict(w)
        for k in EXACT:
            assert g[k] == w[k], (k, g, w)
        for k in set(g) - set(EXACT):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    for pol in ("cfs", "lags"):
        assert min_nodes_meeting_slo(got, pol) == \
            ref_consolidate.min_nodes_meeting_slo(want, pol)


def test_node_share_torch_equals_jax():
    got = simulate_node_share_torch("lags", 40, 4, duration_s=4.0,
                                    device="cpu")
    want = simulate_node_share_jax("lags", 40, 4, duration_s=4.0)
    np.testing.assert_array_equal(got.latencies, want.latencies)
    np.testing.assert_array_equal(got.fn_of, want.fn_of)
    assert (got.n_arrived, got.n_completed) == (want.n_arrived,
                                                want.n_completed)
    np.testing.assert_allclose(got.switch_time_s, want.switch_time_s,
                               rtol=1e-5)


@pytest.mark.parametrize("name", sorted(PLACEMENTS))
def test_placement_copy_equals_the_reference(name):
    got = place(name, 57, 5)
    want = ref_placement.place(name, 57, 5)
    assert len(got.node_fns) == len(want.node_fns)
    for g, w in zip(got.node_fns, want.node_fns):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got.shares, want.shares)


def test_numpy_fleet_copy_equals_the_reference():
    """The numpy backend (the default) runs the port's copy of the numpy
    engine: float64, the reference's numbers exactly."""
    got = simulate_fleet("lags", place("pack", 24, 3), duration_s=3.0)
    want = ref_simulate.simulate_fleet(
        "lags", ref_placement.place("pack", 24, 3), duration_s=3.0)
    assert got.backend == "numpy"
    for g, w in zip(got.nodes, want.nodes):
        np.testing.assert_array_equal(g.latencies, w.latencies)
        assert (g.switches, g.switch_time_s, g.busy_time_s) == \
            (w.switches, w.switch_time_s, w.busy_time_s)


@pytest.mark.parametrize("backend", ["jax", "tpu"])
def test_unknown_backend_raises(backend):
    with pytest.raises(ValueError, match="unknown backend"):
        simulate_fleet("lags", place("round-robin", 4, 2), duration_s=1.0,
                       backend=backend)


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_card_unless_cpu(no_card):
    wl = make_workload("azure2021", 3, duration_s=1.0, threads_per_fn=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        st.build_slot_trace(wl, 3, 2)
    assert st.build_slot_trace(wl, 3, 2, device="cpu").slot_fn.device.type \
        == "cpu"
    asg = place("round-robin", 4, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_fleet("lags", asg, duration_s=1.0, backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        consolidation_sweep(total_fns=4, node_counts=(2,), duration_s=1.0,
                            backend="torch")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        simulate_node_share_torch("lags", 4, 2, duration_s=1.0)
    # the numpy backend runs on the host whatever the device
    assert simulate_fleet("lags", asg, duration_s=1.0).backend == "numpy"
