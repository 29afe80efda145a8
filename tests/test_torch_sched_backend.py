"""The port's torch policy backend against the reference's JAX backend.

Randomized cases on the coarse 1/16 grid of ``tests/test_sched_backends.py``
(a power-of-two group count keeps every primary key and the EEVDF runnable
mean exact in f32), for all seven policy codes: the keys must be equal bit
for bit (EEVDF's within one ulp: its runnable mean is an f32 sum whose
order may differ), and the picked sets, the sticky masks and the voluntary
switch costs identical.  Each case also runs as one batch of nodes, which
must equal the node-by-node results.
"""
from dataclasses import asdict
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sched import jax_backend as jb
from repro.sched import numpy_backend as nb
from repro.sched import protocol
from repro_torch.sched import numpy_backend as tnb
from repro_torch.sched import torch_backend as tb

CODES = sorted(tb.NAME_OF)
N_SEEDS = 5


def _random_case(rng, policy):
    """The generator of tests/test_sched_backends.py::_random_case."""
    G = 4  # power of two: the EEVDF runnable mean stays grid-exact
    T = int(rng.integers(6, 13))
    ent_group = rng.integers(0, G, T)
    grid = lambda n: rng.choice(np.arange(128), size=n, replace=False) / 16.0  # noqa: E731
    group_vrt = grid(G)
    group_credit = grid(G)
    last_pick = rng.permutation(T).astype(np.float64)
    runnable = rng.random(T) < 0.8
    if not runnable.any():
        runnable[int(rng.integers(0, T))] = True
    group_runnable = np.zeros(G, bool)
    group_runnable[np.unique(ent_group[runnable])] = True
    is_rt = np.zeros(G, bool)
    if policy == "lags-static":
        is_rt[int(rng.integers(0, G))] = True
    k = int(rng.integers(1, 5))
    return dict(ent_group=ent_group, group_vrt=group_vrt,
                group_credit=group_credit, last_pick=last_pick,
                runnable=runnable, group_runnable=group_runnable,
                is_rt=is_rt, k=k)


def _views(c, slice_ticks):
    jview = jb.PolicyView(
        ent_group=jnp.asarray(c["ent_group"], jnp.int32),
        group_vrt=jnp.asarray(c["group_vrt"], jnp.float32),
        group_credit=jnp.asarray(c["group_credit"], jnp.float32),
        last_pick_tick=jnp.asarray(c["last_pick"], jnp.float32),
        runnable=jnp.asarray(c["runnable"]),
        group_runnable=jnp.asarray(c["group_runnable"]),
        is_rt_group=jnp.asarray(c["is_rt"]),
        tick_sec=0.004, slice_ticks=slice_ticks,
    )
    tview = tb.PolicyView(
        ent_group=torch.as_tensor(c["ent_group"], dtype=torch.int64),
        group_vrt=torch.as_tensor(c["group_vrt"], dtype=torch.float32),
        group_credit=torch.as_tensor(c["group_credit"], dtype=torch.float32),
        last_pick_tick=torch.as_tensor(c["last_pick"], dtype=torch.float32),
        runnable=torch.as_tensor(c["runnable"]),
        group_runnable=torch.as_tensor(c["group_runnable"]),
        is_rt_group=torch.as_tensor(c["is_rt"]),
        tick_sec=0.004, slice_ticks=slice_ticks,
    )
    return jview, tview


def _stack(views):
    """Node views of one T stacked along a leading node dimension."""
    return tb.PolicyView(*(
        torch.stack(xs) if isinstance(xs[0], torch.Tensor) else xs[0]
        for xs in zip(*views)))


def _cases(code, n=N_SEEDS):
    name = tb.NAME_OF[code]
    for seed in range(n):
        rng = np.random.default_rng(1000 * seed + 17 * code)
        yield rng, _random_case(rng, name)


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_codes_equal_the_reference():
    assert tb.CODE_OF == jb.CODE_OF and tb.NAME_OF == jb.NAME_OF
    for code in CODES:
        assert asdict(tb.spec_of(code)) == asdict(jb.spec_of(code))
    with pytest.raises(ValueError, match="unknown policy code"):
        tb.key_fn(7)


@pytest.mark.parametrize("code", CODES, ids=lambda c: tb.NAME_OF[c])
def test_primary_keys_and_picks_equal_jax(code):
    spec = tb.spec_of(code)
    for seed, (_, c) in enumerate(_cases(code)):
        jview, tview = _views(c, spec.slice_ticks)
        key_jx = np.asarray(jb.primary_key(code, jview))
        key_t = tb.key_fn(code)(tview).numpy()
        assert key_t.dtype == np.float32
        if code in (tb.EEVDF, tb.EEVDF_TUNED):
            assert _ulps(key_t, key_jx).max() <= 1, (seed, key_t, key_jx)
        else:
            np.testing.assert_array_equal(key_t, key_jx)
        picks_jx = nb.pick_k(key_jx.astype(np.float64), c["runnable"], c["k"])
        picks_t = tnb.pick_k(key_t.astype(np.float64), c["runnable"], c["k"])
        assert picks_t.tolist() == picks_jx.tolist(), (seed, picks_t, picks_jx)
        # the protocol's float64 key (numpy backend) admits the same set
        nview = nb.EntityView(
            ent_group=c["ent_group"], group_vrt=c["group_vrt"],
            group_credit=c["group_credit"], last_pick_tick=c["last_pick"],
            runnable=c["runnable"], group_runnable=c["group_runnable"],
            is_rt_group=c["is_rt"], tick_sec=0.004,
            slice_ticks=spec.slice_ticks)
        picks_np = nb.pick_k(nb.primary_key(spec, nview), c["runnable"],
                             c["k"])
        assert picks_t.tolist() == picks_np.tolist()


@pytest.mark.parametrize("code", CODES, ids=lambda c: tb.NAME_OF[c])
def test_sticky_mask_equals_jax(code):
    """Random slice holders on the grid cases: the slices kept (LAGS:
    credit preemption; LAGS-static: RT wakeups) are the reference's."""
    spec = tb.spec_of(code)
    fired = set()
    for seed, (rng, c) in enumerate(_cases(code, n=3 * N_SEEDS)):
        continuing = c["runnable"] & (rng.random(len(c["runnable"])) < 0.5)
        jview, tview = _views(c, spec.slice_ticks)
        want = np.asarray(jb.sticky_mask(code, jview, jnp.asarray(continuing)))
        got = tb.sticky_mask(code, tview, torch.as_tensor(continuing)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"seed {seed}")
        fired.add(bool((continuing & ~got).any()))
    if code in (tb.LAGS, tb.LAGS_STATIC):
        assert fired == {True, False}  # both outcomes exercised


def test_lags_slice_break_is_the_protocol_preemption_rule():
    """The cases of tests/test_sched_backends.py's preemption test: the
    running slot's slice breaks iff ``protocol.credit_preempt`` fires."""
    rng = np.random.default_rng(42)
    fired = set()
    for _ in range(25):
        G = int(rng.integers(2, 7))
        credit = rng.choice(np.arange(64), size=G, replace=False) / 16.0
        run_g = int(rng.integers(0, G))
        waiting = [g for g in range(G) if g != run_g]
        expect = protocol.credit_preempt(
            float(credit[waiting].min()), float(credit[run_g]), 1.0)
        fired.add(expect)
        continuing = torch.zeros(G, dtype=torch.bool)
        continuing[run_g] = True
        view = tb.PolicyView(
            ent_group=torch.arange(G), group_vrt=torch.zeros(G),
            group_credit=torch.as_tensor(credit, dtype=torch.float32),
            last_pick_tick=torch.zeros(G), runnable=torch.ones(G, dtype=bool),
            group_runnable=torch.ones(G, dtype=bool),
            is_rt_group=torch.zeros(G, dtype=bool),
            tick_sec=0.004, slice_ticks=25)
        sticky = tb.sticky_mask(tb.LAGS, view, continuing)
        assert bool(~sticky[run_g]) == expect
    assert fired == {True, False}


@pytest.mark.parametrize("code", CODES, ids=lambda c: tb.NAME_OF[c])
def test_voluntary_switch_equals_jax(code):
    rng = np.random.default_rng(code)
    C = 64
    f = lambda *s: rng.uniform(1.0, 30.0, s).astype(np.float32)  # noqa: E731
    c_same, c_cross = f(C), f(C)
    p_same = rng.uniform(0, 1, C).astype(np.float32)
    cost_cfs = (p_same * c_same + (1 - p_same) * c_cross).astype(np.float32)
    run_credit = (rng.integers(0, 8, C) / 16.0).astype(np.float32)
    wait_cmin = np.float32(2 / 16.0)
    sibs = rng.integers(0, 4, C).astype(np.float32)
    p_pre = np.float32(rng.uniform(0, 1, (1,)))
    args = dict(c_same=c_same, c_cross=c_cross, cost_cfs=cost_cfs,
                run_credit=run_credit, wait_cmin=wait_cmin, sibs=sibs,
                p_preempt=p_pre)
    # jitted, as the simulator runs it: XLA fuses 1 + 0.85 * p into an FMA
    cost_j, spb_j = jax.jit(partial(jb.voluntary_switch, code))(
        **{k: jnp.asarray(v) for k, v in args.items()})
    cost_t, spb_t = tb.voluntary_switch(
        code, **{k: torch.as_tensor(v) for k, v in args.items()})
    np.testing.assert_array_equal(cost_t.numpy(), np.asarray(cost_j))
    np.testing.assert_array_equal(np.float32(spb_t), np.float32(spb_j))
    if code in (tb.LAGS, tb.LAGS_STATIC):  # all three cost branches taken
        assert (cost_t == 0).any() and (cost_t != torch.as_tensor(cost_cfs)).any()


@pytest.mark.parametrize("code", CODES, ids=lambda c: tb.NAME_OF[c])
def test_batched_view_equals_node_by_node(code):
    """A view with a leading node dimension gives each node's own keys and
    sticky masks: the reductions (EEVDF's mean, LAGS's waiting minimum,
    LAGS-static's RT wakeup) are taken per node."""
    spec = tb.spec_of(code)
    rng = np.random.default_rng(5 + code)
    nodes = [_random_case(rng, tb.NAME_OF[code]) for _ in range(3)]
    T = min(len(c["runnable"]) for c in nodes)
    for c in nodes:  # cut every node to a common T
        for k in ("ent_group", "last_pick", "runnable"):
            c[k] = c[k][:T]
    views = [_views(c, spec.slice_ticks)[1] for c in nodes]
    conts = [torch.as_tensor(c["runnable"] & (rng.random(T) < 0.5))
             for c in nodes]
    batch = _stack(views)
    keys = tb.primary_key(code, batch)
    sticky = tb.sticky_mask(code, batch, torch.stack(conts))
    for i, (v, cont) in enumerate(zip(views, conts)):
        torch.testing.assert_close(keys[i], tb.primary_key(code, v),
                                   rtol=0, atol=0)
        assert torch.equal(sticky[i], tb.sticky_mask(code, v, cont))
