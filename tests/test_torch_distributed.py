"""Port parity for the collectives and expert parallelism of
``repro_torch.distributed`` (``grad_compress.compressed_psum``,
``sparse_psum``, ``ep_a2a``) on ``torch.distributed`` with gloo.

At world size 1 each function runs over a one-process gloo group and the
reference runs under a one-device ``shard_map``.  Every case of
tests/test_ep_a2a.py runs through both packages at its tolerances, and
``bucket_by_peer``'s two copied behaviours (data-dependent ownership, the
overflow's last write) are held to the reference's outputs exactly.  At
world size 2 the three functions run in two gloo processes
(``torch.multiprocessing.spawn``, a ``FileStore`` under ``tmp_path``)
against the reference's ``shard_map`` over two host devices, which runs
once in a subprocess (``XLA_FLAGS=--xla_force_host_platform_device_count=2``)
and writes an ``.npz``.
"""
import os
import subprocess
import sys
import time
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro.distributed import ep_a2a as jax_ep
from repro.distributed import grad_compress as jax_gc
from repro.distributed.compat import shard_map
from repro_torch.distributed import ep_a2a, grad_compress
from repro_torch.launch.mesh import make_local_mesh

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120  # the two-process run fails, instead of hanging, past this


@pytest.fixture(scope="module")
def mesh():
    """A (1, 1) gloo mesh of this process, torn down after the module."""
    m = make_local_mesh(1, 1, device="cpu")
    yield m
    dist.destroy_process_group()


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _one_device(fn, jit=False):
    """fn(*args, axis_name) under a one-device shard_map, replicated.

    The collectives run op by op: under ``jax.jit`` XLA multiplies by the
    reciprocal of a constant divisor (``absmax / qmax``), which moves the
    scale by an ulp; the port computes the quotient, as the ops one by one
    do.  The expert dispatch, held to a tolerance, is jitted for time."""
    m = Mesh(np.asarray(jax.devices()[:1]), ("x",))
    f = shard_map(lambda *a: fn(*a, "x"), mesh=m, in_specs=JP(),
                  out_specs=JP(), check_vma=False)
    return jax.jit(f) if jit else f


def _grads(seed):
    rng = np.random.default_rng(seed)
    return {
        "normal": rng.standard_normal((64, 33)).astype(np.float32),
        "wide": (rng.standard_normal((4, 1000)) * 1e3).astype(np.float32),
        "tiny": (rng.standard_normal((257,)) * 1e-20).astype(np.float32),
        "zeros": np.zeros((8, 8), np.float32),
        "ties": np.round(rng.standard_normal((16, 16)) * 4) / 4,
    }


# --- the collectives at world size 1 -----------------------------------------


@pytest.mark.parametrize("kind", ["normal", "wide", "tiny", "zeros", "ties"])
@pytest.mark.parametrize("bits", [8, 4])
def test_compressed_psum_world1_equals_reference(mesh, kind, bits):
    g = _grads(0)[kind].astype(np.float32)
    want = np.asarray(_one_device(
        lambda x, ax: jax_gc.compressed_psum(x, ax, bits=bits))(
            jnp.asarray(g)))
    got = grad_compress.compressed_psum(_t(g), mesh.get_group("data"),
                                        bits=bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # one rank: the collective is the in-step pair
    q, scale = grad_compress.compress(_t(g), bits)
    assert torch.equal(got, grad_compress.decompress(q, scale))


@pytest.mark.parametrize("kind", ["normal", "wide", "tiny"])
@pytest.mark.parametrize("frac", [0.01, 0.1])
def test_sparse_psum_world1_matches_reference(mesh, kind, frac):
    g = _grads(1)[kind]
    want = np.asarray(_one_device(
        lambda x, ax: jax_gc.sparse_psum(x, ax, frac=frac))(jnp.asarray(g)))
    got = grad_compress.sparse_psum(_t(g), mesh.get_group("data"), frac=frac)
    assert got.shape == g.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert int((got != 0).sum()) == max(1, int(g.size * frac))


def test_compressed_psum_casts_the_int32_total_to_int16(monkeypatch):
    """The wire sums int32; the total wraps as the reference's int16 psum
    does past 258 ranks (here a stand-in all-reduce that multiplies the
    payload by 300, as 300 ranks of equal gradients would sum it)."""
    def all_reduce(t, op=None, group=None):
        if t.dtype == torch.int32:
            assert op is None
            t.mul_(300)

    monkeypatch.setattr(dist, "all_reduce", all_reduce)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 300)
    g = torch.tensor([1.0, -1.0, 0.5, 0.0])
    got = grad_compress.compressed_psum(g, None)
    q, scale = grad_compress.compress(g)
    total = q.to(torch.int32) * 300
    want = total.to(torch.int16).float() * scale / torch.tensor(300.0)
    assert torch.equal(got, want)
    assert got[0] < 0  # 38100 wraps to -27436


# --- bucket_by_peer: the reference's behaviours, exactly --------------------


def _bucket_both(x, ids, gate, n_peers, capacity):
    ref = jax.jit(jax_ep.bucket_by_peer, static_argnums=(3, 4))(
        jnp.asarray(x), jnp.asarray(ids), jnp.asarray(gate), n_peers,
        capacity)
    port = ep_a2a.bucket_by_peer(_t(x), _t(ids), _t(gate), n_peers, capacity)
    names = ("send_x", "src", "eid", "gate", "counts")
    for name, r, p in zip(names, ref, port, strict=True):
        r = np.asarray(r)
        assert p.shape == r.shape, name
        np.testing.assert_array_equal(p.numpy(), r, err_msg=name)
    return {n: p.numpy() for n, p in zip(names, port)}


def test_bucket_overflow_wipes_the_last_kept_slot():
    """Six tokens to one peer at capacity 4: the dropped ones write slot 3
    last, so its metadata is (-1, 0, 0) while its row stays."""
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    out = _bucket_both(x, np.zeros((6, 1), np.int32),
                       np.full((6, 1), 0.5, np.float32), 1, 4)
    assert out["src"].tolist() == [[0, 1, 2, -1]]
    assert out["counts"].tolist() == [4]
    assert out["send_x"][0, :, 0].tolist() == [0, 2, 4, 6]
    assert out["eid"].tolist() == [[0, 0, 0, 0]]
    assert out["gate"].tolist() == [[0.5, 0.5, 0.5, 0.0]]


def test_bucket_ownership_follows_the_ids_seen():
    """ids {0, 1, 3, 4} over 2 peers: the divisor is 5 // 2 = 2, id 4 maps
    to peer 2, past the buffer, and is dropped and not counted."""
    x = np.arange(8, dtype=np.float32).reshape(4, 2)
    ids = np.array([[0], [1], [3], [4]], np.int32)
    out = _bucket_both(x, ids, np.full((4, 1), 0.25, np.float32), 2, 4)
    assert out["src"].tolist() == [[0, 1, -1, -1], [2, -1, -1, -1]]
    assert out["eid"].tolist() == [[0, 1, 0, 0], [3, 0, 0, 0]]
    assert out["counts"].tolist() == [2, 1]
    assert not out["send_x"][1, 1:].any()


@pytest.mark.parametrize("seed", range(8))
def test_bucket_by_peer_equals_reference(seed):
    rng = np.random.default_rng(seed)
    T, K, E = rng.integers(1, 24), rng.integers(1, 4), rng.integers(1, 9)
    n_peers, capacity = int(rng.integers(1, 4)), int(rng.integers(1, 12))
    _bucket_both(rng.standard_normal((T, 5)).astype(np.float32),
                 rng.integers(0, E, (T, K)).astype(np.int32),
                 rng.uniform(0.1, 1.0, (T, K)).astype(np.float32),
                 n_peers, capacity)


# --- tests/test_ep_a2a.py through both packages -----------------------------


def _dense_oracle(x, ids, gate, w_gate, w_up, w_down, capacity):
    """tests/test_ep_a2a.py's per-(token, k) loop with a shared capacity."""
    T, K = ids.shape
    y = np.zeros_like(x)
    placed = 0
    for t in range(T):
        for k in range(K):
            e = int(ids[t, k])
            if placed >= capacity:
                continue
            placed += 1
            g = x[t] @ w_gate[e]
            u = x[t] @ w_up[e]
            h = (g / (1 + np.exp(-g))) * u
            y[t] += float(gate[t, k]) * (h @ w_down[e])
    return y


def _ep_inputs(seed, T, K, E, M, F, gate="uniform"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, M)).astype(np.float32)
    ids = rng.integers(0, E, (T, K))
    g = (rng.uniform(0.1, 1.0, (T, K)) if gate == "uniform"
         else np.ones((T, K))).astype(np.float32)
    w = lambda *s: (rng.standard_normal(s) / 10).astype(np.float32)  # noqa: E731
    return x, ids, g, w(E, M, F), w(E, M, F), w(E, F, M)


def _ep_both(args, **kw):
    ref = np.asarray(jax.jit(lambda *a: jax_ep.moe_ep_a2a_local(*a, **kw))(
        *map(jnp.asarray, args)))
    port = ep_a2a.moe_ep_a2a_local(*map(_t, args), **kw)
    assert port.dtype == torch.float32 and port.shape == ref.shape
    return port.numpy(), ref


def test_local_matches_oracle():
    args = _ep_inputs(0, 16, 2, 4, 8, 16)
    cap = 16 * 2  # no drops
    got, ref = _ep_both(args, capacity_factor=1.0)
    want = _dense_oracle(*args, cap)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ref, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("factor", [1.0, 0.5, 0.1])
def test_capacity_drops_are_bounded(factor):
    args = _ep_inputs(1, 32, 2, 4, 8, 16, gate="ones")
    got, ref = _ep_both(args, capacity_factor=factor)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_shard_map_single_device(mesh):
    """The exchange over a one-process gloo group equals the local path,
    and both equal the reference's shard_map over one device."""
    args = _ep_inputs(2, 8, 2, 4, 8, 8)
    local = ep_a2a.moe_ep_a2a_local(*map(_t, args), capacity_factor=2.0)
    grouped = ep_a2a.moe_ep_a2a_local(*map(_t, args),
                                      group=mesh.get_group("model"),
                                      capacity_factor=2.0)
    np.testing.assert_allclose(grouped.numpy(), local.numpy(), rtol=1e-5,
                               atol=1e-5)
    ref = _one_device(lambda *a: jax_ep.moe_ep_a2a_local(
        *a[:-1], axis_name=a[-1], capacity_factor=2.0), jit=True)(
            *map(jnp.asarray, args))
    np.testing.assert_allclose(grouped.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_expert_ffn_matches_reference_gather():
    rng = np.random.default_rng(3)
    xs = rng.standard_normal((40, 8)).astype(np.float32)
    eids = rng.integers(0, 5, 40)
    eids[:7] = 2  # one expert with many rows, others possibly none
    w = lambda *s: (rng.standard_normal(s) / 10).astype(np.float32)  # noqa: E731
    ws = (w(6, 8, 12), w(6, 8, 12), w(6, 12, 8))
    want = np.asarray(jax_ep.expert_ffn(jnp.asarray(xs), jnp.asarray(eids),
                                        *map(jnp.asarray, ws)))
    got = ep_a2a.expert_ffn(_t(xs), _t(eids), *map(_t, ws))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_combine_adds_in_slot_order_in_bf16():
    """A token's gated rows are added in f32 in slot order and rounded once
    to y's dtype, as the reference's bf16 scatter-add adds them on the CPU;
    slots whose source is -1 add nothing."""
    rng = np.random.default_rng(4)
    T, K, M, n = 6, 3, 16, 15
    out = (rng.standard_normal((n, M)) * 40).astype(np.float32)
    src = rng.integers(-1, T, n)
    for t in range(T):  # at most K slots a token, as bucket_by_peer gives
        extra = np.flatnonzero(src == t)[K:]
        src[extra] = -1
    gate = rng.uniform(0.1, 1.0, n).astype(np.float32)
    ob = jnp.asarray(out, jnp.bfloat16)
    ok = src >= 0
    with warnings.catch_warnings():  # the reference's f32 values, bf16 y
        warnings.simplefilter("ignore", FutureWarning)
        want = jnp.zeros((T, M), jnp.bfloat16).at[np.where(ok, src, 0)].add(
            jnp.where(ok[:, None], ob * jnp.asarray(gate)[:, None], 0.0))
    got = ep_a2a._combine(_t(out).to(torch.bfloat16), _t(src), _t(gate), T,
                          K, torch.bfloat16)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


# --- world size 2: two gloo processes against shard_map on two devices ------


REF_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.distributed import ep_a2a, grad_compress
from repro.distributed.compat import shard_map

inp = dict(np.load(sys.argv[1]))
assert len(jax.devices()) == 2
mesh = Mesh(np.asarray(jax.devices()), ("x",))
sm = lambda f, n: shard_map(f, mesh=mesh, in_specs=(P("x"),) * n,
                            out_specs=P("x"), check_vma=False)
out = {}
g = jnp.asarray(inp["g"]).reshape(-1, *inp["g"].shape[2:])
# op by op, as tests/test_torch_distributed.py::_one_device says
out["cpsum"] = sm(lambda a: grad_compress.compressed_psum(a, "x"), 1)(g)
out["spsum"] = sm(lambda a: grad_compress.sparse_psum(a, "x", frac=0.05), 1)(g)
for case in ("even", "drops", "owners"):
    a = [jnp.asarray(inp[f"{case}_{k}"]) for k in
         ("x", "ids", "gate", "wg", "wu", "wd")]
    a = [v.reshape(-1, *v.shape[2:]) for v in a]
    cf = float(inp[f"{case}_cf"])
    out[f"ep_{case}"] = jax.jit(sm(lambda *b: ep_a2a.moe_ep_a2a_local(
        *b, axis_name="x", capacity_factor=cf), 6))(*a)
np.savez(sys.argv[2], **{k: np.asarray(v) for k, v in out.items()})
"""


def _world2_inputs():
    """Per-rank inputs, rank on the leading axis."""
    rng = np.random.default_rng(7)
    inp = {"g": rng.standard_normal((2, 16, 24)).astype(np.float32)}
    T, K, E, M, F = 16, 2, 4, 8, 16
    for case, cf in (("even", 2.0), ("drops", 0.5), ("owners", 2.0)):
        ids = rng.integers(0, E, (2, T, K))
        ids[:, 0, 0] = E - 1  # every rank sees the top id: block ownership
        if case == "owners":  # rank 1 sees ids < 3: its divisor is 1
            ids[1] = rng.integers(0, 3, (T, K))
        inp.update({
            f"{case}_x": rng.standard_normal((2, T, M)).astype(np.float32),
            f"{case}_ids": ids.astype(np.int32),
            f"{case}_gate": rng.uniform(0.1, 1, (2, T, K)).astype(np.float32),
            f"{case}_wg": (rng.standard_normal((2, E // 2, M, F)) * 0.1
                           ).astype(np.float32),
            f"{case}_wu": (rng.standard_normal((2, E // 2, M, F)) * 0.1
                           ).astype(np.float32),
            f"{case}_wd": (rng.standard_normal((2, E // 2, F, M)) * 0.1
                           ).astype(np.float32),
            f"{case}_cf": np.float64(cf)})
    return inp


def _rank_main(rank, store_path, inp_path, out_dir):
    """One of the two gloo ranks: the three functions on its inputs."""
    dist.init_process_group("gloo", store=dist.FileStore(store_path, 2),
                            rank=rank, world_size=2)
    try:
        m = make_local_mesh(1, 2, device="cpu")
        grp = m.get_group("model")
        inp = dict(np.load(inp_path))
        g = torch.from_numpy(inp["g"][rank])
        out = {"cpsum": grad_compress.compressed_psum(g, grp).numpy(),
               "spsum": grad_compress.sparse_psum(g, grp, frac=0.05).numpy()}
        for case in ("even", "drops", "owners"):
            a = [torch.from_numpy(inp[f"{case}_{k}"][rank]) for k in
                 ("x", "ids", "gate", "wg", "wu", "wd")]
            out[f"ep_{case}"] = ep_a2a.moe_ep_a2a_local(
                *a, group=grp, capacity_factor=float(inp[f"{case}_cf"])
            ).numpy()
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()


def test_world2_gloo_equals_shard_map_on_two_devices(tmp_path):
    inp = _world2_inputs()
    inp_path = tmp_path / "inputs.npz"
    np.savez(inp_path, **inp)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    ref_proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(inp_path),
         str(tmp_path / "ref.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ctx = mp.spawn(_rank_main, args=(str(tmp_path / "store"),
                                         str(inp_path), str(tmp_path)),
                       nprocs=2, join=False)
        deadline = time.monotonic() + JOIN_S
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the two gloo ranks did not end in {JOIN_S} s")
        ref_out, _ = ref_proc.communicate(timeout=JOIN_S)
    finally:
        ref_proc.kill()
    assert ref_proc.returncode == 0, ref_out[-3000:]
    ref = np.load(tmp_path / "ref.npz")
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in range(2)]
    for key in ("cpsum", "spsum", "ep_even", "ep_drops", "ep_owners"):
        want = ref[key].reshape(2, -1, *ref[key].shape[1:])
        for r in range(2):
            got = ranks[r][key]
            assert got.shape == want[r].shape, key
            if key == "cpsum":
                np.testing.assert_array_equal(got, want[r], err_msg=key)
            else:
                tol = 1e-6 if key == "spsum" else 1e-5
                np.testing.assert_allclose(got, want[r], rtol=tol, atol=tol,
                                           err_msg=f"{key} rank {r}")
    # each rank's all-reduced mean is the same
    np.testing.assert_array_equal(ranks[0]["cpsum"], ranks[1]["cpsum"])
