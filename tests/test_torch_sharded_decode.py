"""The decode merge over split cache rows, sharded MoE groups, and what
does not run sharded.

* ``decode_attention_plain``'s log-sum-exp against a float64 softmax, empty
  ranges (-inf) included; a (B, H, L) case split into 2 and 3 row ranges,
  some of them empty for some rows, merges (``models/attention.py::
  merge_partials``, which the sharded decode runs over the ranks) to the
  unsplit result at ``TOL[float32]`` (tests/test_kernels.py).
* In a gloo world of 2 processes on a (1, 2) mesh:
  ``init_params(..., mesh=)``, which places each leaf as it is drawn,
  equals ``shard_params`` of the whole draw;
  ``constrain`` raises for a plain tensor; and the kernel wrappers refuse
  DTensors split over a dimension the kernel does not treat independently
  (the sequence, the cache rows), split unlike each other, or mixed with
  plain tensors, instead of gathering them.
* In the same world on a (2, 1) mesh, each rank holding one batch row: the
  reduced qwen2-moe's MoE layer with groups of 4 tokens over prompts of 6,
  so that the middle group crosses the two ranks' rows, and a decode
  token under ``DECODE_RULES``, whose FFN width lies on "data" with the
  batch: sharded ``moe`` equals the unsharded one (which
  tests/test_torch_moe.py holds to the reference, groups spanning rows
  included), output and aux loss; and none of its collectives runs over
  the one-rank "model" axis.
"""
import json
import math
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.kernels import decode_attention as dec
from repro_torch.models.attention import merge_partials

TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py TOL[float32]
JOIN_S = 120


def _inputs(seed, B, H, Hkv, L, D):
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    return n(B, H, D), n(B, Hkv, L, D), n(B, Hkv, L, D)


@pytest.mark.parametrize("B,H,Hkv,L,D,kv_len,kv_start", [
    (2, 4, 4, 16, 8, [16, 5], None),
    (3, 8, 2, 40, 16, [40, 0, 1], [0, 0, 0]),
    (4, 16, 1, 33, 32, [33, 20, 7, 2], [0, 4, 7, 3]),
])
def test_decode_lse_equals_float64_softmax(B, H, Hkv, L, D, kv_len,
                                           kv_start):
    q, k, v = _inputs(0, B, H, Hkv, L, D)
    kl = torch.tensor(kv_len, dtype=torch.int32)
    ks = None if kv_start is None else torch.tensor(kv_start,
                                                    dtype=torch.int32)
    out, lse = dec.decode_attention(q, k, v, kl, kv_start=ks, with_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, H)
    G = H // Hkv
    s = torch.einsum("bhgd,bhld->bhgl", q.double().reshape(B, Hkv, G, D),
                     k.double()) / math.sqrt(D)
    rows = torch.arange(L)
    start = torch.zeros(B, dtype=torch.long) if ks is None else ks.long()
    valid = (rows[None] < kl[:, None]) & (rows[None] >= start[:, None])
    s = s.masked_fill(~valid[:, None, None], -math.inf)
    want = torch.logsumexp(s, dim=-1).reshape(B, H)
    torch.testing.assert_close(lse.double(), want, **TOL)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    o = torch.einsum("bhgl,bhld->bhgd", p, v.double()).reshape(B, H, D)
    torch.testing.assert_close(out.double(), o, **TOL)
    empty = ~valid.any(-1)
    assert torch.isneginf(lse[empty]).all() and (out[empty] == 0).all()


@pytest.mark.parametrize("cuts", [(0, 20, 40), (0, 7, 30, 40)],
                         ids=["two", "three"])
def test_split_rows_merge_to_the_unsplit_result(cuts):
    """Rows [kv_start, kv_len) of a 40-row cache, attended in row ranges
    whose kv_len and kv_start are shifted by the range's first row and
    clamped, as each rank of a sequence-split cache attends: row 2 has an
    empty range in both splits, row 1 in the three-way one."""
    B, H, Hkv, L, D = 3, 8, 2, 40, 16
    q, k, v = _inputs(1, B, H, Hkv, L, D)
    kv_len = torch.tensor([40, 17, 9], dtype=torch.int32)
    kv_start = torch.tensor([0, 5, 0], dtype=torch.int32)
    want = dec.decode_attention(q, k, v, kv_len, kv_start=kv_start)
    outs, lses = [], []
    for a, b in zip(cuts[:-1], cuts[1:]):
        o, lse = dec.decode_attention(
            q, k[:, :, a:b], v[:, :, a:b], (kv_len - a).clamp(0, b - a),
            kv_start=(kv_start - a).clamp(0, b - a), with_lse=True)
        outs.append(o)
        lses.append(lse)
    assert any(torch.isneginf(x).any() for x in lses)  # an empty range
    torch.testing.assert_close(merge_partials(outs, lses), want, **TOL)


# --- what does not run sharded: a world of two gloo ranks -------------------


def _raises(fn):
    """The type and message of what fn raises, or None."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - recorded for the test to judge
        return [type(e).__name__, str(e)]
    return None


def _moe_groups_across_ranks():
    """{case: [max |y - unsharded y|, max |unsharded y|, |aux - unsharded
    aux|]} of the reduced
    qwen2-moe's first MoE layer on a (2, 1) mesh: prefill under
    TRAIN_RULES with groups of 4 over (2, 6) tokens, and decode under
    DECODE_RULES."""
    from repro_torch.configs.base import get_config, reduced
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import (init_params, param_specs,
                                           spec_to_pspecs)

    mesh = make_local_mesh(2, 1, device="cpu")
    cfg = reduced(get_config("qwen2-moe-a2.7b"))
    layer = next(i for i, p in enumerate(param_specs(cfg)["layers"])
                 if "moe" in p)
    params = init_params(cfg, torch.Generator().manual_seed(0),
                         device="cpu")["layers"][layer]["moe"]
    gen = torch.Generator().manual_seed(1)
    out = {}
    for case, rules, S, gs in (("prefill", sh.TRAIN_RULES, 6, 4),
                               ("decode", sh.DECODE_RULES, 1, 256)):
        x = torch.randn(2, S, cfg.d_model, generator=gen)
        want, want_aux = moe.moe(params, x, cfg, group_size=gs)
        with sh.sharding_ctx(mesh, rules):
            p = sh.distribute(params, spec_to_pspecs(
                param_specs(cfg)["layers"][layer]["moe"], rules=rules,
                mesh=mesh), mesh)
            xd = sh.distribute(x, sh.to_pspec(("batch", "seq_sp", None),
                                              shape=tuple(x.shape)), mesh)
            y, aux = moe.moe(p, xd, cfg, group_size=gs)
            y = sh.full(y)
        out[case] = [float((y - want).abs().max()),
                     float(want.abs().max()), float(abs(aux - want_aux))]
    return out


def _rank_checks(rank, store, out_dir):
    torch.set_num_threads(1)  # beside the other test workers' processes
    dist.init_process_group("gloo", store=dist.FileStore(store, 2),
                            rank=rank, world_size=2)
    try:
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)

        from repro_torch.configs.base import get_config, reduced
        from repro_torch.distributed import sharding as sh
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import ssm_scan as ssm
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models.params import init_params, shard_params
        from repro_torch.train.tree import leaves

        mesh = make_local_mesh(1, 2, device="cpu")
        res = {}
        cfg = reduced(get_config("jamba-v0.1-52b"))
        drawn = init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu", mesh=mesh, rules=sh.TRAIN_RULES)
        placed = shard_params(cfg, init_params(
            cfg, torch.Generator().manual_seed(0), device="cpu"), mesh,
            sh.TRAIN_RULES)
        res["init_on_mesh"] = [
            [str(a.placements), str(b.placements),
             bool(torch.equal(a.to_local(), b.to_local()))]
            for a, b in zip(leaves(drawn), leaves(placed), strict=True)]
        # the collectives the MoE check issues on its (2, 1) mesh, by the
        # size of their group: none may run over the one-rank "model" axis
        sizes = []
        originals = {n: getattr(dist, n) for n in (
            "all_gather_into_tensor", "all_reduce", "reduce_scatter_tensor")}

        def counted(fn):
            def call(*a, **kw):
                sizes.append(dist.get_world_size(kw.get("group")))
                return fn(*a, **kw)
            return call

        for n, fn in originals.items():
            setattr(dist, n, counted(fn))
        try:
            res["moe"] = _moe_groups_across_ranks()
        finally:
            for n, fn in originals.items():
                setattr(dist, n, fn)
        res["group_sizes"] = sizes
        with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
            res["constrain"] = _raises(lambda: sh.constrain(
                torch.ones(4, 4), "batch", None))
        rep, model_ax = [Replicate(), Replicate()], lambda p: [Replicate(), p]
        d = lambda t, pl: distribute_tensor(t, mesh, pl)  # noqa: E731
        torch.manual_seed(0)  # every rank the same full tensors
        q = torch.randn(2, 4, 8, 16)
        k = torch.randn(2, 2, 8, 16)
        res["fa_seq"] = _raises(lambda: fa.flash_attention(
            d(q, model_ax(Shard(2))), d(k, model_ax(Shard(2))),
            d(k, model_ax(Shard(2)))))
        res["fa_unlike"] = _raises(lambda: fa.flash_attention(
            d(q, model_ax(Shard(1))), d(k, rep), d(k, rep)))
        res["fa_mixed"] = _raises(lambda: fa.flash_attention(
            d(q, model_ax(Shard(1))), k, k))
        out = fa.flash_attention(d(q, model_ax(Shard(1))),
                                 d(k, model_ax(Shard(1))),
                                 d(k, model_ax(Shard(1))))
        res["fa_heads"] = [str(out.placements), float(
            (out.full_tensor() - fa.flash_attention_plain(q, k, k)).abs()
            .max())]
        kv_len = torch.tensor([8, 3], dtype=torch.int32)
        res["dec_rows"] = _raises(lambda: dec.decode_attention(
            d(q[:, :, 0], rep), d(k, model_ax(Shard(2))),
            d(k, model_ax(Shard(2))), d(kv_len, rep)))
        dA = torch.rand(2, 8, 16, 4)
        C, h0 = torch.randn(2, 8, 4), torch.zeros(2, 16, 4)
        res["ssm_seq"] = _raises(lambda: ssm.ssm_scan(
            d(dA, model_ax(Shard(1))), d(dA, model_ax(Shard(1))),
            d(C, model_ax(Shard(1))), d(h0, rep)))
        y, h = ssm.ssm_scan(d(dA, model_ax(Shard(2))),
                            d(dA, model_ax(Shard(2))), d(C, rep),
                            d(h0, model_ax(Shard(1))))
        wy, wh = ssm.ssm_scan_plain(dA, dA, C, h0)
        res["ssm_inner"] = [str(y.placements), str(h.placements), float(
            (y.full_tensor() - wy).abs().max()), float(
            (h.full_tensor() - wh).abs().max())]
        with open(os.path.join(out_dir, f"checks{rank}.json"), "w") as fh:
            json.dump(res, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def checks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_checks")
    ctx = mp.spawn(_rank_checks, args=(str(tmp / "store"), str(tmp)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the two gloo ranks did not end in {JOIN_S} s")
    return [json.loads((tmp / f"checks{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("case", ["prefill", "decode"])
def test_sharded_moe_equals_unsharded_with_groups_across_ranks(checks, case):
    for res in checks:
        # the width's partial sums add in another order: a few ulps
        y_err, scale, aux_err = res["moe"][case]
        assert y_err <= 1e-6 * scale and aux_err <= 1e-6, res["moe"]


def test_init_params_on_a_mesh_equals_shard_params(checks):
    """Drawing each leaf and placing it at once gives ``shard_params`` of
    the whole draw: the same placements, and the same values on each rank
    (the reduced jamba: attention, Mamba, MoE and dense leaves)."""
    for res in checks:
        assert len(res["init_on_mesh"]) > 100
        assert any("Shard" in a for a, _, _ in res["init_on_mesh"])
        for a, b, same in res["init_on_mesh"]:
            assert a == b and same


def test_no_collective_runs_over_a_one_rank_axis(checks):
    """``redistribute`` moves nothing over a mesh axis of one rank (with
    gloo a collective of a CUDA tensor crosses the host even there)."""
    for res in checks:
        assert res["group_sizes"] and set(res["group_sizes"]) == {2}


def test_constrain_raises_for_a_plain_tensor_on_two_ranks(checks):
    for res in checks:
        kind, msg = res["constrain"]
        assert kind == "NotImplementedError" and "several devices" in msg


@pytest.mark.parametrize("case,kind", [
    ("fa_seq", "NotImplementedError"), ("fa_unlike", "NotImplementedError"),
    ("fa_mixed", "ValueError"), ("dec_rows", "NotImplementedError"),
    ("ssm_seq", "NotImplementedError")])
def test_wrappers_refuse_placements_they_cannot_run_on_shards(checks, case,
                                                              kind):
    for res in checks:
        assert res[case][0] == kind, res[case]


def test_wrappers_run_on_head_and_channel_shards(checks):
    for res in checks:
        placements, err = res["fa_heads"]
        assert placements == "(Replicate(), Shard(dim=1))" and err < 1e-6
        y_pl, h_pl, y_err, h_err = res["ssm_inner"]
        assert y_pl == "(Replicate(), Shard(dim=2))"
        assert h_pl == "(Replicate(), Shard(dim=1))"
        assert y_err < 1e-6 and h_err < 1e-6
