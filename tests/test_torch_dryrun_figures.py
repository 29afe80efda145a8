"""The dry run's executed figures: ``repro_torch.launch.dryrun.execute``
runs a cell's sharded step as rank 0 of a fake process group on meta
DTensors, the kernels on their shape-only routes (``kernels/_meta.py``),
and ``launch/workcount.py`` counts FLOPs, bytes, temporaries and the
collectives ``distributed/sharding.py`` records.

Reduced configs on the small meshes of ``tests/torch_sharded_world.py``,
the cells in one child process (``world.fake_cells``: the fake group is
the child's default group, and this worker may hold another):

* each meta route runs on exactly the local shapes that the live gloo
  worlds' ranks run the kernels on (``world.kernel_shapes``,
  ``world.train_kernel_shapes``), under the card's f32 routes;
* DTensors moved by hand record one collective each, with the wire bytes
  of the reference's formula (``repro.launch.hlo_analysis`` on the same
  collectives' HLO);
* rank 0's FLOPs of the reduced dense prefill on (2, 1) are world 1's
  halved, exactly;
* a hand-written function's peak temporaries, exactly, and a train
  cell's above 0;
* the pointwise ops' fast path gives the meta kernels' shapes, dtypes and
  strides;
* a microbatch whose rows do not split over every batch axis (jamba's
  16 microbatches of 2 rows on (2, 2, 1)) splits over "pod" alone, one
  row a device, in the port's executed step as in the reference's
  compiled one;
* each kernel's ``cost`` through ``chip_smoke.bound_ms`` gives the bounds
  PERF.md's kernel table records;
* the reduced qwen3-8b prefill and train cells on (1, 2) and (2, 2)
  against the reference's compiled cells (a JAX child on four host
  devices doing ``repro.launch.dryrun.run_cell``'s compile): the wire
  bytes by kind side by side, their totals within a factor of 4; and the
  collectives of the embedding's lookup and of its transpose one by one,
  kind and result, the port's (``sharding.labelled("lookup")``) against
  those the reference's HLO attributes to ``jnp.take``.
"""
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

import torch_sharded_world as world
from repro.launch import hlo_analysis as ref_hlo
from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ssm
from repro_torch.launch import workcount

# config, overrides of ``reduced``
KERNEL_CASES = {"qwen3-G2": ("qwen3-8b", {"n_kv_heads": 2}),
                "falcon-mamba": ("falcon-mamba-7b", {}),
                "qwen2-moe": ("qwen2-moe-a2.7b", {}),
                "jamba": ("jamba-v0.1-52b", {})}
KERNEL_MESHES = ((2, 2), (1, 3))
REF_MESHES = ((1, 2), (2, 2))
STEPS = ("prefill", "decode", "train")
# the card's kernels for f32, the reduced configs' dtype, by step
F32_KERNELS = {"prefill": {"fa_fwd", "ssm_fwd<false>"},
               "decode": {"dec_split"},
               "train": {"fa_fwd", "fa_bwd_f32", "ssm_fwd<true>",
                         "ssm_bwd_tma + ssm_bwd_dc"}}


def _batch(step):
    return world.TRAIN_B if step == "train" else world.B


def _cells() -> dict:
    cells = {}
    for case, (name, ov) in KERNEL_CASES.items():
        for mesh in KERNEL_MESHES:
            for step in STEPS:
                cells[f"{case}/{world.tag(mesh)}/{step}"] = (
                    name, ov, step, world.S, _batch(step), list(mesh))
    name, ov = KERNEL_CASES["qwen3-G2"]
    for mesh in ((1, 1), (2, 1)):
        cells[f"flops/{world.tag(mesh)}"] = (name, ov, "prefill", world.S,
                                             world.B, list(mesh))
    for mesh in REF_MESHES:
        for step in ("prefill", "train"):
            key = f"qwen3-G2/{world.tag(mesh)}/{step}"
            cells.setdefault(key, (name, ov, step, world.S, _batch(step),
                                   list(mesh)))
    cells["pod"] = POD_CELL
    return cells


REF_SCRIPT = r"""
import json, re, sys
import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.distributed.sharding import sharding_ctx
from repro.launch.hlo_analysis import collective_stats_attributed
from repro.launch.specs import build_lowerable
out = {}
for key, (name, ov, step, S, B, shape) in json.loads(sys.argv[1]).items():
    cfg = reduced(get_config(name), **ov)
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(
        shape), ("pod", "data", "model")[-len(shape):])
    low = build_lowerable(cfg, ShapeConfig(step, S, B, step), mesh)
    to_ns = lambda tree: jax.tree_util.tree_map(
        lambda ps: NamedSharding(mesh, ps), tree,
        is_leaf=lambda x: isinstance(x, PartitionSpec))
    with mesh, sharding_ctx(mesh, low.rules):
        compiled = jax.jit(low.fn, in_shardings=to_ns(low.in_shardings),
                           out_shardings=to_ns(low.out_shardings),
                           donate_argnums=low.donate_argnums).lower(
            *low.args_sds).compile()
    text = compiled.as_text()
    # the collectives of the embedding's lookup (jnp.take) and of its
    # transpose, kind and result (an all-to-all's a tuple), without layouts
    lookup = re.findall(r"= (\([^)]*\)|\S+) (all-gather|all-reduce|"
                        r"reduce-scatter|all-to-all|collective-permute)"
                        r"(?:-start)?\(.*op_name=\"[^\"]*_take", text)
    # the rows a device of each layer's query projection (B, S, H, D)
    rows = re.findall(r"= f32\[(\d+),\d+,\d+,\d+\][{][^}]*[}] [a-z-]+\(.*"
                      r"op_name=\"[^\"]*bsm,mhd->bshd/dot_general", text)
    cost = compiled.cost_analysis()
    cost = cost[0] if isinstance(cost, (list, tuple)) else cost
    out[key] = dict(collective_stats_attributed(text),
                    lookup=[k + " " + re.sub(r"[{][^}]*[}]", "", t)
                            for t, k in lookup],
                    rows=sorted({int(r) for r in rows}),
                    flops=float(cost.get("flops", 0.0)))
print(json.dumps(out))
"""


# jamba under its own name, so that its train step takes the reference's
# 16 microbatches (``TRAIN_ACCUM``), of 2 rows a microbatch on a ("pod",
# "data", "model") mesh of (2, 2, 1), whose batch axes have 4 ranks: the
# rows split over "pod" alone, as train_4k's 16 rows a microbatch do over
# 2x16x16's 32 ranks of "pod" and "data"; one period of 8 layers
POD_CELL = ("jamba-v0.1-52b",
            {"name": "jamba-v0.1-52b", "n_layers": 8}, "train", world.S, 32,
            [2, 2, 1])


def _ref_cases() -> dict:
    name, ov = KERNEL_CASES["qwen3-G2"]
    cases = {f"qwen3-G2/{world.tag(m)}/{step}": (name, ov, step, world.S,
                                                 _batch(step), list(m))
             for m in REF_MESHES for step in ("prefill", "train")}
    return dict(cases, pod=POD_CELL)


@pytest.fixture(scope="module")
def runs():
    """(the port's cells, the reference's compiled cells' collectives),
    the two children side by side."""
    port = world.start_fake_cells(_cells())
    ref = world._start(REF_SCRIPT, _ref_cases())
    ref.limit = world.REF_TRAIN_S
    try:
        got = world.fake_cells(port)
        left = ref.limit - (time.monotonic() - ref.started)
        out, _ = ref.communicate(timeout=max(left, 0.1))
    finally:
        for p in (port, ref):
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert ref.returncode == 0, out[-3000:]
    return got, json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("mesh", KERNEL_MESHES, ids=world.tag)
@pytest.mark.parametrize("case", sorted(KERNEL_CASES))
def test_meta_routes_run_on_the_live_ranks_shapes(runs, case, mesh, step):
    name, ov = KERNEL_CASES[case]
    cfg = reduced(get_config(name), **ov)
    cell = runs[0][f"{case}/{world.tag(mesh)}/{step}"]
    if step == "train":
        want = world.train_kernel_shapes(cfg, mesh, 2)
    else:
        ks = world.kernel_shapes(cfg, mesh, world.S, batch=world.B,
                                 n_decode=1 if step == "decode" else 0)
        want = ({"decode_attention": ks["decode_attention"]}
                if step == "decode" else
                {k: ks[k] for k in ("flash_attention", "ssm_scan")})
    want = {k: v for k, v in want.items() if v}
    # every step runs a kernel, but the Mamba stack's decode (one
    # recurrence step in the mixer)
    assert bool(want) != (case == "falcon-mamba" and step == "decode")
    assert cell["shapes"] == want
    assert set(cell["kernels"]) <= F32_KERNELS[step]
    if step == "train":
        assert cell["temp"] > 0


def test_collectives_by_hand_have_the_reference_bytes():
    """Shard -> Replicate, Partial -> Shard and Partial -> Replicate of an
    f32 (8, 6) DTensor over "data" of (2, 2): one all-gather, one
    reduce-scatter, one all-reduce, each with the wire bytes that the
    reference's parser gives the same collective in HLO.  A collective of
    DTensor's own redistribution is recorded too, under the op it served,
    and its plan under the op and placements."""
    script = r"""
import json
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from repro_torch.distributed import sharding as sh
from repro_torch.launch import dryrun
mesh = dryrun._mesh((2, 2))
out = {}
for name, src, dst in (("gather", Shard(0), Replicate()),
                       ("scatter", Partial(), Shard(0)),
                       ("reduce", Partial(), Replicate())):
    local = torch.empty((4 if src.is_shard() else 8, 6), device="meta")
    x = DTensor.from_local(local, mesh, [src, Replicate()], run_check=False,
                           shape=(8, 6), stride=(6, 1))
    with sh.recording() as rec:
        y = sh.redistribute(x, [dst, Replicate()])
    assert y.placements == (dst, Replicate()) and y.shape == (8, 6)
    out[name] = rec
# an op whose operands DTensor redistributes on its own (the models need
# none): its functional collective noted under the op it served
from repro_torch.launch.workcount import count_work
x = DTensor.from_local(torch.empty(4, 6, device="meta"), mesh,
                       [Shard(0), Replicate()], run_check=False, shape=(8, 6),
                       stride=(6, 1))
y = DTensor.from_local(torch.empty(8, 3, device="meta"), mesh,
                       [Shard(1), Replicate()], run_check=False, shape=(8, 6),
                       stride=(6, 1))
with count_work() as w:
    x + y
out["dtensor"] = [w["dtensor_collectives"], w["collectives"],
                  w["dtensor_redistributions"]]
print(json.dumps(out))
"""
    env = dict(os.environ, PYTHONPATH=str(world.ROOT / "src"),
               **world.ONE_THREAD)
    proc = subprocess.run([sys.executable, "-c", script], env=env,
                          capture_output=True, text=True,
                          timeout=world.JOIN_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    ops, rec, plans = got.pop("dtensor")
    assert list(ops) == ["aten::add.Tensor"]
    assert sum(v["count"] for k, v in rec.items() if k != "total_bytes") == \
        ops["aten::add.Tensor"] > 0
    # and the plan itself, by the op and the placements it moved between
    assert plans == {"aten::add.Tensor: (Shard(dim=1), Replicate()) -> "
                     "(Shard(dim=0), Replicate())": 1}
    hlo = ("HloModule m\n\nENTRY %main (p: f32[8,6]) -> f32[8,6] {{\n"
           "  %p = f32[8,6]{{1,0}} parameter(0)\n"
           "  ROOT %r = {} {}(f32[8,6]{{1,0}} %p)\n}}\n")
    for name, kind, result in (("gather", "all-gather", "f32[8,6]{1,0}"),
                               ("scatter", "reduce-scatter", "f32[4,6]{1,0}"),
                               ("reduce", "all-reduce", "f32[8,6]{1,0}")):
        want = ref_hlo.collective_stats_attributed(hlo.format(result, kind))
        want.pop("total_bytes")
        assert got[name] == want, name


def test_flops_split_as_the_batch(runs):
    """Rank 0 of (2, 1) runs half of world 1's rows: half its FLOPs."""
    one, two = runs[0]["flops/1x1"], runs[0]["flops/2x1"]
    assert one["flops"] > 0 and 2 * two["flops"] == one["flops"]
    assert one["collectives"]["total_bytes"] == 0


def test_peak_temporaries_of_a_hand_written_function():
    x = torch.empty(1024, device="meta")  # an argument: not a temporary
    with workcount.count_work((x,)) as w:
        a = x * 2  # 4 KiB
        b = a + 1  # 8 KiB live
        del a  # 4 KiB
        c = b.view(32, 32)  # a view: no new storage
        d = torch.cat([c, c])  # 12 KiB live: the peak
        del b, c, d
        e = x.exp()  # 4 KiB
    del e
    assert w["temp_size_in_bytes"] == 3 * 4096
    # cat and the three pointwise ops read and write their operands once
    assert w["bytes_accessed"] == 4096 * (2 + 2 + 3 + 2)
    assert w["flops"] == 0 and w["collectives"]["total_bytes"] == 0


def _layouts():
    """Meta tensors of one (4, 6, 5) f32 value in many layouts."""
    base = torch.empty(4, 6, 5, device="meta")
    big = torch.empty(4, 12, 5, device="meta")
    return {"contiguous": base, "slice": big[:, 3:9],
            "permuted": torch.empty(5, 4, 6, device="meta").permute(1, 2, 0),
            "expanded": torch.empty(1, 6, 1, device="meta").expand(4, 6, 5),
            "row": torch.empty(6, 1, device="meta"),
            "unsqueezed": torch.empty(4, 6, device="meta")[..., None],
            "scalar": torch.empty((), device="meta"),
            "bf16": torch.empty(4, 6, 5, dtype=torch.bfloat16, device="meta"),
            "int": torch.empty(4, 6, 5, dtype=torch.int32, device="meta"),
            "transposed": torch.empty(6, 4, device="meta").t()[..., None]}


@pytest.mark.parametrize("op", ["add", "mul", "div", "sub", "where", "gt",
                                "pow", "exp", "silu", "clamp"])
def test_pointwise_fast_path_is_the_meta_kernel(op):
    aten = torch.ops.aten
    ts = _layouts()
    calls = []
    for a in ts:
        for b in ts:
            if op in ("exp", "silu"):
                calls.append((getattr(aten, op).default, (ts[a],), {}))
            elif op == "clamp":
                calls.append((aten.clamp.default, (ts[a], -1.0, 2), {}))
            elif op == "pow":
                calls.append((aten.pow.Tensor_Tensor, (ts[a], ts[b]), {}))
            elif op == "where":
                calls.append((aten.where.self, (ts[a] > 0, ts[a], ts[b]), {}))
            elif op == "gt":
                calls.append((aten.gt.Tensor, (ts[a], ts[b]), {}))
            else:
                calls.append((getattr(aten, op).Tensor, (ts[a], ts[b]), {}))
    fast = 0
    for func, args, kwargs in calls:
        got = workcount._pointwise(func, args, kwargs)
        try:
            want = func(*args, **kwargs)
        except (RuntimeError, NotImplementedError):
            assert got is None, func  # the meta kernel refuses them
            continue
        if got is None:
            continue
        fast += 1
        assert got.shape == want.shape and got.dtype == want.dtype, func
        assert [s for s, n in zip(got.stride(), got.shape) if n > 1] == [
            s for s, n in zip(want.stride(), want.shape) if n > 1], (
            func, [tuple(a.stride()) for a in args
                   if isinstance(a, torch.Tensor)])
    assert fast > len(calls) // 3


def test_kernel_costs_give_the_recorded_bounds():
    """Each kernel's ``cost`` through ``chip_smoke``'s bound functions (the
    ones its kernel table reads) at the shapes of PERF.md's table: the
    bounds recorded there."""
    sys.path.insert(0, str(world.ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(world.ROOT))
    qwen = chip_smoke.QWEN_PREFILL
    assert round(chip_smoke.flash_bound(
        fa, qwen["B"], qwen["H"], qwen["Hkv"], qwen["S"], qwen["D"])[0],
        4) == 0.1390
    # time_decode's cache: 512 rows, 505 of them valid in each batch row
    assert round(chip_smoke.decode_bound(
        dec, 16, 32, 8, 512, 128, [505] * 16)[0], 5) == 0.00996
    assert round(chip_smoke.ssm_bound(ssm, 4, 256, 8192, 16)[0], 4) == 0.3318
    assert round(chip_smoke.flash_bwd_bound(fa, 8, 32, 32, 2048, 64)[0],
                 4) == 0.3476


@pytest.mark.parametrize("causal", [True, False])
def test_kept_pairs_by_row_index(causal):
    for S in (1, 5, 17, 64):
        for w in (0, 1, 3, 16, 100):
            want = sum(1 for i in range(S) for j in range(S)
                       if (not causal or j <= i) and (not w or j > i - w))
            assert fa.kept_pairs(S, causal, w) == want, (S, w)


def test_collectives_against_the_reference(runs):
    """The reduced qwen3-8b prefill and train cells: the port's executed
    collectives beside the reference's compiled ones, kind by kind (wire
    bytes a device, the reference's loop bodies multiplied by their trip
    counts), the totals within a factor of 4; printed too, the
    reference's collectives of the embedding's lookup."""
    port, ref = runs
    for key in sorted(k for k in ref if k.startswith("qwen3-G2/")):
        got, want = port[key]["collectives"], ref[key]
        print(f"{key}: port {got['total_bytes']:.0f} B, reference "
              f"{want['total_bytes']:.0f} B (ratio "
              f"{got['total_bytes'] / want['total_bytes']:.3f}); by kind "
              + ", ".join(f"{k} {got[k]['count']}/{want[k]['count']} calls "
                          f"{got[k]['bytes']:.0f}/{want[k]['bytes']:.0f} B"
                          for k in ref_hlo.COLLECTIVE_FACTOR)
              + f"; the lookup: port {port[key]['lookup']}, reference "
              f"{want['lookup']}")
        assert want["total_bytes"] / 4 <= got["total_bytes"] <= \
            4 * want["total_bytes"], key


def _unit_dims_dropped(call: str) -> str:
    """A collective's result with its dimensions of size 1 left out: XLA
    keeps the gather's index-vector dimension on the tokens and the split
    dimension on each piece of an all-to-all, the port neither."""
    return re.sub(r"\[([0-9,]*)\]", lambda m: "[" + ",".join(
        d for d in m.group(1).split(",") if d != "1") + "]", call)


@pytest.mark.parametrize("step", ("prefill", "train"))
@pytest.mark.parametrize("mesh", REF_MESHES, ids=world.tag)
def test_lookup_collectives_are_the_references(runs, mesh, step):
    """The reduced qwen3-8b's embedding lookup issues the reference's
    collectives, one by one, kind and result shape: the tokens gathered
    over "data", the rows summed over "model" at the table's width split
    over "data" (f32[2,8,32] on (2, 2), not the whole width), and one
    all-to-all over "data" to the batch split; in training the transpose's
    all-to-all back.  Before each gather of the tokens the reference's HLO
    also swaps the token shards of devices 1 and 2 (a collective-permute
    of the rank's own (B / data, S) tokens), so that it gathers them over
    the groups {0, 1} and {2, 3}; the port gathers over "data" directly,
    and that permute is left out of the comparison."""
    key = f"qwen3-G2/{world.tag(mesh)}/{step}"
    got = [_unit_dims_dropped(c) for c in runs[0][key]["lookup"]]
    shard = _unit_dims_dropped(
        f"collective-permute s32[{_batch(step) // mesh[0]},{world.S}]")
    want = []
    for c in map(_unit_dims_dropped, runs[1][key]["lookup"]):
        if c.startswith("collective-permute"):
            assert c == shard, c
            continue
        want.append(c)
    assert want and got == want, (got, runs[1][key]["lookup"])


def test_a_microbatch_splits_as_the_references(runs):
    """jamba's train step in 16 microbatches of 2 rows on a (2, 2, 1)
    mesh: the batch axes ("pod", "data") have 4 ranks, which 2 rows do
    not divide, and the longest prefix that divides, "pod", splits them.
    The reference's compiled step does the same: each layer's query
    projection in its microbatch loop holds 1 row a device, as each of the
    port's attention calls does.  Printed too, each side's FLOPs a device
    (the reference's ``cost_analysis`` counts a loop body once, the port's
    executed count every microbatch)."""
    port, ref = runs[0]["pod"], runs[1]["pod"]
    rows = sorted({q[0] for q, *_ in port["shapes"]["flash_attention"]})
    print(f"a microbatch's rows a device: port {rows}, reference "
          f"{ref['rows']}; FLOPs a device: port {port['flops']:.6g} "
          f"(executed), reference {ref['flops']:.6g} (loop bodies once)")
    assert rows == ref["rows"] == [1]
