"""Multi-pod dry run: build, place and execute every (arch x shape x mesh)
cell.

Port of ``repro.launch.dryrun``.  It touches no card, as the reference's
runs on fake CPU devices.  It starts a fake process group of 512 ranks in
this process (``torch.testing``'s "fake" backend: no rank but 0 exists, no
collective moves a byte); for each cell it builds the production mesh on
its first 256 or 512 ranks, builds the cell's ``Lowerable`` on the meta
device and turns every argument leaf into a ``DTensor`` with the
placements of its PartitionSpec.  A leaf whose placements do not divide
its shape fails the cell, where the reference's SPMD partitioner would
refuse the sharding.  ``memory`` records the bytes of rank 0's local
shards, summed over the leaves.

Then it executes the cell's real sharded step, ``low.fn``, as rank 0, on
those meta DTensors under ``sharding_ctx(mesh, low.rules)``, the
reference's compile of the same function: the kernels take their
shape-only route (``kernels/_meta.py``), and ``launch/workcount.py``
counts rank 0's FLOPs, bytes accessed and peak temporaries, with the
collectives ``distributed/sharding.py`` issues.  Each output's global
shape, dtype and placements are held to ``low.outs`` and
``low.out_shardings``; a mismatch fails the cell, as the reference's
partitioner would refuse it.  The report keeps the reference's layout:

* ``flops`` and ``bytes_accessed`` are executed totals: every layer,
  microbatch, remat recomputation and backward pass as it ran, and each
  kernel call's ``cost``.  XLA's ``cost_analysis`` counts a loop body
  once, so they are not expected to equal the reference's;
* ``collectives``: the reference's ``{kind: {"count", "bytes"},
  "total_bytes"}`` over all five kinds, the wire bytes a device sends
  (``hlo_analysis.COLLECTIVE_FACTOR``); ``count`` is the calls executed,
  where the reference's counts HLO instructions;
* ``memory.temp_size_in_bytes``: the peak of rank 0's live temporaries;
* ``compile_s``: the seconds of the executed step (eager PyTorch compiles
  nothing; this is the step's host time on meta tensors);
* ``fits_card``: arguments plus temporaries within the card's memory, the
  reference's "the compiled module must fit per-device memory";
* ``generated_code_size_in_bytes`` stays ``null``, and ``unavailable``
  says why;
* ``dtensor_collectives``: the collectives DTensor's own redistribution
  issued (in ``collectives`` too), by the op they served, and
  ``dtensor_redistributions``: every redistribution DTensor planned by
  itself, collective or local, by the op and placements; the models are
  laid out to need none of either (``{}``);
* ``lookup``: the collectives of the embedding's lookup and of its
  transpose, in order, as "<kind> <result>" (``models/model.py::_embed``,
  ``sharding.labelled``), the reference's attributed to ``jnp.take``.

``execute(cfg, shape, mesh_shape)`` does one cell's work for any config,
shape and mesh (the tests run reduced configs on small fake meshes).  The
cells of ``--all`` run in child processes, one fake group each (the cells
are independent), as many at a time as this process may use cores.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun_report.json
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

from repro_torch.configs.base import SHAPES, get_config, list_configs
from repro_torch.launch.hlo_analysis import CHIP
from repro_torch.launch.specs import build_lowerable, cell_skip_reason
from repro_torch.train.tree import leaves, unflatten

UNAVAILABLE = (
    "generated_code_size_in_bytes: eager PyTorch compiles no module, and "
    "the dry run builds no kernel")
#: mesh axis names by the number of mesh dimensions
AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}


#: the fake group's ranks: the largest mesh's
WORLD = 512
_MESHES: dict = {}


def _mesh(shape: tuple):
    """The mesh of ``shape`` (axes ``AXES``) over the first ranks of a fake
    default process group of ``WORLD`` ranks, this process rank 0; the
    group is started once and each mesh made once, so that no mesh that
    DTensor's caches hold loses its groups."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=WORLD)
    if dist.get_backend() != "fake" or dist.get_world_size() != WORLD:
        raise RuntimeError(
            f"a {dist.get_backend()} process group of "
            f"{dist.get_world_size()} ranks is running: the dry run needs "
            f"its own process")
    if shape not in _MESHES:
        _MESHES[shape] = DeviceMesh("cpu", torch.arange(
            math.prod(shape)).reshape(shape), mesh_dim_names=AXES[len(shape)])
    return _MESHES[shape]


def _pairs(tree, specs) -> list:
    """[(meta tensor, PartitionSpec)] of one argument or output; a spec of
    None replicates the whole subtree."""
    from repro_torch.distributed.sharding import PartitionSpec

    if tree is None:
        return []
    if specs is None:
        return [(t, PartitionSpec()) for t in leaves(tree)]
    return list(zip(leaves(tree), leaves(specs), strict=True))


def place(tree, specs, mesh) -> tuple:
    """(``tree`` with every leaf a meta DTensor on ``mesh`` with its spec's
    placements, the bytes of rank 0's local shards)."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.sharding import placements

    if tree is None:
        return None, 0
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total, placed = 0, []
    for t, spec in _pairs(tree, specs):
        pl = placements(spec, mesh)
        local = list(t.shape)
        for axis, p in zip(mesh.mesh_dim_names, pl):
            if isinstance(p, Shard):
                if local[p.dim] % sizes[axis]:
                    raise ValueError(
                        f"{spec} does not divide a leaf of shape "
                        f"{tuple(t.shape)} on {sizes}")
                local[p.dim] //= sizes[axis]
        shard = torch.empty(local, dtype=t.dtype, device="meta")
        d = DTensor.from_local(shard, mesh, pl, run_check=False,
                               shape=t.shape, stride=t.stride())
        if d.shape != t.shape:
            raise ValueError(f"{spec}: a DTensor of {tuple(d.shape)}, the "
                             f"leaf {tuple(t.shape)}")
        placed.append(d)
        total += math.prod(local) * t.element_size()
    return unflatten(tree, placed), total


def _check_outputs(outs, want, specs, mesh) -> None:
    """Each output leaf's global shape, dtype and placements against the
    cell's stated ones (a plain tensor is the whole value on every rank:
    replicated); a mesh dimension of one rank places nothing."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.distributed.sharding import placements

    got = [t for t in leaves(outs) if t is not None]
    pairs = [(w, s) for w, s in _pairs(want, specs) if w is not None]
    if len(got) != len(pairs):
        raise ValueError(f"the step returned {len(got)} output leaves, the "
                         f"cell states {len(pairs)}")
    for i, (g, (w, spec)) in enumerate(zip(got, pairs)):
        pl = (tuple(g.placements) if isinstance(g, DTensor)
              else (Replicate(),) * mesh.ndim)
        wpl = placements(spec, mesh)
        same = all(a == b for m, (a, b) in enumerate(zip(pl, wpl))
                   if mesh.size(m) > 1)
        if tuple(g.shape) != tuple(w.shape) or g.dtype != w.dtype or not same:
            raise ValueError(
                f"output leaf {i}: {tuple(g.shape)} {g.dtype} {pl}, the cell "
                f"states {tuple(w.shape)} {w.dtype} {wpl} ({spec})")


def execute(cfg, shape, mesh_shape) -> dict:
    """One cell's work: the mesh of ``mesh_shape`` on the fake group
    (``_mesh``), the cell's ``Lowerable``, the arguments placed as meta
    DTensors (a decode step's cache length the cell's prompt length, an
    int) and ``low.fn`` executed under the counter.  Returns the report's figures,
    with "kernel_calls" (the meta routes' ``_meta.Call``s)."""
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.workcount import count_work

    mesh = _mesh(tuple(mesh_shape))
    t0 = time.time()
    low = build_lowerable(cfg, shape, mesh)
    args, arg_bytes = zip(*(place(a, s, mesh) for a, s in
                            zip(low.args, low.in_shardings, strict=True)))
    out_bytes = sum(place(o, s, mesh)[1]
                    for o, s in zip(low.outs, low.out_shardings, strict=True))
    if shape.step == "decode":
        args = (*args[:3], shape.seq_len)
    if shape.step == "train":
        for p in leaves(args[0].params):
            p.requires_grad_(True)
    t_place = time.time() - t0
    t0 = time.time()
    with sharding_ctx(mesh, low.rules), count_work(args) as work:
        outs = low.fn(*args)
    t_exec = time.time() - t0
    _check_outputs(outs, low.outs, low.out_shardings, mesh)
    coll = work["collectives"]
    issued = sum(v["count"] for k, v in coll.items() if k != "total_bytes")
    plain = sum(n for op, n in work["collective_ops"].items()
                if op.startswith("c10d::"))
    if plain + sum(work["dtensor_collectives"].values()) != issued:
        raise RuntimeError(f"collectives ran: {dict(work['collective_ops'])}"
                           f"; {issued} recorded")
    return dict(work, place_s=t_place, exec_s=t_exec,
                argument_size_in_bytes=sum(arg_bytes),
                output_size_in_bytes=out_bytes)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             verbose: bool = True) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    skip = cell_skip_reason(cfg, shape_name)
    mesh_name = "2x16x16" if multi_pod else "16x16"
    cell = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "step": shape.step,
    }
    if skip:
        cell["status"] = "skipped"
        cell["reason"] = skip
        return cell

    w = execute(cfg, shape, (2, 16, 16) if multi_pod else (16, 16))
    mem = {
        "argument_size_in_bytes": w["argument_size_in_bytes"],
        "output_size_in_bytes": w["output_size_in_bytes"],
        "temp_size_in_bytes": w["temp_size_in_bytes"],
        "generated_code_size_in_bytes": None,
    }
    cell.update(
        status="ok",
        lower_s=round(w["place_s"], 1),
        compile_s=round(w["exec_s"], 1),
        flops=float(w["flops"]),
        bytes_accessed=float(w["bytes_accessed"]),
        collectives=w["collectives"],
        memory=mem,
        dtensor_collectives=w["dtensor_collectives"],
        dtensor_redistributions=w["dtensor_redistributions"],
        lookup=w["labelled_collectives"].get("lookup", []),
        fits_card=(mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
                   <= CHIP.hbm_bytes),
        unavailable=UNAVAILABLE,
    )
    if verbose:
        coll = cell["collectives"]
        print(f"--- {arch} x {shape_name} x {mesh_name} ---")
        print("memory (rank 0):", cell["memory"])
        print(f"executed (rank 0): flops={cell['flops']:.3e} "
              f"bytes={cell['bytes_accessed']:.3e}")
        print("collectives: " + ", ".join(
            f"{k}:{v['count']}({v['bytes'] / 1e6:.1f}MB)"
            for k, v in coll.items() if isinstance(v, dict) and v["count"])
            + f" | total {coll['total_bytes'] / 1e6:.1f} MB/device")
        print("lookup: " + ", ".join(cell["lookup"]))
        print(f"placed {w['place_s']:.1f}s executed {w['exec_s']:.1f}s")
    return cell


def _failed(arch: str, shape: str, mp: bool, e: Exception) -> dict:
    print(f"FAILED {arch} x {shape} x {'multi' if mp else 'single'}: {e!r}",
          file=sys.stderr)
    return {"arch": arch, "shape": shape, "mesh": "2x16x16" if mp else "16x16",
            "status": "FAILED", "error": repr(e)[:500]}


def _cell_job(combo) -> dict:
    """A child's cell of ``--all``: its report entry, or the failure's."""
    try:
        return run_cell(*combo, verbose=False)
    except Exception as e:  # noqa: BLE001 - report and continue
        return _failed(*combo, e)


def _work_order(combo) -> tuple:
    """The larger cells first: train steps, then by depth."""
    arch, shape, _ = combo
    return (SHAPES[shape].step != "train", -get_config(arch).n_layers)


def run_all(combos) -> list:
    """The cells of ``combos`` in child processes (spawned, one fake group
    each, as many at a time as this process may use cores), the larger
    first; their entries in ``combos``' order."""
    import multiprocessing as mp
    import os
    from concurrent.futures import ProcessPoolExecutor

    order = sorted(range(len(combos)), key=lambda i: _work_order(combos[i]))
    cells = [None] * len(combos)
    workers = max(1, min(len(combos), len(os.sched_getaffinity(0))))
    with ProcessPoolExecutor(workers, mp_context=mp.get_context("spawn")) as ex:
        futures = {ex.submit(_cell_job, combos[i]): i for i in order}
        for f in futures:
            i = futures[f]
            cells[i] = f.result()
            c = cells[i]
            if c["status"] == "ok":
                print(f"{c['arch']} x {c['shape']} x {c['mesh']}: executed "
                      f"{c['compile_s']} s, flops={c['flops']:.3e} "
                      f"collectives {c['collectives']['total_bytes'] / 1e6:.1f}"
                      f" MB, temporaries "
                      f"{c['memory']['temp_size_in_bytes'] / 1e9:.2f} GB",
                      flush=True)
    return cells


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="every cell, both meshes")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--out", default=None, help="write JSON report")
    args = ap.parse_args(argv)

    t0 = time.time()
    if args.all:
        combos = [
            (a, s, mp)
            for mp in ((False,) if args.single_pod_only else (False, True))
            for a in list_configs()
            for s in SHAPES
        ]
        cells = run_all(combos)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combo = (args.arch, args.shape, args.multi_pod)
        try:
            cells = [run_cell(*combo)]
        except Exception as e:  # noqa: BLE001 - report and continue
            cells = [_failed(*combo, e)]
    failed = sum(c["status"] == "FAILED" for c in cells)

    ok = [c for c in cells if c["status"] == "ok"]
    over = []
    for c in ok:
        if not c["fits_card"]:
            m = c["memory"]
            need = m["argument_size_in_bytes"] + m["temp_size_in_bytes"]
            over.append(f"{c['arch']} x {c['shape']} x {c['mesh']} "
                        f"({need / 1e9:.2f} GB)")
    print(f"arguments and temporaries a device above the card's "
          f"{CHIP.hbm_bytes / 1e9:.0f} GB: {len(over)} of {len(ok)} ok cells"
          + (": " + "; ".join(over) if over else ""))
    print(f"dry run: {len(cells)} cells in {time.time() - t0:.1f} s")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out} ({len(cells)} cells, {failed} failed)")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
