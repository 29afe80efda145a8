"""Multi-pod dry run: build and place every (arch x shape x mesh) cell.

Port of ``repro.launch.dryrun``.  It touches no card, as the reference's
runs on fake CPU devices.  For each cell it starts a fake process group of
256 or 512 ranks in this process (``torch.testing``'s "fake" backend: no
rank but 0 exists, no collective moves a byte), builds the production mesh
on it (``launch.mesh.make_production_mesh``), builds the cell's
``Lowerable`` on the meta device and turns every argument and output leaf
into a ``DTensor`` with the placements of its PartitionSpec.  A leaf whose
placements do not divide its shape fails the cell, where the reference's
SPMD partitioner would refuse the sharding.  ``memory`` records the bytes
of rank 0's local shards, summed over the leaves.

What the reference reads from XLA's compiled module (temporaries, code
size, ``cost_analysis``'s flops and bytes, the collectives of the
partitioned HLO) is ``null`` here, and ``unavailable`` says why: the
sharded step is not executed.  The roofline takes FLOPs and HBM bytes from
the analytic ``benchmarks_torch.flops_model``, as the reference's does.

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
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import build_lowerable, cell_skip_reason
from repro_torch.train.tree import leaves

UNAVAILABLE = (
    "the sharded step is not executed on the fake group (every cell's step "
    "runs sharded on a live group of ranks); a meta trace of the plain "
    "versions at these shapes is not practical either (the plain scan loops "
    "over every step, 524288 at long_500k); the reference reads these from "
    "XLA's compiled module, whose cost_analysis counts a loop body once")


def _fake_group(world: int) -> None:
    """A fake default process group of ``world`` ranks, this process rank
    0; one the dry run started for another mesh is replaced."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError(
                f"a {dist.get_backend()} process group is running: the dry "
                f"run needs its own process")
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _pairs(tree, specs) -> list:
    """[(meta tensor, PartitionSpec)] of one argument or output; a spec of
    None replicates the whole subtree."""
    from repro_torch.distributed.sharding import PartitionSpec

    if tree is None:
        return []
    if specs is None:
        return [(t, PartitionSpec()) for t in leaves(tree)]
    return list(zip(leaves(tree), leaves(specs), strict=True))


def place(tree, specs, mesh) -> int:
    """Turn every leaf into a DTensor on ``mesh`` with its spec's
    placements; returns the bytes of rank 0's local shards."""
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.distributed.sharding import placements

    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0
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
        total += math.prod(local) * t.element_size()
    return total


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

    _fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
    t0 = time.time()
    low = build_lowerable(cfg, shape, mesh)
    arg_bytes = sum(place(a, s, mesh)
                    for a, s in zip(low.args, low.in_shardings, strict=True))
    out_bytes = sum(place(o, s, mesh)
                    for o, s in zip(low.outs, low.out_shardings, strict=True))
    t_place = time.time() - t0

    cell.update(
        status="ok",
        lower_s=round(t_place, 1),
        compile_s=None,
        flops=None,
        bytes_accessed=None,
        collectives=None,
        memory={
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
        },
        fits_card=arg_bytes <= CHIP.hbm_bytes,
        unavailable=UNAVAILABLE,
    )
    if verbose:
        print(f"--- {arch} x {shape_name} x {mesh_name} ---")
        print("memory (rank 0's shards):", cell["memory"])
        print(f"built and placed in {t_place:.1f}s")
    return cell


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

    if args.all:
        # mesh outermost: one fake group per mesh
        combos = [
            (a, s, mp)
            for mp in ((False,) if args.single_pod_only else (False, True))
            for a in list_configs()
            for s in SHAPES
        ]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        combos = [(args.arch, args.shape, args.multi_pod)]

    cells, failed = [], 0
    for arch, shape, mp in combos:
        try:
            cells.append(run_cell(arch, shape, mp))
        except Exception as e:  # noqa: BLE001 - report and continue
            failed += 1
            cells.append(
                {"arch": arch, "shape": shape,
                 "mesh": "2x16x16" if mp else "16x16",
                 "status": "FAILED", "error": repr(e)[:500]}
            )
            print(f"FAILED {arch} x {shape} x {'multi' if mp else 'single'}: "
                  f"{e!r}", file=sys.stderr)

    over = [f"{c['arch']} x {c['shape']} x {c['mesh']} "
            f"({c['memory']['argument_size_in_bytes'] / 1e9:.2f} GB)"
            for c in cells if c.get("status") == "ok" and not c["fits_card"]]
    print(f"argument bytes a device above the card's "
          f"{CHIP.hbm_bytes / 1e9:.0f} GB: {len(over)} of "
          f"{sum(c.get('status') == 'ok' for c in cells)} ok cells"
          + (": " + "; ".join(over) if over else ""))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(cells, f, indent=1)
        print(f"wrote {args.out} ({len(cells)} cells, {failed} failed)")
    if failed:
        sys.exit(1)


if __name__ == "__main__":
    main()
