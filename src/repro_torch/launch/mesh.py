"""Mesh construction on ``torch.distributed``.

Port of ``repro.launch.mesh``.  Functions, not module-level constants, so
importing this module starts no process group.

* ``make_local_mesh(n_data, n_model, device)`` is a ("data", "model")
  ``DeviceMesh`` over the ranks of the process group.  Where no group
  exists and the world is one process, it starts one: NCCL on cuda, gloo on
  the CPU, over an in-process ``HashStore`` (no address, no network).  A
  world of several processes starts its own group first (address, size
  and rank are the caller's, as ``torch.distributed`` wants them).
* ``make_production_mesh(multi_pod=)`` is the reference's (16, 16) pod or
  (2, 16, 16) multi-pod mesh; it needs a group of 256 or 512 ranks.
  ``abstract_production_mesh`` gives the same axes and sizes as an
  ``AbstractMesh``, for resolving rules without the devices.

The device is cuda unless the caller asks for the CPU; without a card a
cuda mesh raises.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.device import resolve
from repro_torch.distributed.sharding import AbstractMesh


def _production_layout(multi_pod: bool):
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def _start_group(dev: torch.device, world: int):
    if dist.is_initialized():
        return
    if world != 1:
        raise RuntimeError(
            f"a mesh of {world} ranks: start the process group of {world} "
            f"processes first (torch.distributed.init_process_group)")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh(dev: torch.device, shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    _start_group(dev, math.prod(shape))
    if dist.get_world_size() != math.prod(shape):
        raise RuntimeError(f"a mesh of {shape} needs {math.prod(shape)} "
                           f"ranks; the group has {dist.get_world_size()}")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=names)


def abstract_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    shape, names = _production_layout(multi_pod)
    return AbstractMesh(names, shape)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape, names = _production_layout(multi_pod)
    return _mesh(resolve(device), shape, names)


def make_local_mesh(n_data: int = 1, n_model: int = 1, device=None):
    """A ("data", "model") mesh over the group's ranks (default cuda)."""
    return _mesh(resolve(device), (n_data, n_model), ("data", "model"))
