"""Logical-axis sharding rules (MaxText-style) and helpers.

Port of ``repro.distributed.sharding``.  Every parameter and strategic
activation carries *logical* axis names ("batch", "heads", "embed",
"experts", ...).  A rule table maps logical names to physical mesh axes;
:func:`to_pspec` resolves them, dropping physical axes that are absent from
the mesh, so the same rules serve one device, a 16x16 pod or a 2x16x16
multi-pod mesh.  ``TRAIN_RULES`` (FSDP over "data", TP over "model") and
``DECODE_RULES`` (adds KV-sequence parallelism) are the reference's tables.

The port's meshes are ``torch.distributed.device_mesh.DeviceMesh`` (built
by ``repro_torch.launch.mesh``) and :class:`AbstractMesh`, which has axis
names and sizes but no devices, so that rules resolve for meshes this
machine cannot build (the reference's tests use a ``Mesh`` of one device
repeated for the same purpose).  A resolved spec is a :class:`PartitionSpec`
(a tuple, as the reference's ``jax.sharding.PartitionSpec``);
:func:`placements` turns it into DTensor placements, one per mesh
dimension.

``constrain`` is the reference's ``with_sharding_constraint`` by logical
names.  Without a mesh it returns ``x`` itself; a DTensor is redistributed
to the resolved placements; a plain tensor under a mesh of one device is
returned as it is (the constraint holds trivially, as it does in JAX).  A
plain tensor under a larger mesh raises ``NotImplementedError``: running the
model over several devices is not ported (the CUDA kernels take raw
pointers, so a DTensor cannot enter them).
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

# logical axis -> physical mesh axis (or tuple of axes)
TRAIN_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "model",  # Megatron-style sequence parallelism on the residual
    "kv_seq": None,
    "heads": "model",
    "kv_heads": "model",
    "qk_features": "model",  # fused head*dim projections
    "embed": None,  # activation embed dim replicated
    "mlp": "model",
    "experts": "model",
    # falls back to "model" when the expert count is not mesh-divisible
    # (e.g. qwen2-moe's 60 experts): the used-axis tracking in to_pspec
    # gives "experts" first claim on the axis when divisible.
    "expert_mlp": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "ssm_state": None,
    "conv": None,
    "dt_rank": None,
    # parameter-only axes (FSDP dimension)
    "embed_p": "data",
    "capacity": None,
}

# Long-context decode: batch is tiny, KV length is huge -> shard the KV
# sequence; serving holds no optimizer state, so weights are not
# FSDP-sharded over "data", and expert FFN dims shard over "data" instead.
DECODE_RULES = dict(
    TRAIN_RULES,
    kv_seq="model",
    seq_sp=None,
    batch=("pod", "data"),
    embed_p=None,
    expert_mlp="data",
)


class PartitionSpec(tuple):
    """One entry per tensor dimension: None (replicated), a mesh axis name,
    or a tuple of names (the dimension split over those axes, the first
    outermost)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class AbstractMesh:
    """Axis names and sizes of a mesh, without devices."""

    def __init__(self, axis_names, shape):
        if len(axis_names) != len(shape):
            raise ValueError(f"{axis_names} names for a mesh of {shape}")
        self.mesh_dim_names = tuple(axis_names)
        self.shape = tuple(int(s) for s in shape)

    def size(self) -> int:
        return math.prod(self.shape)

    def __repr__(self):
        return f"AbstractMesh({self.mesh_dim_names}, {self.shape})"


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class _Ctx(threading.local):
    mesh = None
    rules: dict = TRAIN_RULES


_CTX = _Ctx()


@contextmanager
def sharding_ctx(mesh, rules: Optional[dict] = None):
    prev = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = rules if rules is not None else TRAIN_RULES
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def active_mesh():
    return _CTX.mesh


def to_pspec(logical, rules: Optional[dict] = None, mesh=None,
             shape: Optional[tuple] = None) -> PartitionSpec:
    """Resolve logical axis names to a PartitionSpec for the mesh.

    Shape-aware: a mapping is dropped when the dimension is not divisible by
    the product of the mapped mesh axis sizes, and when a mesh axis was
    already consumed by an earlier dimension (a spec may use each axis
    once).  Of a tuple mapping the longest prefix that divides is kept.
    """
    rules = rules if rules is not None else _CTX.rules
    mesh = mesh if mesh is not None else _CTX.mesh
    sizes = axis_sizes(mesh) if mesh is not None else {}
    used: set = set()
    out = []
    for i, name in enumerate(logical):
        phys = rules.get(name, None) if name is not None else None
        if phys is None:
            out.append(None)
            continue
        if isinstance(phys, str):
            phys = (phys,)
        if mesh is not None:
            phys = tuple(a for a in phys if a in sizes and a not in used)
        if shape is not None:
            while phys and shape[i] % math.prod(
                    sizes.get(a, 1) for a in phys):
                phys = phys[:-1]
        if not phys:
            out.append(None)
            continue
        used.update(phys)
        out.append(phys[0] if len(phys) == 1 else tuple(phys))
    return PartitionSpec(*out)


def placements(spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` for each
    mesh dimension that splits tensor dimension ``dim``, ``Replicate()``
    for the others.  A tuple entry must name its axes in mesh order (the
    first outermost), which is how DTensor splits one dimension over
    several mesh dimensions."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{entry} is not in the mesh's order {names}")
        for j in idx:
            out[j] = Shard(dim)
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A mesh and a resolved spec: the reference's ``NamedSharding``."""
    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def constrain(x, *logical):
    """The sharding constraint by logical names; a no-op without a mesh."""
    mesh = _CTX.mesh
    if mesh is None:
        return x
    spec = to_pspec(logical, shape=tuple(x.shape))
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        return x.redistribute(mesh, placements(spec, mesh))
    if mesh.size() == 1:
        return x
    raise NotImplementedError(
        f"a plain tensor under a mesh of {mesh.size()} devices: running the "
        f"model over several devices is not ported (spec {spec})")


def named_sharding(logical, mesh=None, rules=None) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("named_sharding needs a mesh")
    return NamedSharding(mesh, to_pspec(logical, rules=rules, mesh=mesh))
