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
to the resolved placements (the collectives that XLA's partitioner inserts
in the reference); a plain tensor under a mesh of one device is returned as
it is (the constraint holds trivially, as it does in JAX).  A plain tensor
under a larger mesh raises ``NotImplementedError``: prefill, decode and
training run sharded with every activation a DTensor from the embedding
on, so a plain tensor there is a leak.

Every redistribution (``redistribute``: ``constrain``'s, ``distribute``'s
and ``full``'s) runs its collectives through ``torch.distributed``'s own
calls on the rank's shard (``all_gather_into_tensor``, ``all_reduce``,
``reduce_scatter_tensor``, and ``all_to_all_single`` where a mesh axis
moves its split from one dimension to another, as XLA's partitioner
does) and rewraps it, never through DTensor's: with
torch 2.11.0 and gloo on an H100 host, DTensor's functional all-gather of
a CUDA tensor ended the process (SIGSEGV), while the plain calls moved the
same tensors.  The
models place every DTensor operation so that it needs no redistribution
of its own: ``forbid_dtensor_plans`` makes any plan of DTensor's own
raise, as the tests' ranks and the card's sharded phases do, since a plan
that relabels on one torch version moves data on another.  A dimension of
size 1 is never split (``placements``), and over a mesh axis of one rank
a weight is whole (``gathered``) and so is the activation it meets in a
product (``whole_on_one_rank``): DTensor cannot view such a split, and
would split the weight by itself.

``distribute`` is the reference's ``jax.device_put`` with a tree of
``NamedSharding``s: each full tensor becomes a DTensor holding only the
rank's shard.  Where a step has no DTensor strategy, or needs a collective
that the reference's partitioner places by itself, the models work on the
rank's shard (``local``) with the collective explicit (``psum``, ``pmax``
over the mesh axes that shard a dimension, ``shard_axes``) and wrap the
result back (``from_local``); ``local_offset`` gives where a rank's shard
starts, and ``zeros`` allocates only the rank's shard of a tensor.

Under autograd (sharded training) every move carries its gradient.  A
redistribution is the identity on the whole tensor, so its gradient is the
incoming gradient redistributed to the input's placements
(``_Redistribute``): a gather's gradient is reduce-scattered where it
arrives as a partial sum and chunked where it arrives the same on every
rank, a reduction's (``Partial()`` in) is the replicated gradient, a
chunk's is gathered.  ``from_local`` does the same for the rank's shard.
``local`` states what the rank's gradient of its shard is: the shard of
the whole gradient, or, on the mesh axes named in its ``partial``, where
the tensor is replicated but each rank works on its own part, the rank's
term of a sum.  ``psum``'s gradient passes as it is (every rank's
consumers of the sum are the same), and ``reduce_grad`` sums a gradient
over the ranks whose consumers differ (Megatron's f and g).  No move goes
through DTensor's own redistribution, forward or backward.

``recording()`` turns on a record of the collectives issued (every one
goes through ``_move`` or ``_all_reduce``, so ``psum``, ``pmax``,
``reduce_grad`` and the moves' transposes under autograd are in it): by
the reference's kind names (``hlo_analysis.COLLECTIVE_FACTOR``), the
calls executed and their wire bytes, the result's local bytes times the
kind's factor (``note``; the dry run's counter also notes any collective
of DTensor's own redistribution, which the models avoid).  The reference's ``count`` is the number of HLO
instructions (a loop body's once), with only the bytes multiplied by trip
counts; here both count what ran.  Off, it costs one test a collective.
Given a dict, it also lists each collective issued under ``labelled(name)``
(and by that code's transposes under autograd) as "<kind> <result>" in
``calls[name]``, in order: the reference's op names, which attribute an
HLO collective to the operation whose partitioning placed it.
"""
from __future__ import annotations

import collections
import math
import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.launch.hlo_analysis import COLLECTIVE_FACTOR

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
    label = None  # ``labelled``'s name


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


_RECORD: dict | None = None
_CALLS: dict | None = None


@contextmanager
def recording(calls: Optional[dict] = None):
    """Record the collectives issued inside: yields {kind: {"count",
    "bytes"}} over every kind of ``COLLECTIVE_FACTOR``, filled as they
    run, and lists those issued under a ``labelled`` name in ``calls``
    (see the module's docstring)."""
    global _RECORD, _CALLS
    prev = _RECORD, _CALLS
    _RECORD = {k: {"count": 0, "bytes": 0.0} for k in COLLECTIVE_FACTOR}
    _CALLS = calls
    try:
        yield _RECORD
    finally:
        _RECORD, _CALLS = prev


@contextmanager
def labelled(name):
    """List the collectives issued inside, and those their transposes
    issue under autograd, under ``name`` in ``recording``'s calls."""
    prev = _CTX.label
    _CTX.label = name
    try:
        yield
    finally:
        _CTX.label = prev


_DTYPE_NAMES = {torch.float32: "f32", torch.bfloat16: "bf16",
                torch.float16: "f16", torch.int32: "s32", torch.int64: "s64",
                torch.int16: "s16", torch.int8: "s8", torch.bool: "pred"}


def _hlo_type(dtype, shape) -> str:
    """A result's type as XLA prints it: "f32[2,8,32]"."""
    dims = ",".join(map(str, shape))
    return f"{_DTYPE_NAMES.get(dtype, str(dtype))}[{dims}]"


def note(kind: str, result) -> None:
    """Add one collective of ``kind`` whose result is ``result`` to the
    active record (``recording``), if any.  An all-to-all's ``result``
    holds the pieces a rank receives along its first dimension, one a
    rank, which its listed result names as XLA's tuple does."""
    if _RECORD is not None:
        entry = _RECORD[kind]
        entry["count"] += 1
        entry["bytes"] += (result.numel() * result.element_size()
                           * COLLECTIVE_FACTOR[kind])
    if _CALLS is not None and _CTX.label is not None:
        if kind == "all-to-all":
            piece = _hlo_type(result.dtype, result.shape[1:])
            what = f"({', '.join([piece] * result.shape[0])})"
        else:
            what = _hlo_type(result.dtype, result.shape)
        _CALLS.setdefault(_CTX.label, []).append(f"{kind} {what}")


def recompute_context():
    """A ``context_fn`` for ``torch.utils.checkpoint`` (non-reentrant) that
    makes the active mesh and rules active again while the backward pass
    recomputes the forward: on a card autograd runs that in its own
    thread, where the thread-local context is empty."""
    from contextlib import nullcontext

    mesh, rules = _CTX.mesh, _CTX.rules
    return lambda: (nullcontext(), sharding_ctx(mesh, rules))


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


def placements(spec, mesh, shape=None) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(dim)`` for each
    mesh dimension that splits tensor dimension ``dim``, ``Replicate()``
    for the others.  A tuple entry must name its axes in mesh order (the
    first outermost), which is how DTensor splits one dimension over
    several mesh dimensions.  Given the tensor's ``shape``, a dimension of
    size 1 is not split: only mesh axes of one rank can split it, where
    nothing moves, and DTensor cannot view such a split (it plans a
    redistribution of its own, or refuses)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        if entry is None or shape is not None and shape[dim] == 1:
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
        return redistribute(x, placements(spec, mesh, x.shape))
    if mesh.size() == 1:
        return x
    raise NotImplementedError(
        f"a plain tensor under a mesh of {mesh.size()} devices (spec "
        f"{spec}): on several devices only DTensors run")


def named_sharding(logical, mesh=None, rules=None) -> NamedSharding:
    mesh = mesh if mesh is not None else _CTX.mesh
    if mesh is None:
        raise ValueError("named_sharding needs a mesh")
    return NamedSharding(mesh, to_pspec(logical, rules=rules, mesh=mesh))


# --- DTensors: placing, local shards and explicit collectives ---------------


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def local(x, partial=()):
    """The rank's shard of a DTensor (``to_local()``); anything else as it
    is.  Under autograd the shard's gradient is the rank's shard of the
    whole gradient, except on the mesh axes named in ``partial`` where
    ``x`` is replicated: there each rank works on its own part of the
    tensor's uses, and its gradient is the rank's term of a sum
    (``Partial()``), which the next redistribution of the gradient sums."""
    if not is_dtensor(x):
        return x
    if not _needs_grad(x):
        return x.to_local()
    return x.to_local(grad_placements=_grad_placements(
        x.placements, x.device_mesh, partial))


def _chunk(t, mesh, pl):
    """The rank's shard of the full tensor ``t`` under placements ``pl``
    (each split even; a dimension split over several mesh dimensions is
    split in mesh order, as DTensor splits it)."""
    coord = mesh.get_coordinate()
    for m, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(m)
            if t.shape[p.dim] % n:
                raise ValueError(f"dimension {p.dim} of {tuple(t.shape)} "
                                 f"does not split evenly over {n}")
            t = t.chunk(n, dim=p.dim)[coord[m]]
    return t


def _contiguous_strides(shape) -> tuple:
    out, acc = [], 1
    for n in reversed(tuple(shape)):
        out.append(acc)
        acc *= n
    return tuple(reversed(out))


def _place(t, spec, mesh):
    from torch.distributed.tensor import DTensor

    if not isinstance(t, torch.Tensor):
        return t
    pl = placements(spec if spec is not None else PartitionSpec(), mesh,
                    t.shape)
    if isinstance(t, DTensor):
        return redistribute(t, pl)
    # the mesh's device; a meta tensor (the dry run) stays on meta
    dev = t.device if t.is_meta else torch.device(mesh.device_type)
    if all(p.is_replicate() for p in pl):
        shard = t.to(dev)
    else:  # a copy: the caller's full tensor can be dropped
        shard = _chunk(t, mesh, pl).to(dev, copy=True).contiguous()
    return DTensor.from_local(shard, mesh, pl, run_check=False, shape=t.shape,
                              stride=_contiguous_strides(t.shape))


def distribute(tree, pspec_tree, mesh, in_place=False):
    """The reference's ``jax.device_put(tree, NamedSharding tree)``: each
    tensor leaf of ``tree`` becomes a DTensor on ``mesh`` with the
    placements of its PartitionSpec, holding only the rank's shard (moved
    to the mesh's device; nothing is communicated, every rank holds the
    same full tensor).  A DTensor leaf is redistributed.  A None spec, for
    a leaf or a whole subtree, replicates; other leaves (numbers, None)
    are returned as they are.  With ``in_place``, the dicts and lists of
    ``tree`` take the placed leaves themselves, one at a time, so that
    each leaf's old placement is freed as its new one is made (no second
    whole tree lives beside the first)."""
    if in_place and isinstance(tree, (dict, list)):
        whole = pspec_tree is None or isinstance(pspec_tree, PartitionSpec)
        for k in list(tree.keys() if isinstance(tree, dict)
                      else range(len(tree))):
            tree[k] = distribute(tree[k], pspec_tree if whole
                                 else pspec_tree[k], mesh, in_place=True)
        return tree
    if pspec_tree is None or isinstance(pspec_tree, PartitionSpec):
        from repro_torch.train.tree import map_tree

        return map_tree(lambda t: _place(t, pspec_tree, mesh), tree)
    if isinstance(tree, dict):
        return {k: distribute(v, pspec_tree[k], mesh) for k, v in tree.items()}
    return type(tree)(distribute(v, s, mesh)
                      for v, s in zip(tree, pspec_tree, strict=True))


def _alone(placements, m, d, ndim) -> bool:
    """Whether mesh dimension m is the only one splitting tensor dim d."""
    return not any(q.is_shard() and q.dim % ndim == d
                   for k, q in enumerate(placements) if k != m)


def _grad_placements(pl, mesh=None, partial=()) -> tuple:
    """The placements of the gradient of a tensor placed by ``pl``: a
    ``Partial()`` term's gradient is the whole (replicated) gradient; on
    the mesh axes of more than one rank named in ``partial`` where ``pl``
    replicates, the rank's term of a sum (``Partial()``)."""
    from torch.distributed.tensor import Partial, Replicate

    def summed(m):
        return bool(partial) and mesh.mesh_dim_names[m] in partial and \
            mesh.size(m) > 1

    return tuple(Partial() if summed(m) and p.is_replicate() else
                 Replicate() if p.is_partial() else p
                 for m, p in enumerate(pl))


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


class _Redistribute(torch.autograd.Function):
    """``redistribute`` with its gradient: the incoming gradient
    redistributed to the input's placements."""

    @staticmethod
    def forward(ctx, x, target):
        ctx.placements, ctx.label = tuple(x.placements), _CTX.label
        return _move(x, target)

    @staticmethod
    def backward(ctx, g):
        with labelled(ctx.label):
            return redistribute(g, _grad_placements(ctx.placements)), None


def redistribute(x, target):
    """The DTensor ``x`` with placements ``target`` on its mesh: first each
    mesh dimension that changes is summed (Partial: ``all_reduce``, or
    ``reduce_scatter_tensor`` straight onto a split the target asks for),
    moves its split to the dimension the target splits
    (``all_to_all_single``, where no other mesh dimension's split stands
    in the way: ``_swaps``) or is gathered (Shard:
    ``all_gather_into_tensor``) over its group, the inner dimensions
    first; then each that the target splits takes the rank's chunk.  A
    mesh dimension of one rank moves nothing: its shard or its
    sum is the whole (with gloo, a collective of a CUDA tensor would cross
    the host even then).  Values as ``DTensor.redistribute``'s.  Under
    autograd its gradient is the incoming gradient redistributed to
    ``x``'s placements (a ``Partial()`` one's replicated), by the same
    collectives."""
    target = tuple(target)
    if tuple(x.placements) == target:
        return x
    if _needs_grad(x):
        return _Redistribute.apply(x, target)
    return _move(x, target)


def _move(x, target):
    """``redistribute``'s collectives, outside autograd."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    mesh = x.device_mesh
    cur = list(x.placements)
    t = x.to_local()
    coord = mesh.get_coordinate()
    for m in reversed(range(mesh.ndim)):
        p = cur[m]
        if mesh.size(m) == 1:  # one rank: its shard, or its sum, is whole
            cur[m] = target[m]
            continue
        if p == target[m] or p.is_replicate():
            continue
        if p.is_partial():
            if p != Partial():
                raise NotImplementedError(f"reducing {p}")
            d = target[m].dim % x.ndim if target[m].is_shard() else None
            if d is not None and _alone(cur, m, d, x.ndim) and _alone(
                    target, m, d, x.ndim):
                src = t.movedim(d, 0).contiguous()
                out = torch.empty((src.shape[0] // mesh.size(m),
                                   *src.shape[1:]), dtype=src.dtype,
                                  device=src.device)
                dist.reduce_scatter_tensor(out, src, group=mesh.get_group(m))
                note("reduce-scatter", out)
                t, cur[m] = out.movedim(0, d), target[m]
                continue
            t = t.contiguous().clone()
            dist.all_reduce(t, group=mesh.get_group(m))
            note("all-reduce", t)
        elif _swaps(cur, target, m, mesh, x.ndim):
            # the outer mesh dimensions that split the new dimension take
            # their chunk first, so that the all-to-all's split is inner
            b = target[m].dim % x.ndim
            for k in range(m):
                if cur[k] != target[k] and _splits(target[k], b, x.ndim):
                    t, cur[k] = t.chunk(mesh.size(k), dim=b)[coord[k]], \
                        target[k]
            t = _all_to_all(t, mesh, m, p.dim % x.ndim, b)
            cur[m] = target[m]
            continue
        else:  # Shard(d): gather along d
            d, n = p.dim % x.ndim, mesh.size(m)
            src = t.movedim(d, 0).contiguous()
            out = torch.empty((n * src.shape[0], *src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=mesh.get_group(m))
            note("all-gather", out)
            t = out.movedim(0, d)
        cur[m] = Replicate()
    for m in range(mesh.ndim):
        if target[m] != cur[m]:
            if not target[m].is_shard():
                raise NotImplementedError(f"redistributing to {target[m]}")
            d = target[m].dim % x.ndim
            t = t.chunk(mesh.size(m), dim=d)[coord[m]]
    return DTensor.from_local(t.contiguous(), mesh, target, run_check=False,
                              shape=x.shape,
                              stride=_contiguous_strides(x.shape))


def _splits(p, d: int, ndim: int) -> bool:
    """Whether the placement ``p`` splits tensor dimension ``d``."""
    return p.is_shard() and p.dim % ndim == d


def _swaps(cur, target, m: int, mesh, ndim: int) -> bool:
    """Whether mesh dimension m, splitting tensor dimension a in ``cur``
    and b in ``target``, can move its split by one all-to-all: it is the
    innermost split of a and of b (the inner mesh dimensions, handled
    already, split neither), no outer one splits b but as the target
    does, and those that split b only in the target replicate it now (they
    take their chunk first)."""
    p, q = cur[m], target[m]
    if not (p.is_shard() and q.is_shard()):
        return False
    a, b = p.dim % ndim, q.dim % ndim
    for k in range(len(cur)):
        if k == m or mesh.size(k) == 1:
            continue
        if k > m and (_splits(cur[k], a, ndim) or _splits(cur[k], b, ndim)):
            return False
        if k < m and cur[k] != target[k] and (
                _splits(cur[k], b, ndim) or _splits(target[k], b, ndim)
                and not cur[k].is_replicate()):
            return False
    return True


def _all_to_all(t, mesh, m: int, a: int, b: int):
    """The rank's shard ``t``, split over mesh dimension m along a, split
    along b instead: piece j of its b goes to rank j, and the pieces it
    receives, one a rank, are joined along a in rank order."""
    n = mesh.size(m)
    src = torch.stack(t.chunk(n, dim=b))
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.get_group(m))
    note("all-to-all", out)
    return torch.cat(out.unbind(0), dim=a)


def full(x, partial=()):
    """The whole tensor of a DTensor on every rank (``full_tensor()``,
    through ``redistribute``); anything else as it is.  Under autograd, as
    ``local``: on the mesh axes named in ``partial`` each rank's gradient
    is its term of a sum."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    return local(redistribute(x, [Replicate()] * x.device_mesh.ndim),
                 partial=partial)


def gathered(w):
    """A parameter with its FSDP split gathered: the mesh axes that the
    active rules give "embed_p" replicated, the others as they are (the
    weights' all-gather before a product, as XLA places it).  A split over
    a mesh axis of one rank is taken as replicated too (nothing moves):
    the rules keep such a split (one KV head over a one-rank "model"
    axis), and DTensor refuses to reshape a split dimension of size 1."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    fsdp = _CTX.rules.get("embed_p")
    fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp or ())
    mesh = w.device_mesh
    names = mesh.mesh_dim_names
    return redistribute(w, [
        Replicate() if names[m] in fsdp or mesh.size(m) == 1 else p
        for m, p in enumerate(w.placements)])


def whole_on_one_rank(x):
    """The DTensor ``x`` with its splits over mesh axes of one rank taken
    as replicated (nothing moves), as ``gathered`` takes a weight's: an
    activation split over a one-rank axis is made so before a product
    that contracts the split dimension with a gathered weight, which would
    otherwise make DTensor plan a split of the weight by itself.  Anything
    else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate

    mesh = x.device_mesh
    return redistribute(x, [Replicate() if mesh.size(m) == 1 else p
                            for m, p in enumerate(x.placements)])


def shard_axes(x, dim: int) -> tuple:
    """The names of the mesh dimensions that split dimension ``dim`` of the
    DTensor ``x``, in mesh order (none for a plain tensor)."""
    if not is_dtensor(x):
        return ()
    names = x.device_mesh.mesh_dim_names
    dim %= x.ndim
    return tuple(names[m] for m, p in enumerate(x.placements)
                 if p.is_shard() and p.dim % x.ndim == dim)


def local_offset(x, dim: int) -> int:
    """Where the rank's shard of the DTensor ``x`` starts along ``dim`` (0
    for a plain tensor or an unsplit dimension)."""
    axes = shard_axes(x, dim)
    if not axes:
        return 0
    mesh = x.device_mesh
    idx = 0
    for a in axes:
        idx = idx * mesh.size(mesh.mesh_dim_names.index(a)) + \
            mesh.get_local_rank(a)
    return idx * x.to_local().shape[dim]


def _all_reduce(t, axes, op, mesh=None):
    mesh = mesh if mesh is not None else _CTX.mesh
    for a in axes:
        if axis_sizes(mesh)[a] > 1:
            dist.all_reduce(t, op=op, group=mesh.get_group(a))
            note("all-reduce", t)
    return t


def _summed(axes, mesh=None):
    """The axes of ``axes`` with more than one rank on ``mesh`` (default:
    the active mesh)."""
    mesh = mesh if mesh is not None else _CTX.mesh
    sizes = axis_sizes(mesh) if mesh is not None else {}
    return tuple(a for a in axes if sizes.get(a, 1) > 1)


class _PSum(torch.autograd.Function):
    """All-reduce forward; the gradient passes as it is."""

    @staticmethod
    def forward(ctx, t, axes, mesh):
        return _all_reduce(t.clone(), axes, dist.ReduceOp.SUM, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _ReduceGrad(torch.autograd.Function):
    """The identity forward; the gradient all-reduced (the mesh kept: on a
    card the backward runs in autograd's own thread, where no sharding
    context is active)."""

    @staticmethod
    def forward(ctx, t, axes, mesh):
        ctx.axes, ctx.mesh, ctx.label = axes, mesh, _CTX.label
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        with labelled(ctx.label):
            return _all_reduce(g.clone(), ctx.axes, dist.ReduceOp.SUM,
                               ctx.mesh), None, None


def psum(t, axes, mesh=None):
    """Sum the plain tensor ``t`` over the ranks of ``axes`` of ``mesh``
    (default: the active mesh): the explicit all-reduce of a partial
    product, in place outside autograd.  Under autograd the sum is a new
    tensor and its gradient passes to each rank's term as it is
    (Megatron's g): every rank's consumers of the sum must be the same, so
    that the gradient that arrives is the whole one on every rank."""
    mesh = mesh if mesh is not None else _CTX.mesh
    axes = _summed(axes, mesh)
    if axes and _needs_grad(t):
        return _PSum.apply(t, axes, mesh)
    return _all_reduce(t, axes, dist.ReduceOp.SUM, mesh)


def reduce_grad(t, axes):
    """``t`` as it is, for a value that is the same on every rank of the
    active mesh's ``axes`` and that each rank uses for its own part of the
    work: under autograd its gradient, each rank's term, is summed over
    those ranks (Megatron's f)."""
    axes = _summed(axes)
    if axes and _needs_grad(t):
        return _ReduceGrad.apply(t, axes, _CTX.mesh)
    return t


def forbid_dtensor_collectives():
    """Make every collective of DTensor's own redistribution raise in this
    process (DTensor's functional collectives and its placements' scatter,
    broadcast and all-to-all): a guard for sharded runs, whose collectives
    all go through this module and whose DTensor operations are laid out
    to need none.  With torch 2.11 and gloo on an H100 host, DTensor's
    functional all-gather of a CUDA tensor ended the process, and DTensor
    reconciles mixed placements with a collective on one version where
    another changes a label locally."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def refuse(*a, **kw):
        raise AssertionError("a DTensor operation ran a collective of its "
                             "own redistribution")

    for mod, names in ((funcol, ("all_reduce", "all_gather_single",
                                 "all_gather_tensor", "reduce_scatter_single",
                                 "reduce_scatter_tensor",
                                 "all_to_all_single")),
                       (placement_types, ("shard_dim_alltoall", "mesh_scatter",
                                          "mesh_broadcast"))):
        for n in names:
            if hasattr(mod, n):
                setattr(mod, n, refuse)


def _watch_dtensor_plans(on_plan):
    """Call ``on_plan(by, current, target)`` before each redistribution
    DTensor plans by itself (its ``redistribute_local_tensor``), from here
    on: ``by`` is "op" where its op dispatch plans one for an operand, and
    "from_local/redistribute" for those transposes' gradients.  Returns the
    function that undoes it."""
    from torch.distributed.tensor import _api, _dispatch

    def watched(by, orig):
        def call(local, current, target, *a, **kw):
            on_plan(by, current, target)
            return orig(local, current, target, *a, **kw)
        return call

    # the op dispatch's must be there (no call must mean no plan)
    mods = [(_dispatch, "op")] + [
        (m, "from_local/redistribute") for m in (_api,)
        if hasattr(m, "redistribute_local_tensor")]
    originals = [m.redistribute_local_tensor for m, _ in mods]
    for (m, by), orig in zip(mods, originals):
        m.redistribute_local_tensor = watched(by, orig)

    def undo():
        for (m, _), orig in zip(mods, originals):
            m.redistribute_local_tensor = orig
    return undo


#: the redistributions DTensor planned by itself in this process since
#: ``forbid_dtensor_plans``, by "<by>: <placements> -> <placements>"
DTENSOR_PLANS: collections.Counter = collections.Counter()


def forbid_dtensor_plans():
    """Make every redistribution that DTensor plans by itself raise in this
    process, collective or not, after counting it in ``DTENSOR_PLANS``: a
    guard for sharded runs beside ``forbid_dtensor_collectives``.  A plan
    that is a local relabel on one torch version is a collective on
    another (an all-reduce on 2.11 where 2.13 relabels), so the models are
    laid out to need none, and every move goes through ``redistribute``."""
    def refuse(by, current, target):
        plan = (f"{by}: {tuple(current.placements)} -> "
                f"{tuple(target.placements)}")
        DTENSOR_PLANS[plan] += 1
        raise AssertionError(
            f"DTensor planned a redistribution of its own ({plan})")

    _watch_dtensor_plans(refuse)


def pmax(t, axes):
    """``psum``'s maximum, in place and without a gradient (the choices it
    serves, a softmax's shift and the position masks, take none)."""
    return _all_reduce(t, axes, dist.ReduceOp.MAX)


class _FromLocal(torch.autograd.Function):
    """``DTensor.from_local`` whose gradient is moved to the placements of
    ``_grad_placements`` by ``redistribute`` (not by DTensor's own
    collectives) before its local shard is handed back."""

    @staticmethod
    def forward(ctx, t, mesh, pl, shape, grad_pl):
        from torch.distributed.tensor import DTensor

        ctx.grad_pl, ctx.label = grad_pl, _CTX.label
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=_contiguous_strides(shape))

    @staticmethod
    def backward(ctx, g):
        with labelled(ctx.label):
            return (redistribute(g, ctx.grad_pl).to_local(), None, None,
                    None, None)


def wrap_local(t, mesh, pl, shape=None, partial_grad=()):
    """``DTensor.from_local(t, mesh, pl)`` (``t`` the rank's shard, which
    must split evenly where no ``shape`` is given).  Under autograd the
    gradient that comes back is redistributed to ``pl`` (a ``Partial()``
    placement's to the replicated gradient), except on the mesh axes
    named in ``partial_grad``, where ``t`` is the same on every rank but
    each rank's consumers of it differ: there the rank keeps its term."""
    from torch.distributed.tensor import DTensor

    pl = tuple(pl)
    if shape is None:
        shape = list(t.shape)
        for m, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim % t.dim()] *= mesh.size(m)
    shape = tuple(shape)
    if not _needs_grad(t):
        return DTensor.from_local(t, mesh, pl, run_check=False, shape=shape,
                                  stride=_contiguous_strides(shape))
    return _FromLocal.apply(t, mesh, pl, shape, _grad_placements(
        pl, mesh, partial_grad))


def from_local(t, shape, *logical, partial=(), partial_grad=()):
    """``t``, the rank's shard of a ``shape`` tensor laid out by the logical
    axes under the active mesh and rules, as a DTensor.  On the mesh axes
    named in ``partial`` it is instead a partial sum (``Partial()``): each
    rank holds a term, which the next ``constrain`` sums over those axes
    (``redistribute``: an all-reduce, or a reduce-scatter onto a split).
    Under autograd, ``wrap_local``'s gradient (``partial_grad``: the axes
    where each rank keeps its term of the gradient)."""
    from torch.distributed.tensor import Partial

    mesh = _CTX.mesh
    shape = tuple(shape)
    pl = list(placements(to_pspec(logical, shape=shape), mesh, shape))
    for m, name in enumerate(mesh.mesh_dim_names):
        if name in partial:
            if pl[m].is_shard():
                raise ValueError(f"mesh axis {name} both splits and sums a "
                                 f"{shape} tensor")
            pl[m] = Partial()
    return wrap_local(t, mesh, pl, shape, partial_grad)


def zeros(shape, dtype, logical, device):
    """A DTensor of zeros of ``shape``, laid out by the logical axes under
    the active mesh and rules, allocating only the rank's shard."""
    mesh = _CTX.mesh
    pl = placements(to_pspec(logical, shape=tuple(shape)), mesh, shape)
    local_shape = list(shape)
    for m, p in enumerate(pl):
        if p.is_shard():
            local_shape[p.dim] //= mesh.size(m)
    return from_local(torch.zeros(local_shape, dtype=dtype, device=device),
                      shape, *logical)
