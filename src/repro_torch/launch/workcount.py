"""Rank 0's work in the dry run's executed step.

``count_work()`` is the context the dry run (``launch/dryrun.py``) runs a
cell's sharded step in, on the meta DTensors of a fake process group.  It
turns on ``WorkCounter``, a ``TorchDispatchMode`` that sees every op the
step executes, through autograd's backward and the per-layer remat
recomputation too, and keeps three totals of rank 0's work:

* FLOPs: each op of ``torch.utils.flop_counter.flop_registry`` evaluated
  on its local operands, plus each kernel call's ``cost`` FLOPs (the
  kernels' meta routes, ``kernels/_meta.py``).  An op on DTensors is
  passed to DTensor's dispatch, which runs it on the local shards (after
  any local chunking its strategy asks for) under this mode, so every op
  is counted at rank 0's size (``FlopCounterMode`` counts a DTensor at its
  global size); DTensor's shape propagation on fake tensors is not
  counted;
* bytes accessed: each executed op's operand and result local bytes, each
  distinct tensor once, excluding views, metadata ops, allocations and
  the collectives, plus each kernel call's ``cost`` bytes;
* peak temporaries: the peak of live local storage bytes above the
  arguments.  Each new storage an op returns is tracked and released
  through ``weakref.finalize``; views share their base's storage.

A pointwise op on meta operands skips its meta kernel, which for these ops
runs as Python (``torch._refs``, a few hundred microseconds a call, most
of the dry run's host time), where TensorIterator would lay its result out
contiguous: where each operand's strides fall with the dimension over the
dimensions it does not broadcast (``_pointwise``).  The result is then a
contiguous tensor of the broadcast shape, in the dtype that the same op
gives on one-element CPU operands of the same dtypes and ranks (0-dim or
not); tests/test_torch_dryrun_figures.py holds it to the meta kernels.

It also turns on ``sharding.recording()`` (the collectives, by the
reference's kinds) and ``kernels/_meta.recording()`` (the kernel calls),
and counts the collective ops it sees, so that the dry run can tell a
collective that bypassed ``sharding`` from none.  A collective of
DTensor's own redistribution (a functional collective, which the models
are laid out to need none of) is noted in the record too, by kind, and
counted under the DTensor op it served (``dtensor_collectives``), and
every redistribution DTensor plans by itself, collective or local, by the
op it served and the placements it moved between
(``dtensor_redistributions``): a plan that is a local relabel on one
torch version may be a collective on another.
"""
from __future__ import annotations

import collections
import weakref
from contextlib import contextmanager

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed import sharding as sh
from repro_torch.kernels import _meta

_aten = torch.ops.aten
#: ops that move no data: allocations, and aliases not marked as views
_NO_BYTES = {_aten.empty.memory_format, _aten.empty_strided.default,
             _aten.empty_like.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten._unsafe_view.default,
             _aten.lift_fresh.default, _aten.set_.source_Storage_storage_offset}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
#: DTensor's own collectives (``torch.distributed._functional_collectives``)
#: by the reference's kinds; their waits move nothing
_FUNCTIONAL = {"_c10d_functional::all_reduce": "all-reduce",
               "_c10d_functional::all_gather_into_tensor": "all-gather",
               "_c10d_functional::reduce_scatter_tensor": "reduce-scatter",
               "_c10d_functional::all_to_all_single": "all-to-all"}
#: pointwise ops whose result takes the broadcast shape of all their tensor
#: operands (``_pointwise``)
POINTWISE = {getattr(_aten, n) for n in (
    "abs", "add", "clamp", "clamp_max", "clamp_min", "cos", "div", "eq",
    "erf", "exp", "exp2", "ge", "gelu", "gelu_backward", "gt", "le", "log",
    "logical_and", "logical_not", "logical_or", "lt", "maximum", "minimum",
    "mul", "ne", "neg", "pow", "reciprocal", "rsqrt", "sigmoid",
    "sigmoid_backward", "silu", "silu_backward", "sin", "softplus",
    "softplus_backward", "sqrt", "square", "sub", "tanh", "tanh_backward",
    "where")}


def _local(x):
    """A DTensor's local shard; anything else as it is."""
    return getattr(x, "_local_tensor", x)


def _tensors(tree, out: list) -> list:
    """The tensors in an op's (nested list or tuple) arguments or results,
    appended to ``out``."""
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    return out


#: the dtype of a pointwise op, by the op, its tensor operands' dtypes and
#: whether each has dimensions, and the types of its other arguments
_DTYPES: dict = {}


def _broadcast(shapes):
    """The broadcast shape, or None where the shapes do not broadcast."""
    nd = max(len(s) for s in shapes)
    out = [1] * nd
    for s in shapes:
        for i, n in enumerate(s, nd - len(s)):
            if n != 1:
                if out[i] != 1 and out[i] != n:
                    return None
                out[i] = n
    return out


def _pointwise(func, args, kwargs):
    """The result of a pointwise op (``POINTWISE``, not in place) on meta
    operands without its meta kernel, where TensorIterator lays it out
    contiguous: each operand's strides strictly fall over its dimensions
    of more than one element that the result has too (a broadcast
    dimension, stride 0 or size 1, takes no part in TensorIterator's
    order).  A contiguous tensor of the broadcast shape, in the dtype of
    the op on one-element CPU operands; None where the op or its operands
    do not qualify, or where the operands do not broadcast or the op
    refuses them (then the meta kernel runs, and raises)."""
    if func._schema.is_mutable or "out" in kwargs:
        return None
    tensors, key = [], [func]
    for a in args:
        if isinstance(a, torch.Tensor):
            if type(a) is not torch.Tensor or not a.is_meta:
                return None
            tensors.append(a)
            key.append((a.dtype, a.dim() > 0))
        else:
            key.append(type(a))
    if not tensors:
        return None
    key.extend((k, type(v)) for k, v in kwargs.items())
    shape = _broadcast([t.shape for t in tensors])
    if shape is None:
        return None
    for t in tensors:
        off, last = len(shape) - t.dim(), None
        for i, (n, st) in enumerate(zip(t.shape, t.stride())):
            if n == 1 or st == 0 or shape[off + i] == 1:
                continue
            if last is not None and st >= last:
                return None
            last = st
    key = tuple(key)
    dtype = _DTYPES.get(key)
    if dtype is None:
        probe = [torch.ones((1,) * min(a.dim(), 1), dtype=a.dtype)
                 if isinstance(a, torch.Tensor) else a for a in args]
        try:
            dtype = _DTYPES[key] = func(*probe, **kwargs).dtype
        except (RuntimeError, NotImplementedError):
            return None  # the meta kernel says why
    return torch.empty(shape, dtype=dtype, device="meta")


class WorkCounter(TorchDispatchMode):
    """FLOPs, bytes accessed and peak temporaries of the ops run under it
    (see the module's docstring).  ``keep(tree)`` marks the arguments'
    storages, which are not temporaries."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.live = 0
        self.peak = 0
        self.collective_ops = collections.Counter()
        self.dtensor_collectives = collections.Counter()
        self.dtensor_redistributions = collections.Counter()
        self._dtensor_op = None
        self._kept: set = set()
        self._tracked: set = set()

    def keep(self, tree) -> None:
        from repro_torch.train.tree import leaves

        for t in leaves(tree):
            if isinstance(t, torch.Tensor):
                self._kept.add(id(_local(t).untyped_storage()))

    def _free(self, key: int, nbytes: int) -> None:
        self._tracked.discard(key)
        self.live -= nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            # DTensor's dispatch runs the op on the local shards (with any
            # local chunking its strategy asks for) under this mode
            self._dtensor_op = func.name()
            return NotImplemented
        kwargs = kwargs or {}
        out = None
        if func._overloadpacket in POINTWISE:
            out = _pointwise(func, args, kwargs)
        if out is None:
            out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            name = func.name()
            self.collective_ops[name] += 1
            if name in _FUNCTIONAL:  # DTensor's own, for the op it serves
                sh.note(_FUNCTIONAL[name], out)
                self.dtensor_collectives[self._dtensor_op] += 1
            return out
        operands = _tensors(args, _tensors(list(kwargs.values()), []))
        results = _tensors(out, [])
        if any(type(t) is not torch.Tensor for t in operands + results):
            return out  # DTensor's shape propagation on fake tensors
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not func.is_view and func not in _NO_BYTES:
            seen = set()
            for t in operands + results:
                if id(t) not in seen:
                    seen.add(id(t))
                    self.bytes += t.numel() * t.element_size()
        for t in results:
            st = t.untyped_storage()
            key = id(st)
            if key in self._tracked or key in self._kept:
                continue
            self._tracked.add(key)
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key, n)
        return out


@contextmanager
def _planned_redistributions(counter):
    """Count into ``counter.dtensor_redistributions`` each redistribution
    DTensor plans by itself inside: the ones its op dispatch plans for an
    operand, under the op it served, and its ``from_local``/``redistribute``
    transposes' (``sharding._watch_dtensor_plans``)."""
    def count(by, current, target):
        op = counter._dtensor_op if by == "op" else by
        counter.dtensor_redistributions[
            f"{op}: {tuple(current.placements)} -> "
            f"{tuple(target.placements)}"] += 1

    undo = sh._watch_dtensor_plans(count)
    try:
        yield
    finally:
        undo()


@contextmanager
def count_work(args=()):
    """Count rank 0's work inside; yields a dict that holds, on leaving,
    "flops", "bytes_accessed", "temp_size_in_bytes", "collectives" (the
    reference's ``{kind: {"count", "bytes"}, "total_bytes"}``),
    "kernel_calls" (``_meta.Call``s), "collective_ops" (the collective ops
    seen, by name), "dtensor_collectives" (DTensor's own, by the op they
    served), "dtensor_redistributions" (the redistributions DTensor
    planned by itself, by the op and placements) and
    "labelled_collectives" (``sharding.recording``'s calls: {label:
    ["<kind> <result>", ...]}).  ``args``: the step's arguments, whose
    storages are not temporaries."""
    res: dict = {}
    counter = WorkCounter()
    counter.keep(args)
    by_label: dict = {}
    with sh.recording(by_label) as coll, _meta.recording() as calls, \
            _planned_redistributions(counter), counter:
        yield res
    coll["total_bytes"] = sum(v["bytes"] for v in coll.values())
    res.update(
        flops=counter.flops + sum(c.flops for c in calls),
        bytes_accessed=counter.bytes + sum(c.bytes for c in calls),
        temp_size_in_bytes=counter.peak, collectives=coll,
        kernel_calls=calls, collective_ops=counter.collective_ops,
        dtensor_collectives=dict(counter.dtensor_collectives),
        dtensor_redistributions=dict(counter.dtensor_redistributions),
        labelled_collectives=by_label)
