"""The DTensor boundary of the kernel wrappers.

Under a mesh of several devices the model hands the wrappers DTensors.  A
kernel takes raw pointers, so it runs on each rank's local shard: that is
right only where the shards split dimensions the kernel treats
independently (batch and heads for attention, batch and the inner channels
for the scan), and split them alike in every argument.  ``on_shards``
checks exactly that, calls the wrapper on the ``to_local()`` shards (the
kernel on a card, its plain version on the CPU) and wraps each output with
``DTensor.from_local``.  Any other placement raises: no argument is
gathered to a full tensor, and nothing falls back.  The launch counters
count each rank's launches.

Under autograd the wrapper's own gradient (``FlashAttentionFn``,
``SSMScanFn``: the backward kernels on a card) runs on the same shards,
and the gradients go back through ``sharding.local`` and
``sharding.wrap_local``, never through DTensor's redistribution: each
output's gradient is moved to the output's placements, and an argument's
gradient is the rank's shard of the whole one, or, for an argument
replicated over a mesh dimension that splits the work (the scan's C over
the inner channels), the rank's term of a sum (``Partial()``).
"""
from __future__ import annotations


def any_dtensor(*tensors) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in tensors)


def _dim_of(shards: dict, role: str):
    return next((d for d, r in shards.items() if r == role), None)


def on_shards(name: str, fn, args, shards, out_shards):
    """fn(*local shards) wrapped back into DTensors.

    ``args``: the wrapper's tensor arguments (None where absent), all
    DTensors on one mesh; ``shards``: for each, {tensor dim: role} of the
    dims the kernel treats independently; ``out_shards``: one such dict for
    a single output, or a tuple of them, one per output.  Each mesh
    dimension may shard one role, and then shards it in every argument that
    has it and leaves the others replicated.  A mesh dimension of one rank
    splits nothing (each rank's shard is the whole there, whatever the
    placement: a dimension of size 1 is not split, its neighbours may be),
    and the outputs are replicated over it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    present = [(a, s) for a, s in zip(args, shards, strict=True)
               if a is not None]
    if not all(isinstance(a, DTensor) for a, _ in present):
        raise ValueError(f"{name}: DTensor and plain tensor arguments mixed")
    mesh = present[0][0].device_mesh
    roles = [None] * mesh.ndim
    for a, s in present:
        if a.device_mesh != mesh:
            raise ValueError(f"{name}: arguments on different meshes")
        for m, p in enumerate(a.placements):
            if p.is_replicate() or mesh.size(m) == 1:
                continue
            dim = p.dim % a.ndim if p.is_shard() else None
            if dim not in s or a.shape[dim] % mesh.size(m):
                raise NotImplementedError(
                    f"{name}: placement {p} on mesh dimension {m} of a "
                    f"{tuple(a.shape)} argument; the kernel runs on even "
                    f"shards of {sorted(set(s.values()))} only")
            if roles[m] not in (None, s[dim]):
                raise NotImplementedError(
                    f"{name}: mesh dimension {m} shards both {roles[m]} and "
                    f"{s[dim]}")
            roles[m] = s[dim]
    for a, s in present:
        for m, role in enumerate(roles):
            if mesh.size(m) == 1:  # one rank: its shard is the whole
                continue
            want = None if role is None else _dim_of(s, role)
            p = a.placements[m]
            ok = p == Shard(want) if want is not None else p.is_replicate()
            if not ok:
                raise NotImplementedError(
                    f"{name}: mesh dimension {m} shards {role}, but a "
                    f"{tuple(a.shape)} argument has {p} there")
    from repro_torch.distributed import sharding as sh

    split = tuple(n for n, role in zip(mesh.mesh_dim_names, roles)
                  if role is not None)
    out = fn(*(None if a is None else sh.local(a, partial=split)
               for a in args))

    def wrap(t, s):
        pl = [Replicate()] * mesh.ndim
        for m, role in enumerate(roles):
            if role is not None:
                pl[m] = Shard(_dim_of(s, role))
        return sh.wrap_local(t, mesh, pl)

    if isinstance(out_shards, dict):
        return wrap(out, out_shards)
    return tuple(wrap(t, s) for t, s in zip(out, out_shards, strict=True))
