"""AdamW with cosine schedule, global-norm clipping.

Port of ``repro.train.optimizer``: moments are f32 whatever the parameter
dtype; the update is computed in f32, in the reference's order of
operations, and cast back.  ``apply_updates`` writes the new parameters and
moments into the tensors it is given (the reference's jitted step donates
its state), so a step holds no second copy of the 12 bytes a parameter of
state; the tensors of the returned state are those of the one passed in.

The update runs over each leaf in pieces of at most ``UPDATE_CHUNK``
elements (flat views of the parameter and its moments, written in place):
its f32 temporaries take a few times a piece instead of a few times the
largest leaf (gemma3-27b's 1.4e9-entry embedding would need about 28 GB of
them), and every entry's arithmetic is the same.

Sharded (DTensor leaves, the gradients in the parameters' placements), the
moments and the update are elementwise on each rank's local shards, and
``step`` is replicated.  The clip norm is the whole tree's: each leaf sums
the squares of its local shard, and those sums are added over the mesh
axes that split the leaf (a replicated leaf counts once).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.distributed import sharding as sh
from repro_torch.train.tree import leaves, map_tree


# entries of a leaf updated at a time (see the module's docstring)
UPDATE_CHUNK = 1 << 24


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


class OptState(NamedTuple):
    step: torch.Tensor  # () int32
    mu: dict
    nu: dict


def init_state(params) -> OptState:
    """Zero moments in f32 (a DTensor parameter's laid out as it is, each
    rank allocating its shard) and step 0 (replicated where the parameters
    are DTensors)."""
    zeros32 = lambda p: torch.zeros_like(  # noqa: E731
        p, dtype=torch.float32, requires_grad=False)
    first = leaves(params)[0]
    step = torch.zeros((), dtype=torch.int32, device=first.device)
    if sh.is_dtensor(first):
        from torch.distributed.tensor import Replicate

        step = sh.wrap_local(step, first.device_mesh,
                             [Replicate()] * first.device_mesh.ndim)
    return OptState(step=step, mu=map_tree(zeros32, params),
                    nu=map_tree(zeros32, params))


def schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (a number or an int tensor), in f32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    """The square root of the sum of every leaf's squares, in f32.  A
    DTensor leaf's local sum is added over the mesh axes that split it
    (one all-reduce for each set of axes; a replicated leaf counts once),
    and a plain tensor comes back, the same on every rank; a ``Partial()``
    leaf raises (constrain the gradients to the parameters' layout
    first)."""
    total, split = 0, {}
    for g in leaves(tree):
        if not sh.is_dtensor(g):
            total = total + torch.sum(torch.square(g.float()))
            continue
        if any(p.is_partial() for p in g.placements):
            raise ValueError(f"a partial sum {g.placements} has no norm yet")
        mesh = g.device_mesh
        axes = tuple(mesh.mesh_dim_names[m] for m, p in enumerate(g.placements)
                     if p.is_shard())
        split.setdefault((mesh, axes), []).append(
            torch.sum(torch.square(sh.local(g).float())))
    for (mesh, axes), sums in split.items():
        total = total + sh.psum(torch.stack(sums), axes, mesh=mesh).sum()
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


def _pieces(p, g, m, v):
    """(p, g, m, v) in pieces of at most ``UPDATE_CHUNK`` entries: flat
    views of p, m and v (which the update writes), and g's entries alike;
    the whole leaf where it is smaller or p, m or v is not contiguous."""
    n = p.numel()
    if n <= UPDATE_CHUNK or not all(t.is_contiguous() for t in (p, m, v)):
        yield p, g, m, v
        return
    flat = [p.view(-1), g.reshape(-1), m.view(-1), v.view(-1)]
    for s in range(0, n, UPDATE_CHUNK):
        yield tuple(t[s:s + UPDATE_CHUNK] for t in flat)


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig,
                  ndims=None):
    """Returns (params, state, metrics); params and moments are updated in
    place (see the module's docstring).  Weight decay applies where a
    leaf's ``ndims`` entry (default: its own number of dimensions) is at
    least 2; the model's train step passes the reference tree's
    (``models.params.reference_ndims``)."""
    step = state.step + 1  # a replicated DTensor stays one
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, sh.local(step)).to(gnorm.device)
    b1c = 1.0 - cfg.b1 ** sh.local(step).float()
    b2c = 1.0 - cfg.b2 ** sh.local(step).float()
    nd = ([p.dim() for p in leaves(params)] if ndims is None
          else leaves(ndims))
    for p, g, m, v, n in zip(leaves(params), leaves(grads), leaves(state.mu),
                             leaves(state.nu), nd, strict=True):
        if sh.is_dtensor(p):  # elementwise on the rank's shards
            if not all(t.placements == p.placements for t in (g, m, v)):
                raise ValueError(
                    f"a parameter {p.placements}, its gradient "
                    f"{g.placements} and moments {m.placements}, "
                    f"{v.placements} are laid out unlike")
            p, g, m, v = (sh.local(t) for t in (p, g, m, v))
        for p, g, m, v in _pieces(p, g, m, v):
            g32 = g.float() * scale
            m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g32)
            v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g32))
            mhat = m / b1c
            vhat = v / b2c
            delta = mhat / (torch.sqrt(vhat) + cfg.eps)
            # decoupled weight decay on matrices only (ndim >= 2)
            if n >= 2:
                delta = delta + cfg.weight_decay * p.float()
            p.copy_(p.float() - lr * delta)
    return params, OptState(step, state.mu, state.nu), {"grad_norm": gnorm,
                                                        "lr": lr}
