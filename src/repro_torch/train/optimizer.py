"""AdamW with cosine schedule, global-norm clipping.

Port of ``repro.train.optimizer``: moments are f32 whatever the parameter
dtype; the update is computed in f32, in the reference's order of
operations, and cast back.  ``apply_updates`` writes the new parameters and
moments into the tensors it is given (the reference's jitted step donates
its state), so a step holds no second copy of the 12 bytes a parameter of
state; the tensors of the returned state are those of the one passed in.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.train.tree import leaves, map_tree


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
    zeros32 = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                    device=p.device)
    dev = leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=map_tree(zeros32, params), nu=map_tree(zeros32, params))


def schedule(cfg: OptConfig, step):
    """The learning rate at ``step`` (a number or an int tensor), in f32."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def global_norm(tree) -> torch.Tensor:
    total = 0
    for g in leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def apply_updates(params, grads, state: OptState, cfg: OptConfig,
                  ndims=None):
    """Returns (params, state, metrics); params and moments are updated in
    place (see the module's docstring).  Weight decay applies where a
    leaf's ``ndims`` entry (default: its own number of dimensions) is at
    least 2; the model's train step passes the reference tree's
    (``models.params.reference_ndims``)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = schedule(cfg, step).to(gnorm.device)
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    nd = ([p.dim() for p in leaves(params)] if ndims is None
          else leaves(ndims))
    for p, g, m, v, n in zip(leaves(params), leaves(grads), leaves(state.mu),
                             leaves(state.nu), nd, strict=True):
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
