"""The plain reference's AdamW (Loshchilov and Hutter, arXiv:1711.05101)
with the program's stated schedule and clipping, in float32.

The settings are those of the program's ``TrainConfig`` defaults, stated
in the traffic file: learning rate 3e-4 under a linear warm-up of 100
steps and a cosine to 10% over 10,000, b1 0.9, b2 0.95, eps 1e-8, weight
decay 0.1, the gradients clipped to a global norm of 1.  The moments are
float32; each parameter is stored in its own dtype after every update (a
bf16 weight has the update rounded into it, as the program stores it; the
float32 norms, A_log, D and dt's bias stay float32).

Weight decay: every leaf but the final norm.  That is the program's stated
rule (decay where the leaf is a matrix in its stacked tree of layers, in
which every layer's leaf has one more dimension), not the usual practice
of sparing every norm and bias; the reference follows the program.
"""
from __future__ import annotations

import math

import torch


def lr_at(step: int, o: dict) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    prog = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    return o["lr"] * warm * (0.1 + 0.9 * 0.5 * (1.0 + math.cos(math.pi * prog)))


def decays(path) -> bool:
    return path != ("final_norm",)


class AdamW:
    """Moments over a flat list of (path, f32 parameter); ``stored`` lists
    the dtype each parameter is rounded to after an update."""

    def __init__(self, named, o: dict, stored: torch.dtype):
        self.named, self.o, self.stored, self.step = named, o, stored, 0
        self.m = [torch.zeros_like(p) for _, p in named]
        self.v = [torch.zeros_like(p) for _, p in named]

    @torch.no_grad()
    def update(self, grads):
        """One step; returns the clipped gradients as the update took
        them."""
        o = self.o
        self.step += 1
        norm = torch.sqrt(sum(torch.sum(g.square()) for g in grads))
        scale = min(o["clip_norm"] / (float(norm) + 1e-9), 1.0)
        lr = lr_at(self.step, o)
        b1c, b2c = 1 - o["b1"] ** self.step, 1 - o["b2"] ** self.step
        seen = []
        for (path, p), g, m, v, dt in zip(self.named, grads, self.m, self.v,
                                          self.stored):
            g = g * scale
            seen.append(g)
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g.square())
            delta = (m / b1c) / (torch.sqrt(v / b2c) + o["eps"])
            if decays(path):
                delta = delta + o["weight_decay"] * p
            p.copy_((p - lr * delta).to(dt).float())
        return seen
