"""Mixture-of-Experts layer: GShard-style grouped capacity dispatch.

Port of ``repro.models.moe`` (``moe_specs``, ``_capacity``, ``moe``), in the
reference's literal one-hot form: the dispatch and combine are the same
einsums over the same (groups, group size, experts, capacity) tensors, so
the port keeps exactly the reference's (token, k) pairs, with its sharding
constraints at the same sites (moe.py:60, 93-106; no-ops without a mesh).

* Groups: the B * S tokens are flattened and cut into groups of
  ``min(group_size, S)`` (1 at decode), so a group may span two batch rows.
  Where B * S is not a multiple of the group, the reference's reshape fails;
  the port raises ``ValueError``.
* Router: the logits are the product of x and the router weights rounded to
  x's dtype, kept in f32 (the reference's ``preferred_element_type``); a
  bf16 matmul would round them to bf16 and change which experts win.  Top-K
  puts the lower expert first among equal probabilities, as
  ``jax.lax.top_k`` does, by a stable descending sort (``torch.topk`` does
  not promise that order).
* Drops: a (token, k) pair's slot is its rank among its group's pairs that
  chose the same expert, token-major then k-minor; it is kept iff
  slot < C and its gate weight > 0.
* Experts: SwiGLU in x's dtype over (E, groups, C, M); the shared expert is
  the dense ``mlp`` over the same input, added after the combine.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import constrain
from repro_torch.models.mlp import mlp as dense_mlp


def moe_specs(cfg: ModelConfig) -> dict:
    """{leaf: (shape, init, dtype name, logical axes)} of one MoE MLP, the
    reference's; ``shared`` is a dict of its own where the config has shared
    experts."""
    M, E, F_ = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
    pd = cfg.param_dtype
    ex = ("experts", "embed_p", "expert_mlp")
    specs = {
        "w_router": ((M, E), "dense", "float32", ("embed_p", None)),
        "w_gate": ((E, M, F_), "dense", pd, ex),
        "w_up": ((E, M, F_), "dense", pd, ex),
        "w_down": ((E, F_, M), "dense", pd,
                   ("experts", "expert_mlp", "embed_p")),
    }
    if cfg.n_shared_experts:
        Fs = cfg.n_shared_experts * cfg.d_ff_expert
        specs["shared"] = {
            "w_gate": ((M, Fs), "dense", pd, ("embed_p", "mlp")),
            "w_up": ((M, Fs), "dense", pd, ("embed_p", "mlp")),
            "w_down": ((Fs, M), "dense", pd, ("mlp", "embed_p")),
        }
    return specs


def _capacity(gs: int, k: int, e: int, factor: float = 1.25) -> int:
    c = int(-(-gs * k * factor // e))
    return max(4, -(-c // 4) * 4) if gs > 1 else max(1, c)


def route(params: dict, x, cfg: ModelConfig, group_size: int = 256):
    """The router of ``moe``: x (B, S, M) ->

    ``xg`` (gr, gs, M), ``probs`` (gr, gs, E) f32, ``gate_w`` (gr, gs, K)
    f32 renormalised, ``ids`` (gr, gs, K) int64, ``pos_k`` (gr, gs, K) each
    pair's slot in its expert, ``keep`` (gr, gs, K) f32 and C."""
    B, S, M = x.shape
    E, K = cfg.n_experts, cfg.top_k
    gs = 1 if S == 1 else min(group_size, S)  # decode: one token a group
    if (B * S) % gs:
        raise ValueError(f"B*S = {B * S} tokens do not fill groups of {gs}")
    gr = (B * S) // gs
    C = _capacity(gs, K, E)
    xg = constrain(x.reshape(gr, gs, M), "batch", None, None)

    # bf16 operands, f32 product: the operands are rounded as the
    # reference rounds them, the product is not
    logits = xg.float() @ params["w_router"].to(x.dtype).float()
    probs = torch.softmax(logits, dim=-1)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, ids = srt[..., :K], order[..., :K]
    gate_w = gate_w / torch.clamp(gate_w.sum(-1, keepdim=True), min=1e-9)

    # the slot of each (token, k) within its expert, per group
    oh = F.one_hot(ids.reshape(gr, gs * K), E).to(torch.int32)  # (gr, T, E)
    pos = torch.cumsum(oh, dim=1) - 1
    pos_k = torch.gather(pos, 2, ids.reshape(gr, gs * K, 1))[..., 0]
    pos_k = pos_k.reshape(gr, gs, K)
    keep = (pos_k < C).float() * (gate_w > 0).float()
    return xg, probs, gate_w, ids, pos_k, keep, C


def moe(params: dict, x, cfg: ModelConfig, group_size: int = 256):
    """x: (B, S, M) -> (y (B, S, M) in x's dtype, aux f32 scalar)."""
    B, S, M = x.shape
    E = cfg.n_experts
    dt = x.dtype
    xg, probs, gate_w, ids, pos_k, keep, C = route(params, x, cfg, group_size)
    # the Switch aux loss: E * sum_e(mean prob_e * top-1 share_e)
    me = probs.mean(dim=(0, 1))
    ce = F.one_hot(ids[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce)

    # combine (gr, gs, E, C): sum_k gate_w_k * onehot(e_k) x onehot(c_k),
    # the weight rounded to x's dtype; dispatch is where combine > 0
    eh = F.one_hot(ids, E).to(dt)
    ch = F.one_hot(pos_k.clamp(0, C - 1), C).to(dt)
    combine = torch.einsum("gske,gskc->gsec",
                           eh * (gate_w * keep).to(dt)[..., None], ch)
    dispatch = (combine > 0).to(dt)
    combine = constrain(combine, "batch", None, "experts", None)
    dispatch = constrain(dispatch, "batch", None, "experts", None)

    expert_in = torch.einsum("gsec,gsm->egcm", dispatch, xg)
    expert_in = constrain(expert_in, "experts", "batch", None, None)
    g = torch.einsum("egcm,emf->egcf", expert_in, params["w_gate"].to(dt))
    u = torch.einsum("egcm,emf->egcf", expert_in, params["w_up"].to(dt))
    h = F.silu(g) * u
    eo = torch.einsum("egcf,efm->egcm", h, params["w_down"].to(dt))
    eo = constrain(eo, "experts", "batch", None, None)
    y = torch.einsum("gsec,egcm->gsm", combine, eo)
    y = constrain(y.reshape(B, S, M), "batch", "seq_sp", None)

    if "shared" in params:
        y = y + dense_mlp(params["shared"], x)
    return y, aux
