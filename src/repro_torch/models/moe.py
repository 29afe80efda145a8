"""Mixture-of-Experts layer: GShard-style grouped capacity dispatch.

Port of ``repro.models.moe`` (``moe_specs``, ``_capacity``, ``moe``), in the
reference's literal one-hot form: the dispatch and combine are the same
einsums over the same (groups, group size, experts, capacity) tensors, so
the port keeps exactly the reference's (token, k) pairs.  One body serves
plain tensors and DTensors: a plain tensor is the one-rank case.

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
* Under a mesh (DTensor activations) each rank routes its batch rows'
  groups and runs the experts its shards of ``w_gate``, ``w_up`` and
  ``w_down`` hold; the partial sums over experts and FFN width meet in the
  output's constraint.  The expert all-to-all
  (``distributed/ep_a2a.py``) is not wired, as in the reference.
* Training under a mesh: the routing, the slots and the drops carry no
  gradient.  Each rank's gradients of the router, the experts' shards and
  its tokens are its rows' terms, summed over the batch axes by the
  gathers' transposes; the tokens and gate weights that enter the rank's
  experts take ``sharding.reduce_grad`` over the axes that split the
  experts or their width (each rank's experts give a term), while the aux
  loss's sum over the ranks (``psum``) hands every rank the whole
  gradient of its own terms.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed import sharding as sh
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
    gs = _group(B, S, group_size)
    xg = constrain(x.reshape((B * S) // gs, gs, M), "batch", None, None)
    return (xg, *_route_groups(xg, params["w_router"], cfg))


def _group(B: int, S: int, group_size: int) -> int:
    """The tokens a group: ``min(group_size, S)``, one at decode."""
    gs = 1 if S == 1 else min(group_size, S)  # decode: one token a group
    if (B * S) % gs:
        raise ValueError(f"B*S = {B * S} tokens do not fill groups of {gs}")
    return gs


def _route_groups(xg, w_router, cfg: ModelConfig):
    """``route`` on the groups xg (gr, gs, M) of one tensor: (probs, gate_w,
    ids, pos_k, keep, C)."""
    gr, gs, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    C = _capacity(gs, K, E)
    # bf16 operands, f32 product: the operands are rounded as the
    # reference rounds them, the product is not
    logits = xg.float() @ w_router.to(xg.dtype).float()
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
    return probs, gate_w, ids, pos_k, keep, C


def _combine(gate_w, ids, pos_k, keep, C: int, E: int, dt, experts: range):
    """The combine tensor (gr, gs, len(experts), C) of the experts in the
    range: sum_k gate_w_k * onehot(e_k) x onehot(c_k), the weight rounded
    to ``dt``."""
    eh = F.one_hot(ids, E)[..., experts.start:experts.stop]
    ch = F.one_hot(pos_k.clamp(0, C - 1), C).to(dt)
    return torch.einsum("gske,gskc->gsec",
                        eh.to(dt) * (gate_w * keep).to(dt)[..., None], ch)


def _experts(dispatch, combine, xg, w_gate, w_up, w_down):
    """SwiGLU over the dispatched tokens of the experts whose weights are
    given, combined: (gr, gs, M)."""
    dt = xg.dtype
    expert_in = torch.einsum("gsec,gsm->egcm", dispatch, xg)
    g = torch.einsum("egcm,emf->egcf", expert_in, w_gate.to(dt))
    u = torch.einsum("egcm,emf->egcf", expert_in, w_up.to(dt))
    h = F.silu(g) * u
    eo = torch.einsum("egcf,efm->egcm", h, w_down.to(dt))
    return torch.einsum("gsec,egcm->gsm", combine, eo)


def moe(params: dict, x, cfg: ModelConfig, group_size: int = 256):
    """x: (B, S, M) -> (y (B, S, M) in x's dtype, aux f32 scalar).

    On DTensors every rank routes the tokens of its batch rows (gathered
    over the sequence) and runs its own experts on them; on a plain tensor
    the one "rank" holds every row and every expert.  The tokens are also
    gathered over the batch axes that split the expert weights' FFN width
    (``DECODE_RULES`` puts ``expert_mlp`` on "data", where the batch lies
    too), so that a width split is a partial sum over the same tokens and
    never mixes rows of different ranks; and over every batch axis where a
    group of ``min(group_size, S)`` tokens would cross the ranks' rows.  So
    each rank takes the reference's groups, (token, k) pairs, slots and
    drops for its rows.  Its combined output is a partial sum over the axes
    that split the experts and the FFN width, reduced onto the residual's
    layout by its constraint; the shared expert is the dense MLP."""
    B, S, M = x.shape
    E = cfg.n_experts
    dt = x.dtype
    w = {n: sh.gathered(params[n]) for n in ("w_gate", "w_up", "w_down")}
    split = set(sh.shard_axes(w["w_gate"], 0) + sh.shard_axes(w["w_gate"], 2))
    xr = constrain(x, "batch", None, None)  # every row's whole sequence
    rows = sh.shard_axes(xr, 0)
    gs = _group(B, S, group_size)
    if rows and (split & set(rows) or sh.local(xr).shape[0] * S % gs):
        xr = constrain(xr, None, None, None)
        rows = ()
    xl = sh.local(xr)
    xg = xl.reshape(xl.shape[0] * S // gs, gs, M)
    # each rank routes its rows: the router's gradient is its rows' term
    router = sh.full(params["w_router"], partial=rows)
    probs, gate_w, ids, pos_k, keep, C = _route_groups(xg, router, cfg)

    # the Switch aux loss, E * sum_e(mean prob_e * top-1 share_e), over
    # every rank's groups; the sum's gradient reaches each rank's terms
    n = torch.tensor(float(xg.shape[0] * gs), device=xl.device)
    tot = torch.cat([probs.sum(dim=(0, 1)),
                     F.one_hot(ids[..., 0], E).float().sum(dim=(0, 1)), n[None]])
    tot = sh.psum(tot, rows)
    aux = E * torch.sum((tot[:E] / tot[-1]) * (tot[E:2 * E] / tot[-1]))

    # the tokens and the gate weights, the same on every rank of the axes
    # that split the experts, enter each rank's experts: their gradients,
    # each rank's term, are summed over those axes (the aux's and the
    # router's are whole on every rank already)
    xe, gate_w = (sh.reduce_grad(t, tuple(sorted(split)))
                  for t in (xg, gate_w))
    # the experts' shards, read for the rank's rows: their gradients are
    # the rows' terms, summed over the batch axes by the FSDP gather's
    wl = {k: sh.local(v, partial=rows) for k, v in w.items()}
    e0 = sh.local_offset(w["w_gate"], 0)
    combine = _combine(gate_w, ids, pos_k, keep, C, E, dt,
                       range(e0, e0 + wl["w_gate"].shape[0]))
    # dispatch is where combine > 0
    y = _experts((combine > 0).to(dt), combine, xe, wl["w_gate"],
                 wl["w_up"], wl["w_down"]).reshape(xl.shape)
    if sh.is_dtensor(x):
        y = sh.from_local(y, (B, S, M), "batch" if rows else None, None,
                          None, partial=split)
    y = constrain(y, "batch", "seq_sp", None)
    if "shared" in params:
        y = y + dense_mlp(params["shared"], x)
    return y, aux
