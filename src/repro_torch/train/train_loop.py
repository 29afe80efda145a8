"""Train step: gradient accumulation, remat, optional int8 gradient
compression.

Port of ``repro.train.train_loop``.  ``make_train_step`` returns a
(state, batch) -> (state, metrics) function; the state lies on one device
(default cuda) and is updated in place (the reference's jitted step donates
it).  Gradients are taken with ``torch.autograd.grad`` of
``model.train_loss``: on a card its attention and Mamba layers run the
forward kernels with hand-written backward kernels as their gradients.
AdamW decays the leaves that are matrices in the reference's tree, where
every layer of the scanned stack has one more (stacked) dimension
(``models.params.reference_ndims``).  With ``accum_steps`` > 1 the batch's
leading axis is cut into that many
microbatches whose gradients are summed in f32 and divided, as the
reference's scan does.  The step constrains the gradients to the
parameters' logical axes (``params.constrain_like``, a no-op without a
mesh), ``state_pspecs`` resolves the state's partition specs under a
rule table and a mesh, and ``abstract_state`` gives the state as meta
tensors (shape and dtype, no storage), as the reference's do.

Sharded (the state's leaves DTensors placed by ``state_pspecs``, the batch
placed by the batch specs or given whole, the step called under
``sharding_ctx(mesh, rules)``; ``launch/specs.py::build_lowerable`` gives
both), the same step runs on each rank's shards: FSDP over "data" and
tensor parallelism over "model" in the forward and backward passes, each
microbatch's gradients constrained to the parameters' layout as they come
(a sum over the batch axes reduce-scattered onto the FSDP split), the clip
norm taken over the whole tree, and the update on each rank's shards, for
every config.  Accumulation cuts the *global* batch as the reference
does: microbatch j is the reference's rows [j B/n, (j+1) B/n), split over
the batch axes.  The metrics come back as
plain tensors, the same on every rank.  ``init_state`` and
``state_from_jax`` take a mesh and place each leaf as it is made.  The
step function's ``grad_hook``, None by default, is called with the
gradients before clipping (a test hook).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve
from repro_torch.distributed import grad_compress
from repro_torch.distributed import sharding as sh
from repro_torch.distributed.sharding import PartitionSpec
from repro_torch.models import model as model_lib
from repro_torch.models import params as params_lib
from repro_torch.train import optimizer as opt_lib
from repro_torch.train.tree import leaves, map_tree, unflatten


@dataclass(frozen=True)
class TrainConfig:
    accum_steps: int = 1
    remat: bool = True
    compress_grads: bool = False  # int8 + error feedback (numerics-faithful)
    opt: opt_lib.OptConfig = field(default_factory=opt_lib.OptConfig)


class TrainState(NamedTuple):
    params: dict
    opt: opt_lib.OptState


def _trainable(params):
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def init_state(cfg: ModelConfig, generator: torch.Generator,
               device=None, mesh=None, rules=None) -> TrainState:
    """Random parameters (``models.params.init_params``) on ``device``
    (default cuda), drawn from ``generator``, with zero moments.  With
    ``mesh`` each leaf is placed by ``state_pspecs(cfg, rules, mesh)`` as it
    is drawn: every rank draws the same values and keeps its shards."""
    params = _trainable(params_lib.init_params(
        cfg, generator, device=resolve(device), mesh=mesh, rules=rules))
    return TrainState(params=params, opt=opt_lib.init_state(params))


def state_from_jax(cfg: ModelConfig, jax_state, device=None, mesh=None,
                   rules=None) -> TrainState:
    """The port's state from a reference ``TrainState`` whose leaves are
    numpy arrays: params, mu and nu through ``from_jax_params``, and the
    step.  With ``mesh`` the leaves are made on the host and each is
    placed by ``state_pspecs(cfg, rules, mesh)`` on ``device`` as it is
    made, so that the device holds only the rank's shards."""
    dev = resolve(device)
    if mesh is None:
        tree = lambda t: params_lib.from_jax_params(  # noqa: E731
            cfg, t, device=dev)
        step = torch.as_tensor(np.array(jax_state.opt.step),
                               dtype=torch.int32, device=dev)
    else:
        specs = state_pspecs(cfg, rules=rules, mesh=mesh)
        tree = lambda t: sh.distribute(  # noqa: E731
            params_lib.from_jax_params(cfg, t, device="cpu"), specs.params,
            mesh, in_place=True)
        step = sh.distribute(torch.as_tensor(np.array(jax_state.opt.step),
                                             dtype=torch.int32),
                             specs.opt.step, mesh)
    opt = jax_state.opt
    return TrainState(params=_trainable(tree(jax_state.params)),
                      opt=opt_lib.OptState(step=step, mu=tree(opt.mu),
                                           nu=tree(opt.nu)))


def abstract_state(cfg: ModelConfig) -> TrainState:
    """The train state on the meta device: the parameters in their dtypes,
    f32 moments and an int32 step (the reference's ``abstract_state``)."""
    params = params_lib.spec_to_meta(params_lib.param_specs(cfg))
    f32 = lambda p: torch.empty(p.shape, dtype=torch.float32,  # noqa: E731
                                device="meta")
    return TrainState(params=params, opt=opt_lib.OptState(
        step=torch.empty((), dtype=torch.int32, device="meta"),
        mu=map_tree(f32, params), nu=map_tree(f32, params)))


def state_pspecs(cfg: ModelConfig, rules=None, mesh=None) -> TrainState:
    """The state's tree of PartitionSpecs: each parameter's, the same for
    its two moments, and a replicated step."""
    pp = params_lib.spec_to_pspecs(params_lib.param_specs(cfg), rules=rules,
                                   mesh=mesh)
    return TrainState(params=pp, opt=opt_lib.OptState(
        step=PartitionSpec(), mu=pp, nu=pp))


def _to_device(batch: dict, dev) -> dict:
    """The batch's entries as tensors on ``dev``; DTensors as they are."""
    return {k: v if sh.is_dtensor(v) else torch.as_tensor(
        np.asarray(v) if not torch.is_tensor(v) else v, device=dev)
        for k, v in batch.items()}


def _microbatch(batch: dict, n: int, j: int) -> dict:
    """Rows [j B/n, (j+1) B/n) of every entry of the global batch; a
    DTensor's gathered first and the rows placed again by the batch axes
    under the active rules (split over them where they divide)."""
    out = {}
    for k, v in batch.items():
        rows = sh.full(v)
        rows = rows.reshape(n, rows.shape[0] // n, *rows.shape[1:])[j]
        if sh.is_dtensor(v):
            rows = sh.distribute(rows, sh.to_pspec(
                ("batch",) + (None,) * (rows.dim() - 1),
                shape=tuple(rows.shape)), v.device_mesh)
        out[k] = rows
    return out


def make_train_step(cfg: ModelConfig, tc: TrainConfig):
    """The (state, batch) -> (state, metrics) step; see the module's
    docstring."""
    ndims = None  # the reference's number of dimensions of each leaf
    param_specs = params_lib.param_specs(cfg)

    def loss_fn(params, batch):
        dev = leaves(params)[0].device
        return model_lib.train_loss(params, cfg, batch, remat=tc.remat,
                                    device=dev)

    def grad_leaves(params, batch):
        """(loss, metrics, gradients of the leaves of params, in the
        parameters' layout)."""
        ps = leaves(params)
        loss, metrics = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, ps, allow_unused=True)
        # a leaf the loss does not read (the audio frontend's embedding)
        # has a zero gradient, as jax.grad gives it
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        # keep the gradients in the parameters' layout
        grads = leaves(params_lib.constrain_like(unflatten(params, grads),
                                                 param_specs))
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def grads_of(params, batch):
        if tc.accum_steps <= 1:
            loss, metrics, grads = grad_leaves(params, batch)
            return loss, metrics, unflatten(params, grads)
        # microbatch accumulation: split the global batch's leading axis
        n = tc.accum_steps
        acc = [torch.zeros_like(p, dtype=torch.float32, requires_grad=False)
               for p in leaves(params)]
        loss_sum = torch.zeros((), dtype=torch.float32,
                               device=sh.local(acc[0]).device)
        for j in range(n):
            loss, _, g = grad_leaves(params, _microbatch(batch, n, j))
            for a, gi in zip(acc, g):
                a.add_(gi.float())
            loss_sum = loss_sum + loss
        grads = unflatten(params, [a / n for a in acc])
        return loss_sum / n, {"nll": loss_sum / n,
                              "aux": torch.zeros_like(loss_sum)}, grads

    def train_step(state: TrainState, batch: dict):
        nonlocal ndims
        if ndims is None:
            ndims = params_lib.reference_ndims(cfg, state.params)
        dev = leaves(state.params)[0].device
        loss, metrics, grads = grads_of(state.params, _to_device(batch, dev))
        if train_step.grad_hook is not None:
            train_step.grad_hook(grads)
        if tc.compress_grads:
            grads = map_tree(lambda g: grad_compress.decompress(
                *grad_compress.compress(g), dtype=g.dtype), grads)
        new_params, new_opt, om = opt_lib.apply_updates(
            state.params, grads, state.opt, tc.opt, ndims)
        metrics = dict(metrics, loss=loss, **om)
        return TrainState(new_params, new_opt), metrics

    train_step.grad_hook = None
    return train_step


def instrument_step(step_fn, name: str = "train.step", tokens_per_step: int = 0):
    """Wrap a ``(state, batch) -> (state, metrics)`` step with
    ``repro_torch.obs`` telemetry: a fenced span (``torch.cuda.synchronize``
    where the step's outputs lie on a card: launches return before the card
    is done) feeding a step-time histogram and throughput counters.  With
    telemetry disabled the wrapper neither fences nor records."""
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import tracing as obs_tracing

    def wrapped(state, batch):
        with obs_tracing.fenced_span(name, cat="train") as sp:
            state, metrics = step_fn(state, batch)
            sp((state, metrics))
        if obs_metrics.enabled():
            obs_metrics.histogram(f"{name}.seconds").record(sp.dur_s)
            obs_metrics.counter(f"{name}.count").inc()
            if tokens_per_step:
                obs_metrics.counter(f"{name}.tokens").inc(tokens_per_step)
        return state, metrics

    return wrapped
