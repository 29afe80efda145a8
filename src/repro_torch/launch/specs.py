"""Meta-tensor stand-ins and PartitionSpecs for every (arch x shape) cell.

Port of ``repro.launch.specs``.  ``build_lowerable`` returns, for one cell,
the step function (``make_train_step``, ``prefill`` or ``decode_step``,
wired as the reference wires them), its arguments as tensors on the meta
device (shape and dtype, no storage), and the trees of PartitionSpecs that
place them on a mesh, resolved shape-aware under the step's rule table.
The dry run (``launch/dryrun.py``) and the roofline read them.

The port's parameter and cache trees hold one entry per layer where the
reference stacks the layers of a period over a leading unnamed axis, so a
leaf's spec is the reference's without that leading ``None`` and the bytes
a device holds are the same.

The reference leaves the placement of most outputs to XLA's partitioner
(``out_shardings=None``).  The port states the placement it counts: the
train state as its input (donated), metrics replicated, logits over
("batch", "vocab") and a cache as the cache's logical axes.

The prefill and decode ``fn``s also run sharded, for every config, the
port's counterpart of ``jax.jit(low.fn, in_shardings=...)``: their
arguments placed on a live mesh by ``sharding.distribute(arg,
in_shardings[i], mesh)`` (parameters, the batch of ``_batch_sds`` with its
frames, vision embeddings and positions, and the cache; ``cache_len`` a
plain int) and called under ``sharding_ctx(mesh, low.rules)``; the logits
come back vocab-sharded as DTensors (``sharding.full`` gathers them) and
the cache as DTensors laid out by the rules.  So does the train ``fn``,
for every config: the state placed by ``in_shardings[0]``
(``train_loop.state_from_jax`` and ``init_state`` take the mesh and place
each leaf as it is made, the expert stacks and their moments included)
and the batch by ``in_shardings[1]`` (tokens or frames, the vision rows
and positions, the targets and the loss mask); it returns the new state
in the same layout and the metrics replicated, as plain tensors.  Its
``TrainConfig`` is the reference's: ``TRAIN_ACCUM`` microbatches for the
full configs (a reduced config's name ends in ``-reduced`` and takes
none), unless the caller passes its own ``tc``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from repro_torch.configs.base import (SHAPES, ModelConfig, ShapeConfig,
                                      shape_skip_reason)
from repro_torch.distributed import sharding as sh
from repro_torch.models import model as model_lib
from repro_torch.models.common import dtype_of
from repro_torch.models.params import spec_to_meta, spec_to_pspecs
from repro_torch.train import train_loop

# Room for the new token past the cached prefix; 16 keeps the cache length
# divisible by the "model" mesh axis so KV-sequence sharding applies.
DECODE_PAD = 16

# Microbatch (gradient-accumulation) factors for train_4k: the reference's
# values, so that both dry runs describe the same step.
TRAIN_ACCUM = {
    "jamba-v0.1-52b": 16,
    "gemma3-27b": 8,
    "falcon-mamba-7b": 8,
    "qwen2-moe-a2.7b": 8,
    "qwen3-moe-235b-a22b": 8,
    "qwen2-vl-7b": 2,
}

TRAIN_METRICS = ("aux", "grad_norm", "loss", "lr", "nll")


@dataclass
class Lowerable:
    """One (arch x shape) cell: the step, its arguments on the meta device
    with their specs, and its outputs on the meta device with the specs
    the dry run counts them under."""

    fn: Callable
    args: tuple  # meta tensors
    in_shardings: tuple  # PartitionSpec trees (None: replicated)
    outs: tuple  # meta tensors of the outputs
    out_shardings: tuple
    rules: dict
    donate_argnums: tuple = ()


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _batch_sds(cfg: ModelConfig, shape: ShapeConfig, step: str, rules, mesh):
    """(batch of meta tensors, their PartitionSpecs) for the step."""
    B, S = shape.global_batch, shape.seq_len
    i32, f32 = torch.int32, torch.float32
    dt = dtype_of(cfg)

    def bp(t, *names):
        return sh.to_pspec(names, rules=rules, mesh=mesh, shape=tuple(t.shape))

    if step == "decode":
        batch = {"tokens": _meta((B, 1), i32)}
        ps = {"tokens": bp(batch["tokens"], "batch", None)}
        if cfg.rope_kind == "mrope":
            batch["positions"] = _meta((B, 1, 3), i32)
            ps["positions"] = bp(batch["positions"], "batch", None, None)
        return batch, ps
    if cfg.frontend == "audio_frames":
        batch = {"frames": _meta((B, S, cfg.d_model), dt)}
        ps = {"frames": bp(batch["frames"], "batch", None, None)}
    else:
        batch = {"tokens": _meta((B, S), i32)}
        ps = {"tokens": bp(batch["tokens"], "batch", None)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = _meta((B, cfg.n_vision_tokens, cfg.d_model),
                                       dt)
        ps["vision_embeds"] = bp(batch["vision_embeds"], "batch", None, None)
        batch["positions"] = _meta((B, S, 3), i32)
        ps["positions"] = bp(batch["positions"], "batch", None, None)
    if step == "train":
        batch["targets"] = _meta((B, S), i32)
        batch["loss_mask"] = _meta((B, S), f32)
        ps["targets"] = bp(batch["targets"], "batch", None)
        ps["loss_mask"] = bp(batch["loss_mask"], "batch", None)
    return batch, ps


def _logits(cfg: ModelConfig, B: int, rules, mesh):
    """The (B, V) logits of prefill and decode, and their spec."""
    t = _meta((B, cfg.vocab_size), dtype_of(cfg))
    return t, sh.to_pspec(("batch", "vocab"), rules=rules, mesh=mesh,
                          shape=tuple(t.shape))


def build_lowerable(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    tc: Optional[train_loop.TrainConfig] = None) -> Lowerable:
    step = shape.step
    rules = sh.DECODE_RULES if step == "decode" else sh.TRAIN_RULES
    batch, batch_ps = _batch_sds(cfg, shape, step, rules, mesh)

    if step == "train":
        tc = tc or train_loop.TrainConfig(
            accum_steps=TRAIN_ACCUM.get(cfg.name, 1))
        state = train_loop.abstract_state(cfg)
        state_ps = train_loop.state_pspecs(cfg, rules=rules, mesh=mesh)
        metrics = {k: _meta((), torch.float32) for k in TRAIN_METRICS}
        return Lowerable(
            fn=train_loop.make_train_step(cfg, tc),
            args=(state, batch),
            in_shardings=(state_ps, batch_ps),
            outs=(state, metrics),
            out_shardings=(state_ps, {k: sh.PartitionSpec() for k in metrics}),
            rules=rules,
            donate_argnums=(0,),
        )

    params_spec = model_lib.abstract_params(cfg)
    params = spec_to_meta(params_spec)
    params_ps = spec_to_pspecs(params_spec, rules=rules, mesh=mesh)
    B = shape.global_batch

    if step == "prefill":
        # long sequence: sequence-parallel residual (TRAIN_RULES)
        def prefill_fn(params, batch):
            return model_lib.prefill(params, cfg, batch, max_len=shape.seq_len,
                                     device=params["embed"].device)

        logits, logits_ps = _logits(cfg, B, rules, mesh)
        if cfg.encoder_only:
            cache, cache_ps = None, None
        else:
            cache_spec = model_lib.cache_specs(cfg, B, shape.seq_len)
            cache = spec_to_meta(cache_spec)
            cache_ps = spec_to_pspecs(cache_spec, rules=rules, mesh=mesh)
        return Lowerable(
            fn=prefill_fn,
            args=(params, batch),
            in_shardings=(params_ps, batch_ps),
            outs=(logits, cache),
            out_shardings=(logits_ps, cache_ps),
            rules=rules,
        )

    # decode
    cache_spec = model_lib.cache_specs(cfg, B, shape.seq_len + DECODE_PAD)
    cache = spec_to_meta(cache_spec)
    cache_ps = spec_to_pspecs(cache_spec, rules=rules, mesh=mesh)

    def decode_fn(params, batch, cache, cache_len):
        return model_lib.decode_step(params, cfg, batch, cache, int(cache_len),
                                     device=params["embed"].device)

    logits, logits_ps = _logits(cfg, B, rules, mesh)
    return Lowerable(
        fn=decode_fn,
        args=(params, batch, cache, _meta((), torch.int32)),
        in_shardings=(params_ps, batch_ps, cache_ps, None),
        outs=(logits, cache),
        out_shardings=(logits_ps, cache_ps),
        rules=rules,
        donate_argnums=(2,),
    )


def cell_skip_reason(cfg: ModelConfig, shape_name: str) -> Optional[str]:
    return shape_skip_reason(cfg, SHAPES[shape_name])

