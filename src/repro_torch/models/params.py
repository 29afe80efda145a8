"""Decoder parameters: random init on a device, and import of the reference's.

Port of ``repro.models.params`` for attention and Mamba layers with a dense
MLP, an MoE MLP or none.  The port keeps one dict per layer instead of the
reference's stacked ``stack/body`` arrays:

  {"embed": (V, M), "layers": [layer, ...], "final_norm": (M,),
   "unembed": (M, V)}                      # no "unembed" when embeddings tie
  attention layer = {"ln1": (M,), "attn": {"wq": (M, H, D), "wk": (M, Hkv, D),
           "wv": (M, Hkv, D), "wo": (H, D, M), "q_norm": (D,), "k_norm": (D,)},
           "ln2": (M,), "mlp": {"w_gate": (M, F), "w_up": (M, F),
           "w_down": (F, M)}}
  Mamba layer = {"ln1": (M,), "mamba": {leaves of ``mamba.mamba_specs``}}
                                            # plus ln2/mlp where d_ff > 0
  MoE MLP = {"ln2": (M,), "moe": {"w_router": (M, E) f32, "w_gate": (E, M,
           F), "w_up": (E, M, F), "w_down": (E, F, M), "shared": {"w_gate":
           (M, Fs), "w_up": (M, Fs), "w_down": (Fs, M)}}}  # in place of mlp

Dense weights and the embedding are in ``cfg.param_dtype``, norms in f32;
the Mamba leaves keep the reference's types (``dt_bias``, ``A_log`` and
``D`` in f32), and so does the router (f32).

``init_params`` draws from the reference's distributions: embeddings
N(0, 0.02²), norms and ``D`` one, biases zero, ``A_log`` = log(1..N) over
every channel, dense weights N(0, 1/fan_in) with the reference's
``fan_in`` rule (params.py:93), which takes ``shape[0]`` of the *stacked*
array.  For a layer inside the scanned stack that is the number of stacked
layers, not the input width: Qwen3-8B's wq has std 1/6 (36 layers),
falcon-mamba-7b's in_proj 1/8 (64 layers), and the reduced two-layer
config's wq 1/sqrt(2).  A layer past the last whole period (gemma3's last
two) takes its own ``shape[0]``: its input width, or E for an expert
weight.  A config
cut to fewer layers stacks fewer, so its std changes with the depth: the
8-layer qwen3-moe's weights have std 1/sqrt(8).  The port copies the rule so
that its magnitudes match the reference's.  PyTorch cannot replay JAX's
path-keyed random stream, so the values themselves differ; parity tests
carry the reference's arrays over with ``from_jax_params``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.configs.base import (LayerSpec, ModelConfig, layer_specs,
                                      scan_period)
from repro_torch.device import resolve
from repro_torch.models.common import param_dtype_of
from repro_torch.models.mamba import mamba_specs
from repro_torch.models.moe import moe_specs


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """{path: (shape, init, dtype)} of one layer, in a fixed order."""
    M, H, Hkv, D, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    pd = param_dtype_of(cfg)
    shapes = {("ln1",): ((M,), "ones", torch.float32)}
    if spec.kind == "mamba":
        for name, (shape, init, dt) in mamba_specs(cfg).items():
            shapes[("mamba", name)] = (shape, init, getattr(torch, dt))
    else:
        shapes[("attn", "wq")] = ((M, H, D), "dense", pd)
        shapes[("attn", "wk")] = ((M, Hkv, D), "dense", pd)
        shapes[("attn", "wv")] = ((M, Hkv, D), "dense", pd)
        shapes[("attn", "wo")] = ((H, D, M), "dense", pd)
        if cfg.qk_norm:
            shapes[("attn", "q_norm")] = ((D,), "ones", torch.float32)
            shapes[("attn", "k_norm")] = ((D,), "ones", torch.float32)
    if spec.mlp == "dense":
        shapes[("ln2",)] = ((M,), "ones", torch.float32)
        shapes[("mlp", "w_gate")] = ((M, F), "dense", pd)
        shapes[("mlp", "w_up")] = ((M, F), "dense", pd)
        shapes[("mlp", "w_down")] = ((F, M), "dense", pd)
    elif spec.mlp == "moe":
        shapes[("ln2",)] = ((M,), "ones", torch.float32)
        for name, leaf in moe_specs(cfg).items():
            for sub, (shape, init, dt) in (
                    leaf.items() if name == "shared" else [(None, leaf)]):
                path = ("moe", name) if sub is None else ("moe", name, sub)
                shapes[path] = (shape, init, getattr(torch, dt))
    return shapes


def _set(tree: dict, path, value):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def _draw(shape, init, dtype, fan_in, gen, dev):
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=dev)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=dev)
    if init == "ssm_a":  # Mamba's A_log: log(1..N) over every channel
        a = torch.log(torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                                   device=dev))
        return a.expand(shape).to(dtype).contiguous()
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=dev)
    std = 0.02 if init == "embed" else 1.0 / math.sqrt(max(fan_in, 1))
    return (x * std).to(dtype)


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> dict:
    """Random parameters on ``device`` (default cuda), drawn from
    ``generator`` (a ``torch.Generator`` on that device)."""
    dev = resolve(device)
    pd = param_dtype_of(cfg)
    M, V = cfg.d_model, cfg.vocab_size
    # the reference stacks n_rep = n_layers // P layers per period position;
    # its fan_in for those is n_rep, for the remainder layers shape[0]
    n_rep = cfg.n_layers // scan_period(cfg)
    n_stacked = n_rep * scan_period(cfg)
    params = {"embed": _draw((V, M), "embed", pd, 0, generator, dev),
              "layers": []}
    for i, spec in enumerate(layer_specs(cfg)):
        layer: dict = {}
        for path, (shape, init, dt) in _layer_shapes(cfg, spec).items():
            fan_in = n_rep if i < n_stacked else shape[0]
            _set(layer, path, _draw(shape, init, dt, fan_in, generator, dev))
        params["layers"].append(layer)
    params["final_norm"] = torch.ones((M,), dtype=torch.float32, device=dev)
    if not cfg.tie_embeddings:
        params["unembed"] = _draw((M, V), "dense", pd, M, generator, dev)
    return params


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: torch reads it as raw bits
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a)).to(dev)


def from_jax_params(cfg: ModelConfig, tree: dict, device=None) -> dict:
    """The port's parameters from the reference's parameter tree.

    ``tree`` is ``repro.models.model.init_params``'s output with every leaf
    as a numpy array: ``embed``, ``stack/body[p]`` (leading axis: the n_rep
    stacked layers of period position p, layer ``rep * P + p``),
    ``stack/rem[j]`` (layer ``n_rep * P + j``), ``final_norm`` and
    ``unembed``.
    """
    dev = resolve(device)
    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    specs = layer_specs(cfg)
    body, rem = tree["stack"]["body"], tree["stack"]["rem"]

    def leaf(node, path):
        for key in path:
            node = node[key]
        return node

    layers = []
    for i, spec in enumerate(specs):
        layer: dict = {}
        for path in _layer_shapes(cfg, spec):
            if i < n_rep * P:
                a = np.asarray(leaf(body[i % P], path))[i // P]
            else:
                a = leaf(rem[i - n_rep * P], path)
            _set(layer, path, _tensor(a, dev))
        layers.append(layer)
    params = {"embed": _tensor(tree["embed"], dev), "layers": layers,
              "final_norm": _tensor(tree["final_norm"], dev)}
    if not cfg.tie_embeddings:
        params["unembed"] = _tensor(tree["unembed"], dev)
    return params


def count_params(params: dict) -> int:
    total = 0
    stack = [params]
    while stack:
        node = stack.pop()
        if isinstance(node, torch.Tensor):
            total += node.numel()
        elif isinstance(node, dict):
            stack.extend(node.values())
        else:
            stack.extend(node)
    return total
