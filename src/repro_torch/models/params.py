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

``param_specs`` gives the same tree with a :class:`ParamSpec` (shape,
dtype, logical axes) for each leaf, the reference's
``abstract_params`` without the stacked layer axis: a per-layer leaf's
logical axes are the stacked spec's minus its leading (None) entry, so it
resolves to the stacked spec's partition minus its first entry.
``spec_to_pspecs`` resolves such a tree under sharding rules and a mesh,
``spec_to_meta`` turns it into tensors on the meta device (shape and dtype,
no storage: the reference's ``spec_to_sds``), and ``constrain_like``
applies each leaf's constraint to a tree of the same structure (a no-op
without a mesh).  ``shard_params`` places a parameter tree on a mesh by
those specs: each leaf a DTensor holding only the rank's shard (the
reference's ``jax.device_put`` with the specs' ``NamedSharding``s).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import (LayerSpec, ModelConfig, layer_specs,
                                      scan_period)
from repro_torch.device import resolve
from repro_torch.distributed.sharding import (active_mesh, constrain,
                                              distribute, to_pspec)
from repro_torch.models.common import param_dtype_of
from repro_torch.models.mamba import mamba_specs
from repro_torch.models.moe import moe_specs
from repro_torch.train.tree import map_tree


def _layer_shapes(cfg: ModelConfig, spec: LayerSpec) -> dict:
    """{path: (shape, init, dtype, logical axes)} of one layer, in a fixed
    order; the logical axes are the reference's ``ParamSpec.logical``
    (attention.py:36-43, blocks.py:31-40, mlp.py:17-19, and the Mamba and
    MoE specs) without the stacked layer axis."""
    M, H, Hkv, D, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                       cfg.head_dim, cfg.d_ff)
    pd = param_dtype_of(cfg)
    f32 = torch.float32
    shapes = {("ln1",): ((M,), "ones", f32, (None,))}
    if spec.kind == "mamba":
        for name, (shape, init, dt, lg) in mamba_specs(cfg).items():
            shapes[("mamba", name)] = (shape, init, getattr(torch, dt), lg)
    else:
        shapes[("attn", "wq")] = ((M, H, D), "dense", pd,
                                  ("embed_p", "heads", None))
        shapes[("attn", "wk")] = ((M, Hkv, D), "dense", pd,
                                  ("embed_p", "kv_heads", None))
        shapes[("attn", "wv")] = ((M, Hkv, D), "dense", pd,
                                  ("embed_p", "kv_heads", None))
        shapes[("attn", "wo")] = ((H, D, M), "dense", pd,
                                  ("heads", None, "embed_p"))
        if cfg.qk_norm:
            shapes[("attn", "q_norm")] = ((D,), "ones", f32, (None,))
            shapes[("attn", "k_norm")] = ((D,), "ones", f32, (None,))
    if spec.mlp == "dense":
        shapes[("ln2",)] = ((M,), "ones", f32, (None,))
        shapes[("mlp", "w_gate")] = ((M, F), "dense", pd, ("embed_p", "mlp"))
        shapes[("mlp", "w_up")] = ((M, F), "dense", pd, ("embed_p", "mlp"))
        shapes[("mlp", "w_down")] = ((F, M), "dense", pd, ("mlp", "embed_p"))
    elif spec.mlp == "moe":
        shapes[("ln2",)] = ((M,), "ones", f32, (None,))
        for name, leaf in moe_specs(cfg).items():
            for sub, (shape, init, dt, lg) in (
                    leaf.items() if name == "shared" else [(None, leaf)]):
                path = ("moe", name) if sub is None else ("moe", name, sub)
                shapes[path] = (shape, init, getattr(torch, dt), lg)
    return shapes


@dataclass(frozen=True)
class ParamSpec:
    """A leaf's shape, dtype and logical axis names (a leaf of the port's
    trees, where the reference's ``ParamSpec`` is a pytree node)."""
    shape: tuple
    dtype: torch.dtype
    logical: tuple


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
                device=None, mesh=None, rules=None) -> dict:
    """Random parameters on ``device`` (default cuda), drawn from
    ``generator`` (a ``torch.Generator`` on that device).  With ``mesh``,
    each leaf is placed on it by its spec under ``rules`` as soon as it is
    drawn (``shard_params`` of the same tree, every rank drawing the same
    values), so that no more than one whole leaf lives at a time."""
    dev = resolve(device)
    pd = param_dtype_of(cfg)
    M, V = cfg.d_model, cfg.vocab_size
    specs = param_specs(cfg)

    def place(t, spec):
        if mesh is None:
            return t
        return distribute(t, to_pspec(spec.logical, rules=rules, mesh=mesh,
                                      shape=spec.shape), mesh)

    # the reference stacks n_rep = n_layers // P layers per period position;
    # its fan_in for those is n_rep, for the remainder layers shape[0]
    n_rep = cfg.n_layers // scan_period(cfg)
    n_stacked = n_rep * scan_period(cfg)
    params = {"embed": place(_draw((V, M), "embed", pd, 0, generator, dev),
                             specs["embed"]),
              "layers": []}
    for i, spec in enumerate(layer_specs(cfg)):
        layer: dict = {}
        for path, (shape, init, dt, _) in _layer_shapes(cfg, spec).items():
            fan_in = n_rep if i < n_stacked else shape[0]
            leaf_spec = specs["layers"][i]
            for key in path:
                leaf_spec = leaf_spec[key]
            _set(layer, path, place(_draw(shape, init, dt, fan_in, generator,
                                          dev), leaf_spec))
        params["layers"].append(layer)
    params["final_norm"] = place(torch.ones((M,), dtype=torch.float32,
                                            device=dev), specs["final_norm"])
    if not cfg.tie_embeddings:
        params["unembed"] = place(_draw((M, V), "dense", pd, M, generator,
                                        dev), specs["unembed"])
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


def reference_ndims(cfg: ModelConfig, params: dict) -> dict:
    """A tree of ``params``' structure holding each leaf's number of
    dimensions in the reference's tree: one more for a layer inside the
    scanned stack (stacked over n_rep), where the reference's AdamW reads
    it to decide weight decay (optimizer.py: ``p.ndim >= 2``), so the
    stack's norms and Mamba vectors are decayed and ``final_norm`` is not."""
    n_stacked = cfg.n_layers // scan_period(cfg) * scan_period(cfg)

    def walk(node, extra):
        if isinstance(node, torch.Tensor):
            return node.dim() + extra
        if isinstance(node, dict):
            return {k: walk(v, extra) for k, v in node.items()}
        return [walk(v, extra) for v in node]

    out = {k: walk(v, 0) for k, v in params.items() if k != "layers"}
    out["layers"] = [walk(layer, int(i < n_stacked))
                     for i, layer in enumerate(params["layers"])]
    return out


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


def param_specs(cfg: ModelConfig) -> dict:
    """The :class:`ParamSpec` tree of ``init_params``' output."""
    pd = param_dtype_of(cfg)
    M, V = cfg.d_model, cfg.vocab_size
    out = {"embed": ParamSpec((V, M), pd, ("vocab", "embed_p")),
           "layers": []}
    for spec in layer_specs(cfg):
        layer: dict = {}
        for path, (shape, _, dt, lg) in _layer_shapes(cfg, spec).items():
            _set(layer, path, ParamSpec(tuple(shape), dt, lg))
        out["layers"].append(layer)
    out["final_norm"] = ParamSpec((M,), torch.float32, (None,))
    if not cfg.tie_embeddings:
        out["unembed"] = ParamSpec((M, V), pd, ("embed_p", "vocab"))
    return out


def spec_to_pspecs(tree, rules=None, mesh=None):
    """ParamSpec tree -> PartitionSpec tree."""
    return map_tree(lambda s: to_pspec(s.logical, rules=rules, mesh=mesh,
                                       shape=s.shape), tree)


def shard_params(cfg: ModelConfig, params: dict, mesh, rules=None) -> dict:
    """``params`` (full tensors, every rank the same) placed on ``mesh`` by
    ``param_specs`` resolved under ``rules`` (default: the active rules):
    each leaf a DTensor holding only the rank's shard."""
    return distribute(params, spec_to_pspecs(param_specs(cfg), rules=rules,
                                             mesh=mesh), mesh)


def spec_to_meta(tree):
    """ParamSpec tree -> tree of meta tensors of each spec's shape and
    dtype (the reference's ``spec_to_sds``)."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), tree)


def constrain_like(tree, spec_tree):
    """``constrain`` every leaf of ``tree`` by its ParamSpec's logical axes
    (a no-op without an active sharding context): keeps gradients in the
    parameters' layout."""
    if active_mesh() is None:
        return tree
    return map_tree(lambda leaf, s: constrain(leaf, *s.logical), tree,
                    spec_tree)
