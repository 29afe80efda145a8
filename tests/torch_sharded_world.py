"""Shared by tests/test_torch_sharded_*.py: the reference's sharded prefill
and decode in a JAX subprocess, and the port's in gloo worlds.

``reference(tmp, name, overrides, meshes)`` runs one JAX subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) that initialises
the reduced config's parameters, then on each ("data", "model") mesh of
its host devices runs ``jax.jit(model.prefill, in_shardings=...)`` under
``TRAIN_RULES`` (max_len = S + ``DECODE_PAD``) and two ``decode_step``s
through ``launch/specs.py::build_lowerable``'s decode cell under
``DECODE_RULES``, the cache placed by its ``cache_specs``.  It writes the
parameters, the tokens, and each mesh's logits and cache (gathered) to
``.npz`` files.

``world(tmp, name, overrides, shape)`` runs the port's same steps in a gloo
world of data x model processes (``torch.multiprocessing.spawn``, a
``FileStore``): parameters placed by ``params.shard_params``, prefill under
``sharding_ctx(mesh, TRAIN_RULES)``, then the decode cell's ``fn`` on
arguments placed by its ``in_shardings`` under its rules.  Each rank
records its local parameter and cache bytes beside those its shards should
hold by the rules, and the local shapes its kernel wrappers ran on; rank 0
writes the gathered logits and caches.  DTensor's own collectives are
refused in the ranks (``forbid_dtensor_collectives``).

This module imports no JAX, so that the spawned ranks do not either.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
JOIN_S = 120  # a world fails, instead of hanging, past this
B, S = 2, 8  # batch and prompt; the cache holds S + DECODE_PAD = 24 rows
N_DECODE = 2

REF_SCRIPT = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import ShapeConfig, get_config, reduced
from repro.distributed.sharding import TRAIN_RULES, sharding_ctx, to_pspec
from repro.launch import specs
from repro.models import model
from repro.models.params import spec_to_pspecs

name, overrides, B, S, n_decode, meshes, out = json.loads(sys.argv[1])
cfg = reduced(get_config(name), **overrides)
params = model.init_params(cfg, jax.random.PRNGKey(0))
rng = np.random.default_rng(0)
tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
steps = rng.integers(0, cfg.vocab_size, (n_decode, B, 1)).astype(np.int32)
L = S + specs.DECODE_PAD


def flat(tree, prefix):
    res = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        res[prefix + key] = np.asarray(leaf)
    return res


np.savez(out + "/params.npz", **flat(params, ""))
res = {"tokens": tokens, "steps": steps}
for shape in meshes:
    n = shape[0] * shape[1]
    mesh = Mesh(np.asarray(jax.devices()[:n]).reshape(shape),
                ("data", "model"))
    ns = lambda t: jax.tree_util.tree_map(
        lambda ps: NamedSharding(mesh, ps), t,
        is_leaf=lambda x: isinstance(x, P))
    tag = f"{shape[0]}x{shape[1]}"
    pps = spec_to_pspecs(model.abstract_params(cfg), rules=TRAIN_RULES,
                         mesh=mesh)
    bps = {"tokens": to_pspec(("batch", None), rules=TRAIN_RULES, mesh=mesh,
                              shape=(B, S))}
    with mesh, sharding_ctx(mesh, TRAIN_RULES):
        prefill = jax.jit(lambda p, b: model.prefill(p, cfg, b, max_len=L),
                          in_shardings=(ns(pps), ns(bps)))
        logits, cache = prefill(params, {"tokens": jnp.asarray(tokens)})
    res[f"{tag}/logits0"] = np.asarray(logits)
    res.update(flat(cache, f"{tag}/prefill/"))
    low = specs.build_lowerable(cfg, ShapeConfig("decode", S, B, "decode"),
                                mesh)
    sh_in = ns(low.in_shardings)
    p_dec = jax.device_put(params, sh_in[0])
    cache = jax.device_put(cache, sh_in[2])
    with mesh, sharding_ctx(mesh, low.rules):
        decode = jax.jit(low.fn, in_shardings=sh_in)
        for i in range(n_decode):
            batch = jax.device_put({"tokens": jnp.asarray(steps[i])},
                                   sh_in[1])
            logits, cache = decode(p_dec, batch, cache, jnp.int32(S + i))
            res[f"{tag}/logits{i + 1}"] = np.asarray(logits)
    res.update(flat(cache, f"{tag}/decode/"))
np.savez(out + "/ref.npz", **res)
"""


def tag(shape) -> str:
    return f"{shape[0]}x{shape[1]}"


def reference(tmp: Path, name: str, overrides: dict, meshes,
              prompt: int = S) -> subprocess.Popen:
    """Start the reference's subprocess (prompts of ``prompt`` tokens); it
    writes tmp/params.npz, then tmp/ref.npz."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    arg = json.dumps([name, overrides, B, prompt, N_DECODE,
                      [list(m) for m in meshes], str(tmp)])
    return subprocess.Popen([sys.executable, "-c", REF_SCRIPT, arg], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def wait_reference(proc: subprocess.Popen) -> None:
    out, _ = proc.communicate(timeout=JOIN_S)
    if proc.returncode != 0:
        raise AssertionError(f"the reference failed:\n{out[-3000:]}")


def _tree(npz) -> dict:
    """The nested parameter tree from the reference's flattened keys."""
    root: dict = {}
    for key in npz.files:
        node = root
        parts = [int(p) if p.isdigit() else p for p in key.split("/")]
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = npz[key]
    for part in ("body", "rem"):  # an empty list leaves no key
        root["stack"].setdefault(part, {})
    return root


def _local_bytes(tree) -> int:
    from repro_torch.distributed.sharding import local
    from repro_torch.train.tree import leaves

    return sum(local(t).numel() * local(t).element_size()
               for t in leaves(tree))


def _rule_bytes(spec_tree, mesh, rules) -> int:
    """The bytes a rank's shards hold by the rules: each leaf's size over
    the mesh axes its resolved spec splits it by."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.train.tree import leaves

    sizes = sh.axis_sizes(mesh)
    total = 0
    for s in leaves(spec_tree):
        split = 1
        for entry in sh.to_pspec(s.logical, rules=rules, mesh=mesh,
                                 shape=s.shape):
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= sizes[a]
        total += math.prod(s.shape) // split * s.dtype.itemsize
    return total


def _record_shapes():
    """Wrap the kernels' plain versions to record the local shapes they
    run on; returns {kernel: [shape, ...]}."""
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan as ssm

    seen: dict = {"flash_attention": [], "decode_attention": [],
                  "ssm_scan": []}
    for mod, fn, key in ((fa, "flash_attention_plain", "flash_attention"),
                         (dec, "decode_attention_plain", "decode_attention"),
                         (ssm, "ssm_scan_plain", "ssm_scan")):
        orig = getattr(mod, fn)

        def wrapped(*a, _orig=orig, _key=key, **kw):
            seen[_key].append([list(a[0].shape), list(a[1].shape)])
            return _orig(*a, **kw)

        setattr(mod, fn, wrapped)
    return seen


def forbid_dtensor_collectives():
    """Make every collective of DTensor's own redistribution raise: the
    port runs its collectives through ``sharding.redistribute`` and places
    every DTensor operation so that it needs none (with torch 2.11 and
    gloo on an H100 host, DTensor's functional all-gather of a CUDA tensor
    ends the process)."""
    import torch.distributed._functional_collectives as funcol
    from torch.distributed.tensor import placement_types

    def refuse(*a, **kw):
        raise AssertionError("a DTensor operation ran a collective of its "
                             "own redistribution")

    for mod, names in ((funcol, ("all_reduce", "all_gather_single",
                                 "all_gather_tensor", "reduce_scatter_single",
                                 "reduce_scatter_tensor",
                                 "all_to_all_single")),
                       (placement_types, ("shard_dim_alltoall", "mesh_scatter",
                                          "mesh_broadcast"))):
        for n in names:
            if hasattr(mod, n):
                setattr(mod, n, refuse)


def _rank_main(rank, world, shape, store, name, overrides, tmp):
    import torch
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        from repro_torch.configs.base import ShapeConfig, get_config, reduced
        from repro_torch.distributed import sharding as sh
        from repro_torch.launch import specs
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import model
        from repro_torch.models import params as P

        cfg = reduced(get_config(name), **overrides)
        full = P.from_jax_params(cfg, _tree(np.load(f"{tmp}/params.npz")),
                                 device="cpu")
        ref = np.load(f"{tmp}/ref.npz")
        tokens, steps = ref["tokens"], ref["steps"]
        S = tokens.shape[1]
        mesh = make_local_mesh(*shape, device="cpu")
        seen = _record_shapes()
        forbid_dtensor_collectives()
        out: dict = {}
        params = P.shard_params(cfg, full, mesh, sh.TRAIN_RULES)
        L = S + specs.DECODE_PAD
        with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
            logits, cache = model.prefill(
                params, cfg, {"tokens": torch.from_numpy(tokens)}, max_len=L,
                device="cpu")
        out["bytes/params_train"] = [_local_bytes(params), _rule_bytes(
            P.param_specs(cfg), mesh, sh.TRAIN_RULES)]
        out["bytes/cache_train"] = [_local_bytes(cache), _rule_bytes(
            model.cache_specs(cfg, B, L), mesh, sh.TRAIN_RULES)]
        got = {"logits0": sh.full(logits)}
        for i, layer in enumerate(cache):
            for leaf, t in layer.items():
                # a copy: a leaf replicated over every rank is the rank's
                # own tensor, which decode updates in place
                got[f"prefill/{i}/{leaf}"] = sh.full(t).clone()
        low = specs.build_lowerable(cfg, ShapeConfig("decode", S, B,
                                                     "decode"), mesh)
        params = sh.distribute(params, low.in_shardings[0], mesh)
        cache = sh.distribute(cache, low.in_shardings[2], mesh)
        for i in range(N_DECODE):
            batch = sh.distribute({"tokens": torch.from_numpy(steps[i])},
                                  low.in_shardings[1], mesh)
            with sh.sharding_ctx(mesh, low.rules):
                logits, cache = low.fn(params, batch, cache, S + i)
            got[f"logits{i + 1}"] = sh.full(logits)
        for i, layer in enumerate(cache):
            for leaf, t in layer.items():
                got[f"decode/{i}/{leaf}"] = sh.full(t)
        out["bytes/params_decode"] = [_local_bytes(params), _rule_bytes(
            P.param_specs(cfg), mesh, sh.DECODE_RULES)]
        out["bytes/cache_decode"] = [_local_bytes(cache), _rule_bytes(
            model.cache_specs(cfg, B, L), mesh, sh.DECODE_RULES)]
        out["bytes/params_full"] = _local_bytes(full)
        out["shapes"] = seen
        with open(f"{tmp}/rank{rank}.json", "w") as fh:
            json.dump(out, fh)
        if rank == 0:
            np.savez(f"{tmp}/port.npz",
                     **{k: v.numpy() for k, v in got.items()})
    finally:
        dist.destroy_process_group()


def world(tmp: Path, name: str, overrides: dict, shape) -> None:
    """Run the port's gloo world of shape[0] x shape[1] ranks to its end
    (after the reference has written its files) in tmp."""
    import torch.multiprocessing as mp

    n = shape[0] * shape[1]
    ctx = mp.spawn(_rank_main, args=(n, tuple(shape), str(tmp / "store"),
                                     name, overrides, str(tmp)),
                   nprocs=n, join=False)
    deadline = time.monotonic() + JOIN_S
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise AssertionError(
                f"the {shape} world did not end in {JOIN_S} s")


def run_all(tmp: Path, name: str, overrides: dict, meshes, proc=None):
    """The reference on every mesh (``proc``, where it was started
    already), then the port's world on each: returns ({mesh tag: (the
    port's outputs, each rank's record)}, the reference's outputs)."""
    wait_reference(proc or reference(tmp, name, overrides, meshes))
    out = {}
    for shape in meshes:
        d = tmp / tag(shape)
        d.mkdir()
        for f in ("params.npz", "ref.npz"):
            (d / f).symlink_to(tmp / f)
        world(d, name, overrides, shape)
        ranks = [json.loads((d / f"rank{r}.json").read_text())
                 for r in range(shape[0] * shape[1])]
        out[tag(shape)] = (np.load(d / "port.npz"), ranks)
    return out, np.load(tmp / "ref.npz")


def ref_layer(ref, prefix: str, cfg, i: int) -> dict:
    """Layer i's cache leaves from the reference's stacked cache."""
    from repro_torch.configs.base import scan_period

    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    out = {}
    for leaf in ("k", "v", "h", "conv"):
        if i < n_rep * P:
            key = f"{prefix}body/{i % P}/{leaf}"
            if key in ref.files:
                out[leaf] = ref[key][i // P]
        else:
            key = f"{prefix}rem/{i - n_rep * P}/{leaf}"
            if key in ref.files:
                out[leaf] = ref[key]
    return out
