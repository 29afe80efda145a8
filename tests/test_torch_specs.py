"""Port parity for ``repro_torch.launch.specs`` against ``repro.launch.specs``.

* The skip matrix is the reference's: 9 rule-skips
  (tests/test_dryrun_lowering.py::test_skip_matrix_matches_design).
* For every arch x shape on the production meshes (16, 16) and
  (2, 16, 16), the port's ``build_lowerable`` on an ``AbstractMesh`` and
  the reference's on a ``Mesh`` of one device repeated: every argument
  leaf has the reference's shape (without the stacked layer axis), dtype
  and PartitionSpec (without that axis's leading None), matched by path:
  the port's layer i is the reference's ``stack/body[i % P]`` row i // P,
  or ``stack/rem[i - n_rep * P]`` (gemma3's last two layers); and the
  bytes one device holds, summed over the arguments, are the reference's
  shard arithmetic.
* Each step kind's ``Lowerable.fn`` (train with two microbatches, prefill,
  decode) on the reduced qwen3-8b (G = 2, 2 layers, S = 32) against the
  reference's, on arguments made from a seed and carried over with
  ``state_from_jax`` / ``from_jax_params``: f32 results within TOL of
  tests/test_kernels.py; the train step's updated state within 1e-6
  (tests/test_torch_train.py::test_one_train_step_matches_reference).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import ShapeConfig as JShapeConfig
from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.configs.base import scan_period
from repro.launch import specs as jspecs
from repro.models import model as jax_model
from repro.train import train_loop as jax_train_loop
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro_torch.configs.base import SHAPES, ShapeConfig, get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch import specs
from repro_torch.models.params import from_jax_params
from repro_torch.train import train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.tree import flatten_with_path

ARCHS = ["falcon-mamba-7b", "gemma3-27b", "hubert-xlarge", "jamba-v0.1-52b",
         "mistral-nemo-12b", "qwen2-moe-a2.7b", "qwen2-vl-7b", "qwen3-8b",
         "qwen3-moe-235b-a22b", "stablelm-1.6b"]
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py, f32


def _meshes(name):
    shape, axes = MESHES[name]
    devs = np.asarray(jax.devices()[:1] * math.prod(shape)).reshape(shape)
    return Mesh(devs, axes), sh.AbstractMesh(axes, shape)


def test_skip_matrix_matches_reference():
    got = {(a, s) for a in ARCHS for s in SHAPES
           if specs.cell_skip_reason(get_config(a), s)}
    want = {(a, s) for a in ARCHS for s in JSHAPES
            if jspecs.cell_skip_reason(jax_get_config(a), s)}
    assert got == want
    assert len(got) == 9
    for a, s in got:
        assert (specs.cell_skip_reason(get_config(a), s)
                == jspecs.cell_skip_reason(jax_get_config(a), s))
    assert specs.DECODE_PAD == jspecs.DECODE_PAD
    assert specs.TRAIN_ACCUM == jspecs.TRAIN_ACCUM


def _ref_node(node, key):
    if isinstance(node, dict):
        return node[key]
    if isinstance(key, str):  # a NamedTuple's field
        return getattr(node, key)
    return node[key]


def _ref_path(cfg, path):
    """The reference's path of the port's argument leaf at ``path`` (its
    first entry the argument's index, or "cache" for decode's cache), and
    whether the reference stacks it over a leading layer axis."""
    P = scan_period(cfg)
    n_stacked = cfg.n_layers // P * P
    if path[0] == "cache":  # ("cache", layer, key)
        head, i, rest = [2], path[1], path[2:]
    elif "layers" in path:
        j = path.index("layers")
        head, i, rest = list(path[:j]) + ["stack"], path[j + 1], path[j + 2:]
    else:
        return list(path), False
    if i < n_stacked:
        return head + ["body", i % P] + list(rest), True
    return head + ["rem", i - n_stacked] + list(rest), False


def _ref_leaf(tree, path):
    for key in path:
        tree = _ref_node(tree, key)
    return tree


def _ref_spec(tree, path):
    for key in path:
        if tree is None or isinstance(tree, JP):
            break
        tree = _ref_node(tree, key)
    return JP() if tree is None else tree


def _shard_bytes(shape, dtype_bytes, spec, sizes):
    n = list(shape)
    for d, e in enumerate(spec):
        for a in () if e is None else ((e,) if isinstance(e, str) else e):
            assert n[d] % sizes[a] == 0
            n[d] //= sizes[a]
    return math.prod(n) * dtype_bytes


def _port_leaves(low):
    """[(path, meta tensor, PartitionSpec)] of the arguments; the decode
    cache's paths start with "cache"."""
    out = []
    for k, (arg, ps) in enumerate(zip(low.args, low.in_shardings)):
        head = ("cache",) if (k == 2 and len(low.args) == 4) else (k,)
        flat = flatten_with_path(arg)
        pss = ([sh.PartitionSpec()] * len(flat) if ps is None
               else [s for _, s in flatten_with_path(ps)])
        for (path, leaf), spec in zip(flat, pss, strict=True):
            out.append((head + path, leaf, spec))
    return out


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_specs_and_bytes_equal_reference(arch, shape, mesh_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    skip = specs.cell_skip_reason(cfg, shape)
    assert skip == jspecs.cell_skip_reason(jcfg, shape)
    if skip:
        return  # the matrix above; nothing is built for a skipped cell
    jmesh, amesh = _meshes(mesh_name)
    sizes = dict(zip(amesh.mesh_dim_names, amesh.shape))
    low = specs.build_lowerable(cfg, SHAPES[shape], amesh)
    jlow = jspecs.build_lowerable(jcfg, JSHAPES[shape], jmesh)
    assert low.rules == jlow.rules
    assert low.donate_argnums == jlow.donate_argnums
    got_bytes = 0
    for path, leaf, spec in _port_leaves(low):
        rpath, stacked = _ref_path(cfg, path)
        arg, rest = rpath[0], rpath[1:]
        want = _ref_leaf(jlow.args_sds[arg], rest)
        want_spec = _ref_spec(jlow.in_shardings[arg], rest)
        where = "/".join(map(str, path))
        want_shape = tuple(want.shape[1:] if stacked else want.shape)
        assert tuple(leaf.shape) == want_shape, where
        assert leaf.device.type == "meta"
        assert (str(leaf.dtype).split(".")[1]
                == np.dtype(want.dtype).name), where
        want_spec = tuple(want_spec)
        if stacked:
            assert want_spec[:1] in ((), (None,)), where
            want_spec = want_spec[1:]
        # a PartitionSpec may leave its trailing None entries out
        assert tuple(spec) + (None,) * (len(leaf.shape) - len(spec)) == \
            want_spec + (None,) * (len(leaf.shape) - len(want_spec)), where
        got_bytes += _shard_bytes(leaf.shape, leaf.element_size(), spec,
                                  sizes)
    want_bytes = 0
    for arg, ps in zip(jlow.args_sds, jlow.in_shardings):
        lv = jax.tree_util.tree_leaves(arg)
        sp = ([JP()] * len(lv) if ps is None else jax.tree_util.tree_leaves(
            ps, is_leaf=lambda x: isinstance(x, JP)))
        assert len(sp) == len(lv)
        want_bytes += sum(_shard_bytes(a.shape, np.dtype(a.dtype).itemsize,
                                       s, sizes) for a, s in zip(lv, sp))
    assert got_bytes == want_bytes


# --- Lowerable.fn against the reference's --------------------------------

S = 32
NAME, OVERRIDES = "qwen3-8b", {"n_kv_heads": 2}


def _cfgs():
    return (jax_reduced(jax_get_config(NAME), **OVERRIDES),
            reduced(get_config(NAME), **OVERRIDES))


def _lows(kind, B, tc=None):
    jcfg, cfg = _cfgs()
    jmesh, amesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                        ("data", "model")), sh.AbstractMesh(
                            ("data", "model"), (1, 1))
    step = {"train": "train", "prefill": "prefill", "decode": "decode"}[kind]
    jlow = jspecs.build_lowerable(jcfg, JShapeConfig(kind, S, B, step), jmesh,
                                  tc[0] if tc else None)
    low = specs.build_lowerable(cfg, ShapeConfig(kind, S, B, step), amesh,
                                tc[1] if tc else None)
    return jcfg, cfg, jlow, low


def _np_batch(rng, cfg, B, S_):
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, S_), np.int32),
            "targets": rng.integers(0, cfg.vocab_size, (B, S_), np.int32),
            "loss_mask": (rng.random((B, S_)) < 0.9).astype(np.float32)}


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(torch.as_tensor(got).detach()),
                               np.asarray(want), err_msg=what, **tol)


def test_train_fn_equals_reference():
    opt = dict(lr=1e-3, warmup_steps=0, clip_norm=1e-3)
    tc = (jax_train_loop.TrainConfig(accum_steps=2, opt=JaxOptConfig(**opt)),
          train_loop.TrainConfig(accum_steps=2, opt=OptConfig(**opt)))
    jcfg, cfg, jlow, low = _lows("train", 2, tc)
    jstate = jax_train_loop.init_state(jcfg, jax.random.PRNGKey(0))
    npstate = jax.tree_util.tree_map(np.asarray, jstate)
    batch = _np_batch(np.random.default_rng(0), cfg, 2, S)
    batch = {k: batch[k] for k in low.args[1]}
    jnew, jm = jax.jit(jlow.fn)(jstate, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    state = train_loop.state_from_jax(cfg, npstate, device="cpu")
    new, m = low.fn(state, batch)
    assert sorted(m) == sorted(jm) == list(specs.TRAIN_METRICS)
    for k in m:
        _close(m[k], jm[k], k)
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for got_tree, want_tree in ((new.params, want.params),
                                (new.opt.mu, want.opt.mu),
                                (new.opt.nu, want.opt.nu)):
        w_tree = from_jax_params(cfg, want_tree, device="cpu")
        for (path, g), (_, w) in zip(flatten_with_path(got_tree),
                                     flatten_with_path(w_tree), strict=True):
            _close(g, w, "/".join(map(str, path)), dict(rtol=0, atol=1e-6))


def _params(jcfg, cfg):
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    return jparams, from_jax_params(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


def _port_cache(cfg, jcache):
    """The reference's stacked cache as the port's per-layer list."""
    P = scan_period(cfg)
    body = jax.tree_util.tree_map(np.asarray, jcache["body"])
    return [{k: torch.from_numpy(np.array(v[i // P]))
             for k, v in body[i % P].items()} for i in range(cfg.n_layers)]


def test_prefill_fn_equals_reference():
    jcfg, cfg, jlow, low = _lows("prefill", 2)
    jparams, params = _params(jcfg, cfg)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, S),
                                               np.int32)
    jlogits, jcache = jax.jit(jlow.fn)(jparams,
                                       {"tokens": jnp.asarray(tokens)})
    logits, cache = low.fn(params, {"tokens": torch.from_numpy(tokens)})
    assert tuple(logits.shape) == tuple(low.outs[0].shape)
    _close(logits, jlogits, "logits")
    for i, (got, want) in enumerate(zip(cache, _port_cache(cfg, jcache),
                                        strict=True)):
        for k in ("k", "v"):
            assert got[k].shape == low.outs[1][i][k].shape
            _close(got[k], want[k], f"cache {i} {k}")


def test_decode_fn_equals_reference():
    jcfg, cfg, jlow, low = _lows("decode", 2)
    jparams, params = _params(jcfg, cfg)
    rng = np.random.default_rng(2)
    L = S + specs.DECODE_PAD
    jcache = jax.tree_util.tree_map(
        lambda s: jnp.asarray(rng.standard_normal(s.shape).astype(np.float32)),
        jlow.args_sds[2])
    tokens = rng.integers(0, cfg.vocab_size, (2, 1), np.int32)
    cache_len = S // 2
    jlogits, jnew = jax.jit(jlow.fn)(jparams, {"tokens": jnp.asarray(tokens)},
                                     jcache, jnp.int32(cache_len))
    cache = _port_cache(cfg, jcache)
    assert [tuple(c["k"].shape) for c in cache] == [
        (2, L, cfg.n_kv_heads, cfg.head_dim)] * cfg.n_layers
    logits, new = low.fn(params, {"tokens": torch.from_numpy(tokens)}, cache,
                         torch.tensor(cache_len, dtype=torch.int32))
    assert tuple(logits.shape) == tuple(low.outs[0].shape)
    _close(logits, jlogits, "logits")
    for i, (got, want) in enumerate(zip(new, _port_cache(cfg, jnew),
                                        strict=True)):
        for k in ("k", "v"):
            _close(got[k], want[k], f"cache {i} {k}")
