"""Port parity for the logical-axis sharding of
``repro_torch.distributed.sharding``, the per-leaf parameter specs, the
train state's specs, re-sharding on restore and the train step under a
mesh.

Every case of tests/test_sharding_rules.py runs through both packages: the
port resolves on an ``AbstractMesh`` of the same axes and sizes as the
reference's ``Mesh`` of one device repeated, and the two specs must be
equal as tuples.  The port's per-leaf specs equal the reference's stacked
specs minus their leading (layer) entry for all ten configs, both rule
sets and four meshes.  The gloo cases run on a (1, 1) mesh of this process.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist
from hypothesis import given, settings
from hypothesis import strategies as st

import torch_sharded_world as world

import jax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as JP

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import scan_period
from repro.distributed import sharding as jsh
from repro.models import model as jax_model
from repro.models.params import spec_to_pspecs as jax_spec_to_pspecs
from repro.train import train_loop as jax_train_loop
from repro_torch.configs.base import get_config, reduced
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import params as params_lib
from repro_torch.models.params import init_params
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.tree import flatten_with_path, leaves, map_tree

CONFIGS = ["falcon-mamba-7b", "gemma3-27b", "hubert-xlarge",
           "jamba-v0.1-52b", "mistral-nemo-12b", "qwen2-moe-a2.7b",
           "qwen2-vl-7b", "qwen3-8b", "qwen3-moe-235b-a22b", "stablelm-1.6b"]
MESHES = [((2, 2), ("data", "model")), ((2, 2, 1), ("pod", "data", "model")),
          ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RULES = {"train": (jsh.TRAIN_RULES, sh.TRAIN_RULES),
         "decode": (jsh.DECODE_RULES, sh.DECODE_RULES)}


def _meshes(shape=(2, 2), axes=("data", "model")):
    """(the reference's Mesh of one device repeated, the port's
    AbstractMesh)."""
    devs = np.asarray(jax.devices()[:1] * int(np.prod(shape))).reshape(shape)
    return Mesh(devs, axes), sh.AbstractMesh(axes, shape)


JMESH, MESH = _meshes()


def _both(logical, rules, shape, meshes=(JMESH, MESH)):
    """The port's spec, after checking it equals the reference's."""
    want = jsh.to_pspec(logical, rules=rules[0], mesh=meshes[0], shape=shape)
    got = sh.to_pspec(logical, rules=rules[1], mesh=meshes[1], shape=shape)
    assert isinstance(got, sh.PartitionSpec)
    assert tuple(got) == tuple(want)
    return got


def test_rule_tables_are_the_reference():
    assert sh.TRAIN_RULES == jsh.TRAIN_RULES
    assert sh.DECODE_RULES == jsh.DECODE_RULES


# --- tests/test_sharding_rules.py through both packages ---------------------


def test_divisible_kept():
    ps = _both(("batch", "heads"), RULES["train"], (8, 4))
    assert ps == sh.P("data", "model")


def test_nondivisible_dropped():
    ps = _both(("batch", "heads"), RULES["train"], (3, 4))
    assert ps == sh.P(None, "model")


def test_duplicate_axis_first_wins():
    ps = _both(("batch", "kv_seq", "kv_heads", None), RULES["decode"],
               (4, 8, 8, 16))
    assert ps == sh.P("data", "model", None, None)


def test_tuple_axis_prefix_fallback():
    ps = _both(("batch",), RULES["train"], (2,),
               _meshes((2, 2, 1), ("pod", "data", "model")))
    assert ps == sh.P("pod")


def test_missing_mesh_axis_filtered():
    ps = _both(("batch",), RULES["train"], (8,))
    assert ps == sh.P("data")


def test_no_mesh_and_no_shape():
    for logical in (("batch", "kv_seq", "kv_heads"), ("vocab", "embed_p")):
        for rules in RULES.values():
            want = jsh.to_pspec(logical, rules=rules[0])
            assert tuple(sh.to_pspec(logical, rules=rules[1])) == tuple(want)


@given(
    st.lists(
        st.sampled_from([None, "batch", "heads", "mlp", "vocab", "embed_p",
                         "experts", "kv_seq"]),
        min_size=1, max_size=5,
    ),
    st.lists(st.integers(1, 64), min_size=5, max_size=5),
)
@settings(max_examples=100, deadline=None)
def test_resolution_always_valid(logical, dims):
    """Property: resolved specs never violate divisibility or axis reuse,
    and equal the reference's."""
    shape = tuple(dims[: len(logical)])
    ps = _both(tuple(logical), RULES["decode"], shape)
    sizes = sh.axis_sizes(MESH)
    used = []
    for dim, entry in zip(shape, tuple(ps)):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else entry
        prod = 1
        for a in axes:
            assert a not in used, "mesh axis used twice"
            used.append(a)
            prod *= sizes[a]
        assert dim % prod == 0, "non-divisible sharding emitted"


def test_constrain_noop_without_mesh():
    import jax.numpy as jnp

    xj = jnp.ones((4, 4))
    assert jsh.constrain(xj, "batch", None) is xj
    x = torch.ones((4, 4))
    assert sh.constrain(x, "batch", None) is x
    assert params_lib.constrain_like({"w": x}, {"w": None})["w"] is x


# --- the port's own rules for meshes and placements --------------------------


def test_constrain_raises_on_a_plain_tensor_under_a_larger_mesh():
    x = torch.ones((4, 4))
    with sh.sharding_ctx(sh.AbstractMesh(("data", "model"), (2, 2))):
        assert sh.active_mesh().size() == 4
        with pytest.raises(NotImplementedError, match="several devices"):
            sh.constrain(x, "batch", None)
    assert sh.active_mesh() is None


def test_placements_follow_the_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    m = sh.AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    spec = sh.to_pspec(("batch", "heads", None), rules=sh.TRAIN_RULES,
                       mesh=m, shape=(64, 32, 8))
    assert spec == sh.P(("pod", "data"), "model", None)
    assert sh.placements(spec, m) == (Shard(0), Shard(0), Shard(1))
    assert sh.placements(sh.P(None, "data"), m) == (Replicate(), Shard(1),
                                                    Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        sh.placements(sh.P(("data", "pod")), m)


def test_named_sharding_equals_reference():
    for logical in (("batch", "seq", "heads"), ("vocab", "embed_p")):
        want = jsh.named_sharding(logical, mesh=JMESH, rules=jsh.TRAIN_RULES)
        got = sh.named_sharding(logical, mesh=MESH, rules=sh.TRAIN_RULES)
        assert tuple(got.spec) == tuple(want.spec)
    with pytest.raises(ValueError, match="needs a mesh"):
        sh.named_sharding(("batch",))


# --- per-leaf parameter specs and the train state's specs -------------------


def _ref_leaf(tree, cfg, path):
    """The reference's leaf for the port's path: layer i of the stack is
    repetition i // P of body[i % P] (its stacked leaf, minus the leading
    entry), or rem[i - n_rep * P]."""
    if path[0] != "layers":
        return tree[path[0]]
    i, rest = path[1], path[2:]
    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    node = (tree["stack"]["body"][i % P] if i < n_rep * P
            else tree["stack"]["rem"][i - n_rep * P])
    for k in rest:
        node = node[k]
    return JP(*tuple(node)[1:]) if i < n_rep * P else node


def _check_pspecs(port_tree, ref_tree, jcfg):
    n = 0
    for path, got in flatten_with_path(port_tree):
        want = _ref_leaf(ref_tree, jcfg, path)
        assert isinstance(got, sh.PartitionSpec), path
        assert tuple(got) == tuple(want), (path, got, want)
        n += 1
    return n


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("name", CONFIGS)
def test_param_pspecs_equal_reference_per_leaf(name, rules):
    jcfg, cfg = jax_get_config(name), get_config(name)
    specs = params_lib.param_specs(cfg)
    for shape, axes in MESHES:
        jm, m = _meshes(shape, axes)
        ref = jax_spec_to_pspecs(jax_model.abstract_params(jcfg),
                                 rules=RULES[rules][0], mesh=jm)
        got = params_lib.spec_to_pspecs(specs, rules=RULES[rules][1], mesh=m)
        assert _check_pspecs(got, ref, jcfg) == len(leaves(specs))


def test_param_specs_have_the_parameters_shapes():
    for name in ("jamba-v0.1-52b", "gemma3-27b", "qwen2-moe-a2.7b"):
        cfg = reduced(get_config(name))
        params = init_params(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
        specs = params_lib.param_specs(cfg)
        pairs = list(zip(flatten_with_path(params), flatten_with_path(specs),
                         strict=True))
        for (pp, p), (sp, s) in pairs:
            assert pp == sp
            assert (tuple(p.shape), p.dtype) == (s.shape, s.dtype), pp
            assert len(s.logical) == p.dim(), pp


@pytest.mark.parametrize("name", CONFIGS)
def test_state_pspecs_equal_reference(name):
    jcfg, cfg = jax_get_config(name), get_config(name)
    for rules in RULES:
        for shape, axes in MESHES[::3]:
            jm, m = _meshes(shape, axes)
            ref = jax_train_loop.state_pspecs(jcfg, rules=RULES[rules][0],
                                              mesh=jm)
            got = train_loop.state_pspecs(cfg, rules=RULES[rules][1], mesh=m)
            assert tuple(got.opt.step) == tuple(ref.opt.step) == ()
            for part in ("params", "mu", "nu"):
                g = got.params if part == "params" else getattr(got.opt, part)
                r = ref.params if part == "params" else getattr(ref.opt, part)
                _check_pspecs(g, r, jcfg)


# --- on a (1, 1) gloo mesh of this process ----------------------------------


@pytest.fixture(scope="module")
def mesh():
    m = make_local_mesh(1, 1, device="cpu")
    yield m
    dist.destroy_process_group()


def _state(cfg, seed=0):
    params = init_params(cfg, torch.Generator().manual_seed(seed),
                         device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    state = train_loop.TrainState(params, opt.init_state(params))
    # moments that are not zero, so that restore has values to show
    for m in leaves(state.opt.mu) + leaves(state.opt.nu):
        m.copy_(torch.rand(m.shape, generator=torch.Generator().manual_seed(
            seed + m.numel())))
    return state


def test_production_mesh_needs_its_ranks(mesh):
    from repro_torch.launch import mesh as mesh_lib

    for multi_pod, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks"):
            mesh_lib.make_production_mesh(multi_pod=multi_pod, device="cpu")
    assert (mesh.mesh_dim_names, tuple(mesh.shape)) == (("data", "model"),
                                                        (1, 1))


def test_restore_reshards_onto_the_mesh(mesh, tmp_path):
    from torch.distributed.tensor import DTensor

    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    state = _state(cfg)
    ckpt.save(str(tmp_path), 3, state)
    pspecs = train_loop.state_pspecs(cfg, rules=sh.TRAIN_RULES, mesh=mesh)
    shardings = map_tree(lambda p: sh.NamedSharding(mesh, p), pspecs)
    out = ckpt.restore(str(tmp_path), 3, state, sharding_tree=shardings)
    n_sharded = 0
    for (path, got), (_, want), (_, ns) in zip(
            flatten_with_path(out), flatten_with_path(state),
            flatten_with_path(shardings), strict=True):
        assert isinstance(got, DTensor), path
        assert got.device_mesh is mesh
        assert got.placements == ns.placements, path
        assert got.requires_grad == want.requires_grad, path
        full = got.full_tensor()
        assert full.dtype == want.dtype and torch.equal(full, want.detach())
        n_sharded += any(p.is_shard() for p in got.placements)
    assert n_sharded > len(leaves(state)) // 2
    # a leaf without a sharding comes back as a plain tensor
    partial = map_tree(lambda _: None, state)
    plain = ckpt.restore(str(tmp_path), 3, state, sharding_tree=partial)
    assert not any(isinstance(t, DTensor) for t in leaves(plain))


def test_constrain_redistributes_a_dtensor(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    x = torch.arange(32.0).reshape(4, 8)
    d = sh.NamedSharding(mesh, sh.P())
    dt = torch.distributed.tensor.distribute_tensor(x, mesh, d.placements)
    with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
        out = sh.constrain(dt, "batch", "heads")
        plain = sh.constrain(x, "batch", "heads")
    assert isinstance(out, DTensor)
    assert out.placements == (Shard(0), Shard(1))
    assert torch.equal(out.full_tensor(), x)
    assert plain is x
    assert d.placements == (Replicate(), Replicate())


def test_distribute_in_place_equals_a_new_tree(mesh):
    """``distribute(..., in_place=True)`` fills the caller's dicts and
    lists with the placed leaves, which equal ``distribute``'s new tree
    (the reduced jamba: attention, Mamba, MoE and dense leaves, placed by
    DECODE_RULES after TRAIN_RULES, as decode re-places them)."""
    from torch.distributed.tensor import DTensor

    cfg = reduced(get_config("jamba-v0.1-52b"))
    specs = params_lib.param_specs(cfg)
    train, decode = (params_lib.spec_to_pspecs(specs, rules=r, mesh=mesh)
                     for r in (sh.TRAIN_RULES, sh.DECODE_RULES))
    tree = sh.distribute(init_params(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"), train, mesh)
    layers = tree["layers"]
    want = sh.distribute(tree, decode, mesh)
    got = sh.distribute(tree, decode, mesh, in_place=True)
    assert got is tree and got["layers"] is layers
    for (path, g), (_, w) in zip(flatten_with_path(got),
                                 flatten_with_path(want), strict=True):
        assert isinstance(g, DTensor) and g.placements == w.placements, path
        assert torch.equal(g.to_local(), w.to_local()), path


def test_train_step_under_the_mesh_equals_the_step_without(mesh):
    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    batch = TokenStream(cfg, 2, 16, DataConfig()).batch_at(0)
    tc = train_loop.TrainConfig(opt=opt.OptConfig(lr=1e-3, warmup_steps=0))
    step = train_loop.make_train_step(cfg, tc)
    plain, meshed = _state(cfg), _state(cfg)
    s0, m0 = step(plain, batch)
    with sh.sharding_ctx(mesh, sh.TRAIN_RULES):
        assert params_lib.constrain_like(meshed.params, params_lib.param_specs(
            cfg))["embed"] is meshed.params["embed"]
        s1, m1 = step(meshed, batch)
    assert torch.equal(m0["loss"], m1["loss"])
    for a, b in zip(leaves(s0), leaves(s1), strict=True):
        assert torch.equal(a.detach(), b.detach())


# --- the collectives' gradients: a world of two gloo ranks -------------------

@pytest.fixture(scope="module")
def collective_grads(tmp_path_factory):
    import json
    import time

    import torch.multiprocessing as mp

    tmp = tmp_path_factory.mktemp("collective_grads")
    ctx = mp.spawn(world.grad_world, args=(str(tmp / "store"), str(tmp)),
                   nprocs=2, join=False)
    deadline = time.monotonic() + 120
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the two gloo ranks did not end in 120 s")
    return [json.loads((tmp / f"grads{r}.json").read_text())
            for r in range(2)]


@pytest.mark.parametrize("case", sorted(world.GRAD_CASES))
def test_collective_gradient_equals_the_unsharded_gradient(collective_grads,
                                                           case):
    """The gradient of sum(W * Y) with Y the redistributed (or summed) X
    is W on every rank, as unsharded: the rank's rows of W for an X split
    over the rows, the whole W for a replicated X and for each rank's term
    of a partial sum; a DTensor's gradient comes back in its placements (a
    partial sum's replicated), whether the gradient that arrives is the
    same on every rank or each rank's term, and no DTensor collective of
    its own runs."""
    src = world.GRAD_CASES[case][0]
    want_pl = {"shard": ["Replicate()", "Shard(dim=0)"],
               "replicate": ["Replicate()", "Replicate()"],
               "partial": ["Replicate()", "Replicate()"]}.get(src)
    for res in collective_grads:
        err, pl = res[case]
        assert err < 1e-12, res[case]
        assert pl == want_pl
