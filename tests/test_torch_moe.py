"""Port parity for the MoE layer: ``repro_torch.models.moe.moe`` against
``repro.models.moe.moe`` on the CPU in f32, the reference's parameters
(``moe_specs`` drawn by its ``materialize``) carried over as numpy arrays.

Output y and the aux loss agree within 1e-4 for a normal router, a zero
router (every probability ties: experts 0..K-1 must win, as
``jax.lax.top_k`` orders them), a router skewed to one expert so that
capacity drops (token, k) pairs, groups that span batch rows (B=4, S=320:
five groups of 256), and decode (S = 1, one token a group).  Where B * S
is not a multiple of the group, both packages refuse.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import moe as jax_moe
from repro.models.params import materialize
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import moe

TOL = dict(rtol=1e-4, atol=1e-4)

# (config, overrides): the reduced configs (E=4, K=2; qwen2-moe with one
# shared expert), and qwen3-moe with E=16, K=4 where capacity is tighter
CONFIGS = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "qwen3-moe-E16K4": ("qwen3-moe-235b-a22b", {"n_experts": 16, "top_k": 4}),
}


def _setup(case, seed=0):
    name, overrides = CONFIGS[case]
    jcfg = jax_reduced(jax_get_config(name), **overrides)
    cfg = reduced(get_config(name), **overrides)
    jparams = materialize(jax_moe.moe_specs(jcfg), jax.random.PRNGKey(seed))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    params = jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a)),
                                    tree)
    return jcfg, cfg, tree, params


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _both(jcfg, cfg, tree, params, x):
    jy, jaux = jax.jit(lambda p, a: jax_moe.moe(p, a, jcfg))(
        jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    y, aux = moe.moe(params, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **TOL)
    return y, aux


@pytest.mark.parametrize("case", list(CONFIGS))
@pytest.mark.parametrize("B,S", [(2, 32), (4, 320), (3, 1)],
                         ids=["prefill", "groups-span-rows", "decode"])
def test_moe_matches_reference(case, B, S):
    jcfg, cfg, tree, params = _setup(case)
    _both(jcfg, cfg, tree, params, _x(cfg, B, S))


@pytest.mark.parametrize("case", list(CONFIGS))
def test_zero_router_picks_the_lowest_experts(case):
    """All probabilities tie: the reference's top_k takes experts 0..K-1."""
    jcfg, cfg, tree, params = _setup(case)
    tree["w_router"] = np.zeros_like(tree["w_router"])
    params["w_router"] = torch.zeros_like(params["w_router"])
    x = _x(cfg, 2, 32)
    _, _, gate_w, ids, _, keep, _ = moe.route(params, torch.from_numpy(x), cfg)
    assert (ids == torch.arange(cfg.top_k)).all()
    assert torch.allclose(gate_w, torch.full_like(gate_w, 1 / cfg.top_k))
    _both(jcfg, cfg, tree, params, x)


@pytest.mark.parametrize("case", list(CONFIGS))
@pytest.mark.parametrize("B,S", [(2, 32), (4, 320)])
def test_skewed_router_drops_the_reference_pairs(case, B, S):
    """Expert 0 wins every token, past its capacity: the pairs the port
    drops are the reference's (y would differ otherwise)."""
    jcfg, cfg, tree, params = _setup(case)
    skew = np.zeros_like(tree["w_router"])
    skew[:, 0] = 0.5
    tree["w_router"] = tree["w_router"] + skew
    params["w_router"] = torch.from_numpy(tree["w_router"])
    x = np.abs(_x(cfg, B, S))  # x . w_router[:, 0] > 0 for every token
    keep = moe.route(params, torch.from_numpy(x), cfg)[5]
    assert float(keep.mean()) < 0.9, float(keep.mean())
    _both(jcfg, cfg, tree, params, x)


def test_groups_that_do_not_fill_raise():
    """B * S = 300 tokens in groups of 256: the reference's reshape fails,
    the port raises ValueError."""
    jcfg, cfg, tree, params = _setup("qwen2-moe")
    x = _x(cfg, 1, 300)
    with pytest.raises(ValueError, match="groups of 256"):
        moe.moe(params, torch.from_numpy(x), cfg)
    with pytest.raises(TypeError):
        jax_moe.moe(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x),
                    jcfg)


def test_capacity_and_specs_match_reference():
    for gs, k, e in [(1, 8, 128), (256, 2, 16), (256, 4, 60), (256, 8, 128),
                     (32, 2, 4), (7, 3, 5)]:
        assert moe._capacity(gs, k, e) == jax_moe._capacity(gs, k, e)
    for name in ("qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b"):
        ref = jax.tree_util.tree_map(
            lambda s: (s.shape, s.dtype), jax_moe.moe_specs(
                jax_get_config(name)),
            is_leaf=lambda s: hasattr(s, "logical"))
        port = jax.tree_util.tree_map(
            lambda s: (s[0], s[2]), moe.moe_specs(get_config(name)),
            is_leaf=lambda s: isinstance(s, tuple))
        assert port == ref, name
