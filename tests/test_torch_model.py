"""Port parity for the decoder: ``reduced(qwen3-8b, n_layers=2)`` in f32, the
reference's parameters carried over with ``from_jax_params``, decode steps
from an empty cache, on the CPU.

The kernel keeps p in f32 where the reference casts it to the cache dtype
before P.V; in f32 the two agree, so the comparison runs in f32.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.models import model as jax_model
from repro.models.params import count_params as jax_count_params
from repro.scheduler.tenant import Request as JRequest
from repro.scheduler.tenant import Tenant as JTenant
from repro.serving.engine import Engine as JEngine
from repro.serving.engine import EngineConfig as JEngineConfig
from repro_torch.configs.base import get_config, reduced
from repro_torch.models import model
from repro_torch.models.params import count_params, from_jax_params, init_params
from repro_torch.scheduler.tenant import Request, Tenant
from repro_torch.serving.engine import Engine, EngineConfig


@pytest.fixture(scope="module")
def cfgs_and_params():
    jcfg = jax_reduced(jax_get_config("qwen3-8b"), n_layers=2)
    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, cfg, jparams, from_jax_params(cfg, tree, device="cpu")


def test_reduced_config_matches_reference(cfgs_and_params):
    jcfg, cfg, jparams, params = cfgs_and_params
    assert cfg.__dict__ == jcfg.__dict__
    assert count_params(params) == jax_count_params(jparams)


def test_decode_steps_match_reference(cfgs_and_params):
    jcfg, cfg, jparams, params = cfgs_and_params
    B, max_len, steps = 3, 8, 4
    jcache = jax_model.init_cache(jcfg, B, max_len)
    cache = model.init_cache(cfg, B, max_len, device="cpu")
    jdecode = jax.jit(lambda p, t, c, n: jax_model.decode_step(
        p, jcfg, {"tokens": t}, c, n))
    tokens = np.asarray([[3], [17], [200]], np.int32)
    jtok, tok = jnp.asarray(tokens), torch.from_numpy(tokens)
    for n in range(steps):
        jlogits, jcache = jdecode(jparams, jtok, jcache, jnp.asarray(n))
        logits, cache = model.decode_step(params, cfg, {"tokens": tok}, cache,
                                          n, device="cpu")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-4, atol=1e-4)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
        assert tok.numpy().tolist() == np.asarray(jtok).tolist(), f"step {n}"
    # the cache holds the same keys and values, in the reference's layout
    np.testing.assert_allclose(cache[1]["k"].numpy(),
                               np.asarray(jcache["body"][0]["k"][1]),
                               rtol=1e-4, atol=1e-4)


def test_init_params_follows_reference_fan_in_rule():
    """The reference's fan_in is shape[0] of the stacked array, the layer
    count: std(wq) = 1/sqrt(2) on the two-layer config, not 1/sqrt(64)."""
    cfg = reduced(get_config("qwen3-8b"), n_layers=2)
    jcfg = jax_reduced(jax_get_config("qwen3-8b"), n_layers=2)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
    jstd = float(np.std(np.asarray(jparams["stack"]["body"][0]["attn"]["wq"])))
    std = float(torch.cat([p["attn"]["wq"].flatten()
                           for p in params["layers"]]).std())
    assert abs(jstd - 2 ** -0.5) < 0.03
    assert abs(std - 2 ** -0.5) < 0.03
    assert abs(float(params["unembed"].std()) - 64 ** -0.5) < 0.01
    assert abs(float(params["embed"].std()) - 0.02) < 0.002


def test_engine_real_model_matches_reference(cfgs_and_params):
    """Both engines decode on every busy step: same cache length and tokens."""
    jcfg, cfg, jparams, params = cfgs_and_params

    def run(engine_cls, cfg_cls, tenant_cls, request_cls, mcfg, mparams, **kw):
        tenants = {i: tenant_cls(i, weight_mb=32.0) for i in range(8)}
        eng = engine_cls(cfg_cls(policy="lags", n_slots=4), tenants, **kw)
        eng.attach_model(mcfg, mparams, max_len=16)
        reqs = [request_cls(i, i % 8, 32, 4, arrival=0.0) for i in range(8)]
        st = eng.run(5.0, reqs)
        return eng, st

    jeng, jst = run(JEngine, JEngineConfig, JTenant, JRequest, jcfg, jparams)
    eng, st = run(Engine, EngineConfig, Tenant, Request, cfg, params,
                  device="cpu")
    assert len(st.completed) == len(jst.completed) >= 4
    assert eng._cache_len == jeng._cache_len > 0
    assert eng._tokens.numpy().tolist() == np.asarray(jeng._tokens).tolist()
