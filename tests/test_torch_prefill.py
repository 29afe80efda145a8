"""Port parity for prefill and the decode that continues from it: the reduced
configs in f32 on the CPU (the kernels' plain versions), the reference's
parameters carried over with ``from_jax_params``, against
``repro.models.model.prefill`` and ``decode_step``.

Prefill logits and every cache leaf (k, v; h, conv) agree within 1e-4; the
comparisons of prefill with decode use the reference's own 2e-3
(tests/test_models_smoke.py).  The SSM state h is held to 1e-4 of its
largest entry: under the reference's ``fan_in`` rule the reduced
falcon-mamba's h reaches ~6e5, and the one-ulp differences between XLA's
and PyTorch's exp and softplus then leave absolute differences of a few
1e-2 on entries that cancel down to ~1e2 (relative to the leaf's scale,
~2e-7).  Reduced Qwen3-8B runs at G = 1 (the reduced
config's n_kv_heads = n_heads = 4) and at G = 2; falcon-mamba at S = 32 and
at S = 512, where the reference takes its chunked branch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.configs.base import scan_period
from repro.models import model as jax_model
from repro_torch.configs.base import get_config, list_configs, reduced
from repro_torch.models import model
from repro_torch.models.params import from_jax_params, init_params

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_DECODE_VS_PREFILL = dict(rtol=2e-3, atol=2e-3)
B = 2

CASES = {
    "qwen3-G1": ("qwen3-8b", {}, 32),
    "qwen3-G2": ("qwen3-8b", {"n_kv_heads": 2}, 32),
    "stablelm": ("stablelm-1.6b", {}, 32),
    "mistral-nemo": ("mistral-nemo-12b", {"n_kv_heads": 2}, 32),
    "mamba-S32": ("falcon-mamba-7b", {"n_layers": 2}, 32),
    "mamba-S512": ("falcon-mamba-7b", {"n_layers": 2}, 512),
}
_MODELS: dict = {}


def _model(name, overrides):
    """(reference cfg, port cfg, reference params, port params), cached."""
    key = (name, tuple(sorted(overrides.items())))
    if key not in _MODELS:
        jcfg = jax_reduced(jax_get_config(name), **overrides)
        cfg = reduced(get_config(name), **overrides)
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        _MODELS[key] = (jcfg, cfg, jparams,
                        from_jax_params(cfg, tree, device="cpu"))
    return _MODELS[key]


def _tokens(cfg, S, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


def _ref_layer(jcache, cfg, i):
    """Layer i's cache from the reference's stacked {"body", "rem"}."""
    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    if i < n_rep * P:
        return {k: np.asarray(v[i // P]) for k, v in jcache["body"][i % P].items()}
    return {k: np.asarray(v) for k, v in jcache["rem"][i - n_rep * P].items()}


def _jax_prefill(jcfg, max_len):
    return jax.jit(lambda p, t: jax_model.prefill(p, jcfg, {"tokens": t},
                                                  max_len=max_len))


def _jax_decode(jcfg):
    return jax.jit(lambda p, t, c, n: jax_model.decode_step(
        p, jcfg, {"tokens": t}, c, n))


@pytest.mark.parametrize("name", ["stablelm-1.6b", "mistral-nemo-12b",
                                  "falcon-mamba-7b"])
def test_new_configs_match_reference(name):
    assert name in list_configs()
    cfg, jcfg = get_config(name), jax_get_config(name)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert dataclasses.asdict(reduced(cfg)) == dataclasses.asdict(
        jax_reduced(jcfg))


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_reference(case):
    """Prefill logits and every cache leaf, then three greedy decode steps
    from that cache, against the reference."""
    name, overrides, S = CASES[case]
    jcfg, cfg, jparams, params = _model(name, overrides)
    max_len = S + 4
    toks = _tokens(cfg, S)
    jlogits, jcache = _jax_prefill(jcfg, max_len)(jparams, jnp.asarray(toks))
    logits, cache = model.prefill(params, cfg,
                                  {"tokens": torch.from_numpy(toks)},
                                  max_len=max_len, device="cpu")
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert len(cache) == cfg.n_layers
    for i, layer in enumerate(cache):
        want = _ref_layer(jcache, cfg, i)
        assert sorted(layer) == sorted(want), f"layer {i}"
        for leaf, got in layer.items():
            assert tuple(got.shape) == want[leaf].shape, f"layer {i} {leaf}"
            tol = dict(TOL)
            if leaf == "h":
                tol["atol"] *= max(1.0, float(np.abs(want[leaf]).max()))
            np.testing.assert_allclose(got.numpy(), want[leaf], **tol,
                                       err_msg=f"layer {i} {leaf}")

    jdecode = _jax_decode(jcfg)
    jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
    tok = torch.argmax(logits, -1)[:, None].to(torch.int32)
    for n in range(S, S + 3):
        assert tok.numpy().tolist() == np.asarray(jtok).tolist(), f"pos {n}"
        jlogits, jcache = jdecode(jparams, jtok, jcache, jnp.asarray(n))
        logits, cache = model.decode_step(params, cfg, {"tokens": tok}, cache,
                                          n, device="cpu")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"decode at {n}")
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = torch.argmax(logits, -1)[:, None].to(torch.int32)


@pytest.mark.parametrize("case", ["qwen3-G1", "qwen3-G2", "mamba-S32"])
def test_decode_matches_prefill(case):
    """Teacher-forced decode over a prompt matches the prefill logits (the
    port's ``test_decode_matches_prefill`` and ``..._ssm``)."""
    name, overrides, S = CASES[case]
    _, cfg, _, params = _model(name, overrides)
    toks = torch.from_numpy(_tokens(cfg, S))
    logits_p, _ = model.prefill(params, cfg, {"tokens": toks}, max_len=S + 4,
                                device="cpu")
    cache = model.init_cache(cfg, B, S + 4, device="cpu")
    for t in range(S):
        logits_d, cache = model.decode_step(
            params, cfg, {"tokens": toks[:, t:t + 1]}, cache, t, device="cpu")
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(),
                               **TOL_DECODE_VS_PREFILL)


@pytest.mark.parametrize("case", ["qwen3-G2", "mamba-S32", "mamba-S512"])
def test_prefill_then_one_decode_matches_longer_prefill(case):
    """prefill(tokens[:, :S-1]) and one decode step give the last logits of
    prefill(tokens[:, :S]): the check ``chip_smoke.py`` runs at full size."""
    name, overrides, S = CASES[case]
    _, cfg, _, params = _model(name, overrides)
    toks = torch.from_numpy(_tokens(cfg, S, seed=2))
    full, _ = model.prefill(params, cfg, {"tokens": toks}, device="cpu")
    _, cache = model.prefill(params, cfg, {"tokens": toks[:, :S - 1]},
                             max_len=S, device="cpu")
    step, _ = model.decode_step(params, cfg, {"tokens": toks[:, S - 1:]},
                                cache, S - 1, device="cpu")
    np.testing.assert_allclose(full.numpy(), step.numpy(),
                               **TOL_DECODE_VS_PREFILL)


def test_window_and_non_causal_prefill_match_reference():
    """A windowed layer and a non-causal config take the same flash path
    (no config of the port's registry has either yet)."""
    for overrides in ({"sliding_window": 8}, {"causal": False}):
        jcfg = jax_reduced(jax_get_config("qwen3-8b"), n_kv_heads=2,
                           **overrides)
        cfg = reduced(get_config("qwen3-8b"), n_kv_heads=2, **overrides)
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(3))
        params = from_jax_params(
            cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
        toks = _tokens(cfg, 24, seed=4)
        jlogits, _ = _jax_prefill(jcfg, 24)(jparams, jnp.asarray(toks))
        logits, _ = model.prefill(params, cfg, {"tokens": torch.from_numpy(toks)},
                                  device="cpu")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=str(overrides))


def test_given_positions_raise():
    """The reference reads batch["positions"] when it is given; the port does
    not take it yet and says so rather than ignore it."""
    cfg = reduced(get_config("qwen3-8b"), n_layers=1)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = torch.zeros((1, 4), dtype=torch.int32)
    pos = torch.arange(4, dtype=torch.int32)[None] + 3
    with pytest.raises(NotImplementedError, match="positions"):
        model.prefill(params, cfg, {"tokens": toks, "positions": pos},
                      device="cpu")
    cache = model.init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="positions"):
        model.decode_step(params, cfg, {"tokens": toks[:, :1],
                                        "positions": pos[:, :1]}, cache, 0,
                          device="cpu")
