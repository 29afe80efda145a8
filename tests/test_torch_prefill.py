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
from repro_torch.models.params import from_jax_params

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
    """Given positions whose stream 0 is off the row index (the name is the
    test's from when the port refused them): prefill, decode and the
    training loss equal the reference's, which masks keys by position.
    Reduced Qwen3-8B at G = 2; row 0 at positions 3..6, row 1 at 0, 0, 1, 5
    (a repeat and a gap); then a decode step at cache row 4 with positions
    2 (below the cache length: rows 3.. masked) and 9."""
    jcfg, cfg, jparams, params = _model("qwen3-8b", {"n_kv_heads": 2})
    S = 4
    toks = _tokens(cfg, S, seed=3)
    pos = np.array([[3, 4, 5, 6], [0, 0, 1, 5]], np.int32)
    jbatch = {"tokens": jnp.asarray(toks), "positions": jnp.asarray(pos)}
    jlogits, jcache = jax.jit(lambda p, b: jax_model.prefill(
        p, jcfg, b, max_len=S + 1))(jparams, jbatch)
    logits, cache = model.prefill(
        params, cfg, {"tokens": torch.from_numpy(toks),
                      "positions": torch.from_numpy(pos)},
        max_len=S + 1, device="cpu")
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i, layer in enumerate(cache):
        for leaf, got in layer.items():
            np.testing.assert_allclose(got.numpy(), _ref_layer(jcache, cfg, i)
                                       [leaf], **TOL)
    dpos = np.array([[2], [9]], np.int32)
    jd, _ = jax.jit(lambda p, b, c: jax_model.decode_step(p, jcfg, b, c, S))(
        jparams, {"tokens": jnp.asarray(toks[:, :1]),
                  "positions": jnp.asarray(dpos)}, jcache)
    d, _ = model.decode_step(params, cfg, {
        "tokens": torch.from_numpy(toks[:, :1]),
        "positions": torch.from_numpy(dpos)}, cache, S, device="cpu")
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), **TOL)

    batch = {"tokens": toks, "targets": _tokens(cfg, S, seed=4),
             "positions": pos}
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, b: jax_model.train_loss(p, jcfg, b), has_aux=True))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                              device="cpu")
    leaves = [tparams["embed"], tparams["layers"][0]["attn"]["wq"],
              tparams["layers"][1]["attn"]["wk"]]
    for t in leaves:
        t.requires_grad_(True)
    loss, _ = model.train_loss(tparams, cfg, {k: torch.from_numpy(v) for k, v
                                              in batch.items()}, device="cpu")
    got = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    want = from_jax_params(cfg, jax.tree_util.tree_map(np.asarray, jgrads),
                           device="cpu")
    for g, w in zip(got, [want["embed"], want["layers"][0]["attn"]["wq"],
                          want["layers"][1]["attn"]["wk"]]):
        w = w.numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max())


