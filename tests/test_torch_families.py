"""Port parity for the model families beyond dense attention and Mamba: the
six configs registered with the MoE, hybrid, windowed, M-RoPE/vision and
encoder-only paths, reduced and in f32 on the CPU (the kernels' plain
versions), the reference's parameters carried over with
``from_jax_params``, against ``repro.models.model.prefill`` and
``decode_step``.

Prefill logits and every cache leaf agree within 1e-4, then 8 greedy decode
steps (none for hubert); decode against prefill within the reference's
2e-3 (tests/test_models_smoke.py).  The cases:

* qwen2-moe (a shared expert), qwen3-moe at G=1 and at ``n_heads=16,
  n_kv_heads=1`` (G = 16, the full config's group);
* jamba's 16-layer hybrid: 14 Mamba and 2 attention layers, MoE on the odd
  layers after both kinds of mixer, no rope.  Under the reference's
  ``fan_in`` rule its stacked weights have std 1/sqrt(2) at width 64, its
  residual reaches ~1e11, and the reference's own logits move by ~2.5e-3
  when its embeddings move by 1e-7 (relative): one-ulp differences between
  XLA's and PyTorch's arithmetic cannot stay within 1e-4 end to end.  So
  every layer is held to 1e-4 of its scale on the reference's input to
  that layer, in prefill and in 8 decode steps, and the end-to-end logits
  to the reference's own response to that 1e-7 noise;
* gemma3 (window 16, every 6th layer global) prefilling 32 tokens and
  decoding past the window, its last 16 cache rows read through a view;
* qwen2-vl with vision embeddings over the first rows and three different
  position streams (equal streams reduce M-RoPE to plain RoPE and would
  hide a wrong section split), in prefill and decode;
* hubert's encoder-only forward from frames (non-causal, no cache).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import list_configs as jax_list_configs
from repro.configs.base import reduced as jax_reduced
from repro.configs.base import scan_period
from repro.configs.base import layer_specs as jax_layer_specs
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro_torch.configs.base import get_config, layer_specs, list_configs, reduced
from repro_torch.models import blocks, model
from repro_torch.models.params import count_params, from_jax_params

TOL = dict(rtol=1e-4, atol=1e-4)
TOL_DECODE_VS_PREFILL = dict(rtol=2e-3, atol=2e-3)
B, S, N_DECODE = 2, 32, 8
NEW = ["qwen2-moe-a2.7b", "qwen3-moe-235b-a22b", "jamba-v0.1-52b",
       "gemma3-27b", "qwen2-vl-7b", "hubert-xlarge"]

CASES = {
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen3-moe": ("qwen3-moe-235b-a22b", {}),
    "qwen3-moe-G16": ("qwen3-moe-235b-a22b", {"n_heads": 16, "n_kv_heads": 1}),
    "jamba": ("jamba-v0.1-52b", {}),
    "gemma3": ("gemma3-27b", {}),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "hubert": ("hubert-xlarge", {}),
}
_MODELS: dict = {}


def _model(case):
    """(reference cfg, port cfg, reference params, port params), cached."""
    if case not in _MODELS:
        name, overrides = CASES[case]
        jcfg = jax_reduced(jax_get_config(name), **overrides)
        cfg = reduced(get_config(name), **overrides)
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jparams)
        _MODELS[case] = (jcfg, cfg, jparams,
                         from_jax_params(cfg, tree, device="cpu"))
    return _MODELS[case]


def _positions(S0, n, seed):
    """(B, n, 3) positions from S0: stream 0 the row index, streams 1 and 2
    different from it and from each other."""
    rng = np.random.default_rng(seed)
    idx = np.arange(S0, S0 + n, dtype=np.int32)
    pos = np.stack([idx, idx // 4 + rng.integers(0, 3, n),
                    idx % 4 + rng.integers(0, 5, n)], -1).astype(np.int32)
    return np.broadcast_to(pos, (B, n, 3)).copy()


def _batch(cfg, S_, seed=1):
    """The prefill batch of a config, as numpy arrays."""
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio_frames":
        return {"frames": rng.standard_normal(
            (B, S_, cfg.d_model)).astype(np.float32)}
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S_)).astype(np.int32)}
    if cfg.frontend == "vision":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
        batch["positions"] = _positions(0, S_, seed)
    return batch


def _decode_batch(cfg, tok, n):
    batch = {"tokens": tok}
    if cfg.frontend == "vision":
        batch["positions"] = _positions(n, 1, n)
    return batch


def _ref_layer(jcache, cfg, i):
    P = scan_period(cfg)
    n_rep = cfg.n_layers // P
    if i < n_rep * P:
        return {k: np.asarray(v[i // P]) for k, v in jcache["body"][i % P].items()}
    return {k: np.asarray(v) for k, v in jcache["rem"][i - n_rep * P].items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_all_ten_configs_registered():
    assert list_configs() == jax_list_configs()
    for name in list_configs():
        assert get_config(name).__dict__ == jax_get_config(name).__dict__
        assert reduced(get_config(name)).__dict__ == jax_reduced(
            jax_get_config(name)).__dict__


@pytest.mark.parametrize("case", list(CASES))
def test_from_jax_params_carries_every_leaf(case):
    jcfg, cfg, jparams, params = _model(case)
    n_ref = sum(np.asarray(a).size for a in jax.tree_util.tree_leaves(jparams))
    assert count_params(params) == n_ref
    moe_layers = [i for i, s in enumerate(layer_specs(cfg)) if s.mlp == "moe"]
    if moe_layers:  # the router and experts of the last MoE layer
        i = moe_layers[-1]
        P = scan_period(cfg)
        n_rep = cfg.n_layers // P
        stack = jparams["stack"]
        for leaf in ("w_router", "w_gate", "w_up", "w_down"):
            if i < n_rep * P:
                want = np.asarray(stack["body"][i % P]["moe"][leaf])[i // P]
            else:
                want = np.asarray(stack["rem"][i - n_rep * P]["moe"][leaf])
            np.testing.assert_array_equal(
                params["layers"][i]["moe"][leaf].numpy(), want)


@pytest.mark.parametrize("case", [c for c in CASES if c != "jamba"])
def test_prefill_and_decode_match_reference(case):
    """Prefill logits and every cache leaf, then 8 greedy decode steps from
    that cache, against the reference."""
    jcfg, cfg, jparams, params = _model(case)
    max_len = S + N_DECODE
    batch = _batch(cfg, S)
    jlogits, jcache = jax.jit(lambda p, b: jax_model.prefill(
        p, jcfg, b, max_len=max_len))(
            jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    logits, cache = model.prefill(params, cfg, _torch_batch(batch),
                                  max_len=max_len, device="cpu")
    assert logits.shape == (B, cfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    if cfg.encoder_only:
        assert cache is None and jcache is None
        with pytest.raises(ValueError, match="encoder-only"):
            model.decode_step(params, cfg, {"tokens": np.zeros((B, 1), np.int32)},
                              None, S, device="cpu")
        return
    for i, layer in enumerate(cache):
        want = _ref_layer(jcache, cfg, i)
        assert sorted(layer) == sorted(want), f"layer {i}"
        for leaf, got in layer.items():
            tol = dict(TOL)
            if leaf == "h":  # the SSM state's scale (tests/test_torch_prefill.py)
                tol["atol"] *= max(1.0, float(np.abs(want[leaf]).max()))
            np.testing.assert_allclose(got.numpy(), want[leaf], **tol,
                                       err_msg=f"layer {i} {leaf}")

    jdecode = jax.jit(lambda p, b, c, n: jax_model.decode_step(p, jcfg, b, c, n))
    tok = np.asarray(jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32))
    for n in range(S, S + N_DECODE):
        db = _decode_batch(cfg, tok, n)
        jlogits, jcache = jdecode(
            jparams, {k: jnp.asarray(v) for k, v in db.items()}, jcache,
            jnp.asarray(n))
        logits, cache = model.decode_step(params, cfg, _torch_batch(db), cache,
                                          n, device="cpu")
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL,
                                   err_msg=f"decode at {n}")
        tok = np.asarray(jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32))
        assert torch.argmax(logits, -1).tolist() == tok[:, 0].tolist()
    for i, layer in enumerate(cache):
        want = _ref_layer(jcache, cfg, i)
        for leaf, got in layer.items():
            tol = dict(TOL)
            if leaf == "h":
                tol["atol"] *= max(1.0, float(np.abs(want[leaf]).max()))
            np.testing.assert_allclose(got.numpy(), want[leaf], **tol,
                                       err_msg=f"after decode: layer {i} {leaf}")


def _close(got, want, what):
    """Within 1e-4 of ``want``'s scale (its largest entry, at least 1)."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * scale, err_msg=what)


def test_jamba_layerwise_matches_reference():
    """Each layer of the reduced jamba, fed the reference's input to that
    layer: its output, aux and cache leaves within 1e-4 of their scale in
    prefill (S=32) and in 8 decode steps after it; then the whole forward's
    logits within 4x the reference's own move under 1e-7 input noise."""
    jcfg, cfg, jparams, params = _model("jamba")
    P = scan_period(jcfg)
    stack = jparams["stack"]
    lp = [jax.tree_util.tree_map(lambda a, i=i: a[i // P], stack["body"][i % P])
          for i in range(cfg.n_layers)]
    jspecs, specs = jax_layer_specs(jcfg), layer_specs(cfg)
    max_len = S + N_DECODE
    jcache = jax_model.init_cache(jcfg, B, max_len)
    jc = [jax.tree_util.tree_map(lambda a, i=i: a[i // P], jcache["body"][i % P])
          for i in range(cfg.n_layers)]
    cache = model.init_cache(cfg, B, max_len, device="cpu")
    jlayer = jax.jit(lambda i, p, x, pos, c, n: jax_blocks.apply_layer(
        jcfg, jspecs[i], p, x, pos, c, n), static_argnums=0)
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, (B, S + N_DECODE)).astype(np.int32)
    steps = [(0, S)] + [(n, 1) for n in range(S, S + N_DECODE)]
    for start, n in steps:
        x = np.asarray(jparams["embed"])[toks[:, start:start + n]]
        pos = jnp.broadcast_to(jnp.arange(start, start + n), (B, n))
        kv_len = torch.full((B,), start + n, dtype=torch.int32)
        for i in range(cfg.n_layers):
            jx, jc[i], jaux = jlayer(i, lp[i], jnp.asarray(x), pos, jc[i],
                                     jnp.asarray(start))
            got, aux = blocks.apply_layer(
                cfg, specs[i], params["layers"][i], torch.from_numpy(x), None,
                cache[i], None if start == 0 else start, kv_len)
            what = f"layer {i} ({specs[i].kind}/{specs[i].mlp}) at {start}"
            _close(got, jx, what)
            np.testing.assert_allclose(float(aux), float(jaux), **TOL,
                                       err_msg=what)
            for leaf, c in cache[i].items():
                _close(c, jc[i][leaf], f"{what}: {leaf}")
            x = np.array(jx)

    batch = {"tokens": toks[:, :S]}
    f = jax.jit(lambda p, t: jax_model.prefill(p, jcfg, {"tokens": t})[0])
    jlogits = np.asarray(f(jparams, jnp.asarray(batch["tokens"])))
    moved = 0.0  # the most of three draws of the noise
    for seed in range(3):
        noisy = dict(jparams)
        noisy["embed"] = jparams["embed"] * (1 + 1e-7 * jax.random.normal(
            jax.random.PRNGKey(seed), jparams["embed"].shape))
        moved = max(moved, float(np.abs(np.asarray(
            f(noisy, jnp.asarray(batch["tokens"]))) - jlogits).max()))
    logits, _ = model.prefill(params, cfg, _torch_batch(batch), device="cpu")
    err = float(np.abs(logits.numpy() - jlogits).max())
    assert err <= 1e-4 + 4 * moved, (err, moved)


@pytest.mark.parametrize("case", ["gemma3", "qwen2-vl", "jamba"])
def test_decode_matches_prefill(case):
    """Teacher-forced decode over the prompt gives the prefill's last logits:
    gemma3 decodes past its window of 16, qwen2-vl with its three streams.
    (Not for MoE configs: capacity makes prefill and decode different
    functions.)"""
    _, cfg, _, params = _model(case)
    batch = _batch(cfg, S, seed=3)
    # decode takes tokens: qwen2-vl's prompt here has no vision rows
    batch.pop("vision_embeds", None)
    logits_p, _ = model.prefill(params, cfg, _torch_batch(batch), device="cpu")
    cache = model.init_cache(cfg, B, S, device="cpu")
    for t in range(S):
        db = {k: torch.from_numpy(v[:, t:t + 1]) for k, v in batch.items()}
        logits_d, cache = model.decode_step(params, cfg, db, cache, t,
                                            device="cpu")
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(),
                               **TOL_DECODE_VS_PREFILL)


@pytest.mark.parametrize("case", ["qwen2-moe", "qwen3-moe-G16"])
def test_moe_decode_matches_prefill_where_nothing_drops(case):
    """At S = 8 the prefill's one group of 8 tokens has a capacity of 8 for
    every expert, so no (token, k) pair drops, and teacher-forced decode
    (one token a group) gives the prefill's logits.  At S = 32 pairs drop
    and the two are different functions."""
    from repro_torch.models import moe

    _, cfg, _, params = _model(case)
    S8 = 8
    assert moe._capacity(S8, cfg.top_k, cfg.n_experts) >= S8
    toks = torch.from_numpy(_batch(cfg, S8, seed=6)["tokens"])
    logits_p, _ = model.prefill(params, cfg, {"tokens": toks}, device="cpu")
    cache = model.init_cache(cfg, B, S8, device="cpu")
    for t in range(S8):
        logits_d, cache = model.decode_step(
            params, cfg, {"tokens": toks[:, t:t + 1]}, cache, t, device="cpu")
    np.testing.assert_allclose(logits_p.numpy(), logits_d.numpy(),
                               **TOL_DECODE_VS_PREFILL)


def test_vision_prefill_then_decode_matches_longer_prefill():
    """prefill(S-1) with the vision rows and three streams, then one decode
    step, gives prefill(S)'s last logits: the check ``chip_smoke.py`` runs
    at full size."""
    _, cfg, _, params = _model("qwen2-vl")
    batch = _torch_batch(_batch(cfg, S, seed=4))
    full, _ = model.prefill(params, cfg, batch, device="cpu")
    short = {k: (v[:, :S - 1] if k != "vision_embeds" else v)
             for k, v in batch.items()}
    _, cache = model.prefill(params, cfg, short, max_len=S, device="cpu")
    step, _ = model.decode_step(
        params, cfg, {"tokens": batch["tokens"][:, S - 1:],
                      "positions": batch["positions"][:, S - 1:]},
        cache, S - 1, device="cpu")
    np.testing.assert_allclose(full.numpy(), step.numpy(),
                               **TOL_DECODE_VS_PREFILL)


def test_positions_off_the_row_index_raise():
    """Stream 0 must be the row index: the reference's mask reads it, the
    port's kernels mask by index."""
    _, cfg, _, params = _model("qwen2-vl")
    batch = _torch_batch(_batch(cfg, S))
    batch["positions"][1, 5, 0] += 1
    with pytest.raises(NotImplementedError, match="positions"):
        model.prefill(params, cfg, batch, device="cpu")
    cache = model.init_cache(cfg, B, S + 1, device="cpu")
    pos = torch.from_numpy(_positions(3, 1, 0))
    with pytest.raises(NotImplementedError, match="positions"):
        model.decode_step(params, cfg, {"tokens": batch["tokens"][:, :1],
                                        "positions": pos}, cache, 0,
                          device="cpu")


def test_too_many_vision_embeddings_raise():
    _, cfg, _, params = _model("qwen2-vl")
    batch = _torch_batch(_batch(cfg, 4))
    del batch["positions"]
    with pytest.raises(ValueError, match="vision embeddings"):
        model.prefill(params, cfg, batch, device="cpu")
