"""Port parity for training on the CPU: ``repro_torch.models.model.
train_loss`` and its gradients against ``jax.value_and_grad`` of
``repro.models.model.train_loss``, and one train step against the
reference's (the train step's other cases and the CLI are in
tests/test_torch_train_substrate.py).

The reduced configs run in f32 with the kernels' plain versions (autograd
through them); the reference's parameters are carried over with
``from_jax_params``, and so are its gradients, leaf by leaf.  The loss must
agree within 1e-5 relative, every gradient leaf within 1e-4 of that leaf's
largest |g|, or within 4x the reference's own move under 1e-7 relative
noise on its embeddings where that is larger: the reduced stablelm (no
qk-norm, std 1/sqrt(2) weights at width 64 under the reference's
``fan_in`` rule) is so ill-conditioned that its own gradients move by up to
~1e-3 of a leaf's scale under that noise, where qwen3's move by ~1e-6.
Batches come from the data pipeline (the reference's and the port's copy
give equal arrays).  The cases: stablelm, qwen3-8b at G = 2,
gemma3 (a window of 16 at S = 32), qwen2-moe (the aux loss), qwen2-vl
(vision rows and three position streams), hubert (frames, non-causal),
falcon-mamba (the scan's gradient through two chunks at S = 512 too), and
jamba layer by layer: its reduced stack is ill-conditioned in the reference
itself (tests/test_torch_families.py), so each layer's VJP is held on the
reference's input to that layer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import layer_specs as jax_layer_specs
from repro.configs.base import reduced as jax_reduced
from repro.configs.base import scan_period
from repro.models import blocks as jax_blocks
from repro.models import model as jax_model
from repro.train import train_loop as jax_train_loop
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import TokenStream as JaxTokenStream
from repro.train.optimizer import OptConfig as JaxOptConfig
from repro_torch.configs.base import get_config, layer_specs, reduced
from repro_torch.models import blocks, model
from repro_torch.models.params import from_jax_params
from repro_torch.train import train_loop
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.tree import flatten_with_path, leaves

B, S = 2, 32
LOSS_RTOL = 1e-5
GRAD_REL = 1e-4

CASES = {
    "stablelm": ("stablelm-1.6b", {}),
    "qwen3-G2": ("qwen3-8b", {"n_kv_heads": 2}),
    "gemma3": ("gemma3-27b", {}),
    "qwen2-moe": ("qwen2-moe-a2.7b", {}),
    "qwen2-vl": ("qwen2-vl-7b", {}),
    "hubert": ("hubert-xlarge", {}),
    "falcon-mamba": ("falcon-mamba-7b", {"n_layers": 2}),
    "jamba": ("jamba-v0.1-52b", {}),
}
_MODELS: dict = {}


def _model(case):
    """(reference cfg, port cfg, reference params, numpy tree), cached."""
    if case not in _MODELS:
        name, overrides = CASES[case]
        jcfg = jax_reduced(jax_get_config(name), **overrides)
        cfg = reduced(get_config(name), **overrides)
        jparams = jax_model.init_params(jcfg, jax.random.PRNGKey(0))
        _MODELS[case] = (jcfg, cfg, jparams,
                         jax.tree_util.tree_map(np.asarray, jparams))
    return _MODELS[case]


def _trainable(cfg, tree):
    params = from_jax_params(cfg, tree, device="cpu")
    for p in leaves(params):
        p.requires_grad_(True)
    return params


def _batch(jcfg, cfg, S_=S, seed=0):
    """A batch of the data pipeline, equal in both packages; qwen2-vl's
    position streams 1 and 2 made to differ from stream 0."""
    want = JaxTokenStream(jcfg, B, S_, JaxDataConfig()).batch_at(seed)
    got = TokenStream(cfg, B, S_, DataConfig()).batch_at(seed)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    if "positions" in want:
        idx = np.arange(S_, dtype=np.int32)
        want["positions"][..., 1] = idx // 4
        want["positions"][..., 2] = idx % 4 + 1
    return want


_REF_FNS: dict = {}


def _ref_loss_and_grads(jcfg, jparams, batch, remat=False):
    key = (id(jcfg), remat)  # one compilation per config
    if key not in _REF_FNS:
        _REF_FNS[key] = jax.jit(jax.value_and_grad(
            lambda p, b: jax_model.train_loss(p, jcfg, b, remat=remat),
            has_aux=True))
    (loss, metrics), grads = _REF_FNS[key](jparams, {k: jnp.asarray(v)
                                         for k, v in batch.items()})
    return float(loss), metrics, grads


def _port_loss_and_grads(cfg, params, batch, remat=True):
    loss, metrics = model.train_loss(
        params, cfg, {k: torch.from_numpy(np.array(v)) for k, v in
                      batch.items()}, remat=remat, device="cpu")
    grads = torch.autograd.grad(loss, leaves(params), allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves(params), grads)]
    return float(loss.detach()), metrics, grads


def _noise_move(jcfg, jparams, batch, jgrads):
    """The reference's own move of each gradient entry, the most of two
    draws of 1e-7 relative noise on its embeddings."""
    moved = None
    for seed in range(2):
        noisy = dict(jparams)
        noisy["embed"] = jparams["embed"] * (1 + 1e-7 * jax.random.normal(
            jax.random.PRNGKey(seed), jparams["embed"].shape))
        _, _, g = _ref_loss_and_grads(jcfg, noisy, batch)
        d = jax.tree_util.tree_map(lambda a, b: jnp.abs(a - b), g, jgrads)
        moved = d if moved is None else jax.tree_util.tree_map(
            jnp.maximum, moved, d)
    return moved


def _assert_grads(cfg, params, grads, jgrads, moved):
    tree = lambda t: from_jax_params(  # noqa: E731
        cfg, jax.tree_util.tree_map(np.asarray, t), device="cpu")
    want, move = tree(jgrads), tree(moved)
    paths = [p for p, _ in flatten_with_path(params)]
    for path, g, (wpath, w), m in zip(paths, grads, flatten_with_path(want),
                                      leaves(move), strict=True):
        assert path == wpath
        w = w.numpy()
        atol = max(GRAD_REL * float(np.abs(w).max()), 4 * float(m.max()),
                   1e-30)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=atol,
                                   err_msg=f"grad {'/'.join(map(str, path))}")


@pytest.mark.parametrize("case", [c for c in CASES if c != "jamba"])
def test_train_loss_and_grads_match_reference(case):
    jcfg, cfg, jparams, tree = _model(case)
    batch = _batch(jcfg, cfg)
    jloss, jmetrics, jgrads = _ref_loss_and_grads(jcfg, jparams, batch)
    params = _trainable(cfg, tree)
    loss, metrics, grads = _port_loss_and_grads(cfg, params, batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    for k in ("nll", "aux"):
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  rel=LOSS_RTOL, abs=1e-7)
    if case == "qwen2-moe":
        assert float(metrics["aux"]) > 0
    _assert_grads(cfg, params, grads, jgrads,
                  _noise_move(jcfg, jparams, batch, jgrads))


@pytest.mark.parametrize("case,S_", [("stablelm", 1024),
                                     ("falcon-mamba", 512)])
def test_chunked_loss_and_scan_chunks_match_reference(case, S_):
    """S = 1024: the loss over two checkpointed chunks of 512; falcon-mamba
    at S = 512: two scan chunks of 256 chained through h0's gradient."""
    jcfg, cfg, jparams, tree = _model(case)
    batch = {k: v[:1] for k, v in _batch(jcfg, cfg, S_, seed=3).items()}
    jloss, _, jgrads = _ref_loss_and_grads(jcfg, jparams, batch)
    params = _trainable(cfg, tree)
    loss, _, grads = _port_loss_and_grads(cfg, params, batch)
    assert loss == pytest.approx(jloss, rel=LOSS_RTOL)
    _assert_grads(cfg, params, grads, jgrads,
                  _noise_move(jcfg, jparams, batch, jgrads))


def test_chunked_loss_refuses_a_ragged_length():
    _, cfg, _, tree = _model("stablelm")
    params = from_jax_params(cfg, tree, device="cpu")
    x = torch.zeros((1, 600, cfg.d_model))
    with pytest.raises(ValueError, match="multiple"):
        model.chunked_lm_loss(params, cfg, x, torch.zeros((1, 600)),
                              torch.ones((1, 600)))


@pytest.mark.parametrize("case", ["stablelm", "falcon-mamba", "qwen2-moe"])
def test_remat_gives_the_gradients_of_no_remat(case):
    jcfg, cfg, _, tree = _model(case)
    batch = _batch(jcfg, cfg, seed=1)
    params = _trainable(cfg, tree)
    on = _port_loss_and_grads(cfg, params, batch, remat=True)
    off = _port_loss_and_grads(cfg, params, batch, remat=False)
    assert on[0] == off[0]
    for a, b in zip(on[2], off[2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_jamba_layerwise_vjp_matches_reference():
    """Each layer of the reduced jamba (Mamba and attention mixers, MoE and
    dense MLPs), fed the reference's input to that layer: its output and
    the VJP of a fixed cotangent, for the layer's input and every
    parameter, within 1e-4 of each one's scale."""
    jcfg, cfg, jparams, tree = _model("jamba")
    P = scan_period(jcfg)
    stack = jparams["stack"]
    jspecs, specs = jax_layer_specs(jcfg), layer_specs(cfg)
    params = _trainable(cfg, tree)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    x = np.asarray(jparams["embed"])[toks]
    pos = jnp.broadcast_to(jnp.arange(S), (B, S))
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda a, i=i: a[i // P],
                                    stack["body"][i % P])
        ct = rng.standard_normal(x.shape).astype(np.float32)

        def f(p, xx, i=i):
            y, _, aux = jax_blocks.apply_layer(jcfg, jspecs[i], p, xx, pos)
            return y, aux
        (jy, jaux), vjp = jax.vjp(f, lp, jnp.asarray(x))
        jgp, jgx = vjp((jnp.asarray(ct), jnp.ones((), jnp.float32)))
        xt = torch.from_numpy(x).requires_grad_(True)
        lt = params["layers"][i]
        y, aux = blocks.apply_layer(cfg, specs[i], lt, xt, None, None)
        out = (y * torch.from_numpy(ct)).sum() + aux
        ps = leaves(lt)
        got = torch.autograd.grad(out, [xt] + ps, allow_unused=True)
        what = f"layer {i} ({specs[i].kind}/{specs[i].mlp})"

        def close(g, w, name):
            w = np.asarray(w)
            g = np.zeros_like(w) if g is None else g.detach().numpy()
            np.testing.assert_allclose(
                g, w, rtol=0, atol=GRAD_REL * max(float(np.abs(w).max()),
                                                  1e-30),
                err_msg=f"{what}: {name}")
        close(y, jy, "output")
        close(got[0], jgx, "d input")
        jflat = {"/".join(str(getattr(k, "key", k)) for k in path): a
                 for path, a in jax.tree_util.tree_flatten_with_path(jgp)[0]}
        for (path, _), g in zip(flatten_with_path(lt), got[1:], strict=True):
            close(g, jflat["/".join(map(str, path))], "/".join(map(str, path)))
        x = np.array(jy)


def _jax_state_as_numpy(jcfg, seed=0):
    state = jax_train_loop.init_state(jcfg, jax.random.PRNGKey(seed))
    return state, jax.tree_util.tree_map(np.asarray, state)


def test_one_train_step_matches_reference():
    """AdamW with clipping after one step from the reference's state
    carried over with ``state_from_jax``: params and moments within 1e-6.
    On qwen3 (G = 2), whose gradients agree to ~1e-6: the first step's
    update is g / (|g| + eps), which turns a gradient's relative error into
    the update's wherever the clipped |g| is near eps, so the ill-conditioned
    stablelm (above) cannot hold 1e-6 here."""
    jcfg, cfg, _, _ = _model("qwen3-G2")
    jstate, npstate = _jax_state_as_numpy(jcfg)
    batch = _batch(jcfg, cfg, seed=2)
    opt = dict(lr=1e-3, warmup_steps=0, clip_norm=1e-3)
    jstep = jax.jit(jax_train_loop.make_train_step(
        jcfg, jax_train_loop.TrainConfig(remat=False,
                                         opt=JaxOptConfig(**opt))))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = train_loop.state_from_jax(cfg, npstate, device="cpu")
    step = train_loop.make_train_step(cfg, train_loop.TrainConfig(
        opt=OptConfig(**opt)))
    new, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(float(jm["loss"]), rel=LOSS_RTOL)
    assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                  rel=1e-4)
    assert float(m["grad_norm"]) > 1e-3  # the clip is active
    assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    want = jax.tree_util.tree_map(np.asarray, jnew)
    for got_tree, want_tree in ((new.params, want.params),
                                (new.opt.mu, want.opt.mu),
                                (new.opt.nu, want.opt.nu)):
        w_tree = from_jax_params(cfg, want_tree, device="cpu")
        for (path, g), (_, w) in zip(flatten_with_path(got_tree),
                                     flatten_with_path(w_tree), strict=True):
            np.testing.assert_allclose(g.detach().numpy(), w.numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg="/".join(map(str, path)))
