"""Port parity for the training substrate: optimizer, data pipeline,
checkpointing, the in-step gradient compression, and the train step and
CLI end to end.

Each case of tests/test_train_substrate.py that covers ``repro.train`` or
the int8 pair of ``repro.distributed.grad_compress`` runs through both
packages: the reference's assertion on the port, and the port's numbers
against the reference's where both compute them (one ``apply_updates`` on
the same state and gradients within 1e-6, the schedule, the data, the
int8 payload).  The fault-tolerance cases were ported with the chaos layer
(tests/test_torch_chaos.py).  The end-to-end cases are those of
tests/test_train_e2e.py on the port: gradient accumulation, a falling loss
through ``repro_torch.launch.train.main``, and a run that dies and resumes
from its checkpoint in a child process.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs.base import get_config as jax_get_config
from repro.configs.base import reduced as jax_reduced
from repro.distributed import grad_compress as jax_gc
from repro.train import optimizer as jax_opt
from repro.train.data import DataConfig as JaxDataConfig
from repro.train.data import TokenStream as JaxTokenStream
from repro_torch.configs.base import get_config, reduced
from repro_torch.distributed import grad_compress
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train import train_loop
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.data import DataConfig, TokenStream
from repro_torch.train.tree import flatten_with_path, leaves, unflatten

ROOT = Path(__file__).resolve().parents[1]


# --- optimizer --------------------------------------------------------------


def test_adamw_minimises_quadratic():
    params = {"w": torch.tensor([3.0, -2.0])}
    state = opt.init_state(params)
    cfg = opt.OptConfig(lr=0.1, warmup_steps=0, total_steps=100,
                        weight_decay=0.0)
    for _ in range(100):
        grads = {"w": 2 * params["w"]}
        params, state, m = opt.apply_updates(params, grads, state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_clip_norm():
    params = {"w": torch.zeros(3)}
    state = opt.init_state(params)
    cfg = opt.OptConfig(lr=1e-3, clip_norm=1.0, warmup_steps=0)
    _, _, metrics = opt.apply_updates(
        params, {"w": torch.tensor([1e4, 0.0, 0.0])}, state, cfg)
    assert float(metrics["grad_norm"]) > 1e3  # raw norm reported


@pytest.mark.parametrize("step", [0, 1, 5, 10, 11, 50, 99, 100, 150])
def test_schedule_matches_reference(step):
    cfg = opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    jcfg = jax_opt.OptConfig(lr=1.0, warmup_steps=10, total_steps=100)
    got = float(opt.schedule(cfg, step))
    assert got == pytest.approx(float(jax_opt.schedule(jcfg, step)),
                                rel=1e-6, abs=1e-7)
    if step == 0:
        assert got < 0.11
    if step == 10:
        assert got == pytest.approx(1.0, rel=0.01)
    if step == 100:
        assert got < 0.2


def _tree(rng):
    """Leaves of 1, 2 and 3 dimensions, as numpy arrays."""
    return {"a": rng.standard_normal((4, 6)).astype(np.float32),
            "b": [rng.standard_normal(5).astype(np.float32),
                  rng.standard_normal((2, 3, 4)).astype(np.float32)]}


@pytest.mark.parametrize("clip_norm", [1.0, 1e-2])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_apply_updates_matches_reference(clip_norm, n_steps):
    """The same params, gradients and moments through both optimizers: the
    new params and moments within 1e-6, grad_norm and lr within 1e-6
    relative; with decay on the matrices and clipping active at 1e-2."""
    rng = np.random.default_rng(n_steps)
    p_np = _tree(rng)
    cfg = opt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                        clip_norm=clip_norm)
    jcfg = jax_opt.OptConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                             clip_norm=clip_norm)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jstate = jax_opt.init_state(jp)
    params = unflatten(p_np, [torch.from_numpy(np.array(x))
                              for x in leaves(p_np)])
    state = opt.init_state(params)
    for _ in range(n_steps):
        g_np = _tree(rng)
        jp, jstate, jm = jax_opt.apply_updates(
            jp, jax.tree_util.tree_map(jnp.asarray, g_np), jstate, jcfg)
        params, state, m = opt.apply_updates(
            params, unflatten(params, [torch.from_numpy(x)
                                       for x in leaves(g_np)]), state, cfg)
        assert float(m["grad_norm"]) == pytest.approx(float(jm["grad_norm"]),
                                                      rel=1e-6)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(state.step) == int(jstate.step) == n_steps
    for got, want in ((params, jp), (state.mu, jstate.mu),
                      (state.nu, jstate.nu)):
        for (path, g), w in zip(flatten_with_path(got),
                                jax.tree_util.tree_leaves(want), strict=True):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=1e-6, err_msg=str(path))


def test_apply_updates_keeps_bf16_params_and_f32_moments():
    params = {"w": torch.ones((4, 4), dtype=torch.bfloat16)}
    state = opt.init_state(params)
    assert state.mu["w"].dtype == torch.float32
    params, state, _ = opt.apply_updates(
        params, {"w": torch.full((4, 4), 0.5, dtype=torch.bfloat16)}, state,
        opt.OptConfig(lr=1e-2, warmup_steps=0))
    assert params["w"].dtype == torch.bfloat16
    assert float(params["w"].float().max()) < 1.0
    assert state.nu["w"].dtype == torch.float32


def test_decay_follows_the_given_ndims():
    """The train step hands the reference tree's ndims: a 1-D leaf of the
    scanned stack is decayed as the reference's stacked (n_rep, D) is."""
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5)
    outs = []
    for nd in (1, 2):
        params = {"n": torch.ones(3)}
        params, _, _ = opt.apply_updates(params, {"n": torch.zeros(3)},
                                         opt.init_state(params), cfg,
                                         ndims={"n": nd})
        outs.append(float(params["n"][0]))
    assert outs[0] == 1.0 and outs[1] < 1.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update_in_pieces_equals_the_whole_update(monkeypatch, dtype):
    """AdamW over a leaf in pieces of ``UPDATE_CHUNK`` entries (flat views
    written in place; a transposed gradient read alike) gives the bits of
    the update of the whole leaf, over two steps."""
    gen = torch.Generator().manual_seed(3)
    params = {"w": torch.randn(6, 10, generator=gen).to(dtype),
              "b": torch.randn(7, generator=gen).to(dtype)}
    grads = {"w": torch.randn(10, 6, generator=gen).to(dtype).T,
             "b": torch.randn(7, generator=gen).to(dtype)}
    cfg = opt.OptConfig(lr=1e-2, warmup_steps=0)
    runs = []
    for chunk in (opt.UPDATE_CHUNK, 4):
        monkeypatch.setattr(opt, "UPDATE_CHUNK", chunk)
        p = {k: v.clone() for k, v in params.items()}
        state = opt.init_state(p)
        for _ in range(2):
            p, state, _ = opt.apply_updates(p, grads, state, cfg)
        runs.append((p, state.mu, state.nu))
    for whole, pieces in zip(*runs):
        for k in params:
            assert torch.equal(whole[k], pieces[k]), k


# --- data -------------------------------------------------------------------


def test_data_deterministic_and_shardwise_distinct():
    cfg = reduced(get_config("qwen3-8b"))
    s0 = TokenStream(cfg, 4, 32, DataConfig(), shard=0, n_shards=2)
    s0b = TokenStream(cfg, 4, 32, DataConfig(), shard=0, n_shards=2)
    s1 = TokenStream(cfg, 4, 32, DataConfig(), shard=1, n_shards=2)
    a, b, c = s0.batch_at(7), s0b.batch_at(7), s1.batch_at(7)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].min() >= 0


@pytest.mark.parametrize("name", ["qwen3-8b", "hubert-xlarge", "qwen2-vl-7b"])
@pytest.mark.parametrize("mask_frac", [0.0, 0.3])
def test_data_equals_reference(name, mask_frac):
    want = JaxTokenStream(jax_reduced(jax_get_config(name)), 2, 16,
                          JaxDataConfig(mask_frac=mask_frac)).batch_at(3)
    got = TokenStream(reduced(get_config(name)), 2, 16,
                      DataConfig(mask_frac=mask_frac)).batch_at(3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


# --- checkpoint -------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6).reshape(2, 3).float(),
            "b": {"c": torch.ones(4, dtype=torch.int32)},
            "h": torch.randn(3, 5).to(torch.bfloat16),
            "s": opt.OptState(torch.tensor(3, dtype=torch.int32), {}, [])}
    d = str(tmp_path)
    ckpt.save(d, 3, tree)
    assert ckpt.latest_step(d) == 3
    assert ckpt.verify(d, 3)
    back = ckpt.restore(d, 3, tree)
    for (path, g), (_, w) in zip(flatten_with_path(back),
                                 flatten_with_path(tree), strict=True):
        assert g.dtype == w.dtype, path
        assert torch.equal(g, w), path
    assert isinstance(back["s"], opt.OptState)


def test_checkpoint_manifest_names_bf16(tmp_path):
    import json

    path = ckpt.save(str(tmp_path), 1, {"w": torch.ones(2, 2,
                                                        dtype=torch.bfloat16)})
    meta = json.load(open(os.path.join(path, "MANIFEST.json")))
    assert meta["files"]["w"]["dtype"] == "bfloat16"
    assert np.load(os.path.join(path, meta["files"]["w"]["file"])).dtype \
        == np.uint16


def test_checkpoint_keeps_requires_grad(tmp_path):
    tree = {"w": torch.zeros(3, requires_grad=True)}
    ckpt.save(str(tmp_path), 2, tree)
    assert ckpt.restore(str(tmp_path), 2, tree)["w"].requires_grad


def test_checkpoint_atomicity(tmp_path):
    """A torn write (leftover .tmp) is never visible as a checkpoint."""
    d = str(tmp_path)
    tree = {"a": torch.ones(3)}
    ckpt.save(d, 1, tree)
    os.makedirs(os.path.join(d, "step_00000002.tmp"))
    assert ckpt.latest_step(d) == 1


def test_checkpoint_detects_corruption(tmp_path):
    d = str(tmp_path)
    tree = {"a": torch.ones(8)}
    path = ckpt.save(d, 5, tree)
    fn = [f for f in os.listdir(path) if f.endswith(".npy")][0]
    with open(os.path.join(path, fn), "r+b") as f:
        f.seek(-1, 2)
        f.write(b"\x7f")
    assert not ckpt.verify(d, 5)


def test_checkpoint_refuses_another_structure(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.ones(2)})
    with pytest.raises(ValueError, match="mismatch"):
        ckpt.restore(str(tmp_path), 1, {"b": torch.ones(2)})


# --- grad compression -------------------------------------------------------


@given(st.integers(0, 1000))
@settings(max_examples=25, deadline=None)
def test_int8_compress_error_bounded(seed):
    rng = np.random.default_rng(seed)
    g_np = (rng.standard_normal(256) * rng.uniform(0.01, 10)).astype(np.float32)
    g = torch.from_numpy(g_np)
    q, scale = grad_compress.compress(g)
    back = grad_compress.decompress(q, scale)
    err = float((back - g).abs().max())
    assert err <= float(scale) * 0.5 + 1e-9  # half-ULP of the quant grid
    jq, jscale = jax_gc.compress(jnp.asarray(g_np))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(scale) == float(jscale)


def test_error_feedback_unbiased():
    """With error feedback, the running sum of decompressed grads tracks
    the true sum (bias -> 0), and each step equals the reference's."""
    rng = np.random.default_rng(0)
    residual = torch.zeros(64)
    jres = jnp.zeros(64)
    tot_true = np.zeros(64)
    tot_sent = np.zeros(64)
    for _ in range(200):
        g = rng.standard_normal(64).astype(np.float32)
        q, s, residual = grad_compress.compress_with_feedback(
            torch.from_numpy(g), residual)
        jq, js, jres = jax_gc.compress_with_feedback(jnp.asarray(g), jres)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        tot_true += g
        tot_sent += grad_compress.decompress(q, s).numpy()
    drift = np.abs(tot_sent - tot_true).max()
    assert drift < 0.2  # bounded by one quantisation step
    np.testing.assert_allclose(residual.numpy(), np.asarray(jres), atol=1e-6)


def test_topk_roundtrip():
    g = torch.from_numpy(np.random.default_rng(1).standard_normal((8, 8)))
    vals, idx = grad_compress.topk_compress(g, frac=0.25)
    back = grad_compress.topk_decompress(vals, idx, g.shape)
    kept = back.numpy() != 0
    assert kept.sum() == 16
    np.testing.assert_allclose(back.numpy()[kept], g.numpy()[kept], rtol=1e-6)
    jvals, jidx = jax_gc.topk_compress(jnp.asarray(g.numpy()), frac=0.25)
    assert sorted(idx.tolist()) == sorted(np.asarray(jidx).tolist())


# --- the train step and CLI, end to end ---------------------------------


def test_grad_accum_equivalence():
    """accum=2 over a doubled batch matches a single step on the same data
    (the reference's test, on the port)."""
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    batch = TokenStream(cfg, 8, 32, DataConfig()).batch_at(0)
    outs = {}
    for accum in (1, 2):
        tc = train_loop.TrainConfig(accum_steps=accum, remat=False,
                                    opt=OptConfig(lr=1e-3, warmup_steps=0))
        step = train_loop.make_train_step(cfg, tc)
        state = train_loop.init_state(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        new_state, metrics = step(state, batch)
        outs[accum] = (float(metrics["loss"]),
                       leaves(new_state.params)[0].detach().float().numpy())
    assert abs(outs[1][0] - outs[2][0]) < 5e-3
    np.testing.assert_allclose(outs[1][1], outs[2][1], rtol=2e-2, atol=2e-4)


def test_compressed_grads_step():
    """--compress-grads: the step sees int8-quantised gradients."""
    cfg = reduced(get_config("stablelm-1.6b"), n_layers=2)
    batch = TokenStream(cfg, 2, 16, DataConfig()).batch_at(0)
    losses = []
    for compress in (False, True):
        tc = train_loop.TrainConfig(compress_grads=compress,
                                    opt=OptConfig(lr=1e-3, warmup_steps=0))
        state = train_loop.init_state(cfg, torch.Generator().manual_seed(0),
                                      device="cpu")
        state, m = train_loop.make_train_step(cfg, tc)(state, batch)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert losses[0] == losses[1]  # compression acts after the loss


def test_train_loss_decreases():
    from repro_torch.launch.train import main

    out = main(["--arch", "stablelm-1.6b", "--reduced", "--steps", "12",
                "--batch", "4", "--seq", "64", "--lr", "3e-3",
                "--device", "cpu"])
    losses = out["losses"]
    assert len(losses) == 12 and np.all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_train_cli_records_a_run(tmp_path):
    from repro_torch.launch.train import main

    main(["--reduced", "--steps", "2", "--batch", "2", "--seq", "16",
          "--device", "cpu", "--obs-dir", str(tmp_path), "--trace"])
    import json

    run = json.loads((tmp_path / "run.json").read_text())
    assert run["meta"]["layer"] == "train"
    assert run["meta"]["device"] == "cpu"


def test_failure_resume(tmp_path):
    """Kill training mid-run, restart, verify it resumes from the checkpoint
    and finishes (the reference's node-failure recovery test, on the
    port)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    args = [
        sys.executable, "-m", "repro_torch.launch.train",
        "--arch", "stablelm-1.6b", "--reduced", "--steps", "9",
        "--batch", "2", "--seq", "32", "--ckpt-dir", str(tmp_path),
        "--ckpt-every", "3", "--device", "cpu",
    ]
    p1 = subprocess.run(args + ["--simulate-failure", "5"],
                        capture_output=True, text=True, env=env, cwd=ROOT)
    assert p1.returncode == 17, p1.stderr  # simulated hard failure
    # failure hits at step 5, after the step-6 checkpoint committed
    assert ckpt.latest_step(str(tmp_path)) == 6
    assert ckpt.verify(str(tmp_path), 6)

    p2 = subprocess.run(args, capture_output=True, text=True, env=env,
                        cwd=ROOT)
    assert p2.returncode == 0, p2.stderr
    assert "resumed from step 6" in p2.stdout
    assert "step 8" in p2.stdout
