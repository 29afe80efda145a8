"""Port parity for prefill and decode over a ("data", "model") mesh: the
reduced Qwen3-8B with two KV heads (G = 2), f32 on the CPU.

The reference's ``jax.jit`` prefill (``TRAIN_RULES``) and two decode steps
(``DECODE_RULES``, the cache placed by ``cache_specs``) run on meshes (1, 2),
(2, 2) and (1, 3) of four host devices in one JAX subprocess; the port runs
the same steps in gloo worlds of 2, 4 and 3 processes
(``tests/torch_sharded_world.py``).  The gathered logits and every cache
leaf are held to the reference's sharded outputs at ``TOL[float32]`` of
tests/test_kernels.py (2e-5).  The (1, 3) mesh puts 4 query heads and 2 KV
heads over 3 ranks: prefill takes the reference's head padding (4 -> 6
heads, K and V repeated to one head per query head) and every KV head is
replicated.  Decode splits the 24 cache rows over "model" on every mesh.
Each rank holds exactly the parameter and cache bytes its shards hold by
the rules, and the kernels' plain versions ran on local shapes.  The dry
run's execution of the same prefill and decode cells on a fake (2, 2)
group (rank 0 alone, meta tensors) records exactly the collectives that
rank 0 of the live world issued.
"""
import numpy as np
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, reduced

NAME, OVERRIDES = "qwen3-8b", {"n_kv_heads": 2}
MESHES = ((1, 2), (2, 2), (1, 3))
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py TOL[float32]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh tag: (the port's outputs, each rank's record)} and the
    reference's outputs."""
    return world.run_all(tmp_path_factory.mktemp("sharded_qwen3"), NAME,
                         OVERRIDES, MESHES)


@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_sharded_logits_equal_reference(runs, shape):
    (port, _), ref = runs[0][world.tag(shape)], runs[1]
    for i in range(1 + world.N_DECODE):
        np.testing.assert_allclose(port[f"logits{i}"],
                                   ref[f"{world.tag(shape)}/logits{i}"],
                                   **TOL, err_msg=f"logits {i}")


@pytest.mark.parametrize("step", ["prefill", "decode"])
@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_sharded_cache_equals_reference(runs, shape, step):
    (port, _), ref = runs[0][world.tag(shape)], runs[1]
    cfg = reduced(get_config(NAME), **OVERRIDES)
    for i in range(cfg.n_layers):
        want = world.ref_layer(ref, f"{world.tag(shape)}/{step}/", cfg, i)
        assert sorted(want) == ["k", "v"]
        for leaf, w in want.items():
            np.testing.assert_allclose(port[f"{step}/{i}/{leaf}"], w, **TOL,
                                       err_msg=f"layer {i} {leaf}")


@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_each_rank_holds_only_its_shards(runs, shape):
    _, ranks = runs[0][world.tag(shape)]
    for r, rec in enumerate(ranks):
        for key in ("params_train", "cache_train", "params_decode",
                    "cache_decode"):
            got, want = rec[f"bytes/{key}"]
            assert got == want, f"rank {r} {key}"
        # at tp 2 "model" splits every matrix: about half of the whole; at
        # tp 3 it divides no width of the reduced config
        half = rec["bytes/params_decode"][0] / rec["bytes/params_full"]
        assert 0.5 <= half < 0.55 if shape[1] == 2 else half == 1, f"rank {r}"


@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_kernels_ran_on_local_shards(runs, shape):
    """Prefill's flash_attention on the rank's heads (padded to 2 a rank
    at tp 3), decode's decode_attention on every head over the rank's
    cache rows."""
    dp, tp = shape
    cfg = reduced(get_config(NAME), **OVERRIDES)
    B, L = world.B // dp, world.S + 16
    heads = -(-cfg.n_heads // tp)
    kv_heads = cfg.n_kv_heads // tp if cfg.n_kv_heads % tp == 0 else heads
    _, ranks = runs[0][world.tag(shape)]
    world.assert_kernel_calls(ranks, {
        "flash_attention": [[[B, heads, world.S, cfg.head_dim],
                             [B, kv_heads, world.S, cfg.head_dim]]]
        * cfg.n_layers,
        "decode_attention": [[[B, cfg.n_heads, cfg.head_dim],
                              [B, cfg.n_kv_heads, L // tp, cfg.head_dim]]]
        * (cfg.n_layers * world.N_DECODE)})


def test_fake_group_records_the_live_collectives(runs):
    """Each kind's calls and wire bytes of prefill and of the first decode
    step (cache length S, as the dry run's decode cell has it): rank 0 of
    the live (2, 2) gloo world against ``dryrun.execute`` on a fake group,
    the same cells (the fake prefill fills a cache of S rows, the live one
    of S + DECODE_PAD: nothing moves the cache)."""
    got = world.fake_cells({
        step: (NAME, OVERRIDES, step, world.S, world.B, [2, 2])
        for step in ("prefill", "decode")})
    _, ranks = runs[0]["2x2"]
    for step, live in (("prefill", "collectives/prefill"),
                       ("decode", "collectives/decode0")):
        want = ranks[0][live]
        fake = {k: v for k, v in got[step]["collectives"].items()
                if k != "total_bytes"}
        assert sum(v["count"] for v in want.values()) > 0, step
        assert fake == want, step
