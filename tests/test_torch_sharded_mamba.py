"""Port parity for prefill and decode over a ("data", "model") mesh: the
reduced falcon-mamba-7b, f32 on the CPU.

As tests/test_torch_sharded_qwen3.py, for the Mamba mixer: the reference's
``jax.jit`` prefill (``TRAIN_RULES``) and two decode steps
(``DECODE_RULES``) on meshes (1, 2), (2, 2) and (1, 3) of four host devices
against the port's gloo worlds of 2, 4 and 3 processes
(``tests/torch_sharded_world.py``), the gathered logits and the caches held
at ``TOL[float32]`` (2e-5).  The SSM state h is held to 2e-5 of its largest
entry: under the reference's ``fan_in`` rule the reduced config's h reaches
~1e5 and cancels down to far smaller entries (tests/test_torch_prefill.py
says why).  "model" splits the 128 inner channels at tp 2 (``in_proj``'s
x and z halves lie on different ranks) and divides none of them at tp 3,
where every rank runs every channel.
"""
import numpy as np
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, reduced

NAME, OVERRIDES = "falcon-mamba-7b", {}
MESHES = ((1, 2), (2, 2), (1, 3))
TOL = dict(rtol=2e-5, atol=2e-5)  # tests/test_kernels.py TOL[float32]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{mesh tag: (the port's outputs, each rank's record)} and the
    reference's outputs."""
    return world.run_all(tmp_path_factory.mktemp("sharded_mamba"), NAME,
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
        assert sorted(want) == ["conv", "h"]
        for leaf, w in want.items():
            tol = dict(TOL)
            if leaf == "h":
                tol["atol"] *= max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(port[f"{step}/{i}/{leaf}"], w, **tol,
                                       err_msg=f"layer {i} {leaf}")


@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_each_rank_holds_only_its_shards(runs, shape):
    _, ranks = runs[0][world.tag(shape)]
    for r, rec in enumerate(ranks):
        for key in ("params_train", "cache_train", "params_decode",
                    "cache_decode"):
            got, want = rec[f"bytes/{key}"]
            assert got == want, f"rank {r} {key}"
        # at tp 2 "model" splits the inner channels and the vocabulary:
        # about half of the whole; at tp 3 it divides neither
        half = rec["bytes/params_decode"][0] / rec["bytes/params_full"]
        assert 0.5 <= half < 0.55 if shape[1] == 2 else half == 1, f"rank {r}"


@pytest.mark.parametrize("shape", MESHES, ids=world.tag)
def test_scan_ran_on_local_channels(runs, shape):
    """Prefill's ssm_scan on the rank's batch rows and inner channels, once
    a layer (S = 8 is one chunk); decode has no kernel (the recurrence
    step is plain PyTorch, as in the reference)."""
    dp, tp = shape
    cfg = reduced(get_config(NAME), **OVERRIDES)
    inner = cfg.d_inner // tp if cfg.d_inner % tp == 0 else cfg.d_inner
    want = [world.B // dp, world.S, inner, cfg.ssm_state]
    _, ranks = runs[0][world.tag(shape)]
    world.assert_kernel_calls(ranks, {
        "ssm_scan": [[want, want]] * cfg.n_layers, "flash_attention": [],
        "decode_attention": []})
