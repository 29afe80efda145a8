"""Port parity for prefill and decode over a ("data", "model") mesh: the
other configs built only of attention layers without a window and dense
MLPs, reduced, f32 on the CPU.

As tests/test_torch_sharded_qwen3.py (``tests/torch_sharded_world.py``), on
meshes (1, 2) and (1, 3): stablelm-1.6b (multi-head attention, G = 1: at
tp 3 its 4 heads are not split and every rank runs all of them, as the
reference's grouped form does without padding) and mistral-nemo-12b with
two KV heads (G = 2, no qk-norm); and mistral-nemo-12b on (1, 2) with a
9-token prompt, whose cache of 25 rows does not split over "model": the
rules split it by KV heads instead, and decode runs on each rank's heads.
Logits and caches are held at tests/test_torch_prefill.py's 1e-4, the
tolerance of these configs' unsharded parity (a few cache entries of the
reduced stablelm sit 2.4e-5 from the reference's); each rank holds the
bytes its shards hold by the rules.
"""
import numpy as np
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, reduced

CASES = {"stablelm": ("stablelm-1.6b", {}, ((1, 2), (1, 3)), world.S),
         "mistral-nemo": ("mistral-nemo-12b", {"n_kv_heads": 2},
                          ((1, 2), (1, 3)), world.S),
         "mistral-nemo-rows25": ("mistral-nemo-12b", {"n_kv_heads": 2},
                                 ((1, 2),), 9)}
TOL = dict(rtol=1e-4, atol=1e-4)  # tests/test_torch_prefill.py TOL


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # a case's worlds beside the next case's reference
    return world.run_cases(tmp_path_factory, {
        case: (name, overrides, meshes, (S,))
        for case, (name, overrides, meshes, S) in CASES.items()})


@pytest.mark.parametrize("case,shape", [
    (case, shape) for case, (_, _, meshes, _) in CASES.items()
    for shape in meshes], ids=lambda x: x if isinstance(x, str) else
    world.tag(x))
def test_sharded_logits_and_caches_equal_reference(runs, case, shape):
    name, overrides, _, _ = CASES[case]
    cfg = reduced(get_config(name), **overrides)
    (port, ranks), ref = runs[case][0][world.tag(shape)], runs[case][1]
    for i in range(1 + world.N_DECODE):
        np.testing.assert_allclose(port[f"logits{i}"],
                                   ref[f"{world.tag(shape)}/logits{i}"],
                                   **TOL, err_msg=f"logits {i}")
    for step in ("prefill", "decode"):
        for i in range(cfg.n_layers):
            want = world.ref_layer(ref, f"{world.tag(shape)}/{step}/", cfg, i)
            assert sorted(want) == ["k", "v"]
            for leaf, w in want.items():
                np.testing.assert_allclose(port[f"{step}/{i}/{leaf}"], w,
                                           **TOL,
                                           err_msg=f"{step} {i} {leaf}")
    for r, rec in enumerate(ranks):
        for key in ("params_train", "cache_train", "params_decode",
                    "cache_decode"):
            got, want = rec[f"bytes/{key}"]
            assert got == want, f"rank {r} {key}"
    if case == "mistral-nemo-rows25":  # decode on heads: one KV head a rank
        for rec in ranks:
            assert {tuple(map(tuple, x)) for x in rec["shapes"][
                "decode_attention"]} == {((world.B, cfg.n_heads // 2,
                                           cfg.head_dim),
                                          (world.B, 1, 25, cfg.head_dim))}
