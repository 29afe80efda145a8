"""Port parity over a ("data", "model") mesh for the hybrid, windowed,
vision and encoder-only families, reduced, f32 on the CPU.

As tests/test_torch_sharded_qwen3.py (``tests/torch_sharded_world.py``):
the reference's ``jax.jit`` prefill (``TRAIN_RULES``, the batch placed by
``launch/specs.py::_batch_sds``) and two decode steps (``DECODE_RULES``)
on meshes (1, 2), (2, 2) and (1, 3) of four host devices against the
port's gloo worlds of 2, 4 and 3 processes.  The configs:

* jamba-v0.1-52b: 14 Mamba and 2 attention layers, MoE on the odd layers,
  no rope.  Under the reference's ``fan_in`` rule its reduced residual
  reaches ~1e11 and its own logits move by ~2e-4 when its embeddings move
  by 1e-7 (tests/test_torch_families.py holds it layer by layer);
* gemma3-27b with a window of 4 over a 14-token prompt into a cache of 30
  rows: the first decode step's window, rows 11..14, lies wholly in one
  rank's rows (rank 0 of 2, rank 1 of 3) and the other ranks hold none of
  it; the second's, rows 12..15, straddles ranks 0 and 1 of 2;
* qwen2-vl-7b with 8 vision rows and three position streams over a
  12-token prompt; row 1's stream 0 is off the row index (prefill) and
  below the cache length (decode), row 0's is not, so on (2, 2) one rank's
  rows alone take the position masks; the 28 cache rows do not split over
  3, where decode runs on heads;
* hubert-xlarge's encoder-only forward from frames (non-causal, no cache).

Logits and every cache leaf are held at ``TOL[float32]`` (2e-5), except
where the reference differs from mesh to mesh by more than that: there the
output is held to ``TOL`` plus 4x the reference's own move when its
embeddings move by 1e-7 (relative), the rule tests/test_torch_families.py
applies to jamba's logits.  That is every output of jamba, and the cache
leaves of gemma3 and qwen2-vl (the reference's own v of gemma3 differs by
up to 8.3e-5 between its meshes, its k of qwen2-vl by 2.7e-5); their
logits and all of hubert's are held at ``TOL``.  The SSM state h's atol is
scaled by its largest entry.  Each rank holds the bytes its shards hold by
the rules, and the kernels' plain versions ran on its shards.
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, layer_specs, reduced

MESHES = ((1, 2), (2, 2), (1, 3))
# config, overrides, prompt, the outputs held to TOL plus 4x the
# reference's noise move (the others at TOL)
CASES = {"jamba": ("jamba-v0.1-52b", {}, world.S, ("logits", "cache")),
         "gemma3": ("gemma3-27b", {"sliding_window": 4}, 14, ("cache",)),
         "qwen2-vl": ("qwen2-vl-7b", {}, 12, ("cache",)),
         "hubert": ("hubert-xlarge", {}, world.S, ())}
NOISE = 3  # draws of the reference's noise, where an output is widened


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: ({mesh tag: (the port's outputs, each rank's record)}, the
    reference's outputs)}."""
    # a case's worlds beside the next case's reference
    return world.run_cases(tmp_path_factory, {
        c: (name, ov, MESHES, (S, NOISE if widen else 0))
        for c, (name, ov, S, widen) in CASES.items()})


def _cfg(case):
    name, overrides, _, _ = CASES[case]
    return reduced(get_config(name), **overrides)


PARAMS = [(c, m) for c in CASES for m in MESHES]
IDS = [f"{c}-{world.tag(m)}" for c, m in PARAMS]


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_sharded_logits_and_caches_equal_reference(runs, case, shape):
    (port, _), ref = runs[case][0][world.tag(shape)], runs[case][1]
    world.assert_outputs_match(port, ref, shape, _cfg(case),
                               widen=CASES[case][3])


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_each_rank_holds_only_its_shards(runs, case, shape):
    _, ranks = runs[case][0][world.tag(shape)]
    world.assert_rule_bytes(ranks, encoder_only=_cfg(case).encoder_only)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_kernels_ran_on_local_shards(runs, case, shape):
    want = world.kernel_shapes(_cfg(case), shape, CASES[case][2])
    world.assert_kernel_calls(runs[case][0][world.tag(shape)][1], want)


@pytest.mark.parametrize("shape", [(1, 2), (1, 3)], ids=world.tag)
def test_windowed_decode_attends_each_ranks_part_of_the_window(runs, shape):
    """gemma3's decode steps at cache_len 14 and 15 (window 4): each rank's
    kv_start and kv_len are the window's rows [cache_len - 3, cache_len]
    shifted by the rank's first row and clamped to its rows; the global
    layers attend from row 0 with no kv_start."""
    cfg = _cfg("gemma3")
    n = (CASES["gemma3"][2] + 16) // shape[1]
    windowed = [s.window is not None for s in layer_specs(cfg)]
    spans = {14: [], 15: []}
    for r, rec in enumerate(runs["gemma3"][0][world.tag(shape)][1]):
        calls = rec["shapes"]["decode_rows"]
        assert len(calls) == 2 * len(windowed)
        for k, (start, end) in enumerate(calls):
            cache_len = 14 + k // len(windowed)
            clamp = lambda x: min(max(x - r * n, 0), n)  # noqa: E731
            assert end == [clamp(cache_len + 1)] * world.B
            if windowed[k % len(windowed)]:
                assert start == [clamp(cache_len - 3)] * world.B
                spans[cache_len].append(end[0] - start[0])
            else:
                assert start is None
    if shape == (1, 2):  # one rank holds the whole window, then both part
        assert sorted(set(spans[14])) == [0, 4]
        assert sorted(set(spans[15])) == [1, 3]
    else:  # rank 1 holds it all, ranks 0 and 2 none of it
        assert sorted(set(spans[14])) == sorted(set(spans[15])) == [0, 4]


def test_positions_cut_one_rows_decode_to_the_first_ranks_rows(runs):
    """qwen2-vl on (1, 2): row 1 decodes at stream-0 positions 5 and 6, so
    it attends cache rows [0, 6) and [0, 7), all on rank 0 (rows 0..13);
    rank 1 holds none of them, while row 0 attends up to cache_len."""
    for r, rec in enumerate(runs["qwen2-vl"][0]["1x2"][1]):
        for k, (start, end) in enumerate(rec["shapes"]["decode_rows"]):
            i = k // _cfg("qwen2-vl").n_layers
            want = [12 + i + 1, 6 + i]
            assert start is None
            assert end == [min(max(x - 14 * r, 0), 14) for x in want]
