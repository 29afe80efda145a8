"""Port parity for the MoE layers over a ("data", "model") mesh: the reduced
qwen2-moe-a2.7b (a shared expert) and qwen3-moe-235b-a22b at G = 16, f32 on
the CPU.

As tests/test_torch_sharded_qwen3.py (``tests/torch_sharded_world.py``):
the reference's ``jax.jit`` prefill (``TRAIN_RULES``) and two decode steps
(``DECODE_RULES``) on meshes (1, 2), (2, 2) and (1, 3) of four host devices
against the port's gloo worlds of 2, 4 and 3 processes.  The cases:

* qwen2-moe: 4 experts split over "model" at tp 2; under ``DECODE_RULES``
  on (2, 2) the experts' FFN width lies on "data", where the batch lies
  too, so every rank gathers the decode tokens over "data" and the width's
  partial sums are reduced over it; at tp 3 neither 4 experts nor a width
  of 32 divide, and every rank runs every expert;
* qwen3-moe with 16 query heads on one KV head (the full config's group);
* qwen2-moe with 3 experts, which "model" does not divide at tp 2: the
  rules put the FFN width on "model" instead (reference sharding.py:34-38)
  and the down-projection is a partial sum; at tp 3 each rank holds one
  expert;
* the same with a 384-token prompt: groups of 256 tokens, the middle one
  crossing the two batch rows, so that on (2, 2) it crosses the ranks'
  rows and every rank gathers the batch before grouping;
* qwen3-moe at G = 16 also on meshes (1, 1) and (2, 1), whose "model" axis
  has one rank (ROADMAP Queue C item 16).

Each output is held at ``TOL[float32]`` (2e-5), or, where the reference
itself differs from mesh to mesh by more than that, at ``TOL`` plus 4x the
reference's own move when its embeddings move by 1e-7 (relative).  Under
the reference's ``fan_in`` rule the reduced experts' activations reach
~1e2: the reference's qwen2-moe logits of the first decode step differ by
4.5e-5 between its meshes, and its cache leaves after an MoE layer by up
to 3.3e-4 (the 384-token case).  qwen3-moe at G = 16 is held at ``TOL``
throughout.  Each rank holds the bytes its shards hold by the rules.
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, reduced

MESHES = ((1, 2), (2, 2), (1, 3))
ONE_RANK_MODEL = ((1, 1), (2, 1))
# config, overrides, prompt, the outputs held to TOL plus 4x the
# reference's noise move (the others at TOL)
CASES = {"qwen2-moe": ("qwen2-moe-a2.7b", {}, world.S, ("logits", "cache")),
         "qwen3-moe-G16": ("qwen3-moe-235b-a22b",
                           {"n_heads": 16, "n_kv_heads": 1}, world.S, ()),
         "qwen2-moe-E3": ("qwen2-moe-a2.7b", {"n_experts": 3}, world.S,
                          ("logits", "cache")),
         "qwen2-moe-E3-S384": ("qwen2-moe-a2.7b", {"n_experts": 3}, 384,
                               ("cache",))}
NOISE = 3  # draws of the reference's noise, where an output is widened


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: ({mesh tag: (the port's outputs, each rank's record)}, the
    reference's outputs)}."""
    # a case's worlds beside the next case's reference; the one-KV-head
    # case also on meshes whose "model" axis has one rank
    cases = {c: (name, ov, MESHES, (S, NOISE if widen else 0))
             for c, (name, ov, S, widen) in CASES.items()}
    cases["kv1-one-rank-model"] = (*CASES["qwen3-moe-G16"][:2],
                                   ONE_RANK_MODEL, (world.S, 0))
    return world.run_cases(tmp_path_factory, cases)


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
    world.assert_rule_bytes(ranks)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_kernels_ran_on_local_shards(runs, case, shape):
    """Prefill's flash_attention on the rank's batch rows and heads
    (qwen3-moe's one KV head paired with each rank's query heads, padded
    to 6 a rank at tp 3), decode's decode_attention on every head over the
    rank's cache rows."""
    want = world.kernel_shapes(_cfg(case), shape, CASES[case][2])
    world.assert_kernel_calls(runs[case][0][world.tag(shape)][1], want)


@pytest.mark.parametrize("shape", ONE_RANK_MODEL, ids=world.tag)
def test_one_kv_head_on_a_one_rank_model_axis(runs, shape):
    """qwen3-moe's 16 query heads on one KV head where "model" has one
    rank: the rules keep wk's split of its one KV head over that axis (1
    divides 1), and no DTensor placement splits over one rank, so the
    projections' views run as the reference's do.  Logits and caches at
    TOL, the rank bytes by the rules, the kernels on the rank's rows."""
    case = "kv1-one-rank-model"
    (port, ranks), ref = runs[case][0][world.tag(shape)], runs[case][1]
    cfg = _cfg("qwen3-moe-G16")
    world.assert_outputs_match(port, ref, shape, cfg)
    world.assert_rule_bytes(ranks)
    want = world.kernel_shapes(cfg, shape, world.S)
    world.assert_kernel_calls(ranks, want)


def test_the_experts_and_their_width_split_as_the_rules_say():
    """What the cases rest on: at tp 2 the 4 experts split over "model",
    and under DECODE_RULES their FFN width over "data"; 3 experts do not
    split over "model" at tp 2, and the width takes it; at tp 3 the 3
    experts split and 4 do not."""
    from repro_torch.distributed import sharding as sh

    def spec(E, F, shape, rules):
        mesh = sh.AbstractMesh(("data", "model"), shape)
        return tuple(sh.to_pspec(("experts", "embed_p", "expert_mlp"),
                                 rules=rules, mesh=mesh, shape=(E, 64, F)))

    assert spec(4, 32, (2, 2), sh.TRAIN_RULES) == ("model", "data", None)
    assert spec(4, 32, (2, 2), sh.DECODE_RULES) == ("model", None, "data")
    assert spec(3, 32, (2, 2), sh.TRAIN_RULES) == (None, "data", "model")
    assert spec(3, 32, (1, 3), sh.TRAIN_RULES) == ("model", "data", None)
    assert spec(4, 32, (1, 3), sh.TRAIN_RULES) == (None, "data", None)
