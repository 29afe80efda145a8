"""Port parity for the train step over a ("data", "model") mesh: the MoE
stacks and Jamba's hybrid stack, reduced, f32 on the CPU.

As tests/test_torch_sharded_train.py (``tests/torch_sharded_world.py``'s
``REF_TRAIN_SCRIPT`` and ``_train_rank_main``): the reference's
``build_lowerable`` train cell under ``jax.jit`` on ("data", "model")
meshes of four host devices, two steps on two batches of B = 4 rows,
against the port's same cell in gloo worlds.  The cases:

* qwen2-moe-a2.7b (4 experts, a shared expert, the aux loss at 0.01):
  the experts split over "model" at tp 2, every rank runs all of them at
  tp 3;
* qwen3-moe-235b-a22b with 16 query heads on one KV head (G = 16), on the
  three meshes; and at S = 384 with two microbatches (``accum_steps=2``)
  on (1, 2) and (2, 2), whose masks count unlike: groups of 256 tokens,
  so that on (2, 2) a data rank's row of a microbatch ends inside a group
  that crosses the ranks' rows, and every rank gathers the microbatch
  before grouping;
* jamba-v0.1-52b: 14 Mamba and 2 attention layers, MoE on the odd layers,
  under remat; and with one KV head on (1, 2) alone, where "model"
  splits the query heads but not the KV head, and k reaches
  ``attention._paired`` straight from its projection (jamba has neither
  rope nor qk-norm): the ranks refuse DTensor's own plans
  (``world.gloo_rank``), and until ``_paired`` made the KV heads'
  gradient contiguous, the reshape of k's strided partial gradient
  planned a reduction of its own there (ROADMAP Queue C item 22).

Held as tests/test_torch_sharded_train.py holds its cases: after each
step the metrics and every leaf of params, mu and nu at ``TOL[float32]``
(2e-5), each gradient leaf within 1e-4 of its largest |g|, against the
reference's sharded step and the port's own unsharded step; each rank's
state bytes by the rules; the kernels' local shapes, forward and backward.
Where the reference's own step is ill-conditioned, the outputs in
``WIDEN`` are held to that plus 4x the reference's own move when the
stack's inputs move by 1e-7 (``REF_TRAIN_SCRIPT``'s noise draws, the
largest over each output): qwen2-moe's grad norm (the port and the
reference differ by 1.1e-2 in 1e2, on every mesh alike); and every
gradient leaf and the grad norm of the reduced jamba (both cases),
whose residual reaches ~1e11 under the reference's init (ROADMAP Queue C
items 9 and 15): its gradients move by up to ~2e-3 of their scale between the
reference's own meshes, and by as much between the port's sharded and
unsharded steps (ten noise draws for jamba, three elsewhere).  Its
parameters and moments are held at ``TOL``, but for one KV head the
embedding's first moment after step 2, which the reference's own noise
moves by 3.9e-4 (on a scale of 2.0e-2), where the port differs from the
reference by 3.2e-5 and from its unsharded step by 6.0e-5 (the first
run of this case, seed 0).
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, layer_specs, reduced

MESHES = ((1, 2), (2, 2), (1, 3))
G16 = {"n_heads": 16, "n_kv_heads": 1}
CROSS_S = 384  # a microbatch row of 384 tokens ends inside a group of 256
# config, overrides, meshes, microbatches, the loss's chunk of rows, S, the
# reference's noise draws
CASES = {"qwen2-moe": ("qwen2-moe-a2.7b", {}, MESHES, 1, 4, world.S, 3),
         "qwen3-moe-G16": ("qwen3-moe-235b-a22b", G16, MESHES, 1, 512,
                           world.S, 0),
         "qwen3-moe-G16-accum2": ("qwen3-moe-235b-a22b", G16,
                                  ((1, 2), (2, 2)), 2, 512, CROSS_S, 0),
         "jamba": ("jamba-v0.1-52b", {}, MESHES, 1, 4, world.S, 10),
         "jamba-kv1": ("jamba-v0.1-52b", {"n_kv_heads": 1}, ((1, 2),), 1, 4,
                       world.S, 10)}
# the outputs held to their tolerance plus 4x the reference's own move
# under 1e-7 noise on the stack's inputs, by case, against the reference
# (see the module's docstring); jamba's also against the port's unsharded
# step
WIDEN = {"qwen2-moe": ("grad_norm",),
         "jamba": ("grad_norm", "grads/"),
         "jamba-kv1": ("grad_norm", "grads/", "mu/embed")}
WIDEN_UNSHARDED = {c: WIDEN[c] for c in ("jamba", "jamba-kv1")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{case: ({mesh tag: (the port's outputs, each rank's record)}, the
    reference's outputs)}; a case's worlds beside the next case's
    reference."""
    return world.run_train_cases(tmp_path_factory, CASES)


def _cfg(case):
    name, overrides = CASES[case][:2]
    return reduced(get_config(name), **overrides)


PARAMS = [(c, m) for c, (_, _, meshes, *_) in CASES.items() for m in meshes]
IDS = [f"{c}-{world.tag(m)}" for c, m in PARAMS]


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_sharded_train_steps_equal_reference(runs, case, shape):
    world.assert_train_matches(runs[case], _cfg(case), shape,
                               WIDEN.get(case, ()))


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_sharded_train_steps_equal_the_unsharded_step(runs, case, shape):
    world.assert_train_matches(runs[case], _cfg(case), shape,
                               WIDEN_UNSHARDED.get(case, ()), plain=True)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_each_rank_holds_only_its_shards_of_the_state(runs, case, shape):
    world.assert_train_state_bytes(runs[case], shape)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_kernels_ran_forward_and_backward_on_local_shards(runs, case, shape):
    world.assert_train_kernel_shapes(runs[case], _cfg(case), shape,
                                     *CASES[case][3:6:2])


def test_the_cases_cover_the_slice():
    """What the cases rest on: qwen2-moe's 4 experts split over "model" at
    tp 2 and not at tp 3; its shared expert; qwen3-moe's 16 query heads on
    one KV head; at S = 384 a data rank's microbatch row ends inside a
    group; jamba's stack mixes Mamba and attention mixers with MoE and
    dense MLPs."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.models.moe import _group

    def expert_spec(cfg, shape):
        mesh = sh.AbstractMesh(("data", "model"), shape)
        return tuple(sh.to_pspec(
            ("experts", "embed_p", "expert_mlp"), rules=sh.TRAIN_RULES,
            mesh=mesh, shape=(cfg.n_experts, cfg.d_model, cfg.d_ff_expert)))

    moe = _cfg("qwen2-moe")
    assert expert_spec(moe, (1, 2))[0] == "model"
    assert expert_spec(moe, (1, 3)) == (None, "data", None)
    assert moe.n_shared_experts
    assert _cfg("qwen3-moe-G16").q_per_kv == 16
    # a data rank's row of a microbatch on (2, 2) ends inside a group
    accum = CASES["qwen3-moe-G16-accum2"][3]
    assert CASES["qwen3-moe-G16-accum2"][5] == CROSS_S
    micro = world.TRAIN_B // accum
    assert micro // 2 * CROSS_S % _group(micro, CROSS_S, 256)
    assert {(s.kind, s.mlp) for s in layer_specs(_cfg("jamba"))} == {
        ("mamba", "dense"), ("mamba", "moe"), ("attn", "dense")}
    # one KV head: "model" of (1, 2) splits the query heads alone, and no
    # rope or qk-norm stands between k's projection and ``_paired``
    kv1 = _cfg("jamba-kv1")
    assert kv1.n_heads % 2 == 0 and kv1.n_kv_heads == 1
    assert kv1.rope_kind == "none" and not kv1.qk_norm
