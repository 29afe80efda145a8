"""Port parity for the train step over a ("data", "model") mesh: the
windowed, encoder-only and vision families, reduced, f32 on the CPU.

As tests/test_torch_sharded_train.py (``tests/torch_sharded_world.py``'s
``REF_TRAIN_SCRIPT`` and ``_train_rank_main``): the reference's
``build_lowerable`` train cell under ``jax.jit`` on meshes (1, 2), (2, 2)
and (1, 3) of four host devices, two steps on two batches of B = 4 rows,
S = 8, against the port's same cell in gloo worlds of 2, 4 and 3
processes, its state from the reference's initial parameters placed leaf
by leaf.  The cases:

* gemma3-27b with a window of 4 and 8 layers: one period of five windowed
  layers and a global one, then two windowed layers past the last whole
  period, which the reference does not stack and so does not decay (ROADMAP
  Queue C item 8); tied embeddings, so the unembedding's gradient and the
  vocab-split lookup's meet in one leaf;
* hubert-xlarge: frames in place of tokens (the embedding table's
  gradient is zero, as the reference's), non-causal attention, the masked
  prediction loss over the units split by vocab;
* qwen2-vl-7b with 4 vision rows over the first positions (their tokens
  get no gradient) and three position streams; row 1's stream 0 is off
  the row index from position 5, so on (2, 2) one rank's rows alone take
  the position masks and every rank takes them.

Held after each step as tests/test_torch_sharded_train.py holds them:
the metrics and every leaf of params, mu and nu at ``TOL[float32]``
(2e-5), each gradient leaf within 1e-4 of its largest |g|, against the
reference's sharded step and the port's own unsharded step; each rank's
state bytes by the rules; the kernels' local shapes, forward and backward.
The reduced hubert and qwen2-vl are ill-conditioned in the reference
itself: its step 2 gradients of hubert, and its qwen2-vl gradients
(whose vision rows, drawn at scale 1 beside embeddings of 0.02, dominate
the residual), move by up to 6e-4 of a leaf's scale when the stack's
inputs move by 1e-7.  The leaves in ``WIDEN`` are held to their tolerance
plus 4x that move (``REF_TRAIN_SCRIPT``'s noise draws), against the
reference only: the port's sharded step is held to its unsharded step
without it.
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, layer_specs, reduced

MESHES = ((1, 2), (2, 2), (1, 3))
# config, overrides, meshes, microbatches, the loss's chunk of rows, S, the
# reference's noise draws
CASES = {"gemma3": ("gemma3-27b", {"sliding_window": 4, "n_layers": 8},
                    MESHES, 1, 4, world.S, 0),
         "hubert": ("hubert-xlarge", {}, MESHES, 1, 512, world.S, 3),
         "qwen2-vl": ("qwen2-vl-7b", {"n_vision_tokens": 4}, MESHES, 1, 512,
                      world.S, 3)}
# the outputs held to TOL plus 4x the reference's own move under 1e-7
# noise on the stack's inputs, by case: those where the reference's own
# step is ill-conditioned (ROADMAP Queue C items 9 and 15); the port's
# unsharded step is as far from it there as the sharded one
WIDEN = {"hubert": ("grads/layers/0/ln2", "grads/layers/1/attn/wk"),
         "qwen2-vl": ("grad_norm", "grads/embed", *(
             f"grads/layers/0/{leaf}" for leaf in (
                 "ln1", "attn/wq", "attn/wk", "attn/wv", "attn/wo",
                 "mlp/w_up", "mlp/w_down")), *(
             f"grads/layers/1/{leaf}" for leaf in (
                 "ln1", "attn/wq", "attn/wk")))}


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
    world.assert_train_matches(runs[case], _cfg(case), shape, plain=True)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_each_rank_holds_only_its_shards_of_the_state(runs, case, shape):
    world.assert_train_state_bytes(runs[case], shape)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_kernels_ran_forward_and_backward_on_local_shards(runs, case, shape):
    world.assert_train_kernel_shapes(runs[case], _cfg(case), shape)


def test_the_cases_cover_the_slice():
    """What the cases rest on: gemma3's window lies inside S and two of its
    layers lie past the last whole period (undecayed); hubert reads frames
    and attends both ways; qwen2-vl's vision rows leave token rows."""
    from repro_torch.configs.base import scan_period

    gemma = _cfg("gemma3")
    specs = layer_specs(gemma)
    assert {s.window for s in specs} == {4, None} and 4 < world.S
    assert gemma.n_layers % scan_period(gemma) == 2
    hubert = _cfg("hubert")
    assert hubert.frontend == "audio_frames" and hubert.encoder_only
    assert not hubert.causal
    vl = _cfg("qwen2-vl")
    assert vl.frontend == "vision" and 0 < vl.n_vision_tokens < world.S
    assert vl.rope_kind == "mrope"
