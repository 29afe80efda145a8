"""Port parity for the train step over a ("data", "model") mesh: the dense
attention and Mamba stacks, reduced, f32 on the CPU.

The reference (``tests/torch_sharded_world.py``'s ``REF_TRAIN_SCRIPT``)
runs ``launch/specs.py::build_lowerable``'s train cell under ``jax.jit``
with its ``in_shardings`` on meshes (1, 2), (2, 2) and (1, 3) of four host
devices: two steps on two batches of B = 4 rows (so that (2, 2) splits the
batch), S = 8, their loss masks keeping most positions of the first two
rows and few of the last two; before each step, the gradients the step
takes, under the same shardings.  The port runs the same cell's ``fn`` in
gloo worlds of 2, 4 and 3 processes, its state from the reference's
initial parameters placed as it is made (``state_from_jax(..., mesh=)``),
with DTensor's own collectives made to raise; its step hands the
gradients before clipping to ``grad_hook``.  The cases:

* stablelm-1.6b (multi-head attention, G = 1; no qk-norm; at tp 3 its 4
  heads are not split and every rank runs all of them);
* qwen3-8b at G = 2 (qk-norm): at tp 2 the KV heads split with the query
  heads, at tp 3 the reference's head padding;
* mistral-nemo-12b with one KV head (G = 4): at tp 2 each rank pairs its
  query heads with the replicated KV head, at tp 3 the padding;
* falcon-mamba-7b (tied embeddings; the inner channels split at tp 2, not
  at tp 3), and the same with two microbatches (``accum_steps=2``) on
  (1, 2) and (2, 2), whose masks count unlike, against the reference's
  accumulated step.

The stablelm and falcon-mamba cases take the loss in chunks of 4 rows,
each recomputed in the backward pass with its collectives, in the
sharded and the unsharded run; the qwen3 and mistral-nemo cases in one
chunk, as the reference at this S.

Held after each step: ``loss``, ``grad_norm`` and ``lr`` and every leaf of
``params``, ``mu`` and ``nu`` at ``TOL[float32]`` (2e-5); each gradient
leaf within 1e-4 of its largest |g| (the rule of tests/test_torch_train.py,
whose other arm, 4x the reference's own move under 1e-7 noise on the
embeddings, no leaf needs at this batch: every case passes without it, so
the reference draws no noise).  The port's sharded step is held to its
own unsharded step on the same inputs by the same rules.
Each rank holds the bytes of its shards of the state by the rules, and
the kernels' plain versions ran, forward and backward, on its shards.
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, layer_specs, reduced

MESHES = ((1, 2), (2, 2), (1, 3))
# config, overrides, meshes, microbatches, the loss's chunk of rows (4: two
# chunks of S = 8, each recomputed in the backward pass; 512: one, as the
# reference's at this S), S, the reference's noise draws (none: no leaf
# needs its noise arm)
CASES = {"stablelm": ("stablelm-1.6b", {}, MESHES, 1, 4, world.S, 0),
         "qwen3-G2": ("qwen3-8b", {"n_kv_heads": 2}, MESHES, 1, 512,
                      world.S, 0),
         "mistral-nemo-G4": ("mistral-nemo-12b", {"n_kv_heads": 1}, MESHES,
                             1, 512, world.S, 0),
         "falcon-mamba": ("falcon-mamba-7b", {}, MESHES, 1, 4, world.S, 0),
         "falcon-mamba-accum2": ("falcon-mamba-7b", {}, ((1, 2), (2, 2)), 2,
                                 4, world.S, 0)}


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
    world.assert_train_matches(runs[case], _cfg(case), shape)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_sharded_train_steps_equal_the_unsharded_step(runs, case, shape):
    world.assert_train_matches(runs[case], _cfg(case), shape, plain=True)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_each_rank_holds_only_its_shards_of_the_state(runs, case, shape):
    world.assert_train_state_bytes(runs[case], shape)


@pytest.mark.parametrize("case,shape", PARAMS, ids=IDS)
def test_kernels_ran_forward_and_backward_on_local_shards(runs, case, shape):
    world.assert_train_kernel_shapes(runs[case], _cfg(case), shape,
                                     CASES[case][3])


def test_the_cases_cover_the_slice():
    """Every registered config trains over a mesh, held by this file's
    cases or those of tests/test_torch_sharded_train_{families,moe}.py;
    and the paths this file's cases take there: heads split alike (qwen3
    at tp 2), query heads paired with a replicated KV head (mistral-nemo
    at tp 2), the reference's padding (tp 3 at G > 1), every head on every
    rank (stablelm at tp 3), the scan's channels split (tp 2) or not (tp
    3), and the loss in one chunk or in several, each recomputed in the
    backward pass."""
    import test_torch_sharded_train_families as families
    import test_torch_sharded_train_moe as moe
    from repro_torch.configs.base import list_configs

    names = {CASES[c][0] for c in CASES}
    assert names == {"stablelm-1.6b", "qwen3-8b", "mistral-nemo-12b",
                     "falcon-mamba-7b"}
    assert names | {v[0] for v in families.CASES.values()} | {
        v[0] for v in moe.CASES.values()} == set(list_configs())
    assert _cfg("mistral-nemo-G4").n_kv_heads % 2
    assert _cfg("qwen3-G2").n_heads % 3 and _cfg("qwen3-G2").q_per_kv > 1
    assert _cfg("falcon-mamba").d_inner % 2 == 0
    assert _cfg("falcon-mamba").d_inner % 3
    assert all(s.kind == "mamba" for s in layer_specs(_cfg("falcon-mamba")))
    assert {CASES[c][4] < world.S for c in CASES} == {True, False}
    assert all(world.S % CASES[c][4] == 0 for c in CASES
               if CASES[c][4] < world.S)
