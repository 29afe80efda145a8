"""No DTensor operation of a sharded step redistributes an operand on its
own: every collective of prefill, decode and the train step (forward and
backward) goes through ``distributed/sharding.py`` (``redistribute``,
``psum``, ``reduce_grad``, the ``_FromLocal`` transposes), and every
operation's operands arrive in placements its strategy takes as they are.

A redistribution that DTensor plans by itself may be a local chunk on one
torch version and a collective on another: a gradient summed from a
replicated term and a partial one, for instance, is reconciled by turning
the replicated term partial (a local step) or by all-reducing the partial
term, as the version decides.  So the test counts the plans, not the
collectives: the dry run's cells (``world.fake_cells``: two child
processes on the fake group, ``launch/dryrun.py::execute``) record each
redistribution DTensor plans (``launch/workcount.py``,
``dtensor_redistributions``), and the train, prefill and decode steps of
reduced configs must plan none.

The cells with one KV head, and with two on a "model" axis of 4, reach
the regime where "model" splits the query heads but not the KV heads
(``models/attention.py::_paired``): each rank reads its slice of the
replicated KV heads, and the gradients that reach the layer's input
through ``wq``, ``wk`` and ``wv`` must all be each rank's term of a sum
over "model".  Where k's and v's gradients were summed over "model"
first, the train step planned one redistribution a layer (the replicated
term to a partial one); where they are partial sums that come back
strided, the reshape of the projections' gradient planned one (DTensor
reduces a partial sum that it must copy).  Decode planned one a layer
too, where a rank's heads of the merged output met ``wo``'s split.

Whether a gradient comes back strided depends on the kernel's route: the
card's kernels and their meta routes return dK and dV contiguous in the
projections' layout, the plain attention that the CPU runs returns them
strided.  So the meta-route cells cannot see a plan that only the CPU's
layout makes: jamba's one-KV-head train step at tp 2, which has neither
rope nor qk-norm to copy k's gradient before the reshape, planned one at
each attention layer in the live gloo ranks and none in its meta-route
cell (ROADMAP Queue C item 22).  The train cells of that regime run
again with the kernels' plain versions on the meta tensors ("-plain",
``world.start_fake_cells``), and there that cell planned the reshape's
reduction before ``_paired`` made the gradient contiguous.
"""
import pytest

import torch_sharded_world as world
from repro_torch.configs.base import get_config, reduced

# the dense stack, the sliding-window stack, the MoE stack, the hybrid
# (attention and Mamba) stack and the encoder-only stack
CONFIGS = ("qwen3-8b", "gemma3-27b", "qwen3-moe-235b-a22b",
           "jamba-v0.1-52b", "hubert-xlarge")
MESHES = ((1, 2), (2, 2))
# KV heads: the config's own (split with the query heads over "model"),
# one, and two of eight query heads on a "model" axis of 4 (each rank's
# two query heads read one of two replicated KV heads, as the production
# meshes' 16 ranks read one of 8 or 4), with the meshes of each
KV = {"own-kv": ({}, MESHES), "one-kv": ({"n_kv_heads": 1}, MESHES),
      "two-kv": ({"n_heads": 8, "n_kv_heads": 2}, ((1, 4),))}
STEPS = ("train", "prefill", "decode")
S, B = 16, 4  # B splits over "data" of (2, 2)


def _cases() -> dict:
    """{case id: (config, overrides, step, S, B, mesh)}; the encoder-only
    stack has no decode step."""
    out = {}
    for name in CONFIGS:
        for kv, (ov, meshes) in KV.items():
            for mesh in meshes:
                for step in STEPS:
                    if step == "decode" and get_config(name).encoder_only:
                        continue
                    out[f"{name}/{kv}/{world.tag(mesh)}/{step}"] = (
                        name, ov, step, S, B, list(mesh))
                    if ov and step == "train":  # the CPU's layouts too
                        out[f"{name}/{kv}/{world.tag(mesh)}/train-plain"] = (
                            name, ov, step, S, B, list(mesh), "plain")
    return out


CASES = _cases()


@pytest.fixture(scope="module")
def cells():
    """The cases' cells, in two children side by side."""
    keys = sorted(CASES)
    procs = [world.start_fake_cells({k: CASES[k] for k in keys[i::2]})
             for i in range(2)]
    try:
        return {k: v for p in procs for k, v in world.fake_cells(p).items()}
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_redistribution_of_dtensors_own(cells, case):
    name, ov, step, _, _, mesh, *_ = CASES[case]
    cfg = reduced(get_config(name), **ov)
    if ov:  # "model" splits the query heads but not the KV heads
        assert cfg.n_heads % mesh[1] == 0 and cfg.n_kv_heads % mesh[1]
    plans = cells[case]["redistributions"]
    assert plans == {}, (
        f"{case}: DTensor planned {sum(plans.values())} redistributions of "
        f"its own in {cfg.n_layers} layers: {plans}")
