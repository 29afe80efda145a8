"""``correct`` comes out false where the timed path is broken underneath
(a run driven on the CPU at a small size, the look for a card skipped),
and where the control, the reference in fp8, stands in the program's
place."""
import pytest
import torch

from bench import calibrate, compare, modelcfg
from test_bench_harness import SMALL, shrink, small_run

PREFILL = "falcon-mamba-7b.prefill_mix"
TRAIN = "falcon-mamba-7b-16L.train_2k"


def _altered(orig):
    """An answer altered where it is produced: token 0 made every row's
    greedy token."""
    def prefill(*a, **k):
        logits, cache = orig(*a, **k)
        logits = logits.clone()
        logits[:, 0] = logits.max(-1).values + 1
        return logits, cache
    return prefill


def _altered_cache(orig):
    """An answer altered where it is produced: every key and every state
    the prefill leaves in the cache doubled."""
    def prefill(*a, **k):
        logits, cache = orig(*a, **k)
        return logits, [{n: 2 * v for n, v in c.items()} for c in cache]
    return prefill


def _altered_head(orig):
    """An answer altered where it is produced, at the head alone: the first
    row's last logits reversed over the vocabulary."""
    def prefill(*a, **k):
        logits, cache = orig(*a, **k)
        logits = logits.clone()
        logits[0] = logits[0].flip(-1)
        return logits, cache
    return prefill


def _altered_last_layer(orig):
    """An answer altered where it is produced, in the last layer alone:
    its scan state and conv history doubled."""
    def prefill(*a, **k):
        logits, cache = orig(*a, **k)
        return logits, cache[:-1] + [{n: 2 * v for n, v in cache[-1].items()}]
    return prefill


def _half(orig):
    """Half of the batch left out: the first half's answers stand for the
    whole batch."""
    def prefill(params, cfg, batch, **k):
        t = batch["tokens"]
        h = max(t.shape[0] // 2, 1)
        logits, cache = orig(params, cfg, {"tokens": t[:h]}, **k)
        rep = -(-t.shape[0] // h)

        def whole(x):
            return x.repeat(rep, *[1] * (x.dim() - 1))[:t.shape[0]]
        return whole(logits), [{n: whole(v) for n, v in c.items()}
                               for c in cache]
    return prefill


@pytest.mark.parametrize("fault", [
    _altered, _altered_cache, _altered_head, _altered_last_layer, _half])
def test_a_broken_prefill_is_not_correct(fault, monkeypatch):
    from repro_torch.models import model

    monkeypatch.setattr(model, "prefill", fault(model.prefill))
    assert small_run(PREFILL)["correct"] is False


def _unchanged(orig):
    """A step that returns its state unchanged."""
    def make(cfg, tc):
        from repro_torch.models import model

        def step(state, batch):
            with torch.no_grad():
                loss, _ = model.train_loss(state.params, cfg, batch,
                                           device="cpu")
            return state, {"loss": loss}
        return step
    return make


def _half_batch(orig):
    """Half of the batch left out, the mean taken over the rest."""
    def make(cfg, tc):
        real = orig(cfg, tc)

        def step(state, batch):
            h = batch["tokens"].shape[0] // 2
            return real(state, {k: v[:h] for k, v in batch.items()})
        return step
    return make


def _unchanged_in_window(orig):
    """The warm steps sound, and from the window's first step on a step
    that returns its state unchanged."""
    def make(cfg, tc):
        real, fake = orig(cfg, tc), _unchanged(orig)(cfg, tc)
        calls = []

        def step(state, batch):
            calls.append(1)
            return (real if len(calls) <= 3 else fake)(state, batch)
        return step
    return make


def _half_batch_in_window(orig):
    """The warm steps sound, and in the window half of the batch left out,
    the mean taken over the rest."""
    def make(cfg, tc):
        real, half = orig(cfg, tc), _half_batch(orig)(cfg, tc)
        calls = []

        def step(state, batch):
            calls.append(1)
            return (real if len(calls) <= 3 else half)(state, batch)
        return step
    return make


@pytest.mark.parametrize("fault", [_unchanged, _half_batch,
                                   _unchanged_in_window,
                                   _half_batch_in_window])
def test_a_broken_train_step_is_not_correct(fault, monkeypatch):
    from repro_torch.train import train_loop

    monkeypatch.setattr(train_loop, "make_train_step",
                        fault(train_loop.make_train_step))
    assert small_run(TRAIN)["correct"] is False


#: the control's test size: wider, longer and (prefill) deeper than the
#: other tests', so that the fp8 rounding accumulates as it does at the
#: cells' sizes
CONTROL = {
    "prefill": {"token_budget": 512,
                "cycle": {"lengths": [128, 256, 512], "counts": [2, 1, 1]},
                "check": {"batches": 3, "rows": 2, "block": 4}},
    "train": {"batch": 2, "seq": 128},
}


CONTROL_LAYERS = {"prefill": 12, "train": 4}


def control_shrink(a, n_layers):
    return modelcfg.small(a, d_model=256, d_inner=512, ssm_state=16,
                          dt_rank=16, vocab=1024, dtype="float32",
                          n_layers=n_layers)


@pytest.mark.parametrize("cell", [PREFILL, TRAIN])
def test_the_control_is_not_correct(cell):
    """The reference in fp8 in the program's place fails the cell's limits
    (the program, here in f32 on the CPU, passes them)."""
    kind = "train" if cell == TRAIN else "prefill"
    lim = compare.limits(cell)
    got = {}
    for control in (False, True):
        r = calibrate.readings(cell, 5, 0.1, control, device="cpu",
                               shrink=lambda a: control_shrink(
                                   a, CONTROL_LAYERS[kind]),
                               traffic_update=CONTROL[kind])
        got[control] = compare.judge(r["numbers"], lim)[0]
    assert got == {False: True, True: False}
