"""The one traffic generator: reads a mix's parameters from
``bench/traffic/<name>.json`` and draws every input from the seed.

A mix file has a ``kind`` (the driver that runs it, ``bench/drivers/
<kind>.py``), its parameters, and under ``by_config`` the parameters that
differ for a configuration.

* ``prefill``: a closed loop of one client.  A cycle is a fixed multiset
  of prompt lengths (``cycle.lengths`` with ``cycle.counts``), in an order
  that the seed shuffles anew every cycle; a batch of length S holds
  ``token_budget // S`` prompts of S tokens.  Every seed gives the same
  work in another order.
* ``train``: ``batch`` rows of ``seq`` tokens a step, with their targets
  (the next token), every step's rows new.

Token ids are uniform over the vocabulary, drawn on the device by a
generator seeded from (seed, cycle or step, batch), so any batch can be
made again after the window.
"""
from __future__ import annotations

import hashlib
import json

import numpy as np
import torch

from bench.modelcfg import ROOT


def load(name: str, config: str) -> dict:
    """The parameters of mix ``name`` for configuration ``config``."""
    t = json.loads((ROOT / "traffic" / f"{name}.json").read_text())
    over = t.pop("by_config", {}).get(config, {})
    t.update(over)
    return t


def _seed(*parts) -> int:
    h = hashlib.sha256(":".join(map(str, parts)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def tokens(seed: int, shape, vocab: int, device, *tag):
    """Token ids of ``shape`` drawn from (seed, *tag)."""
    g = torch.Generator(device=device)
    g.manual_seed(_seed(seed, *tag))
    return torch.randint(0, vocab, shape, generator=g, device=device)


class PrefillMix:
    """The batches of a ``prefill`` mix."""

    def __init__(self, p: dict, seed: int, vocab: int, device):
        self.seed, self.vocab, self.device = seed, vocab, device
        self.budget = p["token_budget"]
        c = p["cycle"]
        self.lengths = [S for S, n in zip(c["lengths"], c["counts"])
                        for _ in range(n)]
        for S in self.lengths:
            if S > self.budget:
                raise ValueError(f"length {S} is over the budget "
                                 f"{self.budget}")

    def shapes(self):
        """The distinct (S, B) of the mix, longest first."""
        return [(S, self.budget // S)
                for S in sorted(set(self.lengths), reverse=True)]

    def order(self, cycle: int):
        """The lengths of ``cycle``'s batches, in order."""
        rng = np.random.default_rng([self.seed, cycle])
        return [self.lengths[i] for i in rng.permutation(len(self.lengths))]

    def batch(self, cycle: int, j: int, S: int):
        """The (B, S) prompts of batch j of ``cycle``."""
        return tokens(self.seed, (self.budget // S, S), self.vocab,
                      self.device, "prefill", cycle, j)


class TrainMix:
    """The batches of a ``train`` mix: step j's {"tokens", "targets"}."""

    def __init__(self, p: dict, seed: int, vocab: int, device):
        self.seed, self.vocab, self.device = seed, vocab, device
        self.B, self.S = p["batch"], p["seq"]

    def batch(self, j: int) -> dict:
        t = tokens(self.seed, (self.B, self.S + 1), self.vocab, self.device,
                   "train", j)
        return {"tokens": t[:, :-1].contiguous(),
                "targets": t[:, 1:].contiguous()}
