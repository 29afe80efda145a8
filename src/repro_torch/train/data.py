"""Deterministic synthetic data pipeline.

Copy of ``repro.train.data`` (numpy only): batch ``i`` on data shard ``k`` is
a pure function of (seed, i, k) — no state to checkpoint beyond the step
counter, which makes restart-after-failure trivial.  Produces token streams
whose unigram statistics follow a Zipf distribution so the LM loss has
realistic structure (tests assert loss decreases over steps).  Batches are
numpy arrays; the train step moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    zipf_a: float = 1.2
    mask_frac: float = 0.0  # >0: masked-prediction (encoder archs)


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-a)
    return p / p.sum()


class TokenStream:
    """Deterministic batch generator for one data shard."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 dc: DataConfig = DataConfig(), shard: int = 0,
                 n_shards: int = 1):
        self.cfg, self.batch, self.seq = cfg, batch, seq
        self.dc, self.shard, self.n_shards = dc, shard, n_shards
        self._probs = _zipf_probs(min(cfg.vocab_size, 50_000), dc.zipf_a)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng(
            (self.dc.seed * 1_000_003 + step) * 97 + self.shard
        )
        V = len(self._probs)
        toks = rng.choice(V, size=(self.batch, self.seq + 1), p=self._probs)
        # inject learnable bigram structure: every even position repeats
        # a function of the previous token
        toks[:, 1::2] = (toks[:, 0:-1:2] * 7 + 3) % V
        toks = toks.astype(np.int32)
        batch = {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "loss_mask": np.ones((self.batch, self.seq), np.float32),
        }
        if self.cfg.frontend == "audio_frames":
            emb = rng.standard_normal(
                (self.batch, self.seq, self.cfg.d_model)
            ).astype(np.float32)
            batch = {
                "frames": emb,
                "targets": (toks[:, 1:] % self.cfg.vocab_size).astype(np.int32),
                "loss_mask": batch["loss_mask"],
            }
        elif self.cfg.frontend == "vision":
            nv = self.cfg.n_vision_tokens
            batch["vision_embeds"] = rng.standard_normal(
                (self.batch, nv, self.cfg.d_model)
            ).astype(np.float32)
            pos = np.broadcast_to(
                np.arange(self.seq, dtype=np.int32)[None, :, None],
                (self.batch, self.seq, 3),
            ).copy()
            batch["positions"] = pos
        if self.dc.mask_frac > 0:
            m = rng.uniform(size=(self.batch, self.seq)) < self.dc.mask_frac
            batch["loss_mask"] = m.astype(np.float32)
        return batch
