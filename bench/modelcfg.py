"""A configuration file's sizes, read into one flat description.

``bench/configs/<name>.json`` holds the published ``config.json`` keys of
the model as it is run (``model_type`` says which family's keys), beside
the benchmark's own keys (``name``, ``source``, ``reduced``, ``assumed``,
``deployment``, ``dtype``).  ``arch`` turns it into an :class:`Arch`: the
sizes and the layer pattern that the harness, the weights and the plain
reference all read.  Pure Python: the reference imports it too.
"""
from __future__ import annotations

import json
import math
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent


@dataclass(frozen=True)
class Arch:
    name: str
    model_type: str
    n_layers: int
    d_model: int
    d_inner: int
    ssm_state: int
    d_conv: int
    dt_rank: int
    vocab: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    n_experts: int
    top_k: int
    d_ff_expert: int
    attn_period: int
    attn_offset: int
    moe_period: int
    moe_offset: int
    tie_embeddings: bool
    norm_eps: float
    dtype: str
    #: the MoE layers' capacity rule: tokens a routing group, and the factor
    moe_group: int = 256
    capacity_factor: float = 1.25

    def kind(self, i: int) -> str:
        """"attn" or "mamba" for layer i."""
        if self.attn_period and i % self.attn_period == self.attn_offset:
            return "attn"
        return "mamba"

    def mlp(self, i: int) -> str:
        """"moe", "dense" or "none" for the MLP after layer i's mixer."""
        if self.moe_period and i % self.moe_period == self.moe_offset:
            return "moe"
        return "dense" if self.d_ff else "none"

    @property
    def layers(self):
        return [(self.kind(i), self.mlp(i)) for i in range(self.n_layers)]


def load(name: str) -> dict:
    """The configuration file of ``name``."""
    return json.loads((ROOT / "configs" / f"{name}.json").read_text())


def arch(c: dict) -> Arch:
    """The :class:`Arch` of a configuration file's contents."""
    t = c["model_type"]
    common = dict(name=c["name"], model_type=t,
                  n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                  vocab=c["vocab_size"],
                  tie_embeddings=bool(c.get("tie_word_embeddings", False)),
                  dtype=c.get("dtype", "bfloat16"))
    if t == "falcon_mamba":
        M = c["hidden_size"]
        return Arch(**common, d_inner=c["intermediate_size"],
                    ssm_state=c["state_size"], d_conv=c["conv_kernel"],
                    dt_rank=c.get("time_step_rank") or math.ceil(M / 16),
                    n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0,
                    n_experts=0, top_k=0, d_ff_expert=0, attn_period=0,
                    attn_offset=0, moe_period=0, moe_offset=0,
                    norm_eps=c["layer_norm_epsilon"])
    if t == "jamba":
        M, H = c["hidden_size"], c["num_attention_heads"]
        return Arch(**common, d_inner=c["mamba_expand"] * M,
                    ssm_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"],
                    dt_rank=c["mamba_dt_rank"], n_heads=H,
                    n_kv_heads=c["num_key_value_heads"], head_dim=M // H,
                    d_ff=c["intermediate_size"], n_experts=c["num_experts"],
                    top_k=c["num_experts_per_tok"],
                    d_ff_expert=c["intermediate_size"],
                    attn_period=c["attn_layer_period"],
                    attn_offset=c["attn_layer_offset"],
                    moe_period=c["expert_layer_period"],
                    moe_offset=c["expert_layer_offset"],
                    norm_eps=c["rms_norm_eps"])
    raise ValueError(f"no reader for model_type {t!r}")


def small(a: Arch, **kw) -> Arch:
    """A tiny Arch of the same family, for tests on the CPU."""
    from dataclasses import replace
    d = dict(d_model=64, d_inner=128, ssm_state=8, dt_rank=8, vocab=256,
             dtype="float32")
    if a.n_heads:
        d.update(n_heads=4, n_kv_heads=2, head_dim=16, d_ff=96,
                 d_ff_expert=96, n_experts=4)
    d.update(kw)
    return replace(a, **d)
