"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887; hf].  32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536 (spec), MoE 16 experts top-2 on every other layer; attention at
layer offset 4 of each 8-layer block (1 attention : 7 mamba).

Copy of ``repro.configs.jamba_v0_1_52b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=65536,
        attn_period=8,
        attn_offset=4,
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        moe_period=2,
        moe_offset=1,
        ssm_state=16,
        d_conv=4,
        expand=2,
        rope_kind="none",  # Jamba uses no positional encoding in attn layers
    )
)
