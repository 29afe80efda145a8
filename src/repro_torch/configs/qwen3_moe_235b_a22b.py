"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA 64/4.

[hf:Qwen/Qwen3-*; hf].  94L d_model=4096 64H (kv=4) expert d_ff=1536
vocab=151936, qk-norm.

Copy of ``repro.configs.qwen3_moe_235b_a22b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,  # all layers MoE
        vocab_size=151936,
        qk_norm=True,
        n_experts=128,
        top_k=8,
        d_ff_expert=1536,
        moe_period=1,
        rope_theta=1_000_000.0,
    )
)
