"""qwen2-moe-a2.7b [moe] — 4 shared + 60 routed top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B; hf].  24L d_model=2048 16H (kv=16) expert
d_ff=1408 vocab=151936; shared expert = 4 x 1408 = 5632.

Copy of ``repro.configs.qwen2_moe_a2_7b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-moe-a2.7b",
        family="moe",
        n_layers=24,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=0,  # all layers MoE
        vocab_size=151936,
        n_experts=60,
        top_k=4,
        d_ff_expert=1408,
        n_shared_experts=4,
        moe_period=1,
        rope_theta=1_000_000.0,
    )
)
