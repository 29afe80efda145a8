"""stablelm-1.6b [dense] — MHA (kv=32).  [hf:stabilityai/stablelm-2-1_6b; unverified].

Copy of ``repro.configs.stablelm_1_6b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="stablelm-1.6b",
        family="dense",
        n_layers=24,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        head_dim=64,
        d_ff=5632,
        vocab_size=100352,
        rope_theta=10_000.0,
    )
)
