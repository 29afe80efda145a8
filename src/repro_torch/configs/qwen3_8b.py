"""qwen3-8b [dense] — qk_norm, GQA 32/8.  [hf:Qwen/Qwen3-8B; hf].

Copy of ``repro.configs.qwen3_8b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        qk_norm=True,
        rope_theta=1_000_000.0,
    )
)
