"""gemma3-27b [dense] — 5:1 local:global sliding-window pattern, 128k ctx.

[hf:google/gemma-3-*; unverified].  62L d_model=5376 32H (GQA kv=16)
d_ff=21504 vocab=262144; every 6th layer global, others sliding window 1024;
qk-norm.

Copy of ``repro.configs.gemma3_27b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="gemma3-27b",
        family="dense",
        n_layers=62,
        d_model=5376,
        n_heads=32,
        n_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        qk_norm=True,
        sliding_window=1024,
        global_period=6,
        rope_theta=1_000_000.0,
        tie_embeddings=True,
    )
)
