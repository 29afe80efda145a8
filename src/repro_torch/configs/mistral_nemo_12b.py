"""mistral-nemo-12b [dense] — GQA 32/8, 128k ctx, head_dim 128.

[hf:mistralai/Mistral-Nemo-Base-2407; hf].

Copy of ``repro.configs.mistral_nemo_12b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="mistral-nemo-12b",
        family="dense",
        n_layers=40,
        d_model=5120,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=131072,
        rope_theta=1_000_000.0,
    )
)
