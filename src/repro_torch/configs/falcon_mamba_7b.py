"""falcon-mamba-7b [ssm] — attention-free Mamba1.  [arXiv:2410.05355; unverified].

64L d_model=4096 d_inner=8192 ssm_state=16 vocab=65024; no MLP (the Mamba
block is the whole layer), no positional encoding.

Copy of ``repro.configs.falcon_mamba_7b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="falcon-mamba-7b",
        family="ssm",
        n_layers=64,
        d_model=4096,
        n_heads=0,
        n_kv_heads=0,
        head_dim=0,
        d_ff=0,
        vocab_size=65024,
        attn_period=0,  # attention-free
        ssm_state=16,
        d_conv=4,
        expand=2,
        rope_kind="none",
        tie_embeddings=True,
    )
)
