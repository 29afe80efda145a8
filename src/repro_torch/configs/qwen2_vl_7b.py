"""qwen2-vl-7b [vlm] — M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf].

Backbone only: 28L d_model=3584 28H (GQA kv=4) d_ff=18944 vocab=152064.
The vision tower is a STUB per the assignment: ``input_specs()`` provides
precomputed patch embeddings which replace the first ``n_vision_tokens``
positions; M-RoPE 3-section (temporal/height/width) rotary is implemented on
the backbone with position ids supplied as input.

Copy of ``repro.configs.qwen2_vl_7b``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        n_layers=28,
        d_model=3584,
        n_heads=28,
        n_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        rope_kind="mrope",
        mrope_sections=(16, 24, 24),
        frontend="vision",
        n_vision_tokens=1024,
        rope_theta=1_000_000.0,
    )
)
