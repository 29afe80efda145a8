"""hubert-xlarge [audio] — encoder-only transformer.  [arXiv:2106.07447; unverified].

48L d_model=1280 16H (MHA) d_ff=5120 "vocab"=504 target units.  The conv
waveform feature extractor is a STUB per the assignment: ``input_specs()``
provides precomputed 1280-d frame embeddings.  Training step is masked
prediction over the 504-unit codebook; there is no decode step.

Copy of ``repro.configs.hubert_xlarge``: the port imports nothing of ``repro``.
"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(
    ModelConfig(
        name="hubert-xlarge",
        family="audio",
        n_layers=48,
        d_model=1280,
        n_heads=16,
        n_kv_heads=16,
        head_dim=80,
        d_ff=5120,
        vocab_size=504,
        causal=False,
        encoder_only=True,
        rope_kind="default",  # conv-pos-embedding stubbed; rotary stands in
        frontend="audio_frames",
    )
)
