"""Model / run configuration for all assigned architectures.

Every architecture in the assigned pool is expressed as a single
``ModelConfig``.  Layer heterogeneity (hybrid attn/mamba interleaves, MoE
periods, local/global sliding-window patterns) is described declaratively and
resolved by :func:`layer_specs` into a per-layer ``LayerSpec`` list; the model
stack groups layers into identical "periods" and scans over them so compile
time is O(period) not O(depth).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Layer / model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LayerSpec:
    """Resolved structure of one decoder layer."""

    kind: str  # "attn" | "mamba"
    mlp: str  # "dense" | "moe" | "none"
    window: Optional[int]  # sliding-window size; None = global attention


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rope_kind: str = "default"  # "default" | "mrope" | "none"
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    causal: bool = True
    # sliding-window pattern: every ``global_period``-th layer is global,
    # the rest use ``sliding_window``.  0 = all layers global.
    sliding_window: int = 0
    global_period: int = 0
    # hybrid attn/mamba interleave: layer i is attention iff
    # i % attn_period == attn_offset.  attn_period == 1 -> all attention.
    attn_period: int = 1
    attn_offset: int = 0
    # MoE: layer i is MoE iff moe_period > 0 and i % moe_period == moe_offset
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    moe_period: int = 0
    moe_offset: int = 0
    # Mamba (mamba1)
    ssm_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0  # 0 -> ceil(d_model / 16)
    # structure
    encoder_only: bool = False
    tie_embeddings: bool = False
    # modality frontend stub: "none" | "vision" | "audio_frames"
    frontend: str = "none"
    n_vision_tokens: int = 1024
    norm_eps: float = 1e-6
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"

    # ---- derived -----------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def dt_rank_resolved(self) -> int:
        return self.dt_rank if self.dt_rank else -(-self.d_model // 16)

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def layer_spec(self, i: int) -> LayerSpec:
        if self.attn_period <= 0:
            kind = "mamba"
        elif self.attn_period == 1:
            kind = "attn"
        else:
            kind = "attn" if (i % self.attn_period) == self.attn_offset else "mamba"
        if self.moe_period > 0 and (i % self.moe_period) == self.moe_offset:
            mlp = "moe"
        elif self.d_ff > 0:
            mlp = "dense"
        else:
            mlp = "none"  # pure-SSM archs (falcon-mamba) have no MLP
        window: Optional[int] = None
        if kind == "attn" and self.sliding_window > 0:
            if self.global_period > 0 and (i % self.global_period) == (
                self.global_period - 1
            ):
                window = None  # global layer
            else:
                window = self.sliding_window
        return LayerSpec(kind=kind, mlp=mlp, window=window)


def layer_specs(cfg: ModelConfig):
    return [cfg.layer_spec(i) for i in range(cfg.n_layers)]


def scan_period(cfg: ModelConfig) -> int:
    """Smallest repeating period of layer structure (for scan grouping)."""
    import math

    p = 1
    if cfg.attn_period > 1:
        p = math.lcm(p, cfg.attn_period)
    if cfg.moe_period > 1:
        p = math.lcm(p, cfg.moe_period)
    if cfg.global_period > 1:
        p = math.lcm(p, cfg.global_period)
    return p


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    step: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shape_skip_reason(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a reason string if this (arch, shape) cell is skipped by rule."""
    if cfg.encoder_only and shape.step == "decode":
        return "encoder-only arch has no decode step"
    if shape.name == "long_500k":
        # needs sub-quadratic attention: run only for SSM / hybrid
        has_full_attn_everywhere = cfg.attn_period == 1 and (
            cfg.sliding_window == 0 or cfg.global_period > 0
        )
        if cfg.family in ("ssm", "hybrid"):
            return None
        if has_full_attn_everywhere or cfg.attn_period == 1:
            return "full-attention arch: long_500k skipped per spec"
    return None


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


_CONFIG_MODULES = [
    "jamba_v0_1_52b",
    "qwen3_8b",
    "stablelm_1_6b",
    "mistral_nemo_12b",
    "gemma3_27b",
    "qwen2_moe_a2_7b",
    "qwen3_moe_235b_a22b",
    "qwen2_vl_7b",
    "falcon_mamba_7b",
    "hubert_xlarge",
]


def _load_all():
    import importlib

    for m in _CONFIG_MODULES:
        importlib.import_module(f"repro_torch.configs.{m}")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    small = dict(
        n_layers=min(cfg.n_layers, 2 * max(scan_period(cfg), 1)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        d_ff_expert=32 if cfg.d_ff_expert else 0,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        n_shared_experts=min(cfg.n_shared_experts, 1),
        ssm_state=8,
        dt_rank=8,
        n_vision_tokens=8 if cfg.frontend == "vision" else cfg.n_vision_tokens,
        mrope_sections=(2, 3, 3) if cfg.rope_kind == "mrope" else cfg.mrope_sections,
        sliding_window=16 if cfg.sliding_window else 0,
        dtype="float32",
        param_dtype="float32",
        name=cfg.name + "-reduced",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
