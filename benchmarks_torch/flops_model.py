"""Analytic FLOPs / HBM-traffic models per (arch x shape).

Two FLOPs numbers per cell:
  * ``model_flops``  — MODEL_FLOPS = 6*N*D for training (N = params, dense;
    N_active for MoE), 2*N*D for inference forward; attention not included
    (the standard accounting the roofline "useful" ratio is defined against).
  * ``cell_flops``   — HLO-equivalent executed FLOPs: adds attention
    score/value matmuls, remat recompute (train forward counted twice),
    MoE router/dispatch/combine einsums, logit head, and head-padding waste.

Port of ``benchmarks/flops_model.py`` on the port's configs and parameter
specs: every function gives the reference's number for every (arch x
shape) (``tests/test_torch_figures.py``).  ``step_model_flops`` is the
same count at any batch and sequence length, for the steps a run on the
card times.
"""
from __future__ import annotations

import math

from repro_torch.configs.base import SHAPES, get_config, layer_specs
from repro_torch.models import model as model_lib
from repro_torch.train.tree import leaves


def param_count(arch: str) -> int:
    return sum(math.prod(s.shape)
               for s in leaves(model_lib.abstract_params(get_config(arch))))


def active_param_count(arch: str) -> int:
    """Params touched per token (MoE: top_k + shared experts only)."""
    cfg = get_config(arch)
    total = param_count(arch)
    if cfg.n_experts == 0:
        return total
    # subtract inactive routed experts on MoE layers
    n_moe_layers = sum(1 for s in layer_specs(cfg) if s.mlp == "moe")
    per_expert = 3 * cfg.d_model * cfg.d_ff_expert
    inactive = n_moe_layers * (cfg.n_experts - cfg.top_k) * per_expert
    return total - inactive


def _attn_flops(cfg, S_q: int, S_kv: int, batch: int, causal=True) -> float:
    """Score + value matmuls (2*2*B*H*Sq*Skv*D), causal halving."""
    specs = layer_specs(cfg)
    total = 0.0
    for s in specs:
        if s.kind != "attn":
            continue
        kv = S_kv if s.window is None else min(S_kv, s.window)
        frac = 0.5 if (causal and S_q == S_kv and s.window is None) else 1.0
        total += 4.0 * batch * cfg.n_heads * S_q * kv * cfg.head_dim * frac
    return total


def _moe_overhead_flops(cfg, tokens: float) -> float:
    """Router + dispatch/combine one-hot einsums (GShard path)."""
    if cfg.n_experts == 0:
        return 0.0
    n_moe = sum(1 for s in layer_specs(cfg) if s.mlp == "moe")
    E, K, M = cfg.n_experts, cfg.top_k, cfg.d_model
    gs = 256
    C = max(4, -(-int(gs * K * 1.25 / E) // 4) * 4) if gs > 1 else 1
    per_tok = 2 * M * E + 2 * 2 * M * E * C  # router + dispatch + combine
    return n_moe * tokens * per_tok


def step_model_flops(arch: str, step: str, batch: int, seq_len: int) -> float:
    """MODEL_FLOPS of one ``step`` ("train", "prefill" or "decode") over
    ``batch`` sequences of ``seq_len`` (decode: one new token each)."""
    n_active = active_param_count(arch)
    if step == "train":
        return 6.0 * n_active * batch * seq_len
    if step == "prefill":
        return 2.0 * n_active * batch * seq_len
    # decode: one token per sequence
    return 2.0 * n_active * batch


def model_flops(arch: str, shape_name: str) -> float:
    sh = SHAPES[shape_name]
    return step_model_flops(arch, sh.step, sh.global_batch, sh.seq_len)


def cell_flops(arch: str, shape_name: str) -> float:
    """HLO-equivalent executed FLOPs (global, all devices)."""
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    n_active = active_param_count(arch)
    B, S = sh.global_batch, sh.seq_len
    if sh.step == "train":
        tokens = B * S
        # fwd + remat-fwd + bwd = 2 + 2+... : grads cost 2x fwd; full remat
        # recomputes fwd once -> 4x fwd matmul work REL 2*N*D
        mm = 2.0 * n_active * tokens * 4.0
        attn = _attn_flops(cfg, S, S, B) * 4.0
        moe = _moe_overhead_flops(cfg, tokens) * 4.0
        return mm + attn + moe
    if sh.step == "prefill":
        tokens = B * S
        return (
            2.0 * n_active * tokens
            + _attn_flops(cfg, S, S, B)
            + _moe_overhead_flops(cfg, tokens)
        )
    # decode
    return (
        2.0 * n_active * B
        + _attn_flops(cfg, 1, S, B, causal=False)
        + _moe_overhead_flops(cfg, B)
    )


def memory_bytes(arch: str, shape_name: str, n_dev: int = 256) -> float:
    """Per-device HBM traffic per step (bytes), analytic.

    Terms: parameter reads (weights stream from HBM once per matmul pass;
    fwd + remat-fwd + bwd for train), optimizer state read+write (train),
    KV/SSM-cache read+write (decode/prefill), activation traffic
    (approximated as 2 bytes x tokens x d_model x layers x passes —
    residual stream reads/writes; attention/MoE internals assumed
    fused/VMEM-resident between ops).
    """
    cfg = get_config(arch)
    sh = SHAPES[shape_name]
    B, S = sh.global_batch, sh.seq_len
    n_params = param_count(arch)
    p_bytes = 2.0 * n_params / n_dev  # bf16, fully sharded

    if sh.step == "train":
        passes = 3.0  # fwd + remat fwd + bwd weight reads
        opt = (4.0 + 4.0) * 2.0 * n_params / n_dev  # m,v read+write fp32
        grads = 2.0 * 2.0 * n_params / n_dev
        tokens_dev = B * S / n_dev * 16  # batch sharded over data(+pod) only
        act = 2.0 * tokens_dev * cfg.d_model * cfg.n_layers * 4.0
        return p_bytes * passes + opt + grads + act
    if sh.step == "prefill":
        tokens_dev = B * S / n_dev * 16
        act = 2.0 * tokens_dev * cfg.d_model * cfg.n_layers
        cache_w = _cache_bytes(cfg, B, S) / n_dev
        return p_bytes + act + cache_w
    # decode: read whole cache + params each step
    cache_rw = 1.0 * _cache_bytes(cfg, B, S) / n_dev
    act = 2.0 * B / n_dev * 16 * cfg.d_model * cfg.n_layers * 2
    return p_bytes + cache_rw + act


def _cache_bytes(cfg, B: int, S: int) -> float:
    total = 0.0
    for s in layer_specs(cfg):
        if s.kind == "attn":
            total += 2.0 * B * S * cfg.n_kv_heads * cfg.head_dim * 2.0
        else:
            total += 4.0 * B * cfg.d_inner * cfg.ssm_state
    return total
