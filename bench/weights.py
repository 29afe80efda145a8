"""The weights of a configuration, made on the device from the seed.

Every random leaf is a slice of one normal draw in the served dtype (one
more in float32 for the MoE routers and dt's bias), so set-up makes them
in a few large calls; each slice is then scaled to its leaf's std.  The
rules are the published ones of Mamba's own code (mamba_ssm, Gu and Dao,
arXiv:2312.00752) and of GPT-2's scaled residual init:

* a product's weight: std 1/sqrt(the width it contracts);
* a projection that writes into the residual stream (``out_proj``,
  attention's ``wo``, an MLP's or expert's ``w_down``): that std over
  sqrt(residual branches a layer x layers), so that the stack's output
  does not grow with depth;
* ``dt_proj``: std 1/sqrt(3 R) (mamba_ssm's uniform of +-R^-1/2);
  ``dt_bias``: softplus^-1 of a dt drawn log-uniform in [1e-3, 1e-1];
* the embedding: std 0.02; A_log = log(1..N) on every channel (S4D-real);
  norms and D one, the conv's bias zero.

A random stack at the unscaled rule amplifies the rounding of bf16 by
tens of percent over 16 layers, which would hide any lower precision
from the check; at these rules it does not.  The same seed on the same
device gives the same weights, so the reference gets the same inputs by
making them again.

The tree is the one ``bench/reference/model.py`` describes, which is also
the layout the program's entry points take.
"""
from __future__ import annotations

import math

import torch

from bench.modelcfg import Arch


def leaf_specs(a: Arch):
    """[(path, shape, init, dtype name, std)] in a fixed order; init is
    "normal", "ones", "zeros", "a_log" or "dt_bias"."""
    M, I, N, R, W = a.d_model, a.d_inner, a.ssm_state, a.dt_rank, a.d_conv
    pd, f32 = a.dtype, "float32"
    # residual branches: the mixer's, and the MLP's where there is one
    depth = math.sqrt((2 if a.d_ff else 1) * a.n_layers)

    def std(width, out=False):
        return 1.0 / math.sqrt(width) / (depth if out else 1.0)
    out = [(("embed",), (a.vocab, M), "normal", pd, 0.02)]
    for i, (kind, mlp) in enumerate(a.layers):
        L = ("layers", i)
        out.append((L + ("ln1",), (M,), "ones", f32, 0))
        if kind == "mamba":
            m = L + ("mamba",)
            out += [(m + ("in_proj",), (M, 2 * I), "normal", pd, std(M)),
                    (m + ("conv_w",), (W, I), "normal", pd, std(W)),
                    (m + ("conv_b",), (I,), "zeros", pd, 0),
                    (m + ("x_proj",), (I, R + 2 * N), "normal", pd, std(I)),
                    (m + ("dt_proj",), (R, I), "normal", pd, std(3 * R)),
                    (m + ("dt_bias",), (I,), "dt_bias", f32, 0),
                    (m + ("A_log",), (I, N), "a_log", f32, 0),
                    (m + ("D",), (I,), "ones", f32, 0),
                    (m + ("out_proj",), (I, M), "normal", pd,
                     std(I, out=True))]
        else:
            H, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
            t = L + ("attn",)
            out += [(t + ("wq",), (M, H, D), "normal", pd, std(M)),
                    (t + ("wk",), (M, Hkv, D), "normal", pd, std(M)),
                    (t + ("wv",), (M, Hkv, D), "normal", pd, std(M)),
                    (t + ("wo",), (H, D, M), "normal", pd,
                     std(H * D, out=True))]
        if mlp == "dense":
            F_ = a.d_ff
            t = L + ("mlp",)
            out += [(L + ("ln2",), (M,), "ones", f32, 0),
                    (t + ("w_gate",), (M, F_), "normal", pd, std(M)),
                    (t + ("w_up",), (M, F_), "normal", pd, std(M)),
                    (t + ("w_down",), (F_, M), "normal", pd,
                     std(F_, out=True))]
        elif mlp == "moe":
            E, F_ = a.n_experts, a.d_ff_expert
            t = L + ("moe",)
            out += [(L + ("ln2",), (M,), "ones", f32, 0),
                    (t + ("w_router",), (M, E), "normal", f32, std(M)),
                    (t + ("w_gate",), (E, M, F_), "normal", pd, std(M)),
                    (t + ("w_up",), (E, M, F_), "normal", pd, std(M)),
                    (t + ("w_down",), (E, F_, M), "normal", pd,
                     std(F_, out=True))]
    out.append((("final_norm",), (M,), "ones", f32, 0))
    if not a.tie_embeddings:
        out.append((("unembed",), (M, a.vocab), "normal", pd, std(M)))
    return out


def _set(tree, path, value):
    node = tree
    for k, nxt in zip(path[:-1], path[1:]):
        if isinstance(k, int):
            while len(node) <= k:
                node.append({})
            node = node[k]
        else:
            node = node.setdefault(k, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def make(a: Arch, seed: int, device) -> dict:
    """The weight tree of ``a`` drawn from ``seed`` on ``device``."""
    specs = leaf_specs(a)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    sizes: dict = {}
    for _, shape, init, dt, _ in specs:
        if init in ("normal", "dt_bias"):
            sizes[dt] = sizes.get(dt, 0) + math.prod(shape)
    flat = {dt: torch.randn(n, generator=gen, device=device,
                            dtype=getattr(torch, dt))
            for dt, n in sorted(sizes.items())}
    used = dict.fromkeys(flat, 0)
    tree: dict = {}
    for path, shape, init, dt, sd in specs:
        dtype = getattr(torch, dt)
        if init in ("normal", "dt_bias"):
            n = math.prod(shape)
            t = flat[dt][used[dt]:used[dt] + n].view(shape)
            used[dt] += n
            if init == "normal":
                t.mul_(sd)
            else:  # log-uniform dt in [1e-3, 1e-1], through softplus^-1
                u = torch.special.ndtr(t)
                d = torch.exp(math.log(1e-3) + u * math.log(100.0))
                t.copy_(d + torch.log(-torch.expm1(-d)))
        elif init == "ones":
            t = torch.ones(shape, dtype=dtype, device=device)
        elif init == "zeros":
            t = torch.zeros(shape, dtype=dtype, device=device)
        else:
            t = torch.log(torch.arange(1, shape[-1] + 1, dtype=dtype,
                                       device=device)).expand(shape)
            t = t.contiguous()
        _set(tree, path, t)
    return tree


def named_leaves(tree, prefix=()):
    """[(path, tensor)] in a fixed order (dict keys sorted)."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    items = (sorted(tree.items()) if isinstance(tree, dict)
             else enumerate(tree))
    out = []
    for k, v in items:
        out += named_leaves(v, prefix + (k,))
    return out
