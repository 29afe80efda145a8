"""The plain reference: the benchmark's configurations written out in plain
PyTorch, in float32, with no kernel, no cache manager and no batching.

It imports nothing of the program.  Its parameters are a tree of the
weights the harness made (``bench/weights.py``), each cast to float32:

  {"embed": (V, M), "layers": [layer, ...], "final_norm": (M,),
   "unembed": (M, V)}                    # no "unembed" when embeddings tie
  Mamba layer: {"ln1", "mamba": {"in_proj" (M, 2I), "conv_w" (W, I),
     "conv_b" (I,), "x_proj" (I, R + 2N), "dt_proj" (R, I), "dt_bias" (I,),
     "A_log" (I, N), "D" (I,), "out_proj" (I, M)}}
  attention layer: {"ln1", "attn": {"wq" (M, H, D), "wk", "wv" (M, Hkv, D),
     "wo" (H, D, M)}}
  then "ln2" and "mlp" {"w_gate", "w_up" (M, F), "w_down" (F, M)} or
     "moe" {"w_router" (M, E), "w_gate", "w_up" (E, M, F), "w_down"
     (E, F, M)}, where the layer has an MLP.

What it computes, layer by layer (pre-norm residual blocks):

* RMSNorm with a weight, eps from the configuration.
* The Mamba-1 mixer (Gu and Dao, arXiv:2312.00752, Algorithm 2): in_proj
  to x and the gate z; a causal depthwise conv of width W with bias,
  zero history; SiLU; x_proj to (dt, B, C); dt = softplus(dt dt_proj +
  dt_bias); A = -exp(A_log); the selective scan step by step,
  h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t, y_t = h_t C_t + D x_t; y times
  SiLU(z); out_proj.  Departure from falcon-mamba (arXiv:2410.05355) and
  Jamba (arXiv:2403.19887): neither the RMS norms those papers put on dt,
  B and C, nor a bias on the projections; the program has neither.
* Attention (Jamba's one layer a period): grouped-query, causal, softmax of
  q k / sqrt(D), no positional encoding (Jamba uses none).
* The dense MLP and each expert: SwiGLU, silu(x W_gate) * (x W_up) W_down.
* The MoE layer with the program's capacity rule (GShard, arXiv:2006.16668):
  the tokens in flattened order cut into groups of min(256, S); router
  softmax in float32; the top-k experts, ties to the lower index; gate
  weights renormalised over the k; a (token, k) pair's slot is the number
  of earlier pairs of its group that chose the same expert, token-major
  then k-minor; it is kept iff its slot is under the capacity C =
  ceil(gs k 1.25 / E), rounded up to a multiple of 4 and at least 4, and its
  weight is positive.  Each token's output is the gate-weighted sum of its
  kept experts.  Departure from Jamba: Jamba drops no token; the program's
  layer does, and the reference follows the program.  The aux loss is
  E * sum_e(mean probability_e * top-1 share_e).
* The head: the final RMSNorm, then the unembedding (the embedding's
  transpose where they tie).  The training loss is the mean token NLL plus
  0.01 times the MoE layers' summed aux loss.

``prec="fp8"`` is the control: every matrix product's two operands
rounded to float8 e4m3 with one scale a tensor (its largest magnitude to
448), the rest as above.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

#: the selective scan walks the sequence in blocks of this many steps, so
#: that its (rows, steps, I, N) temporaries stay bounded; the recurrence
#: inside each block is taken one step at a time
SCAN_BLOCK = 256
#: query rows of attention scored at a time
ATTN_BLOCK = 1024


def _fp8(t):
    """t rounded to float8 e4m3 under one scale, back in float32."""
    amax = t.detach().abs().amax().clamp_min(1e-12)
    s = 448.0 / amax
    q = (t.detach() * s).to(torch.float8_e4m3fn).float() / s
    return t + (q - t.detach())  # the rounding passes no gradient


def no_tf32():
    """Full float32 products: TF32 keeps about three decimal digits."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm(a, b, prec="f32"):
    """a @ b in float32; under the control, of fp8-rounded operands."""
    if prec == "fp8":
        a, b = _fp8(a), _fp8(b)
    return a @ b


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _blocks(S):
    return [slice(s0, min(s0 + SCAN_BLOCK, S)) for s0 in range(0, S, SCAN_BLOCK)]


def _states(dt, A, Bm, xc, h, sl):
    """(dA, the states after each step) of one block from its first state
    h, one step at a time: h_t = dA_t h_{t-1} + dBx_t."""
    dA = torch.exp(dt[:, sl, :, None] * A)
    dBx = (dt[:, sl] * xc[:, sl])[..., None] * Bm[:, sl, None, :]
    H = torch.empty_like(dA)
    for t in range(dA.shape[1]):
        h = torch.addcmul(dBx[:, t], dA[:, t], h, out=H[:, t])
    return dA, H


class _Scan(torch.autograd.Function):
    """The scan with its gradient written out, also step by step: the
    states of each block are made again from the block's first state, and
    the recurrence of dh is run backward, dh_t = dA_{t+1} dh_{t+1} + dy_t
    C_t.  (Autograd through the loop gives the same numbers with one node
    a step, which the training reference cannot afford at 2048 steps.)"""

    @staticmethod
    def forward(ctx, dt, A, Bm, xc, C, h0):
        h, starts, ys = h0, [], []
        for sl in _blocks(dt.shape[1]):
            starts.append(h)
            _, H = _states(dt, A, Bm, xc, h, sl)
            ys.append(torch.einsum("rsin,rsn->rsi", H, C[:, sl]))
            h = H[:, -1].clone()
            del H
        ctx.save_for_backward(dt, A, Bm, xc, C, torch.stack(starts))
        return torch.cat(ys, 1), h

    @staticmethod
    def backward(ctx, gy, gh):
        dt, A, Bm, xc, C, starts = ctx.saved_tensors
        g = torch.zeros_like(starts[0]) if gh is None else gh
        gy = torch.zeros_like(dt) if gy is None else gy
        d_dt, dBm, dxc, dC = (torch.empty_like(t) for t in (dt, Bm, xc, C))
        dAp = torch.zeros_like(A)
        for k, sl in reversed(list(enumerate(_blocks(dt.shape[1])))):
            dA, H = _states(dt, A, Bm, xc, starts[k], sl)
            dH = torch.empty_like(H)
            for t in reversed(range(H.shape[1])):
                dh = torch.addcmul(g, gy[:, sl][:, t, :, None],
                                   C[:, sl][:, t, None, :], out=dH[:, t])
                g = dA[:, t] * dh
            prev = torch.cat([starts[k][:, None], H[:, :-1]], 1)
            dC[:, sl] = torch.einsum("rsin,rsi->rsn", H, gy[:, sl])
            q = dH * prev * dA  # d(dA) dA: through dA = exp(dt A)
            u = dt[:, sl] * xc[:, sl]
            du = torch.einsum("rsin,rsn->rsi", dH, Bm[:, sl])
            dBm[:, sl] = torch.einsum("rsin,rsi->rsn", dH, u)
            d_dt[:, sl] = (q * A).sum(-1) + du * xc[:, sl]
            dxc[:, sl] = du * dt[:, sl]
            dAp += torch.einsum("rsin,rsi->in", q, dt[:, sl])
        return d_dt, dAp, dBm, dxc, dC, g


def selective_scan(dt, A, Bm, xc, C, h0):
    """dt, xc (R, S, I); A (I, N); Bm, C (R, S, N); h0 (R, I, N) ->
    (y (R, S, I) without the D term, h_S (R, I, N)), step by step."""
    return _Scan.apply(dt, A, Bm, xc, C, h0)


def mamba(p, x, a, prec="f32"):
    """x (R, S, M) -> (y (R, S, M), {"h": (R, I, N), "conv": (R, W-1, I)})."""
    R, S, _ = x.shape
    I, N, Rk, W = a.d_inner, a.ssm_state, a.dt_rank, a.d_conv
    xz = mm(x, p["in_proj"], prec)
    xin, z = xz[..., :I], xz[..., I:]
    pad = torch.cat([xin.new_zeros(R, W - 1, I), xin], 1)
    conv = sum(pad[:, j:j + S] * p["conv_w"][j] for j in range(W))
    xc = F.silu(conv + p["conv_b"])
    xdb = mm(xc, p["x_proj"], prec)
    dt = F.softplus(mm(xdb[..., :Rk], p["dt_proj"], prec) + p["dt_bias"])
    Bm, Cm = xdb[..., Rk:Rk + N], xdb[..., Rk + N:]
    A = -torch.exp(p["A_log"])
    y, h = selective_scan(dt, A, Bm, xc, Cm, xin.new_zeros(R, I, N))
    y = (y + xc * p["D"]) * F.silu(z)
    return mm(y, p["out_proj"], prec), {"h": h, "conv": pad[:, -(W - 1):]}


def attention(p, x, a, prec="f32"):
    """x (R, S, M) -> (y (R, S, M), {"k", "v": (R, S, Hkv, D)}); causal."""
    R, S, M = x.shape
    H, Hkv, D = a.n_heads, a.n_kv_heads, a.head_dim
    q = mm(x, p["wq"].reshape(M, H * D), prec).view(R, S, H, D)
    k = mm(x, p["wk"].reshape(M, Hkv * D), prec).view(R, S, Hkv, D)
    v = mm(x, p["wv"].reshape(M, Hkv * D), prec).view(R, S, Hkv, D)
    G = H // Hkv
    qh = q.permute(0, 2, 1, 3).reshape(R, Hkv, G, S, D)
    kh, vh = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    out = []
    for q0 in range(0, S, ATTN_BLOCK):
        qb = qh[:, :, :, q0:q0 + ATTN_BLOCK]
        s = torch.einsum("rhgqd,rhkd->rhgqk", qb, kh) / math.sqrt(D)
        qi = torch.arange(q0, q0 + qb.shape[3], device=x.device)[:, None]
        s = s.masked_fill(torch.arange(S, device=x.device)[None] > qi,
                          float("-inf"))
        out.append(torch.einsum("rhgqk,rhkd->rhgqd", torch.softmax(s, -1),
                                vh))
    o = torch.cat(out, 3).reshape(R, H, S, D).permute(0, 2, 1, 3)
    y = mm(o.reshape(R, S, H * D), p["wo"].reshape(H * D, M), prec)
    return y, {"k": k, "v": v}


def swiglu(x, w_gate, w_up, w_down, prec="f32"):
    return mm(F.silu(mm(x, w_gate, prec)) * mm(x, w_up, prec), w_down, prec)


def capacity(gs: int, k: int, e: int, factor: float) -> int:
    c = math.ceil(gs * k * factor / e)
    return max(4, -(-c // 4) * 4) if gs > 1 else max(1, c)


def moe(p, x, a, prec="f32"):
    """x (R, S, M) -> (y (R, S, M), aux)."""
    R, S, M = x.shape
    E, K = a.n_experts, a.top_k
    gs = min(a.moe_group, S)
    if (R * S) % gs:
        raise ValueError(f"{R * S} tokens do not fill groups of {gs}")
    C = capacity(gs, K, E, a.capacity_factor)
    xt = x.reshape(R * S, M)
    probs = torch.softmax(mm(xt, p["w_router"].float(), prec), -1)  # (T, E)
    srt, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = srt[:, :K], order[:, :K]
    w = w / w.sum(-1, keepdim=True).clamp_min(1e-9)
    # slots: within each group, pairs in token-major, k-minor order
    oh = F.one_hot(ids.reshape(-1, gs * K), E)  # (groups, gs K, E)
    slot = (torch.cumsum(oh, 1) - 1).gather(2, ids.reshape(-1, gs * K, 1))
    keep = (slot.reshape(-1, K) < C) & (w > 0)
    y = torch.zeros_like(xt)
    for e in range(E):
        tok, kk = torch.nonzero((ids == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        out = swiglu(xt[tok], p["w_gate"][e].float(), p["w_up"][e].float(),
                     p["w_down"][e].float(), prec)
        y = y.index_add(0, tok, out * w[tok, kk, None])
    top1 = F.one_hot(ids[:, 0], E).float().mean(0)
    aux = E * torch.sum(probs.mean(0) * top1)
    return y.reshape(R, S, M), aux


def f32(tree):
    """The leaves of a (part of a) weight tree in float32: a float32 leaf
    itself (so gradients reach it), any other a float32 copy."""
    if isinstance(tree, dict):
        return {k: f32(v) for k, v in tree.items()}
    return tree.float()


def layer(p, x, a, i: int, prec="f32"):
    """Layer i: (x, its cache entry, aux).  The layer's weights are read
    in float32, the experts' one expert at a time."""
    p = {k: v if k == "moe" else f32(v) for k, v in p.items()}
    h = rms_norm(x, p["ln1"], a.norm_eps)
    if a.kind(i) == "mamba":
        y, cache = mamba(p["mamba"], h, a, prec)
    else:
        y, cache = attention(p["attn"], h, a, prec)
    x = x + y
    aux = x.new_zeros(())
    if a.mlp(i) == "dense":
        m = p["mlp"]
        x = x + swiglu(rms_norm(x, p["ln2"], a.norm_eps), m["w_gate"],
                       m["w_up"], m["w_down"], prec)
    elif a.mlp(i) == "moe":
        y, aux = moe(p["moe"], rms_norm(x, p["ln2"], a.norm_eps), a, prec)
        x = x + y
    return x, cache, aux


def unembed(params, a):
    w = params["embed"].T if a.tie_embeddings else params["unembed"]
    return w.float()


@torch.no_grad()
def prefill(params, a, tokens, prec="f32"):
    """tokens (R, S) -> (last logits (R, V), [cache entry of each layer])."""
    no_tf32()
    x = params["embed"][tokens].float()
    caches = []
    for i, p in enumerate(params["layers"]):
        x, c, _ = layer(p, x, a, i, prec)
        caches.append(c)
    x = rms_norm(x[:, -1], params["final_norm"].float(), a.norm_eps)
    return mm(x, unembed(params, a), prec), caches


def _stack(layers, x, a, prec, remat):
    from torch.utils.checkpoint import checkpoint

    aux = x.new_zeros(())
    for i, p in enumerate(layers):
        def run(x, p=p, i=i):
            y, _, au = layer(p, x, a, i, prec)
            return y, au
        x, au = checkpoint(run, x, use_reentrant=False) if remat else run(x)
        aux = aux + au
    return x, aux


def loss(params, a, tokens, targets, prec="f32", remat=True):
    """The training loss (mean NLL + 0.01 aux) of tokens, targets (R, S)."""
    no_tf32()
    x = params["embed"].float()[tokens]
    x, aux = _stack(params["layers"], x, a, prec, remat)
    x = rms_norm(x, params["final_norm"].float(), a.norm_eps)
    logits = mm(x, unembed(params, a), prec)
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1).long())
    return nll + 0.01 * aux
