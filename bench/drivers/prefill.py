"""Driver of ``prefill`` mixes: one client sends a batch of prompts,
waits until its last logits are on the host's side of a synchronise, and
sends the next.

The window runs whole cycles of the mix until ``--seconds`` have passed.
A prompt's time to first token is its batch's time from submission to
synchronised logits.  Kept for the check: the logits and the cache of a
reservoir sample, drawn from the seed, of the finished batches, and of
the last finished batch of the longest length.
"""
from __future__ import annotations

import math
import random
import statistics
import time
from dataclasses import dataclass, field

import torch

from bench import compare, traffic, weights
from bench.reference import model as ref


@dataclass
class State:
    params: dict
    mix: traffic.PrefillMix
    kept: dict = field(default_factory=dict)  # slot -> batch record


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _prefill(ctx, params, toks):
    from repro_torch.models import model
    return model.prefill(params, ctx.cfg, {"tokens": toks},
                         device=ctx.device)


def setup(ctx) -> State:
    """The weights, and one batch of every length the mix sends."""
    params = weights.make(ctx.arch, ctx.seed, ctx.device)
    mix = traffic.PrefillMix(ctx.traffic, ctx.seed, ctx.arch.vocab,
                             ctx.device)
    for S, B in mix.shapes():
        toks = traffic.tokens(ctx.seed, (B, S), ctx.arch.vocab, ctx.device,
                              "warm", S)
        _prefill(ctx, params, toks)
        _sync(ctx.device)
    return State(params, mix)


def window(ctx, st: State, seconds: float) -> dict:
    """Runs the window; returns its records."""
    check = ctx.traffic["check"]
    rng = random.Random(f"{ctx.seed}:sample")
    longest = max(st.mix.lengths)
    rows = []  # (S, B, t_submit, t_done)
    n = 0
    t0 = time.perf_counter()
    cycle = 0
    while True:
        for j, S in enumerate(st.mix.order(cycle)):
            toks = st.mix.batch(cycle, j, S)
            with ctx.span(f"prefill S={S}"):
                ts = time.perf_counter()
                logits, cache = _prefill(ctx, st.params, toks)
                _sync(ctx.device)
                td = time.perf_counter()
            rows.append((S, toks.shape[0], ts, td))
            rec = (toks, logits, cache)
            # a reservoir of finished batches, and the last longest one
            if n < check["batches"]:
                st.kept[n] = rec
            else:
                i = rng.randrange(n + 1)
                if i < check["batches"]:
                    st.kept[i] = rec
            if S == longest:
                st.kept["longest"] = rec
            n += 1
        cycle += 1
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = rows[-1][3]
    return {"batches": rows, "t0": t0, "t1": t1}


def end_to_end(ctx, win: dict) -> dict:
    b = win["batches"]
    tokens = sum(S * B for S, B, _, _ in b)
    ttft = sorted(t for S, B, ts, td in b for t in [td - ts] * B)
    p95 = ttft[math.ceil(0.95 * len(ttft)) - 1]
    return {"prefill_tokens_per_s": tokens / (win["t1"] - win["t0"]),
            "ttft_p95_ms": 1e3 * p95}


def summary(win: dict) -> dict:
    """Per length: batches, and the median and largest time to first
    token in ms (for the run's standard error)."""
    out = {}
    for S in sorted({b[0] for b in win["batches"]}):
        t = sorted(1e3 * (td - ts) for s, _, ts, td in win["batches"]
                   if s == S)
        out[S] = [len(t), round(statistics.median(t), 3), round(t[-1], 3)]
    return out


def attempted(win: dict) -> int:
    return sum(B for _, B, _, _ in win["batches"])


def release(st: State):
    """Frees the program's weights; the kept outputs stay."""
    st.params = None


def check(ctx, st: State, control: bool = False):
    """The kept outputs against the reference's, on rows drawn from the
    seed (the longest batch's first row included):

    * ``gap``: the widest logit gap of a served (greedy) token, and
      ``gap_med`` the median row's;
    * ``logits``: the worst row's relative error of the last logits, and
      ``logits_med`` the median row's;
    * ``h``, ``conv``: the worst Mamba layer's relative error of the scan's
      final state and of the conv's history over the rows checked, and
      ``h_med``, ``conv_med`` the median of one row's in one layer;
    * ``k``, ``v`` (where there is attention): the same of the attention
      layers' keys and values, and ``k_med``, ``v_med``.

    A cell's limits file says which of them it compares.

    Returns (those numbers, what was checked).  With ``control`` the
    reference computed in fp8 stands in the program's place, on the same
    rows."""
    a = ctx.arch
    params = weights.make(a, ctx.seed, ctx.device)
    rng = random.Random(f"{ctx.seed}:rows")
    per = ctx.traffic["check"]["rows"]
    by_len: dict = {}  # S -> [(toks row, logits row, cache, row index)]
    for key in sorted(st.kept, key=str):
        toks, logits, cache = st.kept[key]
        B = toks.shape[0]
        pick = [0] if key == "longest" else sorted(
            rng.sample(range(B), min(per, B)))
        for r in pick:
            by_len.setdefault(toks.shape[1], []).append(
                (toks[r], logits[r], cache, r))
    gaps, lerr = [], []
    kinds = [k for k, _ in a.layers]
    names = {k: ("h", "conv") if k == "mamba" else ("k", "v")
             for k in set(kinds)}
    pooled = {(i, n): compare.RelErr() for i, k in enumerate(kinds)
              for n in names[k]}
    rows = {n: [] for k in names for n in names[k]}  # per row and layer
    block = ctx.traffic["check"]["block"]
    for S in sorted(by_len):
        items = by_len[S]
        for b0 in range(0, len(items), block):
            part = items[b0:b0 + block]
            toks = torch.stack([t for t, _, _, _ in part])
            logits, caches = ref.prefill(params, a, toks)
            if control:
                mine, got = ref.prefill(params, a, toks, "fp8")
            else:
                mine = torch.stack([lg for _, lg, _, _ in part])
                got = [{n: torch.stack([c[i][n][r] for _, _, c, r in part])
                        for n in caches[i]} for i in range(len(kinds))]
            gaps += compare.logit_gap(mine, logits).tolist()
            lerr += compare.row_errors(mine, logits)
            for (i, n), e in pooled.items():
                e.add(got[i][n], caches[i][n])
                rows[n] += compare.row_errors(got[i][n], caches[i][n])
            del logits, caches, mine, got
    med = statistics.median
    out = {"gap": max(gaps), "gap_med": med(gaps), "logits": max(lerr),
           "logits_med": med(lerr)}
    for n, v in rows.items():
        out[n] = max(e.value for (i, m), e in pooled.items() if m == n)
        out[n + "_med"] = med(v)
    return out, {"rows_checked": len(gaps)}
