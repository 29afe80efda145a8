"""Driver of ``train`` mixes: the program's train step, back to back.

Set-up builds one train state and one step function, and drives them from
the seed through the mix's first ``warm_steps`` (3) steps with the window's
own call and feed: they compile and warm every shape.  The window then goes
on with the same state, step after step, until ``--seconds`` have passed.

Read from the program's state on the way, for the check, which holds the
warm steps and the window's first step to the reference: each step's loss;
after step 1 each leaf's norm of the first gradient as the optimizer took
it (its first moment over 1 - b1); after the last warm step each leaf's
norm of the change from the initial weights (made again from the seed);
and of the window's first step, each leaf's norm of its gradient as the
optimizer took it ((first moment - b1 times the one before) over 1 - b1)
and of its change, from copies of the weights and first moments that
set-up keeps for it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from bench import compare, traffic, weights
from bench.reference import model as ref
from bench.reference import optim


@dataclass
class State:
    step: object
    state: object
    mix: traffic.TrainMix
    losses: list = field(default_factory=list)
    grad_norms: list = field(default_factory=list)
    change_norms: list = field(default_factory=list)
    #: copies of the weights and first moments before the window's first
    #: step, until it has been read
    before: tuple = None
    #: of the window's first step: (gradient norms, change norms)
    window_norms: tuple = None
    n_steps: int = 0


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _leaves(tree):
    return [t for _, t in weights.named_leaves(tree)]


def build(ctx, params):
    """(step function, train state) of the program over ``params``."""
    from repro_torch.train import optimizer, train_loop

    for p in _leaves(params):
        p.requires_grad_(True)
    o = ctx.traffic["opt"]
    tc = train_loop.TrainConfig(opt=optimizer.OptConfig(**o),
                                **ctx.traffic["train"])
    state = train_loop.TrainState(params, optimizer.init_state(params))
    return train_loop.make_train_step(ctx.cfg, tc), state


def setup(ctx) -> State:
    mix = traffic.TrainMix(ctx.traffic, ctx.seed, ctx.arch.vocab, ctx.device)
    step, state = build(ctx, weights.make(ctx.arch, ctx.seed, ctx.device))
    st = State(step, state, mix)
    b1 = ctx.traffic["opt"]["b1"]
    for j in range(ctx.traffic["warm_steps"]):
        st.state, m = step(st.state, mix.batch(j))
        st.losses.append(float(m["loss"]))
        st.n_steps += 1
        if j == 0:
            st.grad_norms = [float(t.float().norm()) / (1 - b1)
                             for t in _leaves(st.state.opt.mu)]
    with torch.no_grad():
        p0 = _leaves(weights.make(ctx.arch, ctx.seed, ctx.device))
        st.change_norms = [float((p.float() - q.float()).norm())
                           for p, q in zip(_leaves(st.state.params), p0)]
        del p0
        st.before = ([p.detach().clone() for p in _leaves(st.state.params)],
                     [m.clone() for m in _leaves(st.state.opt.mu)])
    _sync(ctx.device)
    return st


@torch.no_grad()
def _step_norms(st: State, b1: float):
    """(gradient norms, change norms) of the step since ``st.before``."""
    ps, ms = st.before
    g = torch.stack([(m.float() - b1 * m0.float()).norm()
                     for m, m0 in zip(_leaves(st.state.opt.mu), ms)])
    c = torch.stack([(p.float() - p0.float()).norm()
                     for p, p0 in zip(_leaves(st.state.params), ps)])
    return (g / (1 - b1)).tolist(), c.tolist()


def window(ctx, st: State, seconds: float) -> dict:
    t0 = time.perf_counter()
    n0 = st.n_steps
    while True:
        batch = st.mix.batch(st.n_steps)
        with ctx.span("train step"):
            st.state, m = st.step(st.state, batch)
            loss = float(m["loss"])  # the step is done on the device
        st.n_steps += 1
        if st.before is not None:
            st.losses.append(loss)
            st.window_norms = _step_norms(st, ctx.traffic["opt"]["b1"])
            st.before = None
        if time.perf_counter() - t0 >= seconds:
            break
    t1 = time.perf_counter()
    return {"steps": st.n_steps - n0, "B": st.mix.B, "S": st.mix.S,
            "t0": t0, "t1": t1}


def end_to_end(ctx, win: dict) -> dict:
    tokens = win["steps"] * win["B"] * win["S"]
    return {"train_tokens_per_s": tokens / (win["t1"] - win["t0"])}


def summary(win: dict) -> dict:
    return {"steps": win["steps"], "window_s": win["t1"] - win["t0"]}


def attempted(win: dict) -> int:
    return win["steps"]


def release(st: State):
    st.state = st.step = st.before = None


def reference_steps(ctx, prec: str = "f32"):
    """The reference over the warm steps and the window's first, in
    float32 (or fp8, the control): (each step's loss; the leaf norms of the
    first gradient as the update took it, clipped; those of the change
    after the last warm step; those of the window's first step's gradient
    and of its change)."""
    a = ctx.arch
    p0 = weights.make(a, ctx.seed, ctx.device)
    named = [(path, t.detach().float().clone().requires_grad_(True))
             for path, t in weights.named_leaves(p0)]
    tree = _tree(p0, [t for _, t in named])
    opt = optim.AdamW(named, ctx.traffic["opt"],
                      [t.dtype for _, t in weights.named_leaves(p0)])
    losses, first, change, last = [], None, None, None
    mix = traffic.TrainMix(ctx.traffic, ctx.seed, a.vocab, ctx.device)
    warm = ctx.traffic["warm_steps"]
    for j in range(warm + 1):
        b = mix.batch(j)
        loss = ref.loss(tree, a, b["tokens"], b["targets"], prec)
        grads = torch.autograd.grad(loss, [t for _, t in named])
        losses.append(float(loss.detach()))
        if j == warm:
            before = [t.detach().clone() for _, t in named]
        seen = opt.update([g.detach() for g in grads])
        if j == 0:
            first = [float(g.norm()) for g in seen]
        if j == warm - 1:
            change = [float((t.detach() - q.float()).norm())
                      for (_, t), (_, q) in zip(named,
                                                weights.named_leaves(p0))]
        if j == warm:
            last = ([float(g.norm()) for g in seen],
                    [float((t.detach() - q).norm())
                     for (_, t), q in zip(named, before)])
            del before
        del grads, seen, loss
    return losses, first, change, last


def _tree(like, flat):
    it = iter(flat)

    def build(node):
        if isinstance(node, torch.Tensor):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return [build(v) for v in node]

    return build(like)


def check(ctx, st: State, control: bool = False):
    """The warm steps and the window's first against the reference's:

    * ``loss``: the worst step's |loss - reference| / |reference|;
    * ``grad``: the worst leaf's gap of the first gradient's norm;
    * ``change``: the worst leaf's gap of the change's norm after the last
      warm step, over the leaves whose reference gradient is at least a
      thousandth of the median leaf's (the others move by round-off);
    * ``grad_window``, ``change_window``: the same of the window's first
      step's gradient, and of its change (the leaves kept by that step's
      reference gradient).

    A gap is |program - reference| over the larger of the leaf's reference
    norm and the median leaf's.  With ``control`` the reference computed
    in fp8 stands in the program's place."""
    import statistics

    if control:
        mine = reference_steps(ctx, "fp8")
    else:
        mine = (st.losses, st.grad_norms, st.change_norms, st.window_norms)
    losses, grads, change, last = reference_steps(ctx)
    loss = max(abs(p - r) / abs(r) for p, r in zip(mine[0], losses))

    def keep(g):
        med = statistics.median(g)
        return [x >= 1e-3 * med for x in g]
    return ({"loss": loss, "grad": compare.norm_gap(mine[1], grads),
             "change": compare.norm_gap(mine[2], change, keep(grads)),
             "grad_window": compare.norm_gap(mine[3][0], last[0]),
             "change_window": compare.norm_gap(mine[3][1], last[1],
                                               keep(last[0]))},
            {"steps": len(losses), "leaves": len(grads),
             "leaves_moved": sum(keep(grads)),
             "leaves_moved_window": sum(keep(last[0]))})
