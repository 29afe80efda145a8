"""The plain reference (bench/reference/) against the program, on reduced
configurations of both families with seeded weights, on the CPU; and the
benchmark's import rules."""
import ast
import math
from pathlib import Path

import pytest
import torch

from bench import modelcfg, weights
from bench.reference import model as ref
from bench.reference import optim

BENCH = Path(__file__).resolve().parents[1]
CONFIGS = ["falcon-mamba-7b-16L", "jamba-v0.1-52b-16L"]


def small(name):
    a = modelcfg.arch(modelcfg.load(name))
    return modelcfg.small(a, n_layers=8 if a.n_heads else 2)


def port_cfg(a):
    from bench.run import port_config
    return port_config(a)


def rel(x, y):
    return float((x.double() - y.double()).norm() / y.double().norm())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("S", [16, 48])
def test_prefill_matches_the_program(name, S):
    from repro_torch.models import model

    a = small(name)
    p = weights.make(a, 7, "cpu")
    toks = torch.randint(0, a.vocab, (2, S), generator=torch.Generator()
                         .manual_seed(S))
    logits, cache = model.prefill(p, port_cfg(a), {"tokens": toks},
                                  device="cpu")
    rlogits, rcache = ref.prefill(p, a, toks)
    assert rel(logits, rlogits) < 1e-5
    for c, r in zip(cache, rcache):
        for k in r:
            assert rel(c[k], r[k]) < 1e-5, k


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_program(name):
    from repro_torch.models import model

    a = small(name)
    p = weights.make(a, 3, "cpu")
    named = weights.named_leaves(p)
    for _, t in named:
        t.requires_grad_(True)
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(0, a.vocab, (2, 33), generator=g)
    batch = {"tokens": toks[:, :-1], "targets": toks[:, 1:]}
    loss, _ = model.train_loss(p, port_cfg(a), batch, device="cpu")
    grads = torch.autograd.grad(loss, [t for _, t in named])
    rloss = ref.loss(p, a, batch["tokens"], batch["targets"])
    rgrads = torch.autograd.grad(rloss, [t for _, t in named])
    assert abs(float(loss) - float(rloss)) < 1e-5 * abs(float(rloss))
    scale = max(float(r.norm()) for r in rgrads)
    for (path, _), x, r in zip(named, grads, rgrads):
        assert float((x - r).norm()) <= 1e-4 * max(float(r.norm()),
                                                   1e-3 * scale), path


def test_adamw_matches_the_program():
    from repro_torch.train import optimizer

    o = {"lr": 3e-4, "warmup_steps": 2, "total_steps": 10, "b1": 0.9,
         "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1, "clip_norm": 1.0}
    g = torch.Generator().manual_seed(0)
    tree = {"embed": torch.randn(8, 4, generator=g),
            "final_norm": torch.randn(4, generator=g),
            "layers": [{"ln1": torch.randn(4, generator=g)}]}
    named = [(k, t.clone()) for k, t in weights.named_leaves(tree)]
    ropt = optim.AdamW(named, o, [torch.float32] * len(named))
    state = optimizer.init_state(tree)
    ndims = {"embed": 2, "final_norm": 1, "layers": [{"ln1": 2}]}
    for step in range(3):
        grads = {"embed": torch.randn(8, 4, generator=g),
                 "final_norm": torch.randn(4, generator=g),
                 "layers": [{"ln1": torch.randn(4, generator=g)}]}
        tree, state, _ = optimizer.apply_updates(
            tree, grads, state, optimizer.OptConfig(**o), ndims)
        ropt.update([t for _, t in weights.named_leaves(grads)])
        for (k, r), (_, t) in zip(named, weights.named_leaves(tree)):
            assert torch.allclose(t, r, rtol=1e-6, atol=1e-9), (step, k)


def test_the_scan_is_the_recurrence_step_by_step():
    g = torch.Generator().manual_seed(0)
    R, S, I, N = 2, 300, 3, 4
    dt = torch.rand(R, S, I, generator=g)
    A = -torch.rand(I, N, generator=g)
    Bm, C = torch.randn(R, S, N, generator=g), torch.randn(R, S, N,
                                                           generator=g)
    x = torch.randn(R, S, I, generator=g)
    y, h = ref.selective_scan(dt, A, Bm, x, C, torch.zeros(R, I, N))
    hh = torch.zeros(R, I, N)
    for t in range(S):
        hh = torch.exp(dt[:, t, :, None] * A) * hh + (
            dt[:, t] * x[:, t])[..., None] * Bm[:, t, None, :]
        if t in (0, 255, 256, 299):
            assert torch.allclose(y[:, t], (hh * C[:, t, None]).sum(-1),
                                  atol=1e-5)
    assert torch.allclose(h, hh, atol=1e-6)


def test_the_control_rounds_to_fp8():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0))
    q = ref._fp8(x)
    err = float(((q - x).abs() / x.abs().clamp_min(1e-2)).median())
    assert 1e-3 < err < 0.07  # e4m3: 3 mantissa bits
    assert ref.mm(x[None], x[:, None], "fp8").shape == (1, 1)


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    p.relative_to(BENCH).as_posix() for p in BENCH.rglob("*.py")))
def test_no_jax_and_no_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(BENCH / path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks",
                       "benchmarks_torch"}, path
    if path.startswith("reference/"):
        assert "repro_torch" not in tops, path


@pytest.mark.parametrize("name, L", [("falcon-mamba-7b-16L", 16),
                                     ("falcon-mamba-7b", 64)])
def test_reference_param_count_by_hand(name, L):
    a = modelcfg.arch(modelcfg.load(name))
    M, I, N, R, W = 4096, 8192, 16, 256, 4
    layer = (M + M * 2 * I + W * I + I + I * (R + 2 * N) + R * I + I
             + I * N + I + I * M)
    n = sum(math.prod(s) for _, s, _, _, _ in weights.leaf_specs(a))
    # the embedding and the untied head, the layers, the final norm
    assert n == 2 * 65024 * M + L * layer + M
