"""The frozen counts (bench/counts/): hand-worked numbers at one shape, and
a scan count that depends on the shapes alone, whatever the route."""
import inspect
import math

import pytest

from bench import modelcfg
from bench.counts import model_flops, ssm_scan


def test_scan_forward_by_hand():
    B, S, I, N = 2, 3, 4, 5
    flops, nbytes = ssm_scan.forward(B, S, I, N)
    # per (b, t, i, n): dt A, exp, (dt x) B, h = dA h + dBx (2), y += h C (2)
    assert flops == 7 * 120 + 1 * 24
    # x, dt (2 x 24) and B, C (2 x 30) in bf16; A (20) and h0 (40) in f32;
    # y (24) in bf16 and h_last (40) in f32
    assert nbytes == 2 * (48 + 60) + 4 * (20 + 40) + 2 * 24 + 4 * 40


def test_scan_backward_by_hand():
    B, S, I, N = 2, 3, 4, 5
    flops, nbytes = ssm_scan.backward(B, S, I, N)
    assert flops == 20 * 120 + 4 * 24
    reads = 2 * (3 * 24 + 2 * 30) + 4 * (20 + 40)   # x, dt, dy; B, C; A, h0
    writes = 2 * (2 * 24 + 2 * 30) + 4 * (20 + 40)  # dx, ddt; dB, dC; dA, dh0
    assert nbytes == reads + writes


@pytest.mark.parametrize("ckpt", [False, True])
def test_the_scan_count_is_the_same_whatever_the_route(ckpt):
    """The program's cost counts its route's work (ssm_fwd<true> also
    writes checkpoints, and every build reads the f32 dA and dBx); the
    benchmark's count takes shapes alone and never those tensors."""
    from repro_torch.kernels import ssm_scan as prog

    B, S, I, N = 4, 256, 8192, 16
    assert list(inspect.signature(ssm_scan.forward).parameters) == [
        "B", "S", "I", "N", "act_bytes"]
    mine = ssm_scan.forward(B, S, I, N)
    theirs = prog.cost(B, S, I, N, ckpt=ckpt)
    materialised = 2 * 4 * B * S * I * N  # dA and dBx in f32
    assert mine[1] < materialised < theirs[1]
    assert prog.cost(B, S, I, N, ckpt=True) != prog.cost(B, S, I, N)
    # a scan cut into chunks is the same work as one call, to the state
    # carried between them
    parts = [ssm_scan.forward(B, 64, I, N) for _ in range(4)]
    assert sum(f for f, _ in parts) == mine[0]
    carried = 3 * 2 * 4 * B * I * N  # h_last out and h0 in, three times
    assert sum(b for _, b in parts) - 3 * 4 * I * N - carried == mine[1]


def test_least_seconds_takes_the_larger_bound():
    assert ssm_scan.least_seconds(67e12, 1.0, 67e12, 3.35e12) == 1.0
    assert ssm_scan.least_seconds(1.0, 3.35e12, 67e12, 3.35e12) == 1.0


def test_model_flops_by_hand():
    a = modelcfg.arch(modelcfg.load("jamba-v0.1-52b-16L"))
    M, F, E, K = 4096, 14336, 16, 2
    n = model_flops.param_count(a)
    assert model_flops.active_param_count(a) == n - 8 * (E - K) * 3 * M * F
    assert model_flops.step_flops(a, "prefill", 10) == 20.0 * (
        n - 8 * (E - K) * 3 * M * F)
    f = modelcfg.arch(modelcfg.load("falcon-mamba-7b-16L"))
    assert model_flops.active_param_count(f) == model_flops.param_count(f)
    assert math.isclose(model_flops.step_flops(f, "train", 4096),
                        6 * 4096 * model_flops.param_count(f))
    # about 2.2 B parameters at 16 layers, and falcon-mamba-7b's published
    # 7.27 B at all 64
    assert 2.2e9 < model_flops.param_count(f) < 2.25e9
    whole = modelcfg.arch(modelcfg.load("falcon-mamba-7b"))
    assert 7.25e9 < model_flops.param_count(whole) < 7.3e9
