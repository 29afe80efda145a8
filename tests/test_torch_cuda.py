"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips with a reason where there is no card (the
decision is taken inside the ``card`` fixture, never at import).  On a
machine with one:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import lags_select as lags

pytestmark = pytest.mark.cuda

TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),  # tests/test_kernels.py
       torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


@pytest.mark.parametrize("T,k", [(1, 1), (256, 16), (1000, 16), (4096, 16),
                                 (65536, 16), (65536, 64)])
def test_lags_select_kernel_equals_plain(card, T, k):
    u = lambda: torch.rand(T, generator=card, device="cuda")  # noqa: E731
    # a coarse grid makes many equal credits: ties go to the lower lane
    args = ((u() * 2).round(decimals=1), (u() * 2).round(decimals=1), u(),
            u() < 0.5, k)
    got = lags.lags_select(*args)
    want = lags.lags_select_plain(*args)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_lags_select_sub_1e4_order(card):
    T = 2048
    credit = torch.ones(T, device="cuda")
    credit[1000] = 1e-5
    credit[0] = torch.nextafter(torch.tensor(1e-5), torch.tensor(1.0))
    z = torch.zeros(T, device="cuda")
    idx = lags.lags_select(z, credit, z, torch.ones(T, dtype=torch.bool,
                                                    device="cuda"), 3,
                           window=10**9)[2]
    assert idx.tolist() == [0, 1000, 1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H,Hkv,L,D", [(1, 2, 2, 512, 64), (2, 4, 4, 1024, 128),
                                         (2, 8, 2, 300, 64),
                                         (16, 32, 8, 512, 128)])
def test_decode_attention_kernel_matches_plain(card, dtype, B, H, Hkv, L, D):
    n = lambda *s: torch.randn(*s, generator=card, device="cuda").to(dtype)  # noqa: E731
    q = n(B, H, D)
    k = n(B, L, Hkv, D).permute(0, 2, 1, 3)  # the model's cache view
    v = n(B, L, Hkv, D).permute(0, 2, 1, 3)
    kv_len = torch.tensor(([L - 7, L, 1, L // 3] * B)[:B], dtype=torch.int32,
                          device="cuda")
    got = dec.decode_attention(q, k, v, kv_len)
    want = dec.decode_attention_plain(q, k, v, kv_len)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
