"""Port parity for the selective scan: ``repro_torch``'s ``ssm_scan`` on the
CPU (its plain PyTorch version) against the Pallas kernel in interpret mode
and ``repro.kernels.ref.ssm_scan_ref``, at the reference's 1e-4
(tests/test_kernels.py).  Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssm_scan import ssm_scan as pallas_scan
from repro_torch.kernels.ssm_scan import ssm_scan

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, B, S, I, N, h0_scale):
    """The reference test's distributions: dA = exp(-dt * a) in (0, 1),
    dBx = dt * noise * 0.1."""
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I, 1)) - 1.0))
    dA = np.exp(-dt * np.exp(rng.standard_normal((1, 1, I, N)) * 0.2))
    dBx = dt * rng.standard_normal((B, S, I, N)) * 0.1
    C = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, I, N)) * h0_scale
    return tuple(a.astype(np.float32) for a in (dA, dBx, C, h0))


def _port(*arrays):
    y, h = ssm_scan(*map(torch.from_numpy, arrays))
    assert y.dtype == torch.float32 and h.dtype == torch.float32
    return y.numpy(), h.numpy()


@pytest.mark.parametrize("B,S,I,N", [(1, 128, 256, 8), (2, 256, 512, 16)])
@pytest.mark.parametrize("h0_scale", [0.0, 1.0])
def test_plain_matches_pallas_interpret_and_ref(B, S, I, N, h0_scale):
    arrays = _inputs(B * S + N, B, S, I, N, h0_scale)
    y, h = _port(*arrays)
    j = tuple(map(jnp.asarray, arrays))
    y_pl, h_pl = pallas_scan(*j, chunk=64, bi=min(256, I), interpret=True)
    y_ref, h_ref = ref.ssm_scan_ref(*j)
    for got, want in ((y, y_pl), (h, h_pl), (y, y_ref), (h, h_ref)):
        np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("S", [1, 37])
def test_ragged_length_matches_ref(S):
    """Any S: the Pallas kernel's S % chunk == 0 is VMEM tiling."""
    arrays = _inputs(S, 2, S, 64, 16, 1.0)
    y, h = _port(*arrays)
    y_ref, h_ref = ref.ssm_scan_ref(*map(jnp.asarray, arrays))
    np.testing.assert_allclose(y, np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(h, np.asarray(h_ref), **TOL)


def test_split_scan_carries_the_state():
    """Two scans with h carried equal one scan over the whole sequence: the
    model walks long prompts in chunks."""
    dA, dBx, C, h0 = map(torch.from_numpy, _inputs(3, 2, 96, 32, 8, 1.0))
    y, h = ssm_scan(dA, dBx, C, h0)
    y1, h1 = ssm_scan(dA[:, :40], dBx[:, :40], C[:, :40], h0)
    y2, h2 = ssm_scan(dA[:, 40:], dBx[:, 40:], C[:, 40:], h1)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, rtol=0, atol=0)
    torch.testing.assert_close(h2, h, rtol=0, atol=0)
