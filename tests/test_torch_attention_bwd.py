"""Port parity for the backward kernels' plain versions, on the CPU.

``flash_attention_bwd_plain`` and ``ssm_scan_bwd_plain`` (the plain PyTorch
versions of ``csrc/flash_attention_bwd.cu`` and ``csrc/ssm_scan_bwd.cu``)
against ``jax.vjp`` of the reference's functions, and against autograd of
the port's own plain forwards, at the reference's f32 ``TOL``
(tests/test_kernels.py: rtol = atol = 2e-5).  Attention: causal, windowed,
non-causal, GQA, given positions (the reference's ``_attend_chunk`` mask)
and a query row whose keys are all masked, which gets zero gradient.  The
scan: with and without h0, and split into chunks that chain through h0's
gradient, as the Mamba mixer runs it.  Inputs are made with numpy from a
seed; the cotangents too.

At bf16 the kernel's Delta is rowsum(dO * O) of the rounded output O,
where the reference's is the sum of p * dP over keys (it rounds p before
P.V): the two differ by bf16 rounding, so bf16 is held only on the card,
against the plain version (tests/test_torch_cuda.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models.attention import _attend_chunk
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssm_scan as ssm

TOL = dict(rtol=2e-5, atol=2e-5)


def _attn_inputs(seed, B, H, Hkv, S, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype(np.float32) for s in (
        (B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, H, S, D)))


def _ref_vjp(q, k, v, do, causal, window, q_pos=None, k_pos=None):
    """(dq, dk, dv) of the reference: ``flash_attention_ref`` with K and V
    repeated over the group, or ``_attend_chunk`` where positions are
    given."""
    B, H, S, D = q.shape
    G = H // k.shape[1]
    if q_pos is None:
        def f(q, k, v):
            rep = lambda x: jnp.repeat(x, G, axis=1)  # noqa: E731
            return ref.flash_attention_ref(q, rep(k), rep(v), causal=causal,
                                           window=window)
    else:
        def f(q, k, v):
            qg = q.reshape(B, k.shape[1], G, S, D).transpose(0, 3, 1, 2, 4)
            out = _attend_chunk(qg, k.transpose(0, 2, 1, 3),
                                v.transpose(0, 2, 1, 3), jnp.asarray(q_pos),
                                jnp.asarray(k_pos),
                                jnp.full((B, 1), np.iinfo(np.int32).max,
                                         jnp.int32),
                                causal, window or None)
            return out.transpose(0, 2, 3, 1, 4).reshape(B, H, S, D)
    _, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(do))]


def _port_bwd(q, k, v, do, causal, window, q_pos=None, k_pos=None):
    """(plain backward, autograd of the plain forward), each (dq, dk, dv)."""
    t = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    kw = dict(causal=causal, window=window,
              q_pos=None if q_pos is None else torch.from_numpy(q_pos),
              k_pos=None if k_pos is None else torch.from_numpy(k_pos))
    out = fa.flash_attention(*t, **kw)
    auto = torch.autograd.grad(out, t, torch.from_numpy(do))
    plain = fa.flash_attention_bwd_plain(*(x.detach() for x in t),
                                         out.detach(), torch.from_numpy(do),
                                         **kw)
    return [g.numpy() for g in plain], [g.numpy() for g in auto]


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (1, 2, 2, 64, 16, True, 0), (2, 2, 2, 96, 32, True, 24),
    (1, 2, 2, 80, 16, False, 0), (1, 2, 2, 70, 16, False, 20),
    (2, 8, 2, 64, 16, True, 0), (1, 4, 1, 50, 32, True, 16),
    (1, 2, 2, 1, 16, True, 0)])
def test_flash_bwd_plain_matches_reference_vjp(B, H, Hkv, S, D, causal,
                                               window):
    q, k, v, do = _attn_inputs(S + D, B, H, Hkv, S, D)
    want = _ref_vjp(q, k, v, do, causal, window)
    plain, auto = _port_bwd(q, k, v, do, causal, window)
    for name, p, a, w in zip("qkv", plain, auto, want):
        np.testing.assert_allclose(p, w, **TOL, err_msg=f"d{name} plain")
        np.testing.assert_allclose(a, w, **TOL, err_msg=f"d{name} autograd")


def _positions(B, S, seed, offset):
    """(B, S) int32 positions, increasing with repeats and gaps."""
    rng = np.random.default_rng(seed)
    steps = rng.integers(0, 3, (B, S))
    return (offset + np.cumsum(steps, axis=1)).astype(np.int32)


@pytest.mark.parametrize("causal,window,G", [
    (True, 0, 1), (True, 6, 2), (False, 5, 1), (True, 0, 4)])
def test_flash_bwd_plain_with_positions(causal, window, G):
    """The training path's mask: k_pos = q_pos = given positions (repeated
    positions see each other both ways); also q_pos offset from the key
    row index, the prefill's."""
    B, Hkv, S, D = 2, 2, 40, 16
    q, k, v, do = _attn_inputs(G, B, G * Hkv, Hkv, S, D)
    pos = _positions(B, S, G, 3)
    for q_pos, k_pos in ((pos, pos),
                         (pos, np.broadcast_to(np.arange(S, dtype=np.int32),
                                               (B, S)).copy())):
        want = _ref_vjp(q, k, v, do, causal, window, q_pos, k_pos)
        plain, auto = _port_bwd(q, k, v, do, causal, window, q_pos, k_pos)
        for name, p, a, w in zip("qkv", plain, auto, want):
            np.testing.assert_allclose(p, w, **TOL, err_msg=f"d{name} plain")
            np.testing.assert_allclose(a, w, **TOL,
                                       err_msg=f"d{name} autograd")


def test_flash_fully_masked_row_gives_zero_output_and_gradient():
    """Query positions below every key position: under the causal mask the
    first rows keep no key; the reference gives them 0 and zero gradient."""
    B, H, S, D = 1, 2, 24, 16
    q, k, v, do = _attn_inputs(7, B, H, H, S, D)
    q_pos = np.arange(S, dtype=np.int32)[None] - 5
    k_pos = np.arange(S, dtype=np.int32)[None]
    t = [torch.from_numpy(x) for x in (q, k, v)]
    out = fa.flash_attention(*t, q_pos=torch.from_numpy(q_pos),
                             k_pos=torch.from_numpy(k_pos))
    assert torch.count_nonzero(out[:, :, :5]) == 0
    assert torch.count_nonzero(out[:, :, 5:]) > 0
    want = _ref_vjp(q, k, v, do, True, 0, q_pos, k_pos)
    plain, auto = _port_bwd(q, k, v, do, True, 0, q_pos, k_pos)
    assert np.count_nonzero(plain[0][:, :, :5]) == 0
    for p, a, w in zip(plain, auto, want):
        np.testing.assert_allclose(p, w, **TOL)
        np.testing.assert_allclose(a, w, **TOL)


def test_flash_forward_with_positions_matches_reference():
    B, H, Hkv, S, D = 2, 4, 2, 33, 16
    q, k, v, _ = _attn_inputs(3, B, H, Hkv, S, D)
    pos = _positions(B, S, 4, 2)
    for causal, window in ((True, 0), (True, 7), (False, 9)):
        got = fa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal, window=window,
                                 q_pos=torch.from_numpy(pos),
                                 k_pos=torch.from_numpy(pos))
        G = H // Hkv
        qg = jnp.asarray(q).reshape(B, Hkv, G, S, D).transpose(0, 3, 1, 2, 4)
        want = _attend_chunk(qg, jnp.asarray(k).transpose(0, 2, 1, 3),
                             jnp.asarray(v).transpose(0, 2, 1, 3),
                             jnp.asarray(pos), jnp.asarray(pos),
                             jnp.asarray(pos).max(-1, keepdims=True) + 1,
                             causal, window or None)
        want = np.asarray(want.transpose(0, 2, 3, 1, 4).reshape(B, H, S, D))
        np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_flash_without_positions_equals_index_positions():
    """Positions equal to the row index are the index masks."""
    B, H, S, D = 1, 2, 50, 16
    q, k, v, _ = _attn_inputs(11, B, H, H, S, D)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    idx = torch.arange(S, dtype=torch.int32)[None]
    for causal, window in ((True, 0), (True, 9), (False, 0)):
        a = fa.flash_attention(*t, causal=causal, window=window)
        b = fa.flash_attention(*t, causal=causal, window=window, q_pos=idx,
                               k_pos=idx)
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def _ssm_inputs(seed, B, S, I, N, h0_scale):
    rng = np.random.default_rng(seed)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, I, 1)) - 1.0))
    dA = np.exp(-dt * np.exp(rng.standard_normal((1, 1, I, N)) * 0.2))
    dBx = dt * rng.standard_normal((B, S, I, N)) * 0.1
    C = rng.standard_normal((B, S, N))
    h0 = rng.standard_normal((B, I, N)) * h0_scale
    dy = rng.standard_normal((B, S, I))
    dh = rng.standard_normal((B, I, N))
    return [x.astype(np.float32) for x in (dA, dBx, C, h0, dy, dh)]


@pytest.mark.parametrize("B,S,I,N,h0_scale", [
    (1, 32, 16, 8, 0.0), (2, 37, 8, 16, 1.0), (1, 1, 4, 8, 1.0),
    (2, 17, 32, 4, 0.5)])
def test_ssm_bwd_plain_matches_reference_vjp(B, S, I, N, h0_scale):
    dA, dBx, C, h0, dy, dh = _ssm_inputs(S, B, S, I, N, h0_scale)
    _, vjp = jax.vjp(ref.ssm_scan_ref,
                     *(jnp.asarray(x) for x in (dA, dBx, C, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    plain = ssm.ssm_scan_bwd_plain(*map(torch.from_numpy,
                                        (dA, dBx, C, h0, dy, dh)))
    t = [torch.from_numpy(x).requires_grad_(True) for x in (dA, dBx, C, h0)]
    y, h_last = ssm.ssm_scan(*t)
    auto = torch.autograd.grad((y, h_last), t, (torch.from_numpy(dy),
                                                torch.from_numpy(dh)))
    for name, p, a, w in zip(("dA", "dBx", "C", "h0"), plain, auto, want):
        np.testing.assert_allclose(p.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name} plain")
        np.testing.assert_allclose(a.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name} autograd")


def test_ssm_bwd_plain_without_cotangents():
    """dy or dh_last may be absent (None): they count as zero."""
    dA, dBx, C, h0, dy, dh = _ssm_inputs(2, 1, 9, 8, 4, 1.0)
    args = list(map(torch.from_numpy, (dA, dBx, C, h0)))
    zeros = (torch.zeros(dy.shape), torch.zeros(dh.shape))
    for dy_, dh_ in ((None, torch.from_numpy(dh)),
                     (torch.from_numpy(dy), None)):
        got = ssm.ssm_scan_bwd_plain(*args, dy_, dh_)
        want = ssm.ssm_scan_bwd_plain(*args, zeros[0] if dy_ is None else dy_,
                                      zeros[1] if dh_ is None else dh_)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssm_bwd_chains_through_chunks():
    """The mixer scans in chunks, h_last of one the h0 of the next: the
    chunks' backward passes, chained through h0's gradient, give the
    gradient of one scan over the whole sequence."""
    dA, dBx, C, h0, dy, dh = _ssm_inputs(5, 2, 40, 16, 8, 1.0)
    T = lambda x: torch.from_numpy(x)  # noqa: E731
    whole = ssm.ssm_scan_bwd_plain(*map(T, (dA, dBx, C, h0, dy, dh)))
    cut = 24
    _, h_mid = ssm.ssm_scan_plain(T(dA[:, :cut]), T(dBx[:, :cut]),
                                  T(C[:, :cut]), T(h0))
    late = ssm.ssm_scan_bwd_plain(T(dA[:, cut:]), T(dBx[:, cut:]),
                                  T(C[:, cut:]), h_mid, T(dy[:, cut:]), T(dh))
    early = ssm.ssm_scan_bwd_plain(T(dA[:, :cut]), T(dBx[:, :cut]),
                                   T(C[:, :cut]), T(h0), T(dy[:, :cut]),
                                   late[3])
    for i in range(3):
        torch.testing.assert_close(torch.cat([early[i], late[i]], dim=1),
                                   whole[i], **TOL)
    torch.testing.assert_close(early[3], whole[3], **TOL)
