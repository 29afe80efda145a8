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

The scan's forward keeps the state before every ``SEG``-th step for its
backward (``ssm_scan_ckpt_plain``): held to the per-step states of the
reference's ``_ssm_chunk`` and the final state of ``ref.ssm_scan_ref``
over each prefix.  The plain backward given those checkpoints is held to
``jax.vjp`` at ragged S (1, 5, 17, 37), with and without dy or dh_last,
to the backward that recomputes from h0 (bit for bit), and through chained
chunks, each with its own checkpoints.

At bf16 the kernel's Delta is rowsum(dO * O) of the rounded output O,
where the reference's is the sum of p * dP over keys (it rounds p before
P.V): the two differ by bf16 rounding, so bf16 is held only on the card,
against the plain version (tests/test_torch_cuda.py).

The log-sum-exp L that the training forward saves for the wgmma backward
(``flash_attention_lse_plain``) is held to the reference's own: the masked
scores of ``_attend_chunk`` captured as it runs, reduced with
``jax.nn.logsumexp``.  The plain backward given that L equals the plain
backward that recomputes it, and ``jax.vjp`` of the reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.models import attention as ref_attention
from repro.models.attention import _attend_chunk
from repro.models.mamba import _ssm_chunk
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


# -- the scan's checkpoints, kept by the forward for the backward ----------

# (B, S, I, N, h0_scale): the cases above and a ragged S of 5
SSM_CKPT_CASES = [(1, 32, 16, 8, 0.0), (2, 37, 8, 16, 1.0), (1, 1, 4, 8, 1.0),
                  (2, 17, 32, 4, 0.5), (1, 5, 32, 4, 1.0)]
SEG = ssm.SEG


def _t(*arrays):
    return [torch.from_numpy(x) for x in arrays]


@pytest.mark.parametrize("B,S,I,N,h0_scale", SSM_CKPT_CASES)
def test_ssm_ckpt_plain_matches_reference_states(B, S, I, N, h0_scale):
    dA, dBx, C, h0, _, _ = _ssm_inputs(S + 1, B, S, I, N, h0_scale)
    hck = ssm.ssm_scan_ckpt_plain(*_t(dA, dBx, h0)).numpy()
    n_seg = -(-S // SEG)
    assert hck.shape == (B, n_seg, I, N) and hck.dtype == np.float32
    hs, _ = _ssm_chunk(jnp.asarray(dA), jnp.asarray(dBx), jnp.asarray(h0))
    hs = np.asarray(hs)  # (B, S, I, N): the state after each step
    np.testing.assert_array_equal(hck[:, 0], h0)
    for s in range(1, n_seg):
        t = s * SEG
        np.testing.assert_allclose(hck[:, s], hs[:, t - 1], **TOL)
        _, h_prefix = ref.ssm_scan_ref(*(jnp.asarray(x[:, :t])
                                         for x in (dA, dBx, C)),
                                       jnp.asarray(h0))
        np.testing.assert_allclose(hck[:, s], np.asarray(h_prefix), **TOL)


@pytest.mark.parametrize("B,S,I,N,h0_scale", SSM_CKPT_CASES)
@pytest.mark.parametrize("with_dy,with_dh", [(True, True), (False, True),
                                             (True, False)])
def test_ssm_bwd_plain_with_ckpt_matches_reference_vjp(B, S, I, N, h0_scale,
                                                       with_dy, with_dh):
    dA, dBx, C, h0, dy, dh = _ssm_inputs(S, B, S, I, N, h0_scale)
    dy = dy if with_dy else np.zeros_like(dy)
    dh = dh if with_dh else np.zeros_like(dh)
    _, vjp = jax.vjp(ref.ssm_scan_ref,
                     *(jnp.asarray(x) for x in (dA, dBx, C, h0)))
    want = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    hck = ssm.ssm_scan_ckpt_plain(*_t(dA, dBx, h0))
    got = ssm.ssm_scan_bwd_plain(*_t(dA, dBx, C, h0),
                                 _t(dy)[0] if with_dy else None,
                                 _t(dh)[0] if with_dh else None, hck)
    for name, g, w in zip(("dA", "dBx", "C", "h0"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,S,I,N,h0_scale", SSM_CKPT_CASES)
def test_ssm_bwd_plain_given_its_ckpt_equals_the_recomputed(B, S, I, N,
                                                            h0_scale):
    """Checkpoints equal to the scan's own states change no bit: the
    backward from them is the backward that runs from h0."""
    dA, dBx, C, h0, dy, dh = _t(*_ssm_inputs(2 * S, B, S, I, N, h0_scale))
    hck = ssm.ssm_scan_ckpt_plain(dA, dBx, h0)
    got = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh, hck)
    want = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_ssm_bwd_plain_uses_the_ckpt_as_given():
    """A segment's states run from its checkpoint, not from the state the
    segment before ends in: a zero checkpoint zeroes d(dA) at its step."""
    dA, dBx, C, h0, dy, dh = _t(*_ssm_inputs(7, 1, 40, 8, 4, 1.0))
    hck = ssm.ssm_scan_ckpt_plain(dA, dBx, h0)
    hck[:, 1] = 0.0
    d_dA = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh, hck)[0]
    assert int(torch.count_nonzero(d_dA[:, SEG])) == 0
    assert int(torch.count_nonzero(d_dA[:, SEG - 1])) > 0


def test_ssm_scan_with_ckpt_on_cpu_is_the_plain_versions():
    dA, dBx, C, h0, _, _ = _t(*_ssm_inputs(3, 2, 37, 16, 8, 1.0))
    y, h_last, hck = ssm.ssm_scan_with_ckpt(dA, dBx, C, h0)
    y_p, h_p = ssm.ssm_scan(dA, dBx, C, h0)
    torch.testing.assert_close(y, y_p, rtol=0, atol=0)
    torch.testing.assert_close(h_last, h_p, rtol=0, atol=0)
    torch.testing.assert_close(hck, ssm.ssm_scan_ckpt_plain(dA, dBx, h0),
                               rtol=0, atol=0)
    # on the meta device (the dry run) the card route's outputs, shapes only
    m = torch.empty(2, 37, 16, 8, device="meta")
    y, h_last, hck = ssm.ssm_scan_with_ckpt(m, m, m[..., 0, :], m[:, 0])
    assert (y.shape, h_last.shape, hck.shape) == ((2, 37, 16), (2, 16, 8),
                                                  (2, 3, 16, 8))
    assert y.is_meta and hck.dtype == torch.float32


def test_ssm_bwd_with_ckpt_chains_through_chunks():
    """The mixer scans in chunks, h_last of one the h0 of the next, and
    each chunk's forward keeps its own checkpoints: the chunks' backward
    passes, each given them and chained through h0's gradient, give the
    gradient of one scan over the whole sequence."""
    dA, dBx, C, h0, dy, dh = _t(*_ssm_inputs(5, 2, 40, 16, 8, 1.0))
    whole = ssm.ssm_scan_bwd_plain(dA, dBx, C, h0, dy, dh,
                                   ssm.ssm_scan_ckpt_plain(dA, dBx, h0))
    cut = 24  # not a multiple of SEG: the second chunk's segments shift
    early_in = [x[:, :cut] for x in (dA, dBx, C)]
    late_in = [x[:, cut:] for x in (dA, dBx, C)]
    _, h_mid, hck_early = ssm.ssm_scan_with_ckpt(*early_in, h0)
    _, _, hck_late = ssm.ssm_scan_with_ckpt(*late_in, h_mid)
    late = ssm.ssm_scan_bwd_plain(*late_in, h_mid, dy[:, cut:], dh, hck_late)
    early = ssm.ssm_scan_bwd_plain(*early_in, h0, dy[:, :cut], late[3],
                                   hck_early)
    for i in range(3):
        torch.testing.assert_close(torch.cat([early[i], late[i]], dim=1),
                                   whole[i], **TOL)
    torch.testing.assert_close(early[3], whole[3], **TOL)


# -- the log-sum-exp kept from the forward, and the backward's routes ------


class _ScoreCapture:
    """Stands in for ``jnp`` inside ``repro.models.attention`` while
    ``_attend_chunk`` runs: its first ``where`` is the masking of the scores
    (attention.py:59), whose result is kept."""

    def __init__(self):
        self.scores = None

    def __getattr__(self, name):
        return getattr(jnp, name)

    def where(self, *args):
        out = jnp.where(*args)
        if self.scores is None:
            self.scores = out
        return out


def _ref_lse(monkeypatch, q, k, v, causal, window, q_pos, k_pos):
    """(B, H, S) log-sum-exp of the reference's masked scores in log2 units,
    0 for a row that keeps no key (the reference clamps such a row's max at
    NEG_INF / 2 and gives it 0)."""
    B, H, S, D = q.shape
    Hkv = k.shape[1]

    @jax.jit
    def lse(q, k, v, q_pos, k_pos):
        cap = _ScoreCapture()
        monkeypatch.setattr(ref_attention, "jnp", cap)
        qg = q.reshape(B, Hkv, H // Hkv, S, D).transpose(0, 3, 1, 2, 4)
        _attend_chunk(qg, k.transpose(0, 2, 1, 3), v.transpose(0, 2, 1, 3),
                      q_pos, k_pos,
                      jnp.full((B, 1), np.iinfo(np.int32).max, jnp.int32),
                      causal, window or None)
        monkeypatch.undo()
        s = cap.scores  # (B, Hkv, G, S, S), NEG_INF where masked
        kept = jnp.max(s, axis=-1) > ref_attention.NEG_INF / 2
        return jnp.where(kept, jax.nn.logsumexp(s, axis=-1), 0.0) * fa.LOG2E

    return np.asarray(lse(q, k, v, q_pos, k_pos)).reshape(B, H, S)


@pytest.mark.parametrize("H,Hkv,causal,window,positions", [
    (2, 2, True, 0, False), (2, 2, True, 9, False), (2, 2, False, 0, False),
    (2, 2, False, 7, False), (8, 2, True, 0, False), (4, 1, True, 5, False),
    (4, 2, True, 0, True), (4, 2, False, 6, True)])
def test_lse_plain_matches_reference_scores(monkeypatch, H, Hkv, causal,
                                            window, positions):
    """L of index masks (causal, window, non-causal, G > 1) and of given
    positions in which the first query rows keep no key (L = 0 there)."""
    B, S, D = 2, 40, 16
    q, k, v, _ = _attn_inputs(H + window, B, H, Hkv, S, D)
    idx = np.broadcast_to(np.arange(S, dtype=np.int32), (B, S)).copy()
    q_pos, k_pos = (_positions(B, S, H, -4), idx) if positions else (idx, idx)
    kw = dict(q_pos=torch.from_numpy(q_pos),
              k_pos=torch.from_numpy(k_pos)) if positions else {}
    got = fa.flash_attention_lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                                       causal=causal, window=window, **kw)
    want = _ref_lse(monkeypatch, q, k, v, causal, window, q_pos, k_pos)
    assert got.dtype == torch.float32 and got.shape == (B, H, S)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    if positions and causal:
        empty = q_pos[:, :, None] < k_pos[:, None, :].min(-1, keepdims=True)
        assert empty.any()  # rows that keep no key: L = 0
        assert not np.any(got.numpy()[np.broadcast_to(empty[:, None, :, 0],
                                                      got.shape)])


@pytest.mark.parametrize("B,H,Hkv,S,D,causal,window", [
    (1, 2, 2, 64, 16, True, 0), (2, 2, 2, 96, 32, True, 24),
    (1, 2, 2, 80, 16, False, 0), (2, 8, 2, 64, 16, True, 0),
    (1, 4, 1, 50, 32, False, 16)])
def test_flash_bwd_plain_given_lse(B, H, Hkv, S, D, causal, window):
    """The plain backward reading the forward's L (log2 units, as the wgmma
    route does) equals the one that recomputes it, and the reference's
    ``jax.vjp``."""
    q, k, v, do = _attn_inputs(S * D, B, H, Hkv, S, D)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(causal=causal, window=window)
    out, lse = fa.flash_attention_with_lse(*t[:3], **kw)
    torch.testing.assert_close(out, fa.flash_attention(*t[:3], **kw), rtol=0,
                               atol=0)
    given = fa.flash_attention_bwd_plain(*t[:3], out, t[3], lse=lse, **kw)
    recomputed = fa.flash_attention_bwd_plain(*t[:3], out, t[3], **kw)
    want = _ref_vjp(q, k, v, do, causal, window)
    for name, g, r, w in zip("qkv", given, recomputed, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), **TOL,
                                   err_msg=f"d{name} given L vs recomputed")
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f"d{name}")


def test_flash_bwd_plain_given_lse_of_fully_masked_rows():
    """Given positions whose first rows keep no key: their L is 0, and the
    plain backward given it leaves their gradient 0, as recomputing does."""
    B, H, S, D = 1, 2, 24, 16
    q, k, v, do = map(torch.from_numpy, _attn_inputs(9, B, H, H, S, D))
    kw = dict(q_pos=torch.arange(S, dtype=torch.int32)[None] - 5,
              k_pos=torch.arange(S, dtype=torch.int32)[None])
    lse = fa.flash_attention_lse_plain(q, k, **kw)
    assert torch.count_nonzero(lse[:, :, :5]) == 0
    out = fa.flash_attention(q, k, v, **kw)
    given = fa.flash_attention_bwd_plain(q, k, v, out, do, lse=lse, **kw)
    recomputed = fa.flash_attention_bwd_plain(q, k, v, out, do, **kw)
    assert torch.count_nonzero(given[0][:, :, :5]) == 0
    for g, r in zip(given, recomputed):
        torch.testing.assert_close(g, r, **TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", fa.HEAD_DIMS)
@pytest.mark.parametrize("positions", [False, True])
def test_bwd_route(dtype, D, positions):
    """The wgmma backward exactly where the forward is fa_wgmma (bf16, D of
    WGMMA_DIMS: 64, 80 and 128, with or without positions); mma.sync for
    the other bf16 head dims, the CUDA cores for f32."""
    want = ("fa_bwd_f32" if dtype == torch.float32 else
            "fa_bwd_wgmma" if D in (64, 80, 128) else "fa_bwd_mma")
    assert fa.bwd_route(dtype, D, positions) == want
    assert (want == "fa_bwd_wgmma") == (fa.route(dtype, D, positions)
                                        == "fa_wgmma")


def test_bwd_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa.bwd_route(torch.float16, 64)


def test_lse_arg_layout():
    """The wgmma route reads L with S rounded up to 128 rows a (b, head):
    the forward's padded view is taken as it is, any other (B, H, S) tensor
    is copied into that layout, a wrong shape is refused."""
    B, H, S = 2, 3, 77
    padded = torch.randn(B, H, fa._lse_rows(S))
    view = padded[..., :S]
    assert fa._lse_arg(view, B, H, S).data_ptr() == padded.data_ptr()
    dense = view.contiguous()
    got = fa._lse_arg(dense, B, H, S)
    assert got.shape == (B, H, 128) and got.data_ptr() != dense.data_ptr()
    torch.testing.assert_close(got[..., :S], dense, rtol=0, atol=0)
    with pytest.raises(ValueError, match="must be"):
        fa._lse_arg(dense[:, :, :10], B, H, S)


@pytest.mark.parametrize("B,Hkv,S,G,want", [
    (8, 32, 2048, 1, 1),  # stablelm-1.6b: 2048 blocks
    (4, 8, 2048, 4, 1),  # qwen3-8b: 512 blocks
    (1, 4, 1536, 7, 7),  # qwen2-vl-7b: 48 blocks, G = 7 has no other divisor
    (1, 2, 1536, 7, 7),  # its rank of a (1, 2) mesh
    (1, 8, 1536, 2, 2),  # gemma3-27b's rank of a (1, 2) mesh: 96 blocks
    (1, 1, 2048, 16, 16),  # 16 blocks: 33 wanted, 16 at most
    (1, 4, 4096, 16, 4),  # 128 blocks: 3 wanted, 4 the least divisor above
    (2, 16, 512, 1, 1),  # hubert-xlarge: G = 1
    (2, 2, 300, 16, 1),  # S < 512
    (2, 2, 1, 16, 1)])
def test_dkdv_splits(B, Hkv, S, G, want):
    """The dK/dV kernel splits a KV group's heads over blocks only where
    its blocks leave the card's SMs idle and S is at least 512; the split
    divides G."""
    got = fa.dkdv_splits(B, Hkv, S, G)
    assert got == want and G % got == 0
