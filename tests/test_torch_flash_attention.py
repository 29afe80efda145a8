"""Port parity for flash attention: ``repro_torch``'s ``flash_attention`` on
the CPU (its plain PyTorch version) against the Pallas kernel in interpret
mode and ``repro.kernels.ref.flash_attention_ref``, at the reference's
``TOL`` (tests/test_kernels.py).  Inputs are made with numpy from a seed.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.configs.base import get_config, layer_specs, list_configs
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels.flash_attention import flash_attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MASKS = [(True, 0), (True, 128), (False, 0)]


def _inputs(seed, B, H, Hkv, S, D, dtype):
    """numpy f32 arrays already rounded to ``dtype``, so both frameworks
    see the same values."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, S, D), (B, Hkv, S, D), (B, Hkv, S, D)))
    cast = lambda x: np.array(jnp.asarray(x, dtype), np.float32)  # noqa: E731
    return cast(q), cast(k), cast(v)


def _port(q, k, v, dtype, **kw):
    t = lambda x: torch.from_numpy(x).to(getattr(torch, dtype))  # noqa: E731
    out = flash_attention(t(q), t(k), t(v), **kw)
    assert out.dtype == getattr(torch, dtype)
    assert out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("B,H,S,D", [(1, 1, 128, 64), (2, 2, 256, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_pallas_interpret_and_ref(B, H, S, D, dtype, causal,
                                                window):
    q, k, v = _inputs(0, B, H, H, S, D, dtype)
    got = _port(q, k, v, dtype, causal=causal, window=window)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want_pl = pallas_flash(jq, jk, jv, causal=causal, window=window, bq=128,
                           bk=128, interpret=True)
    want_ref = ref.flash_attention_ref(jq, jk, jv, causal=causal,
                                       window=window)
    np.testing.assert_allclose(got, np.asarray(want_pl, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
def test_gqa_matches_ref_with_repeated_kv(dtype, causal, window):
    """G = 4 query heads per KV head, against the reference oracle with K/V
    repeated to the full head count."""
    B, H, Hkv, S, D = 2, 8, 2, 192, 64
    q, k, v = _inputs(5, B, H, Hkv, S, D, dtype)
    got = _port(q, k, v, dtype, causal=causal, window=window)
    rep = lambda x: jnp.repeat(jnp.asarray(x, dtype), H // Hkv, axis=1)  # noqa: E731
    want = ref.flash_attention_ref(jnp.asarray(q, dtype), rep(k), rep(v),
                                   causal=causal, window=window)
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("S", [1, 77, 200])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 50)])
def test_ragged_length_matches_ref(S, causal, window):
    """S that is no multiple of any tile: the Pallas kernel does not take
    it, the oracle does."""
    q, k, v = _inputs(S, 1, 2, 2, S, 16, "float32")
    got = _port(q, k, v, "float32", causal=causal, window=window)
    want = ref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL["float32"])


def test_projection_view_equals_contiguous():
    """The model hands in its (B, S, H, D) projections as permuted views."""
    B, H, Hkv, S, D = 2, 4, 2, 40, 16
    q, k, v = _inputs(9, B, H, Hkv, S, D, "float32")
    view = lambda x: torch.from_numpy(x).permute(0, 2, 1, 3).contiguous() \
        .permute(0, 2, 1, 3)  # noqa: E731
    assert not view(q).is_contiguous()
    got = flash_attention(view(q), view(k), view(v))
    dense = flash_attention(*map(torch.from_numpy, (q, k, v)))
    torch.testing.assert_close(got, dense, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,D,want", [
    (torch.bfloat16, 64, "fa_wgmma"), (torch.bfloat16, 128, "fa_wgmma"),
    (torch.bfloat16, 16, "fa_mma"), (torch.bfloat16, 32, "fa_mma"),
    (torch.bfloat16, 80, "fa_wgmma"), (torch.bfloat16, 96, "fa_mma"),
    (torch.float32, 64, "fa_fwd"), (torch.float32, 128, "fa_fwd"),
    (torch.float32, 80, "fa_fwd")])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, D, want):
    """fa_wgmma takes every bf16 head dim of a config (80 in the layout of
    128), with or without positions."""
    assert fa_mod.route(dtype, D) == want
    assert fa_mod.route(dtype, D, True) == want
    assert D in fa_mod.HEAD_DIMS


def test_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_mod.route(torch.float16, 128)


@pytest.mark.parametrize("name", [n for n in list_configs() if any(
    s.kind == "attn" for s in layer_specs(get_config(n)))])
def test_every_attention_config_prefills_on_fa_wgmma(name):
    """The prefill of every attention config of the port runs in bf16 at a
    head dim that fa_wgmma takes, hubert-xlarge's head dim 80 included,
    with or without positions (qwen2-vl's M-RoPE stream 0)."""
    cfg = get_config(name)
    for positions in (False, True):
        assert fa_mod.route(getattr(torch, cfg.dtype), cfg.head_dim,
                            positions) == "fa_wgmma"


@pytest.mark.parametrize("name,dtype,D,match", [
    ("fa_fwd", torch.bfloat16, 128, "cannot run"),
    ("fa_wgmma", torch.bfloat16, 96, "cannot run"),
    ("fa_wgmma", torch.float32, 128, "cannot run"),
    ("fa_mma", torch.float32, 80, "cannot run"),
    ("fa_bwd_mma", torch.bfloat16, 128, "none of"),
    ("mma", torch.bfloat16, 80, "none of")])
def test_forward_route_by_name_refuses(name, dtype, D, match):
    """``route=`` on the forward, as the backward's: a route runs its own
    calls, and ``fa_mma`` any bf16 call; anything else is refused before a
    kernel is chosen, on the CPU too."""
    q = torch.zeros(1, 2, 8, D, dtype=dtype)
    with pytest.raises(ValueError, match=match):
        flash_attention(q, q, q, route=name)


@pytest.mark.parametrize("name,dtype,D", [
    ("fa_mma", torch.bfloat16, 128), ("fa_mma", torch.bfloat16, 80),
    ("fa_wgmma", torch.bfloat16, 64), ("fa_fwd", torch.float32, 64)])
def test_forward_route_by_name_runs_the_plain_version_on_the_cpu(name, dtype,
                                                                  D):
    q, k, v = (torch.from_numpy(x).to(dtype)
               for x in _inputs(3, 1, 2, 2, 40, D, "float32"))
    got = flash_attention(q, k, v, window=9, route=name)
    torch.testing.assert_close(got, flash_attention(q, k, v, window=9),
                               rtol=0, atol=0)


# -- the wgmma kernels' tiles under given positions ---------------------------

def _drawn_positions(kind, B, S, seed, offset):
    """(q_pos, k_pos) int32 (B, S): rising with the row, with repeats and
    gaps, or the same shuffled; the queries moved by ``offset`` (below 0,
    early rows keep no key under a causal mask)."""
    rng = np.random.default_rng(seed)
    idx = np.tile(np.arange(S), (B, 1))
    if kind == "rising":
        pos = idx
    else:
        pos = np.cumsum(rng.integers(0, 3, (B, S)), 1) + 2
        if kind == "unsorted":
            pos = np.take_along_axis(pos, rng.permuted(idx, axis=1), 1)
    k_pos = torch.from_numpy(pos.astype(np.int32))
    return k_pos + offset, k_pos


@given(st.sampled_from(["rising", "repeats", "unsorted"]),
       st.integers(1, 300), st.booleans(),
       st.sampled_from([0, 1, 7, 50, 128]), st.integers(-20, 20),
       st.sampled_from([(64, 64), (128, 128), (128, 64), (64, 128)]),
       st.integers(0, 2**31 - 1))
@settings(max_examples=60, deadline=None)
def test_tile_classes_hold_against_the_mask(kind, S, causal, window, offset,
                                            rows, seed):
    """``tile_classes``, the plain version of the wgmma kernels' rule for
    which tiles to load and which to mask under positions, against the
    element mask ``_keep``: every SKIP tile keeps no pair, every WHOLE tile
    keeps all of its pairs (below S), and every tile that keeps a pair is
    loaded; ``pos_tiles`` gives each 64-row tile's least and greatest
    position."""
    B = 2
    q_pos, k_pos = _drawn_positions(kind, B, S, seed, offset)
    q_tab, k_tab = fa_mod.pos_tiles(q_pos, S), fa_mod.pos_tiles(k_pos, S)
    for pos, tab in ((q_pos, q_tab), (k_pos, k_tab)):
        for t in range(tab.shape[1]):
            rows_t = pos[:, t * 64:(t + 1) * 64]
            assert torch.equal(tab[:, t, 0], rows_t.amin(1))
            assert torch.equal(tab[:, t, 1], rows_t.amax(1))
    q_rows, k_rows = rows
    cls = fa_mod.tile_classes(q_tab, k_tab, S, causal, window, q_rows, k_rows)
    keep = fa_mod._keep(q_pos, k_pos, B, S, causal, window, "cpu")[:, 0, 0]
    assert cls.shape == (B, -(-S // q_rows), -(-S // k_rows))
    for b, i, j in itertools.product(*map(range, cls.shape)):
        pairs = keep[b, i * q_rows:(i + 1) * q_rows,
                     j * k_rows:(j + 1) * k_rows]
        c = int(cls[b, i, j])
        if c == fa_mod.SKIP:
            assert not pairs.any(), (b, i, j)
        elif c == fa_mod.WHOLE:
            assert pairs.all() and (j + 1) * k_rows <= S, (b, i, j)
        else:
            assert c == fa_mod.MASK


def test_tile_classes_skip_what_the_index_masks_skip():
    """Positions that rise with the row skip the tiles the masks by index
    skip: above the causal diagonal and below the window."""
    S = 1000
    pos = torch.arange(S, dtype=torch.int32)[None]
    tab = fa_mod.pos_tiles(pos, S)
    cls = fa_mod.tile_classes(tab, tab, S, True, 200, 128, 128)[0]
    for i, j in itertools.product(range(cls.shape[0]), repeat=2):
        above = j > i
        below = (j + 1) * 128 - 1 <= i * 128 - 200
        assert (int(cls[i, j]) == fa_mod.SKIP) == (above or below), (i, j)
