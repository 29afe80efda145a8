"""Port parity for flash attention: ``repro_torch``'s ``flash_attention`` on
the CPU (its plain PyTorch version) against the Pallas kernel in interpret
mode and ``repro.kernels.ref.flash_attention_ref``, at the reference's
``TOL`` (tests/test_kernels.py).  Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
    (torch.bfloat16, 80, "fa_mma"), (torch.bfloat16, 96, "fa_mma"),
    (torch.float32, 64, "fa_fwd"), (torch.float32, 128, "fa_fwd"),
    (torch.float32, 80, "fa_fwd")])
def test_route_is_a_function_of_dtype_and_head_dim(dtype, D, want):
    assert fa_mod.route(dtype, D) == want
    assert D in fa_mod.HEAD_DIMS


def test_route_refuses_other_dtypes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa_mod.route(torch.float16, 128)


@pytest.mark.parametrize("name", [n for n in list_configs() if any(
    s.kind == "attn" for s in layer_specs(get_config(n)))])
def test_every_attention_config_prefills_on_fa_wgmma(name):
    """The prefill of every attention config of the port runs in bf16 at a
    head dim that fa_wgmma takes, but hubert-xlarge's head dim 80, which
    takes fa_mma."""
    cfg = get_config(name)
    want = "fa_mma" if name == "hubert-xlarge" else "fa_wgmma"
    assert fa_mod.route(getattr(torch, cfg.dtype), cfg.head_dim) == want
