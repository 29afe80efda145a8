"""Port parity for decode attention: ``repro_torch``'s ``decode_attention`` on
the CPU (its plain PyTorch version) against the Pallas kernel in interpret
mode and ``repro.kernels.ref.decode_attention_ref``, at the reference's
``TOL`` (tests/test_kernels.py).  Inputs are made with numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels.decode_attention import decode_attention

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}


def _inputs(seed, B, H, Hkv, L, D, dtype):
    """numpy f32 arrays already rounded to ``dtype``, so both frameworks
    see the same values."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s).astype(np.float32)
               for s in ((B, H, D), (B, Hkv, L, D), (B, Hkv, L, D)))
    cast = lambda x: np.array(jnp.asarray(x, dtype), np.float32)  # noqa: E731
    return cast(q), cast(k), cast(v)


def _port(q, k, v, kv_len, dtype):
    t = lambda x: torch.from_numpy(x).to(getattr(torch, dtype))  # noqa: E731
    out = decode_attention(t(q), t(k), t(v), torch.from_numpy(kv_len))
    assert out.dtype == getattr(torch, dtype)
    return out.float().numpy()


@pytest.mark.parametrize("B,H,L,D", [(1, 2, 512, 64), (2, 4, 1024, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_interpret_and_ref(B, H, L, D, dtype):
    q, k, v = _inputs(2, B, H, H, L, D, dtype)
    kv_len = np.asarray([L // 3] if B == 1 else [L // 2, L - 7], np.int32)
    got = _port(q, k, v, kv_len, dtype)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want_pl = pallas_decode(jq, jk, jv, jnp.asarray(kv_len), bk=256,
                            interpret=True)
    want_ref = ref.decode_attention_ref(jq, jk, jv, jnp.asarray(kv_len))
    np.testing.assert_allclose(got, np.asarray(want_pl, np.float32),
                               **TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(want_ref, np.float32),
                               **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_matches_ref_with_repeated_kv(dtype):
    """G = 4 query heads per KV head, against the reference oracle with K/V
    repeated to the full head count."""
    B, H, Hkv, L, D = 2, 8, 2, 256, 64
    q, k, v = _inputs(5, B, H, Hkv, L, D, dtype)
    kv_len = np.asarray([100, L - 7], np.int32)
    got = _port(q, k, v, kv_len, dtype)
    rep = lambda x: jnp.repeat(jnp.asarray(x, dtype), H // Hkv, axis=1)  # noqa: E731
    want = ref.decode_attention_ref(jnp.asarray(q, dtype), rep(k), rep(v),
                                    jnp.asarray(kv_len))
    np.testing.assert_allclose(got, np.asarray(want, np.float32),
                               **TOL[dtype])


def test_cache_view_equals_contiguous():
    """The model hands its (B, L, Hkv, D) cache in as a permuted view."""
    B, H, Hkv, L, D = 2, 8, 4, 64, 32
    q, k, v = _inputs(9, B, H, Hkv, L, D, "float32")
    kv_len = torch.tensor([17, 64], dtype=torch.int32)
    cache_k = torch.from_numpy(k).permute(0, 2, 1, 3).contiguous()
    cache_v = torch.from_numpy(v).permute(0, 2, 1, 3).contiguous()
    view = decode_attention(torch.from_numpy(q), cache_k.permute(0, 2, 1, 3),
                            cache_v.permute(0, 2, 1, 3), kv_len)
    dense = decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), kv_len)
    torch.testing.assert_close(view, dense, rtol=0, atol=0)
