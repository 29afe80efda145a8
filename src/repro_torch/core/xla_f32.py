"""The reference's f32 arithmetic as XLA compiles it for the CPU.

The reference's tick simulator (``repro.core.simkernel_jax``) runs as one
XLA CPU program, and its completion ticks rest on the last bits of that
program's f32 results, not on the Python expressions it was traced from.
Two rules of the compiled code matter, read in its optimized LLVM IR:

  * **Fused multiply-add.** LLVM contracts an f32 product whose one use is
    an add into one FMA (one rounding): ``a * b + c`` is ``fma(a, b, c)``.
    :func:`fma` computes it on any device: the product of two f32 values
    is exact in f64, the f64 sum is rounded to f32.  That is the FMA's
    value except where the f64 sum falls exactly between two f32 values
    without the exact sum doing so (a double rounding), about one case in
    2**29.
  * **Its own ``log``.** XLA computes an f32 ``log`` with the Cephes
    polynomial (Eigen's ``plog_float``), with its own FMA contractions,
    which is not correctly rounded: it differs from ``torch.log`` in the
    last bit at 582 of the integers 1 to 69999 (7 among them).
    :func:`log` is that algorithm in numpy; the simulator takes logs only
    of small integer counts, so it reads its switch costs from tables built
    with it.

``tests/test_torch_simkernel.py`` holds :func:`log` to ``jnp.log`` under
``jax.jit`` bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

_F32 = np.float32


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 ``a * b + c`` rounded once.  ``b`` and ``c`` are f32 tensors or
    Python floats holding f32 values."""
    return (a.double() * b + c).float()


def fma_np(a, b, c):
    """:func:`fma` on numpy f32 values."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(_F32)


def _c(bits: int) -> np.float32:
    """An f32 constant from its bit pattern."""
    return np.array(bits, np.uint32).view(_F32)[()]


def log(x) -> np.ndarray:
    """XLA CPU's f32 natural log of positive finite ``x`` (numpy, f32)."""
    x = np.maximum(np.asarray(x, _F32), _c(0x00800000))  # smallest normal
    bits = x.view(np.int32)
    e = ((bits >> 23) - 127).astype(_F32)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3F000000)).view(_F32)
    low = m < _c(0x3F3504F3)  # sqrt(1/2)
    e = (_F32(1) + e) - low.astype(_F32)
    x = (m - _F32(1)) + np.where(low, m, _F32(0))
    z = x * x
    x3 = z * x
    p1 = fma_np(x, _c(0x3D9021BB), _c(0xBDEBD1B8))
    p2 = fma_np(x, _c(0xBDFE5D4F), _c(0x3E11E9BF))
    p3 = fma_np(x, _c(0x3E4CCEAC), _c(0xBE7FFFFC))
    q1 = fma_np(p1, x, _c(0x3DEF251A))
    q2 = fma_np(p2, x, _c(0xBE2AAE50))
    q3 = fma_np(p3, x, _c(0x3EAAAAAA))
    r = fma_np(fma_np(q1, x3, q2), x3, q3)
    y = fma_np(r, x3, _c(0xB95E8083) * e)
    s = fma_np(_F32(-0.5), z, x) + y
    return fma_np(_c(0x3F318000), e, s)
