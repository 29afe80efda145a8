"""Dispatch layer for the port's kernels.

Port of ``repro.kernels.ops``.  Each wrapper takes its route from where its
tensors lie: the CUDA kernel for tensors on a card, the plain PyTorch version
for tensors on the CPU, and an error for anything else.  Nothing falls back
from the card to the CPU or from a kernel to its plain version.  Each kernel
module counts its own launches; ``launch_counts`` reads them all.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import lags_select as _lags

decode_attention = _dec.decode_attention
lags_select = _lags.lags_select

_MODULES = {"lags_select": _lags, "decode_attention": _dec}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
