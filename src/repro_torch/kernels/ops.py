"""Dispatch layer for the port's kernels.

Port of ``repro.kernels.ops``.  Each wrapper takes its route from where its
tensors lie: the CUDA kernel for tensors on a card, the plain PyTorch version
for tensors on the CPU, and an error for anything else.  Nothing falls back
from the card to the CPU or from a kernel to its plain version.  Each kernel
module counts its own launches; ``launch_counts`` reads them all.

Under a mesh the model hands ``decode_attention``, ``flash_attention`` and
``ssm_scan`` DTensors: each wrapper checks that they are split only over
dimensions its kernel treats independently (batch and heads for attention,
batch and the inner channels for the scan), runs on each rank's local
shard and wraps the result back (``_dtensor.on_shards``); any other
placement raises, and nothing gathers a full tensor.  The counts are each
rank's own.
"""
from __future__ import annotations

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import lags_select as _lags
from repro_torch.kernels import ssm_scan as _ssm

decode_attention = _dec.decode_attention
flash_attention = _fa.flash_attention
lags_select = _lags.lags_select
ssm_scan = _ssm.ssm_scan

#: {kernel name: (module, counter attribute)}; the backward kernels count
#: beside their forwards, attention's forward and backward also by route
#: (``fa_wgmma``, ``fa_mma``, ``fa_fwd``, whose sum is ``flash_attention``,
#: and ``fa_bwd_*``, whose sum is ``flash_attention_bwd``);
#: ``ssm_scan_ckpt`` counts the launches of ``ssm_scan``'s
#: checkpoint-writing build among ``ssm_scan``'s
_COUNTERS = {"lags_select": (_lags, "launches"),
             "decode_attention": (_dec, "launches"),
             "flash_attention": (_fa, "launches"),
             "fa_wgmma": (_fa, "wgmma_launches"),
             "fa_mma": (_fa, "mma_launches"),
             "fa_fwd": (_fa, "fwd_f32_launches"),
             "ssm_scan": (_ssm, "launches"),
             "ssm_scan_ckpt": (_ssm, "ckpt_launches"),
             "flash_attention_bwd": (_fa, "bwd_launches"),
             "ssm_scan_bwd": (_ssm, "bwd_launches"),
             "fa_bwd_wgmma": (_fa, "bwd_wgmma_launches"),
             "fa_bwd_mma": (_fa, "bwd_mma_launches"),
             "fa_bwd_f32": (_fa, "bwd_f32_launches")}


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTERS.values():
        setattr(mod, attr, 0)
