"""Device resolution for the port's entry points.

Entry points run on the card by default.  Without one they raise, unless the
caller asks for the CPU: there is no silent move to the CPU.  The dry run
(``launch/dryrun.py``) runs them on the meta device: shapes and dtypes,
no data.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` means ``cuda``.  Returns a ``torch.device`` of type cuda,
    cpu or meta; raises if cuda is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev} (cuda, cpu or meta)")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(--device cpu on the command line) to run on the CPU")
    return dev
