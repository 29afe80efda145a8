"""repro_torch.sched — the scheduling-policy protocol, its numpy and torch
backends, the serving admission registry and the CUDA backend of the credit
tick (see each submodule).

Port of ``repro.sched``: it exports the numpy backend's ``Policy`` and
``make_policy`` (with ``EntityView``, ``pick_k`` and ``primary_key``) as the
reference's package does.
"""
from repro_torch.sched.numpy_backend import (  # noqa: F401
    EntityView,
    Policy,
    make_policy,
    pick_k,
    primary_key,
)
