"""repro_torch.sched — the unified scheduling policy core.

One policy protocol (``protocol.PolicySpec``: per-entity state arrays, a
composite lower-runs-first key, a slice length, a preemption rule) with
three interchangeable backends — numpy (simulators/DES), torch (the tensor
tick simulator, all policies, one node or a batch of fleet nodes) and CUDA
(the fused credit tick + selection kernel behind the serving engine's
admission path) — plus the serving admission registry.  See each
submodule's docstring.

Port of ``repro.sched``: it exports the same names.
"""
from repro_torch.sched.protocol import (  # noqa: F401
    CFS_DEFAULT_SLICE_TICKS,
    KINDS,
    TUNED_SLICE_TICKS,
    PolicySpec,
    credit_preempt,
    names,
    register,
    spec,
)
from repro_torch.sched.numpy_backend import (  # noqa: F401
    EntityView,
    Policy,
    make_policy,
    pick_k,
    primary_key,
)
